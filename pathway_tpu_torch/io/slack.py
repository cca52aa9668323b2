"""Slack alert sink (reference: python/pathway/io/slack/__init__.py:9).

`send_alerts` posts each added value of one column to a Slack channel via
the `chat.postMessage` Web API — plain REST, no slack-sdk dependency.  The
HTTP transport is injectable (`_http`) so tests run against a fake.

The port of ``pathway_tpu/io/slack.py``; alerts fire on additions only.
"""

from __future__ import annotations

import logging
from typing import Callable

from ..engine.types import unwrap_row
from ..internals import parse_graph as pg
from ..internals.expression import ColumnReference
from .vector_writers import _default_http as _rest_post

_log = logging.getLogger("pathway_tpu_torch.io.slack")

_API_URL = "https://slack.com/api/chat.postMessage"


def _default_http(url: str, payload: dict, headers: dict) -> dict:
    # shared REST transport (vector_writers), pinned to POST
    return _rest_post("POST", url, payload, headers)


class _SlackWriter:
    def __init__(self, column: str, channel_id: str, token: str,
                 _http: Callable | None):
        self.column = column
        self.channel_id = channel_id
        self.token = token
        self._http = _http or _default_http

    def write_batch(self, time_, colnames, updates) -> None:
        ci = list(colnames).index(self.column)
        for _key, row, diff in updates:
            if diff <= 0:  # alerts fire on additions only (reference parity)
                continue
            text = unwrap_row(row)[ci]
            resp = self._http(
                _API_URL,
                {"channel": self.channel_id, "text": str(text)},
                {"Authorization": f"Bearer {self.token}"},
            )
            if isinstance(resp, dict) and resp.get("ok") is False:
                _log.warning("slack postMessage failed: %s", resp.get("error"))

    def close(self) -> None:
        pass


def send_alerts(alerts: ColumnReference, slack_channel_id: str,
                slack_token: str, *, _http: Callable | None = None) -> None:
    """Post every added value of `alerts` to the Slack channel."""
    if not isinstance(alerts, ColumnReference):
        raise ValueError("pw.io.slack.send_alerts expects a column reference")
    table = alerts.table
    pg.new_output_node(
        "output", [table], colnames=table.column_names(),
        writer=_SlackWriter(alerts._name, slack_channel_id, slack_token,
                            _http),
    )
