"""Google BigQuery sink (reference: io/bigquery wrapper over the google
cloud client) — implemented directly on the REST API: service-account JWT
(RS256 via `cryptography`) exchanged for an OAuth token, rows streamed with
tabledata.insertAll.

The HTTP layer is a seam (`_http(url, payload, headers) -> dict`) so tests
run against a fake; the token flow is skipped when a seam is injected.

The port of ``pathway_tpu/io/bigquery.py``.
"""

from __future__ import annotations

import base64
import json
import time
import urllib.request
from typing import Any

from ..engine.types import unwrap_row
from ..internals import parse_graph as pg
from ..internals.table import Table
from ._utils import plain_scalar
from ..internals.config import _check_entitlements

_SCOPE = "https://www.googleapis.com/auth/bigquery.insertdata"


def _b64url(data: bytes) -> bytes:
    return base64.urlsafe_b64encode(data).rstrip(b"=")


def _service_account_token(info: dict) -> str:
    """OAuth2 JWT-bearer flow for a service account (RS256)."""
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import padding

    now = int(time.time())
    header = _b64url(json.dumps({"alg": "RS256", "typ": "JWT"}).encode())
    claims = _b64url(json.dumps({
        "iss": info["client_email"],
        "scope": _SCOPE,
        "aud": "https://oauth2.googleapis.com/token",
        "iat": now, "exp": now + 3600,
    }).encode())
    signing_input = header + b"." + claims
    key = serialization.load_pem_private_key(
        info["private_key"].encode(), password=None
    )
    sig = key.sign(signing_input, padding.PKCS1v15(), hashes.SHA256())
    assertion = (signing_input + b"." + _b64url(sig)).decode()
    body = (
        "grant_type=urn%3Aietf%3Aparams%3Aoauth%3Agrant-type%3Ajwt-bearer"
        f"&assertion={assertion}"
    ).encode()
    req = urllib.request.Request(
        "https://oauth2.googleapis.com/token", data=body,
        headers={"Content-Type": "application/x-www-form-urlencoded"},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())["access_token"]


class _BigQueryWriter:
    def __init__(self, dataset: str, table_name: str,
                 service_user_credentials_file: str | None, _http):
        self.dataset = dataset
        self.table_name = table_name
        self.creds_file = service_user_credentials_file
        self._http = _http
        self._token: str | None = None
        self._token_exp = 0.0
        self._project: str | None = None

    def _ensure_auth(self) -> None:
        # tokens are minted with exp=now+3600; refresh before expiry so
        # long streaming sinks don't start 401ing after an hour
        if self._http is not None or (
            self._token is not None and time.time() < self._token_exp - 60
        ):
            return
        with open(self.creds_file) as f:
            info = json.load(f)
        self._project = info["project_id"]
        self._token = _service_account_token(info)
        self._token_exp = time.time() + 3600

    def write_batch(self, time_, colnames, updates) -> None:
        if not updates:
            return
        self._ensure_auth()
        rows = []
        colnames = list(colnames)
        for key, row, diff in updates:
            d = dict(zip(colnames, (plain_scalar(v) for v in unwrap_row(row))))
            d["time"] = time_
            d["diff"] = diff
            rows.append({"insertId": f"{key}:{time_}:{diff}", "json": d})
        url = (
            f"https://bigquery.googleapis.com/bigquery/v2/projects/"
            f"{self._project}/datasets/{self.dataset}/tables/"
            f"{self.table_name}/insertAll"
        )
        payload = {"rows": rows, "skipInvalidRows": False}
        headers = {"Authorization": f"Bearer {self._token}",
                   "Content-Type": "application/json"}
        if self._http is not None:
            self._http(url, payload, headers)
            return
        req = urllib.request.Request(
            url, data=json.dumps(payload).encode(), headers=headers,
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=30) as resp:
            out = json.loads(resp.read())
        if out.get("insertErrors"):
            raise RuntimeError(f"bigquery insertAll errors: {out['insertErrors'][:3]}")

    def close(self) -> None:
        pass




def write(table: Table, dataset: str, table_name: str, *,
          service_user_credentials_file: str | None = None,
          **kwargs) -> None:
    """Reference: pw.io.bigquery.write."""
    _check_entitlements("bigquery")
    pg.new_output_node(
        "output", [table], colnames=table.column_names(),
        writer=_BigQueryWriter(
            dataset, table_name, service_user_credentials_file,
            kwargs.pop("_http", None),
        ),
    )
