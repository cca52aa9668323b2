"""SharePoint connector over the Microsoft Graph REST API (reference:
xpacks/connectors/sharepoint/__init__.py, 450 LoC — an Office365-REST
client; here Graph is called directly with urllib + OAuth2 client
credentials, so no client library).

`read` polls a drive folder (document library path) recursively — same
poller shape as io/gdrive.py: change detection by eTag, retraction of
deleted files, name globs and size limits; rows are (data, _metadata).
The Graph transport is a seam (`SharePointClient`), with fakes in tests.

The port of ``pathway_tpu/io/sharepoint.py``.  A failed poll is logged
once and retried at the next poll, and counted in ``n_failed_polls``; one
file's failed download is logged and retried at the next poll, and counted
in ``n_failed_downloads``.
"""

from __future__ import annotations

import fnmatch
import json
import logging
import time
import urllib.parse
import urllib.request
from typing import Any, Sequence

from ..internals import dtype as dt
from ..internals.compat import schema_builder
from ..internals.datasource import DataSource
from ..internals.schema import ColumnDefinition
from ..internals.table import Table
from ..internals.value import Json, ref_scalar
from ._utils import make_input_table
from ..internals.config import _check_entitlements

_log = logging.getLogger("pathway_tpu_torch.io.sharepoint")
_GRAPH = "https://graph.microsoft.com/v1.0"


class SharePointClient:
    """Production Graph client: client-credential OAuth + drive REST."""

    def __init__(self, tenant: str, client_id: str, client_secret: str,
                 site_url: str):
        self.tenant = tenant
        self.client_id = client_id
        self.client_secret = client_secret
        self.site_url = site_url
        self._token: str | None = None
        self._token_exp = 0.0
        self._site_id: str | None = None

    # -- auth --------------------------------------------------------------
    def _get_token(self) -> str:
        if self._token and time.time() < self._token_exp - 60:
            return self._token
        body = urllib.parse.urlencode({
            "grant_type": "client_credentials",
            "client_id": self.client_id,
            "client_secret": self.client_secret,
            "scope": "https://graph.microsoft.com/.default",
        }).encode()
        req = urllib.request.Request(
            f"https://login.microsoftonline.com/{self.tenant}/oauth2/v2.0/token",
            data=body, method="POST",
        )
        with urllib.request.urlopen(req, timeout=30) as resp:
            tok = json.loads(resp.read())
        self._token = tok["access_token"]
        self._token_exp = time.time() + int(tok.get("expires_in", 3600))
        return self._token

    def _get(self, url: str, raw: bool = False):
        req = urllib.request.Request(
            url, headers={"Authorization": f"Bearer {self._get_token()}"}
        )
        with urllib.request.urlopen(req, timeout=60) as resp:
            data = resp.read()
        return data if raw else json.loads(data)

    def _site(self) -> str:
        if self._site_id is None:
            host_path = self.site_url.split("://", 1)[-1]
            host, _, path = host_path.partition("/")
            self._site_id = self._get(
                f"{_GRAPH}/sites/{host}:/{path}"
            )["id"]
        return self._site_id

    # -- seam --------------------------------------------------------------
    def list_folder(self, path: str) -> list[dict]:
        """DriveItems of a folder (path relative to the drive root)."""
        base = f"{_GRAPH}/sites/{self._site()}/drive/root"
        url = (
            f"{base}/children" if path in ("", "/")
            else f"{base}:/{urllib.parse.quote(path.strip('/'))}:/children"
        )
        out = []
        while url:
            resp = self._get(url)
            out.extend(resp.get("value", []))
            url = resp.get("@odata.nextLink")
        return out

    def download(self, item: dict) -> bytes:
        url = item.get("@microsoft.graph.downloadUrl")
        if url:
            with urllib.request.urlopen(url, timeout=120) as resp:
                return resp.read()
        return self._get(
            f"{_GRAPH}/sites/{self._site()}/drive/items/{item['id']}/content",
            raw=True,
        )


class SharePointSource(DataSource):
    """Recursive folder poller with eTag change detection + retraction."""

    def __init__(self, client, root_path: str, mode: str,
                 refresh_interval_s: float,
                 object_size_limit: int | None,
                 file_name_pattern: str | Sequence[str] | None,
                 with_metadata: bool):
        self.client = client
        self.root_path = root_path
        self.mode = mode
        self.refresh_interval_s = refresh_interval_s
        self.object_size_limit = object_size_limit
        self.file_name_pattern = file_name_pattern
        self.with_metadata = with_metadata
        self._snapshot: dict[str, tuple] = {}  # id -> (etag, row)
        self._last_poll = 0.0
        self._first = True
        self._err = False
        self.n_failed_polls = 0
        self.n_failed_downloads = 0

    def is_live(self) -> bool:
        return self.mode == "streaming"

    def _matches(self, item: dict) -> bool:
        pat = self.file_name_pattern
        if pat is None:
            return True
        pats = [pat] if isinstance(pat, str) else list(pat)
        return any(fnmatch.fnmatch(item.get("name", ""), p) for p in pats)

    def _walk(self) -> dict[str, dict]:
        out: dict[str, dict] = {}
        stack = [self.root_path]
        while stack:
            path = stack.pop()
            for item in self.client.list_folder(path):
                if "folder" in item:
                    stack.append(
                        f"{path.rstrip('/')}/{item['name']}".lstrip("/")
                    )
                    continue
                if not self._matches(item):
                    continue
                size = int(item.get("size", 0) or 0)
                if (self.object_size_limit is not None
                        and size > self.object_size_limit):
                    continue
                out[item["id"]] = item
        return out

    def _row(self, item: dict) -> tuple:
        data = self.client.download(item)
        if self.with_metadata:
            meta = {
                "name": item.get("name"), "size": item.get("size"),
                "etag": item.get("eTag"),
                "modified_at": item.get("lastModifiedDateTime"),
                "path": item.get("parentReference", {}).get("path"),
            }
            return (data, Json(meta))
        return (data,)

    def _diff(self) -> list:
        items = self._walk()
        events = []
        for oid, item in items.items():
            etag = item.get("eTag") or item.get("lastModifiedDateTime")
            old = self._snapshot.get(oid)
            if old is not None and old[0] == etag:
                continue
            try:
                row = self._row(item)
            except Exception as exc:
                # one file's download failure must not swallow the rest of
                # this diff, and its snapshot entry stays untouched so the
                # next poll retries it
                self.n_failed_downloads += 1
                _log.warning("sharepoint download failed for %s: %s",
                             item.get("name"), exc)
                continue
            key = ref_scalar("#sharepoint", oid)
            if old is not None:
                events.append((0, key, old[1], -1))
            events.append((0, key, row, 1))
            self._snapshot[oid] = (etag, row)
        for oid in list(self._snapshot):
            if oid not in items:
                etag, row = self._snapshot.pop(oid)
                events.append((0, ref_scalar("#sharepoint", oid), row, -1))
        return events

    def static_events(self) -> list:
        if self.mode == "streaming":
            return []
        return self._diff()

    def poll(self):
        now = time.monotonic()
        if not self._first and now - self._last_poll < self.refresh_interval_s:
            return []
        self._first = False
        self._last_poll = now
        try:
            events = self._diff()
            self._err = False
            return events
        except Exception as exc:
            self.n_failed_polls += 1
            if not self._err:
                _log.warning("sharepoint poll failed: %s", exc)
                self._err = True
            return []


def read(url: str = "", *, tenant: str = "", client_id: str = "",
         client_secret: str = "", root_path: str = "",
         mode: str = "streaming", refresh_interval: int = 30,
         object_size_limit: int | None = None,
         file_name_pattern=None, with_metadata: bool = True,
         _client=None, **kwargs) -> Table:
    """Reference: pw.xpacks.connectors.sharepoint.read."""
    _check_entitlements("xpack-sharepoint")
    client = _client or SharePointClient(tenant, client_id, client_secret, url)
    source = SharePointSource(
        client, root_path, mode, float(refresh_interval),
        object_size_limit, file_name_pattern, with_metadata,
    )
    cols = {"data": ColumnDefinition(dtype=dt.BYTES)}
    if with_metadata:
        cols["_metadata"] = ColumnDefinition(dtype=dt.JSON)
    schema = schema_builder(cols, name="SharePointFile")
    return make_input_table(schema, source, name=f"sharepoint:{root_path}", persistent_id=kwargs.get("persistent_id"))
