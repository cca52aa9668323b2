"""Google Drive connector (reference: python/pathway/io/gdrive/__init__.py,
626 LoC): poll a Drive file or folder tree, stream file contents as binary
rows, retract rows when files disappear.

The Drive API sits behind a client seam: production builds a googleapiclient
service from a service-account credentials file (dep-gated); tests inject
any object with the same three calls (`list_files(folder_id)`,
`get_file(object_id)`, `download(meta)`).

The port of ``pathway_tpu/io/gdrive.py``.  One file's failed download is
retried at the next poll, as there; here it is also logged and counted in
the subject's ``n_failed_downloads``.
"""

from __future__ import annotations

import fnmatch
import logging
import time
from typing import Any, Sequence

from ..internals import dtype as dt
from ..internals.compat import schema_builder
from ..internals.schema import ColumnDefinition
from ..internals.value import Json
from ._utils import make_input_table

_log = logging.getLogger("pathway_tpu_torch.io.gdrive")

_FOLDER_MIME = "application/vnd.google-apps.folder"
# google-docs native types export to these concrete formats
_EXPORT_FORMATS = {
    "application/vnd.google-apps.document":
        "application/vnd.openxmlformats-officedocument.wordprocessingml.document",
    "application/vnd.google-apps.spreadsheet":
        "application/vnd.openxmlformats-officedocument.spreadsheetml.sheet",
    "application/vnd.google-apps.presentation":
        "application/vnd.openxmlformats-officedocument.presentationml.presentation",
}
_META_FIELDS = "id,name,mimeType,parents,modifiedTime,size,version,trashed"


class GDriveApiClient:
    """Thin wrapper over googleapiclient — the production implementation of
    the client seam (requires google-api-python-client + google-auth)."""

    def __init__(self, credentials_file: str):
        try:
            from google.oauth2.service_account import Credentials
            from googleapiclient.discovery import build
        except ImportError as exc:  # pragma: no cover - dep-gated
            raise ImportError(
                "pw.io.gdrive needs google-api-python-client and google-auth "
                "(pip install google-api-python-client google-auth)"
            ) from exc
        creds = Credentials.from_service_account_file(
            credentials_file,
            scopes=["https://www.googleapis.com/auth/drive.readonly"],
        )
        self._service = build("drive", "v3", credentials=creds,
                              cache_discovery=False)

    def list_files(self, folder_id: str) -> list[dict]:
        out, token = [], None
        while True:
            resp = self._service.files().list(
                q=f"'{folder_id}' in parents and trashed = false",
                fields=f"nextPageToken, files({_META_FIELDS})",
                pageToken=token, pageSize=1000,
            ).execute()
            out.extend(resp.get("files", []))
            token = resp.get("nextPageToken")
            if not token:
                return out

    def get_file(self, object_id: str) -> dict:
        return self._service.files().get(
            fileId=object_id, fields=_META_FIELDS
        ).execute()

    def download(self, meta: dict) -> bytes:
        export = _EXPORT_FORMATS.get(meta.get("mimeType", ""))
        files = self._service.files()
        if export:
            req = files.export_media(fileId=meta["id"], mimeType=export)
        else:
            req = files.get_media(fileId=meta["id"])
        return req.execute()


class _GDriveTree:
    """Recursive listing + filtering over the client seam."""

    def __init__(self, client, object_size_limit: int | None,
                 file_name_pattern: str | Sequence[str] | None):
        self.client = client
        self.object_size_limit = object_size_limit
        self.file_name_pattern = file_name_pattern

    def _matches(self, meta: dict) -> bool:
        pat = self.file_name_pattern
        if pat is None:
            return True
        pats = [pat] if isinstance(pat, str) else list(pat)
        return any(fnmatch.fnmatch(meta.get("name", ""), p) for p in pats)

    def _size_ok(self, meta: dict) -> bool:
        if self.object_size_limit is None:
            return True
        return int(meta.get("size", "0") or 0) <= self.object_size_limit

    def snapshot(self, root_id: str) -> dict[str, dict]:
        """{file_id: metadata} for every non-folder object under root."""
        root = self.client.get_file(root_id)
        out: dict[str, dict] = {}
        if root.get("mimeType") != _FOLDER_MIME:
            if self._matches(root) and self._size_ok(root):
                out[root["id"]] = root
            return out
        stack = [root_id]
        seen_folders = set()
        while stack:
            folder = stack.pop()
            if folder in seen_folders:
                continue
            seen_folders.add(folder)
            for meta in self.client.list_files(folder):
                if meta.get("mimeType") == _FOLDER_MIME:
                    stack.append(meta["id"])
                elif self._matches(meta) and self._size_ok(meta):
                    out[meta["id"]] = meta
        return out


class _GDriveSubject:
    """Poll loop: list tree, download new/changed files, retract removed."""

    def __init__(self, client, object_id: str, mode: str,
                 refresh_interval: float, with_metadata: bool,
                 object_size_limit, file_name_pattern):
        self.tree = _GDriveTree(client, object_size_limit, file_name_pattern)
        self.client = client
        self.object_id = object_id
        self.mode = mode
        self.refresh_interval = refresh_interval
        self.with_metadata = with_metadata
        self._known: dict[str, tuple[str, tuple]] = {}  # id -> (ver, row)
        self._stop = False
        self.n_failed_downloads = 0

    def _version(self, meta: dict) -> str:
        return str(meta.get("version") or meta.get("modifiedTime") or "")

    def _row(self, meta: dict, payload: bytes) -> tuple:
        if self.with_metadata:
            return (payload, Json({
                k: meta.get(k)
                for k in ("id", "name", "mimeType", "modifiedTime", "size")
            }))
        return (payload,)

    def _run(self, source) -> None:
        while not self._stop:
            snap = self.tree.snapshot(self.object_id)
            for fid, meta in snap.items():
                ver = self._version(meta)
                old = self._known.get(fid)
                if old is not None and old[0] == ver:
                    continue
                try:
                    payload = self.client.download(meta)
                except Exception as exc:
                    # its version stays unrecorded: the next poll retries it
                    self.n_failed_downloads += 1
                    _log.warning("gdrive download failed for %s: %s",
                                 meta.get("name"), exc)
                    continue
                row = self._row(meta, payload)
                if old is not None:
                    source.push(old[1], -1, fid)  # retract the exact old row
                source.push(row, 1, fid)
                self._known[fid] = (ver, row)
            for fid in list(self._known):
                if fid not in snap:
                    _ver, row = self._known.pop(fid)
                    source.push(row, -1, fid)
            if self.mode == "static":
                break
            deadline = time.monotonic() + self.refresh_interval
            while not self._stop and time.monotonic() < deadline:
                time.sleep(min(0.05, self.refresh_interval))
        source.close()

    def on_stop(self) -> None:
        self._stop = True


def read(
    object_id: str,
    *,
    mode: str = "streaming",
    object_size_limit: int | None = None,
    refresh_interval: float = 30.0,
    service_user_credentials_file: str | None = None,
    with_metadata: bool = False,
    file_name_pattern: str | Sequence[str] | None = None,
    name: str | None = None,
    _client: Any = None,
    **kwargs,
):
    """Stream a Drive file/folder as binary rows (reference signature:
    io/gdrive/__init__.py read)."""
    client = _client
    if client is None:
        if service_user_credentials_file is None:
            raise ValueError(
                "pw.io.gdrive.read needs service_user_credentials_file "
                "(or an injected _client for tests)"
            )
        client = GDriveApiClient(service_user_credentials_file)
    subject = _GDriveSubject(
        client, object_id, mode, refresh_interval, with_metadata,
        object_size_limit, file_name_pattern,
    )
    from ..internals.datasource import SubjectDataSource

    cols = {"data": ColumnDefinition(dtype=dt.BYTES)}
    colnames = ["data"]
    if with_metadata:
        cols["_metadata"] = ColumnDefinition(dtype=dt.JSON)
        colnames.append("_metadata")
    ds = SubjectDataSource(subject, colnames, None, append_only=False)
    schema = schema_builder(cols, name="GDriveFile")
    return make_input_table(schema, ds, name=name or "gdrive", persistent_id=kwargs.get("persistent_id"))
