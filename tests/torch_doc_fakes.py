"""In-process stand-ins for the documents and apps connectors' outside
services: a Google Drive client (``DriveStandIn``), a SharePoint Graph
client (``GraphStandIn``), a PyFilesystem-style filesystem (``MemFS``),
Slack's ``chat.postMessage`` seam (``SlackRecorder``) and the data file
of the fake Airbyte connector (``tests/airbyte_fake_connector.py``).

Each stand-in records what reaches it (downloads and reads by file,
posted payloads) and takes its changes from another thread under a lock,
as a service changes under a poller.  ``tests/test_torch_io_documents_apps.py``,
``tests/test_torch_io_lakes_files.py`` and ``chip_smoke.py``'s phase 4r
use them.
"""

from __future__ import annotations

import collections
import datetime
import json
import os
import sys
import threading
import types

FOLDER_MIME = "application/vnd.google-apps.folder"
AIRBYTE_CONNECTOR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "airbyte_fake_connector.py")


class DriveStandIn:
    """An in-memory Drive behind the connector's client seam
    (``list_files``, ``get_file``, ``download``).  A download returns the
    file's content now, whatever version the listing before it named, and
    fails (``FileNotFoundError``) for a file removed since, as the Drive
    API does.  ``downloads`` counts the downloads of each file id; a file
    id in ``fail_downloads`` fails its next download (``OSError``) once."""

    def __init__(self):
        self.objects: dict = {}
        self.downloads: collections.Counter = collections.Counter()
        self.fail_downloads: set = set()
        self.lock = threading.Lock()

    def add_folder(self, fid: str, parent: str | None = None) -> None:
        with self.lock:
            self.objects[fid] = {"id": fid, "name": fid,
                                 "mimeType": FOLDER_MIME, "children": []}
            if parent:
                self.objects[parent]["children"].append(fid)

    def put(self, fid: str, name: str, content: bytes, parent: str) -> None:
        """Add a file, or change one (its version goes up)."""
        with self.lock:
            old = self.objects.get(fid)
            version = str(int(old["version"]) + 1) if old else "1"
            self.objects[fid] = {
                "id": fid, "name": name, "mimeType": "text/plain",
                "version": version, "size": str(len(content)),
                "content": content,
            }
            if old is None:
                self.objects[parent]["children"].append(fid)

    def remove(self, fid: str, parent: str) -> None:
        with self.lock:
            self.objects.pop(fid, None)
            self.objects[parent]["children"].remove(fid)

    @staticmethod
    def _meta(o: dict) -> dict:
        return {k: v for k, v in o.items() if k not in ("content", "children")}

    # -- the client seam ----------------------------------------------------
    def list_files(self, folder_id: str) -> list:
        with self.lock:
            return [self._meta(self.objects[c])
                    for c in self.objects[folder_id]["children"]
                    if c in self.objects]

    def get_file(self, object_id: str) -> dict:
        with self.lock:
            return self._meta(self.objects[object_id])

    def download(self, meta: dict) -> bytes:
        with self.lock:
            if meta["id"] in self.fail_downloads:
                self.fail_downloads.discard(meta["id"])
                raise OSError(f"drive: download of {meta['id']} failed")
            if meta["id"] not in self.objects:
                raise FileNotFoundError(f"drive: {meta['id']} not found")
            self.downloads[meta["id"]] += 1
            return self.objects[meta["id"]]["content"]


class GraphStandIn:
    """A SharePoint document library behind the connector's Graph seam
    (``list_folder(path)``, ``download(item)``): files in folders named
    by their path under the drive root; a file's ``eTag`` goes up at each
    change, and a download returns the file's content now, or fails for
    a file removed since, as ``DriveStandIn``'s.  ``fail_lists`` makes
    that many next listings fail; ``fail_downloads`` as
    ``DriveStandIn``'s."""

    def __init__(self):
        self.files: dict = {}      # id -> (folder, item, content)
        self.folders: set = {""}
        self.downloads: collections.Counter = collections.Counter()
        self.fail_downloads: set = set()
        self.fail_lists = 0
        self.lock = threading.Lock()

    def put(self, fid: str, name: str, content: bytes,
            folder: str = "docs") -> None:
        folder = folder.strip("/")
        with self.lock:
            old = self.files.get(fid)
            etag = int(old[1]["eTag"][1:]) + 1 if old else 1
            parts = folder.split("/") if folder else []
            for i in range(len(parts) + 1):
                self.folders.add("/".join(parts[:i]))
            self.files[fid] = (folder, {
                "id": fid, "name": name, "eTag": f"v{etag}",
                "size": len(content),
                "lastModifiedDateTime": f"2026-01-01T00:00:{etag:02d}Z",
                "parentReference": {"path": f"/drive/root:/{folder}"},
            }, content)

    def remove(self, fid: str) -> None:
        with self.lock:
            del self.files[fid]

    # -- the client seam ----------------------------------------------------
    def list_folder(self, path: str) -> list:
        path = path.strip("/")
        with self.lock:
            if self.fail_lists:
                self.fail_lists -= 1
                raise OSError("graph: listing failed")
            subs = sorted(f for f in self.folders if f and (
                f.rsplit("/", 1)[0] if "/" in f else "") == path)
            out = [{"id": f"folder:{f}", "name": f.rsplit("/", 1)[-1],
                    "folder": {"childCount": 0}} for f in subs]
            out += [dict(item) for folder, item, _c in self.files.values()
                    if folder == path]
            return out

    def download(self, item: dict) -> bytes:
        with self.lock:
            if item["id"] in self.fail_downloads:
                self.fail_downloads.discard(item["id"])
                raise OSError(f"graph: download of {item['id']} failed")
            if item["id"] not in self.files:
                raise FileNotFoundError(f"graph: {item['id']} not found")
            self.downloads[item["id"]] += 1
            return self.files[item["id"]][2]


class MemFS:
    """A duck-typed PyFilesystem (``listdir``, ``isdir``, ``getinfo``,
    ``readbytes``), each call in time independent of the files' count.
    Each change of a file gives it the next modification time, so a
    change within one second is seen.  ``reads`` counts the reads of each
    path; a path in ``fail_info`` fails its ``getinfo`` (``OSError``)
    while it is there, and a path removed fails ``getinfo`` and
    ``readbytes`` (``FileNotFoundError``), as a filesystem's
    ``ResourceNotFound`` does."""

    def __init__(self):
        self.files: dict = {}      # path -> (bytes, mtime)
        self.children: dict = collections.defaultdict(collections.Counter)
        self.reads: collections.Counter = collections.Counter()
        self.fail_info: set = set()
        self.lock = threading.Lock()
        self._clock = 1000

    def _links(self, path: str):
        """(directory, entry) of each step of ``path``."""
        parts = path.strip("/").split("/")
        for i, name in enumerate(parts):
            yield "/" + "/".join(parts[:i]), name

    def put(self, path: str, data: bytes, mtime: int | None = None) -> None:
        with self.lock:
            if mtime is None:
                self._clock += 1
                mtime = self._clock
            if path not in self.files:
                for d, name in self._links(path):
                    self.children[d][name] += 1
            self.files[path] = (data, mtime)

    def remove(self, path: str) -> None:
        with self.lock:
            del self.files[path]
            for d, name in self._links(path):
                self.children[d][name] -= 1
                if not self.children[d][name]:
                    del self.children[d][name]

    def listdir(self, p: str) -> list:
        with self.lock:
            return sorted(self.children.get("/" + p.strip("/"), ()))

    def isdir(self, p: str) -> bool:
        with self.lock:
            return bool(self.children.get("/" + p.strip("/")))

    def getinfo(self, path: str, namespaces=None):
        with self.lock:
            if path in self.fail_info:
                raise OSError(f"fs: {path} is unreachable")
            if path not in self.files:
                raise FileNotFoundError(f"fs: {path} not found")
            data, mtime = self.files[path]
        return types.SimpleNamespace(
            name=path.rsplit("/", 1)[-1], size=len(data),
            modified=datetime.datetime.fromtimestamp(
                mtime, datetime.timezone.utc),
            created=None, user="tester")

    def readbytes(self, path: str) -> bytes:
        with self.lock:
            if path not in self.files:
                raise FileNotFoundError(f"fs: {path} not found")
            self.reads[path] += 1
            return self.files[path][0]


class SlackRecorder:
    """The Slack writer's ``_http(url, payload, headers)`` seam: records
    each call and answers ``{"ok": true}`` (or ``answer``)."""

    def __init__(self, answer: dict | None = None):
        self.posts: list = []
        self.answer = answer or {"ok": True}

    def __call__(self, url: str, payload: dict, headers: dict) -> dict:
        self.posts.append((url, payload, dict(headers)))
        return self.answer


def airbyte_command() -> list:
    """The fake connector's argv: ``-S`` skips the site hooks (interpreter
    start in milliseconds)."""
    return [sys.executable, "-S", AIRBYTE_CONNECTOR]


def write_airbyte_data(path, users=(), colors=()) -> None:
    """The fake connector's data file: ``users`` (incremental, cursor
    ``id``) and ``colors`` (full refresh)."""
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump({"users": list(users), "colors": list(colors)}, f)
    os.replace(tmp, path)


def airbyte_yaml(path, data_path) -> str:
    """A connection file whose source runs the fake connector."""
    cmd = " ".join(airbyte_command())
    with open(path, "w") as f:
        f.write(f'source:\n  exec: "{cmd}"\n  config:\n'
                f'    data_path: "{data_path}"\n')
    return str(path)
