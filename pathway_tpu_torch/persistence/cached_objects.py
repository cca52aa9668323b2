"""CachedObjectStorage: persist raw source objects so (re-)parsing survives
source disappearance (the port of ``pathway_tpu/persistence/
cached_objects.py``; reference: src/persistence/cached_object_storage.rs,
1,164 LoC).

The reference caches every object a scanner downloads (S3 key, Drive file,
local file) in the persistence backend, keyed by URI with a version stamp
and metadata; when the origin disappears — expired S3 key, deleted file —
the pipeline keeps serving the object's rows and restarts re-parse from the
cache instead of failing.

Here the store rides the same `Backend` journal/metadata API as the rest of
persistence (one `obj:` stream per URI, metadata index under `objcache:`),
and `FilePollingSource` consults it: every successfully read file is cached
(payload + mtime version), and a file that vanishes or turns unreadable is
served from the cache instead of being dropped.  An index that does not
parse raises (the JAX class starts empty, which would retract every
cache-served row whose origin is gone).
"""

from __future__ import annotations

import contextlib
import hashlib
import json
from typing import Any

from . import Backend


def _uri_key(uri: str) -> str:
    return hashlib.sha256(uri.encode()).hexdigest()[:32]


class CachedObjectStorage:
    def __init__(self, backend: Backend, prefix: str = "objcache"):
        self.backend = backend
        self.prefix = prefix
        self._index: dict[str, dict] = {}
        self._defer = 0        # open deferred() blocks
        self._dirty = False    # index changed inside them
        raw = backend.get_metadata(f"{self.prefix}:index")
        if raw:
            try:
                self._index = json.loads(raw.decode())
            except ValueError as exc:
                raise RuntimeError(
                    f"object cache index {self.prefix}:index is unreadable: "
                    f"{exc}") from exc

    # -- index -------------------------------------------------------------
    def _save_index(self) -> None:
        if self._defer:
            self._dirty = True
            return
        self.backend.put_metadata(
            f"{self.prefix}:index", json.dumps(self._index).encode()
        )

    @contextlib.contextmanager
    def deferred(self):
        """Save the index once, when the block ends, for every ``put`` and
        ``remove`` inside it (a file scan caches thousands of objects; the
        JAX class rewrites the whole index at each).  A caller that hands
        out rows read inside the block does so after it ends, so the index
        is durable before any journal record names them."""
        self._defer += 1
        try:
            yield self
        finally:
            self._defer -= 1
            if not self._defer and self._dirty:
                self._dirty = False
                self._save_index()

    def contains(self, uri: str) -> bool:
        return uri in self._index

    def version(self, uri: str) -> Any:
        entry = self._index.get(uri)
        return entry["version"] if entry else None

    def metadata(self, uri: str) -> dict | None:
        entry = self._index.get(uri)
        return entry["metadata"] if entry else None

    def list_uris(self) -> list[str]:
        return sorted(self._index)

    # -- payloads ----------------------------------------------------------
    def put(self, uri: str, payload: bytes, *, version: Any = None,
            metadata: dict | None = None) -> None:
        """Store/refresh one object.  Same version => no rewrite."""
        entry = self._index.get(uri)
        if entry is not None and version is not None and entry["version"] == version:
            return
        stream = f"{self.prefix}:obj:{_uri_key(uri)}"
        if hasattr(self.backend, "replace_all"):
            self.backend.replace_all(stream, [payload])
        else:  # append-only backend: last record wins
            self.backend.append(stream, payload)
        self._index[uri] = {
            "version": version, "metadata": metadata or {},
            "size": len(payload),
        }
        self._save_index()

    def get(self, uri: str) -> bytes | None:
        if uri not in self._index:
            return None
        stream = f"{self.prefix}:obj:{_uri_key(uri)}"
        records = self.backend.read_all(stream)
        return records[-1] if records else None

    def remove(self, uri: str) -> None:
        if uri in self._index:
            del self._index[uri]
            stream = f"{self.prefix}:obj:{_uri_key(uri)}"
            if hasattr(self.backend, "replace_all"):
                self.backend.replace_all(stream, [])
            self._save_index()
