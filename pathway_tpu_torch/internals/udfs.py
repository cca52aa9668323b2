"""Result caches for host-side calls — the cache half of
``pathway_tpu/internals/udfs.py``: :class:`CacheStrategy`,
:class:`InMemoryCache`, :class:`DiskCache` and
:func:`with_cache_strategy`.

The key format (``"<name>:<hash_values(args, sorted kwargs)>"``) and the
on-disk layout (one pickle of ``(value,)`` a key, named by the key's
SHA-256) are the JAX package's, so a :class:`DiskCache` directory
written by one package is read by the other.  The executors, ``UDF``
and the retry strategies belong to the dataflow, which the port does
not copy.
"""

from __future__ import annotations

import functools
import hashlib
import os
import pickle
import tempfile
from typing import Any

from .value import hash_values


class CacheStrategy:
    def lookup(self, key: str):
        return None

    def store(self, key: str, value) -> None:
        pass


class InMemoryCache(CacheStrategy):
    def __init__(self):
        self._data: dict[str, Any] = {}

    def lookup(self, key):
        return self._data.get(key)

    def store(self, key, value):
        self._data[key] = value


class DiskCache(CacheStrategy):
    """One file a key under ``directory`` (default:
    ``$PATHWAY_PERSISTENT_STORAGE/udf_cache``, else ``pathway_tpu/
    udf_cache`` in the temporary directory, where the JAX package's
    default lies).  Only a directory this program or the JAX package
    wrote should be given: its files are unpickled."""

    def __init__(self, directory: str | None = None):
        self.directory = directory or os.path.join(
            os.environ.get("PATHWAY_PERSISTENT_STORAGE",
                           os.path.join(tempfile.gettempdir(), "pathway_tpu")),
            "udf_cache")
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.directory,
                            hashlib.sha256(key.encode()).hexdigest())

    def lookup(self, key):
        p = self._path(key)
        if os.path.exists(p):
            with open(p, "rb") as f:
                return pickle.load(f)
        return None

    def store(self, key, value):
        with open(self._path(key), "wb") as f:
            pickle.dump(value, f)


DefaultCache = DiskCache


def _cache_key(name: str, args, kwargs) -> str:
    return f"{name}:{hash_values(tuple(args), tuple(sorted(kwargs.items())))}"


def with_cache_strategy(fun, cache: CacheStrategy, name: str):
    """``fun`` behind ``cache``: a hit returns the stored value, a miss
    calls ``fun`` and stores ``(value,)`` (so a stored None is a hit)."""
    @functools.wraps(fun)
    def wrapper(*args, **kwargs):
        key = _cache_key(name, args, kwargs)
        hit = cache.lookup(key)
        if hit is not None:
            return hit[0]
        value = fun(*args, **kwargs)
        cache.store(key, (value,))
        return value

    return wrapper


__all__ = ["CacheStrategy", "DefaultCache", "DiskCache", "InMemoryCache",
           "with_cache_strategy"]
