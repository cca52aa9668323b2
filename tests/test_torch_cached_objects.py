"""``CachedObjectStorage`` and the file source's object cache, of the port
against the JAX package's: objects stored and versioned in the backend,
the rest of a file whose origin vanished served from the cache, and a
restart after the source file was deleted giving the same output.  The
JAX source scans inside ``poll``; the port's scans on its own thread, so
the port's cases call ``scan`` where the JAX ones call ``poll``.  A
failing cache raises in the port (the JAX source skips the file or
drops the cache entry)."""

import json
import os

import pytest

import pathway_tpu_torch as tpw
from pathway_tpu.persistence.cached_objects import (
    CachedObjectStorage as JCache)
from pathway_tpu_torch.persistence.cached_objects import (
    CachedObjectStorage as TCache)

from .torch_parity import fresh_port  # noqa: F401
from .torch_persist import PKGS, backend, both, run

CACHES = {"jax": JCache, "torch": TCache}


@pytest.fixture(autouse=True)
def _fresh(fresh_port):  # noqa: F811
    yield


@pytest.mark.parametrize("pkg", list(PKGS))
def test_store_roundtrip_and_versioning(tmp_path, pkg):
    be = backend(pkg, tmp_path / "pstore")
    cache = CACHES[pkg](be)
    cache.put("s3://bucket/a.txt", b"hello", version=1,
              metadata={"etag": "x"})
    assert cache.contains("s3://bucket/a.txt")
    assert cache.get("s3://bucket/a.txt") == b"hello"
    assert cache.version("s3://bucket/a.txt") == 1
    assert cache.metadata("s3://bucket/a.txt") == {"etag": "x"}
    cache.put("s3://bucket/a.txt", b"ignored", version=1)
    assert cache.get("s3://bucket/a.txt") == b"hello"
    cache.put("s3://bucket/a.txt", b"world", version=2)
    assert cache.get("s3://bucket/a.txt") == b"world"
    cache2 = CACHES[pkg](be)  # the index persists across instances
    assert cache2.list_uris() == ["s3://bucket/a.txt"]
    assert cache2.get("s3://bucket/a.txt") == b"world"
    cache2.remove("s3://bucket/a.txt")
    assert CACHES[pkg](be).list_uris() == []


def test_deferred_saves_the_index_once(tmp_path):
    """Inside ``deferred()`` the puts save the index once, at the end."""
    be = backend("torch", tmp_path)
    saves = []
    real = be.put_metadata
    be.put_metadata = lambda k, v: (saves.append(k), real(k, v))
    cache = TCache(be)
    with cache.deferred():
        for i in range(5):
            cache.put(f"f{i}", b"x", version=i)
        assert saves == []
    assert saves == ["objcache:index"]
    assert TCache(backend("torch", tmp_path)).list_uris() == [
        f"f{i}" for i in range(5)]


def _scan(pkg, source):
    if pkg == "jax":
        source.poll_interval_s = 0.0
        source._last_poll = 0.0
        return source.poll()
    return source.scan()


def test_vanished_file_served_from_cache(tmp_path):
    """A crash between a read and its ingest: the object was cached with
    more rows than the offsets say were emitted, and the origin is gone;
    the remaining rows flow from the cache, once."""
    out = {}
    for pkg, (pw, pg) in PKGS.items():
        root = tmp_path / pkg
        data_dir = root / "data"
        data_dir.mkdir(parents=True)
        f = data_dir / "a.txt"
        f.write_text("r1\nr2\nr3\n")
        be = backend(pkg, root / "pstore")
        pg.G.clear()
        t = pw.io.plaintext.read(str(data_dir / "*.txt"), mode="streaming") \
            if pkg == "jax" else pw.io.fs.read(str(data_dir / "*.txt"),
                                                format="plaintext",
                                                mode="streaming")
        source = t._node.params["source"]
        source.object_cache = CACHES[pkg](be)
        assert len(_scan(pkg, source)) == 3
        assert source.object_cache.contains(str(f))
        os.remove(f)
        pg.G.clear()
        t2 = pw.io.plaintext.read(str(data_dir / "*.txt"), mode="streaming") \
            if pkg == "jax" else pw.io.fs.read(str(data_dir / "*.txt"),
                                                format="plaintext",
                                                mode="streaming")
        source2 = t2._node.params["source"]
        source2.object_cache = CACHES[pkg](be)
        source2.seek({str(f): 1})
        rows = sorted(e[2][0] for e in _scan(pkg, source2))
        assert _scan(pkg, source2) == []  # once
        out[pkg] = rows
    assert out["torch"] == out["jax"] == ["r2", "r3"]


def test_e2e_restart_after_source_deletion(tmp_path):
    """Ingest under persistence, delete the source file, restart: the
    output is unchanged (journal and object cache together)."""
    def scenario(pkg, root):
        pw, pg = PKGS[pkg]
        data_dir = root / "data"
        data_dir.mkdir(parents=True)
        (data_dir / "a.txt").write_text("alpha\nbeta\n")
        out = root / "out.jsonl"

        def run_once():
            pg.G.clear()
            t = pw.io.fs.read(str(data_dir / "*.txt"), format="plaintext",
                              mode="streaming", with_metadata=True)
            counts = t.groupby(t.data).reduce(word=t.data,
                                              c=pw.reducers.count())
            pw.io.jsonlines.write(counts, str(out))
            run(pkg, idle_stop_s=0.8, autocommit_duration_ms=50,
                persistence_config=pw.persistence.Config(
                    backend(pkg, root / "pstore")))

        def net():
            acc = {}
            for ln in out.read_text().splitlines() if out.exists() else []:
                e = json.loads(ln)
                acc[e["word"]] = acc.get(e["word"], 0) + e["diff"]
            return acc

        run_once()
        first = net()
        os.remove(data_dir / "a.txt")
        out.unlink()
        run_once()
        return first, net()

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"]
    first, second = got["torch"]
    assert first == {"alpha": 1, "beta": 1}
    # the restart replays the journal: nothing retracted, nothing twice
    assert second == first


def test_with_metadata_persists_the_cache_index(tmp_path):
    """``fs.read(with_metadata=True)``: the cached metadata is stored as
    JSON and comes back as the rows' ``_metadata`` when the origin is
    gone.  (The JAX source hands the index a ``Json`` it cannot encode;
    its put fails as if the file did not parse, and the index is never
    saved.)"""
    pw, pg = PKGS["torch"]
    data_dir = tmp_path / "data"
    data_dir.mkdir()
    f = data_dir / "a.txt"
    f.write_bytes(b"payload")
    be = backend("torch", tmp_path / "pstore")
    pg.G.clear()
    t = pw.io.fs.read(str(data_dir), format="binary", mode="streaming",
                      with_metadata=True)
    source = t._node.params["source"]
    source.object_cache = TCache(be)
    [(_t, _k, row, _d)] = source.scan()
    cache = TCache(backend("torch", tmp_path / "pstore"))
    assert cache.metadata(str(f))["name"] == "a.txt"
    os.remove(f)
    pg.G.clear()
    t2 = pw.io.fs.read(str(data_dir), format="binary", mode="streaming",
                       with_metadata=True)
    source2 = t2._node.params["source"]
    source2.object_cache = cache
    [(_t, _k, row2, _d)] = source2.scan()
    assert row2 == row  # bytes and _metadata, from the cache


def _fs_source(tmp_path, be):
    pw, pg = PKGS["torch"]
    data_dir = tmp_path / "data"
    data_dir.mkdir(exist_ok=True)
    (data_dir / "a.txt").write_text("one\ntwo\n")
    pg.G.clear()
    t = pw.io.fs.read(str(data_dir), format="plaintext", mode="streaming")
    source = t._node.params["source"]
    source.object_cache = TCache(be)
    return source, data_dir


def test_a_failing_cache_write_fails_the_scan(tmp_path):
    """The JAX source swallows an OSError of the cache's put, so a later
    deletion of that file retracts its rows instead of keeping them."""
    be = backend("torch", tmp_path / "pstore")
    source, _dir = _fs_source(tmp_path, be)

    def broken(stream, records):
        raise OSError("backend full")

    be.replace_all = broken
    with pytest.raises(OSError, match="backend full"):
        source.scan()


def test_an_unreadable_cache_index_raises(tmp_path):
    """The JAX cache starts empty over an index that does not parse, so
    rows it serves for vanished files would be retracted."""
    be = backend("torch", tmp_path / "pstore")
    be.put_metadata("objcache:index", b"{not json")
    with pytest.raises(RuntimeError, match="index .* is unreadable"):
        TCache(be)


def test_a_cached_object_that_does_not_parse_raises(tmp_path):
    """The JAX source skips a cached object whose parse raises, losing
    its rows without a word."""
    be = backend("torch", tmp_path / "pstore")
    source, data_dir = _fs_source(tmp_path, be)
    source.scan()
    os.remove(data_dir / "a.txt")
    pg = PKGS["torch"][1]
    pg.G.clear()
    t = tpw.io.fs.read(str(data_dir), format="plaintext", mode="streaming")
    source2 = t._node.params["source"]
    source2.object_cache = TCache(be)

    def bad_parse(p, data=None, cached_metadata=None):
        raise UnicodeDecodeError("utf-8", b"", 0, 1, "bad")

    source2.parse_file = bad_parse
    with pytest.raises(UnicodeDecodeError):
        source2.scan()
