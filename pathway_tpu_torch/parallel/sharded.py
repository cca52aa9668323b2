"""Sharded engine execution: the data plane's parallelism tier.

The port of ``pathway_tpu/parallel/sharded.py`` (the reference's timely
worker sharding, src/engine/dataflow/shard.rs): collections are
partitioned by key across S shards, and operators exchange records at
re-key boundaries.  Each operator gets S replicas; every edge has a
router deciding the owning shard of each update:

  - key-partitioned ops (rowwise/filter/output-merge): route by row key
  - groupby: route by the group key (computed from the same exprs the
    operator uses) — the exchange the reference performs at dataflow.rs:3775
  - join: route by join-key hash (both sides use the same hash, so matching
    rows collide on one shard)
  - non-shardable ops (ix, iterate, external index, temporal buffers):
    centralized on shard 0, like the reference centralizes its time buffer
    (time_column.rs:49-50 shard=1)

Row keys and the group and join hashes are the native tier's
(``internals/value.py``), bit for bit the JAX package's, so a key lands
on the same shard in both packages.  Execution walks (time, topo-op,
shard) deterministically, so results equal the single-shard engine's.
On one host the shards model the reference's threads; across processes
the same routing becomes a key exchange over the fabric (``comm.py``).
"""

from __future__ import annotations

from typing import Callable

from ..engine import runner as runner_mod
from ..engine.types import Update
from ..internals import parse_graph as pg
from ..internals.value import hash_values, ref_scalar

_SHARD_BY_KEY = "key"
_CENTRAL = "central"
_BROADCAST = "broadcast"  # replicate to every shard (small side tables)


def _route_all_shard0(update, n):
    return 0


class ShardRouter:
    """Per-edge routing: update -> shard id."""

    def __init__(self, kind: str, n_shards: int, fn: Callable | None = None):
        self.kind = kind
        self.n = n_shards
        self.fn = fn

    def shard_of(self, update: Update) -> int:
        if self.kind == _CENTRAL:
            return 0
        if self.fn is not None:
            return self.fn(update) % self.n
        return update[0] % self.n  # route by row key


def _groupby_router(node: pg.OpNode, n: int) -> ShardRouter:
    p = node.params
    src = node.input_tables[0]
    env = runner_mod._env_for(src)
    gb_fns = [runner_mod._compile(e) for e in p["gb_exprs"]]
    if p.get("instance") is not None:
        gb_fns.append(runner_mod._compile(p["instance"]))
    key_fn = (
        runner_mod._compile(p["id_expr"]) if p.get("id_expr") is not None else None
    )

    def fn(update):
        key, row, _d = update
        e = env.build(key, row)
        if key_fn is not None:
            return int(key_fn(e))
        gvals = tuple(f(e) for f in gb_fns)
        return int(ref_scalar(*gvals))

    return ShardRouter("fn", n, fn)


def _join_router(node: pg.OpNode, port: int, n: int) -> ShardRouter:
    p = node.params
    side = node.input_tables[port]
    env = runner_mod._env_for(side)
    on = p["left_on"] if port == 0 else p["right_on"]
    fns = [runner_mod._compile(e) for e in on]

    def fn(update):
        key, row, _d = update
        e = env.build(key, row)
        return int(hash_values(*[f(e) for f in fns]))

    return ShardRouter("fn", n, fn)


_SHARDABLE = {"rowwise", "filter", "reindex", "concat", "flatten", "input",
              "groupby", "join", "update_rows", "update_cells", "difference",
              "intersect", "deduplicate"}


def edge_router(down_node: pg.OpNode, port: int, n: int) -> ShardRouter:
    kind = down_node.kind
    if kind == "groupby":
        return _groupby_router(down_node, n)
    if kind == "join":
        return _join_router(down_node, port, n)
    if kind == "deduplicate":
        # route by instance so per-instance state is local
        p = down_node.params
        src = down_node.input_tables[0]
        env = runner_mod._env_for(src)
        inst_fns = [runner_mod._compile(e) for e in p["instance_exprs"]]

        def fn(update):
            key, row, _d = update
            e = env.build(key, row)
            ivals = tuple(f(e) for f in inst_fns)
            return int(ref_scalar(*ivals)) if ivals else 0

        return ShardRouter("fn", n, fn)
    if kind == "gradual_broadcast":
        # big table stays key-partitioned; the tiny threshold table is
        # replicated to every shard (reference: value_stream .broadcast(),
        # operators/gradual_broadcast.rs:96)
        return ShardRouter(
            _SHARD_BY_KEY if port == 0 else _BROADCAST, n
        )
    if kind in _SHARDABLE:
        return ShardRouter(_SHARD_BY_KEY, n)
    if kind in ("capture", "subscribe", "output", "raw_output"):
        return ShardRouter(_CENTRAL, n)
    return ShardRouter(_CENTRAL, n)
