"""pathway_tpu_torch tensor parallelism against the JAX package.

The port shards a decoder over a ``TPMesh`` of logical shards
(``["cpu"] * tp`` here, the counterpart of the conftest's 8 virtual XLA
devices).  At the JAX tests' fixture (vocab 64, d 64, 2 layers, 8
heads, d_ff 128) and on the same converted weights:

- ``PagedDecodeEngine(tp=2|4|8)`` greedy tokens equal the port's tp = 1
  tokens, the dense oracle (``prefill`` + ``decode_step``) and the JAX
  ``PagedDecodeEngine(tp=8)``'s, exactly, for mixed lengths, shared
  prefixes, preemption with recompute, whole-bucket prefill, chained
  decode, int8 plans and the speculative n-gram verify; sampled
  requests at a fixed seed equal tp = 1's;
- the pool is really sharded (a head slice a shard, on its device,
  ``per_shard_bytes * tp`` the whole pool), tp = 1 builds no mesh, and
  impossible degrees raise with the legal values;
- per-shard pool metrics carry a ``shard=`` label;
- the layout rules, the per-shard QKV fusion and the collectives equal
  the JAX package's;
- ``knn_sharded.sharded_topk`` and ``BruteForceKnn(mesh=)`` equal the JAX
  sharded search (ids exact in ``lax.top_k`` order, scores within 1e-5).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pathway_tpu.kvcache.engine import PagedDecodeEngine as JaxEngine
from pathway_tpu.models import decoder as jdec
from pathway_tpu.obs import profiler as jprof
from pathway_tpu.ops import knn_sharded as jks
from pathway_tpu.parallel import mesh as jmesh
from pathway_tpu_torch.kvcache.engine import PagedDecodeEngine, resolve_tp
from pathway_tpu_torch.models import decoder as tdec
from pathway_tpu_torch.models.convert import decoder_params_from_numpy
from pathway_tpu_torch.ops import knn_sharded as tks
from pathway_tpu_torch.parallel import mesh as tmesh
from pathway_tpu_torch.stdlib.indexing.inner_index import BruteForceKnn

WIDTHS = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=8, d_ff=128,
              max_len=128)
CFG_J = jdec.DecoderConfig(**WIDTHS)
CFG_T = tdec.DecoderConfig(**WIDTHS)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread while this module runs: its ops are tiny, and
    under xdist every worker's default of a thread a core oversubscribes
    the machine's cores many times over (tp = 8 runs took 100-200x
    longer with six workers than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _jax_registry_as_found():
    """The JAX engines' program records are removed after each test (the
    JAX package's own profiler tests read its process-wide registry)."""
    reg = jprof.registry()
    keys = set(reg._records)
    yield
    with reg._lock:
        for k in set(reg._records) - keys:
            del reg._records[k]


@pytest.fixture(scope="module")
def weights():
    pj = jdec.init_decoder_params(CFG_J, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, pj)
    return pj, decoder_params_from_numpy(tree, CFG_T, device="cpu")


def _prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, WIDTHS["vocab_size"], size=n)]
            for n in lengths]


def _dense_greedy(params, prompt, n_new, bucket=64):
    """The port's dense oracle: batch-1 ``prefill`` + ``decode_step``."""
    n = len(prompt)
    buf = torch.zeros((1, bucket), dtype=torch.long)
    buf[0, :n] = torch.tensor(prompt)
    logits, cache = tdec.prefill(params, CFG_T, buf, torch.tensor([n]))
    out = [int(logits[0].argmax())]
    for pos in range(n, n + n_new - 1):
        logits, cache = tdec.decode_step(params, CFG_T, cache,
                                         torch.tensor([out[-1]]), pos)
        out.append(int(logits[0].argmax()))
    return out


_BASE = dict(num_blocks=96, block_size=4, max_batch_size=4,
             seq_buckets=(16, 32, 64), prefill_chunk=8)

# case -> (engine keywords, prompt lengths, prompt seed, new tokens)
CASES = {
    "mixed_lengths": ({}, (3, 5, 8, 11, 16, 17, 27, 31), 7, 8),
    "preemption": (dict(num_blocks=13, seq_buckets=(12, 20),
                        prefix_sharing=False), (10, 10, 10, 10), 3, 10),
    "whole_bucket": (dict(block_size=8, chunked_prefill=False),
                     (6, 13, 21, 30), 13, 6),
    "chained": (dict(chain_steps=8), (3, 9, 15, 21), 11, 17),
    "int8": (dict(quantize="int8"), (3, 9, 15, 21), 11, 9),
    "speculative": (dict(speculative="ngram"), (4, 6, 9), 5, 14),
}


def _case(name):
    kw, lengths, seed, n_new = CASES[name]
    prompts = _prompts(lengths, seed)
    if name == "speculative":
        # repetitive contexts: the n-gram drafter proposes and the
        # verify both accepts and rejects
        prompts = [p * 3 for p in prompts]
    return {**_BASE, **kw}, [(p, n_new) for p in prompts]


def _port(params, tp, name, **kw):
    devices = ["cpu"] * tp if tp > 1 else None
    return PagedDecodeEngine(CFG_T, params, tp=tp, devices=devices,
                             device="cpu", name=name, **kw)


_JAX_TP8: dict = {}


def _jax_tp8(pj, name):
    """The JAX package's tp = 8 engine on the same weights (once per
    case)."""
    if name not in _JAX_TP8:
        kw, reqs = _case(name)
        eng = JaxEngine(CFG_J, pj, tp=8, attn="reference",
                        name=f"t_torch_tp_j_{name}", **kw)
        _JAX_TP8[name] = eng.generate_batch(list(reqs))
    return _JAX_TP8[name]


_PORT_TP1: dict = {}


def _port_tp1(pt, name):
    if name not in _PORT_TP1:
        kw, reqs = _case(name)
        _PORT_TP1[name] = _port(pt, 1, f"t_torch_tp1_{name}",
                                **kw).generate_batch(list(reqs))
    return _PORT_TP1[name]


@pytest.mark.parametrize("case", sorted(CASES))
def test_tp1_tokens_equal_the_jax_tp8_engine_and_the_dense_oracle(weights,
                                                                  case):
    """The anchor of the tp cases below: the port's tp = 1 tokens equal
    the JAX package's tp = 8 engine's on the same weights (and, in f32,
    the dense oracle's)."""
    pj, pt = weights
    _kw, reqs = _case(case)
    got = _port_tp1(pt, case)
    assert got == _jax_tp8(pj, case)
    if case in ("mixed_lengths", "whole_bucket", "chained"):
        # f32: the dense oracle too (int8 may flip near-tied argmaxes)
        assert got == [_dense_greedy(pt, p, n) for p, n in reqs]


@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tp_tokens_equal_tp1(weights, case, tp):
    """tp = 2, 4, 8 give the tp = 1 tokens exactly (and so the JAX tp = 8
    engine's and, in f32, the dense oracle's: the test above)."""
    _pj, pt = weights
    kw, reqs = _case(case)
    eng = _port(pt, tp, f"t_torch_tp{tp}_{case}", **kw)
    got = eng.generate_batch(list(reqs))
    assert got == _port_tp1(pt, case)
    if case == "preemption":
        assert eng.pool.n_preemptions > 0
    if case == "whole_bucket":
        assert eng.rounds["prefill"] > 0
    if case == "chained":
        assert eng.rounds["chain"] > 0
    if case == "int8":
        assert eng._prog_suffix == "_i8"
    if case == "speculative":
        assert eng.rounds["verify"] > 0
    assert not eng.pool.sequences()
    eng.pool.check_invariants(eng.prefix.external_refs()
                              if eng.prefix is not None else None)


@pytest.mark.parametrize("tp", [2, 8])
def test_tp_identity_under_shared_prefixes(weights, tp):
    _pj, pt = weights
    header = [11] * 8 + [13] * 8
    prompts = [header + [20 + i, 30 + i] for i in range(5)] + [list(header)]
    kw = dict(_BASE, block_size=8, max_batch_size=8, seq_buckets=(32, 64),
              prefill_chunk=16)
    outs, hits = {}, {}
    for t in (1, tp):
        eng = _port(pt, t, f"t_torch_tp_px{tp}_{t}", **kw)
        outs[t] = eng.generate_batch([(p, 6) for p in prompts])
        hits[t] = eng.pool.kv_stats.snapshot()["prefix_hits"]
    assert outs[tp] == outs[1]
    # sharing is host-side bookkeeping: identical hit counts either way
    assert hits[tp] == hits[1] > 0


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_sampled_tokens_at_a_fixed_seed_equal_tp1(weights, tp):
    _pj, pt = weights
    prompts = _prompts((5, 12, 19), 21)
    reqs = [(prompts[0], 10, {"sampling": (0.8, 8, 0.9, 7)}),
            (prompts[1], 10, {"sampling": (1.2, 0, 1.0, 99)}),
            (prompts[2], 10)]
    for chunked in (True, False):
        kw = dict(_BASE, chunked_prefill=chunked)
        want = _port(pt, 1, f"t_torch_tps1_{chunked}", **kw) \
            .generate_batch(list(reqs))
        got = _port(pt, tp, f"t_torch_tps{tp}_{chunked}", **kw) \
            .generate_batch(list(reqs))
        assert got == want


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_the_pool_and_the_plan_are_really_sharded(weights, tp):
    _pj, pt = weights
    eng = _port(pt, tp, f"t_torch_tp_shards{tp}", **_BASE)
    assert eng.tp == tp and eng.mesh.size == tp
    assert len(eng.params) == tp
    heads = CFG_T.n_heads // tp
    hd = CFG_T.d_model // CFG_T.n_heads
    assert len(eng.pool.shards) == tp
    for (k, v), dev in zip(eng.pool.shards, eng.mesh.devices):
        for t in (k, v):
            assert t.device == dev
            assert tuple(t.shape) == (CFG_T.n_layers, _BASE["num_blocks"],
                                      _BASE["block_size"], heads, hd)
    whole = sum(k.nbytes + v.nbytes for k, v in eng.pool.shards)
    assert eng.pool.per_shard_bytes * tp == whole
    one = _port(pt, 1, "t_torch_tp_shards1", **_BASE)
    assert whole == one.pool.per_shard_bytes
    assert eng.pool.state_bytes_per_seq(9) == one.pool.state_bytes_per_seq(9)
    # each shard's plan holds its slice: vocab rows, QKV and FFN columns
    p0 = eng.params[0]
    assert tuple(p0["embed"].shape) == (CFG_T.vocab_size // tp,
                                        CFG_T.d_model)
    assert tuple(p0["embed_t"].shape) == (CFG_T.d_model,
                                          CFG_T.vocab_size // tp)
    layer = p0["layers"][0]
    assert tuple(layer["wqkv"].shape) == (CFG_T.d_model,
                                          3 * CFG_T.d_model // tp)
    assert tuple(layer["wo"].shape) == (CFG_T.d_model // tp, CFG_T.d_model)
    assert tuple(layer["w_down"].shape) == (CFG_T.d_ff // tp, CFG_T.d_model)


def test_tp1_builds_no_mesh(weights):
    _pj, pt = weights
    assert resolve_tp(CFG_T, None) == 1  # no card here
    for tp in (None, 1):
        eng = PagedDecodeEngine(CFG_T, pt, tp=tp, device="cpu",
                                name=f"t_torch_tp_none{tp}", **_BASE)
        assert eng.tp == 1 and eng.mesh is None
        assert len(eng.pool.shards) == 1
        assert isinstance(eng.params, dict)
    # an explicit one-device list is tp = 1 too
    eng = PagedDecodeEngine(CFG_T, pt, devices=["cpu"], device="cpu",
                            name="t_torch_tp_one", **_BASE)
    assert eng.tp == 1 and eng.mesh is None


@pytest.mark.parametrize("kind", ["paged", "state"])
def test_an_engine_on_the_cpu_takes_no_card(weights, kind, monkeypatch):
    """On a host that sees cards, an engine asked to run on the CPU stays
    one shard on the CPU (its CPU tier must not move to the cards), an
    explicit tp > 1 there needs ``devices=``, and on the card ``tp=None``
    is 1 while ``tp=2`` takes two cards from the engine's own."""
    from pathway_tpu_torch.kvcache.engine import engine_shards
    from pathway_tpu_torch.kvcache.statecache import StateDecodeEngine

    _pj, pt = weights
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert resolve_tp(CFG_T, None) == 4  # what the four cards could take

    def build(**kw):
        if kind == "paged":
            return PagedDecodeEngine(CFG_T, pt, device="cpu",
                                     name="t_torch_tp_cpu", **_BASE, **kw)
        return StateDecodeEngine(CFG_T, pt, device="cpu", max_slots=8,
                                 name="t_torch_tp_cpu_state", **kw)

    eng = build()
    assert eng.tp == 1 and eng.mesh is None
    assert eng.device == torch.device("cpu")
    shards = eng.pool.shards
    assert len(shards) == 1 and all(
        t.device.type == "cpu"
        for t in (shards[0] if kind == "paged" else shards))
    with pytest.raises(ValueError, match=r"tp=2 > 1 local devices"):
        build(tp=2)
    assert engine_shards(CFG_T, None, None, torch.device("cuda")) == (
        1, None, torch.device("cuda"))
    tp, mesh, home = engine_shards(CFG_T, 2, None, torch.device("cuda", 1))
    assert tp == 2 and mesh.devices == [torch.device("cuda", 1),
                                        torch.device("cuda", 2)]
    assert home == torch.device("cuda", 1)
    with pytest.raises(ValueError, match=r"tp=4 > 3 local devices"):
        engine_shards(CFG_T, 4, None, torch.device("cuda", 1))


def test_impossible_tp_values_raise_with_the_legal_list(weights):
    _pj, pt = weights
    with pytest.raises(ValueError, match=r"n_kv_heads=8 % tp=3"):
        _port(pt, 3, "t_torch_tp_bad3", **_BASE)
    with pytest.raises(ValueError) as exc:
        resolve_tp(CFG_T, 3, 8)
    msg = str(exc.value)
    assert "n_kv_heads=8 % tp=3" in msg and "vocab_size=64 % tp=3" in msg
    assert re.search(r"Legal tp values.*\[1, 2, 4, 8\]", msg)
    # d_ff is tp-split too
    cfg_ff = tdec.DecoderConfig(vocab_size=64, d_model=64, n_layers=1,
                                n_heads=8, d_ff=132, max_len=64)
    with pytest.raises(ValueError, match=r"d_ff=132 % tp=8 != 0"):
        resolve_tp(cfg_ff, 8, 8)
    # GPT-2 small: 50257 = 29 x 1733 shards at no degree above 1
    gpt2 = tdec.DecoderConfig(vocab_size=50257, d_model=768, n_layers=12,
                              n_heads=12, d_ff=3072, max_len=1024)
    with pytest.raises(ValueError,
                       match=r"vocab_size=50257 % tp=2 .*Legal tp values "
                             r"for this model/host: \[1\]"):
        resolve_tp(gpt2, 2, 8)
    # more shards than devices, by the CUDA count (none here) or a list
    with pytest.raises(ValueError, match=r"tp=2 > 1 local devices"):
        resolve_tp(CFG_T, 2)
    with pytest.raises(ValueError, match="local devices"):
        PagedDecodeEngine(CFG_T, pt, tp=4, devices=["cpu"] * 2,
                          device="cpu", name="t_torch_tp_few", **_BASE)
    with pytest.raises(ValueError, match="local devices"):
        tmesh.validate_decoder_tp(64, 64, 64, n_devices=8)


def test_per_shard_metrics_carry_the_shard_label(weights):
    from pathway_tpu_torch.serve import metrics as M

    _pj, pt = weights
    eng = _port(pt, 8, "t_torch_tp_metrics", **dict(
        _BASE, block_size=8, max_batch_size=2, seq_buckets=(16,)))
    eng.generate_batch([([1, 2, 3, 4, 5], 4), ([6, 7], 3)])
    snap = eng.pool.kv_stats.snapshot()
    assert snap["shards"] == 8
    assert snap["shard_hbm_bytes"] == eng.pool.per_shard_bytes
    lines = "\n".join(M.render_prometheus_lines())
    lbl = f'pool="{eng.pool.name}"'
    for shard in (0, 7):
        assert (f'pathway_kv_shard_hbm_bytes{{{lbl},shard="{shard}"}} '
                f"{eng.pool.per_shard_bytes}") in lines
        assert (f'pathway_kv_shard_blocks_in_use{{{lbl},shard="{shard}"}}'
                in lines)
    assert f'{lbl},shard="8"' not in lines
    points = [p for p in M.otlp_points("0")
              if any(a["key"] == "shard" for a in p["attributes"])
              and any(a["key"] == "pool"
                      and a["value"]["stringValue"] == eng.pool.name
                      for a in p["attributes"])]
    assert len(points) == 16  # 8 shards x (hbm bytes, blocks in use)


def test_serving_executor_and_fleet_thread_tp_through(weights):
    from pathway_tpu_torch.models.host_decoder import Int8DecoderHost
    from pathway_tpu_torch.serve.fleet import ReplicaFleet

    _pj, pt = weights
    prompt = [3, 1, 4, 1, 5]
    want = _dense_greedy(pt, prompt, 6)
    host = Int8DecoderHost(CFG_T, pt)
    sched = host.serving_executor(tp=2, devices=["cpu"] * 2, device="cpu",
                                  max_batch_size=4, name="t_torch_tp_exec")
    try:
        engine = host.paged_engine()
        assert engine.tp == 2 and engine.mesh is not None
        assert sched.submit((prompt, 6)) == want
    finally:
        sched.shutdown()
    fleet = ReplicaFleet(CFG_T, pt, replicas=2, name="t_torch_tp_fleet",
                         max_restarts=0, device="cpu", tp=4,
                         devices=["cpu"] * 4, **_BASE)
    try:
        assert all(r.engine.tp == 4 for r in fleet._replicas)
        assert fleet.submit(prompt, 6) == want
    finally:
        fleet.shutdown()


def test_restart_and_sessions_work_over_a_sharded_pool(weights):
    """A supervised restart rebuilds the sharded pool and recomputes, and
    a session suspends and resumes every shard's blocks: both give the
    uninterrupted tp = 1 tokens."""
    from pathway_tpu_torch import faults
    from pathway_tpu_torch.kvcache import SessionStore

    _pj, pt = weights
    reqs = [(p, 9) for p in _prompts((5, 12, 19), 17)]
    want = _port(pt, 1, "t_torch_tp_rs1", **_BASE).generate_batch(reqs)
    eng = _port(pt, 4, "t_torch_tp_rs4", max_restarts=1, **_BASE)
    faults.install("engine.dispatch.mixed", "raise", nth=3)
    try:
        assert eng.generate_batch(list(reqs)) == want
    finally:
        faults.clear()
    assert eng.n_restarts == 1 and len(eng.pool.shards) == 4
    turn1 = reqs[1][0]
    outs = {}
    for tp in (1, 4):
        store = SessionStore()
        e = _port(pt, tp, f"t_torch_tp_sess{tp}", session_store=store,
                  **_BASE)
        first = e.generate_batch([(turn1, 4, {"session": "c1"})])[0]
        turn2 = turn1 + first + [2, 3]
        second = e.generate_batch([(turn2, 5, {"session": "c1"})])[0]
        assert store.n_resumes == 1 and store.n_suspend_failures == 0
        outs[tp] = (first, second)
    assert outs[4] == outs[1]


# -- the mesh module against the JAX package -------------------------------


def test_decoder_layout_rules_equal_the_reference(weights):
    _pj, pt = weights
    plan = tdec.plan_decode_params(CFG_T, pt, tp=4)
    plan8 = tdec.plan_decode_params(CFG_T, pt, tp=4, quantize="int8",
                                    native=True)
    ssd = tdec.ssd_augment_params(pt, CFG_T)
    for tree in (pt, plan, plan8, ssd):
        for path, shape in _leaf_paths(tree):
            want = tuple(jmesh.decoder_param_sharding_rules(path, shape))
            got = tmesh.decoder_param_sharding_rules(path, shape)
            assert got + (None,) * (len(want) - len(got)) == want + (
                None,) * (len(got) - len(want)), path
    for path, shape in _leaf_paths(pt):
        assert tmesh.param_sharding_rules(path, shape) == tuple(
            jmesh.param_sharding_rules(path, shape)), path


def _leaf_paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_paths(v, path + (str(k),))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, path + (str(i),))
    else:
        yield path, tuple(tree.shape)


@pytest.mark.parametrize("tp", [1, 2, 8])
def test_fused_qkv_layout_equals_the_reference(weights, tp):
    pj, pt = weights
    jplan = jdec.plan_decode_params(CFG_J, pj, tp=tp)
    tplan = tdec.plan_decode_params(CFG_T, pt, tp=tp)
    np.testing.assert_array_equal(np.asarray(jplan["layers"][0]["wqkv"]),
                                  tplan["layers"][0]["wqkv"].numpy())
    # biases fuse by the same rule
    vecs = [np.arange(16, dtype=np.float32) + 100 * i for i in range(3)]
    np.testing.assert_array_equal(
        np.asarray(jdec._fuse_cols([jnp.asarray(v) for v in vecs], tp)),
        tdec._fuse_cols([torch.from_numpy(v) for v in vecs], tp).numpy())
    # the shards of the fused leaf are the fusions of the unfused slices
    mesh = tmesh.TPMesh(["cpu"] * tp)
    shards = tmesh.shard_decoder_params(tplan, mesh)
    layer = pt["layers"][0]
    for s, shard in enumerate(shards):
        want = torch.cat([layer[w].chunk(tp, -1)[s]
                          for w in ("wq", "wk", "wv")], -1)
        assert torch.equal(shard["layers"][0]["wqkv"], want)


def test_collectives_add_in_shard_order_and_replicate():
    mesh = tmesh.TPMesh(["cpu"] * 3)
    parts = [torch.tensor([1e8, 1.0]), torch.tensor([1.0, 2.0]),
             torch.tensor([-1e8, 3.0])]
    out = mesh.psum(parts)
    want = (parts[0] + parts[1]) + parts[2]
    assert all(torch.equal(o, want) for o in out)
    gathered = mesh.all_gather([p[None] for p in parts])
    assert all(torch.equal(g, torch.stack(parts)) for g in gathered)
    rot = mesh.ppermute(parts)
    assert [r[1].item() for r in rot] == [3.0, 1.0, 2.0]
    x = [torch.arange(6.0).reshape(1, 6) + 10 * i for i in range(3)]
    a2a = mesh.all_to_all(x, split_dim=1, concat_dim=0)
    assert a2a[1].tolist() == [[2.0, 3.0], [12.0, 13.0], [22.0, 23.0]]


def test_a_body_with_no_mesh_issues_no_collective():
    def body(shard):
        y = yield from tmesh.shard_psum(torch.ones(2), shard)
        return y * 2

    assert torch.equal(tmesh.run_single(body(None)), torch.full((2,), 2.0))
    out = tmesh.TPMesh(["cpu"] * 4).spmd(body)
    assert all(torch.equal(o, torch.full((2,), 8.0)) for o in out)
    with pytest.raises(RuntimeError, match="collective"):
        tmesh.run_single(body(tmesh.Shard(0, 2, torch.device("cpu"))))


def test_tp_mesh_validates_the_devices():
    mesh = tmesh.tp_mesh(4, ["cpu"] * 4)
    assert mesh.size == 4 and mesh.shape == {"tp": 4}
    assert len(set(mesh.devices)) == 1
    with pytest.raises(ValueError, match="tp=2 with 4 devices"):
        tmesh.tp_mesh(2, ["cpu"] * 4)
    with pytest.raises(ValueError, match="CUDA device"):
        tmesh.tp_mesh(2, ["cuda:0", "cuda:1"])
    m2 = tmesh.make_mesh(8, dp=2, tp=4, devices=["cpu"] * 8)
    assert m2.shape == {"dp": 2, "tp": 4}
    assert tmesh.make_mesh(8, devices=["cpu"] * 8).shape == {"dp": 1,
                                                             "tp": 8}


def test_shard_params_follow_the_encoder_layout(weights):
    _pj, pt = weights
    mesh = tmesh.make_mesh(8, dp=2, tp=4, devices=["cpu"] * 8)
    shards = tmesh.shard_params(pt, mesh)
    assert len(shards) == 8
    wq = pt["layers"][0]["wq"]
    for flat, shard in enumerate(shards):
        assert torch.equal(shard["layers"][0]["wq"],
                           wq.chunk(4, 1)[flat % 4])
        assert torch.equal(shard["layers"][0]["ln1_scale"],
                           pt["layers"][0]["ln1_scale"])


# -- row-sharded KNN -----------------------------------------------------------


def _knn_data(seed):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((300, 16)).astype(np.float32)
    m[200:212] = m[7]  # a row duplicated more times than k
    q = rng.standard_normal((4, 16)).astype(np.float32)
    q[0] = m[7]
    return m, q


@pytest.mark.parametrize("n_dev", [2, 4, 8])
@pytest.mark.parametrize("metric", ["cos", "dot", "l2sq"])
def test_sharded_topk_equals_the_jax_one(metric, n_dev):
    m, q = _knn_data(n_dev)
    jm = Mesh(np.asarray(jax.devices()[:n_dev]), ("dp",))
    tm = tmesh.TPMesh(["cpu"] * n_dev, ("dp",))
    jv, ji = jks.sharded_topk(jm, "dp", m, q, 10, metric)
    tv, ti = tks.sharded_topk(tm, "dp", m, q, 10, metric)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(tv, np.asarray(jv), rtol=0, atol=1e-5)
    # the duplicated row's copies come lowest index first
    assert list(ti[0][:5]) == [7, 200, 201, 202, 203]
    assert tks.row_bucket(300, n_dev) == jks.row_bucket(300, n_dev)


@pytest.mark.parametrize("metric", ["cos", "dot", "l2sq"])
def test_brute_force_knn_on_a_mesh_equals_the_unsharded_index(metric):
    m, q = _knn_data(1)
    mesh = tmesh.TPMesh(["cpu"] * 4, ("dp",))
    flat = BruteForceKnn(16, metric=metric, device="cpu")
    sharded = BruteForceKnn(16, metric=metric, device="cpu", mesh=mesh)
    for i, row in enumerate(m):
        flat.add(i, row)
        sharded.add(i, row)
    for query in q:
        got, want = sharded.search(query, 10), flat.search(query, 10)
        assert [k for k, _ in got] == [k for k, _ in want]
        np.testing.assert_allclose([s for _, s in got],
                                   [s for _, s in want], atol=1e-5)
    assert sharded._mesh_matrix is not None  # the sharded path ran
    sharded.remove(3)
    flat.remove(3)
    assert [k for k, _ in sharded.search(q[1], 5)] == \
        [k for k, _ in flat.search(q[1], 5)]
