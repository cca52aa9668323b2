"""pathway_tpu_torch.serve.ReplicaFleet against the JAX package.

The port's two-replica fleet and the JAX ``PagedDecodeEngine`` /
``ReplicaFleet`` run on the same weights (the JAX ``init_decoder_params``
converted by ``models/convert.py``) at the JAX fleet tests' widths and
engine sizes (``tests/test_fleet.py``):

- greedy and seeded submits give the JAX engine's and the JAX fleet's
  tokens, and a conversation's next turn routes back to the replica that
  holds its prefix, as the JAX fleet routes it;
- a second session turn resumes from the shared store and gives a fresh
  engine's tokens;
- a chain fault that kills one replica mid-decode (restart budget 0), and
  a verify fault on a speculative fleet, complete every request
  token-identically on the peer; with every replica dead ``submit``
  raises a typed ``EngineFailedError``;
- the engine-level degrade handoff (``tests/test_engine_restart.py``'s
  case) completes stranded requests as the JAX engine does;
- the JAX package's ``register_stream`` serves the port fleet: frames
  carry ``submit``'s tokens, a shed before the first token is a 429 and
  a dead fleet a 503.  The JAX HTTP front maps the JAX package's error
  types, so the route's submit function re-raises the port's
  ``ShedError`` / ``EngineFailedError`` as those (``_jax_facing``).

Destructive cases build their own fleets.
"""

import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

import pathway_tpu.serve as jserve
import pathway_tpu_torch.serve as tserve
from pathway_tpu import faults as jfaults
from pathway_tpu.kvcache import PagedDecodeEngine as JaxEngine
from pathway_tpu.kvcache import SessionStore as JaxStore
from pathway_tpu.models import decoder as jdec
from pathway_tpu_torch import faults
from pathway_tpu_torch.kvcache import PagedDecodeEngine, SessionStore
from pathway_tpu_torch.models import decoder as tdec
from pathway_tpu_torch.models.convert import decoder_params_from_numpy

WIDTHS = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=8, d_ff=128,
              max_len=128)
CFG_J = jdec.DecoderConfig(**WIDTHS)
CFG_T = tdec.DecoderConfig(**WIDTHS)
EKW = dict(num_blocks=96, block_size=4, max_batch_size=8,
           seq_buckets=(16, 32, 64), prefill_chunk=8, chain_steps=4)
PROMPTS = [[1, 2, 3, 4], [9, 8, 7, 6, 5], [4] * 10]
SPEC = (0.9, 8, 0.95, 777)


def fleet_weights():
    """(JAX params, the port's params): JAX ``init_decoder_params`` at
    PRNGKey(0), carried over as numpy."""
    pj = jdec.init_decoder_params(CFG_J, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, pj)
    return pj, decoder_params_from_numpy(tree, CFG_T, device="cpu")


@pytest.fixture(scope="module")
def weights():
    return fleet_weights()


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


@pytest.fixture(scope="module")
def ref_eng(weights):
    return JaxEngine(CFG_J, weights[0], name="tt_fleet_ref", **EKW)


def _fleet(weights, name, **kw):
    return tserve.ReplicaFleet(CFG_T, weights[1], replicas=2, name=name,
                               max_restarts=0, device="cpu",
                               **dict(EKW, **kw))


@pytest.fixture(scope="module")
def store():
    return SessionStore(name="tt_fleet_sessions")


@pytest.fixture(scope="module")
def fleet(weights, store):
    f = _fleet(weights, "tt_fleet", session_store=store)
    yield f
    f.shutdown(drain=False, timeout_s=5.0)


@pytest.fixture(scope="module")
def jax_fleet(weights):
    f = jserve.ReplicaFleet(CFG_J, weights[0], replicas=2, name="tt_jfleet",
                            session_store=JaxStore(name="tt_jfleet_sessions"),
                            max_restarts=0, **EKW)
    yield f
    f.shutdown(drain=False, timeout_s=5.0)


def _run_threads(fn, items, timeout=120.0):
    results: list = [None] * len(items)
    errors: list = []

    def run(i, item):
        try:
            results[i] = fn(item)
        except Exception as exc:  # noqa: BLE001 - asserted by callers
            errors.append((i, exc))

    threads = [threading.Thread(target=run, args=(i, it))
               for i, it in enumerate(items)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
        assert not t.is_alive()
    return results, errors


def test_greedy_submits_match_jax_engine_and_fleet(fleet, jax_fleet,
                                                   ref_eng):
    ref = ref_eng.generate_batch([(p, 8) for p in PROMPTS])
    assert [fleet.submit(p, 8) for p in PROMPTS] == ref
    assert [jax_fleet.submit(p, 8) for p in PROMPTS] == ref
    # concurrent callers spread over both replicas, same tokens
    got, errors = _run_threads(lambda p: fleet.submit(p, 8), PROMPTS * 2)
    assert not errors and got == ref * 2


def test_seeded_submits_match_jax_engine_and_fleet(fleet, jax_fleet,
                                                   ref_eng):
    p = [2, 7, 1, 8, 2, 8]
    ref = ref_eng.generate_batch([(p, 10, {"sampling": SPEC})])[0]
    assert fleet.submit(p, 10, sampling=SPEC) == ref
    assert jax_fleet.submit(p, 10, sampling=SPEC) == ref
    other = fleet.submit(p, 10, sampling=SPEC[:3] + (778,))
    assert other != ref


def test_affinity_routes_next_turn_back_as_the_jax_fleet(fleet, jax_fleet):
    p = [3, 1, 4, 1, 5, 9, 2, 6, 5]
    assert fleet.route(p) == jax_fleet.route(p)  # a miss: least loaded
    out = fleet.submit(p, 8)
    assert jax_fleet.submit(p, 8) == out
    hits0 = fleet.affinity_hit_count
    nxt = p + out + [17]
    assert fleet.route(nxt) == jax_fleet.route(nxt)
    assert fleet.affinity_hit_count == hits0 + 1
    assert fleet.stats()["affinity_entries"] > 0


def test_session_second_turn_matches_fresh_engine(fleet, store, ref_eng,
                                                  weights):
    sid = "conv-42"
    p1 = [5, 4, 3, 2, 1, 0, 1, 2]
    out1 = fleet.submit(p1, 8, session=sid)
    assert out1 == ref_eng.generate(p1, 8)
    assert store.n_suspends >= 1 and store.n_suspend_failures == 0
    p2 = p1 + out1 + [9, 9]
    resumes0 = store.n_resumes
    out2 = fleet.submit(p2, 8, session=sid)
    assert store.n_resumes == resumes0 + 1
    assert out2 == ref_eng.generate(p2, 8)
    fresh = PagedDecodeEngine(CFG_T, weights[1], device="cpu", **EKW)
    assert out2 == fresh.generate(p2, 8)


def test_kill_one_replica_mid_decode_token_identical(weights, ref_eng):
    prompts = [[i + 1, i + 2, i + 3, 5] for i in range(6)]
    ref = ref_eng.generate_batch([(p, 12) for p in prompts])
    fleet = _fleet(weights, "tt_fleet_kill")
    try:
        faults.install("engine.dispatch.chain", "raise", nth=3)
        got, errors = _run_threads(
            lambda p: fleet.submit(p, 12, timeout_s=120.0), prompts)
        assert not errors, errors
        assert got == ref
        st = fleet.stats()
        assert st["live"] == 1
        assert st["recovery_s"], "no failover was recorded"
        assert sum(r["recovered_in"] for r in st["per_replica"]) >= 1
        assert sum(r["handoffs_out"] for r in st["per_replica"]) >= 1
        assert fleet.stats_block.snapshot()["replica_deaths"] == 1
    finally:
        fleet.shutdown(drain=False, timeout_s=5.0)


def test_sampled_failover_token_identical(weights, ref_eng):
    reqs = [([1 + i, 2, 3, 4], 12, {"sampling": (0.8, 0, 1.0, 40 + i)})
            for i in range(4)]
    ref = ref_eng.generate_batch(reqs)
    fleet = _fleet(weights, "tt_fleet_kill_sampled")
    try:
        faults.install("engine.dispatch.chain", "raise", nth=2)
        got, errors = _run_threads(
            lambda r: fleet.submit(r[0], r[1], sampling=r[2]["sampling"],
                                   timeout_s=120.0), reqs)
        assert not errors, errors
        assert got == ref
        assert fleet.stats()["live"] == 1
    finally:
        fleet.shutdown(drain=False, timeout_s=5.0)


def test_speculative_fleet_failover_token_identical(weights):
    prompts = [[i + 1, i + 2, i + 3, 5] for i in range(6)]
    ref = JaxEngine(CFG_J, weights[0], speculative="off",
                    name="tt_sp_fl_ref", **EKW).generate_batch(
                        [(p, 12) for p in prompts])
    fleet = _fleet(weights, "tt_sp_fleet", speculative="ngram")
    try:
        faults.install("engine.dispatch.verify", "raise", nth=2)
        got, errors = _run_threads(
            lambda p: fleet.submit(p, 12, timeout_s=120.0), prompts)
        assert not errors, errors
        assert got == ref
        st = fleet.stats()
        assert st["live"] == 1
        assert st["recovery_s"], "no failover was recorded"
    finally:
        fleet.shutdown(drain=False, timeout_s=5.0)


def test_whole_fleet_dead_fails_typed(weights):
    fleet = _fleet(weights, "tt_fleet_dead")
    try:
        for rep in fleet.replicas:
            fleet.kill(rep.idx)
        with pytest.raises(tserve.EngineFailedError) as ei:
            fleet.submit([1, 2, 3, 4], 4)
        assert ei.value.retry_after_s == 30.0
        fleet.revive(0)
        assert len(fleet.live_replicas()) == 1
        assert len(fleet.submit([1, 2, 3, 4], 4)) == 4
    finally:
        fleet.shutdown(drain=False, timeout_s=5.0)


def test_state_cache_fleet_is_not_ported(weights):
    """``cache="state"`` (ported since): every replica is a state engine
    and greedy submits give the JAX state engine's tokens on the same
    (grafted) weights; an unknown cache kind raises."""
    from pathway_tpu.kvcache import StateDecodeEngine as JaxState

    from pathway_tpu_torch.kvcache import StateDecodeEngine

    skw = dict(max_slots=24, max_batch_size=4, prefill_chunk=8,
               chain_steps=4)
    want = JaxState(CFG_J, weights[0], name="tt_state_ref",
                    **skw).generate_batch([(p, 6) for p in PROMPTS])
    fleet = tserve.ReplicaFleet(CFG_T, weights[1], replicas=2,
                                cache="state", name="tt_fleet_state",
                                max_restarts=0, device="cpu", **skw)
    try:
        assert all(isinstance(r.engine, StateDecodeEngine)
                   for r in fleet.replicas)
        assert [fleet.submit(p, 6) for p in PROMPTS] == want
    finally:
        fleet.shutdown(drain=False, timeout_s=5.0)
    with pytest.raises(ValueError, match="expected 'paged' or 'state'"):
        tserve.ReplicaFleet(CFG_T, weights[1], cache="bogus", device="cpu")


def test_engine_degrade_handoff_matches_jax_engine(weights):
    """With restarts spent and a plain degrade_fn, stranded requests
    complete through it: emitted tokens are kept, the tail comes from the
    degrade tier, and both engines hand over the same requests."""
    reqs = [([1, 2, 3], 5), ([4, 5], 4)]
    got = {}
    for pkg in ("jax", "torch"):
        calls = []

        def degrade(prompt, n_remaining, emitted, _calls=calls):
            _calls.append((list(prompt), n_remaining, list(emitted)))
            return [7] * n_remaining

        if pkg == "jax":
            eng = JaxEngine(CFG_J, weights[0], name="tt_degrade",
                            max_restarts=0, degrade_fn=degrade, **EKW)
            fire = jfaults
        else:
            eng = PagedDecodeEngine(CFG_T, weights[1], device="cpu",
                                    max_restarts=0, degrade_fn=degrade,
                                    **EKW)
            fire = faults
        fire.install("engine.dispatch.chain", "raise", nth=1)
        out = eng.generate_batch(reqs)
        fire.clear()
        assert calls, "degrade_fn never invoked"
        for o, (_p, n) in zip(out, reqs):
            assert len(o) == n and o[-1] == 7
        got[pkg] = (out, sorted(calls))
    assert got["torch"] == got["jax"]


# -- the JAX package's SSE front over the port fleet ----------------------


def _jax_facing(fleet):
    """The port fleet's ``submit`` with the port's typed errors raised as
    the JAX package's, which the JAX HTTP front maps to 429 / 503."""
    def submit(prompt, max_new, *, on_token, sampling=None, session=None,
               priority=None):
        kw = {} if priority is None else {"priority": int(priority)}
        try:
            return fleet.submit(prompt, max_new, on_token=on_token,
                                sampling=sampling, session=session, **kw)
        except tserve.EngineFailedError as exc:
            raise jserve.EngineFailedError(
                str(exc), retry_after_s=exc.retry_after_s) from exc
        except tserve.ShedError as exc:
            raise jserve.ShedError(
                str(exc), retry_after_s=exc.retry_after_s) from exc
    return submit


def _post_stream(fleet, body):
    from pathway_tpu.io.http import PathwayWebserver

    ws = PathwayWebserver("127.0.0.1", 0, with_schema_endpoint=False)
    ws.register_stream("/stream", _jax_facing(fleet), timeout_s=60.0)
    ws._ensure_started()
    port = ws._server.server_address[1]
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/stream", data=json.dumps(body).encode(),
        method="POST", headers={"Content-Type": "application/json",
                                "X-Pathway-Trace": "ssetorch1"},
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.headers["Content-Type"].startswith(
                "text/event-stream")
            return resp.read().decode()
    finally:
        ws.shutdown()


def test_sse_frames_carry_submit_tokens(fleet, ref_eng):
    expect = fleet.submit([11, 12, 13, 14], 6)
    assert expect == ref_eng.generate([11, 12, 13, 14], 6)
    raw = _post_stream(fleet, {"prompt": [11, 12, 13, 14], "max_new": 6})
    frames = [ln[6:] for ln in raw.splitlines() if ln.startswith("data: ")]
    assert frames[-1] == "[DONE]"
    events = [json.loads(f) for f in frames[:-1]]
    assert events[0]["trace"] == "ssetorch1"
    tokens = [e["token"] for e in events if "token" in e]
    done = [e for e in events if e.get("done")]
    assert len(done) == 1
    assert tokens == done[0]["tokens"] == expect
    # a seeded stream replays the seeded submit
    raw = _post_stream(fleet, {"prompt": [2, 7, 1, 8], "max_new": 6,
                               "sampling": list(SPEC)})
    events = [json.loads(ln[6:]) for ln in raw.splitlines()
              if ln.startswith("data: {")]
    assert [e["token"] for e in events if "token" in e] == fleet.submit(
        [2, 7, 1, 8], 6, sampling=SPEC)


def test_sse_shed_before_first_token_maps_to_429(weights):
    shedding = _fleet(weights, "tt_fleet_shed",
                      scheduler_kwargs={"max_queue": 0, "retry_after_s": 3.0})
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post_stream(shedding, {"prompt": [1, 2], "max_new": 4})
        assert ei.value.code == 429
        assert ei.value.headers.get("Retry-After") == "3"
    finally:
        shedding.shutdown(drain=False, timeout_s=5.0)


def test_sse_dead_fleet_maps_to_503(weights):
    dead = _fleet(weights, "tt_fleet_sse_dead")
    try:
        for rep in dead.replicas:
            dead.kill(rep.idx)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post_stream(dead, {"prompt": [1, 2, 3], "max_new": 4})
        assert ei.value.code == 503
        assert ei.value.headers.get("Retry-After") == "30"
    finally:
        dead.shutdown(drain=False, timeout_s=5.0)
