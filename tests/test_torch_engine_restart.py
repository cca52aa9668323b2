"""pathway_tpu_torch engine watchdog and supervised restart.

The port's mirror of ``tests/test_engine_restart.py`` (restart and
watchdog identity, typed failures, the per-run budget) and of the
sampled-restart case of ``tests/test_fleet.py``:

- an engine that fails mid-run rebuilds its pool and re-admits every
  in-flight request by recompute over prompt + emitted: the tokens equal
  an uninterrupted run's and the JAX engine's on the same weights;
- a sync wedged past ``watchdog_timeout_s`` raises ``EngineHungError``
  into the same restart path;
- with the budget spent, every waiter (batch-origin or polled) gets a
  typed ``EngineFailedError``; a failure that recurs at every attempt
  (a poisoned device, say) spends the budget and fails, never loops.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathway_tpu.kvcache.engine import PagedDecodeEngine as JaxEngine
from pathway_tpu_torch import faults
from pathway_tpu_torch.kvcache import engine as eng_mod
from pathway_tpu_torch.kvcache.engine import EngineHungError, PagedDecodeEngine
from pathway_tpu_torch.models.convert import decoder_params_from_numpy
from pathway_tpu_torch.serve.admission import EngineFailedError

from .test_torch_engine import CFG_J, CFG_T, WIDTHS, _np_params

EKW = dict(num_blocks=96, block_size=4, max_batch_size=8,
           seq_buckets=(16, 32, 64), prefill_chunk=8, chain_steps=4)


@pytest.fixture(scope="module")
def weights():
    tree = _np_params(0)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            decoder_params_from_numpy(tree, CFG_T, device="cpu"))


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


def _engine(pt, **kw):
    return PagedDecodeEngine(CFG_T, pt, device="cpu", **dict(EKW, **kw))


def _mixed_requests(sampled=False):
    """>= 8 mixed-length in-flight sessions."""
    rng = np.random.default_rng(11)
    lengths = [3, 5, 7, 9, 12, 15, 21, 27]
    reqs = []
    for i, n in enumerate(lengths):
        prompt = [int(t) for t in rng.integers(1, WIDTHS["vocab_size"], n)]
        if sampled:
            reqs.append((prompt, 6 + (i % 5),
                         {"sampling": (0.8, 0, 1.0, 40 + i)}))
        else:
            reqs.append((prompt, 6 + (i % 5)))
    return reqs


@pytest.fixture(scope="module")
def references(weights):
    """Uninterrupted outputs of the JAX engine, greedy and sampled."""
    pj, _pt = weights
    return {s: JaxEngine(CFG_J, pj, attn="reference",
                         name=f"t_torch_restart_ref_{s}",
                         **EKW).generate_batch(_mixed_requests(s))
            for s in (False, True)}


@pytest.mark.parametrize("sampled", [False, True])
def test_restart_is_token_identical_across_8_mixed_sessions(
        weights, references, sampled):
    _pj, pt = weights
    reqs = _mixed_requests(sampled)
    clean = _engine(pt).generate_batch(reqs)
    assert clean == references[sampled]
    eng = _engine(pt, max_restarts=1)
    # fail the 2nd chained dispatch: by then sessions have emitted
    # tokens, so the restart must recompute prompt + emitted
    faults.install("engine.dispatch.chain", "raise", nth=2)
    assert eng.generate_batch(reqs) == clean
    assert eng.n_restarts == 1
    # the pool really was rebuilt and no sequence leaked into it
    assert eng.pool.sequences() == []
    eng.pool.check_invariants(eng.prefix.external_refs())


def test_watchdog_hang_restarts_token_identical(weights, references):
    _pj, pt = weights
    eng = _engine(pt, max_restarts=1, watchdog_timeout_s=0.5)
    old_pool = eng.pool
    faults.install("engine.sync", "hang", nth=2, arg_ms=2500)
    assert eng.generate_batch(_mixed_requests()) == references[False]
    assert eng.n_restarts == 1
    assert eng.pool is not old_pool


def test_watchdog_without_budget_raises_typed_hung(weights):
    _pj, pt = weights
    eng = _engine(pt, max_restarts=0, watchdog_timeout_s=0.4)
    faults.install("engine.sync", "hang", nth=1, arg_ms=2000)
    with pytest.raises(EngineFailedError) as ei:
        eng.generate_batch([([1, 2, 3], 4)])
    assert EngineHungError.__name__ in str(ei.value)
    assert "watchdog deadline" in str(ei.value)
    assert eng.n_restarts == 0


def test_exhausted_restarts_fail_waiters_typed(weights):
    _pj, pt = weights
    eng = _engine(pt, max_restarts=0)
    faults.install("engine.dispatch.chain", "raise", nth=1)
    got = {}
    polled = [(
        ([1, 2, 3], 4), 1,
        lambda r: got.setdefault("done", r),
        lambda e: got.setdefault("err", e),
    )]

    def poll(n):
        items, polled[:] = list(polled), []
        return items

    with pytest.raises(EngineFailedError, match="injected fault"):
        eng.generate_batch([([4, 5, 6], 4)], poll=poll)
    err = got.get("err")
    assert isinstance(err, EngineFailedError), err
    assert err.trace_id and err.retry_after_s == 5.0
    assert "injected fault" in str(err)
    assert eng.pool.num_free == eng.pool.num_blocks - 1
    # serve_batch places the typed failure in the request's slot
    faults.clear()
    faults.install("engine.dispatch.chain", "raise", nth=1)
    out = eng.serve_batch([([4, 5, 6], 4)])
    assert isinstance(out[0], EngineFailedError)


def test_restart_budget_spent_then_typed_failure(weights):
    """Budget 1, two injected failures: the first restarts, the second
    fails typed — the budget is per run, not per request."""
    _pj, pt = weights
    eng = _engine(pt, max_restarts=1)
    faults.install("engine.dispatch.chain", "raise", nth=1)
    faults.install("engine.dispatch.chain", "raise", nth=2)
    with pytest.raises(EngineFailedError, match="after 1 restart"):
        eng.generate_batch([([1, 2, 3, 4], 16)])
    assert eng.n_restarts == 1


def test_recurring_failure_spends_budget_and_never_loops(weights,
                                                         monkeypatch):
    """A failure at every dispatch (a poisoned device) is restarted
    exactly ``max_restarts`` times, then fails typed; a pool rebuild that
    itself fails ends the run at once."""
    _pj, pt = weights
    eng = _engine(pt, max_restarts=3)
    faults.install("engine.dispatch.chain", "raise", nth=0)
    with pytest.raises(EngineFailedError, match="after 3 restart"):
        eng.generate_batch([([1, 2, 3, 4], 8)])
    assert eng.n_restarts == 3
    faults.clear()
    faults.install("engine.dispatch.chain", "raise", nth=1)

    def sticky(_kind, **_kw):
        raise RuntimeError("CUDA error: an illegal memory access")

    eng = _engine(pt, max_restarts=5)
    # the engine rebuilds its pool through the backend seam
    monkeypatch.setattr(eng_mod, "make_backend", sticky)
    with pytest.raises(EngineFailedError, match="illegal memory access"):
        eng.generate_batch([([1, 2, 3, 4], 8), ([5, 6], 8)])
    assert eng.n_restarts == 0
    assert eng.pool is not None  # the old pool stays attached


def test_restart_budget_from_the_environment(weights, monkeypatch):
    _pj, pt = weights
    monkeypatch.setenv("PW_ENGINE_MAX_RESTARTS", "2")
    monkeypatch.setenv("PW_ENGINE_WATCHDOG_S", "7.5")
    eng = _engine(pt)
    assert (eng.max_restarts, eng.watchdog_timeout_s) == (2, 7.5)
    assert _engine(pt, max_restarts=0,
                   watchdog_timeout_s=0).watchdog_timeout_s is None


def test_fault_registry_actions():
    with pytest.raises(ValueError, match="unknown fault action"):
        faults.install("engine.sync", "explode")
    spec = faults.install("engine.dispatch.step", "raise", nth=2)
    assert faults.fire("engine.dispatch.step") is None
    with pytest.raises(faults.InjectedFault, match="hit 2"):
        faults.fire("engine.dispatch.step")
    assert faults.fire("engine.dispatch.step") is None and spec.hits == 3
    faults.install("engine.draft", "drop", nth=0)
    faults.install("engine.draft", "delay", nth=0, arg_ms=1)
    assert [faults.fire("engine.draft") for _ in range(2)] == ["drop"] * 2
    assert faults.fire("engine.mixed") is None
    faults.clear()
    assert faults.fire("engine.draft") is None
