"""pathway_tpu_torch.serve scheduler and admission against the JAX package.

Every case of ``tests/test_serve_scheduler.py`` that needs neither the
HTTP front nor the JAX dataflow runs here once per package, with the same
assertions on both: the JAX package's ``RequestScheduler`` /
``AdmissionController`` / ``TokenBucket`` / ``shared_scheduler`` and the
port's copies (batch coalescing, size-bucket padding, deadline shedding,
priority order, queue overflow, rate limits, the degrade policy, caller
timeouts, drain and hard shutdown, batch failures, the shared-scheduler
registry, and the embedder's batch scheduler).  Left out:
``test_concurrent_load_batches_sheds_and_exports_metrics`` (the
Prometheus ``MetricsServer``, not ported) and
``test_rest_subject_admission_maps_shed_to_429`` (the JAX HTTP front).
The port's embedder case also holds each scheduled row to the
unscheduled ``embed`` of the same text.
"""

import math
import threading
import time
import types

import numpy as np
import pytest

import pathway_tpu.serve as jserve
import pathway_tpu_torch.serve as tserve


def _api(serve):
    return types.SimpleNamespace(
        AdmissionController=serve.AdmissionController,
        DeadlineExceededError=serve.DeadlineExceededError,
        Priority=serve.Priority,
        QueueFullError=serve.QueueFullError,
        RateLimitedError=serve.RateLimitedError,
        RequestScheduler=serve.RequestScheduler,
        SchedulerClosedError=serve.SchedulerClosedError,
        TokenBucket=serve.TokenBucket,
        shared_scheduler=serve.shared_scheduler,
    )


@pytest.fixture(params=["jax", "torch"])
def api(request):
    ns = _api(jserve if request.param == "jax" else tserve)
    ns.pkg = request.param
    return ns


def _fanout(scheduler, payloads, **submit_kwargs):
    """Submit payloads from concurrent threads; return (results, errors)."""
    results = [None] * len(payloads)
    errors = [None] * len(payloads)

    def worker(i):
        try:
            results[i] = scheduler.submit(payloads[i], **submit_kwargs)
        except Exception as exc:  # noqa: BLE001
            errors[i] = exc

    threads = [
        threading.Thread(target=worker, args=(i,)) for i in range(len(payloads))
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    return results, errors


def test_concurrent_callers_coalesce_into_batches(api):
    calls = []

    def batch_fn(items):
        calls.append(len(items))
        time.sleep(0.005)
        return [x * 10 for x in items]

    # start=False: all callers enqueue BEFORE the worker runs, so the
    # batch split is deterministic
    s = api.RequestScheduler(batch_fn, name=f"tt-coalesce-{api.pkg}",
                             max_batch_size=8, batch_linger_ms=15.0,
                             start=False)
    try:
        n = 24
        results = [None] * n
        errors = [None] * n

        def worker(i):
            try:
                results[i] = s.submit(i)
            except Exception as exc:  # noqa: BLE001
                errors[i] = exc

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 10
        while s.queue_depth < n and time.monotonic() < deadline:
            time.sleep(0.002)
        assert s.queue_depth == n
        s.start()
        for t in threads:
            t.join(timeout=30)
        assert errors == [None] * n
        assert results == [x * 10 for x in range(n)]
        assert len(calls) <= math.ceil(n / 8), calls
        assert sum(calls) == n
        assert s.stats.batch_occupancy_avg > 1.0
    finally:
        s.shutdown()


def test_size_buckets_pad_batch_and_truncate_results(api):
    seen = []

    def batch_fn(items):
        seen.append(len(items))
        return [x + 1 for x in items]

    s = api.RequestScheduler(batch_fn, name=f"tt-buckets-{api.pkg}",
                             max_batch_size=8, batch_linger_ms=30.0,
                             size_buckets=(4, 8))
    try:
        results, errors = _fanout(s, [10, 20, 30])
        assert errors == [None] * 3
        assert results == [11, 21, 31]
        assert all(n in (4, 8) for n in seen), seen
    finally:
        s.shutdown()


def test_expired_deadline_sheds_before_execution(api):
    executed = []
    release = threading.Event()

    def batch_fn(items):
        executed.extend(items)
        release.wait(1.0)
        return items

    s = api.RequestScheduler(batch_fn, name=f"tt-deadline-{api.pkg}",
                             max_batch_size=1, batch_linger_ms=0.0)
    try:
        blocker = threading.Thread(target=lambda: s.submit("blocker"))
        blocker.start()
        time.sleep(0.05)
        with pytest.raises(api.DeadlineExceededError):
            s.submit("doomed", deadline_s=0.05)
        release.set()
        blocker.join(timeout=5)
        time.sleep(0.1)
        assert "doomed" not in executed
        assert s.stats.shed.get("deadline", 0) >= 1
        assert s.stats.deadline_miss >= 1
    finally:
        release.set()
        s.shutdown()


def test_priority_ordering_under_saturation(api):
    order = []
    gate = threading.Event()

    def batch_fn(items):
        gate.wait(5.0)
        order.extend(items)
        return items

    s = api.RequestScheduler(batch_fn, name=f"tt-priority-{api.pkg}",
                             max_batch_size=1, batch_linger_ms=0.0)
    try:
        blocker = threading.Thread(target=lambda: s.submit("blocker"))
        blocker.start()
        time.sleep(0.05)
        threads = []
        for name, prio in [("low1", api.Priority.LOW), ("low2", "low"),
                           ("norm", api.Priority.NORMAL), ("high", "HIGH")]:
            t = threading.Thread(
                target=lambda n=name, p=prio: s.submit(n, priority=p)
            )
            t.start()
            threads.append(t)
            time.sleep(0.03)
        gate.set()
        blocker.join(timeout=5)
        for t in threads:
            t.join(timeout=5)
        assert order == ["blocker", "high", "norm", "low1", "low2"]
    finally:
        gate.set()
        s.shutdown()


def test_queue_overflow_sheds_with_retry_after(api):
    gate = threading.Event()

    def batch_fn(items):
        gate.wait(5.0)
        return items

    s = api.RequestScheduler(batch_fn, name=f"tt-overflow-{api.pkg}",
                             max_batch_size=1, batch_linger_ms=0.0,
                             max_queue=2, retry_after_s=2.5)
    try:
        blocker = threading.Thread(target=lambda: s.submit("blocker"))
        blocker.start()
        time.sleep(0.05)
        q1 = threading.Thread(target=lambda: s.submit("q1"))
        q2 = threading.Thread(target=lambda: s.submit("q2"))
        q1.start(), q2.start()
        time.sleep(0.1)
        with pytest.raises(api.QueueFullError) as exc_info:
            s.submit("overflow")
        assert exc_info.value.retry_after_s == 2.5
        assert s.stats.shed.get("queue_full", 0) == 1
        gate.set()
        for t in (blocker, q1, q2):
            t.join(timeout=5)
    finally:
        gate.set()
        s.shutdown()


def test_rate_limiter_sheds_and_token_bucket_math(api):
    bucket = api.TokenBucket(rate=1.0, burst=2)
    assert bucket.try_acquire()
    assert bucket.try_acquire()
    assert not bucket.try_acquire()
    assert bucket.time_to_token() > 0

    s = api.RequestScheduler(lambda xs: xs, name=f"tt-rate-{api.pkg}",
                             batch_linger_ms=0.0,
                             rate_limits={api.Priority.NORMAL: (1.0, 2)})
    try:
        assert s.submit("a") == "a"
        assert s.submit("b") == "b"
        with pytest.raises(api.RateLimitedError) as exc_info:
            s.submit("c")
        assert exc_info.value.retry_after_s > 0
        assert s.submit("d", priority=api.Priority.HIGH) == "d"
        assert s.stats.shed.get("rate_limit", 0) == 1
    finally:
        s.shutdown()


def test_degrade_policy_routes_to_cheaper_tier(api):
    gate = threading.Event()

    def batch_fn(items):
        gate.wait(5.0)
        return items

    s = api.RequestScheduler(batch_fn, name=f"tt-degrade-{api.pkg}",
                             max_batch_size=1, batch_linger_ms=0.0,
                             max_queue=1, policy="degrade",
                             degrade_fn=lambda x: f"cheap:{x}")
    try:
        blocker = threading.Thread(target=lambda: s.submit("blocker"))
        blocker.start()
        time.sleep(0.05)
        q1 = threading.Thread(target=lambda: s.submit("q1"))
        q1.start()
        time.sleep(0.1)
        assert s.submit("x") == "cheap:x"
        assert s.stats.degraded == 1
        gate.set()
        blocker.join(timeout=5), q1.join(timeout=5)
    finally:
        gate.set()
        s.shutdown()


def test_admission_controller_policies(api):
    ac = api.AdmissionController(max_pending=2, policy="shed",
                                 name=f"tt-ac-{api.pkg}", retry_after_s=3.0)
    ac.try_acquire()
    ac.try_acquire("high")
    with pytest.raises(api.QueueFullError) as exc_info:
        ac.try_acquire()
    assert exc_info.value.retry_after_s == 3.0
    ac.release()
    ac.try_acquire()
    assert ac.pending == 2
    assert ac.stats.shed.get("queue_full", 0) == 1

    acb = api.AdmissionController(max_pending=1, policy="block",
                                  block_timeout_s=5.0,
                                  name=f"tt-ac-block-{api.pkg}")
    acb.try_acquire()
    timer = threading.Timer(0.1, acb.release)
    timer.start()
    t0 = time.monotonic()
    acb.try_acquire()
    assert 0.05 <= time.monotonic() - t0 < 4.0
    timer.join(timeout=5)

    acr = api.AdmissionController(max_pending=10,
                                  name=f"tt-ac-rate-{api.pkg}",
                                  rate_limits={"normal": (1.0, 1)})
    acr.try_acquire()
    with pytest.raises(api.RateLimitedError):
        acr.try_acquire()


def test_caller_timeout_frees_queue_slot_and_counts_timeout_shed(api):
    gate = threading.Event()
    s = api.RequestScheduler(lambda xs: (gate.wait(5.0), xs)[1],
                             name=f"tt-timeout-{api.pkg}", max_batch_size=1,
                             batch_linger_ms=0.0, max_queue=1)
    try:
        blocker = threading.Thread(target=lambda: s.submit("b"))
        blocker.start()
        time.sleep(0.05)
        with pytest.raises(api.DeadlineExceededError):
            s.submit("give-up", timeout_s=0.1)
        assert s.stats.shed.get("timeout", 0) >= 1
        assert s.queue_depth == 0
        gate.set()
        blocker.join(timeout=5)
    finally:
        gate.set()
        s.shutdown()


def test_degrade_overflow_not_double_counted_as_shed(api):
    ac = api.AdmissionController(max_pending=1,
                                 name=f"tt-ac-degrade2-{api.pkg}")
    ac.try_acquire()
    with pytest.raises(api.QueueFullError):
        ac.try_acquire(will_degrade=True)
    ac.record_degraded()
    assert ac.stats.shed.get("queue_full", 0) == 0
    assert ac.stats.degraded == 1


def test_graceful_drain_executes_queued_work(api):
    done = []

    def batch_fn(items):
        time.sleep(0.02)
        done.extend(items)
        return items

    s = api.RequestScheduler(batch_fn, name=f"tt-drain-{api.pkg}",
                             max_batch_size=2, batch_linger_ms=0.0)
    results, errors = [], []

    def worker(i):
        try:
            results.append(s.submit(i))
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    time.sleep(0.03)
    s.shutdown(drain=True)
    for t in threads:
        t.join(timeout=10)
    assert not errors
    assert sorted(done) == list(range(6))
    with pytest.raises(api.SchedulerClosedError):
        s.submit(99)


def test_hard_shutdown_fails_queued_requests(api):
    gate = threading.Event()

    def batch_fn(items):
        gate.wait(2.0)
        return items

    s = api.RequestScheduler(batch_fn, name=f"tt-hard-{api.pkg}",
                             max_batch_size=1, batch_linger_ms=0.0)
    errors = []

    def worker(i):
        try:
            s.submit(i)
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.1)
    s.shutdown(drain=False, timeout_s=0.1)
    gate.set()
    for t in threads:
        t.join(timeout=5)
    assert any(isinstance(e, api.SchedulerClosedError) for e in errors)


def test_batch_fn_failure_propagates_to_all_callers(api):
    def batch_fn(items):
        raise RuntimeError("device fell over")

    s = api.RequestScheduler(batch_fn, name=f"tt-fail-{api.pkg}",
                             batch_linger_ms=10.0)
    try:
        _results, errors = _fanout(s, [1, 2, 3])
        assert all(isinstance(e, RuntimeError) for e in errors)
    finally:
        s.shutdown()


def test_shared_scheduler_is_a_singleton_per_name(api):
    a = api.shared_scheduler(f"tt-shared-{api.pkg}", lambda xs: xs,
                             batch_linger_ms=0.0)
    b = api.shared_scheduler(f"tt-shared-{api.pkg}")
    assert a is b
    try:
        assert b.submit("x") == "x"
    finally:
        a.shutdown()
    with pytest.raises(KeyError):
        api.shared_scheduler("tt-never-registered")


def _embedder(pkg):
    if pkg == "jax":
        from pathway_tpu.models.encoder import EncoderConfig
        from pathway_tpu.xpacks.llm.embedders import (
            SentenceTransformerEmbedder)

        kw = {}
    else:
        from pathway_tpu_torch.models.encoder import EncoderConfig
        from pathway_tpu_torch.xpacks.llm.embedders import (
            SentenceTransformerEmbedder)

        kw = {"device": "cpu"}
    cfg = EncoderConfig(vocab_size=512, d_model=16, n_layers=1, n_heads=2,
                        d_ff=32, max_len=16)
    return (SentenceTransformerEmbedder(config=cfg, batch_scheduler=True,
                                        **kw),
            SentenceTransformerEmbedder(config=cfg, **kw))


def test_embedder_batch_scheduler_coalesces_device_calls(api):
    emb, plain = _embedder(api.pkg)
    sched = emb._scheduler
    n = 16
    results = [None] * n
    errors = []
    embed = emb._embed if api.pkg == "jax" else emb.embed

    def worker(i):
        try:
            results[i] = embed(f"query number {i}")
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    try:
        assert not errors
        assert all(r is not None and len(r) == 16 for r in results)
        assert sched.stats.batches < n
        assert sched.stats.batch_occupancy_avg > 1.0
        if api.pkg == "torch":
            # the same weights (seed 0) answer unscheduled, one at a time
            want = np.stack([plain.embed(f"query number {i}")
                             for i in range(n)])
            np.testing.assert_allclose(np.stack(results), want, rtol=0,
                                       atol=1e-6)
    finally:
        sched.shutdown()
