"""The port's UDF executors, retry strategies, async operators and
``AsyncTransformer`` against the JAX package's, mirroring
``tests/test_udf.py`` and ``tests/test_async_transformer.py``.

Each case builds the same program in both packages; the captures must be
equal (update streams where the emission times are fixed by the run,
squashed states where they depend on when completions land).  Beyond
the JAX package: a failing async call poisons its row with ``ERROR`` and
is recorded in the port's error log, and a UDF cache that fails raises
instead of turning into a miss.
"""

import asyncio
import collections
import random
import threading
import time

import pytest

import pathway_tpu_torch as tpw
from pathway_tpu_torch.engine.runner import run_tables
from pathway_tpu_torch.engine.telemetry import global_error_log
from pathway_tpu_torch.internals import parse_graph as tpg
from pathway_tpu_torch.internals.udfs import AsyncExecutor, SyncExecutor

from .torch_parity import capture, equal_to_jax, fresh_port  # noqa: F401


@pytest.fixture(autouse=True)
def _fresh(fresh_port):  # noqa: F811
    yield


def _abc(pw):
    return pw.debug.table_from_markdown("""
        | a
      1 | 3
      2 | 3
      3 | 4
    """)


# -- tests/test_udf.py -------------------------------------------------------

def test_sync_udf_with_cache_calls_once_a_value():
    calls = {"jax": [], "torch": []}

    def build(pw):
        mine = calls["torch" if pw is tpw else "jax"]

        @pw.udf(cache_strategy=pw.udfs.InMemoryCache())
        def expensive(x: int) -> int:
            mine.append(x)
            return x * 10

        t = _abc(pw)
        return t.select(r=expensive(t.a))

    equal_to_jax(build, stream=True)
    assert sorted(calls["torch"]) == sorted(calls["jax"]) == [3, 4]


def test_async_udf_is_gathered_per_batch():
    def build(pw):
        @pw.udf(executor=pw.udfs.async_executor(capacity=64))
        async def slow(x: int) -> int:
            await asyncio.sleep(0.05)
            return x + 1

        class S(pw.Schema):
            a: int

        t = pw.debug.table_from_rows(S, [(i,) for i in range(30)])
        return t.select(r=slow(t.a))

    t0 = time.perf_counter()
    [got] = capture("torch", build, stream=True)
    elapsed = time.perf_counter() - t0
    assert got == capture("jax", build, stream=True)[0]
    assert sorted(r[0] for (_k, r, _t, _d) in got) == list(range(1, 31))
    assert elapsed < 1.0  # gathered, not 30 x 0.05 s in a row


@pytest.mark.parametrize("strategy", ["fixed", "exponential"])
def test_async_udf_retries(strategy):
    attempts = {"jax": [], "torch": []}

    def build(pw):
        mine = attempts["torch" if pw is tpw else "jax"]
        retry = (pw.udfs.FixedDelayRetryStrategy(max_retries=3, delay_ms=1)
                 if strategy == "fixed" else
                 pw.udfs.ExponentialBackoffRetryStrategy(
                     max_retries=3, initial_delay=1, backoff_factor=2,
                     jitter_ms=1))

        @pw.udf(executor=pw.udfs.async_executor(retry_strategy=retry))
        async def flaky(x: int) -> int:
            mine.append(x)
            if len(mine) < 3:
                raise RuntimeError("transient")
            return x

        t = pw.debug.table_from_markdown("""
            | a
          1 | 5
        """)
        return t.select(r=flaky(t.a))

    [state] = equal_to_jax(build, stream=True)
    assert [r for (_k, r, _t, _d) in state] == [(5,)]
    assert len(attempts["torch"]) == len(attempts["jax"]) == 3


def test_fully_async_emits_pending_then_resolves_each_row_once():
    def build(pw):
        @pw.udf(executor=pw.udfs.fully_async_executor())
        async def slow_double(x: int) -> int:
            await asyncio.sleep(0.02)
            return x * 2

        t = pw.debug.table_from_markdown("""
            | a
          1 | 1
          2 | 5
        """)
        return t.select(a=t.a, d=slow_double(t.a))

    # the port's stream: each row PENDING first, then that PENDING
    # retracted at the time its value is inserted, each change once
    [stream] = capture("torch", build, stream=True)
    assert all(n == 1 for n in stream.values())
    pend = {k: t for (k, r, t, d) in stream if r[1] == "<Pending>" and d > 0}
    assert len(pend) == 2
    done = {k: t for (k, r, t, d) in stream if r[1] == "<Pending>" and d < 0}
    resolved = {k: (r, t) for (k, r, t, d) in stream if r[1] != "<Pending>"}
    assert done.keys() == resolved.keys() == pend.keys()
    assert all(resolved[k][1] == done[k] > pend[k] for k in pend)
    assert sorted(r for r, _t in resolved.values()) == [(1, 2), (5, 10)]
    # the JAX operator lets a completion that lands first cancel its
    # PENDING row, depending on timing: its stream equals the port's once
    # the PENDING insert/retract pairs are cancelled in both, times aside
    def settled(stream):
        net = collections.Counter()
        for (k, r, _t, d), n in stream.items():
            net[k, r] += d * n
        return {e: n for e, n in net.items() if n}

    [jax_stream] = capture("jax", build, stream=True)
    assert settled(stream) == settled(jax_stream)
    [state] = equal_to_jax(build)
    assert sorted(state.values()) == [(1, 2), (5, 10)]


def test_nondeterministic_async_retraction_cancels():
    def build(pw):
        @pw.udf(executor=pw.udfs.async_executor())
        async def rand_val(x: int) -> float:
            return random.random()

        t = pw.debug.table_from_markdown("""
            a | __time__ | __diff__
            7 | 0        | 1
            7 | 2        | -1
        """, id_from=["a"])
        return t.select(r=rand_val(t.a))

    assert capture("torch", build) == capture("jax", build) == [{}]


def test_nondeterministic_sync_udf_stateful_path():
    def build(pw):
        counter = [0]

        @pw.udf(deterministic=False)
        def seq(x: int) -> int:
            counter[0] += 1
            return counter[0]

        t = pw.debug.table_from_markdown("""
            a | __time__ | __diff__
            1 | 0        | 1
            1 | 2        | -1
        """, id_from=["a"])
        return t.select(r=seq(t.a))

    [stream] = equal_to_jax(build, stream=True)
    assert sum(d for (_k, _r, _t, d), n in stream.items()) == 0
    assert capture("torch", build) == [{}]


def test_udf_composition_helpers():
    calls = {"jax": [], "torch": []}

    def build(pw):
        mine = calls["torch" if pw is tpw else "jax"]

        @pw.udf(executor=pw.udfs.auto_executor())
        def double(x: int) -> int:
            return x * 2

        @pw.udf(executor=pw.udfs.auto_executor())
        async def triple(x: int) -> int:
            return x * 3

        async def flaky(x):
            mine.append(x)
            if len(mine) < 2:
                raise RuntimeError("transient")
            return x + 100

        wrapped = pw.udfs.with_retry_strategy(
            pw.udfs.with_timeout(pw.udfs.with_capacity(flaky, 2), 5.0),
            pw.udfs.ExponentialBackoffRetryStrategy(max_retries=3,
                                                    initial_delay=10))

        @pw.udf
        async def resilient(x: int) -> int:
            return await wrapped(x)

        t = pw.debug.table_from_markdown("""
            a
            1
            2
        """)
        return t.select(d=double(t.a), tr=triple(t.a), r=resilient(t.a))

    [state] = equal_to_jax(build)
    assert sorted(state.values()) == [(2, 3, 101), (4, 6, 102)]

    @tpw.udf(executor=tpw.udfs.auto_executor())
    def d(x: int) -> int:
        return x

    @tpw.udf(executor=tpw.udfs.auto_executor())
    async def a(x: int) -> int:
        return x

    assert isinstance(d._executor, SyncExecutor)
    assert isinstance(a._executor, AsyncExecutor)

    async def hang(x):
        await asyncio.sleep(30)

    timed = tpw.udfs.with_timeout(hang, 0.05)
    loop = asyncio.new_event_loop()
    try:
        with pytest.raises(asyncio.TimeoutError):
            loop.run_until_complete(timed(1))
    finally:
        loop.close()
    assert asyncio.run(tpw.udfs.coerce_async(lambda v: v + 1)(1)) == 2


def test_apply_async_gives_the_jax_rows():
    def build(pw):
        async def plus(x):
            return x + 7

        t = _abc(pw)
        return t.select(r=pw.apply_async(plus, t.a))

    [state] = equal_to_jax(build, stream=True)
    assert sorted(r for (_k, r, _t, _d) in state) == [(10,), (10,), (11,)]


@pytest.mark.parametrize("executor", ["async", "fully_async"])
def test_a_failing_async_call_poisons_its_row_and_is_logged(executor):
    def build(pw):
        ex = (pw.udfs.async_executor() if executor == "async"
              else pw.udfs.fully_async_executor())

        @pw.udf(executor=ex)
        async def inv(x: int) -> float:
            return 1 // (x - 4)

        t = _abc(pw)
        return t.select(r=inv(t.a))

    global_error_log.clear()
    [state] = equal_to_jax(build)
    assert sorted(map(repr, state.values())) == ["('<Error>',)", "(-1,)",
                                                 "(-1,)"]
    assert any("ZeroDivisionError" in e["message"]
               for e in global_error_log.entries)


def test_a_failing_cache_raises():
    class Broken(tpw.udfs.CacheStrategy):
        def lookup(self, key):
            raise OSError("cache store unreachable")

    @tpw.udf(executor=tpw.udfs.async_executor(), cache_strategy=Broken())
    async def f(x: int) -> int:
        return x

    t = _abc(tpw)
    from pathway_tpu_torch.internals.trace import EngineErrorWithTrace

    with pytest.raises(EngineErrorWithTrace,
                       match="OSError: cache store unreachable"):
        run_tables(t.select(r=f(t.a)), device="cpu")


def test_async_cache_is_shared_with_the_jax_package(tmp_path):
    calls = []

    def build(pw):
        @pw.udf(executor=pw.udfs.async_executor(),
                cache_strategy=pw.udfs.DiskCache(str(tmp_path / "cache")))
        async def ten(x: int) -> int:
            calls.append(x)
            return x * 10

        t = _abc(pw)
        return t.select(r=ten(t.a))

    want = capture("jax", build)
    assert sorted(calls) == [3, 4]  # an in-batch duplicate shares a call
    assert capture("torch", build) == want  # served from the JAX cache
    assert sorted(calls) == [3, 4]


# -- tests/test_async_transformer.py -----------------------------------------

def _transformer(pw, body, **kw):
    class Out(pw.Schema):
        ret: int

    class T(pw.AsyncTransformer):
        output_schema = Out

        async def invoke(self, value):
            return await body(value)

    rows = kw.pop("rows", """
        | value
    1   | 42
    2   | 44
    """)
    tr = T(input_table=pw.debug.table_from_markdown(rows), **kw)
    return tr


def _pair(make):
    """``make(pw)``'s table in each package, squashed."""
    return capture("torch", make), capture("jax", make)


async def _inc(value):
    await asyncio.sleep(0.01)
    return {"ret": value + 1}


async def _flaky(value):
    if value == 44:
        raise RuntimeError("boom")
    return {"ret": value + 1}


def test_transformer_successful_basic():
    got, want = _pair(lambda pw: _transformer(pw, _inc).successful)
    assert got == want
    assert sorted(r[0] for r in got[0].values()) == [43, 45]


@pytest.mark.parametrize("view", ["successful", "failed", "finished"])
def test_transformer_failure_rows_and_status(view):
    global_error_log.clear()
    got, want = _pair(lambda pw: getattr(_transformer(pw, _flaky), view))
    assert got == want
    if view == "failed":
        assert [r[0] for r in got[0].values()] == [None]
        assert any("boom" in e["message"] for e in global_error_log.entries)


def test_transformer_instance_failure_poisons_group():
    got, want = _pair(
        lambda pw: _transformer(pw, _flaky, instance=0).failed)
    assert got == want
    assert len(got[0]) == 2


def test_transformer_instance_results_apply_in_time_order():
    order = {"jax": [], "torch": []}

    def make(pw):
        mine = order["torch" if pw is tpw else "jax"]

        async def slow(value):
            await asyncio.sleep(0.2 if value == 42 else 0.01)
            mine.append(value)
            return {"ret": value + 1}

        return _transformer(pw, slow, instance=0).successful

    got, want = _pair(make)
    assert got == want
    assert order["torch"] == order["jax"] == [44, 42]


def test_transformer_with_options_retry_and_capacity():
    attempts = {"jax": 0, "torch": 0}

    def make(pw):
        name = "torch" if pw is tpw else "jax"

        async def retried(value):
            attempts[name] += 1
            if attempts[name] < 3:
                raise RuntimeError("transient")
            return {"ret": value + 1}

        return _transformer(pw, retried, rows="""
            | value
        1   | 42
        """).with_options(
            capacity=2,
            retry_strategy=pw.udfs.ExponentialBackoffRetryStrategy(
                max_retries=5, initial_delay=1, backoff_factor=1),
        ).successful

    got, want = _pair(make)
    assert got == want
    assert attempts == {"jax": 3, "torch": 3}


def test_transformer_cache_serves_reinvocation():
    calls = []
    cache = tpw.udfs.InMemoryCache()

    async def counted(value):
        calls.append(value)
        return {"ret": value + 1}

    for _ in range(2):
        tpg.G.clear()
        tr = _transformer(tpw, counted).with_options(cache_strategy=cache)
        [cap] = run_tables(tr.successful, device="cpu")
        assert sorted(r[0] for r in cap.squash().values()) == [43, 45]
    tpg.G.clear()
    assert len(calls) == 2  # the second run is served from the cache


def test_transformer_output_table_shows_pending_then_resolves():
    seen = []

    async def slow(value):
        await asyncio.sleep(0.2)
        return {"ret": value + 1}

    tr = _transformer(tpw, slow, rows="""
        | value
    1   | 7
    """)
    tpw.io.subscribe(tr.output_table, on_change=lambda key, row, time,
                     is_addition: seen.append((row["_async_status"],
                                               row["ret"], is_addition)))
    tpw.run(device="cpu", timeout_s=3.0, autocommit_duration_ms=50)
    from pathway_tpu_torch.internals.value import Pending

    assert any(isinstance(s, Pending) and add for s, _r, add in seen), seen
    assert ("-SUCCESS-", 8, True) in seen


def test_transformer_deletion_removes_output_row():
    from pathway_tpu_torch.internals.datasource import SubjectDataSource
    from pathway_tpu_torch.io._utils import make_input_table

    class InSchema(tpw.Schema):
        value: int

    class _Subj:
        def _run(self, handle):
            handle.push((5,), 1, 100)
            time.sleep(0.4)
            handle.push((5,), -1, 100)
            time.sleep(0.3)
            handle.close()

    async def ident(value):
        return {"ret": value}

    class Out(tpw.Schema):
        ret: int

    class Id(tpw.AsyncTransformer):
        output_schema = Out

        async def invoke(self, value):
            return await ident(value)

    src = SubjectDataSource(_Subj(), ["value"], None, append_only=False)
    tr = Id(input_table=make_input_table(InSchema, src))
    net: dict = {}
    done = threading.Event()

    def on_change(key, row, time, is_addition):
        net[row["ret"]] = net.get(row["ret"], 0) + (1 if is_addition else -1)

    tpw.io.subscribe(tr.finished, on_change=on_change,
                     on_end=lambda: done.set())
    tpw.run(device="cpu", timeout_s=3.0, autocommit_duration_ms=50)
    assert net.get(5, 0) == 0
