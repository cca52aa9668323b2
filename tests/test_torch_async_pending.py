"""The fully-async operator emits every row ``PENDING`` first, at its own
time, and resolves it once at a later time, however fast the UDF
returns; the final state equals the JAX package's."""

import pytest

from .torch_parity import capture, equal_to_jax, fresh_port  # noqa: F401

N_ROWS = 24


def _build(pw):
    @pw.udf(executor=pw.udfs.fully_async_executor())
    async def at_once(x: int) -> int:
        return x + 1

    t = pw.debug.table_from_rows(
        pw.schema_from_types(a=int), [(i,) for i in range(N_ROWS)])
    return t.select(a=t.a, b=at_once(t.a))


@pytest.mark.parametrize("attempt", range(3))
def test_a_udf_that_returns_at_once_still_shows_pending(fresh_port, attempt):
    [stream] = capture("torch", _build, stream=True)
    inserted = {}   # key -> (time of its PENDING insert)
    pending_out = {}
    resolved = {}
    for (key, row, t, diff), n in stream.items():
        assert n == 1
        if row[1] == "<Pending>":
            book = inserted if diff > 0 else pending_out
            assert key not in book
            book[key] = t
        else:
            assert diff > 0 and key not in resolved
            resolved[key] = (row, t)
    assert len(inserted) == len(resolved) == N_ROWS
    assert pending_out.keys() == inserted.keys()
    for key, (row, t) in resolved.items():
        assert row == (row[0], row[0] + 1)
        # the resolution retracts PENDING at its own, later time
        assert pending_out[key] == t > inserted[key]


def test_the_final_state_equals_the_jax_packages(fresh_port):
    [state] = equal_to_jax(_build)
    assert sorted(state.values()) == [(i, i + 1) for i in range(N_ROWS)]
