"""pathway_tpu_torch sequence-parallel attention against the JAX package.

Ring and Ulysses attention over ``["cpu"] * n`` sequence shards equal
the JAX ``make_ring_attention`` / ``make_ulysses_attention`` on the
conftest's virtual devices within 1e-5 absolute (f32: the block merge
and the all-to-alls reorder sums, nothing else), causal and not, at 4
and 8 shards; Ulysses raises on ``H % n != 0``; and
``make_sequence_parallel_attention("auto")`` picks as the JAX one does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pathway_tpu.models import attention as jattn
from pathway_tpu_torch.models import attention as tattn
from pathway_tpu_torch.parallel.mesh import TPMesh

# the JAX functions shard through the top-level jax.shard_map
pytestmark = pytest.mark.skipif(
    not hasattr(jax, "shard_map"),
    reason="this jax build has no top-level jax.shard_map")


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


def _meshes(n):
    return (Mesh(np.asarray(jax.devices()[:n]), ("sp",)),
            TPMesh(["cpu"] * n, ("sp",)))


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


def _run_port(fn, mesh, q, k, v):
    shards = [tattn.shard_sequence(torch.from_numpy(x), mesh)
              for x in (q, k, v)]
    out = fn(*shards)
    assert [o.device for o in out] == mesh.devices
    return torch.cat(out, dim=1).numpy()


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_sequence_parallel_attention_equals_the_jax_one(strategy, causal, n):
    jm, tm = _meshes(n)
    q, k, v = _qkv(n + 2 * causal, (2, 64, 8, 16))
    jfn = getattr(jattn, f"make_{strategy}_attention")(jm, "sp",
                                                        causal=causal)
    tfn = getattr(tattn, f"make_{strategy}_attention")(tm, "sp",
                                                        causal=causal)
    want = np.asarray(jax.jit(jfn)(*(jnp.asarray(x) for x in (q, k, v))))
    got = _run_port(tfn, tm, q, k, v)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    ref = tattn.reference_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                    causal=causal).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_ulysses_raises_when_the_heads_do_not_divide():
    _jm, tm = _meshes(4)
    bad = tattn.make_ulysses_attention(tm, "sp")
    x = tattn.shard_sequence(torch.zeros((1, 16, 6, 4)), tm)
    with pytest.raises(ValueError, match="n_heads % axis size"):
        bad(x, x, x)
    with pytest.raises(ValueError, match="n_heads"):
        tattn.make_sequence_parallel_attention(tm, "sp", n_heads=6,
                                               strategy="ulysses")
    with pytest.raises(ValueError, match="strategy"):
        tattn.make_sequence_parallel_attention(tm, "sp", n_heads=8,
                                               strategy="nope")
    with pytest.raises(ValueError, match="one-axis mesh named 'sp'"):
        tattn.make_ring_attention(TPMesh(["cpu"] * 4, ("tp",)), "sp")


@pytest.mark.parametrize("n_heads,seq_len", [(8, 1024), (6, 1024),
                                             (8, 65536), (8, None)])
def test_auto_picks_as_the_jax_one_does(n_heads, seq_len):
    jm, tm = _meshes(4)
    want = jattn.make_sequence_parallel_attention(
        jm, "sp", n_heads=n_heads, seq_len=seq_len, strategy="auto")
    got = tattn.make_sequence_parallel_attention(
        tm, "sp", n_heads=n_heads, seq_len=seq_len, strategy="auto")
    assert got.strategy == want.strategy
    # and the pick runs
    q, k, v = _qkv(3, (1, 16, n_heads, 4))
    ref = tattn.reference_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(_run_port(got, tm, q, k, v), ref.numpy(),
                               rtol=0, atol=1e-5)
