"""The port's embedder and index inside the JAX package's dataflow.

``DocumentStore.retrieve_query`` runs in static mode (no HTTP, no
wall-clock pacing), as ``tests/test_xpack.py`` runs it, twice on the same
weights (one numpy tree):

- all JAX: ``SentenceTransformerEmbedder`` and ``BruteForceKnn``;
- the port: a ``BaseEmbedder`` that delegates to the port's
  ``SentenceTransformerEmbedder(device_resident=True)`` on the CPU, and a
  retriever factory whose index is the port's ``BruteForceKnn``.  The
  static flow embeds one row at a time (``_embed``), so the wrapper
  answers each row with ``embed_many([text])``: the port's ``DeviceVec``
  handles flow through the JAX engine into the port's index, which
  searches them in its device-resident mode.

Every query's retrieved texts must be equal, in order, and their scores
within ``atol=1e-5`` (f32 encoders and f32 scores on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathway_tpu.debug import table_from_markdown
from pathway_tpu.models import encoder as jenc
from pathway_tpu.stdlib.indexing import BruteForceKnnFactory
from pathway_tpu.xpacks.llm import embedders as jemb
from pathway_tpu.xpacks.llm.document_store import DocumentStore
from pathway_tpu_torch.models import encoder as tenc
from pathway_tpu_torch.models.convert import encoder_params_from_numpy
from pathway_tpu_torch.ops.device_store import DeviceVec
from pathway_tpu_torch.stdlib.indexing.inner_index import BruteForceKnn
from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder

from .test_torch_encoder import _configs, _np_params
from .utils import run_and_squash

DOCS = """
        | data
      1 | "the quick brown fox jumps over the lazy dog"
      2 | "pathway is a stream processing framework for live data"
      3 | "tpus have a systolic array called the mxu"
      4 | "a paged kv cache holds the keys and values of every request"
      5 | "the index answers nearest neighbour queries over embeddings"
      6 | "hopper cards run warpgroup matrix multiplies on tensor cores"
    """
# five queries: the index answers them in one batched search
QUERIES = """
        | query                              | k
      1 | "systolic array mxu"               | 2
      2 | "fox and dog"                      | 3
      3 | "stream processing of live data"   | 2
      4 | "keys and values of a request"     | 2
      5 | "tensor cores on hopper"           | 4
    """


class _PortEmbedder(jemb.BaseEmbedder):
    """The port's embedder behind the JAX package's expression API."""

    def __init__(self, inner: SentenceTransformerEmbedder):
        self.inner = inner

    def _embed(self, text):
        [handle] = self.inner.embed_many([text])
        return handle

    def _embed_many(self, texts):
        return self.inner.embed_many(texts)

    def get_embedding_dimension(self, **kwargs):
        return self.inner.get_embedding_dimension()


BUILT: list = []  # the port indexes the dataflow built


def _port_index(dimensions, *, reserved_space, metric, mesh=None,
                mesh_axis="dp"):
    """``build_index`` passes the JAX index's mesh keywords; the port's
    index has no mesh path, and these runs use none."""
    assert mesh is None
    index = BruteForceKnn(dimensions, reserved_space=reserved_space,
                          metric=metric, device="cpu")
    BUILT.append(index)
    return index


class _PortKnnFactory(BruteForceKnnFactory):
    _index_cls = _port_index


@pytest.fixture(scope="module")
def weights():
    cfg_j, cfg_t = _configs("pre")
    return cfg_j, cfg_t, _np_params(11, post_ln=False)


def _retrieve(store) -> list:
    """Each query's results, in the order of the queries' row keys."""
    state = run_and_squash(store.retrieve_query(table_from_markdown(QUERIES)))
    return [result.value for (result,) in
            (state[k] for k in sorted(state))]


def test_port_embedder_and_index_retrieve_as_the_jax_pipeline(weights):
    cfg_j, cfg_t, tree = weights
    j_emb = jemb.SentenceTransformerEmbedder(config=cfg_j)
    j_emb._enc = jenc.JaxEncoder(
        cfg_j, params=jax.tree_util.tree_map(jnp.asarray, tree))
    want = _retrieve(DocumentStore(
        table_from_markdown(DOCS), retriever_factory=BruteForceKnnFactory(
            dimensions=j_emb.get_embedding_dimension(), embedder=j_emb)))

    inner = SentenceTransformerEmbedder(config=cfg_t, device="cpu",
                                        device_resident=True)
    inner._enc = tenc.TorchEncoder(cfg_t, params=encoder_params_from_numpy(
        tree, cfg_t, device="cpu"), device="cpu")
    assert isinstance(inner.embed_many(["probe"])[0], DeviceVec)
    emb = _PortEmbedder(inner)
    got = _retrieve(DocumentStore(
        table_from_markdown(DOCS), retriever_factory=_PortKnnFactory(
            dimensions=emb.get_embedding_dimension(), embedder=emb)))

    # the port's index held all six chunks as device-resident rows
    assert len(BUILT) == 1 and BUILT[0].n == len(BUILT[0]._dev_refs) == 6
    assert sorted(len(r) for r in got) == [2, 2, 2, 3, 4]  # k per query
    assert [[d["text"] for d in r] for r in got] == \
        [[d["text"] for d in r] for r in want]
    np.testing.assert_allclose([d["score"] for r in got for d in r],
                               [d["score"] for r in want for d in r],
                               atol=1e-5)
