"""The RAG path's document and query embedder.

Counterpart of ``pathway_tpu/xpacks/llm/embedders.py``: its
``BaseEmbedder`` (for embedders written over another callable, such as
the vector store's LangChain adapter) and ``SentenceTransformerEmbedder``,
with the JAX package's ``BaseEmbedder`` surface (``_embed``,
``_embed_one``, ``_embed_uncached``, ``_embed_many``,
``cache_strategy=``, the ``rag.embed`` spans), so a
JAX caller that is handed this embedder (a reranker, an image or text
index) runs over it unchanged.  Calling it on a string embeds the
string; calling it on a column expression of the port's dataflow gives
an ``ApplyExpression`` whose ``batch_fn`` embeds a whole update batch in
one call (``_embed_many_traced``), as the JAX ``BaseEmbedder`` does: a
``DataIndex`` over it receives ``DeviceVec`` handles when
``device_resident``.

The API embedders (``OpenAIEmbedder``, ``LiteLLMEmbedder``,
``GeminiEmbedder``) call their client packages and return (d,) f32 rows;
``BedrockEmbedder`` and ``MarengoEmbedder`` raise ``ImportError`` when
called, as in the JAX package.
"""

from __future__ import annotations

import os
import time

import numpy as np

from ..._device import resolve_device
from ...internals import dtype as dt
from ...internals.expression import ApplyExpression, ColumnExpression
from ...internals.udfs import CacheStrategy, with_cache_strategy
from ...models.encoder import EncoderConfig, TorchEncoder
from ...obs.tracer import record_span
from ...serve.scheduler import RequestScheduler


class BaseEmbedder:
    """The JAX package's embedder base: subclasses implement ``_embed``
    (one text to one vector).  Callable on column expressions (an
    ``ApplyExpression`` whose ``batch_fn`` embeds an update batch through
    ``_embed_many``) and on plain strings (immediate evaluation)."""

    def _embed(self, text: str) -> np.ndarray:
        raise NotImplementedError

    def _embed_many(self, texts: list[str]) -> list[np.ndarray]:
        return [self._embed(t) for t in texts]

    def get_embedding_dimension(self, **kwargs) -> int:
        return int(np.asarray(self._embed("dimension probe")).shape[0])

    def _embed_traced(self, text):
        t0 = time.perf_counter()
        out = self._embed(text)
        record_span("rag.embed", t0, time.perf_counter(), n=1,
                    embedder=type(self).__name__)
        return out

    def _embed_many_traced(self, texts):
        t0 = time.perf_counter()
        out = self._embed_many(texts)
        record_span("rag.embed", t0, time.perf_counter(), n=len(texts),
                    embedder=type(self).__name__)
        return out

    def __call__(self, text, **kwargs):
        if isinstance(text, ColumnExpression):
            return ApplyExpression(
                self._embed_traced, dt.ANY_ARRAY, (text,), {},
                propagate_none=True, batch_fn=self._embed_many_traced)
        return self._embed_traced(text)


class SentenceTransformerEmbedder:
    """The port's transformer encoder behind ``embed`` / ``embed_many``
    and the JAX ``BaseEmbedder`` methods.

    ``model`` naming an existing local path loads BERT-family weights
    through ``models/hf_import.py``; any other value (or None) builds the
    hash-tokenizer encoder of ``config`` with random weights from
    ``seed``.  ``device_resident`` (default: True on the card, False on
    the CPU) makes ``embed_many`` return ``DeviceVec`` handles that stay
    on the device, for a KNN index to consolidate there.

    ``batch_scheduler`` coalesces concurrent :meth:`embed` calls into one
    forward per batch (serve/scheduler.py): ``True`` builds the JAX
    embedder's default scheduler (batches of up to 64, 3 ms linger,
    sizes padded to 1, 2, 4, ..., 64); or pass a configured
    ``RequestScheduler`` whose ``batch_fn`` maps a list of texts to one
    (d,) row each.

    ``cache_strategy`` (``internals/udfs.py``) caches single-text
    embeddings under the name ``emb:<model_name>``, with the JAX
    package's keys: a ``DiskCache`` directory serves both packages."""

    def __init__(self, model: str | None = None, *, config=None,
                 seed: int = 0, device="cuda",
                 cache_strategy: CacheStrategy | None = None,
                 device_resident: bool | None = None,
                 batch_scheduler=None):
        dev = resolve_device(device)
        if model is not None and config is None and os.path.exists(model):
            self._enc = TorchEncoder.from_hf(model, device=dev)
        else:
            self._enc = TorchEncoder(config or EncoderConfig(), seed=seed,
                                     device=dev)
        if device_resident is None:
            device_resident = dev.type == "cuda"
        self.device_resident = device_resident
        self.model_name = model or "pathway-tpu-minilm"
        if batch_scheduler is True:
            batch_scheduler = RequestScheduler(
                self._embed_rows, name=f"embed:{self.model_name}",
                max_batch_size=64, batch_linger_ms=3.0,
                size_buckets=(1, 2, 4, 8, 16, 32, 64),
            )
        self._scheduler = batch_scheduler or None
        if cache_strategy is not None:
            self._embed = with_cache_strategy(  # type: ignore[method-assign]
                self._embed_one, cache_strategy, f"emb:{self.model_name}")

    @property
    def encoder(self) -> TorchEncoder:
        """The encoder behind this embedder (its ``compiled_query_encoder``
        serves single queries on the same weights)."""
        return self._enc

    def _embed_uncached(self, text: str) -> np.ndarray:
        """One text's (d,) f32 row on the host (bf16 compute on the card,
        f32 on the CPU)."""
        return self._enc.embed(text or "").float().cpu().numpy()

    def _embed_one(self, text: str) -> np.ndarray:
        if self._scheduler is not None:
            return self._scheduler.submit(text or "")
        return self._embed_uncached(text)

    def _embed(self, text: str) -> np.ndarray:
        return self._embed_one(text)

    def _embed_rows(self, texts: list[str]) -> list[np.ndarray]:
        """The default batch scheduler's ``batch_fn``: one forward for
        the batch, a (d,) f32 numpy row per text."""
        texts = [t or "" for t in texts]
        return list(self._enc.embed_batch(texts).float().cpu().numpy())

    def _embed_many(self, texts: list[str]) -> list:
        """One embedding per text: ``DeviceVec`` handles when
        ``device_resident`` (nothing synchronised or fetched), else (d,)
        numpy rows."""
        if self.device_resident:
            return self._enc.embed_batch_device([t or "" for t in texts])
        return self._embed_rows(texts)

    def _embed_traced(self, text):
        t0 = time.perf_counter()
        out = self._embed(text)
        record_span("rag.embed", t0, time.perf_counter(), n=1,
                    embedder=type(self).__name__)
        return out

    def _embed_many_traced(self, texts):
        t0 = time.perf_counter()
        out = self._embed_many(texts)
        record_span("rag.embed", t0, time.perf_counter(), n=len(texts),
                    embedder=type(self).__name__)
        return out

    def __call__(self, text, **kwargs):
        """Embed one string (traced as a ``rag.embed`` span), or build the
        dataflow expression embedding a column: one row per text through
        ``_embed_traced``, one update batch per call through
        ``_embed_many_traced``."""
        if isinstance(text, ColumnExpression):
            return ApplyExpression(
                self._embed_traced, dt.ANY_ARRAY, (text,), {},
                propagate_none=True, batch_fn=self._embed_many_traced)
        if not isinstance(text, str):
            raise TypeError(
                f"{type(self).__name__} embeds a str or a column "
                f"expression, got {type(text).__name__}")
        return self._embed_traced(text)

    def embed(self, text: str) -> np.ndarray:
        """One text's (d,) f32 embedding on the host (through the cache
        and the batch scheduler when there are any)."""
        return self._embed(text)

    def embed_many(self, texts: list[str]) -> list:
        """:meth:`_embed_many`, for the port's own callers."""
        return self._embed_many(texts)

    def get_embedding_dimension(self, **kwargs) -> int:
        return self._enc.dimensions


TorchEmbedder = SentenceTransformerEmbedder


class OpenAIEmbedder(BaseEmbedder):
    """OpenAI's embeddings through the ``openai`` client.  ``capacity``,
    ``cache_strategy`` and ``retry_strategy`` are accepted and ignored,
    as in the JAX package."""

    def __init__(self, model: str = "text-embedding-3-small", *,
                 capacity: int | None = None, api_key: str | None = None,
                 cache_strategy=None, retry_strategy=None, **kwargs):
        self.model = model
        self.kwargs = dict(kwargs)
        self.api_key = api_key

    def _embed(self, text: str) -> np.ndarray:
        try:
            import openai
        except ImportError as exc:
            raise ImportError(
                "OpenAIEmbedder requires the openai package") from exc
        client = openai.OpenAI(api_key=self.api_key)
        res = client.embeddings.create(input=[text or " "], model=self.model,
                                       **self.kwargs)
        return np.array(res.data[0].embedding, dtype=np.float32)


class LiteLLMEmbedder(BaseEmbedder):
    """Any embedding model ``litellm.embedding`` reaches."""

    def __init__(self, model: str, *, cache_strategy=None,
                 retry_strategy=None, **kwargs):
        self.model = model
        self.kwargs = kwargs

    def _embed(self, text: str) -> np.ndarray:
        try:
            import litellm
        except ImportError as exc:
            raise ImportError("LiteLLMEmbedder requires litellm") from exc
        res = litellm.embedding(model=self.model, input=[text or " "],
                                **self.kwargs)
        return np.array(res["data"][0]["embedding"], dtype=np.float32)


class GeminiEmbedder(LiteLLMEmbedder):
    def __init__(self, model: str = "models/text-embedding-004", **kwargs):
        super().__init__(model=f"gemini/{model}", **kwargs)


class BedrockEmbedder(BaseEmbedder):
    """Needs boto3, which neither package carries: a call raises
    ``ImportError``, as in the JAX package."""

    def __init__(self, model_id: str = "amazon.titan-embed-text-v2:0",
                 **kwargs):
        self.model_id = model_id

    def _embed(self, text):
        raise ImportError("BedrockEmbedder requires boto3 + AWS credentials")


class MarengoEmbedder(BaseEmbedder):
    """Needs the twelvelabs client: a call raises ``ImportError``, as in
    the JAX package."""

    def __init__(self, *args, **kwargs):
        pass

    def _embed(self, text):
        raise ImportError("MarengoEmbedder requires the twelvelabs client")


__all__ = [
    "BaseEmbedder", "SentenceTransformerEmbedder", "TorchEmbedder",
    "OpenAIEmbedder", "LiteLLMEmbedder", "GeminiEmbedder", "BedrockEmbedder",
    "MarengoEmbedder",
]
