"""The RAG path's document and query embedder.

Counterpart of ``pathway_tpu/xpacks/llm/embedders.py``
``SentenceTransformerEmbedder``, as a plain class: the JAX package's
``BaseEmbedder`` builds dataflow expressions, and the port imports
nothing of that dataflow.  A dataflow that wants this embedder wraps it
(``tests/test_torch_rag_dataflow.py`` does so).
"""

from __future__ import annotations

import os

import numpy as np

from ..._device import resolve_device
from ...models.encoder import EncoderConfig, TorchEncoder
from ...serve.scheduler import RequestScheduler


class SentenceTransformerEmbedder:
    """The port's transformer encoder behind ``embed`` / ``embed_many``.

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
    (d,) row each."""

    def __init__(self, model: str | None = None, *, config=None,
                 seed: int = 0, device="cuda",
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

    @property
    def encoder(self) -> TorchEncoder:
        """The encoder behind this embedder (its ``compiled_query_encoder``
        serves single queries on the same weights)."""
        return self._enc

    def embed(self, text: str) -> np.ndarray:
        """One text's (d,) f32 embedding on the host (bf16 compute on the
        card, f32 on the CPU); through the batch scheduler when there is
        one."""
        if self._scheduler is not None:
            return self._scheduler.submit(text or "")
        return self._enc.embed(text or "").float().cpu().numpy()

    def _embed_rows(self, texts: list[str]) -> list[np.ndarray]:
        """The default batch scheduler's ``batch_fn``: one forward for
        the batch, a (d,) f32 numpy row per text."""
        texts = [t or "" for t in texts]
        return list(self._enc.embed_batch(texts).float().cpu().numpy())

    def embed_many(self, texts: list[str]) -> list:
        """One embedding per text: ``DeviceVec`` handles when
        ``device_resident`` (nothing synchronised or fetched), else (d,)
        numpy rows."""
        texts = [t or "" for t in texts]
        if self.device_resident:
            return self._enc.embed_batch_device(texts)
        return list(self._enc.embed_batch(texts).float().cpu().numpy())

    def get_embedding_dimension(self, **kwargs) -> int:
        return self._enc.dimensions
