"""PyTorch/CUDA port of ``pathway_tpu``'s RAG serving path.

The generation half (``kvcache.engine.PagedDecodeEngine`` over the paged
KV cache, greedy or seeded sampling, with supervised restart,
speculative decoding and optionally int8-resident weights;
``kvcache.statecache.StateDecodeEngine``, the constant-memory SSD
engine; ``models.decoder.TorchDecoderLM.generate`` over a dense cache;
``models.host_decoder.Int8DecoderHost``, the int8 host tier on the
CPU) and the retrieval half (``models.encoder.TorchEncoder`` plus
``stdlib.indexing.inner_index.BruteForceKnn``) run on one NVIDIA H100.
The four TPU kernels on that path are hand-written CUDA kernels under
``csrc/``, built with ``nvcc`` at first launch (``ops/_cuda.py``).

The package imports ``torch`` and nothing of JAX or ``pathway_tpu``;
module layout follows ``pathway_tpu`` so each module's counterpart is
found under the same path.  Entry points take ``device`` (default
``"cuda"``) and raise when no card is present unless ``device="cpu"``.
"""

from ._device import resolve_device, resolve_dtype

__all__ = ["resolve_device", "resolve_dtype"]
