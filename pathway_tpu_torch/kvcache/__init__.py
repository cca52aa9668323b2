"""pathway_tpu_torch.kvcache — paged KV-cache management for batched
decoding (the port of ``pathway_tpu.kvcache``): the block pool behind the
cache-backend contract, hash-chained prefix sharing, the ragged paged
attention kernels, the continuous-batching engine with speculation, and
the host-memory session tier.  The JAX package's state cache
(``StateCache``/``StateDecodeEngine``) and ``make_backend`` are not
ported yet.  ``paged_attention`` stays a submodule here (callers import
the module and its kernel wrappers), not a re-exported function.
"""

from .backend import CacheBackend
from .block_pool import BlockPool, PoolExhausted, SequenceState
from .engine import EngineHungError, PagedDecodeEngine
from .prefix_cache import PrefixCache
from .speculative import (Drafter, DraftModelDrafter, NGramDrafter,
                          SpecController)
from .tiering import SessionStore

__all__ = [
    "BlockPool",
    "CacheBackend",
    "DraftModelDrafter",
    "Drafter",
    "EngineHungError",
    "NGramDrafter",
    "PagedDecodeEngine",
    "PoolExhausted",
    "PrefixCache",
    "SequenceState",
    "SessionStore",
    "SpecController",
]
