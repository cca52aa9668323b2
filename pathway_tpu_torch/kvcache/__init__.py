"""pathway_tpu_torch.kvcache — KV and state caches for batched decoding
(the port of ``pathway_tpu.kvcache``): the block pool and the SSD state
cache behind the cache-backend contract and its ``make_backend`` seam,
hash-chained prefix sharing, the ragged paged attention kernels, the
continuous-batching paged engine with speculation, the constant-memory
state engine, and the host-memory session tier.  ``paged_attention``
stays a submodule here (callers import the module and its kernel
wrappers), not a re-exported function; its plain version
``paged_attention_reference`` is exported, as in the JAX package.
"""

from .backend import CacheBackend, UnsupportedCacheOp, make_backend
from .block_pool import BlockPool, PoolExhausted, SequenceState
from .engine import EngineHungError, PagedDecodeEngine, resolve_tp
from .paged_attention import paged_attention_reference
from .prefix_cache import PrefixCache
from .speculative import (Drafter, DraftModelDrafter, NGramDrafter,
                          SpecController, SpecResourceError)
from .statecache import StateCache, StateDecodeEngine
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
    "SpecResourceError",
    "StateCache",
    "StateDecodeEngine",
    "UnsupportedCacheOp",
    "make_backend",
    "paged_attention_reference",
    "resolve_tp",
]
