"""The engine↔cache contract and the seam engines build caches through.

:class:`CacheBackend` names what a cache backend owns: the slot
lifecycle (``allocate`` / ``extend_slots`` / ``append_slot`` /
``free_sequence``), the per-sequence records, its invariants
(``check_invariants``), and the suspend/resume pair the session tier
(``tiering.SessionStore``) moves idle sequences to host memory with.
Capability flags say which optional operations a backend implements
(a caller's query: each engine knows the kind it builds and calls only
what that kind supports); the others raise :class:`UnsupportedCacheOp`.

``make_backend(kind, **kwargs)`` constructs a backend by kind: engines
build their cache through it and rebuild it through it on a supervised
restart.  ``"paged"`` is :class:`~.block_pool.BlockPool`, ``"state"``
:class:`~.statecache.StateCache`.
"""

from __future__ import annotations

import abc
from typing import Callable


class UnsupportedCacheOp(NotImplementedError):
    """An optional capability (fork, preemption, prefix sharing) the
    backend does not implement (its ``supports_*`` flag is False)."""


class CacheBackend(abc.ABC):
    #: "paged" | "state": the factory key
    cache_kind: str = "abstract"
    #: optional capabilities, for callers that hold a backend of either
    #: kind (the engines do not read them: each builds one kind)
    supports_fork: bool = False
    supports_prefix: bool = False
    supports_preemption: bool = False

    @abc.abstractmethod
    def allocate(self, seq_id, n_tokens: int, *, shared_blocks=(),
                 priority: int = 1):
        """Claim device memory for a new sequence of ``n_tokens``;
        raises the backend's capacity error with NO side effects when it
        cannot."""

    @abc.abstractmethod
    def extend_slots(self, seq_id, k: int) -> list:
        """Grow the sequence by ``k`` write slots, atomically."""

    def append_slot(self, seq_id):
        """Reserve the write slot for the sequence's next token."""
        return self.extend_slots(seq_id, 1)[0]

    @abc.abstractmethod
    def free_sequence(self, seq_id) -> None:
        """Release the sequence's device memory."""

    @abc.abstractmethod
    def sequence(self, seq_id):
        """The live per-sequence record (``.block_ids``, ``.n_tokens``,
        ``.priority``, ``.arrival``)."""

    @abc.abstractmethod
    def sequences(self):
        """The live per-sequence records."""

    # -- suspend / resume (tiering.SessionStore) ---------------------------
    @abc.abstractmethod
    def suspend_host(self, seq_id, context_tokens) -> tuple[dict | None, int]:
        """Copy the sequence's decode state to host memory and free its
        device allocation.  Returns ``(payload, nbytes)`` where
        ``payload`` is backend-opaque (None when there was nothing to
        copy) and ``nbytes`` is the HOST bytes the store must charge —
        the real buffer size, padding included."""

    @abc.abstractmethod
    def resume_host(self, payload: dict, slot_ids) -> None:
        """Scatter a suspended payload back into freshly allocated
        ``slot_ids`` (the ``.block_ids`` of the resuming sequence)."""

    @abc.abstractmethod
    def check_invariants(self, external_refs=None) -> None:
        """Raise AssertionError on any backend-internal inconsistency."""

    # -- byte accounting ---------------------------------------------------
    def state_bytes_per_seq(self, n_tokens: int) -> int:
        """Device bytes one sequence of ``n_tokens`` occupies: grows with
        the block span in the paged pool, a constant in the state
        cache."""
        raise UnsupportedCacheOp(
            f"{type(self).__name__} does not account per-sequence bytes")

    # -- optional capabilities ---------------------------------------------
    def fork(self, parent_id, child_id, *, priority=None):
        raise UnsupportedCacheOp(f"{type(self).__name__} does not support fork")

    def preempt(self, *, exclude=frozenset()):
        raise UnsupportedCacheOp(
            f"{type(self).__name__} does not support preemption")

    def retire(self) -> None:
        """Release what the backend registered process-wide; the port's
        backends register nothing, so the default does nothing."""


_BACKENDS: dict[str, Callable] = {}


def register_backend(kind: str, factory: Callable) -> None:
    """Bind ``kind`` to ``factory`` for :func:`make_backend`.  The two
    built-in kinds register themselves on first use; the port's own
    callers are the tests, which substitute a factory to observe or
    fault an engine's pool construction and restart rebuild."""
    _BACKENDS[kind] = factory


def make_backend(kind: str, **kwargs) -> CacheBackend:
    """Construct a cache backend by kind (``"paged"``, ``"state"``, or
    one registered with :func:`register_backend`)."""
    if kind not in _BACKENDS:
        # registered lazily: block_pool and statecache import this module
        if kind == "paged":
            from .block_pool import BlockPool

            register_backend("paged", BlockPool)
        elif kind == "state":
            from .statecache import StateCache

            register_backend("state", StateCache)
        else:
            raise ValueError(
                f"unknown cache backend {kind!r}; registered: "
                f"{sorted(_BACKENDS)} + builtin: paged, state")
    return _BACKENDS[kind](**kwargs)
