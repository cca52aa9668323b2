"""The engine↔cache contract, as far as the paged cache needs it.

:class:`CacheBackend` names what a cache backend owns: the slot
lifecycle (``allocate`` / ``extend_slots`` / ``append_slot`` /
``free_sequence``), the per-sequence records, and its invariants
(``check_invariants``), and the suspend/resume pair the session tier
(``tiering.SessionStore``) moves idle sequences to host memory with.
The JAX package's capability flags and byte accounting serve backends
and callers the port does not have yet.
"""

from __future__ import annotations

import abc


class CacheBackend(abc.ABC):
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

    def retire(self) -> None:
        """Release what the backend registered process-wide; the paged
        pool registers nothing, so the default does nothing."""
