"""Host-memory session tier for the paged KV cache.

The port of ``pathway_tpu/kvcache/tiering.py`` ``SessionStore``.  A
serving front holds many conversations, almost all of them idle between
user turns; keeping every session's K/V resident on the device caps the
session count at the pool size.  :class:`SessionStore` suspends a
finished request's context blocks to host memory (one gather and copy,
``BlockPool.suspend_host``) and resumes the session's next turn by
scattering them into freshly allocated pool blocks
(``BlockPool.resume_host``), so an idle session costs host bytes, not
device blocks, and the next turn skips recomputing its history.

Correctness leans on the engine's divert rule: resumed positions are
marked ``n_diverted`` exactly like prefix-cache hits, so chunk writes for
already-resident positions go to the null block while attention reads
the scattered bytes through the table.  A resume gives back the
suspend-time K/V bit for bit, and a store miss falls back to the normal
recompute prefill.

:meth:`SessionStore.residency_ledger` computes, from an engine's
``hbm_plan`` ledger, how many sessions stay resumable at that fixed HBM
budget with and without the host tier.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict

from ..serve.metrics import register_session_store


class _SessionEntry:
    __slots__ = ("session_id", "tokens", "payload", "nbytes")

    def __init__(self, session_id, tokens, payload, nbytes):
        self.session_id = session_id
        self.tokens = tokens  # the context tokens the stored state covers
        self.payload = payload  # backend-opaque host state
        # the REAL host buffer size, padding included
        self.nbytes = int(nbytes)


class SessionStore:
    """LRU host-memory store of suspended sessions' KV blocks.

    Engine-agnostic and shareable: every replica of a fleet points at ONE
    store, so a session suspended on replica A resumes on replica B (same
    model config, same pool block layout).  ``host_budget_bytes`` bounds
    the bytes held; past it whole sessions are evicted, least recently
    used first (an evicted session's next turn recomputes).

    ``n_suspend_failures`` counts suspends that raised: the engine then
    frees the sequence's blocks, and the session's next turn recomputes.
    A serving run that must not lose sessions holds this count at 0."""

    def __init__(self, *, host_budget_bytes: int | None = None,
                 name: str = "sessions"):
        self.name = name
        self.host_budget_bytes = (
            int(host_budget_bytes) if host_budget_bytes else None
        )
        self._sessions: "OrderedDict[object, _SessionEntry]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.RLock()
        self.n_suspends = 0
        self.n_resumes = 0
        self.n_misses = 0
        self.n_evictions = 0
        self.n_suspend_failures = 0
        self.resumed_tokens = 0
        self.resume_ms: list[float] = []  # bounded sample ring
        register_session_store(self)

    # -- introspection -----------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._sessions)

    @property
    def host_bytes(self) -> int:
        return self._bytes

    def stats(self) -> dict:
        with self._lock:
            samples = sorted(self.resume_ms)
            p99 = (
                samples[min(len(samples) - 1,
                            int(0.99 * len(samples)))]
                if samples else 0.0
            )
            return {
                "suspended_sessions": len(self._sessions),
                "host_bytes": self._bytes,
                "host_budget_bytes": self.host_budget_bytes,
                "suspends": self.n_suspends,
                "resumes": self.n_resumes,
                "misses": self.n_misses,
                "evictions": self.n_evictions,
                "suspend_failures": self.n_suspend_failures,
                "resumed_tokens": self.resumed_tokens,
                "resume_ms_p99": p99,
            }

    # -- suspend / resume --------------------------------------------------
    def match(self, session_id, tokens) -> "_SessionEntry | None":
        """The stored entry IF its context is a non-empty prefix of this
        turn's admitted tokens (the app sent the running conversation
        back, as chat protocols do).  A diverged entry — the app edited
        history — is dropped: resuming it would attend through K/V of
        tokens that no longer exist."""
        with self._lock:
            ent = self._sessions.get(session_id)
            if ent is None:
                self.n_misses += 1
                return None
            n = len(ent.tokens)
            if 0 < n <= len(tokens) and list(tokens[:n]) == ent.tokens:
                self._sessions.move_to_end(session_id)
                return ent
            del self._sessions[session_id]
            self._bytes -= ent.nbytes
            self.n_misses += 1
            return None

    def suspend(self, session_id, pool, seq_id, context_tokens) -> int:
        """Copy the sequence's decode state to host memory and free its
        device allocation (``CacheBackend.suspend_host``).
        ``context_tokens`` are the tokens the state actually covers
        (admitted + fed-back emitted); blocks past their span are not
        copied.  Returns the number of context tokens stored (0 = nothing
        worth storing; the sequence is freed either way)."""
        tokens = [int(t) for t in context_tokens]
        payload, nbytes = pool.suspend_host(seq_id, tokens)
        if payload is None:
            return 0
        ent = _SessionEntry(session_id, tokens, payload, nbytes)
        with self._lock:
            old = self._sessions.pop(session_id, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._sessions[session_id] = ent
            self._bytes += ent.nbytes
            self.n_suspends += 1
            self._evict_over_budget()
        return len(tokens)

    def record_suspend_failure(self) -> None:
        with self._lock:
            self.n_suspend_failures += 1

    def resume_into(self, pool, entry, block_ids) -> int:
        """Scatter a suspended session's state into the freshly allocated
        ``block_ids`` (the engine allocated for the FULL new prompt,
        which the stored context prefixes), through
        ``CacheBackend.resume_host``.  Returns the number of resident
        tokens — the engine's ``n_diverted``."""
        t0 = time.perf_counter()
        pool.resume_host(entry.payload, block_ids)
        ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            self.n_resumes += 1
            self.resumed_tokens += len(entry.tokens)
            self.resume_ms.append(ms)
            if len(self.resume_ms) > 4096:
                del self.resume_ms[:2048]
        return len(entry.tokens)

    def drop(self, session_id) -> bool:
        with self._lock:
            ent = self._sessions.pop(session_id, None)
            if ent is None:
                return False
            self._bytes -= ent.nbytes
            return True

    def clear(self) -> None:
        with self._lock:
            self._sessions.clear()
            self._bytes = 0

    # -- residency accounting ----------------------------------------------
    def residency_ledger(self, plan, *, session_tokens: int,
                         host_budget_bytes: int | None = None) -> dict:
        """How many sessions stay RESIDENT (resumable without recompute)
        at the plan's fixed HBM budget, paged-only vs tiered — computed
        from the ``hbm_plan`` ledger, not sampled.  Paged-only residency
        is bounded by pool blocks; the tier adds host-budget/bytes-per-
        session on top, at zero extra HBM."""
        bs = int(plan.block_size)
        nb_sess = max(-(-int(session_tokens) // bs), 1)
        usable_blocks = max(int(plan.num_blocks) - 1, 0)
        paged_only = usable_blocks // nb_sess
        # host bytes per suspended session: the per-block K/V bytes the
        # plan charges the device, for the session's block span
        per_block = int(plan.per_block_bytes) * max(int(plan.tp), 1)
        per_session_host = nb_sess * per_block
        budget = (host_budget_bytes if host_budget_bytes is not None
                  else self.host_budget_bytes)
        if budget is None:
            # unbounded store: report what the CURRENT contents prove
            host_sessions = len(self._sessions)
        else:
            host_sessions = int(budget) // max(per_session_host, 1)
        tiered = paged_only + host_sessions
        return {
            "hbm_budget_bytes": plan.budget_bytes,
            "hbm_total_bytes": plan.total_bytes,
            "session_tokens": int(session_tokens),
            "blocks_per_session": nb_sess,
            "bytes_per_session_host": per_session_host,
            "paged_only_sessions": paged_only,
            "host_tier_sessions": host_sessions,
            "sessions_resident": tiered,
            "residency_gain": tiered / max(paged_only, 1),
        }

    def _evict_over_budget(self) -> None:
        # caller holds the lock; LRU whole-session eviction (an evicted
        # session is not lost — its next turn recomputes)
        if self.host_budget_bytes is None:
            return
        while self._bytes > self.host_budget_bytes and len(self._sessions) > 1:
            _sid, ent = self._sessions.popitem(last=False)
            self._bytes -= ent.nbytes
            self.n_evictions += 1


__all__ = ["SessionStore"]
