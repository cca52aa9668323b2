"""Continuous-batching greedy generation over the paged KV cache.

The port of ``pathway_tpu/kvcache/engine.py`` ``PagedDecodeEngine`` in
its default configuration:

- admission (chunked): a request's prompt is matched against the prefix
  cache (shared leading blocks are mapped instead of re-stored and
  re-computed), fresh blocks are allocated for the remainder, and the
  prompt streams through the RAGGED fused step
  (``models/decoder.paged_mixed_step``, the ragged paged-attention
  kernel) in ``prefill_chunk``-token chunks packed beside the in-flight
  decode rows — an arrival never stalls running decodes behind a
  monolithic prefill;
- admission (``chunked_prefill=False``): the prompt is prefilled whole,
  padded to its ``seq_buckets`` bucket, by ONE dense pass
  (``models/decoder.paged_prefill``; the flash-attention kernel on the
  card for buckets >= 256) whose K/V is scattered into the sequence's
  blocks, and its greedy first token is emitted at admission;
- decode: rows with no chunk in flight advance one token per step
  (``paged_decode_step``, the append+attend kernel), or, when the queue
  is quiet, up to ``chain_steps`` greedy steps per dispatch
  (``paged_chained_decode``) with one [B, K] ids sync per chain, the
  next chain dispatched before the previous chain's completions are
  delivered;
- greedy argmax runs on the device; only [B] (or [B, K]) int32 ids come
  back to the host per round;
- preemption: when the pool is exhausted, refcount-1 prefix blocks are
  evicted first, then a victim (lowest priority class, most recent
  arrival) is preempted and later re-admitted by recompute over
  ``prompt + emitted`` — token-identical to never having been
  preempted.

Shapes per round are fixed: ``max_batch_size`` rows, ``prefill_chunk``
query columns, ``max_batch_size + prefill_chunk`` packed tokens in a
mixed round; idle rows and columns write to the reserved null block.

Sizes (``num_blocks``, ``block_size``, ``max_batch_size``,
``chain_steps``) are explicit arguments with plain defaults; the JAX
package's HBM/cost-store planner, watchdog/restart/degrade, sessions,
speculation, sampling, int8 and tensor parallelism are not ported yet.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable

import numpy as np
import torch

from .._device import resolve_device, resolve_dtype
from ..models.decoder import (greedy, paged_chained_decode, paged_decode_step,
                              paged_mixed_step, paged_prefill,
                              plan_decode_params)
from ..models.encoder import params_to
from .block_pool import BlockPool, PoolExhausted
from .prefix_cache import PrefixCache


def _payload_extras(r) -> int:
    """The optional priority after ``(prompt, max_new)`` (default 1)."""
    return int(r[2]) if len(r) > 2 and r[2] is not None else 1


class _Request:
    __slots__ = ("prompt", "max_new", "priority", "stop_token", "emitted",
                 "index", "on_done", "on_error")

    def __init__(self, prompt, max_new: int, *, priority: int = 1,
                 stop_token: int | None = None, index: int | None = None,
                 on_done: Callable | None = None,
                 on_error: Callable | None = None):
        self.prompt = [int(t) for t in prompt]
        self.max_new = int(max_new)
        self.priority = int(priority)
        self.stop_token = stop_token
        self.emitted: list[int] = []
        self.index = index
        self.on_done = on_done
        self.on_error = on_error


class _Active:
    __slots__ = ("seq_id", "req", "tokens", "n_filled", "n_diverted",
                 "prefix_keys", "wait_writer")

    def __init__(self, seq_id: int, req: _Request):
        self.seq_id = seq_id
        self.req = req
        # the (trimmed) prompt still streaming in; None once prefilled
        self.tokens: list[int] | None = None
        self.n_filled = 0
        self.n_diverted = 0  # positions < this are prefix-shared blocks
        self.prefix_keys: list | None = None
        # the sequence whose chunked prefill is STILL WRITING our shared
        # leading blocks: our chunks are gated on its progress
        self.wait_writer: "_Active | None" = None


class PagedDecodeEngine:
    """Batched greedy decoding through BlockPool + PrefixCache."""

    def __init__(self, cfg, params, *, num_blocks: int = 512,
                 block_size: int = 16, max_blocks_per_seq: int | None = None,
                 max_batch_size: int = 8, seq_buckets=(64, 256, 1024),
                 prefix_sharing: bool = True, stop_token: int | None = None,
                 prefill_chunk: int | None = None, chain_steps: int = 8,
                 chunked_prefill: bool = True, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.stop_token = stop_token
        self.dtype = resolve_dtype(cfg.dtype, self.device)
        self.params = params_to(plan_decode_params(cfg, params),
                                self.device, self.dtype)
        self.max_batch_size = int(max_batch_size)
        self.pool = BlockPool(
            num_blocks=num_blocks, block_size=block_size,
            n_layers=cfg.n_layers, n_heads=cfg.n_heads,
            head_dim=cfg.d_model // cfg.n_heads, dtype=self.dtype,
            device=self.device,
        )
        self.prefix = PrefixCache(self.pool) if prefix_sharing else None
        bs = self.pool.block_size
        cap = min((num_blocks - 1) * bs, cfg.max_len)
        if max_blocks_per_seq is None:
            max_blocks_per_seq = -(-cap // bs)
        self.max_blocks_per_seq = int(max_blocks_per_seq)
        self.max_seq_tokens = min(self.max_blocks_per_seq * bs, cfg.max_len)
        # the longest admitted prompt: block-aligned buckets capped at
        # what one table can span
        bucket_cap = max((self.max_seq_tokens // bs) * bs, bs)
        self.seq_buckets = sorted({
            min(-(-b // bs) * bs, bucket_cap) for b in seq_buckets
        }) or [bucket_cap]
        self.chunked_prefill = bool(chunked_prefill)
        # chunk width: block-aligned, default two blocks per step
        if prefill_chunk is None:
            prefill_chunk = 2 * bs
        self.prefill_chunk = max(bs, min(-(-int(prefill_chunk) // bs) * bs,
                                         bucket_cap))
        # packed token budget of one ragged dispatch: each decode row
        # costs one token, the rest is chunk headroom
        self.mixed_tokens = self.max_batch_size + self.prefill_chunk
        self.chain_steps = max(1, int(chain_steps))
        self.rounds = {"mixed": 0, "decode": 0, "chain": 0, "prefill": 0}
        self._seq_counter = 0
        self._lock = threading.RLock()
        # chain key -> (writer _Active, physical block) for blocks an
        # in-flight chunked prefill is still writing (per run)
        self._inflight_prefix: dict = {}

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # -- public API --------------------------------------------------------
    def generate(self, prompt_ids, max_new: int, *,
                 stop_token: int | None = None) -> list[int]:
        """Single-sequence convenience wrapper over :meth:`generate_batch`."""
        return self.generate_batch([(list(prompt_ids), max_new)],
                                   stop_token=stop_token)[0]

    def serve_batch(self, reqs, scheduler=None) -> list:
        """``batch_fn`` adapter for a request scheduler: ``reqs`` are
        ``(prompt_ids, n_new[, priority])`` payloads; a per-request
        failure lands in that request's result slot.  With ``scheduler``
        (anything with ``poll_inflight(n)``, ``complete_inflight(w,
        result)`` and ``fail_inflight(w, exc)``), new arrivals are
        admitted into the in-flight batch at step boundaries."""
        import functools

        poll = None
        if scheduler is not None:
            def poll(n):
                return [
                    ((list(w.payload[0]), int(w.payload[1])), int(w.priority),
                     functools.partial(scheduler.complete_inflight, w),
                     functools.partial(scheduler.fail_inflight, w))
                    for w in scheduler.poll_inflight(n)
                ]
        return self.generate_batch(
            [(list(r[0]), int(r[1]), _payload_extras(r)) for r in reqs],
            poll=poll, return_exceptions=True,
        )

    def generate_batch(self, requests, *, poll: Callable | None = None,
                       stop_token: int | None = None,
                       return_exceptions: bool = False) -> list[list[int]]:
        """Greedy-decode ``(prompt_ids, max_new[, priority])`` requests.

        ``poll(n)``, when given, is called at every step boundary and may
        return up to ``n`` newly arrived ``(payload, priority, on_done,
        on_error)`` tuples to admit; their results flow through the
        callbacks.  ``return_exceptions=True`` places a per-request
        exception in its result slot instead of raising."""
        stop = self.stop_token if stop_token is None else stop_token
        pending: deque[_Request] = deque(
            _Request(r[0], r[1], priority=_payload_extras(r),
                     stop_token=stop, index=i)
            for i, r in enumerate(requests)
        )
        results: list[Any] = [None] * len(requests)
        errors: list[BaseException] = []
        outstanding = {"n": len(requests)}

        def deliver(req: _Request, err: BaseException | None = None) -> None:
            if req.on_done is None and req.on_error is None:
                outstanding["n"] -= 1
            if err is not None:
                if req.on_error is not None:
                    req.on_error(err)
                elif return_exceptions:
                    results[req.index] = err
                else:
                    errors.append(err)
            elif req.on_done is not None:
                req.on_done(list(req.emitted))
            else:
                results[req.index] = list(req.emitted)

        if poll is not None:
            inner_poll = poll

            def poll(n):  # noqa: F811 - bounded by batch-origin work
                return inner_poll(n) if outstanding["n"] > 0 else []

        with self._lock:
            running: list[_Active] = []
            self._inflight_prefix.clear()
            try:
                self._loop_body(running, pending, deliver, poll, stop)
            except BaseException as exc:
                # fail everything still in flight: callers blocked on a
                # callback must not hang
                for act in running:
                    self.pool.free_sequence(act.seq_id)
                for req in [a.req for a in running] + list(pending):
                    if req.on_error is not None:
                        req.on_error(exc)
                raise
        if errors:
            raise errors[0]
        return results

    # -- main loop ---------------------------------------------------------
    def _admit_arrivals(self, running, pending, poll, stop) -> None:
        if poll is None or len(running) >= self.max_batch_size:
            return
        budget = self.max_batch_size - len(running) - len(pending)
        for payload, priority, on_done, on_error in (
                poll(budget) if budget > 0 else ()):
            self._requeue(pending, _Request(
                payload[0], payload[1], priority=priority, stop_token=stop,
                on_done=on_done, on_error=on_error,
            ))

    def _loop_body(self, running, pending, deliver, poll, stop) -> None:
        while pending or running:
            self._admit_arrivals(running, pending, poll, stop)
            while pending and len(running) < self.max_batch_size:
                status = self._try_admit(pending[0], running, deliver)
                if status == "wait":
                    break
                pending.popleft()
            if not running:
                break
            self._step_round(running, pending, deliver, poll, stop)

    def _readmit_len(self, req: _Request) -> int:
        """How many tokens admission would prefill for ``req`` now."""
        total = len(req.prompt) + len(req.emitted)
        remaining = req.max_new - len(req.emitted)
        if total + remaining > self.max_seq_tokens:
            return max(self.max_seq_tokens - remaining, 1)
        return total

    def _requeue(self, pending, req: _Request) -> None:
        """Queue by PRIORITY class: ahead of strictly-lower-priority work,
        behind equal-or-higher."""
        idx = next(
            (i for i, r in enumerate(pending) if r.priority > req.priority),
            len(pending),
        )
        pending.insert(idx, req)

    def _is_done(self, req: _Request, seq_id: int) -> bool:
        if len(req.emitted) >= req.max_new:
            return True
        if req.stop_token is not None and req.emitted[-1] == req.stop_token:
            return True
        # capacity: the next token's position must fit the table
        return self.pool.sequence(seq_id).n_tokens >= self.max_seq_tokens

    def _finish(self, act: _Active, running, deliver) -> None:
        running.remove(act)
        self.pool.free_sequence(act.seq_id)
        deliver(act.req)

    # -- admission ---------------------------------------------------------
    def _try_admit(self, req: _Request, running, deliver) -> str:
        """Allocate one request's blocks and queue its prompt for chunked
        streaming (no device work), or, with ``chunked_prefill=False``,
        prefill it whole (:meth:`_prefill_whole`).  Returns "admitted",
        "done" (nothing left to generate), "failed" (delivered as an
        error) or "wait" (pool full while other sequences run)."""
        if req.max_new - len(req.emitted) <= 0:
            deliver(req)
            return "done"
        tokens = req.prompt + req.emitted
        remaining = req.max_new - len(req.emitted)
        if len(tokens) + remaining > self.max_seq_tokens:
            # keep the most recent context that leaves room for every
            # new token
            tokens = tokens[-max(self.max_seq_tokens - remaining, 1):]
        if len(tokens) > self.seq_buckets[-1]:
            tokens = tokens[-self.seq_buckets[-1]:]
        tokens = tokens or [4]
        n = len(tokens)
        self._seq_counter += 1
        seq_id = self._seq_counter
        state = None
        while state is None:
            shared, keys, writer = [], [], None
            if self.prefix is not None:
                shared, keys = self.prefix.match(tokens)
                # extend the match into blocks an IN-FLIGHT chunked
                # prefill is still writing (one writer only)
                for key in keys[len(shared):]:
                    ent = self._inflight_prefix.get(key)
                    if ent is None or (writer is not None
                                       and ent[0] is not writer):
                        break
                    writer = ent[0]
                    shared.append(ent[1])
            try:
                state = self.pool.allocate(seq_id, n, shared_blocks=shared,
                                           priority=req.priority)
            except PoolExhausted as exc:
                if self.prefix is not None and self.prefix.evict(
                        exc.needed - exc.free):
                    continue  # re-match: eviction may have dropped `shared`
                if running:
                    return "wait"
                if self.pool.preempt() is None:
                    deliver(req, RuntimeError(
                        f"KV pool ({self.pool.num_blocks - 1} blocks of "
                        f"{self.pool.block_size}) cannot hold a "
                        f"{n}-token sequence"
                    ))
                    return "failed"
        if not self.chunked_prefill:
            return self._prefill_whole(req, seq_id, tokens, shared, keys,
                                       running, deliver)
        act = _Active(seq_id, req)
        act.tokens = tokens
        # shared leading blocks need no recompute, but the prompt's LAST
        # token always runs to produce the next-token logits
        shared_tokens = len(shared) * self.pool.block_size
        act.n_filled = min(shared_tokens, n - 1)
        act.n_diverted = shared_tokens
        act.wait_writer = writer
        act.prefix_keys = keys
        if self.prefix is not None:
            for key, blk in zip(keys[len(shared):],
                                state.block_ids[len(shared):len(keys)]):
                self._inflight_prefix.setdefault(key, (act, blk))
        running.append(act)
        return "admitted"

    def _prefill_whole(self, req: _Request, seq_id: int, tokens, shared,
                       keys, running, deliver) -> str:
        """Whole-bucket admission (``chunked_prefill=False``): ONE dense
        prefill of the prompt padded to its bucket (the flash kernel on
        the card for buckets >= 256), its K/V scattered into the
        sequence's blocks, and the greedy first token emitted.  The
        prefix-shared leading blocks already hold the right K/V: their
        scatter goes to the null block instead of rewriting them (a live
        sequence may be reading them, and a rewrite from another bucket
        need not be bit-identical)."""
        n = len(tokens)
        seq = self.pool.sequence(seq_id)
        try:
            bucket = next(b for b in self.seq_buckets if b >= n)
            buf = np.zeros((1, bucket), np.int64)
            buf[0, :n] = tokens
            scatter_bt = np.zeros((1, bucket // self.pool.block_size),
                                  np.int32)
            scatter_bt[0, : len(seq.block_ids)] = seq.block_ids
            scatter_bt[0, : len(shared)] = 0
            logits, _, _ = paged_prefill(
                self.params, self.cfg, self._dev(buf),
                self._dev(np.array([n], np.int64)), self.pool.k,
                self.pool.v, self._dev(scatter_bt),
            )
            first = int(greedy(logits)[0])
            self.rounds["prefill"] += 1
            if self.prefix is not None:
                # insert() keeps only the full-block keys: the partial
                # tail block (the decode-write target) is never shared
                self.prefix.insert(keys, seq.block_ids)
        except BaseException:
            # not yet in `running`: the loop's failure cleanup cannot see
            # this sequence, so free its blocks here
            self.pool.free_sequence(seq_id)
            raise
        req.emitted.append(first)
        if self._is_done(req, seq_id):
            self.pool.free_sequence(seq_id)
            deliver(req)
            return "done"
        running.append(_Active(seq_id, req))
        return "admitted"

    # -- stepping ----------------------------------------------------------
    def _step_round(self, running, pending, deliver, poll, stop) -> None:
        """One engine round: the chained decode loop when the queue is
        quiet, else ONE ragged mixed step (when any chunk is in flight)
        or one plain decode step."""
        if self._can_chain(running, pending):
            if self._chained_rounds(running, pending, deliver, poll, stop):
                return
            if not running:
                return  # every row was preempted into pending
        victims: list[_Active] = []
        reserved = self._reserve_slots(running, pending, victims)
        if victims:
            self._cascade_preempt(victims, running, pending)
        # chunk membership is decided AFTER reservation, which may have
        # preempted a mid-prefill sequence
        chunks = [a for a in running if a.tokens is not None]
        if chunks:
            self._mixed_round(reserved, chunks, running, deliver)
        elif reserved:
            self._decode_round(reserved, running, deliver)

    def _can_chain(self, running, pending) -> bool:
        """Chain only when the queue is QUIET: nothing pending, no
        mid-prefill rows, and some row with >= 2 tokens of budget."""
        if self.chain_steps <= 1 or pending or not running:
            return False
        if any(a.tokens is not None for a in running):
            return False
        return self._chain_headroom(running) >= 2

    def _chain_headroom(self, running) -> int:
        return max(
            min(a.req.max_new - len(a.req.emitted),
                self.max_seq_tokens - self.pool.sequence(a.seq_id).n_tokens)
            for a in running
        )

    def _dispatch_chain(self, running, pending):
        """Pre-extend every decode row's table by its chain budget and
        dispatch ONE K-step chain.  Returns ``(acts, kreal, ids)`` with
        ``ids`` the un-synced [B, K] device tensor, or None when nothing
        could be reserved."""
        K = self.chain_steps
        pool = self.pool

        def k_for(act):
            seq = pool.sequence(act.seq_id)
            rem = min(act.req.max_new - len(act.req.emitted),
                      self.max_seq_tokens - seq.n_tokens)
            # short-budget rows still ride the chain: surplus steps write
            # the null block and their ids are truncated host-side
            return min(K, max(rem, 1))

        victims: list[_Active] = []
        reserved = self._reserve_slots(running, pending, victims, k_for=k_for)
        if victims:
            self._cascade_preempt(victims, running, pending)
        if not reserved:
            return None
        B = self.max_batch_size
        NB = self.max_blocks_per_seq
        token = np.zeros(B, np.int64)
        positions = np.zeros(B, np.int64)
        sb = np.zeros((B, K), np.int32)
        so = np.zeros((B, K), np.int32)
        bt = np.zeros((B, NB), np.int32)
        acts, kreal = [], []
        for i, (act, slots) in enumerate(reserved):
            seq = pool.sequence(act.seq_id)
            token[i] = act.req.emitted[-1]
            # extend_slots already advanced n_tokens by len(slots)
            positions[i] = seq.n_tokens - len(slots)
            for t, (blk, off) in enumerate(slots):
                sb[i, t] = blk
                so[i, t] = off
            bt[i, : len(seq.block_ids)] = seq.block_ids
            acts.append(act)
            kreal.append(len(slots))
        ids, _, _ = paged_chained_decode(
            self.params, self.cfg, pool.k, pool.v, self._dev(token),
            self._dev(positions), self._dev(bt), self._dev(sb),
            self._dev(so),
        )
        self.rounds["chain"] += 1
        return acts, kreal, ids

    def _scan_chain(self, acts, kreal, ids_np, running) -> list[_Active]:
        """Truncating emit of one synced chain: each row's ids in order
        until EOS / max_new / capacity closes it (the per-step done rule,
        token by token).  Returns the finished rows."""
        done = []
        for i, act in enumerate(acts):
            if not any(a is act for a in running):
                continue  # preempted after dispatch; results are void
            req = act.req
            finished = False
            for t in range(kreal[i]):
                req.emitted.append(int(ids_np[i, t]))
                if len(req.emitted) >= req.max_new or (
                        req.stop_token is not None
                        and req.emitted[-1] == req.stop_token):
                    finished = True
                    break
            if finished or self.pool.sequence(
                    act.seq_id).n_tokens >= self.max_seq_tokens:
                done.append(act)
        return done

    def _chained_rounds(self, running, pending, deliver, poll, stop) -> bool:
        """Chains back to back: each iteration dispatches chain N+1 (its
        input is chain N's last emitted id) BEFORE delivering chain N's
        finished requests, and returns to the per-step path as soon as an
        arrival, a preemption or a lack of headroom disturbs the quiet
        window."""
        inflight = self._dispatch_chain(running, pending)
        if inflight is None:
            return False
        while True:
            self._admit_arrivals(running, pending, poll, stop)
            acts, kreal, ids_dev = inflight
            ids_np = ids_dev.cpu().numpy()  # ONE sync per K-token chain
            done = self._scan_chain(acts, kreal, ids_np, running)
            for act in done:
                running.remove(act)
                self.pool.free_sequence(act.seq_id)
            nxt = None
            if running and not pending and self._chain_headroom(running) >= 2:
                try:
                    nxt = self._dispatch_chain(running, pending)
                except BaseException:
                    for act in done:  # finished rows left `running` already
                        deliver(act.req)
                    raise
            for act in done:
                deliver(act.req)
            if nxt is None:
                return True
            inflight = nxt

    def _decode_round(self, reserved, running, deliver) -> None:
        B = self.max_batch_size
        NB = self.max_blocks_per_seq
        token = np.zeros(B, np.int64)
        positions = np.zeros(B, np.int64)
        sb = np.zeros(B, np.int32)
        so = np.zeros(B, np.int32)
        bt = np.zeros((B, NB), np.int32)
        for i, (act, slots) in enumerate(reserved):
            seq = self.pool.sequence(act.seq_id)
            token[i] = act.req.emitted[-1]
            positions[i] = seq.n_tokens - 1  # append_slot already advanced
            sb[i], so[i] = slots[0]
            bt[i, : len(seq.block_ids)] = seq.block_ids
        logits, _, _ = paged_decode_step(
            self.params, self.cfg, self.pool.k, self.pool.v,
            self._dev(token), self._dev(positions), self._dev(bt),
            self._dev(sb), self._dev(so),
        )
        ids = greedy(logits).cpu().numpy()
        self.rounds["decode"] += 1
        for i, (act, _slot) in enumerate(reserved):
            act.req.emitted.append(int(ids[i]))
            if self._is_done(act.req, act.seq_id):
                self._finish(act, running, deliver)

    def _mixed_round(self, reserved, chunks, running, deliver) -> None:
        """The ragged fused step over a token-PACKED stream: decode rows
        one token each, chunk rows a run of prompt tokens, sharing the
        ``mixed_tokens`` budget."""
        B = self.max_batch_size
        C = self.prefill_chunk
        T = self.mixed_tokens
        NB = self.max_blocks_per_seq
        bs = self.pool.block_size
        tokens = np.zeros(T, np.int64)
        positions = np.zeros(T, np.int64)
        sb = np.zeros(T, np.int64)
        so = np.zeros(T, np.int64)
        row_tables = np.zeros((B, NB), np.int32)
        row_start = np.zeros(B, np.int32)
        row_nvalid = np.ones(B, np.int32)
        row_token_idx = np.zeros((B, C), np.int64)
        tok_row = np.zeros(T, np.int64)
        tok_col = np.zeros(T, np.int64)
        logit_idx = np.zeros(B, np.int64)
        rows: list[tuple[_Active, int, int]] = []  # (act, row, filled|-1)
        t = 0
        row = 0
        for act, slots in reserved:
            seq = self.pool.sequence(act.seq_id)
            tokens[t] = act.req.emitted[-1]
            positions[t] = seq.n_tokens - 1  # append_slot already advanced
            sb[t], so[t] = slots[0]
            row_tables[row, : len(seq.block_ids)] = seq.block_ids
            row_start[row] = positions[t]
            row_token_idx[row, :] = t  # one valid column
            tok_row[t] = row
            logit_idx[row] = t
            rows.append((act, row, -1))
            t += 1
            row += 1
        proj: dict[int, int] = {}  # this round's projected n_filled
        for act in chunks:
            budget = T - t
            if budget <= 0 or row >= B:
                break  # later chunks wait a round (FIFO)
            seq = self.pool.sequence(act.seq_id)
            s = act.n_filled
            e = min(s + C, len(act.tokens), s + budget)
            w = act.wait_writer
            if w is not None:
                if w.tokens is None:
                    act.wait_writer = None  # the writer finished
                else:
                    # our queries up to e read the shared region below
                    # min(e, n_diverted); the writer must have written it
                    # by THIS dispatch (same-round writes land first)
                    wp = proj.get(id(w), w.n_filled)
                    if min(e, act.n_diverted) > wp:
                        e = min(e, wp)
                    if e <= s:
                        continue  # the writer lags: wait a round
            nv = e - s
            pos = np.arange(s, e)
            tokens[t:t + nv] = act.tokens[s:e]
            positions[t:t + nv] = pos
            blocks = np.asarray(seq.block_ids, np.int64)
            # prefix-shared blocks already hold the right K/V: divert
            # their writes to the null block (a live sequence may be
            # reading them); the gather still reads them via the table
            sb[t:t + nv] = np.where(pos < act.n_diverted, 0,
                                    blocks[pos // bs])
            so[t:t + nv] = pos % bs
            row_tables[row, : len(seq.block_ids)] = seq.block_ids
            row_start[row] = s
            row_nvalid[row] = nv
            run = np.arange(t, t + nv)
            row_token_idx[row, :nv] = run
            row_token_idx[row, nv:] = t + nv - 1  # pad columns: masked
            tok_row[run] = row
            tok_col[run] = np.arange(nv)
            logit_idx[row] = t + nv - 1
            rows.append((act, row, e))
            proj[id(act)] = e
            t += nv
            row += 1
        if not rows:
            raise RuntimeError(
                "ragged step produced no rows (gated chunk cycle?)"
            )
        d = self._dev
        logits, _, _ = paged_mixed_step(
            self.params, self.cfg, self.pool.k, self.pool.v, d(tokens),
            d(positions), d(row_tables), d(row_start), d(row_nvalid),
            d(row_token_idx), d(tok_row), d(tok_col), d(sb), d(so),
            d(logit_idx),
        )
        ids = greedy(logits).cpu().numpy()
        self.rounds["mixed"] += 1
        for act, row, filled in rows:
            if filled >= 0:
                act.n_filled = filled
                if filled < len(act.tokens):
                    continue  # mid-prefill: this row's logits are garbage
                # prefill complete: register the prompt's full blocks for
                # sharing now that their K/V is written
                if self.prefix is not None and act.prefix_keys:
                    self.prefix.insert(
                        act.prefix_keys,
                        self.pool.sequence(act.seq_id).block_ids,
                    )
                self._drop_inflight_keys(act)
                act.tokens = None
                act.prefix_keys = None
            act.req.emitted.append(int(ids[row]))
            if self._is_done(act.req, act.seq_id):
                self._finish(act, running, deliver)

    def _drop_inflight_keys(self, act: _Active) -> None:
        if self._inflight_prefix:
            self._inflight_prefix = {
                k: v for k, v in self._inflight_prefix.items()
                if v[0] is not act
            }

    def _cascade_preempt(self, victims, running, pending) -> None:
        """A preempted mid-prefill writer strands every sharer whose
        shared region it had not finished writing: requeue those for
        recompute too (transitively)."""
        queue = list(victims)
        while queue:
            w = queue.pop()
            self._drop_inflight_keys(w)
            for act in list(running):
                if act.wait_writer is not w:
                    continue
                if w.tokens is None or w.n_filled >= act.n_diverted \
                        or act.tokens is None:
                    act.wait_writer = None  # region fully written
                else:
                    running.remove(act)
                    self.pool.free_sequence(act.seq_id)
                    self._requeue(pending, act.req)
                    queue.append(act)

    def _reserve_slots(self, running, pending, victims=None, k_for=None
                       ) -> list[tuple[_Active, list[tuple[int, int]]]]:
        """Reserve write slots per running DECODE sequence, resolving pool
        exhaustion by prefix eviction first, preemption second (victims
        come only from rows not yet reserved this round).  ``k_for(act)``
        gives each row's slot count (default 1), reserved atomically."""
        reserved: list[tuple[_Active, list[tuple[int, int]]]] = []
        survivors = list(running)
        idx = 0
        while idx < len(survivors):
            act = survivors[idx]
            if act.tokens is not None:
                idx += 1  # mid-prefill: no decode slot this round
                continue
            try:
                slots = self.pool.extend_slots(
                    act.seq_id, k_for(act) if k_for is not None else 1
                )
            except PoolExhausted as exc:
                if self.prefix is not None and self.prefix.evict(
                        max(exc.needed - exc.free, 1)) > 0:
                    continue
                # a sequence whose re-admission would have to truncate
                # (breaking token identity) is preempt-immune
                bucket_cap = self.seq_buckets[-1]
                exclude = {a.seq_id for a, _ in reserved} | {
                    a.seq_id for a in survivors
                    if self._readmit_len(a.req) > bucket_cap
                }
                victim = self.pool.preempt(exclude=exclude)
                if victim is None:
                    raise RuntimeError(
                        "KV pool exhausted with nothing left to preempt; "
                        "increase num_blocks"
                    )
                vact = next(
                    (a for a in survivors if a.seq_id == victim.seq_id), None
                )
                if vact is None:
                    continue  # a stray registered through direct pool use
                survivors.remove(vact)
                running.remove(vact)
                if victims is not None:
                    victims.append(vact)
                # recompute re-admission over prompt + emitted
                self._requeue(pending, vact.req)
                continue
            reserved.append((act, slots))
            idx += 1
        return reserved
