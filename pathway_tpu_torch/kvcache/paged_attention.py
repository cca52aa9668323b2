"""Ragged paged attention: multi-query attention through a block table.

One contract, two implementations:

- :func:`paged_attention_reference` — the plain PyTorch version (gather
  + einsum + f32 softmax), mirroring ``models/decoder.decode_step``'s
  math.  CPU tensors always take it; ``chip_smoke.py`` holds the kernels
  against it on the card.
- the CUDA kernels in ``csrc/paged_attention.cu`` — ``paged_attention``
  (ragged, any C) and ``paged_append_attend`` (decode, C = 1, with the
  new token's K/V written into the pools in place).  A CUDA tensor
  always launches the kernel (or raises); nothing falls back.

Raggedness: row ``b`` carries ``C >= 1`` query tokens at consecutive
positions; column ``c`` attends to ``min(c0[b] + c, cl[b])`` tokens
(:func:`_query_context` resolves the two calling conventions).

Contract: every row attends to at least one token (``context_lens >= C``
in the consecutive form, ``start_pos >= 0`` and ``n_valid >= 1`` in the
ragged form); violations raise instead of producing 0/0 NaNs.  Idle rows
are padded to context 1 against the null block (the engine does).

Pool layout: ``(num_blocks, block_size, n_heads, head_dim)`` per layer
(one layer's slice of BlockPool's stacked tensors).
"""

from __future__ import annotations

import math

import torch

from ..obs.profiler import add_kernel_cost, counting_cost
from ..ops import _cuda

_NEG = -1e9
_SOURCE = "paged_attention.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)

#: Tokens per key split: each kernel gives every (row, head) one thread
#: block per split of the table's span (``NBT * BS`` tokens, known on the
#: host), and the row's last split to finish merges their partials inside
#: the same launch.  The ragged split is 4 of the kernel's 64-token tiles.
RAGGED_SPLIT = 256
APPEND_SPLIT = 128
#: query columns of one ragged block (and of one partial record)
_COLUMN_GROUP = 32
_SCRATCH: dict = {}


def _n_splits(block_tables, block_size: int, split: int) -> int:
    return -(-block_tables.shape[1] * block_size // split)


def _scratch(device, groups: int, n_split: int, rows: int, hd: int):
    """The cached partials and arrival counters of one launch shape on
    one stream: ``groups`` (row, head, column group) triples, each with
    ``n_split`` f32 records of ``rows * (hd + 4)`` floats (O, then m and
    l per column), and one int32 counter per triple, which starts at 0
    and which every launch leaves at 0.  The key holds the stream the
    launch goes to (the current stream of ``device``, the one
    ``_cuda.launch`` launches on): launches on one stream run one after
    another and share a shape's scratch; launches on two streams, or a
    CUDA-graph capture on a side stream, never share partials or
    counters."""
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (device, stream, groups, n_split, rows, hd)
    hit = _SCRATCH.get(key)
    if hit is None:
        hit = (torch.empty(groups * n_split * rows * (hd + 4),
                           dtype=torch.float32, device=device),
               torch.zeros(groups, dtype=torch.int32, device=device))
        _SCRATCH[key] = hit
    return hit


def _query_context(C: int, context_lens, start_pos, n_valid, device):
    """Per-row ``(c0, cl_last)`` int32: column ``c`` attends to
    ``min(c0 + c, cl_last)`` tokens.

    - consecutive form: ``context_lens`` (B,) is the LAST column's
      context (the decode case at C=1);
    - ragged form: ``start_pos``/``n_valid`` (B,) — chunk rows whose
      valid queries stop at ``n_valid`` (padding columns clamp)."""
    if context_lens is not None:
        cl_last = torch.as_tensor(context_lens, device=device).to(torch.int32)
        c0 = cl_last - (C - 1)
    else:
        sp = torch.as_tensor(start_pos, device=device).to(torch.int32)
        cl_last = sp + torch.as_tensor(n_valid, device=device).to(torch.int32)
        c0 = sp + 1
    return c0, cl_last


def _require_positive_context(C: int, context_lens, start_pos, n_valid):
    """Fail-loud ``context >= 1`` contract on HOST inputs.  A zero-length
    row is an all-masked softmax (0/0 -> NaN); idle rows must be padded
    to one null-block token instead.  Per-row arrays already on the card
    are skipped (reading them would stall the stream on every layer), as
    the JAX package skips traced values: the engine satisfies the
    contract by construction."""
    def _min(x):
        if x is None or (isinstance(x, torch.Tensor) and x.is_cuda):
            return None
        t = torch.as_tensor(x)
        return int(t.min()) if t.numel() else None

    cl = _min(context_lens)
    if cl is not None and cl < C:
        raise ValueError(
            f"paged attention requires context_lens >= n_queries ({C}); "
            f"got min {cl}. A zero-length row is an all-masked softmax "
            "(0/0 -> NaN in the reference path) — pad idle rows to "
            "context 1 against the null block instead."
        )
    nv = _min(n_valid)
    if nv is not None and nv < 1:
        raise ValueError(
            f"paged attention requires n_valid >= 1 per row; got min {nv}."
            " A zero-length row is an all-masked softmax (0/0 -> NaN in"
            " the reference path) — pad idle rows to one null-block token."
        )
    sp = _min(start_pos)
    if sp is not None and sp < 0:
        raise ValueError(
            f"paged attention requires start_pos >= 0; got min {sp}."
        )


def paged_attention_reference(q, k_pool, v_pool, block_tables,
                              context_lens=None, *, start_pos=None,
                              n_valid=None):
    """Gather-based ragged paged attention (the plain version).

    q: (B, C, H, hd); k_pool/v_pool: (num_blocks, block_size, H, hd);
    block_tables: (B, NB) int, padded with the null block;
    context_lens: (B,) — the LAST query column's context; or
    ``start_pos``/``n_valid`` (B,) for ragged rows (padding columns past
    ``n_valid`` clamp to the last valid query's context; their output is
    garbage the caller masks).  Returns (B, C, H, hd)."""
    B, C = q.shape[:2]
    _require_positive_context(C, context_lens, start_pos, n_valid)
    NB = block_tables.shape[1]
    BS, H, hd = k_pool.shape[1:]
    c0, cl_last = _query_context(C, context_lens, start_pos, n_valid,
                                 q.device)
    cols = torch.arange(C, device=q.device, dtype=torch.int32)
    ctx = torch.minimum(c0[:, None] + cols[None, :], cl_last[:, None])
    bt = torch.as_tensor(block_tables, device=q.device).long()
    k = k_pool[bt].reshape(B, NB * BS, H, hd)
    v = v_pool[bt].reshape(B, NB * BS, H, hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    pos = torch.arange(NB * BS, device=q.device)
    valid = (pos[None, None, :] < ctx[:, :, None])[:, None, :, :]
    scores = torch.where(valid, scores, torch.full_like(scores, _NEG))
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _check_kernel_inputs(q, k_pool, v_pool, block_tables):
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        _cuda.check(t, name, dtype=q.dtype, ndim=4, device=q.device)
    _cuda.check(block_tables, "block_tables", dtype=torch.int32, ndim=2,
                device=q.device)
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"paged attention kernel takes f32/bf16, got {q.dtype}")
    H, hd = q.shape[2:]
    if k_pool.shape != v_pool.shape or tuple(k_pool.shape[2:]) != (H, hd):
        raise ValueError(
            f"pool shape {tuple(k_pool.shape)} does not match q heads/dims "
            f"{(H, hd)}"
        )
    if hd not in _HEAD_DIMS:
        raise ValueError(f"paged attention kernel takes hd in {_HEAD_DIMS}, "
                         f"got {hd}")
    if block_tables.shape[0] != q.shape[0]:
        raise ValueError("block_tables rows must match the batch")
    _require_aligned(q, k_pool, v_pool)


def _require_aligned(*tensors):
    # the kernels read q and K/V rows with 16-byte vector loads
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("q and K/V operands must start on a 16-byte "
                             "boundary")


def attention_work(q, block_tables, c0, cl, append: bool
                   ) -> tuple[float, float]:
    """(operations, bytes) one launch's data needs, the roofline bound's
    count: each row reads K and V of the tokens its last valid column
    attends to, each valid column does 4 * hd operations per attended
    token per head; an append also writes one K/V row a sequence.
    Reads the contexts to the host: only a bucket's costed first call
    asks (``obs.profiler.counting_cost``)."""
    B, C, H, hd = q.shape
    es = q.element_size()
    cl_h = [int(x) for x in cl.tolist()]
    c0_h = cl_h if c0 is None else [int(x) for x in c0.tolist()]
    ctx_sum = 0
    for b in range(B):
        for c in range(min(max(cl_h[b] - c0_h[b] + 1, 0), C)):
            ctx_sum += min(c0_h[b] + c, cl_h[b])
    nbytes = (2 * q.numel() * es + 2 * sum(cl_h) * H * hd * es
              + block_tables.numel() * 4 + 2 * B * 4)
    if append:
        nbytes += 2 * B * H * hd * es
    return 4.0 * hd * H * ctx_sum, float(nbytes)


def paged_attention_cuda(q, k_pool, v_pool, block_tables, c0, cl):
    """Launch the ragged kernel: q (B, C, H, hd) CUDA, contiguous;
    c0/cl (B,) int32 per-row column-0 / last-column contexts."""
    _check_kernel_inputs(q, k_pool, v_pool, block_tables)
    B, C, H, hd = q.shape
    for name, t in (("c0", c0), ("cl", cl)):
        _cuda.check(t, name, dtype=torch.int32, ndim=1, device=q.device)
    BS = k_pool.shape[1]
    n_split = _n_splits(block_tables, BS, RAGGED_SPLIT)
    part, counters = _scratch(q.device, B * H * -(-C // _COLUMN_GROUP),
                              n_split, _COLUMN_GROUP, hd)
    out = torch.empty_like(q)
    _cuda.launch(
        _SOURCE, "pw_paged_attention", "paged_attention", q.device,
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), out.data_ptr(),
        block_tables.data_ptr(), c0.data_ptr(), cl.data_ptr(),
        part.data_ptr(), counters.data_ptr(),
        B, C, H, hd, BS, block_tables.shape[1], RAGGED_SPLIT, n_split,
        _DTYPE_CODE[q.dtype], 1.0 / math.sqrt(hd),
    )
    if counting_cost():
        add_kernel_cost(*attention_work(q, block_tables, c0, cl, False))
    return out


def paged_append_attend_cuda(q, k_new, v_new, k_pool, v_pool, block_tables,
                             cl, slot_blocks, slot_offsets):
    """Launch the fused append+attend kernel; pools are updated in place."""
    _check_kernel_inputs(q, k_pool, v_pool, block_tables)
    B, C, H, hd = q.shape
    if C != 1:
        raise ValueError(f"append+attend takes one query column, got {C}")
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        _cuda.check(t, name, dtype=q.dtype, ndim=3, device=q.device)
        if tuple(t.shape) != (B, H, hd):
            raise ValueError(f"{name} must be {(B, H, hd)}, got {tuple(t.shape)}")
    _require_aligned(k_new, v_new)
    for name, t in (("cl", cl), ("slot_blocks", slot_blocks),
                    ("slot_offsets", slot_offsets)):
        _cuda.check(t, name, dtype=torch.int32, ndim=1, device=q.device)
    BS = k_pool.shape[1]
    n_split = _n_splits(block_tables, BS, APPEND_SPLIT)
    part, counters = _scratch(q.device, B * H, n_split, 1, hd)
    out = torch.empty_like(q)
    _cuda.launch(
        _SOURCE, "pw_paged_append_attend", "paged_append_attend", q.device,
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        k_pool.data_ptr(), v_pool.data_ptr(), out.data_ptr(),
        block_tables.data_ptr(), cl.data_ptr(), slot_blocks.data_ptr(),
        slot_offsets.data_ptr(), part.data_ptr(), counters.data_ptr(),
        B, H, hd, BS, block_tables.shape[1], APPEND_SPLIT, n_split,
        _DTYPE_CODE[q.dtype], 1.0 / math.sqrt(hd),
    )
    if counting_cost():
        add_kernel_cost(*attention_work(q, block_tables, None, cl, True))
    return out


def _int32_on(x, device):
    return torch.as_tensor(x, device=device).to(torch.int32).contiguous()


def append_attend_fn(block_tables, context_lens, slot_blocks, slot_offsets,
                     device):
    """:func:`paged_append_attend` for one step's tables, prepared once
    and applied per layer: the contract check and the int32 tables are
    built here, not in each of the step's layer calls.  Returns
    ``attend(q, k_new, v_new, k_pool, v_pool) -> attn_out``, which
    updates the pools in place."""
    _require_positive_context(1, context_lens, None, None)
    device = torch.device(device)
    if device.type == "cuda":
        bt, cl, sb, so = (_int32_on(x, device) for x in (
            block_tables, context_lens, slot_blocks, slot_offsets))

        def attend(q, k_new, v_new, k_pool, v_pool):
            return paged_append_attend_cuda(
                q.contiguous(), k_new.contiguous(), v_new.contiguous(),
                k_pool, v_pool, bt, cl, sb, so)
        return attend
    sb = torch.as_tensor(slot_blocks, device=device).long()
    so = torch.as_tensor(slot_offsets, device=device).long()

    def attend_plain(q, k_new, v_new, k_pool, v_pool):
        k_pool[sb, so] = k_new
        v_pool[sb, so] = v_new
        return paged_attention_reference(q, k_pool, v_pool, block_tables,
                                         context_lens)
    return attend_plain


def paged_append_attend(q, k_new, v_new, k_pool, v_pool, block_tables,
                        context_lens, slot_blocks, slot_offsets):
    """Fused decode append+attend over ONE layer's pool slices: write the
    incoming token's K/V at ``(slot_blocks, slot_offsets)`` and attend
    through ``block_tables``.

    q: (B, 1, H, hd); k_new/v_new: (B, H, hd); pools (num_blocks, BS, H,
    hd); block_tables (B, NB); context_lens/slot_blocks/slot_offsets (B,)
    with the slot at the context tail (``slot_offsets == (context_lens -
    1) % BS`` and ``slot_blocks`` the matching table entry).  Returns
    ``(attn_out, k_pool, v_pool)``; the pools are the SAME tensors,
    updated in place (the JAX package returns new arrays).  CUDA tensors
    run the kernel; CPU tensors scatter then run the plain version."""
    attend = append_attend_fn(block_tables, context_lens, slot_blocks,
                              slot_offsets, q.device)
    return attend(q, k_new, v_new, k_pool, v_pool), k_pool, v_pool


def paged_attention_fn(C: int, block_tables, context_lens=None, *,
                       start_pos=None, n_valid=None, device):
    """:func:`paged_attention` for one step's tables and ``C`` query
    columns, prepared once and applied per layer: the contract check,
    the int32 table and the per-row ``(c0, cl)`` are built here, not in
    each of the step's layer calls.  Returns
    ``attend(q, k_pool, v_pool) -> out``."""
    device = torch.device(device)
    if device.type != "cuda":
        def attend_plain(q, k_pool, v_pool):
            return paged_attention_reference(
                q, k_pool, v_pool, block_tables, context_lens,
                start_pos=start_pos, n_valid=n_valid)
        return attend_plain
    _require_positive_context(C, context_lens, start_pos, n_valid)
    c0, cl_last = _query_context(C, context_lens, start_pos, n_valid, device)
    c0, cl_last = c0.contiguous(), cl_last.contiguous()
    bt = _int32_on(block_tables, device)

    def attend(q, k_pool, v_pool):
        return paged_attention_cuda(q.contiguous(), k_pool, v_pool, bt, c0,
                                    cl_last)
    return attend


def paged_attention(q, k_pool, v_pool, block_tables, context_lens=None, *,
                    start_pos=None, n_valid=None):
    """Ragged paged attention: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Same signature/shape/raggedness contract
    as :func:`paged_attention_reference`."""
    attend = paged_attention_fn(q.shape[1], block_tables, context_lens,
                                start_pos=start_pos, n_valid=n_valid,
                                device=q.device)
    return attend(q, k_pool, v_pool)
