"""Faults planted in the program underneath a decoder cell's run, and the
reading of them at a cell's own size on the card.

- ``token``: every token after a request's first is altered where the
  engine emits it (the next id of the vocabulary).
- ``kv``: attention reads one K/V block of each row from the row after it
  (the first block after the shared prefix, in every layer, in the mixed
  and the decode rounds): K/V read from the wrong slot.

On the card, at the cell's size and weights::

    python -m benchmark.tests.faults --workload gpt2xl.long_decode \\
        --fault kv --seeds 1,2,3 --seconds 30

prints one JSON line a seed with the cell's readings, as ``run.py
--readings`` does.
"""

from __future__ import annotations

import argparse
import contextlib
import sys

import torch


@contextlib.contextmanager
def altered_token(vocab: int):
    from pathway_tpu_torch.kvcache import engine as eng

    emit = eng.PagedDecodeEngine._emit

    def altered(self, req, token_id):
        if req.emitted:  # every token after the first
            token_id = (int(token_id) + 1) % vocab
        return emit(self, req, token_id)

    eng.PagedDecodeEngine._emit = altered
    try:
        yield
    finally:
        eng.PagedDecodeEngine._emit = emit


def foreign_block(tables, column: int):
    """``tables`` (B, NB) with each row's ``column`` taken from the next
    row's (the last row's from the first)."""
    bt = torch.as_tensor(tables)
    if bt.dim() != 2 or bt.shape[0] < 2 or bt.shape[1] <= column:
        return tables
    bt = bt.clone()
    bt[:, column] = bt[:, column].roll(-1)
    return bt


@contextlib.contextmanager
def foreign_kv_block(column):
    """``column()`` names the block column that each row reads from the
    next row's, asked at each call."""
    from pathway_tpu_torch.kvcache import paged_attention as pa

    mixed, append = pa.paged_attention_fn, pa.append_attend_fn

    def mixed_fault(C, block_tables, *a, **kw):
        return mixed(C, foreign_block(block_tables, column()), *a, **kw)

    def append_fault(block_tables, *a, **kw):
        return append(foreign_block(block_tables, column()), *a, **kw)

    pa.paged_attention_fn, pa.append_attend_fn = mixed_fault, append_fault
    try:
        yield
    finally:
        pa.paged_attention_fn, pa.append_attend_fn = mixed, append


def planted(fault: str, cell):
    """The context manager of ``fault`` under a decoder ``cell``'s run
    (entered before its set-up)."""
    if fault == "token":
        return altered_token(int(cell.cfg["vocab_size"]))
    if fault == "kv":
        shared = int(cell.mix["shared_prefix_tokens"])
        return foreign_kv_block(
            lambda: -(-shared // cell.engine.pool.block_size))
    raise ValueError(f"unknown fault {fault!r}")


def main(argv=None) -> int:
    from benchmark import run

    p = argparse.ArgumentParser(description="read a planted fault")
    p.add_argument("--workload", required=True)
    p.add_argument("--fault", required=True, choices=("token", "kv"))
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    args = p.parse_args(argv)
    spec = run.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no result: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    ns = argparse.Namespace(readings=args.seeds, control=0,
                            seconds=args.seconds)
    print(f"[fault] {args.fault}", file=sys.stderr)
    run.readings_mode(ns, spec, device,
                      fault=lambda cell: planted(args.fault, cell))
    return 0


if __name__ == "__main__":
    sys.exit(main())
