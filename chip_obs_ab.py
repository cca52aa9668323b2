#!/usr/bin/env python3
"""Phase 4's bf16 batched generation on one card, for an A/B of two
checkouts of the port: tokens/s of 8 prompts × 32 new tokens through the
paged engine at ``chip_smoke.py``'s GPT-2-small width and engine sizes,
and the host synchronise calls (``cudaStreamSynchronize``,
``cudaDeviceSynchronize``, ``cudaEventSynchronize``) torch.profiler
counts in one such run.  The profiled run is made twice with host and
device tracing and twice with the device alone (``greedy_twice``): each
gives its device events, by kind, and the hand-written kernels'
launches counted by their wrappers (``ops/_cuda.LAUNCHES``), so two
identical runs show whether the profiler's count is stable.

    python3 chip_obs_ab.py --root DIR [--reps 5] [--seed 0]

imports ``pathway_tpu_torch`` from ``DIR`` (a checkout, or an unpacked
``git archive`` of another commit), so two commits run the same
measurement; run them in turns in one call (parent, change, change,
parent) and compare only within it.  The prompts are random token ids of
phase 4's lengths (100 to 600), the weights random from ``--seed``.
Prints the card's name and power limit, then one JSON line; exits
non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

GPT2_SMALL = dict(vocab_size=50257, d_model=768, n_layers=12, n_heads=12,
                  d_ff=3072, max_len=1024, act="gelu_tanh", ln_eps=1e-5)
ENGINE_SIZES = dict(num_blocks=512, block_size=16, max_batch_size=8,
                    chain_steps=8, max_restarts=0)
N_PROMPTS, NEW_TOKENS = 8, 32
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True,
                    help="directory holding the pathway_tpu_torch to run")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import numpy as np
    import torch

    import pathway_tpu_torch

    if not pathway_tpu_torch.__file__.startswith(root + os.sep):
        raise RuntimeError(f"imported {pathway_tpu_torch.__file__}, "
                           f"not the package under {root}")
    if not torch.cuda.is_available():
        print("chip_obs_ab: torch.cuda.is_available() is False; no result",
              file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from pathway_tpu_torch.kvcache.engine import PagedDecodeEngine
    from pathway_tpu_torch.models import decoder as dec
    from pathway_tpu_torch.ops import _cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda.build_all()
    cfg32 = dec.DecoderConfig(**GPT2_SMALL, dtype=torch.float32)
    params = dec.TorchDecoderLM(cfg32, seed=args.seed, device="cuda").params
    eng = PagedDecodeEngine(dec.DecoderConfig(**GPT2_SMALL), params,
                            device="cuda", **ENGINE_SIZES)
    rng = np.random.default_rng(args.seed)
    reqs = [([int(t) for t in rng.integers(4, cfg32.vocab_size, n)],
             NEW_TOKENS)
            for n in np.linspace(100, 600, N_PROMPTS).astype(int)]

    def run():
        eng.prefix.clear()  # every run starts with an empty prefix cache
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.generate_batch(reqs)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    toks, _ = run()  # first calls: the build of every program shape
    rates = []
    for _ in range(args.reps):
        out, wall = run()
        if out != toks:
            raise AssertionError("tokens changed between runs")
        rates.append(sum(len(t) for t in out) / wall)
    def profiled(activities):
        """One run under torch.profiler: its host syncs, its device
        events (all, and by kind), and the hand-written kernels'
        launches counted by their wrappers."""
        eng.prefix.clear()
        _cuda.reset_launches()
        with profile(activities=activities) as prof:
            out = eng.generate_batch(reqs)
            torch.cuda.synchronize()
        if out != toks:
            raise AssertionError("tokens changed under the profiler")
        syncs = {name: 0 for name in SYNC_CALLS}
        kinds = {"kernel": 0, "memcpy": 0, "memset": 0, "other": 0}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                low = e.name.lower()
                kind = next((k for k in ("memcpy", "memset") if k in low),
                            "kernel" if not e.is_user_annotation else "other")
                kinds[kind] += 1
            elif e.name in syncs:
                syncs[e.name] += 1
        return dict(syncs=syncs, device_events=sum(kinds.values()),
                    by_kind=kinds, launches=dict(_cuda.LAUNCHES))

    # the same greedy run twice per profiler setting, in one process: if
    # the counts of two identical runs differ while the wrappers'
    # launches agree, the profiler dropped records
    both = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    host_dev = [profiled(both) for _ in range(2)]
    dev_only = [profiled([ProfilerActivity.CUDA]) for _ in range(2)]
    print(json.dumps({"ab": {
        "root": args.root, "card": smi, "torch": torch.__version__,
        "tokens_per_s": rates, "tokens_per_s_median": statistics.median(
            rates),
        "syncs_profiled": host_dev[0]["syncs"],
        "device_events_profiled": host_dev[0]["device_events"],
        "greedy_twice": {"host_and_device": host_dev,
                         "device_only": dev_only},
        "rounds": dict(eng.rounds), "tokens": sum(len(t) for t in toks),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
