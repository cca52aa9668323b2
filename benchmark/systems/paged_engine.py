"""A GPT-2-family configuration served by the port's paged engine:
``RequestScheduler`` -> ``PagedDecodeEngine.serve_batch``, greedy.

A mix is an open loop (``"loop": "open"``: Poisson arrivals at a fixed
rate, one caller thread a request in flight) or a closed loop
(``"loop": "closed"``: ``clients`` callers that each send their next
request when the last one is answered; the first batch holds every
client's first request, and the window opens once each has its first
token).  Each request carries an
``on_token`` callback that stamps each token's arrival.

The check: a sample of the finished requests, drawn from the seed and
holding the longest, is run through the float32 reference (prompt plus
served tokens).  Each served token's gap is how far its reference logit
lies below the reference's best at its position; the readings are the
widest gap, the mean gap, the mean squared gap and the share of tokens
that are not the reference's first.  The control is the program's own
lower precision: the engine with ``quantize="int8"`` (int8 weights).
"""

from __future__ import annotations

import dataclasses
import gc
import math
import sys
import threading
import time
import types

import numpy as np
import torch

from ..harness import traffic, weights
from ..harness.load import closed_loop, join_all, open_window
from ..reference import gpt2 as ref_gpt2

KV_COUNTERS = ("mixed_steps", "mixed_step_rows", "chain_slots",
               "chain_emitted", "prefix_hits", "prefix_misses",
               "preemptions")


@dataclasses.dataclass
class Request:
    prompt: np.ndarray
    n_new: int
    due: float = math.nan          # perf_counter time it was due
    sent: float = math.nan
    tokens: list = dataclasses.field(default_factory=list)
    stamps: list = dataclasses.field(default_factory=list)
    error: str | None = None


def port_params(w: dict, cfg: dict) -> dict:
    """The benchmark's GPT-2 tensors in the port's decoder layout (views,
    no copies): what a user converting a GPT-2 checkpoint hands the
    engine."""
    D = cfg["n_embd"]
    layers = []
    for i in range(cfg["n_layer"]):
        p = f"h.{i}."
        qkv, b = w[p + "attn.c_attn.weight"], w[p + "attn.c_attn.bias"]
        layers.append({
            "wq": qkv[:, :D], "wk": qkv[:, D:2 * D], "wv": qkv[:, 2 * D:],
            "bq": b[:D], "bk": b[D:2 * D], "bv": b[2 * D:],
            "wo": w[p + "attn.c_proj.weight"], "bo": w[p + "attn.c_proj.bias"],
            "w_up": w[p + "mlp.c_fc.weight"], "b_up": w[p + "mlp.c_fc.bias"],
            "w_down": w[p + "mlp.c_proj.weight"],
            "b_down": w[p + "mlp.c_proj.bias"],
            "ln1_scale": w[p + "ln_1.weight"], "ln1_bias": w[p + "ln_1.bias"],
            "ln2_scale": w[p + "ln_2.weight"], "ln2_bias": w[p + "ln_2.bias"],
        })
    return {"embed": w["wte.weight"], "pos_embed": w["wpe.weight"],
            "ln_f_scale": w["ln_f.weight"], "ln_f_bias": w["ln_f.bias"],
            "layers": layers}


def decoder_config(cfg: dict, dtype):
    """The port's ``DecoderConfig`` from the published GPT-2 config, by the
    port's own converter."""
    from pathway_tpu_torch.models.hf_import import config_from_gpt2

    hf = types.SimpleNamespace(**{k: v for k, v in cfg.items()
                                  if isinstance(v, (int, float, str))
                                  or v is None})
    return dataclasses.replace(config_from_gpt2(hf), dtype=dtype)


class Cell:
    # the control is the program on its int8 weight path: it runs the
    # window like the program
    control_runs_program = True

    def __init__(self, config: dict, mix: dict, seed: int, device,
                 control: bool = False):
        self.cfg = config
        self.mix = mix
        self.seed = int(seed)
        self.device = torch.device(device)
        self.control = control
        self.engine = self.scheduler = None
        self.detail: dict = {}

    # -- set-up -----------------------------------------------------------------
    def setup(self) -> None:
        from pathway_tpu_torch.kvcache.engine import PagedDecodeEngine

        t0 = time.perf_counter()
        dtype = getattr(torch, self.cfg["torch_dtype"])
        self.weights = weights.gpt2_weights(self.cfg, self.seed, self.device,
                                            dtype)
        t1 = time.perf_counter()
        eng = self.mix["engine"]
        self.engine = PagedDecodeEngine(
            decoder_config(self.cfg, dtype),
            port_params(self.weights, self.cfg),
            max_batch_size=eng["max_batch_size"],
            prefill_chunk=eng["prefill_chunk"], stop_token=None,
            device=self.device, name="bench",
            quantize="int8" if self.control else None)
        self.scheduler = self._scheduler(start=True)
        t2 = time.perf_counter()
        print(f"[setup] engine auto_config {self.engine.auto_config}; "
              f"mixed_tokens {self.engine.mixed_tokens}", file=sys.stderr)
        self._warm_up()
        print(f"[setup] weights {t1 - t0:.3f} s, engine {t2 - t1:.3f} s, "
              f"warm-up {time.perf_counter() - t2:.3f} s", file=sys.stderr)

    def _scheduler(self, start: bool):
        from pathway_tpu_torch.serve.scheduler import RequestScheduler

        sched = self.mix["scheduler"]
        return RequestScheduler(
            lambda reqs: self.engine.serve_batch(reqs, self.scheduler),
            name="bench", max_batch_size=self.engine.max_batch_size,
            batch_linger_ms=sched["batch_linger_ms"],
            max_queue=sched["max_queue"],
            default_timeout_s=sched["timeout_s"], start=start)

    def _warm_up(self) -> None:
        """Every step program, before the window (their shapes are fixed
        by the engine's sizes, whatever the rows hold): two of the mix's
        prompts (another seed's ids) with outputs long enough to reach
        chained decode, then two with two tokens each, whose second token
        is a plain decode round (a chain needs two tokens of headroom)."""
        n = 2
        gen = traffic.generation_requests(self.mix, self.cfg["vocab_size"],
                                          self.seed + 1, n)
        k = 2 * self.engine.chain_steps + 2
        done = 0
        for n_new in (k, 2):
            reqs = [Request(p, int(min(n_new, o)))
                    for p, o in zip(gen["prompts"], gen["outputs"])]
            threads = [threading.Thread(target=self._send, args=(r,))
                       for r in reqs]
            for t in threads:
                t.start()
            join_all(threads, time.perf_counter() + 600)
            done += sum(r.error is None for r in reqs)
        seen = {name: bool(getattr(self.engine, "_" + name)._seen)
                for name in ("mixed", "step", "chained")}
        print(f"[setup] warm-up: {done}/{2 * n} answered; programs warmed "
              f"{seen}", file=sys.stderr)

    def _send(self, r: Request) -> None:
        def on_token(tok):
            r.stamps.append(time.perf_counter())
            r.tokens.append(int(tok))

        r.sent = time.perf_counter()
        try:
            self.scheduler.submit(
                (r.prompt.tolist(), r.n_new, 1, {"on_token": on_token}))
        except Exception as exc:  # noqa: BLE001 - a failed request is counted
            r.error = f"{type(exc).__name__}: {exc}"

    def _counters(self) -> dict:
        kv = self.engine.pool.kv_stats
        return {k: getattr(kv, k) for k in KV_COUNTERS}

    # -- the window -------------------------------------------------------------
    def run_window(self, seconds: float, on_open, on_close) -> dict:
        if self.mix["loop"] == "open":
            return self._open(seconds, on_open, on_close)
        return self._closed(seconds, on_open, on_close)

    def _requests(self, n: int) -> tuple[list[Request], np.ndarray | None]:
        gen = traffic.generation_requests(self.mix, self.cfg["vocab_size"],
                                          self.seed, n)
        reqs = [Request(p, int(o)) for p, o in zip(gen["prompts"],
                                                   gen["outputs"])]
        return reqs, gen["gaps"]

    def _open(self, seconds, on_open, on_close) -> dict:
        ramp = float(self.mix["ramp_s"])
        n = int(float(self.mix["rate_per_s"]) * (ramp + seconds) * 1.3) + 32
        reqs, gaps = self._requests(n)
        counters = []

        def opened():
            counters.append(self._counters())
            on_open()

        def closed():
            on_close()
            counters.append(self._counters())

        t_open, t_close, ended = open_window(
            gaps, ramp, seconds, int(self.mix["callers"]),
            lambda i: self._send(reqs[i]), opened, closed, reqs)
        return self._result(reqs, t_open, t_close, *counters, ended)

    def _closed(self, seconds, on_open, on_close) -> dict:
        clients = int(self.mix["clients"])
        per = requests_per_client(self.mix, seconds)
        reqs, _ = self._requests(clients * per)
        jobs = [list(range(c, clients * per, clients)) for c in range(clients)]
        # every client's first request is queued before the worker starts,
        # so the first batch holds them all in every run
        self.scheduler.shutdown(drain=True)
        self.scheduler = self._scheduler(start=False)
        stop = threading.Event()
        threads, ran_out = closed_loop(jobs, lambda i: self._send(reqs[i]),
                                       stop)
        limit = time.perf_counter() + 60
        while (self.scheduler.queue_depth < clients
               and time.perf_counter() < limit):
            time.sleep(0.001)
        self.scheduler.start()
        firsts = [reqs[j[0]] for j in jobs]
        limit = time.perf_counter() + float(self.mix["ramp_timeout_s"])
        while (time.perf_counter() < limit
               and not all(r.stamps for r in firsts)):
            time.sleep(0.01)
        c0, t_open = self._counters(), time.perf_counter()
        on_open()
        time.sleep(max(0.0, t_open + seconds - time.perf_counter()))
        t_close = time.perf_counter()
        on_close()
        c1 = self._counters()
        stop.set()
        ended = join_all(threads, time.perf_counter() + 120)
        # a client that ran out of work before the close left its slot
        # idle: the window no longer offered the mix's load
        starved = sum(1 for t in ran_out if t < t_close)
        print(f"[load] {per} requests a client; {starved} of {clients} "
              f"clients ran out of work before the window closed",
              file=sys.stderr)
        for r in reqs:
            r.due = r.sent
        return self._result(reqs, t_open, t_close, c0, c1,
                            ended and starved == 0)

    @staticmethod
    def _result(reqs, t_open, t_close, c0, c1, ended) -> dict:
        return {"requests": reqs, "t_open": t_open, "t_close": t_close,
                "counters": (c0, c1), "ended": ended}

    def stop_program(self) -> None:
        """Stop the scheduler's worker and free the program's state."""
        if self.scheduler is not None:
            self.scheduler.shutdown(drain=False, timeout_s=30)
        self.engine = self.scheduler = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ---------------------------------------------------------------
    def sample(self, result: dict) -> list[Request]:
        """The requests the check reads: those due in the window that were
        answered, the longest of them and others drawn from the seed."""
        pool = [r for r in result["requests"]
                if result["t_open"] <= r.due < result["t_close"]
                and r.error is None and len(r.tokens) == r.n_new]
        n = int(self.mix["check"]["requests"])
        if not pool:
            return []
        longest = max(range(len(pool)),
                      key=lambda i: len(pool[i].prompt) + pool[i].n_new)
        rng = np.random.default_rng(self.seed % (1 << 63) + 7)
        rest = [i for i in rng.permutation(len(pool)) if i != longest]
        return [pool[i] for i in [longest] + rest[: n - 1]]

    def check(self, result: dict) -> list[tuple[str, float, str]]:
        """(number, reading, what it is) of the comparison with the
        reference.  Runs after :meth:`stop_program`."""
        sample = self.sample(result)
        if not sample:
            return [(n, math.inf, "no request answered") for n in READINGS]
        gaps = ref_gpt2.greedy_gaps(
            self.weights, self.cfg, [r.prompt for r in sample],
            [r.tokens for r in sample])
        self.detail = {"gaps": [g.tolist() for g in gaps]}
        what = f"{sum(g.numel() for g in gaps)} tokens of {len(sample)} requests"
        return [(n, v, what) for n, v in gap_readings(gaps).items()]


READINGS = ("logit_gap", "logit_gap_mean", "logit_gap_sq_mean",
            "argmax_missed")


def gap_readings(gaps: list) -> dict:
    """The readings of the served tokens' gaps below the reference's
    best: the widest, the mean, the mean square, and the share of tokens
    that are not the reference's first."""
    g = torch.cat([torch.as_tensor(x, dtype=torch.float64) for x in gaps])
    return {"logit_gap": float(g.max()), "logit_gap_mean": float(g.mean()),
            "logit_gap_sq_mean": float((g * g).mean()),
            "argmax_missed": float((g > 0).double().mean())}


def requests_per_client(mix: dict, seconds: float) -> int:
    """Enough requests a client that none runs out inside the window even
    at ``supply_tokens_per_s`` (a rate well above what the card can do),
    each request counted at the mix's shortest output."""
    tokens = float(mix["supply_tokens_per_s"]) * float(seconds)
    per_client = tokens / (int(mix["clients"])
                           * int(mix["output_tokens"]["min"]))
    return int(math.ceil(per_client)) + 1
