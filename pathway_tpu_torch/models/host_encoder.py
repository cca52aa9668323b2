"""The single-query serving tier: one query embedded per call, at the
lowest latency the device allows.

Counterpart of ``pathway_tpu/models/host_encoder.py``
``CompiledQueryEncoder``.  The math is that class's ``_build_forward``:
bf16 weights and activations, one fused (3D, D) QKV projection, f32
softmax, masked mean-pool and L2 norm, for one query padded to a
sequence bucket.  The JAX package compiles one program per (bucket,
masked) shape; here each shape becomes one ``torch.cuda.CUDAGraph`` on
the card, captured at the shape's first use (milliseconds), so a query
is three small host-to-device copies, one graph replay and one (D,)
fetch.  On the CPU the same function runs eagerly, which is the JAX
class's ``mode="eager"``.
"""

from __future__ import annotations

import math
import threading

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device


def _np_tree(params):
    """The parameter dict as f32 numpy arrays on the host."""
    if isinstance(params, dict):
        return {k: _np_tree(v) for k, v in params.items()}
    if isinstance(params, list):
        return [_np_tree(v) for v in params]
    if isinstance(params, torch.Tensor):
        return params.detach().to("cpu", torch.float32).numpy()
    return np.asarray(params, dtype=np.float32)


class _Graph:
    """One captured (bucket, masked) forward: static inputs and output."""

    def __init__(self, fn, T: int, masked: bool, device, pool):
        self.ids = torch.zeros(T, dtype=torch.int64, device=device)
        self.amask = self.pmask = None
        if masked:
            self.amask = torch.zeros(T, dtype=torch.bfloat16, device=device)
            self.pmask = torch.ones((T, 1), dtype=torch.float32, device=device)
        args = (self.ids, self.amask, self.pmask)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):  # warm-up off the capture
            for _ in range(2):
                fn(*args)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool):
            self.out = fn(*args)


class CompiledQueryEncoder:
    """One query -> its (d_model,) f32 embedding, L2-normalised, as numpy.

    Queries are padded to the smallest bucket that holds them (longer ones
    are truncated to the largest); a query that fills its bucket runs the
    unmasked program.  On the card ``embed`` replays the shape's CUDA
    graph; a lock serialises fill -> replay -> copy-out, since serving
    threads share the graph's static buffers.  A capture that fails
    raises."""

    def __init__(self, cfg, params, tokenizer,
                 buckets=(16, 32, 48, 64, 96, 128), device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.buckets = tuple(b for b in buckets if b <= cfg.max_len) or (
            cfg.max_len,
        )
        p = _np_tree(params)
        bf16 = torch.bfloat16

        def t(a):
            return torch.from_numpy(
                np.array(a, dtype=np.float32, copy=True)
            ).to(bf16).to(self.device)

        self._emb = t(p["embed"])
        self._pos = t(p["pos_embed"])
        self._fp = {
            k: t(v) for k, v in p.items()
            if k not in ("embed", "pos_embed", "layers")
        }
        self._layers = []
        for L in p["layers"]:
            # F.linear wants (out, in): transpose the x @ w layout
            bqkv = None
            if L.get("bq") is not None:
                bqkv = t(np.concatenate([L["bq"], L["bk"], L["bv"]]))
            self._layers.append({
                "qkv": t(np.concatenate([L["wq"], L["wk"], L["wv"]],
                                        axis=1).T),
                "qkv_b": bqkv,
                "o": t(L["wo"].T),
                "o_b": t(L["bo"]) if L.get("bo") is not None else None,
                "up": t(L["w_up"].T),
                "up_b": t(L["b_up"]) if L.get("b_up") is not None else None,
                "down": t(L["w_down"].T),
                "down_b": (t(L["b_down"]) if L.get("b_down") is not None
                           else None),
                "ln1": (t(L["ln1_scale"]), t(L["ln1_bias"])),
                "ln2": (t(L["ln2_scale"]), t(L["ln2_bias"])),
            })
        self._fns: dict = {}
        self._graphs: dict = {}
        self._pool = None
        self._lock = threading.Lock()
        self._serve_scheduler = None

    @property
    def dimensions(self) -> int:
        return self.cfg.d_model

    def _build_forward(self, T: int, masked: bool):
        cfg = self.cfg
        D, H = cfg.d_model, cfg.n_heads
        hd = D // H
        scale = 1.0 / math.sqrt(hd)
        eps = cfg.ln_eps
        pre = cfg.ln_placement == "pre"
        act = {
            "gelu": lambda v: F.gelu(v),
            "relu": torch.relu,
        }.get(cfg.act, lambda v: F.gelu(v, approximate="tanh"))
        emb, pos, fp, layers = self._emb, self._pos, self._fp, self._layers

        def forward(ids, amask, pmask):
            # ids: (T,) int64; amask: (T,) bf16 additive scores mask;
            # pmask: (T, 1) f32 pooling weights (real positions = 1)
            x = emb[ids] + pos[:T]
            if not pre and "ln_e_scale" in fp:
                x = F.layer_norm(x, (D,), fp["ln_e_scale"],
                                 fp["ln_e_bias"], eps)
            for w in layers:
                h = (F.layer_norm(x, (D,), *w["ln1"], eps) if pre else x)
                qkv = F.linear(h, w["qkv"], w["qkv_b"])
                q, k, v = qkv.view(T, 3, H, hd).permute(1, 2, 0, 3)
                sc = (q @ k.transpose(-1, -2)) * scale
                if masked:
                    sc = sc + amask
                a = torch.softmax(sc.float(), dim=-1).to(q.dtype)
                o = (a @ v).permute(1, 0, 2).reshape(T, D)
                o = F.linear(o, w["o"], w["o_b"])
                if pre:
                    x = x + o
                    h = F.layer_norm(x, (D,), *w["ln2"], eps)
                else:
                    x = F.layer_norm(x + o, (D,), *w["ln1"], eps)
                    h = x
                ff = F.linear(act(F.linear(h, w["up"], w["up_b"])),
                              w["down"], w["down_b"])
                x = (x + ff if pre
                     else F.layer_norm(x + ff, (D,), *w["ln2"], eps))
            if pre:
                x = F.layer_norm(x, (D,), fp["ln_f_scale"],
                                 fp["ln_f_bias"], eps)
            x32 = x.float()
            if masked:
                pooled = (x32 * pmask).sum(0) / pmask.sum()
            else:
                pooled = x32.mean(0)
            return pooled / (torch.linalg.vector_norm(pooled) + 1e-12)

        return forward

    def _forward_fn(self, T: int, masked: bool):
        key = (T, masked)
        if key not in self._fns:
            self._fns[key] = self._build_forward(T, masked)
        return self._fns[key]

    def _graph(self, T: int, masked: bool) -> _Graph:
        """The shape's CUDA graph, captured at its first use."""
        key = (T, masked)
        g = self._graphs.get(key)
        if g is None:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            with torch.no_grad():
                g = _Graph(self._forward_fn(T, masked), T, masked,
                           self.device, self._pool)
            self._graphs[key] = g
        return g

    def _inputs(self, text: str):
        """(T, masked, ids, amask, pmask) of one query, on the host."""
        ids = self.tokenizer.encode(text)[: self.cfg.max_len] or [0]
        T = next((b for b in self.buckets if b >= len(ids)),
                 self.buckets[-1])
        ids = ids[:T]  # longer than the largest bucket: truncate to it
        n = len(ids)
        masked = n != T
        tid = torch.zeros(T, dtype=torch.int64)
        tid[:n] = torch.as_tensor(ids, dtype=torch.int64)
        amask = pmask = None
        if masked:
            amask = torch.full((T,), -1e9, dtype=torch.bfloat16)
            amask[:n] = 0.0
            pmask = torch.zeros((T, 1), dtype=torch.float32)
            pmask[:n] = 1.0
        return T, masked, tid, amask, pmask

    def embed_eager(self, text: str) -> np.ndarray:
        """The same function issued op by op on the device (no graph): on
        the CPU this is ``embed``; on the card, what the graphs are held
        to."""
        T, masked, *args = self._inputs(text)
        args = [None if a is None else a.to(self.device) for a in args]
        with torch.no_grad():
            return self._forward_fn(T, masked)(*args).cpu().numpy()

    def embed(self, text: str) -> np.ndarray:
        if self.device.type != "cuda":
            return self.embed_eager(text)
        T, masked, tid, amask, pmask = self._inputs(text)
        with self._lock:
            g = self._graph(T, masked)
            g.ids.copy_(tid, non_blocking=True)
            if masked:
                g.amask.copy_(amask, non_blocking=True)
                g.pmask.copy_(pmask, non_blocking=True)
            g.graph.replay()
            return g.out.cpu().numpy()

    def __call__(self, text: str) -> np.ndarray:
        return self.embed(text)

    def serving_scheduler(self, **kwargs):
        """The single shared executor of this latency tier
        (serve/scheduler.py): concurrent serving threads queue through
        ONE worker — priority, deadline shedding and backpressure counters
        included — which embeds each item of a batch in turn (on the card,
        one graph replay under the lock per item).  ``kwargs`` configure
        the scheduler when it is built (defaults: ``name="host_encoder"``,
        ``max_batch_size=16``, ``batch_linger_ms=1.0``)."""
        if self._serve_scheduler is None or self._serve_scheduler._closed:
            from ..serve.scheduler import RequestScheduler

            kwargs.setdefault("name", "host_encoder")
            kwargs.setdefault("max_batch_size", 16)
            kwargs.setdefault("batch_linger_ms", 1.0)
            self._serve_scheduler = RequestScheduler(
                lambda texts: [self.embed(t) for t in texts], **kwargs
            )
        return self._serve_scheduler

    def embed_scheduled(self, text: str, **submit_kwargs) -> np.ndarray:
        """:meth:`embed` through :meth:`serving_scheduler`; ``submit_kwargs``
        are ``RequestScheduler.submit``'s (priority, deadline, timeout)."""
        return self.serving_scheduler().submit(text, **submit_kwargs)

    def warmup(self, text: str = "warmup query text") -> None:
        """Capture the bucket ``text`` needs (call off the serving path)."""
        self.embed(text)

    def warmup_all(self) -> None:
        """Capture every (bucket, masked) shape: the cold-start cost a
        long-lived serving process pays once."""
        if self.device.type != "cuda":
            return
        with self._lock:
            for T in self.buckets:
                for masked in (False, True):
                    self._graph(T, masked)
