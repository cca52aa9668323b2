"""The encoder's host tiers and its single-query serving tier.

The host tiers are the counterparts of ``pathway_tpu/models/
host_encoder.py``'s mirrors: ``NumpyEncoderMirror`` (one text a forward,
in numpy), ``TorchBatchEncoder`` (bulk embedding) and
``TorchEncoderMirror`` (one text a forward, what ``make_host_mirror``
returns).  The two torch tiers run ``models/encoder.py``'s ``encode``
over an f32 CPU copy of the encoder's weights, whichever device the
encoder is on.  None sets torch's thread count:
``torch.set_num_threads`` is process-wide, and here it would also change
the threads of the process that drives the card.

The single-query serving tier: one query embedded per call, at the
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

import dataclasses
import math
import threading
import time

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


def _erf_vec(x):
    try:
        from scipy.special import erf

        return erf(x)
    except ImportError:
        # Abramowitz-Stegun 7.1.26 vectorized (<=1.5e-7 abs err)
        sign = np.sign(x)
        ax = np.abs(x)
        t = 1.0 / (1.0 + 0.3275911 * ax)
        y = 1.0 - (
            ((((1.061405429 * t - 1.453152027) * t) + 1.421413741) * t
             - 0.284496736) * t + 0.254829592
        ) * t * np.exp(-ax * ax)
        return sign * y


class NumpyEncoderMirror:
    """Single-text forward pass in numpy, weight-identical to the device
    encoder."""

    def __init__(self, cfg, params, tokenizer):
        self.cfg = cfg
        self.tokenizer = tokenizer
        p = _np_tree(params)
        self._p = p
        # fused (D, 3D) qkv weight per layer: one BLAS call instead of three
        self._layers = []
        for L in p["layers"]:
            wqkv = np.ascontiguousarray(
                np.concatenate([L["wq"], L["wk"], L["wv"]], axis=1)
            )
            bqkv = None
            if L.get("bq") is not None:
                bqkv = np.concatenate([L["bq"], L["bk"], L["bv"]])
            self._layers.append((wqkv, bqkv, L))

    @property
    def dimensions(self) -> int:
        return self.cfg.d_model

    def _act(self, v):
        if self.cfg.act == "gelu":
            return 0.5 * v * (1.0 + _erf_vec(v / np.float32(math.sqrt(2.0))))
        if self.cfg.act == "relu":
            return np.maximum(v, 0.0)
        return 0.5 * v * (
            1.0 + np.tanh(0.7978845608 * (v + 0.044715 * v ** 3))
        )

    def _ln(self, x, s, b):
        mu = x.mean(-1, keepdims=True)
        var = x.var(-1, keepdims=True)
        return (x - mu) / np.sqrt(var + self.cfg.ln_eps) * s + b

    def _forward_tokens(self, ids: np.ndarray) -> np.ndarray:
        """(T,) int token ids -> (T, D) contextual embeddings."""
        p = self._p
        cfg = self.cfg
        x = p["embed"][ids] + p["pos_embed"][: len(ids)]
        if cfg.ln_placement == "post" and "ln_e_scale" in p:
            x = self._ln(x, p["ln_e_scale"], p["ln_e_bias"])
        H = cfg.n_heads
        hd = cfg.d_model // H
        T, D = x.shape
        pre = cfg.ln_placement == "pre"
        for wqkv, bqkv, L in self._layers:
            h = self._ln(x, L["ln1_scale"], L["ln1_bias"]) if pre else x
            qkv = h @ wqkv
            if bqkv is not None:
                qkv = qkv + bqkv
            q, k, v = np.split(qkv, 3, axis=-1)
            q = q.reshape(T, H, hd).transpose(1, 0, 2)  # (H, T, hd)
            k = k.reshape(T, H, hd).transpose(1, 2, 0)  # (H, hd, T)
            v = v.reshape(T, H, hd).transpose(1, 0, 2)
            sc = np.matmul(q, k) / np.sqrt(hd)          # (H, T, T)
            sc -= sc.max(-1, keepdims=True)
            pr = np.exp(sc)
            pr /= pr.sum(-1, keepdims=True)
            a = np.matmul(pr, v).transpose(1, 0, 2).reshape(T, D)
            a = a @ L["wo"]
            if L.get("bo") is not None:
                a = a + L["bo"]
            if pre:
                x = x + a
                h = self._ln(x, L["ln2_scale"], L["ln2_bias"])
            else:
                x = self._ln(x + a, L["ln1_scale"], L["ln1_bias"])
                h = x
            ff = h @ L["w_up"]
            if L.get("b_up") is not None:
                ff = ff + L["b_up"]
            ff = self._act(ff)
            ff = ff @ L["w_down"]
            if L.get("b_down") is not None:
                ff = ff + L["b_down"]
            if pre:
                x = x + ff
            else:
                x = self._ln(x + ff, L["ln2_scale"], L["ln2_bias"])
        if pre:
            x = self._ln(x, p["ln_f_scale"], p["ln_f_bias"])
        return x

    def embed(self, text: str) -> np.ndarray:
        ids = np.asarray(
            self.tokenizer.encode(text)[: self.cfg.max_len] or [0],
            dtype=np.int64,
        )
        x = self._forward_tokens(ids)
        pooled = x.mean(0)
        return pooled / (np.linalg.norm(pooled) + 1e-12)

    def embed_batch(self, texts: list[str]) -> np.ndarray:
        return np.stack([self.embed(t) for t in texts])

    def __call__(self, text: str) -> np.ndarray:
        return self.embed(text)


class TorchBatchEncoder:
    """The batched host tier: ``models/encoder.py``'s ``encode`` on torch
    CPU tensors over an f32 copy of the weights, a chunk of texts a
    forward, each chunk padded to its own longest text."""

    def __init__(self, cfg, params, tokenizer):
        from .encoder import params_to

        self.cfg = dataclasses.replace(cfg, dtype=torch.float32)
        self.params = params_to(params, "cpu", torch.float32)
        self.tokenizer = tokenizer

    @property
    def dimensions(self) -> int:
        return self.cfg.d_model

    def embed_batch(self, texts: list[str], chunk: int = 128,
                    stats: dict | None = None) -> np.ndarray:
        """(len(texts), D) f32 rows as numpy; ``stats``
        (``TorchEncoder.stats``-shaped) accumulates per-stage wall time
        (``device_s``: the host forward)."""
        from .encoder import encode

        outs = [np.zeros((0, self.cfg.d_model), np.float32)]
        for i in range(0, len(texts), chunk):
            part = texts[i: i + chunk]
            t0 = time.perf_counter()
            toks = [self.tokenizer.encode(t)[: self.cfg.max_len] or [0]
                    for t in part]
            t1 = time.perf_counter()
            T = max(len(t) for t in toks)
            ids = torch.zeros((len(part), T), dtype=torch.int64)
            mask = torch.zeros((len(part), T), dtype=torch.bool)
            for j, t in enumerate(toks):
                ids[j, : len(t)] = torch.as_tensor(t)
                mask[j, : len(t)] = True
            t2 = time.perf_counter()
            with torch.no_grad():
                outs.append(encode(self.params, self.cfg, ids,
                                   None if bool(mask.all()) else mask
                                   ).numpy())
            if stats is not None:
                stats["tokenize_s"] += t1 - t0
                stats["pad_s"] += t2 - t1
                stats["device_s"] += time.perf_counter() - t2
                stats["texts"] += len(part)
                stats["calls"] += 1
        return np.concatenate(outs)

    def embed(self, text: str) -> np.ndarray:
        return self.embed_batch([text])[0]

    def __call__(self, text: str) -> np.ndarray:
        return self.embed(text)


class TorchEncoderMirror(TorchBatchEncoder):
    """The single-text host tier (what ``make_host_mirror`` returns): the
    batched tier one text a forward, unpadded."""

    def embed(self, text: str) -> np.ndarray:
        return super().embed_batch([text])[0]

    def embed_batch(self, texts: list[str]) -> np.ndarray:
        return np.stack([self.embed(t) for t in texts])


def make_host_mirror(cfg, params, tokenizer) -> TorchEncoderMirror:
    """The latency tier's host backend: torch is always present here."""
    return TorchEncoderMirror(cfg, params, tokenizer)


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
