"""The int8 HOST decode tier of the causal decoder LM, and the home of
its serving executor (the port of ``pathway_tpu/models/host_decoder.py``).

:class:`Int8DecoderHost` runs greedy decoding on the CPU, by design: it
is the serial tier a decode engine on the CPU degrades to once its
restarts are spent, and the one tier of the port that runs on the host.  Every
projection is a per-channel dynamically quantized int8
``torch.ao.nn.quantized.dynamic.Linear`` (fbgemm); attention and layer
norms run in f32 over a fixed-capacity f32 KV cache that is this
instance's own mutable state.

Its engines (:meth:`paged_engine`, :meth:`state_engine`) and its
executor (:meth:`serving_executor`) are the port's engines, built on the
card (``device="cuda"`` unless the caller names another) from the same
f32 checkpoint.  An engine that cannot be built raises: the JAX package's
``build_engine`` turns any construction error into None and serves from
the serial tier instead, a quiet fallback the port does not copy.  Nor
does an engine on the card move work to the CPU by default: the JAX
package's engines degrade to this serial tier, the port's do so only
when they run on the CPU themselves, or when the caller names the tier
(``degrade_fn=host.degrade``); past its restarts an engine on the card
raises ``EngineFailedError``.
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch
import torch.nn.functional as F

logger = logging.getLogger(__name__)


def _f32_host(a) -> torch.Tensor:
    """A parameter leaf (tensor or array) as an owned f32 CPU tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float32).clone()
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _q8_linear(w) -> torch.nn.Module:
    """A per-channel int8 dynamic Linear from an (in, out) matrix."""
    wt = _f32_host(w).T.contiguous()
    out_f, in_f = wt.shape
    lin = torch.ao.nn.quantized.dynamic.Linear(in_f, out_f)
    scales = wt.abs().amax(dim=1).clamp(min=1e-8) / 127.0
    qw = torch.quantize_per_channel(
        wt, scales, torch.zeros(out_f, dtype=torch.int64), 0, torch.qint8)
    lin.set_weight_bias(qw, None)
    return lin


class Int8DecoderHost:
    """Weight-int8 greedy decoding over a fixed-capacity f32 KV cache on
    the CPU (the host tier), plus the engines and the shared serving
    executor built from the same checkpoint."""

    def __init__(self, cfg, params, cache_capacity: int | None = None):
        self.cfg = cfg
        # the f32 checkpoint, kept (references only) for the engines;
        # serving_executor(paged=False) releases it
        self._params = params
        self._paged_engine = None
        self._state_engine = None
        self._serve_executor = None
        # positions past max_len have no positional embedding
        self.cap = min(int(cache_capacity or cfg.max_len), cfg.max_len)
        t = _f32_host
        self._emb = t(params["embed"])
        self._pos = t(params["pos_embed"])
        self._lnf = (t(params["ln_f_scale"]), t(params["ln_f_bias"]))
        self._layers = []
        for L in params["layers"]:
            wqkv = torch.cat([t(L["wq"]), t(L["wk"]), t(L["wv"])], dim=1)
            self._layers.append({
                "qkv": _q8_linear(wqkv),
                "o": _q8_linear(L["wo"]),
                "up": _q8_linear(L["w_up"]),
                "down": _q8_linear(L["w_down"]),
                "ln1": (t(L["ln1_scale"]), t(L["ln1_bias"])),
                "ln2": (t(L["ln2_scale"]), t(L["ln2_bias"])),
            })
        self._head = _q8_linear(self._emb.T)
        H, D = cfg.n_heads, cfg.d_model
        self._hd = D // H
        self._K = torch.zeros(cfg.n_layers, H, self.cap, self._hd)
        self._V = torch.zeros(cfg.n_layers, H, self.cap, self._hd)
        self._scale = 1.0 / math.sqrt(self._hd)
        self.n_past = 0

    # -- shared blocks -----------------------------------------------------

    def _act(self, v):
        if self.cfg.act == "gelu":
            return F.gelu(v)
        if self.cfg.act == "relu":
            return torch.relu(v)
        return F.gelu(v, approximate="tanh")

    def _ln(self, x, sb):
        return F.layer_norm(x, (self.cfg.d_model,), sb[0], sb[1],
                            self.cfg.ln_eps)

    # -- the serial tier ---------------------------------------------------

    def prefill(self, token_ids) -> np.ndarray:
        """Run the prompt through the int8 blocks, filling the KV cache
        from position 0; returns the next-token logits (f32 numpy)."""
        ids = torch.as_tensor(np.asarray(token_ids, np.int64))
        T = len(ids)
        if T > self.cap:
            raise ValueError(f"prompt {T} exceeds cache capacity {self.cap}")
        H, hd = self.cfg.n_heads, self._hd
        with torch.no_grad():
            x = self._emb[ids] + self._pos[:T]
            causal = torch.tril(torch.ones(T, T, dtype=torch.bool))
            for li, w in enumerate(self._layers):
                h = self._ln(x, w["ln1"])
                q, k, v = w["qkv"](h).view(T, 3, H, hd).permute(1, 2, 0, 3)
                self._K[li, :, :T] = k
                self._V[li, :, :T] = v
                sc = (q @ k.transpose(-1, -2)) * self._scale
                sc = sc.masked_fill(~causal, float("-inf"))
                att = torch.softmax(sc, dim=-1)
                o = (att @ v).permute(1, 0, 2).reshape(T, self.cfg.d_model)
                x = x + w["o"](o)
                h = self._ln(x, w["ln2"])
                x = x + w["down"](self._act(w["up"](h)))
            x = self._ln(x[-1:], self._lnf)
            logits = self._head(x)[0]
        self.n_past = T
        return logits.numpy()

    def decode_step(self, token_id: int) -> np.ndarray:
        """Append one token against the cache; returns the next-token
        logits."""
        n = self.n_past
        if n >= self.cap:
            raise ValueError("KV cache full")
        H, hd = self.cfg.n_heads, self._hd
        with torch.no_grad():
            x = (self._emb[token_id] + self._pos[n]).unsqueeze(0)
            for li, w in enumerate(self._layers):
                h = self._ln(x, w["ln1"])
                q, k, v = w["qkv"](h).view(3, H, hd)
                self._K[li, :, n] = k
                self._V[li, :, n] = v
                keys = self._K[li, :, : n + 1]
                vals = self._V[li, :, : n + 1]
                att = torch.softmax(
                    (keys @ q.unsqueeze(-1)).squeeze(-1) * self._scale,
                    dim=-1)
                o = (att.unsqueeze(1) @ vals).squeeze(1).reshape(
                    1, self.cfg.d_model)
                x = x + w["o"](o)
                h = self._ln(x, w["ln2"])
                x = x + w["down"](self._act(w["up"](h)))
            x = self._ln(x, self._lnf)
            logits = self._head(x)[0]
        self.n_past = n + 1
        return logits.numpy()

    def generate(self, prompt_ids, n_new: int) -> list[int]:
        """Greedy completion: prefill, then ``n_new - 1`` cached steps."""
        logits = self.prefill(prompt_ids)
        out = []
        tok = int(np.argmax(logits))
        for _ in range(n_new):
            out.append(tok)
            if len(out) == n_new:
                break
            tok = int(np.argmax(self.decode_step(tok)))
        return out

    # -- engines and serving -----------------------------------------------

    def degrade(self, prompt, n_remaining, emitted) -> list[int]:
        """An engine's degrade target: once its restarts are spent, a
        stranded request continues on this serial tier (on the CPU) over
        prompt + the tokens the engine already emitted.  The default
        target of the engines built here on the CPU; an engine on the
        card takes it only as an explicit ``degrade_fn=``."""
        return self.generate(list(prompt) + list(emitted), n_remaining)

    def _engine(self, attr: str, cls, name: str, kwargs: dict):
        cached = getattr(self, attr)
        if cached is not None:
            if kwargs and kwargs != getattr(self, attr + "_kwargs"):
                logger.warning(
                    "%s(%r) ignored: the engine was already built with %r "
                    "and is returned unchanged", attr.strip("_"), kwargs,
                    getattr(self, attr + "_kwargs"))
            return cached
        if self._params is None:
            raise RuntimeError("the f32 weights were released "
                               "(serving_executor(paged=False)); no engine")
        setattr(self, attr + "_kwargs", dict(kwargs))
        kwargs = dict(kwargs)
        kwargs.setdefault("name", name)
        # the serial tier runs on the CPU: the default degrade target
        # only of an engine that runs there too
        if torch.device(kwargs.get("device") or "cuda").type == "cpu":
            kwargs.setdefault("degrade_fn", self.degrade)
        engine = cls(self.cfg, self._params, **kwargs)
        setattr(self, attr, engine)
        return engine

    def paged_engine(self, **kwargs):
        """The port's paged engine over this host's checkpoint, built on
        first use (``device="cuda"`` by default).  On the CPU its
        degrade target is this serial tier (:meth:`degrade`); on the card
        it has none unless ``degrade_fn=`` names one.  A construction
        error raises."""
        from ..kvcache.engine import PagedDecodeEngine

        return self._engine("_paged_engine", PagedDecodeEngine,
                            "host_decoder_kv", kwargs)

    def state_engine(self, **kwargs):
        """The constant-memory SSD engine (``kvcache/statecache.py``)
        over this host's checkpoint, which it grafts with the SSD decay
        projections (``ssd_augment_params``); degrade target and errors
        as :meth:`paged_engine`."""
        from ..kvcache.statecache import StateDecodeEngine

        return self._engine("_state_engine", StateDecodeEngine,
                            "host_decoder_state", kwargs)

    def serving_executor(self, *, cache: str = "paged",
                         paged: bool | None = None,
                         max_batch_size: int | None = None,
                         chain_steps: int | None = None,
                         quantize: str | None = None,
                         speculative=None, device=None,
                         tp: int | None = None, devices=None, **kwargs):
        """The one shared :class:`RequestScheduler` of this tier.

        ``cache="paged"`` (default) serves through :meth:`paged_engine`:
        continuous batching over the paged KV pool on the card, new
        arrivals admitted at step boundaries; ``quantize="int8"`` runs
        its products on int8-resident weights, ``speculative=`` turns on
        drafting, ``chain_steps=`` bounds the decode chain.
        ``cache="state"`` serves through :meth:`state_engine`.
        ``paged=False`` keeps the serialized int8 host tier (batch 1:
        the host cache is per-instance state) and releases the f32
        weights the engines would need.  ``device`` is the engines'
        (default ``"cuda"``); ``tp`` and ``devices`` shard them (the
        engines' own arguments).  Other keywords go to the scheduler."""
        if cache not in ("paged", "state"):
            raise ValueError(f"cache={cache!r}: expected 'paged' or 'state'")
        sched = self._serve_executor
        if sched is not None and not sched._closed:
            if (paged is not None or max_batch_size is not None
                    or chain_steps is not None or quantize is not None
                    or speculative is not None or cache != "paged"
                    or tp is not None or devices is not None):
                logger.warning(
                    "serving_executor(cache=%r, paged=%r, ...) ignored: the "
                    "shared executor already exists; shut it down first to "
                    "rebuild it with other settings", cache, paged)
            return sched
        from ..serve.scheduler import RequestScheduler

        kwargs.setdefault("name", "host_decoder")
        kwargs.setdefault("max_queue", 64)
        linger = kwargs.pop("batch_linger_ms", None)
        engine = None
        if cache == "paged" and paged is False:
            # the explicit opt-out frees the f32 weights for good
            if self._paged_engine is None:
                self._params = None
        else:
            engine_kwargs = {"device": "cuda" if device is None else device}
            if max_batch_size is not None:
                engine_kwargs["max_batch_size"] = max_batch_size
            if chain_steps is not None:
                engine_kwargs["chain_steps"] = chain_steps
            if tp is not None:
                engine_kwargs["tp"] = tp
            if devices is not None:
                engine_kwargs["devices"] = devices
            if cache == "state":
                engine = self.state_engine(**engine_kwargs)
            else:
                if quantize is not None:
                    engine_kwargs["quantize"] = quantize
                if speculative is not None:
                    engine_kwargs["speculative"] = speculative
                engine = self.paged_engine(**engine_kwargs)
        if engine is not None:
            holder: list = []
            sched = RequestScheduler(
                lambda reqs: engine.serve_batch(reqs, scheduler=holder[0]),
                max_batch_size=max_batch_size or engine.max_batch_size,
                batch_linger_ms=2.0 if linger is None else linger, **kwargs)
            holder.append(sched)
        else:
            # payloads may carry a priority; the serial tier ignores it
            sched = RequestScheduler(
                lambda reqs: [self.generate(r[0], r[1]) for r in reqs],
                max_batch_size=1,
                batch_linger_ms=0.0 if linger is None else linger, **kwargs)
        self._serve_executor = sched
        return sched

    def generate_scheduled(self, prompt_ids, n_new: int,
                           **submit_kwargs) -> list[int]:
        """Generation through the shared serving executor.  With an
        engine behind it the tokens come from the engine's weights (f32,
        or its own int8 plan), which may differ from :meth:`generate`'s
        fbgemm int8 on near ties.  A ``priority=`` also rides in the
        payload, so the engine's preemption sees the class."""
        payload = (list(prompt_ids), int(n_new))
        if submit_kwargs.get("priority") is not None:
            from ..serve.admission import Priority

            payload = payload + (
                int(Priority.parse(submit_kwargs["priority"])),)
        return self.serving_executor().submit(payload, **submit_kwargs)


__all__ = ["Int8DecoderHost"]
