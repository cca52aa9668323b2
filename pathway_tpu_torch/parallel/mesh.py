"""Device mesh and tensor-parallel sharding, driven by one controller.

Counterpart of ``pathway_tpu/parallel/mesh.py``.  The JAX package shards
its serving path with ``shard_map``: one controller issues each step
program over a (dp=1, tp=N) mesh and every device runs the per-shard
body, with collectives between them.  The port keeps that design
without ``torch.distributed``:

- a :class:`TPMesh` is an ordered list of ``torch.device``s, one per
  shard.  A list may repeat a device: ``["cpu"] * 8`` is the port's
  counterpart of ``--xla_force_host_platform_device_count=8``, and
  ``["cuda:0"] * tp`` runs ``tp`` logical shards on one card.  Nothing
  builds such a list on its own: :func:`tp_mesh` defaults to the first
  ``tp`` CUDA devices;
- a sharded program's per-shard body is a generator that computes on
  its shard's tensors and ``yield``s a :class:`Collective` where the JAX
  body calls ``lax.psum`` / ``lax.all_gather`` (:func:`shard_psum`,
  :func:`shard_all_gather`).  :meth:`TPMesh.spmd` steps every shard's
  body to its next collective, performs it and sends each body its
  result, so the shards advance in lockstep, one Python thread issuing
  every launch in shard order;
- the collectives are plain functions of the shards' tensors:
  :meth:`TPMesh.psum` adds the partials in one fixed order, shard 0 to
  N-1, on shard 0's device and copies the sum to every shard (so
  replicated activations are bit-identical across shards);
  :meth:`TPMesh.all_gather` concatenates along an axis the same way.
  Between distinct cards the copies are ``Tensor.to`` peer copies; no
  NCCL.

With no mesh a body issues no collective at all (:func:`run_single`):
tp = 1 is the single-device program, as in the JAX package.

Sharding layouts are PartitionSpec-like tuples (``(None, "tp")`` shards
a leaf's axis 1 over tp, ``()`` replicates it), the JAX package's rules
written out: :func:`decoder_param_sharding_rules` for the decoder and
its decode plan, :func:`param_sharding_rules` for the encoder.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Generator, NamedTuple, Sequence

import torch

# [n_layers, num_blocks, block_size, n_kv_heads, head_dim]: heads over tp
KV_POOL_SPEC = (None, None, None, "tp", None)
# [n_layers, max_slots, n_heads, d_key, d_value]: the SSD recurrent
# state (kvcache/statecache.py), heads over tp like the KV pool
SSD_STATE_SPEC = (None, None, "tp", None, None)


class Collective(NamedTuple):
    """What a per-shard body yields at a collective: ``op`` is
    ``"psum"`` or ``"all_gather"`` (along ``dim``)."""

    op: str
    tensor: torch.Tensor
    dim: int = 0


@dataclasses.dataclass(frozen=True)
class Shard:
    """One shard's place in its mesh: the JAX body's ``axis_index``."""

    index: int
    count: int
    device: torch.device


def shard_psum(x: torch.Tensor, shard: Shard | None):
    """``lax.psum`` inside a per-shard body (``y = yield from
    shard_psum(x, shard)``); ``x`` itself with no shard."""
    if shard is None:
        return x
    return (yield Collective("psum", x))


def shard_all_gather(x: torch.Tensor, shard: Shard | None, dim: int = 0):
    """``lax.all_gather(..., tiled=True)`` along ``dim`` inside a
    per-shard body; ``x`` itself with no shard."""
    if shard is None:
        return x
    return (yield Collective("all_gather", x, dim))


def run_single(body: Generator) -> Any:
    """Run a per-shard body built with no shard: it issues no collective,
    so it runs to its end at the first step."""
    try:
        req = next(body)
    except StopIteration as stop:
        return stop.value
    raise RuntimeError(f"a body with no mesh issued a collective ({req.op})")


class TPMesh:
    """An ordered list of devices over named axes (row-major), the
    port's ``jax.sharding.Mesh``.  The collectives and :meth:`spmd` act
    over a one-axis mesh; :func:`make_mesh` builds (dp, tp) meshes for
    the encoder layout."""

    def __init__(self, devices: Sequence, axis_names: Sequence[str] = ("tp",),
                 sizes: Sequence[int] | None = None):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = tuple(axis_names)
        sizes = tuple(sizes) if sizes is not None else (len(self.devices),)
        if len(sizes) != len(self.axis_names):
            raise ValueError(f"axis sizes {sizes} for axes {self.axis_names}")
        n = 1
        for s in sizes:
            n *= int(s)
        if n != len(self.devices):
            raise ValueError(f"axis sizes {sizes} do not cover "
                             f"{len(self.devices)} devices")
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))

    def __repr__(self) -> str:
        return (f"TPMesh({[str(d) for d in self.devices]}, "
                f"shape={self.shape})")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def axis_name(self) -> str:
        """The axis of a one-axis mesh."""
        self._one_axis()
        return self.axis_names[0]

    def _one_axis(self) -> None:
        if len(self.axis_names) != 1:
            raise ValueError(f"collectives run over a one-axis mesh, this "
                             f"one has axes {self.axis_names}")

    def shard(self, i: int) -> Shard:
        self._one_axis()
        return Shard(i, self.size, self.devices[i])

    # -- collectives over the shards' tensors -------------------------------
    def replicate(self, t: torch.Tensor) -> list[torch.Tensor]:
        """``t`` on every shard's device (the same tensor where a shard
        shares ``t``'s device)."""
        return [t.to(d) for d in self.devices]

    def psum(self, parts: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """The sum of the shards' partials, added in shard order on
        shard 0's device and copied to every shard."""
        self._one_axis()
        dev0 = self.devices[0]
        acc = parts[0].to(dev0)
        for p in parts[1:]:
            acc = acc + p.to(dev0)
        return self.replicate(acc)

    def all_gather(self, parts: Sequence[torch.Tensor],
                   dim: int = 0) -> list[torch.Tensor]:
        """The shards' tensors concatenated along ``dim`` in shard order
        on shard 0's device, copied to every shard."""
        self._one_axis()
        dev0 = self.devices[0]
        return self.replicate(torch.cat([p.to(dev0) for p in parts], dim))

    def ppermute(self, parts: Sequence[torch.Tensor],
                 shift: int = 1) -> list[torch.Tensor]:
        """Shard ``i`` receives shard ``i - shift``'s tensor (a ring)."""
        self._one_axis()
        n = self.size
        return [parts[(i - shift) % n].to(self.devices[i]) for i in range(n)]

    def all_to_all(self, parts: Sequence[torch.Tensor], split_dim: int,
                   concat_dim: int) -> list[torch.Tensor]:
        """``lax.all_to_all(tiled=True)``: each shard's tensor is cut into
        ``n`` pieces along ``split_dim``; shard ``j`` concatenates piece
        ``j`` of every shard, in shard order, along ``concat_dim``."""
        self._one_axis()
        n = self.size
        pieces = [p.chunk(n, split_dim) for p in parts]
        return [torch.cat([pieces[i][j].to(self.devices[j])
                           for i in range(n)], concat_dim)
                for j in range(n)]

    # -- the lockstep runner -----------------------------------------------
    def spmd(self, body: Callable[[Shard], Generator]) -> list:
        """Run ``body(shard)``, a generator per shard, in lockstep: each
        step advances every shard's body to its next :class:`Collective`,
        performs it and sends each body its share.  Returns the bodies'
        return values in shard order."""
        gens = [body(self.shard(i)) for i in range(self.size)]
        sends: list = [None] * self.size
        while True:
            reqs, outs = [], []
            for g, s in zip(gens, sends):
                try:
                    reqs.append(g.send(s))
                except StopIteration as stop:
                    outs.append(stop.value)
            if len(outs) == self.size:
                return outs
            if outs or len({(r.op, r.dim) for r in reqs}) != 1:
                raise RuntimeError(
                    "shards diverged at a collective: "
                    f"{[(r.op, r.dim) for r in reqs]} with {len(outs)} "
                    "shards finished")
            parts = [r.tensor for r in reqs]
            if reqs[0].op == "psum":
                sends = self.psum(parts)
            elif reqs[0].op == "all_gather":
                sends = self.all_gather(parts, reqs[0].dim)
            else:
                raise ValueError(f"unknown collective {reqs[0].op!r}")


def _cuda_devices(n: int) -> list[torch.device]:
    have = torch.cuda.device_count()
    if n > have:
        raise ValueError(
            f"a mesh of {n} shard(s) needs {n} CUDA devices, this process "
            f"sees {have}; pass devices= to place shards explicitly")
    return [torch.device("cuda", i) for i in range(n)]


def _explicit_devices(devices) -> list[torch.device]:
    out = [torch.device(d) for d in devices]
    have = torch.cuda.device_count()
    for d in out:
        if d.type == "cuda" and (d.index or 0) >= have:
            raise ValueError(f"device {d} requested, this process sees "
                             f"{have} CUDA device(s)")
    return out


def tp_mesh(tp: int | None = None, devices: Sequence | None = None) -> TPMesh:
    """A one-axis ``tp`` mesh: over ``devices`` when given (which may
    repeat a device), else over the first ``tp`` CUDA devices (all of
    them for ``tp=None``).  Raises when the process sees too few."""
    if devices is None:
        n = torch.cuda.device_count() if tp is None else int(tp)
        if n < 1:
            raise ValueError("no CUDA device: a tp mesh over the card needs "
                             "one; pass devices= for shards on the CPU")
        devs = _cuda_devices(n)
    else:
        devs = _explicit_devices(devices)
        if tp is not None and len(devs) != int(tp):
            raise ValueError(f"tp={tp} with {len(devs)} devices")
    return TPMesh(devs, ("tp",))


def make_mesh(n_devices: int | None = None, *, dp: int | None = None,
              tp: int | None = None, axis_names: Sequence[str] = ("dp", "tp"),
              devices: Sequence | None = None) -> TPMesh:
    """A (dp, tp) mesh over ``devices`` (default: the CUDA devices).
    With neither degree given, tensor parallelism is favoured within a
    host (the largest power of two up to 8 that divides the count), as
    in the JAX package."""
    devs = (_explicit_devices(devices) if devices is not None
            else _cuda_devices(n_devices or torch.cuda.device_count()))
    n = n_devices or len(devs)
    if n < 1 or n > len(devs):
        raise ValueError(f"n_devices={n_devices} with {len(devs)} devices")
    devs = devs[:n]
    if dp is None and tp is None:
        tp = _largest_pow2_divisor(n, cap=8)
        dp = n // tp
    elif dp is None:
        dp = n // tp
    elif tp is None:
        tp = n // dp
    if dp * tp != n:
        raise ValueError(f"dp({dp}) * tp({tp}) != n_devices({n})")
    return TPMesh(devs, axis_names, (dp, tp))


def _largest_pow2_divisor(n: int, cap: int) -> int:
    p = 1
    while p * 2 <= cap and n % (p * 2) == 0:
        p *= 2
    return p


# -- legal degrees -----------------------------------------------------------


def legal_tp_values(n_kv_heads: int, vocab_size: int,
                    n_devices: int | None = None,
                    d_ff: int | None = None) -> list[int]:
    """Tensor-parallel degrees that shard the decoder evenly: each
    divides the KV heads, the vocab and ``d_ff``, up to ``n_devices``."""
    cap = min(n_kv_heads, n_devices) if n_devices else n_kv_heads
    return [
        t for t in range(1, cap + 1)
        if n_kv_heads % t == 0 and vocab_size % t == 0
        and (d_ff is None or d_ff % t == 0)
    ]


def validate_decoder_tp(n_kv_heads: int, vocab_size: int, tp: int,
                        n_devices: int | None = None,
                        d_ff: int | None = None) -> None:
    """Raise, naming the offending dims and the legal tp values, when
    ``tp`` cannot shard the decoder: the KV heads (and so d_model), the
    vocab (the tied embedding) and ``d_ff`` (the FFN's columns and rows)
    must each divide by it, and it may not exceed ``n_devices``."""
    problems = []
    if tp < 1:
        problems.append(f"tp={tp} must be >= 1")
    else:
        if n_kv_heads % tp:
            problems.append(f"n_kv_heads={n_kv_heads} % tp={tp} != 0")
        if vocab_size % tp:
            problems.append(f"vocab_size={vocab_size} % tp={tp} != 0")
        if d_ff is not None and d_ff % tp:
            problems.append(f"d_ff={d_ff} % tp={tp} != 0")
        if n_devices is not None and tp > n_devices:
            problems.append(f"tp={tp} > {n_devices} local devices")
    if problems:
        legal = legal_tp_values(n_kv_heads, vocab_size, n_devices, d_ff)
        raise ValueError(
            "cannot shard the paged decode path: " + "; ".join(problems)
            + f". Legal tp values for this model/host: {legal}")


# -- sharding rules ----------------------------------------------------------


def param_sharding_rules(path: tuple[str, ...],
                         leaf_shape: tuple[int, ...]) -> tuple:
    """Megatron layout of the ENCODER's params: q/k/v and the FFN's up
    projection split their output dim (column parallel), the output and
    down projections their input dim (row parallel), the embeddings
    their vocab (rows); everything else is replicated."""
    name = "/".join(path)
    if len(leaf_shape) < 2:
        return ()
    if any(k in name for k in ("wq", "wk", "wv", "w_up", "w_gate")):
        return (None, "tp")
    if any(k in name for k in ("wo", "w_down")):
        return ("tp", None)
    if "embed" in name:
        return ("tp", None)
    return ()


def decoder_param_sharding_rules(path: tuple[str, ...],
                                 leaf_shape: tuple[int, ...]) -> tuple:
    """Tensor-parallel layout of the DECODER's params and decode plan:

    - ``wq``/``wk``/``wv``/``w_up`` (and the SSD gate ``w_a``, one column
      a head) shard their output dim, their biases with them;
    - ``wo``/``w_down`` shard their input dim (one psum after; the
      replicated bias is added once, after it);
    - ``embed`` shards its vocab rows, the plan's ``[D, V]`` ``embed_t``
      its vocab columns;
    - the plan's fused ``wqkv``/``bqkv`` split like a column-parallel
      leaf: their columns are laid out per shard
      (``models/decoder._fuse_cols``);
    - an int8 plan's ``{w}_q`` shards as its base; its scales ``{w}_s``
      split with column-parallel bases and are replicated for
      row-parallel ones (the scale distributes over the psum);
    - ``pos_embed``, the layer norms and the rest are replicated."""
    name = path[-1] if path else ""
    if name.endswith("_q") and name[:-2] in (
            "wqkv", "wo", "w_up", "w_down", "embed_t"):
        name = name[:-2]
    if name.endswith("_s") and name[:-2] in ("wqkv", "w_up", "embed_t"):
        return ("tp",)
    if name.endswith("_s") and name[:-2] in ("wo", "w_down"):
        return ()
    if name in ("wqkv", "embed_t"):
        return (None, "tp")
    if name == "bqkv":
        return ("tp",)
    if name in ("wq", "wk", "wv", "w_up", "w_gate", "w_a"):
        return (None, "tp")
    if name in ("bq", "bk", "bv", "b_up", "b_gate", "b_a"):
        return ("tp",)
    if name in ("wo", "w_down"):
        return ("tp", None)
    if name == "embed":
        return ("tp", None)
    return ()


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _shard_tree(params, mesh: TPMesh, rules, axis: str) -> list:
    n = mesh.shape[axis]
    pos = mesh.axis_names.index(axis)
    # row-major: a device's index along ``axis``
    stride = 1
    for a in mesh.axis_names[pos + 1:]:
        stride *= mesh.shape[a]
    out = []
    for flat, dev in enumerate(mesh.devices):
        i = (flat // stride) % n

        def place(path, t, i=i, dev=dev):
            spec = rules(path, tuple(t.shape))
            if axis in spec:
                dim = spec.index(axis)
                if t.shape[dim] % n:
                    raise ValueError(
                        f"{'/'.join(path)}: axis {dim} of {tuple(t.shape)} "
                        f"does not split over {n} shards")
                t = t.chunk(n, dim)[i]
            return t.to(dev).contiguous()

        out.append(_map_with_path(place, params))
    return out


def shard_decoder_params(params, mesh: TPMesh) -> list[dict]:
    """One param dict per shard, each leaf on its shard's device, laid
    out by :func:`decoder_param_sharding_rules`."""
    return _shard_tree(params, mesh, decoder_param_sharding_rules, "tp")


def shard_params(params, mesh: TPMesh) -> list[dict]:
    """The encoder layout (:func:`param_sharding_rules`) over the mesh's
    ``tp`` axis: one dict per device of the mesh, in its row-major order
    (devices that differ only in ``dp`` hold the same shard)."""
    return _shard_tree(params, mesh, param_sharding_rules, "tp")


def shard_shape(shape: Sequence[int], spec: tuple, count: int,
                axis: str = "tp") -> tuple:
    """A shard's shape of a ``shape`` tensor laid out by ``spec``."""
    out = list(shape)
    if axis in spec:
        out[spec.index(axis)] //= count
    return tuple(out)


__all__ = [
    "Collective", "KV_POOL_SPEC", "SSD_STATE_SPEC", "Shard", "TPMesh",
    "decoder_param_sharding_rules", "legal_tp_values", "make_mesh",
    "param_sharding_rules", "run_single", "shard_all_gather",
    "shard_decoder_params", "shard_params", "shard_psum", "shard_shape",
    "tp_mesh", "validate_decoder_tp",
]
