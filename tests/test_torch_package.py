"""pathway_tpu_torch package rules.

- importing the package and every submodule loads neither ``jax`` nor
  ``pathway_tpu`` (checked in a fresh interpreter), and no source file
  of the port or ``chip_smoke.py`` imports them;
- entry points called without ``device=`` on a machine with no CUDA
  device raise instead of falling back to the CPU;
- ``chip_smoke.py`` exits non-zero and prints no result without a card.
"""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

import pathway_tpu_torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = pathlib.Path(pathway_tpu_torch.__file__).parent


def _modules():
    names = set()
    for p in PORT.rglob("*.py"):
        parts = p.relative_to(PORT).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.add(".".join(("pathway_tpu_torch",) + parts))
    return sorted(names)


def test_the_guard_covers_the_observatory():
    """The import guards below walk every module of the port, the
    observatory's included."""
    for name in ("obs", "obs.tracer", "obs.costdb", "obs.profiler",
                 "obs.memory", "obs.planner"):
        assert f"pathway_tpu_torch.{name}" in _modules()


def test_the_guard_covers_the_parallel_modules():
    """... and the tensor-parallel ones: the mesh, the sharded KNN and the
    sequence-parallel attention."""
    for name in ("parallel", "parallel.mesh", "ops.knn_sharded",
                 "models.attention"):
        assert f"pathway_tpu_torch.{name}" in _modules()


def test_the_guard_covers_the_model_and_embedder_modules():
    """... and the CLIP dual encoder, the result caches and the embedder
    with the JAX package's ``BaseEmbedder`` surface."""
    for name in ("models.clip", "internals.udfs", "xpacks.llm.embedders"):
        assert f"pathway_tpu_torch.{name}" in _modules()


def test_import_loads_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'pathway_tpu' "
        "or m.startswith('pathway_tpu.'))\n"
        "print(len(sys.modules), bad)\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("path", [*sorted(PORT.rglob("*.py")),
                                  ROOT / "chip_smoke.py",
                                  ROOT / "chip_obs_ab.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "pathway_tpu"), (path, name)


def _entry_points():
    from pathway_tpu_torch.kvcache.block_pool import BlockPool
    from pathway_tpu_torch.kvcache.engine import PagedDecodeEngine
    from pathway_tpu_torch.models import clip, decoder, encoder
    from pathway_tpu_torch.models.host_encoder import CompiledQueryEncoder
    from pathway_tpu_torch.models.tokenizer import HashTokenizer
    from pathway_tpu_torch.ops.device_store import DeviceVecStore
    from pathway_tpu_torch.ops.knn_cuda import knn_topk
    from pathway_tpu_torch.serve.fleet import ReplicaFleet
    from pathway_tpu_torch.stdlib.indexing.inner_index import BruteForceKnn
    from pathway_tpu_torch.xpacks.llm.embedders import (
        SentenceTransformerEmbedder)
    from pathway_tpu_torch.xpacks.llm.llms import TorchChat

    dcfg = decoder.DecoderConfig(vocab_size=32, d_model=8, n_layers=1,
                                 n_heads=2, d_ff=16, max_len=16)
    ecfg = encoder.EncoderConfig(vocab_size=32, d_model=8, n_layers=1,
                                 n_heads=2, d_ff=16, max_len=16)
    params = decoder.init_decoder_params(dcfg, 0, device="cpu")
    return {
        "TorchEncoder": lambda: encoder.TorchEncoder(ecfg),
        "init_params": lambda: encoder.init_params(ecfg),
        "TorchDecoderLM": lambda: decoder.TorchDecoderLM(dcfg),
        "TorchDecoderLM.generate": lambda: decoder.TorchDecoderLM(
            dcfg, params=params).generate("a b", 2),
        "PagedDecodeEngine": lambda: PagedDecodeEngine(dcfg, params),
        "BlockPool": lambda: BlockPool(num_blocks=4, block_size=4,
                                       n_layers=1, n_heads=2, head_dim=4),
        "BruteForceKnn": lambda: BruteForceKnn(8),
        "knn_topk": lambda: knn_topk(torch.zeros(4, 8), torch.zeros(1, 8), 2),
        "DeviceVecStore": lambda: DeviceVecStore(8),
        "CompiledQueryEncoder": lambda: CompiledQueryEncoder(
            ecfg, encoder.init_params(ecfg, device="cpu"), HashTokenizer(32)),
        "SentenceTransformerEmbedder": lambda: SentenceTransformerEmbedder(
            config=ecfg),
        "ReplicaFleet": lambda: ReplicaFleet(dcfg, params, replicas=2),
        "TorchChat": lambda: TorchChat(dcfg, params=params),
        "TorchClip": lambda: clip.TorchClip(),
        "make_train_step": lambda: decoder.make_train_step(dcfg),
    }


@pytest.mark.parametrize("name", [
    "BlockPool", "BruteForceKnn", "CompiledQueryEncoder", "DeviceVecStore",
    "PagedDecodeEngine", "ReplicaFleet", "SentenceTransformerEmbedder",
    "TorchChat", "TorchClip", "TorchDecoderLM", "TorchDecoderLM.generate",
    "TorchEncoder", "init_params", "knn_topk", "make_train_step",
])
def test_entry_point_without_a_card_raises(name, monkeypatch):
    # decided inside the test: the default device is the card, and a
    # machine without one raises rather than computing on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[name]()


def test_chip_smoke_fails_without_a_card_or_the_package(tmp_path):
    # no visible card, both in the checkout and beside nothing of the repo
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for cwd in (ROOT, tmp_path):
        out = subprocess.run([sys.executable, str(cwd / "chip_smoke.py")],
                             cwd=cwd, env=env, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


@pytest.mark.parametrize("call", ["tp_mesh()", "tp_mesh(2)",
                                  "resolve_tp(cfg, 2)", "engine(tp=2)"])
def test_tensor_parallelism_without_a_card_raises(call, monkeypatch):
    """Shards default to CUDA devices: with none, asking for a mesh or
    for tp > 1 raises instead of placing shards on the CPU."""
    from pathway_tpu_torch.kvcache.engine import PagedDecodeEngine, resolve_tp
    from pathway_tpu_torch.models import decoder
    from pathway_tpu_torch.parallel.mesh import tp_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    cfg = decoder.DecoderConfig(vocab_size=32, d_model=8, n_layers=1,
                                n_heads=2, d_ff=16, max_len=16)
    calls = {
        "tp_mesh()": lambda: tp_mesh(),
        "tp_mesh(2)": lambda: tp_mesh(2),
        "resolve_tp(cfg, 2)": lambda: resolve_tp(cfg, 2),
        "engine(tp=2)": lambda: PagedDecodeEngine(
            cfg, decoder.init_decoder_params(cfg, 0, device="cpu"), tp=2),
    }
    with pytest.raises((ValueError, RuntimeError),
                       match="CUDA device|local devices|device='cpu'"):
        calls[call]()
