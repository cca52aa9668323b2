"""The port's public surface against the JAX package's, module by module.

For every module of ``pathway_tpu/`` its counterpart in
``pathway_tpu_torch/`` (the same path) must export every name of the
module's ``__all__`` and define every public class and function at its
top level, each of the same kind (module, class or other callable).  A
``Jax*`` name is looked up as ``Torch*``.  The exceptions are listed
below, each with the reason the port has no such name.
"""

from __future__ import annotations

import ast
import importlib
import inspect
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "pathway_tpu"

# (module, name) -> why the port has no counterpart of that kind
EXCEPTIONS = {
    # a submodule in the port: callers import it for the kernel wrappers
    # (pathway_tpu_torch/kvcache/__init__.py), where the JAX package
    # re-exports its function
    ("kvcache", "paged_attention"): "a submodule",
    # the JAX package's quiet fallback (None when no engine can be
    # built); the port raises instead
    ("kvcache.engine", "build_engine"): "no quiet fallback",
    # pads a jax.Array up to a Pallas tile multiple; the CUDA kernels
    # bound their own tiles
    ("ops._tiling", "pad_to"): "Pallas tiling",
    # wrap jax.jit and count XLA's backend compiles; the port has no jit
    # (its programs are registered through obs.profiler.profiled)
    ("obs.profiler", "profiled_jit"): "jax.jit",
    ("obs.profiler", "total_backend_compiles"): "XLA compiles",
    # NamedSharding / PartitionSpec builders of the shard_map mesh; the
    # port's TPMesh shards tensors by hand (parallel/mesh.py)
    **{("parallel.mesh", n): "jax.sharding" for n in (
        "replicated", "batch_sharded", "kv_pool_sharding",
        "ssd_state_sharding", "decoder_param_specs", "param_specs")},
    # "was the library built" for the JAX package's Python fallback; the
    # port raises when the native library does not build
    ("native", "available"): "no quiet fallback",
}
# the Pallas kernels' modules: ported as CUDA C++ (pathway_tpu_torch/
# csrc/) behind ops/attention_cuda.py and ops/knn_cuda.py
PALLAS_MODULES = {"ops.attention_pallas", "ops.knn_pallas"}


def _modules() -> list[str]:
    out = []
    for path in sorted(JAX_PKG.rglob("*.py")):
        rel = path.relative_to(JAX_PKG).with_suffix("")
        parts = [p for p in rel.parts if p != "__init__"]
        name = ".".join(parts)
        if name not in PALLAS_MODULES:
            out.append(name)
    return out


MODULES = _modules()


def _source(module: str) -> ast.Module:
    base = JAX_PKG.joinpath(*module.split(".")) if module else JAX_PKG
    path = base / "__init__.py" if base.is_dir() else base.with_suffix(".py")
    return ast.parse(path.read_text())


def _all_names(tree: ast.Module) -> list[str] | None:
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return list(ast.literal_eval(node.value))
    return None


def _top_level(tree: ast.Module) -> dict[str, str]:
    return {n.name: "class" if isinstance(n, ast.ClassDef) else "callable"
            for n in tree.body
            if isinstance(n, (ast.ClassDef, ast.FunctionDef,
                              ast.AsyncFunctionDef))
            and not n.name.startswith("_")}


def _kind(obj) -> str:
    if inspect.ismodule(obj):
        return "module"
    if inspect.isclass(obj):
        return "class"
    return "callable" if callable(obj) else "value"


def _port(module: str):
    return importlib.import_module(
        "pathway_tpu_torch" + (f".{module}" if module else ""))


def _missing(module: str, wanted: dict[str, str | None]) -> list[str]:
    """The names of ``wanted`` (name -> the JAX kind, or None to take it
    from the JAX module) that the port's module lacks or holds as
    another kind, exceptions aside."""
    port = _port(module)
    jax_mod = None
    out = []
    for name, kind in wanted.items():
        if (module, name) in EXCEPTIONS:
            continue
        if kind is None:
            jax_mod = jax_mod or importlib.import_module(
                "pathway_tpu" + (f".{module}" if module else ""))
            kind = _kind(getattr(jax_mod, name))
        ported = ("Torch" + name[3:]) if name.startswith("Jax") else name
        if not hasattr(port, ported):
            out.append(f"{ported}: absent")
        elif _kind(getattr(port, ported)) != kind:
            out.append(f"{ported}: a {_kind(getattr(port, ported))}, "
                       f"not a {kind}")
    return out


@pytest.mark.parametrize("module", MODULES)
def test_the_port_exports_every_name_of_the_jax_all(module):
    names = _all_names(_source(module))
    if names is None:
        return  # no __all__: the top-level test below covers the module
    assert _missing(module, dict.fromkeys(names)) == []


@pytest.mark.parametrize("module", MODULES)
def test_the_port_defines_every_public_top_level_class_and_function(module):
    assert _missing(module, _top_level(_source(module))) == []


def test_every_exception_is_still_needed():
    """An exception whose name the port now has (of the JAX kind) goes."""
    for module, name in EXCEPTIONS:
        port = _port(module)
        jax_mod = importlib.import_module(f"pathway_tpu.{module}")
        assert not (hasattr(port, name) and _kind(getattr(port, name))
                    == _kind(getattr(jax_mod, name))), (module, name)
    for module in PALLAS_MODULES:
        assert not (ROOT / "pathway_tpu_torch").joinpath(
            *module.split(".")).with_suffix(".py").exists()
