"""pw.load_yaml — YAML template DSL (the port of ``pathway_tpu``'s;
reference: internals/yaml_loader.py:74-232).

Supports `$ref` variables and `!pw.<path>` object instantiation tags so the
RAG app templates can be expressed declaratively.
"""

from __future__ import annotations

import importlib
from typing import Any


def _resolve_symbol(path: str):
    if path.startswith("pw."):
        mod = importlib.import_module("pathway_tpu_torch")
        obj: Any = mod
        import types

        for part in path[3:].split("."):
            try:
                obj = getattr(obj, part)
            except AttributeError:
                # lazily-loaded subpackage (e.g. pw.xpacks.llm.*); only
                # modules can have importable children — a missing attribute
                # on a class/function is the user's typo, keep that error
                if not isinstance(obj, types.ModuleType):
                    raise
                obj = importlib.import_module(f"{obj.__name__}.{part}")
        return obj
    parts = path.split(".")
    for i in range(len(parts), 0, -1):
        try:
            mod = importlib.import_module(".".join(parts[:i]))
        except ImportError:
            continue
        obj = mod
        for part in parts[i:]:
            obj = getattr(obj, part)
        return obj
    raise ImportError(f"cannot resolve {path!r}")


def _instantiate(node: Any, variables: dict[str, Any]) -> Any:
    if isinstance(node, dict):
        if len(node) == 1:
            (key, value), = node.items()
            if isinstance(key, str) and key.startswith("!"):
                cls = _resolve_symbol(key[1:])
                kwargs = _instantiate(value, variables) if value else {}
                if isinstance(kwargs, dict):
                    return cls(**kwargs)
                return cls(kwargs)
        return {k: _instantiate(v, variables) for k, v in node.items()}
    if isinstance(node, list):
        return [_instantiate(v, variables) for v in node]
    if isinstance(node, str):
        if node.startswith("$"):
            name = node[1:]
            if name in variables:
                return variables[name]
            import os

            env = os.environ.get(name)
            if env is not None:
                return env
            raise KeyError(f"unresolved variable ${name}")
    return node


def load_yaml(source, **variables: Any) -> Any:
    try:
        import yaml
    except ImportError as exc:  # pragma: no cover
        raise ImportError("pyyaml is required for load_yaml") from exc

    if hasattr(source, "read"):
        text = source.read()
    else:
        text = source

    class Loader(yaml.SafeLoader):
        pass

    def unknown(loader, suffix, node):
        if isinstance(node, yaml.MappingNode):
            return {f"!{suffix}": loader.construct_mapping(node, deep=True)}
        if isinstance(node, yaml.ScalarNode):
            v = loader.construct_scalar(node)
            return {f"!{suffix}": v if v != "" else None}
        return {f"!{suffix}": loader.construct_sequence(node, deep=True)}

    yaml.add_multi_constructor("!", unknown, Loader)
    data = yaml.load(text, Loader)

    # two-pass: collect top-level simple variables first
    if isinstance(data, dict):
        for k, v in list(data.items()):
            if k.startswith("$"):
                variables.setdefault(k[1:], _instantiate(v, variables))
                del data[k]
    return _instantiate(data, variables)
