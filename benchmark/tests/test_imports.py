"""No module of the benchmark imports JAX or the JAX package (compared by
the whole top-level name: the port's name begins with the JAX
package's), and no reference imports the port."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "pathway_tpu"}


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


MODULES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not (_imports(path) & FORBIDDEN)


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_stands_alone(path):
    assert "pathway_tpu_torch" not in _imports(path)


def test_the_check_compares_whole_names():
    src = "import pathway_tpu_torch.models\nfrom pathway_tpu import x\n"
    tmp = ast.parse(src)
    tops = {n.names[0].name.split(".")[0] if isinstance(n, ast.Import)
            else n.module.split(".")[0] for n in tmp.body}
    assert tops & FORBIDDEN == {"pathway_tpu"}
