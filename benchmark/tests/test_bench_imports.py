"""No benchmark module imports JAX, flax, optax or the JAX package, and the
reference imports nothing of the port; names are compared whole, by their
top-level part, since the port's name begins with the JAX package's."""

import ast
from pathlib import Path

import pytest

from benchmark.harness import BANNED, HERE

PORT = "active_3d_vision_and_touch_tpu_torch"
FILES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: Path) -> set[str]:
    found = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            found |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            found.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                found.add(str(node.args[0].value).split(".")[0])
    return found


def test_the_check_compares_whole_names():
    assert PORT not in BANNED and PORT.startswith("active_3d_vision_and_touch_tpu")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & set(BANNED)


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in top_level_imports(path)
    assert top_level_imports(path) <= {"__future__", "math", "numpy", "torch", "benchmark"}


def test_reference_takes_only_benchmark_modules_of_its_own():
    for path in (HERE / "reference").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("benchmark"):
                assert node.module.startswith("benchmark.reference"), (path, node.module)
