"""Nothing under benchmark/ imports JAX or the JAX package, and the
reference imports nothing of the port."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "optax", "orbax",
       "fine_grained_gaussian_process_forcasting_tpu"}
PORT = "fine_grained_gaussian_process_forcasting_torch"


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


FILES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax(path):
    assert not _imports(path) & JAX


def test_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        assert PORT not in _imports(path), path


def test_names_compared_whole():
    """The port's name begins with the JAX package's stem: the scan
    compares whole top-level names."""
    assert PORT not in JAX and _imports(BENCH / "harness" / "program.py") \
        == {"__future__", "math", "torch", PORT}
