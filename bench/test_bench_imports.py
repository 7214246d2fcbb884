"""No module of the benchmark imports JAX or the JAX package, and the
references import nothing of the served program (top-level names compared
whole: the port's name begins with the JAX package's)."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
FILES = sorted(BENCH.rglob("*.py"))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert not set(_imports(path)) & {"jax", "jaxlib", "flax", "repro"}
    if path.parent.name == "reference":
        assert "repro_torch" not in set(_imports(path))


def test_forbidden_modules_compares_whole_names():
    from bench import harness
    names = ["repro_torch.launch.serve", "reproducer", "torch", "repro",
             "repro.core", "jax", "jaxlib.xla_client", "flax.linen"]
    assert harness.forbidden_modules(names) == [
        "flax.linen", "jax", "jaxlib.xla_client", "repro", "repro.core"]
