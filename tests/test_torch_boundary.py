"""Import boundary of the port: ``src/repro_torch`` and ``chip_smoke.py``
never import ``jax`` or the reference package (only the tests import
both), and no kernel wrapper catches a failure to fall back to its plain
version."""
import ast
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)


def test_sources_found():
    assert len(SOURCES) > 20 and (REPO / "chip_smoke.py").exists()


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(REPO)) for p in SOURCES])
def test_no_jax_or_reference_imports(path):
    text = path.read_text()
    assert not FORBIDDEN.search(text), FORBIDDEN.search(text).group(0)
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), name


@pytest.mark.parametrize("path", sorted((PORT / "kernels").glob("*.py")),
                         ids=lambda p: p.name)
def test_kernel_wrappers_never_fall_back(path):
    """A CUDA tensor launches the kernel or raises: no ``try`` anywhere in
    the kernel layer could swallow a failure into the plain path."""
    tree = ast.parse(path.read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
