"""The port stands alone: no module of ``tpu_ddp_torch`` and not
``chip_smoke.py`` imports JAX, Flax, optax, orbax or the JAX package."""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "tpu_ddp"}
FILES = sorted((ROOT / "tpu_ddp_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_port_files_exist():
    assert (ROOT / "chip_smoke.py").is_file()
    assert len(FILES) > 10


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


PORT_TESTS = sorted((ROOT / "tests").glob("test_torch_*.py"))


def _first_import(path: Path):
    """The first import statement of ``path`` after its docstring and any
    ``from __future__`` line."""
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, ast.ImportFrom) and node.module == "__future__":
            continue
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            return node
    return None


@pytest.mark.parametrize("path", PORT_TESTS, ids=lambda p: p.name)
def test_port_tests_cap_torch_threads_first(path):
    """Every port test file imports ``tests/torch_threads.py`` before
    anything else: one torch thread a process, spawned ranks included."""
    node = _first_import(path)
    assert isinstance(node, ast.Import) and [a.name for a in node.names] == ["torch_threads"], (
        f"{path.name} must import torch_threads first")
