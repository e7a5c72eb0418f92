"""No module of the benchmark imports JAX, Flax or the JAX package, and
the reference imports nothing of the program: top-level names, the part
before the first dot, compared whole (the program's name begins with the
JAX package's)."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

from perfbench.harness import report

BENCH_DIR = Path(__file__).resolve().parent
FILES = sorted(BENCH_DIR.rglob("*.py"))


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_jax(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in top_level_imports(path)


def test_forbidden_modules_compared_whole():
    assert report.forbidden_modules(["repro_torch", "repro_torch.core",
                                     "jaxtyping", "torch"]) == []
    assert report.forbidden_modules(["repro.core", "jax.numpy", "flax",
                                     "repro_torch"]) == ["flax", "jax", "repro"]
    assert isinstance(report.forbidden_modules(), list)
