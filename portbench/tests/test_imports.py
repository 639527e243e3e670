"""No module of the benchmark imports JAX, the JAX package or the
program's benchmarks, and the reference imports nothing of the program.
Module names are compared by their whole top-level name, so
``cdrs_tpu_torch`` is not ``cdrs_tpu``."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

from portbench import run

PKG = Path(__file__).resolve().parents[1]
SOURCES = sorted(p for p in PKG.rglob("*.py") if p.relative_to(PKG).parts[0] != "out")
#: The reference and what it imports: nothing of the program.
REFERENCE = ("reference.py", "keyed.py")


def imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_and_no_program_benchmarks(path):
    for name in imported(path):
        assert name.split(".")[0] not in run.FORBIDDEN, name
        assert not name.startswith("cdrs_tpu_torch.benchmarks"), name
        assert name not in ("bench", "chip_smoke"), name


@pytest.mark.parametrize("name", REFERENCE)
def test_the_reference_imports_nothing_of_the_program(name):
    assert not any(n.split(".")[0] == "cdrs_tpu_torch" for n in imported(PKG / name))


def test_forbidden_names_compare_whole():
    assert run.forbidden_modules(["cdrs_tpu_torch.ops.kmeans", "numpy", "jaxtyping"]) == []
    assert run.forbidden_modules(["cdrs_tpu.ops", "jaxlib.xla", "flax"]) == [
        "cdrs_tpu", "flax", "jaxlib"]
