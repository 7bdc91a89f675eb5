"""Nothing under ``portbench/`` imports JAX or the JAX package, and the
plain reference imports nothing of the measured package."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "qat_vit_tpu"}


def imported(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_by_whole_top_level_name(path):
    tops = {m.split(".")[0] for m in imported(path)}
    assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in imported(path)}
    assert "qat_vit_tpu_torch" not in tops
    assert tops <= {"__future__", "dataclasses", "math", "statistics", "typing", "numpy",
                    "torch", "portbench"}, tops
    for m in imported(path):
        if m.startswith("portbench"):
            assert m.startswith("portbench.reference"), m


def test_the_port_name_is_not_the_jax_package():
    # compared whole: the port's name begins with the JAX package's
    assert "qat_vit_tpu_torch".split(".")[0] not in FORBIDDEN
