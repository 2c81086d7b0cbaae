"""What the benchmark's modules import: never JAX or the JAX package, and
the yardstick (reference, traffic) nothing of the program. Top-level
names, the part before the first dot, are compared whole: the program's
name begins with the JAX package's."""

import ast
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "clipper_tpu"}
YARDSTICK = sorted((BENCH_DIR / "reference").glob("*.py")) + sorted(
    (BENCH_DIR / "traffic").glob("*.py"))
ALL = sorted(p for p in BENCH_DIR.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", ALL, ids=lambda p: str(
    p.relative_to(BENCH_DIR)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", YARDSTICK, ids=lambda p: str(
    p.relative_to(BENCH_DIR)))
def test_yardstick_takes_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert "clipper_tpu_torch" not in names
    assert names <= {"__future__", "bisect", "dataclasses", "json", "math",
                     "struct", "pathlib", "typing", "concurrent", "numpy",
                     "scipy", "torch", "benchmark"}


def test_whole_name_comparison():
    """clipper_tpu_torch is not clipper_tpu: the check compares whole
    top-level names."""
    assert "clipper_tpu_torch".split(".")[0] not in FORBIDDEN
