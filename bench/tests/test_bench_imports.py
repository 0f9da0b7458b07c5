"""Nothing under bench/ imports JAX or the JAX package (top-level module
names compared whole: ``repro_torch`` is not ``repro``), and the yardstick
(reference, roofline, data, trace reading) imports nothing of the
program."""
import ast

import pytest

from _bench_helpers import ROOT

BENCH = ROOT / "bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
YARDSTICK = ("reference.py", "roofline.py", "datagen.py")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_reference_package(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("name", YARDSTICK)
def test_yardstick_imports_nothing_of_the_program(name):
    assert "repro_torch" not in set(_imports(BENCH / name))
