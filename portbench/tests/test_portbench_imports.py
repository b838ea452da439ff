"""No JAX and no JAX package: the check by whole top-level name, and the
imports of the benchmark's own sources."""

import ast
from pathlib import Path

from portbench import harness

HERE = Path(__file__).resolve().parent.parent
# The yardstick takes nothing of the program.
YARDSTICK = ("reference.py", "data.py", "checks.py", "roofline.py", "tracing.py", "cells.py")


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_check_compares_whole_top_level_names():
    assert harness.forbidden_modules(["pymbar_tpu_torch", "pymbar_tpu_torch.mbar", "numpy"]) == []
    assert harness.forbidden_modules(["pymbar_tpu.mbar"]) == ["pymbar_tpu"]
    assert harness.forbidden_modules(["jax.numpy", "jaxlib", "flax.linen"]) == ["flax", "jax", "jaxlib"]
    assert harness.forbidden_modules(["jaxtyping", "pymbar_tpu_x"]) == []


def test_no_source_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        assert not _imports(path) & set(harness.FORBIDDEN), path


def test_the_yardstick_imports_nothing_of_the_program():
    for name in YARDSTICK:
        assert "pymbar_tpu_torch" not in _imports(HERE / name), name
    for path in (HERE / "metrics").glob("*.py"):
        assert "pymbar_tpu_torch" not in _imports(path), path


def test_a_run_loads_no_forbidden_module(monkeypatch):
    from portbench.tests import tiny

    tiny.run(monkeypatch, "osc1024.bootstrap64", trace=1)
    assert harness.forbidden_modules() == []
