"""The port's documentation runs, on the CPU (``PYMBAR_TPU_TORCH_DEVICE=cpu``):
the counterparts of ``tests/test_docs.py``'s gates for pymbar_tpu_torch.

* every ``>>>`` doctest of the port's counterparts of the ten modules that
  ``tests/test_docs.py`` checks, with no ``device=`` in their text;
* the README's port quickstart (its first python block that imports
  pymbar_tpu_torch), with the JAX quickstart's z checks;
* every python block of ``docs/torch_port.md`` that does not start with
  ``# needs a CUDA card``.
"""

import doctest
import importlib
import os
import re

import numpy as np
import pytest
import torch

# one intra-op thread per test process: the suite's workers share the CPUs
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARD_MARK = "# needs a CUDA card"

DOCTEST_MODULES = [
    "pymbar_tpu_torch.mbar",
    "pymbar_tpu_torch.fes",
    "pymbar_tpu_torch.solvers",
    "pymbar_tpu_torch.testsystems.harmonic_oscillators",
    "pymbar_tpu_torch.testsystems.exponential_distributions",
    "pymbar_tpu_torch.testsystems.gaussian_work",
    "pymbar_tpu_torch.testsystems.timeseries",
    "pymbar_tpu_torch.other_estimators",
    "pymbar_tpu_torch.timeseries",
    "pymbar_tpu_torch.utils",
]


@pytest.fixture(autouse=True)
def _cpu_default(monkeypatch):
    monkeypatch.setenv("PYMBAR_TPU_TORCH_DEVICE", "cpu")


def python_blocks(path):
    with open(os.path.join(REPO, path)) as fh:
        return re.findall(r"```python\n(.*?)```", fh.read(), flags=re.DOTALL)


def page_blocks():
    """(index, block) of docs/torch_port.md's python blocks that run on the CPU."""
    return [(i, b) for i, b in enumerate(python_blocks("docs/torch_port.md"))
            if not b.startswith(CARD_MARK)]


@pytest.mark.parametrize("name", DOCTEST_MODULES)
def test_docstring_doctests(name):
    module = importlib.import_module(name)
    results = doctest.testmod(module, verbose=False, raise_on_error=False)
    assert results.failed == 0, f"{results.failed} doctest failures in {name}"


def test_mbar_doctests_mirror_the_jax_package():
    """The port's ``mbar`` carries one ``>>>`` line for each of the JAX
    package's, none of them naming a device."""
    import pymbar_tpu.mbar
    import pymbar_tpu_torch.fes
    import pymbar_tpu_torch.mbar

    def prompts(mod):
        with open(mod.__file__) as fh:
            return [line.strip() for line in fh if line.strip().startswith(">>>")]

    ours, theirs = prompts(pymbar_tpu_torch.mbar), prompts(pymbar_tpu.mbar)
    assert len(ours) == len(theirs) == 54
    assert ours == [line.replace("pymbar_tpu", "pymbar_tpu_torch") for line in theirs]
    assert not any("device=" in line for line in ours + prompts(pymbar_tpu_torch.fes))


def test_readme_port_quickstart_is_golden():
    """The README's port quickstart runs verbatim and recovers the analytic
    free energies and means within 6 sigma (``tests/test_docs.py``'s
    checks)."""
    blocks = [b for b in python_blocks("README.md") if "pymbar_tpu_torch" in b]
    assert blocks, "README must hold a pymbar_tpu_torch quickstart block"
    ns = {}
    exec(compile(blocks[0], "README-port-quickstart", "exec"), ns)

    tc, results = ns["tc"], ns["results"]
    assert ns["mbar"].device.type == "cpu"
    assert isinstance(results["Delta_f"], np.ndarray)
    fa = tc.analytical_free_energies()
    fa = fa - fa[0]
    z = (results["Delta_f"][0, 1:] - fa[1:]) / results["dDelta_f"][0, 1:]
    assert np.all(np.isfinite(z))
    assert np.max(np.abs(z)) < 6.0, f"quickstart z-scores too large: {z}"

    ex = ns["ex"]
    means = tc.analytical_means()
    assert np.max(np.abs(ex["mu"] - means) / np.maximum(ex["sigma"], 1e-3)) < 6.0


def test_page_marks_its_card_blocks():
    """docs/torch_port.md has blocks for both: the card's solves the
    537 MB problem from the card and from host memory."""
    blocks = python_blocks("docs/torch_port.md")
    card = [b for b in blocks if b.startswith(CARD_MARK)]
    assert len(card) == 1 and page_blocks()
    assert "K, n = 64, 16384" in card[0] and 'device="cuda"' in card[0]


@pytest.mark.parametrize("index, block", page_blocks(), ids=[f"block{i}" for i, _ in page_blocks()])
def test_page_block_runs(index, block):
    exec(compile(block, f"docs/torch_port.md block {index}", "exec"), {})
