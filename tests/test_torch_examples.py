"""The six synthetic examples (examples/*.py) run unchanged under
pymbar_tpu_torch, on the CPU (``PYMBAR_TPU_TORCH_DEVICE=cpu``), and print
what they print under pymbar_tpu.

Each script is loaded as ``tests/test_examples.py`` loads it and its
``main()`` is called twice: under the JAX package, then with
``sys.modules["pymbar_tpu"]`` pointed at the port.  The text between the
numbers must be the same, and every printed number the same within one
unit of its last printed digit (NaN only where the JAX run prints NaN).
"""

import importlib.util
import os
import re
import sys

import numpy as np
import pytest
import torch

import pymbar_tpu_torch

# one intra-op thread per test process: the suite's workers share the CPUs
torch.set_num_threads(1)

EXAMPLES_DIR = os.path.join(os.path.dirname(__file__), os.pardir, "examples")

EXAMPLES = [
    "harmonic_oscillators.py",
    "alchemical_free_energy.py",
    "heat_capacity.py",
    "umbrella_sampling_fes.py",
    "constant_force_optical_trap.py",
    "parallel_tempering_2dfes.py",
]

# a printed number: decimal or scientific, or nan / inf
NUMBER = re.compile(r"[-+]?(?:nan|inf|(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?)", re.IGNORECASE)


def run_example(name):
    """Load examples/``name`` afresh (its ``from pymbar_tpu import ...``
    binds whatever ``sys.modules`` holds now) and call its ``main()``."""
    path = os.path.join(EXAMPLES_DIR, name)
    spec = importlib.util.spec_from_file_location(f"example_{name[:-3]}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.main()


def last_digit_unit(token):
    """One unit of the last printed digit of a number token."""
    mantissa, _, exponent = token.lower().partition("e")
    decimals = len(mantissa.partition(".")[2])
    return 10.0 ** (int(exponent or 0) - decimals)


def compare_printed(out, ref):
    """Assert ``out`` prints what ``ref`` prints: the same text around the
    numbers, each number within one unit of the last digit either printed
    (and a little float slack), NaN where ``ref`` has NaN."""
    assert NUMBER.sub("#", out) == NUMBER.sub("#", ref), "the printed text differs"
    got, want = NUMBER.findall(out), NUMBER.findall(ref)
    for a, b in zip(got, want):
        x, y = float(a), float(b)
        if np.isnan(y) or np.isnan(x):
            assert np.isnan(x) and np.isnan(y), f"{a} printed where the JAX run prints {b}"
            continue
        if np.isinf(y) or np.isinf(x):
            assert x == y, f"{a} against {b}"
            continue
        unit = max(last_digit_unit(a), last_digit_unit(b))
        assert abs(x - y) <= unit * (1 + 1e-9), f"{a} against {b} (one unit: {unit:g})"


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_matches_jax(name, capsys, monkeypatch):
    run_example(name)
    ref = capsys.readouterr().out
    assert ref.strip(), f"{name} printed nothing under pymbar_tpu"

    monkeypatch.setenv("PYMBAR_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setitem(sys.modules, "pymbar_tpu", pymbar_tpu_torch)
    run_example(name)
    out = capsys.readouterr().out
    compare_printed(out, ref)


def test_compare_printed_rules():
    """The comparison's own rules: one unit of the last digit passes, two
    fail, NaN must meet NaN, and the text must match."""
    compare_printed("f = 1.234 and 5e-3", "f = 1.235 and 6e-3")
    compare_printed("[nan 2.0]", "[nan 2.1]")
    with pytest.raises(AssertionError):
        compare_printed("f = 1.233", "f = 1.235")
    with pytest.raises(AssertionError):
        compare_printed("[nan]", "[1.0]")
    with pytest.raises(AssertionError):
        compare_printed("g = 1.0", "f = 1.0")
