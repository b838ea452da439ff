"""pymbar_tpu_torch.mbar_solvers, the alias of the reference's
``pymbar.mbar_solvers`` surface, against pymbar_tpu.mbar_solvers
(tests/test_checkpoint.py:45-63)."""

import numpy as np
import pytest
import torch

import pymbar_tpu_torch
from pymbar_tpu import mbar_solvers as jms
from pymbar_tpu_torch import mbar_solvers
from pymbar_tpu_torch import solvers as ts
from pymbar_tpu_torch.ops import mbar_core

# one intra-op thread per test process: the suite's workers share the CPUs
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu_default(monkeypatch):
    """Numpy into the solver entry points goes to the process default device
    (the card unless named): these tests ask for the CPU."""
    monkeypatch.setenv("PYMBAR_TPU_TORCH_DEVICE", "cpu")


def test_names_match_jax():
    assert mbar_solvers.__all__ == jms.__all__
    for name in mbar_solvers.__all__:
        assert hasattr(mbar_solvers, name), name
        home = ts if hasattr(ts, name) else mbar_core
        assert getattr(mbar_solvers, name) is getattr(home, name)
    assert mbar_solvers.DEFAULT_SOLVER_PROTOCOL == jms.DEFAULT_SOLVER_PROTOCOL
    assert mbar_solvers.scipy_minimize_options == jms.scipy_minimize_options


def test_gradient_vanishes_at_the_solution():
    tc = pymbar_tpu_torch.testsystems.HarmonicOscillatorsTestCase(
        O_k=[0, 1, 2, 3, 4], K_k=[1, 2, 4, 8, 16]
    )
    _x, u_kn, N_k, _s = tc.sample(N_k=[100, 100, 0, 100, 100], mode="u_kn", seed=1)
    m = pymbar_tpu_torch.MBAR(u_kn, N_k, device="cpu")
    g = mbar_solvers.mbar_gradient(torch.from_numpy(u_kn), np.asarray(N_k, float), m.f_k)
    assert float(torch.linalg.norm(g)) < 1e-6


PRIMITIVES = ["mbar_gradient", "mbar_objective", "mbar_objective_and_gradient",
              "self_consistent_update", "mbar_log_W_nk", "mbar_W_nk", "mbar_hessian",
              "precondition_u_kn"]


@pytest.mark.parametrize("name", PRIMITIVES)
def test_primitives_take_numpy_like_jax(name):
    """Each solver primitive takes numpy u_kn, N_k and f_k, as the JAX
    package's does, and returns its values to 1e-12 (relative where a value
    exceeds 1)."""
    rng = np.random.default_rng(3)
    u = rng.normal(size=(3, 150)) ** 2
    N_k = np.array([50, 50, 50])
    f_k = np.array([0.0, 0.3, -0.2])
    ours = getattr(mbar_solvers, name)(u, N_k, f_k)
    ref = getattr(jms, name)(u, N_k.astype(float), f_k)
    pairs = zip(ours, ref) if isinstance(ours, tuple) else [(ours, ref)]
    for a, b in pairs:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        assert np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)) <= 1e-12


def test_solve_mbar_for_all_states_returns_f_k_like_jax():
    u, N_k = _oscillators_with_an_empty_state()
    sws = np.where(N_k > 0)[0]
    f = mbar_solvers.solve_mbar_for_all_states(u, N_k, np.zeros(len(N_k)), sws, None)
    f_jax = jms.solve_mbar_for_all_states(u, N_k, np.zeros(len(N_k)), sws, None)
    assert isinstance(f, np.ndarray) and f.shape == np.asarray(f_jax).shape
    assert np.max(np.abs(f - np.asarray(f_jax))) < 1e-10


def _oscillators_with_an_empty_state():
    tc = pymbar_tpu_torch.testsystems.HarmonicOscillatorsTestCase(
        O_k=[0, 1, 2, 3], K_k=[1, 2, 4, 8]
    )
    _x, u_kn, N_k, _s = tc.sample(N_k=[200, 200, 0, 200], mode="u_kn", seed=2)
    return u_kn, np.asarray(N_k)
