"""The rest of MBAR on the card against the same calls on the CPU.

Needs an NVIDIA card (marker ``cuda``); skips without one.  Imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_expectations_cuda.py

One solution (the CPU solve, with its bootstrap replicates) is given to the
object on each device, so only the expectation machinery differs: every
public call, on both branches (``_AUG_STREAM_BYTES`` = 0: streamed; 2**62:
materializing), under each uncertainty method.  Values within 1e-12 and
uncertainties within 1e-10, absolute and relative to the largest entry; a
CUDA Theta comes from the rank-nnz form, a CPU one from the dense host path.
"""

import numpy as np
import pytest
import torch

import pymbar_tpu_torch
import pymbar_tpu_torch.mbar as tmbar
from pymbar_tpu_torch import checkpoint

pytestmark = pytest.mark.cuda

VALUE_KEYS = {"mu", "f", "observables", "Delta_f", "Delta_u", "Delta_s", "Amin"}


def _close(ours, ref, key):
    tol = 1e-12 if key in VALUE_KEYS else 1e-10
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, key
    scale = max(float(np.max(np.abs(ref))), 1.0) if ref.size else 1.0
    assert float(np.max(np.abs(ours - ref), initial=0.0)) <= tol * scale, key


@pytest.fixture(scope="module")
def pair():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tc = pymbar_tpu_torch.testsystems.HarmonicOscillatorsTestCase()
    x, u, N_k, _s = tc.sample(N_k=[600, 300, 0, 500, 400], mode="u_kn", seed=1)
    cpu = pymbar_tpu_torch.MBAR(u, N_k, n_bootstraps=4, rseed=3, device="cpu")
    card = pymbar_tpu_torch.MBAR(u, N_k, n_bootstraps=4, rseed=3, device="cuda")
    assert card.u_kn.is_cuda
    card.f_k, card.f_k_boots = cpu.f_k.copy(), cpu.f_k_boots.copy()
    np.testing.assert_array_equal(card.bootstrap_rints, cpu.bootstrap_rints)
    return x, u, card, cpu


CALLS = {
    "averages": lambda m, x, u, meth: m.compute_expectations(x, uncertainty_method=meth,
                                                             return_theta=True),
    "differences": lambda m, x, u, meth: m.compute_expectations(x, output="differences",
                                                                uncertainty_method=meth),
    "state_dependent": lambda m, x, u, meth: m.compute_expectations(u, state_dependent=True,
                                                                    uncertainty_method=meth),
    "multiple": lambda m, x, u, meth: m.compute_multiple_expectations(
        np.vstack([x, x**2]), u[3], compute_covariance=True, uncertainty_method=meth),
    "perturbed": lambda m, x, u, meth: m.compute_perturbed_free_energies(
        np.vstack([u[0], 1.5 * (x - 0.5) ** 2]), uncertainty_method=meth),
    "entropy": lambda m, x, u, meth: m.compute_entropy_and_enthalpy(uncertainty_method=meth),
}


@pytest.mark.parametrize("call", list(CALLS))
@pytest.mark.parametrize("method", [None, "approximate", "svd", "bootstrap"])
@pytest.mark.parametrize("branch", [0, 2**62])
def test_card_matches_cpu(pair, monkeypatch, branch, method, call):
    x, u, card, cpu = pair
    monkeypatch.setattr(tmbar, "_AUG_STREAM_BYTES", branch)
    res = CALLS[call](card, x, u, method)
    res_cpu = CALLS[call](cpu, x, u, method)
    assert set(res) == set(res_cpu)
    for key in res_cpu:
        _close(res[key], res_cpu[key], key)


def test_card_observables_as_tensors(pair, monkeypatch):
    """Observables and perturbed potentials given as CUDA tensors."""
    x, u, card, cpu = pair
    monkeypatch.setattr(tmbar, "_AUG_STREAM_BYTES", 0)
    xt, ut = torch.as_tensor(x, device="cuda"), torch.as_tensor(u, device="cuda")
    for res, res_cpu in (
        (card.compute_expectations(xt), cpu.compute_expectations(x)),
        (card.compute_multiple_expectations(torch.stack([xt, xt**2]), ut[3]),
         cpu.compute_multiple_expectations(np.vstack([x, x**2]), u[3])),
        (card.compute_perturbed_free_energies(ut[:2] + 0.3),
         cpu.compute_perturbed_free_energies(u[:2] + 0.3)),
    ):
        for key in res_cpu:
            _close(res[key], res_cpu[key], key)


def test_resume_on_the_card(pair, tmp_path):
    x, u, card, cpu = pair
    path = tmp_path / "ck.npz"
    checkpoint.save_mbar(card, path)
    m = checkpoint.resume_mbar(path, card.u_kn, skip_solve=True)
    assert m.u_kn.data_ptr() == card.u_kn.data_ptr()
    np.testing.assert_array_equal(m.f_k, card.f_k)
    m2 = checkpoint.resume_mbar(path, u)
    assert m2.u_kn.is_cuda
    np.testing.assert_allclose(m2.f_k, card.f_k, atol=1e-9)
