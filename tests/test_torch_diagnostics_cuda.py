"""MBAR's diagnostics on the card against the same calls on the CPU.

Needs an NVIDIA card (marker ``cuda``); skips without one.  Imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_diagnostics_cuda.py

One solution f_k (the CPU solve) is wrapped around the same u_kn on both
devices (``MBAR.from_solution``), so only the diagnostics differ: the
log-weights, N_eff, the overlap and the 'svd' Theta (a Householder QR and
an SVD of R by cuSOLVER against LAPACK) all within 1e-12, absolute and
relative to the largest entry.
"""

import numpy as np
import pytest
import torch

import pymbar_tpu_torch

pytestmark = pytest.mark.cuda

TOL = 1e-12


def _close(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape
    assert float(np.max(np.abs(ours - ref))) <= TOL * max(float(np.max(np.abs(ref))), 1.0)


@pytest.fixture(scope="module")
def pair():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tc = pymbar_tpu_torch.testsystems.HarmonicOscillatorsTestCase(
        O_k=[0, 1, 2, 3, 4], K_k=[1, 2, 4, 8, 16]
    )
    _x, u_kn, N_k, _s = tc.sample(N_k=[600, 300, 0, 500, 400], mode="u_kn", seed=1)
    cpu = pymbar_tpu_torch.MBAR(u_kn, N_k, device="cpu")
    card = pymbar_tpu_torch.MBAR.from_solution(u_kn, N_k, cpu.f_k, device="cuda")
    assert card.u_kn.is_cuda
    return card, cpu


def test_log_W_nk_on_the_card_matches_the_cpu(pair):
    card, cpu = pair
    _close(card.Log_W_nk, cpu.Log_W_nk)
    _close(card.W_nk, cpu.W_nk)


def test_effective_sample_number_on_the_card_matches_the_cpu(pair):
    card, cpu = pair
    _close(card.compute_effective_sample_number(), cpu.compute_effective_sample_number())


def test_overlap_on_the_card_matches_the_cpu(pair):
    card, cpu = pair
    o, o_cpu = card.compute_overlap(), cpu.compute_overlap()
    for key in ("matrix", "eigenvalues", "scalar"):
        _close(o[key], o_cpu[key])


@pytest.mark.parametrize("method", ["svd", "svd-ew", "approximate"])
def test_theta_on_the_card_matches_the_cpu(pair, method):
    card, cpu = pair
    res = card.compute_free_energy_differences(uncertainty_method=method, return_theta=True)
    res_cpu = cpu.compute_free_energy_differences(uncertainty_method=method, return_theta=True)
    for key in ("Theta", "dDelta_f"):
        _close(res[key], res_cpu[key])
