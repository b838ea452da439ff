"""MBAR's diagnostics in pymbar_tpu_torch against pymbar_tpu on the CPU.

The weights (``Log_W_nk``, ``W_nk``, ``weights()``), the effective sample
numbers, the overlap, Theta by each covariance method, ``dDelta_f`` with
``uncertainty_method="svd"`` and the BAR initialization.  The same numpy
inputs (harmonic oscillators made from a seed, K <= 5, N <= 1800, state 2
empty) go to both packages; the port runs with ``device="cpu"``.  Both
compute in f64 and differ in summation order and LAPACK path only, so every
comparison holds to 1e-12, absolute and relative to the largest entry
(ROADMAP Queue 1 item 2's gate).
"""

import numpy as np
import pytest
import torch

import pymbar_tpu
import pymbar_tpu_torch
from pymbar_tpu_torch.utils import ParameterError

TOL = 1e-12
N_K = [600, 300, 0, 500, 400]


def _close(ours, ref, tol=TOL):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape
    scale = max(float(np.max(np.abs(ref))), 1.0)
    assert float(np.max(np.abs(ours - ref))) <= tol * scale


def _oscillators(N_k, seed=1, O_k=(0, 1, 2, 3, 4), K_k=(1, 2, 4, 8, 16)):
    tc = pymbar_tpu_torch.testsystems.HarmonicOscillatorsTestCase(O_k=O_k, K_k=K_k)
    _x, u_kn, N_k, _s = tc.sample(N_k=N_k, mode="u_kn", seed=seed)
    return u_kn, N_k


@pytest.fixture(scope="module")
def pair():
    """(u_kn, N_k, port MBAR, JAX MBAR), both started from a BAR chain."""
    u, N_k = _oscillators(N_K)
    ours = pymbar_tpu_torch.MBAR(u, N_k, initialize="BAR", device="cpu")
    ref = pymbar_tpu.MBAR(u, N_k, initialize="BAR")
    return u, N_k, ours, ref


@pytest.mark.parametrize("name", ["Log_W_nk", "W_nk", "weights"])
def test_weights_match_jax(pair, name):
    _u, _N_k, ours, ref = pair
    get = (lambda m: m.weights()) if name == "weights" else (lambda m: getattr(m, name))
    w = get(ours)
    assert isinstance(w, np.ndarray) and w.shape == (ours.N, ours.K)
    _close(w, get(ref))


def test_log_W_nk_is_cached_and_assignable(pair):
    """An assigned Log_W_nk is what W_nk and the 'svd' Theta read, as in the
    JAX package: wrapped around f_k = 0 the weights are not normalized and
    'svd' raises, until the solution's log-weights are assigned."""
    u, N_k, ours, ref = pair
    m = pymbar_tpu_torch.MBAR.from_solution(u, N_k, np.zeros(len(N_k)), device="cpu")
    assert m.Log_W_nk is m.Log_W_nk
    with pytest.raises(ParameterError):
        m.compute_free_energy_differences(uncertainty_method="svd")
    m.Log_W_nk = ref.Log_W_nk
    _close(m.W_nk, np.exp(ref.Log_W_nk), tol=0.0)
    theta = m.compute_free_energy_differences(uncertainty_method="svd", return_theta=True)
    theta_ref = ref.compute_free_energy_differences(uncertainty_method="svd", return_theta=True)
    _close(theta["Theta"], theta_ref["Theta"])


def test_effective_sample_number_matches_jax(pair):
    _u, N_k, ours, ref = pair
    n_eff = ours.compute_effective_sample_number(verbose=True)
    _close(n_eff, ref.compute_effective_sample_number())
    _close(n_eff, 1.0 / np.sum(ours.W_nk**2, axis=0))
    assert np.all(n_eff >= N_k * (1 - 1e-9)) and np.all(n_eff <= ours.N * (1 + 1e-9))


@pytest.mark.parametrize("case", ["empty_state", "identical_states"])
def test_overlap_matches_jax(pair, case):
    """Matrix, spectrum and scalar; identical states give O = 1/K."""
    if case == "empty_state":
        _u, _N_k, ours, ref = pair
    else:
        u, N_k = _oscillators([360] * 5, seed=2, O_k=[0.0] * 5, K_k=[1.0] * 5)
        ours = pymbar_tpu_torch.MBAR(u, N_k, device="cpu")
        ref = pymbar_tpu.MBAR(u, N_k)
    o, o_ref = ours.compute_overlap(), ref.compute_overlap()
    for key in ("matrix", "eigenvalues", "scalar"):
        _close(o[key], o_ref[key])
    _close(o["matrix"].sum(axis=1), np.ones(ours.K))
    if case == "identical_states":
        _close(o["matrix"], np.full((5, 5), 1.0 / 5.0))
        assert abs(o["scalar"] - 1.0) <= TOL
    else:
        assert o["eigenvalues"][-1] == pytest.approx(0.0, abs=TOL)  # the empty state


@pytest.mark.parametrize("method", ["approximate", "svd", "svd-ew"])
def test_theta_matches_jax(pair, method):
    """_computeAsymptoticCovarianceMatrix on the same W (JAX's weights), as a
    numpy array and as a CPU tensor."""
    _u, N_k, ours, ref = pair
    W = np.exp(ref.Log_W_nk)
    theta_ref = np.asarray(ref._computeAsymptoticCovarianceMatrix(W, N_k, method=method))
    _close(ours._computeAsymptoticCovarianceMatrix(W, N_k, method=method), theta_ref)
    _close(ours._computeAsymptoticCovarianceMatrix(torch.from_numpy(W), N_k, method=method),
           theta_ref)


def test_theta_rejects_bad_weights(pair):
    _u, N_k, ours, ref = pair
    W = np.exp(ref.Log_W_nk)
    for bad in (W[:, :-1], W[:-1], 2.0 * W):
        with pytest.raises(ParameterError):
            ours._computeAsymptoticCovarianceMatrix(bad, N_k, method="svd")
    with pytest.raises(ParameterError):
        ours._computeAsymptoticCovarianceMatrix(W, N_k, method="nope")


def test_svd_free_energy_differences_match_jax(pair):
    """dDelta_f and Theta by 'svd' at 1e-12 against JAX, and 'svd' against
    'svd-ew' at the JAX suite's bar (tests/test_covariance.py:43-44)."""
    _u, _N_k, ours, ref = pair
    res = ours.compute_free_energy_differences(uncertainty_method="svd", return_theta=True)
    res_ref = ref.compute_free_energy_differences(uncertainty_method="svd", return_theta=True)
    for key in ("Delta_f", "dDelta_f", "Theta"):
        _close(res[key], res_ref[key])
    ew = ours.compute_free_energy_differences(uncertainty_method="svd-ew")
    np.testing.assert_almost_equal(res["dDelta_f"], ew["dDelta_f"], decimal=8)


def test_bar_initialization_matches_jax(pair):
    """The BAR chain's f_k before the solve and the solved f_k; the chain
    skips the empty state, so its f_k stays 0."""
    u, _N_k, ours, ref = pair
    f0 = ours._initialize_with_bar(torch.from_numpy(u))
    f0_ref = ref._initialize_with_bar(u)
    _close(f0, f0_ref)
    assert f0[2] == 0.0
    _close(ours.f_k, ref.f_k)


def test_bar_initialization_with_permuted_samples_and_bootstraps():
    """Samples out of state order (x_kindices) and sequential bootstrap
    replicates each restarted from a BAR chain on their own columns: the
    same rseed gives JAX's replicates (1e-9, as tests/test_torch_bootstrap.py)."""
    u, N_k = _oscillators(N_K, seed=6)
    perm = np.random.default_rng(2).permutation(u.shape[1])
    x_kindices = np.repeat(np.arange(5), N_k)[perm]
    kw = dict(x_kindices=x_kindices, initialize="BAR", n_bootstraps=2, rseed=4)
    ours = pymbar_tpu_torch.MBAR(u[:, perm], N_k, device="cpu", **kw)
    ref = pymbar_tpu.MBAR(u[:, perm], N_k, **kw)
    _close(ours._initialize_with_bar(ours.u_kn), ref._initialize_with_bar(u[:, perm]))
    assert ours.bootstrap_at_floor is None
    assert np.max(np.abs(ours.f_k_boots - np.asarray(ref.f_k_boots))) <= 1e-9
