"""The plain reference against the analytic oscillator free energies, and
the float32 control against the float64 reference."""

import numpy as np
import pytest
import torch

from portbench import data, reference

CONFIG = {"system": "harmonic_oscillators", "dtype": "float64", "K": 5, "samples_per_state": 4000,
          "O": [0.0, 5.0], "K_f": [1.0, 3.0]}


@pytest.fixture(scope="module")
def problem():
    torch.set_num_threads(1)
    u, N_k = data.oscillators(CONFIG, 2**31 + 11, "cpu")
    f, iterations = reference.solve(u, N_k)
    return u, N_k, f, iterations


def test_generator_is_the_seeds_alone():
    a = data.oscillators(CONFIG, 7, "cpu")[0]
    b = data.oscillators(CONFIG, 7, "cpu")[0]
    c = data.oscillators(CONFIG, 8, "cpu")[0]
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (5, 5 * 4000) and a.dtype == torch.float64


def test_solve_meets_the_analytic_free_energies(problem):
    u, N_k, f, iterations = problem
    sigma = reference.sigma_svd_ew(u, N_k, f)
    fa = data.analytic_free_energies(CONFIG)
    z = (f - fa)[1:] / sigma[0, 1:]
    assert np.all(np.abs(z) < 6), z
    assert 1 < iterations < 20


def test_solve_zeroes_the_gradient(problem):
    u, N_k, f, _ = problem
    w = torch.as_tensor(f)[:, None] + np.log(N_k[0]) - u
    w = torch.softmax(w, dim=0)
    assert (w.sum(dim=1) - N_k[0]).abs().max() < 1e-9


def test_sigma_matches_the_dense_formula(problem):
    u, N_k, f, _ = problem
    a = torch.as_tensor(f)[:, None] - u
    W = torch.exp(a - torch.logsumexp(a + np.log(N_k[0]), dim=0)).T.numpy()
    S, V = np.linalg.eigh(W.T @ W)
    Sig = np.diag(np.sqrt(np.clip(S, 0, None)))
    inner = np.eye(5) - Sig @ V.T @ np.diag(N_k) @ V @ Sig
    theta = V @ Sig @ np.linalg.pinv(inner, rcond=1e-10) @ Sig @ V.T
    d2 = np.diag(theta)[:, None] + np.diag(theta)[None, :] - 2 * theta
    dense = np.sqrt(np.clip(d2, 0, None))
    assert np.abs(reference.sigma_svd_ew(u, N_k, f) - dense).max() < 1e-12


def test_float32_control_departs_from_float64(problem):
    u, N_k, f, _ = problem
    f32, _ = reference.solve(u, N_k, dtype=torch.float32)
    assert 1e-8 < np.abs(f32 - f).max() < 1e-3


def test_bootstrap_sigma_of_one_replicate_set(problem):
    u, N_k, f, _ = problem
    rng = np.random.default_rng(3)
    counts = np.stack([np.concatenate([np.bincount(rng.integers(4000, size=4000), minlength=4000)
                                       for _ in range(5)]) for _ in range(4)])
    sigma, f_boots, iterations = reference.sigma_bootstrap(u, N_k, f, counts)
    assert f_boots.shape == (4, 5) and np.all(f_boots[:, 0] == 0) and iterations < 60
    fb = f_boots
    by_hand = np.std(fb[:, None, :] - fb[:, :, None], axis=0)
    assert np.abs(sigma - by_hand).max() < 1e-14
    # each replicate is the Newton solution of its own weighted problem
    for b in range(4):
        f_b, _ = reference.solve(u, N_k, counts=counts[b], f_init=f)
        assert np.abs(f_boots[b] - f_b).max() < 1e-12
    # the unit counts solve the original problem
    f1, _ = reference.solve(u, N_k, counts=np.ones(u.shape[1]), f_init=f)
    assert np.abs(f1 - f).max() < 1e-12
