"""pymbar_tpu_torch's solvers against pymbar_tpu's, on the CPU.

The same float64 inputs (made with numpy from a seed) go to both packages.
The f64 adaptive solves, and the dd solves (float32 phase + double-word
polish, whose noise floor is ~1e-12 in f, docs/numerics.md), must agree to
1e-10; the float32 phases themselves may differ in rounding.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pymbar_tpu_torch
from helpers import Z_SCALE
from numpy.testing import assert_array_almost_equal
from pymbar_tpu import solvers as js
from pymbar_tpu import solvers_large as jsl
from pymbar_tpu.utils import ParameterError as JaxParameterError
from pymbar_tpu_torch import solvers as ts
from pymbar_tpu_torch import solvers_large as tsl
from pymbar_tpu_torch.utils import ParameterError
from pymbar_tpu_torch.utils_for_testing import oscillators

# one intra-op thread per test process: the suite's workers share the CPUs
torch.set_num_threads(1)


def _oscillators(K, npk, seed, O_hi=4.0):
    rng = np.random.default_rng(seed)
    O = np.linspace(0.0, O_hi, K)
    Kf = np.linspace(1.0, 3.0, K)
    N_k = np.full(K, npk)
    x = np.concatenate([rng.normal(o, 1.0 / np.sqrt(s), n) for o, s, n in zip(O, Kf, N_k)])
    u = 0.5 * Kf[:, None] * (x[None, :] - O[:, None]) ** 2
    return u, N_k


@pytest.fixture(scope="module")
def small():
    return _oscillators(8, 200, seed=3)


@pytest.mark.parametrize("method", ["adaptive", "hybr"])
def test_solve_mbar_once_matches_jax(small, method):
    u, N_k = small
    f0 = np.zeros(len(N_k))
    f, res = ts.solve_mbar_once(u, N_k, f0, method=method)
    f_ref, res_ref = js.solve_mbar_once(u, N_k, f0, method=method)
    assert bool(res["success"]) == bool(res_ref["success"])
    assert np.max(np.abs(f - f_ref)) <= 1e-10


def test_adaptive_matches_jax(small):
    u, N_k = small
    f0 = np.zeros(len(N_k))
    res = ts.adaptive(torch.from_numpy(u), N_k, f0, tol=1e-12)
    res_ref = js.adaptive(jnp.asarray(u), N_k, f0, tol=1e-12)
    assert res["success"] and res_ref["success"]
    assert np.max(np.abs(res["x"].numpy() - np.asarray(res_ref["x"]))) <= 1e-10


@pytest.mark.parametrize("delta_mode", ["relative", "mixed"])
def test_convergence_metrics_match_jax(delta_mode):
    rng = np.random.default_rng(0)
    f_new, f_old, f_sci, f_nr = rng.normal(0, 1, (4, 9)) * np.array([1, 1e-9, 1, 1, 1e-3, 1, 1, 1, 1])
    ours = ts.host_adaptive_metrics(f_new, f_old, f_sci, f_nr, 1e-7, delta_mode)
    ref = js._adaptive_metrics(
        *(jnp.asarray(v) for v in (f_new, f_old, f_sci, f_nr)), 1e-7, delta_mode
    )
    np.testing.assert_allclose(ours, [float(r) for r in ref], rtol=1e-15)


def test_solve_mbar_for_all_states_with_empty_state():
    u, N_k = _oscillators(5, 300, seed=9)
    keep = np.concatenate([np.arange(0, 600), np.arange(900, 1500)])  # state 2 unsampled
    u = u[:, keep]
    N_k = np.array([300, 300, 0, 300, 300])
    sws = np.where(N_k > 0)[0]
    prot = ({"method": "adaptive", "options": {}},)
    f, results = ts._solve_mbar_for_all_states(u, N_k, np.zeros(5), sws, prot)
    f_ref = js.solve_mbar_for_all_states(u, N_k, np.zeros(5), sws, prot)
    assert results[0]["success"]
    assert np.max(np.abs(f - f_ref)) <= 1e-10
    # the public name returns f_k alone, as the JAX package's
    f_pub = ts.solve_mbar_for_all_states(u, N_k, np.zeros(5), sws, prot)
    assert isinstance(f_pub, np.ndarray) and np.array_equal(f_pub, f)


@pytest.mark.parametrize("method,tol", [("anderson", 1e-10), ("BFGS", 1e-8)])
def test_anderson_and_bfgs_match_jax(small, method, tol):
    """anderson and the BFGS stage (the torch form of jax.scipy's BFGS,
    which stops on its default gtol 1e-5: the JAX package's tol does not
    reach it) against pymbar_tpu's on the same inputs."""
    u, N_k = small
    f0 = np.zeros(len(N_k))
    f, res = ts.solve_mbar_once(u, N_k, f0, method=method)
    f_ref, res_ref = js.solve_mbar_once(u, N_k, f0, method=method)
    assert bool(res["success"]) == bool(res_ref["success"]) is True
    assert np.max(np.abs(f - np.asarray(f_ref))) <= tol
    assert f[0] == 0.0 and f.shape == (len(N_k),)


@pytest.mark.parametrize("method", ["anderson", "BFGS"])
def test_protocol_reaches_analytic_accuracy(method):
    """tests/test_mbar_solvers.py:105-115 through the port's MBAR: the
    protocol's solve, re-solved warm from it, within |z| < 6 of the
    analytic free energies."""
    _name, u_kn, N_k, _s, test = oscillators(50, 100, provide_test=True, seed=12)
    fa = test.analytical_free_energies()
    fa = fa[1:] - fa[0]
    prot = ({"method": method},)
    m = pymbar_tpu_torch.MBAR(u_kn, N_k, solver_protocol=prot, device="cpu")
    assert m.solver_results[0]["success"]
    m = pymbar_tpu_torch.MBAR(u_kn, N_k, initial_f_k=m.f_k, solver_protocol=prot, device="cpu")
    res = m.compute_free_energy_differences()
    z = (res["Delta_f"][0, 1:] - fa) / res["dDelta_f"][0, 1:]
    assert_array_almost_equal(z / Z_SCALE, np.zeros(len(z)), decimal=0)


def test_bfgs_line_search_pieces_match_jax():
    """The BFGS stage's interpolation steps against jax.scipy's."""
    from jax._src.scipy.optimize import line_search as jls

    args = [(0.0, 1.0, -2.0, 1.0, 0.5, 0.5, 0.6), (0.0, 1.0, -2.0, 0.4, 0.9, 1.0, 3.0)]
    for a in args:
        assert ts._cubicmin(*map(np.float64, a)) == pytest.approx(
            float(jls._cubicmin(*a)), rel=1e-14)
        assert ts._quadmin(*map(np.float64, a[:5])) == pytest.approx(
            float(jls._quadmin(*a[:5])), rel=1e-14)


def test_unknown_method_raises_like_jax(small):
    u, N_k = small
    with pytest.raises(ParameterError):
        ts.solve_mbar_once(u, N_k, np.zeros(len(N_k)), method="nope")
    with pytest.raises(JaxParameterError):
        js.solve_mbar_once(u, N_k, np.zeros(len(N_k)), method="nope")


# -----------------------------------------------------------------------------
# solvers_large
# -----------------------------------------------------------------------------


def test_split_planes_match_jax():
    u, _ = _oscillators(6, 50, seed=4)
    hi, lo = tsl.host_split_planes(u)
    hi_ref, lo_ref = jsl.host_split_planes(u)
    assert np.array_equal(hi, hi_ref) and np.array_equal(lo, lo_ref)
    dh, dl = tsl.dev_split_planes(torch.from_numpy(u))
    assert np.array_equal(dh.numpy(), hi_ref) and np.array_equal(dl.numpy(), lo_ref)


def test_coarse_stride_and_subsample_match_jax():
    big = tsl.COARSE_MIN_ELEMS
    assert big == jsl.COARSE_MIN_ELEMS
    for N_k, n in (([1000, 1000], big - 1), ([976 * 1024] * 4, big), ([64, 10000], big),
                   ([33, 10000], big), ([31, 10000], big)):
        N_k = np.array(N_k)
        assert tsl._coarse_stride(N_k, n) == jsl._coarse_stride(N_k, n)
    idx, counts = tsl._strided_subsample([1000, 64, 130], 16)
    idx_ref, counts_ref = jsl._strided_subsample([1000, 64, 130], 16)
    assert np.array_equal(idx, idx_ref) and np.array_equal(counts, counts_ref)


def _dd_pair(u, N_k, monkeypatch, coarse_min=None, **kw):
    if coarse_min is not None:
        monkeypatch.setattr(tsl, "COARSE_MIN_ELEMS", coarse_min)
        monkeypatch.setattr(jsl, "COARSE_MIN_ELEMS", coarse_min)
    uh, ul = jsl.host_split_planes(u)
    f, info = tsl.solve_mbar_dd(torch.from_numpy(uh), torch.from_numpy(ul), N_k, **kw)
    f_ref, info_ref = jsl.solve_mbar_dd(uh, ul, N_k, **kw)
    return f, info, np.asarray(f_ref), info_ref


@pytest.mark.parametrize(
    "K,npk,coarse_min",
    [(32, 256, None), (6, 640, 2**12), (6, 600, 2**12)],
    ids=["full_plane", "coarse_strided_slice", "coarse_gather"],
)
def test_solve_mbar_dd_matches_jax(monkeypatch, K, npk, coarse_min):
    u, N_k = _oscillators(K, npk, seed=K + npk, O_hi=2.0 if K == 6 else 4.0)
    f, info, f_ref, info_ref = _dd_pair(u, N_k, monkeypatch, coarse_min)
    assert info["converged"] and info_ref["converged"]
    assert (info["f32_coarse_iterations"] > 0) == (coarse_min is not None)
    assert (info_ref["f32_coarse_iterations"] > 0) == (coarse_min is not None)
    assert np.max(np.abs(f - f_ref)) <= 1e-10
    assert info["gnorm"] < 1e-6
    assert len(info["deltas"]) == info["polish_iterations"]


def test_solve_mbar_dd_noise_floor_stop_matches_jax(monkeypatch):
    """A tolerance below the dd floor must end on a noise-floor rule in
    both packages (converged, at_noise_floor)."""
    u, N_k = _oscillators(8, 300, seed=2)
    f, info, f_ref, info_ref = _dd_pair(u, N_k, monkeypatch, tol=1e-18)
    assert info["converged"] and info["at_noise_floor"]
    assert info_ref["converged"] and info_ref["at_noise_floor"]
    assert np.max(np.abs(f - f_ref)) <= 1e-10


def test_solve_mbar_dd_fallback_after_failed_polish(monkeypatch):
    """If the polish off the subsample factor does not converge, the solver
    reruns full-plane float32 adaptive + a fresh factor + the polish."""
    monkeypatch.setattr(tsl, "COARSE_MIN_ELEMS", 2**12)
    real_polish = tsl._polish_loop
    calls = {"n": 0}

    def flaky_polish(*args, **kwargs):
        f, it, g, deltas, converged, floor = real_polish(*args, **kwargs)
        calls["n"] += 1
        return f, it, g, deltas, converged and calls["n"] > 1, floor

    monkeypatch.setattr(tsl, "_polish_loop", flaky_polish)
    u, N_k = _oscillators(6, 600, seed=5, O_hi=2.0)
    uh, ul = tsl.dev_split_planes(torch.from_numpy(u))
    f, info = tsl.solve_mbar_dd(uh, ul, N_k)
    assert calls["n"] == 2, "fallback polish must run"
    assert info["converged"] and info["f32_iterations"] > 0
    monkeypatch.setattr(tsl, "_polish_loop", real_polish)
    f_ref, _ = tsl.solve_mbar_dd(uh, ul, N_k)
    assert np.max(np.abs(f - f_ref)) < 1e-11


def test_polish_stops_on_non_finite_step_without_taking_it():
    K = 4
    N_k64 = torch.full((K,), 10.0, dtype=torch.float64)
    f0 = torch.linspace(0, 0.3, K, dtype=torch.float64)

    def nan_wsum(uh, ul, gh, gl):
        return torch.full((K,), float("nan")), torch.zeros(K)

    f, it, _g, deltas, converged, floor = tsl._polish_loop(
        nan_wsum, None, None, N_k64, f0, torch.eye(K - 1, dtype=torch.float64),
        torch.log(N_k64), 1e-12, 1.0, 5,
    )
    assert it == 1 and not converged and not floor
    assert torch.equal(f, f0) and np.isnan(deltas[0])
