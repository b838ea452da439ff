"""The port's FES against pymbar_tpu's on the CPU.

Umbrella sampling on a quadratic base surface (K0 = 20) with 7 harmonic
windows (Ku = 100, centres 0.2 * (-3..3)), 300 samples each, made from a
seed with numpy; the same inputs go through ``pymbar_tpu.FES`` and
``pymbar_tpu_torch.FES(..., device="cpu")``.  Every JAX result is computed
once per module (each JAX flow compiles).

* Histogram: f_i under 'from-lowest', 'from-specified' and
  'all-differences' to 1e-9, analytical df_i and df_ij to 1e-8, on both of
  the port's Theta branches: the streamed augmented Gram
  (``mbar._AUG_STREAM_BYTES`` = 0) against the JAX package's
  ``_hist_aug_gram_scan`` path (a device-resident ``jnp`` u_kn), the
  materializing branch (2**62) against its host path; also on 2-D bins.
* Bootstrap (per-replicate route, same ``seed``): histogram and KDE df_i to
  1e-8; the counts route against the per-replicate route to 1e-8.
* KDE under the three reference points (also 2-D), the ML spline
  (Newton-CG and Custom-NR, with AIC/BIC) and the MC chain's confidence
  intervals to 1e-8, the unnormalized log weights to 1e-12.
* The error paths of ``tests/test_fes.py`` raise the same exceptions;
  ``FES`` is exported lazily; numpy input goes to the card unless
  ``device="cpu"``.
"""

import doctest
import importlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pymbar_tpu
import pymbar_tpu_torch
import pymbar_tpu_torch.mbar as tmbar
from pymbar_tpu_torch.utils import ParameterError

# one intra-op thread per test process: the suite's workers share the CPUs
torch.set_num_threads(1)

K0, KU = 20.0, 100.0
CENTERS = 0.2 * np.arange(-3, 4)
EDGES = np.linspace(-0.7, 0.7, 16)
CENT = 0.5 * (EDGES[1:] + EDGES[:-1])
EDGES_2D = [np.linspace(-0.7, 0.7, 6), np.linspace(-1.0, 1.0, 5)]
REFERENCE_POINTS = ["from-lowest", "from-specified", "all-differences"]
BRANCHES = {"streamed": 0, "materialized": 2**62}
SPLINES = ["Newton-CG", "Custom-NR"]


def _umbrella(nsamples=300, seed=1):
    rng = np.random.default_rng(seed)
    sigma = 1.0 / (K0 + KU)
    mu = sigma * KU * CENTERS
    x = (mu[:, None] + np.sqrt(sigma) * rng.standard_normal((CENTERS.size, nsamples))).reshape(-1)
    u_n = K0 / 2 * x**2
    u_kn = u_n[None, :] + KU / 2 * (x[None, :] - CENTERS[:, None]) ** 2
    # a second coordinate for the 2-D surfaces: the bins, not the states, change
    y = rng.standard_normal(x.size) * 0.4
    return u_kn, u_n, x, np.column_stack([x, y]), np.full(CENTERS.size, nsamples)


def _spline_params(algorithm):
    fa = K0 / 2 * CENT**2
    params = dict(
        spline_weights="unbiasedstate", nspline=4, spline_initialize="explicit", xinit=CENT,
        yinit=fa - fa.min(), xrange=[-0.9, 0.9],
        fkbias=[(lambda x, k=k: KU / 2 * float(np.dot(x - CENTERS[k], x - CENTERS[k])))
                for k in range(CENTERS.size)],
        kdegree=3, optimization_algorithm=algorithm,
        optimize_options={"disp": False, "tol": 1e-6}, objective="ml", map_data=None,
    )
    if algorithm == "Custom-NR":
        params["optimize_options"] = {"disp": False, "tol": 1e-2, "maxiter": 50}
    return params


def _histogram(fes, u_n, x, edges=EDGES, **kw):
    fes.generate_fes(u_n, x, histogram_parameters={"bin_edges": edges}, **kw)


def _kde(fes, u_n, x, **kw):
    fes.generate_fes(u_n, x, fes_type="kde", kde_parameters={"bandwidth": 0.05}, **kw)


def _get_histograms(fes):
    return {rp: fes.get_fes(CENT, reference_point=rp, fes_reference=0.0,
                            uncertainty_method="analytical") for rp in REFERENCE_POINTS}


def _get_kdes(fes):
    return {rp: fes.get_fes(CENT, reference_point=rp, fes_reference=0.0)
            for rp in ("from-lowest", "from-specified", "from-normalization")}


def _flows(F, u_kn, u_n, x, xy, N_k, device_resident=None):
    """Every result the tests compare, from one FES class (``F``)."""
    out = {}
    fes = F(u_kn, N_k)
    out["log_w"] = fes.mbar._computeUnnormalizedLogWeights(u_n)
    _histogram(fes, u_n, x)
    out["histogram", "materialized"] = _get_histograms(fes)
    if device_resident is not None:
        dev = device_resident()
        _histogram(dev, u_n, x)
        out["histogram", "streamed"] = _get_histograms(dev)
    _histogram(fes, u_n, xy, edges=EDGES_2D)
    out["histogram_2d"] = fes.get_fes(xy[::97], uncertainty_method="analytical")
    _histogram(fes, u_n, x, n_bootstraps=3, seed=4)
    out["histogram_bootstrap"] = (
        fes.get_fes(CENT, reference_point="from-lowest", uncertainty_method="bootstrap"),
        fes.get_fes(CENT, reference_point="all-differences", uncertainty_method="bootstrap"),
    )
    _kde(fes, u_n, x)
    out["kde"] = _get_kdes(fes)
    _kde(fes, u_n, x, n_bootstraps=2, seed=7)
    out["kde_bootstrap"] = fes.get_fes(CENT, reference_point="from-lowest",
                                       uncertainty_method="bootstrap")
    fes.generate_fes(u_n, xy, fes_type="kde", kde_parameters={"bandwidth": 0.1})
    out["kde_2d"] = fes.get_fes(xy[::97], reference_point="from-lowest")
    for algorithm in SPLINES:
        fes.generate_fes(u_n, x, fes_type="spline", spline_parameters=_spline_params(algorithm))
        out["spline", algorithm] = (fes.get_fes(CENT, reference_point="from-lowest"),
                                    fes.get_information_criteria("aic"),
                                    fes.get_information_criteria("bic"))
    np.random.seed(2)
    fes.sample_parameter_distribution(
        x, mc_parameters=dict(niterations=200, sample_every=10, print_every=100),
        decorrelate=False, verbose=False)
    out["mc"] = (fes.get_confidence_intervals(CENT, 2.5, 97.5), fes.get_mc_data())
    return out


@pytest.fixture(scope="module")
def problem():
    return _umbrella()


@pytest.fixture(scope="module")
def jax_results(problem):
    u_kn, u_n, x, xy, N_k = problem
    return _flows(pymbar_tpu.FES, u_kn, u_n, x, xy, N_k,
                  device_resident=lambda: pymbar_tpu.FES(jnp.asarray(u_kn), N_k))


@pytest.fixture(scope="module")
def port(problem):
    """One port FES per module (the histogram tests regenerate what they read)."""
    u_kn, u_n, x, xy, N_k = problem
    return pymbar_tpu_torch.FES(u_kn, N_k, device="cpu")


def _close(ours, ref, tol):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=tol)


def _check_histogram(ours, ref):
    _close(ours["f_i"], ref["f_i"], 1e-9)
    for key in ("df_i", "df_ij"):
        assert (key in ours) == (key in ref)
        if key in ref:
            _close(ours[key], ref[key], 1e-8)


@pytest.mark.parametrize("branch", list(BRANCHES))
@pytest.mark.parametrize("reference_point", REFERENCE_POINTS)
def test_histogram_matches_jax(problem, jax_results, port, monkeypatch, branch, reference_point):
    _u_kn, u_n, x, _xy, _N_k = problem
    monkeypatch.setattr(tmbar, "_AUG_STREAM_BYTES", BRANCHES[branch])
    _histogram(port, u_n, x)
    ours = port.get_fes(CENT, reference_point=reference_point, fes_reference=0.0,
                        uncertainty_method="analytical")
    _check_histogram(ours, jax_results["histogram", branch][reference_point])


def test_histogram_2d_matches_jax(problem, jax_results, port):
    _u_kn, u_n, _x, xy, _N_k = problem
    _histogram(port, u_n, xy, edges=EDGES_2D)
    _check_histogram(port.get_fes(xy[::97], uncertainty_method="analytical"),
                     jax_results["histogram_2d"])


def test_histogram_bootstrap_matches_jax(problem, jax_results, port):
    _u_kn, u_n, x, _xy, _N_k = problem
    _histogram(port, u_n, x, n_bootstraps=3, seed=4)
    assert port.bootstrap_route == "replicate"
    lowest = port.get_fes(CENT, reference_point="from-lowest", uncertainty_method="bootstrap")
    diffs = port.get_fes(CENT, reference_point="all-differences", uncertainty_method="bootstrap")
    ref_lowest, ref_diffs = jax_results["histogram_bootstrap"]
    _close(lowest["f_i"], ref_lowest["f_i"], 1e-9)
    _close(lowest["df_i"], ref_lowest["df_i"], 1e-8)
    _close(diffs["df_ij"], ref_diffs["df_ij"], 1e-8)


def test_counts_route_matches_replicate_route(problem):
    """Bootstrap replicates on the dd counts route (the internal MBAR on an
    explicit dd protocol) against the per-replicate route, same seed."""
    u_kn, u_n, x, _xy, N_k = problem
    fes = pymbar_tpu_torch.FES(u_kn, N_k, device="cpu",
                               mbar_options=dict(solver_protocol=(dict(method="dd"),)))
    _histogram(fes, u_n, x, n_bootstraps=3, seed=4)
    assert fes.bootstrap_route == "counts"
    f_replicate, n_fail = fes._replicate_free_energies(fes.bootstrap_indices, "replicate")
    assert n_fail == 0
    _close(fes.f_k_boots, f_replicate, 1e-8)


def test_unnormalized_log_weights_match_jax(problem, jax_results, port):
    _u_kn, u_n, _x, _xy, _N_k = problem
    np.testing.assert_allclose(port.mbar._computeUnnormalizedLogWeights(u_n),
                               jax_results["log_w"], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("reference_point", ["from-lowest", "from-specified", "from-normalization"])
def test_kde_matches_jax(problem, jax_results, port, reference_point):
    _u_kn, u_n, x, _xy, _N_k = problem
    _kde(port, u_n, x)
    assert port.get_kde().n_features_in_ == 1
    ours = port.get_fes(CENT, reference_point=reference_point, fes_reference=0.0)
    _close(ours["f_i"], jax_results["kde"][reference_point]["f_i"], 1e-8)


def test_kde_bootstrap_and_2d_match_jax(problem, jax_results, port):
    _u_kn, u_n, x, xy, _N_k = problem
    _kde(port, u_n, x, n_bootstraps=2, seed=7)
    ours = port.get_fes(CENT, reference_point="from-lowest", uncertainty_method="bootstrap")
    _close(ours["df_i"], jax_results["kde_bootstrap"]["df_i"], 1e-8)
    port.generate_fes(u_n, xy, fes_type="kde", kde_parameters={"bandwidth": 0.1})
    _close(port.get_fes(xy[::97], reference_point="from-lowest")["f_i"],
           jax_results["kde_2d"]["f_i"], 1e-8)


@pytest.mark.parametrize("algorithm", SPLINES)
def test_spline_matches_jax(problem, jax_results, port, algorithm):
    _u_kn, u_n, x, _xy, _N_k = problem
    port.generate_fes(u_n, x, fes_type="spline", spline_parameters=_spline_params(algorithm))
    ref, aic, bic = jax_results["spline", algorithm]
    _close(port.get_fes(CENT, reference_point="from-lowest")["f_i"], ref["f_i"], 1e-8)
    assert port.get_information_criteria("aic") == pytest.approx(aic, rel=1e-12)
    assert port.get_information_criteria("BIC") == pytest.approx(bic, rel=1e-12)


def test_mc_confidence_intervals_match_jax(problem, jax_results, port):
    _u_kn, u_n, x, _xy, _N_k = problem
    port.generate_fes(u_n, x, fes_type="spline", spline_parameters=_spline_params("Newton-CG"))
    np.random.seed(2)
    port.sample_parameter_distribution(
        x, mc_parameters=dict(niterations=200, sample_every=10, print_every=100),
        decorrelate=False, verbose=False)
    ref_ci, ref_mc = jax_results["mc"]
    ci = port.get_confidence_intervals(CENT, 2.5, 97.5)
    for key in ref_ci:
        _close(ci[key], ref_ci[key], 1e-8)
    mc = port.get_mc_data()
    assert mc["acceptance_ratio"] == ref_mc["acceptance_ratio"]
    _close(mc["samples"], ref_mc["samples"], 1e-8)


ERROR_PATHS = {
    "n_bootstraps_1": lambda fes, u_n, x: _histogram(fes, u_n, x, n_bootstraps=1),
    "missing_bin_edges": lambda fes, u_n, x: fes.generate_fes(u_n, x, histogram_parameters={}),
    "histogram_from_normalization": lambda fes, u_n, x: (
        _histogram(fes, u_n, x),
        fes.get_fes(CENT, reference_point="from-normalization", uncertainty_method="analytical")),
    "kde_bad_parameter": lambda fes, u_n, x: fes.generate_fes(
        u_n, x, fes_type="kde", kde_parameters={"not_a_kde_param": 1.0}),
    "information_criteria_requires_spline": lambda fes, u_n, x: (
        _histogram(fes, u_n, x), fes.get_information_criteria("aic")),
    "unknown_fes_type": lambda fes, u_n, x: fes.generate_fes(u_n, x, fes_type="mesh"),
    "bad_uncertainty_method": lambda fes, u_n, x: (
        _histogram(fes, u_n, x), fes.get_fes(CENT, uncertainty_method="jackknife")),
}


@pytest.mark.parametrize("case", list(ERROR_PATHS))
def test_error_paths_match_jax(problem, port, case):
    u_kn, u_n, x, _xy, N_k = problem
    with pytest.raises(Exception) as ref:
        ERROR_PATHS[case](pymbar_tpu.FES(u_kn, N_k), u_n, x)
    with pytest.raises(Exception) as ours:
        ERROR_PATHS[case](port, u_n, x)
    assert type(ours.value).__name__ == type(ref.value).__name__
    assert type(ours.value).__name__ in ("ValueError", "ParameterError")


def test_input_layouts_and_devices(problem, port):
    """kln input gives the kn solution; a tensor stays where it is and is
    shared with the internal MBAR; numpy goes to the card unless
    device="cpu", and without a card that raises."""
    u_kn, _u_n, _x, _xy, N_k = problem
    K, n = N_k.size, int(N_k[0])
    u_kln = u_kn.reshape(K, K, n).transpose(1, 0, 2)  # u_kln[k, l, i]: state k's sample i at l
    kln = pymbar_tpu_torch.FES(u_kln, N_k, device="cpu")
    np.testing.assert_allclose(kln.mbar.f_k, port.mbar.f_k, rtol=0, atol=1e-12)
    t = torch.as_tensor(u_kn)
    fes = pymbar_tpu_torch.FES(t, N_k)
    assert fes.u_kn.data_ptr() == t.data_ptr() == fes.mbar.u_kn.data_ptr()
    if torch.cuda.is_available():
        assert pymbar_tpu_torch.FES(u_kn, N_k).u_kn.is_cuda
    else:
        with pytest.raises(ParameterError):
            pymbar_tpu_torch.FES(u_kn, N_k)


def test_fes_is_exported_lazily():
    """``pymbar_tpu_torch.FES`` is the FES class, and executing the
    package's ``__init__`` imports neither the FES nor the KDE module."""
    assert pymbar_tpu_torch.FES is pymbar_tpu_torch.fes.FES
    assert "FES" in pymbar_tpu_torch.__all__
    saved = {name: sys.modules.pop(name) for name in ("pymbar_tpu_torch.fes", "pymbar_tpu_torch.kde")}
    try:
        importlib.reload(pymbar_tpu_torch)
        assert not any(name in sys.modules for name in saved)
    finally:
        sys.modules.update(saved)


def test_docstring_examples_run(monkeypatch):
    """The ``>>>`` examples of the port's FES (on the CPU, the process
    default device) run and pass."""
    import pymbar_tpu_torch.fes

    monkeypatch.setenv("PYMBAR_TPU_TORCH_DEVICE", "cpu")
    result = doctest.testmod(pymbar_tpu_torch.fes, optionflags=doctest.ELLIPSIS)
    assert result.attempted >= 10 and result.failed == 0
