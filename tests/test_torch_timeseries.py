"""pymbar_tpu_torch's host modules against pymbar_tpu's on the CPU.

Every public function of ``timeseries`` and of ``confidenceintervals`` on
the same numpy inputs (AR(1) series and replicate dicts made from a seed),
to 1e-12 absolute and relative, with ``qq_plot`` writing a file under
matplotlib's Agg backend; and the test systems, which give the same samples
for the same seed, exactly.
"""

import matplotlib
import numpy as np
import pytest

import pymbar_tpu
import pymbar_tpu_torch
from pymbar_tpu import confidenceintervals as jci
from pymbar_tpu import timeseries as jts
from pymbar_tpu import utils_for_testing as jut
from pymbar_tpu_torch import confidenceintervals as tci
from pymbar_tpu_torch import timeseries as tts
from pymbar_tpu_torch import utils_for_testing as tut

TOL = 1e-12


def _close(ours, ref):
    if isinstance(ref, (tuple, list)):
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            _close(a, b)
        return
    a, b = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert a.shape == b.shape
    scale = max(float(np.max(np.abs(b), initial=0.0)), 1.0)
    assert float(np.max(np.abs(a - b), initial=0.0)) <= TOL * scale


@pytest.fixture(scope="module")
def series():
    """Three AR(1) series (tau 3, 8 and a short one) and a correlated pair."""
    make = pymbar_tpu_torch.testsystems.correlated_timeseries_example
    A = make(N=2000, tau=3.0, seed=1).astype(np.float64)
    B = A + 0.5 * make(N=2000, tau=8.0, seed=2)
    return dict(A=A, B=B, kn=[A, B[:1500], make(N=700, tau=2.0, seed=3).astype(np.float64)])


CASES = {
    "statistical_inefficiency": lambda m, s: m.statistical_inefficiency(s["A"]),
    "statistical_inefficiency_cross": lambda m, s: m.statistical_inefficiency(s["A"], s["B"]),
    "statistical_inefficiency_fast": lambda m, s: m.statistical_inefficiency(s["A"], fast=True),
    "statistical_inefficiency_direct": lambda m, s: m.statistical_inefficiency(
        s["A"], s["B"], method="direct"),
    "statistical_inefficiency_fft_flag": lambda m, s: m.statistical_inefficiency(s["A"], fft=True),
    "statistical_inefficiency_multiple": lambda m, s: m.statistical_inefficiency_multiple(
        s["kn"], return_correlation_function=True),
    "statistical_inefficiency_multiple_array": lambda m, s: m.statistical_inefficiency_multiple(
        np.stack([s["A"], s["B"]]), fast=True),
    "integrated_autocorrelation_time": lambda m, s: m.integrated_autocorrelation_time(s["B"]),
    "integrated_autocorrelation_timeMultiple": lambda m, s: (
        m.integrated_autocorrelation_timeMultiple(s["kn"])),
    "normalized_fluctuation_correlation_function": lambda m, s: (
        m.normalized_fluctuation_correlation_function(s["A"], s["B"], N_max=300)),
    "normalized_fluctuation_correlation_function_unnormed": lambda m, s: (
        m.normalized_fluctuation_correlation_function(s["A"], norm=False)),
    "normalized_fluctuation_correlation_function_multiple": lambda m, s: (
        m.normalized_fluctuation_correlation_function_multiple(s["kn"], truncate=True)),
    "subsample_correlated_data": lambda m, s: m.subsample_correlated_data(s["A"]),
    "subsample_correlated_data_conservative": lambda m, s: list(
        m.subsample_correlated_data(s["A"], g=3.4, conservative=True)),
    "detect_equilibration": lambda m, s: m.detect_equilibration(s["A"][:400], nskip=7),
    "detect_equilibration_constant": lambda m, s: m.detect_equilibration(np.ones(50)),
    "statistical_inefficiency_fft": lambda m, s: m.statistical_inefficiency_fft(s["B"]),
    "detect_equilibration_binary_search": lambda m, s: (
        m.detect_equilibration_binary_search(s["B"], bs_nodes=6)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_timeseries_matches_jax(series, name):
    _close(CASES[name](tts, series), CASES[name](jts, series))


def test_timeseries_parameter_errors(series):
    for mod in (tts, jts):
        err = pymbar_tpu_torch.utils.ParameterError if mod is tts else pymbar_tpu.utils.ParameterError
        with pytest.raises(err):
            mod.statistical_inefficiency(np.ones(100))
        with pytest.raises(err):
            mod.statistical_inefficiency(series["A"], series["A"][:-1])
        with pytest.raises(err):
            mod.normalized_fluctuation_correlation_function_multiple(series["A"])


@pytest.fixture(scope="module")
def replicates():
    """Replicate dicts of dimension 0, 1 and 2 (K = 4), one zero sigma each."""
    rng = np.random.default_rng(71)
    K, n_rep = 4, 30
    out = {}
    for dim, shape in ((0, ()), (1, (K,)), (2, (K, K))):
        sigma = rng.uniform(0.5, 2.0, shape)
        if dim:
            sigma.flat[0] = 0.0
        out[dim] = [dict(estimated=rng.normal(0, 1, shape), destimated=sigma.copy(),
                         error=rng.normal(0, 1, shape) * sigma) for _ in range(n_rep)]
    return K, out


@pytest.mark.parametrize("dim", [0, 1, 2])
def test_confidenceintervals_match_jax(replicates, dim):
    K, reps = replicates
    for name in ("order_replicates", "anderson_darling", "generate_confidence_intervals"):
        _close(getattr(tci, name)(reps[dim], K), getattr(jci, name)(reps[dim], K))


def test_qq_plot_writes_a_file(replicates, tmp_path):
    matplotlib.use("Agg")
    K, reps = replicates
    for dim in (1, 2):
        out = tmp_path / f"qq{dim}.png"
        tci.qq_plot(reps[dim], K, filename=str(out))
        assert out.stat().st_size > 0


SYSTEMS = {
    "harmonic_oscillators": lambda m: m.testsystems.HarmonicOscillatorsTestCase().sample(
        N_k=[7, 0, 5, 3, 4], mode="u_kn", seed=2),
    "exponential_u_kln": lambda m: m.testsystems.ExponentialTestCase().sample(seed=5),
    "exponential_wFwR": lambda m: m.testsystems.ExponentialTestCase(rates=(1, 3)).sample(
        [20, 10], mode="wFwR", seed=5),
    "exponential_evenly_spaced": lambda m: m.testsystems.ExponentialTestCase
    .evenly_spaced_exponentials(3, 6, seed=8)[2:],
    "gaussian_work_example": lambda m: m.testsystems.gaussian_work_example(
        N_F=30, N_R=20, mu_F=None, DeltaF=1.0, seed=9),
    "correlated_timeseries_example": lambda m: m.testsystems.correlated_timeseries_example(
        N=500, tau=4.0, seed=10),
    "oscillators": lambda m: (tut if m is pymbar_tpu_torch else jut).oscillators(
        3, 20, provide_test=True, seed=11)[1:4],
    "exponentials": lambda m: (tut if m is pymbar_tpu_torch else jut).exponentials(
        3, 20, seed=12)[1:],
}


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_test_systems_give_the_same_samples(name):
    ours, ref = SYSTEMS[name](pymbar_tpu_torch), SYSTEMS[name](pymbar_tpu)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.array_equal(a, b)


def test_analytic_values_match_jax():
    for ours, ref in ((pymbar_tpu_torch.testsystems.ExponentialTestCase((1, 2, 5)),
                       pymbar_tpu.testsystems.ExponentialTestCase((1, 2, 5))),):
        for name in ("analytical_free_energies", "analytical_means", "analytical_variances",
                     "analytical_standard_deviations", "analytical_entropies",
                     "analytical_x_squared"):
            assert np.array_equal(getattr(ours, name)(), getattr(ref, name)())
        for obs in ("position", "position^2", "RMS displacement", "potential energy"):
            assert np.array_equal(ours.analytical_observable(obs), ref.analytical_observable(obs))
