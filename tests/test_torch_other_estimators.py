"""pymbar_tpu_torch's two-state estimators against pymbar_tpu's on the CPU.

``bar`` (every root method and uncertainty method, the one-step estimate,
no uncertainty), ``bar_zero``, ``bar_overlap``, ``exp`` and ``exp_gauss``
on the same work values (Gaussian work and exponential-state samples made
from a seed), each to 1e-12 absolute and relative; and the paths that end in
``ParameterError``, ``ConvergenceError``, ``BoundsError`` or the poor-overlap
guess of 0.  ``bar_overlap`` builds the port's MBAR with ``device="cpu"``.
"""

import numpy as np
import pytest

import pymbar_tpu
import pymbar_tpu_torch
from pymbar_tpu import other_estimators as jax_est
from pymbar_tpu import utils as jutils
from pymbar_tpu_torch import other_estimators as port_est
from pymbar_tpu_torch import utils as tutils

TOL = 1e-12


def _close(ours, ref):
    assert set(ours) == set(ref)
    for key in ref:
        a, b = float(ours[key]), float(ref[key])
        assert abs(a - b) <= TOL * max(abs(b), 1.0), (key, a, b)


@pytest.fixture(scope="module", params=["gaussian_work", "exponential"])
def works(request):
    if request.param == "gaussian_work":
        return pymbar_tpu_torch.testsystems.gaussian_work_example(
            N_F=300, N_R=200, mu_F=2.0, sigma_F=1.5, seed=3)
    tc = pymbar_tpu_torch.testsystems.ExponentialTestCase(rates=(1.0, 4.0))
    w_F, w_R, _N_k = tc.sample([300, 200], mode="wFwR", seed=4)
    return w_F, w_R


@pytest.mark.parametrize("uncertainty_method", ["BAR", "MBAR"])
@pytest.mark.parametrize("method", ["false-position", "bisection", "self-consistent-iteration"])
def test_bar_matches_jax(works, method, uncertainty_method):
    kw = dict(method=method, uncertainty_method=uncertainty_method)
    _close(pymbar_tpu_torch.bar(*works, **kw), pymbar_tpu.bar(*works, **kw))


@pytest.mark.parametrize("kw", [dict(iterated_solution=False, DeltaF=0.5),
                                dict(compute_uncertainty=False, relative_tolerance=1e-8)])
def test_bar_variants_match_jax(works, kw):
    _close(pymbar_tpu_torch.bar(*works, **kw), pymbar_tpu.bar(*works, **kw))


def test_bar_zero_matches_jax(works):
    for delta in (-3.0, 0.0, 0.7, 5.0):
        a, b = pymbar_tpu_torch.bar_zero(*works, delta), pymbar_tpu.bar_zero(*works, delta)
        assert abs(a - b) <= TOL * max(abs(b), 1.0)
    for pkg in (pymbar_tpu_torch, pymbar_tpu):
        assert np.isnan(pkg.bar_zero([np.inf, 1.0], [0.0], 0.0))  # inf - inf inside
        with pytest.raises(FloatingPointError):  # M + w_F - DeltaF itself overflows
            pkg.bar_zero([1.0e308], [0.0], -1.0e308)


@pytest.mark.parametrize("compute_uncertainty", [True, False])
@pytest.mark.parametrize("is_timeseries", [False, True])
@pytest.mark.parametrize("name", ["exp", "exp_gauss"])
def test_exp_matches_jax(works, name, compute_uncertainty, is_timeseries):
    kw = dict(compute_uncertainty=compute_uncertainty, is_timeseries=is_timeseries)
    _close(getattr(pymbar_tpu_torch, name)(works[0], **kw), getattr(pymbar_tpu, name)(works[0], **kw))


def test_bar_overlap_matches_jax(works):
    ours = pymbar_tpu_torch.bar_overlap(*works, device="cpu")
    ref = pymbar_tpu.bar_overlap(*works)
    assert abs(ours - ref) <= TOL and 0.0 < ours <= 1.0


def test_bar_poor_overlap_guesses_zero(caplog):
    """A work value of +inf makes the bracket's implicit function nan."""
    w_F, w_R = np.array([np.inf, 1.0, 2.0]), np.array([0.5, -1.0])
    for pkg in (pymbar_tpu_torch, pymbar_tpu):
        assert pkg.bar(w_F, w_R) == {"Delta_f": 0.0, "dDelta_f": 0.0}
    assert "poor overlap" in caplog.text


@pytest.mark.parametrize("kw", [dict(method="nope"), dict(uncertainty_method="nope")])
def test_bar_parameter_errors(works, kw):
    for errors, pkg in ((tutils, pymbar_tpu_torch), (jutils, pymbar_tpu)):
        with pytest.raises(errors.ParameterError):
            pkg.bar(*works, **kw)


def test_bar_convergence_error(works):
    kw = dict(method="self-consistent-iteration", maximum_iterations=2)
    for errors, pkg in ((tutils, pymbar_tpu_torch), (jutils, pymbar_tpu)):
        with pytest.raises(errors.ConvergenceError):
            pkg.bar(*works, **kw)


def test_bar_bounds_error(works, monkeypatch):
    """A nan of the implicit function inside the bracket matches neither
    endpoint's sign: both packages raise BoundsError."""
    for errors, mod in ((tutils, port_est), (jutils, jax_est)):
        calls = []
        real = mod.bar_zero

        def nan_after_bracket(w_F, w_R, x, calls=calls, real=real):
            calls.append(x)
            return np.nan if len(calls) > 2 else real(w_F, w_R, x)

        monkeypatch.setattr(mod, "bar_zero", nan_after_bracket)
        with pytest.raises(errors.BoundsError):
            mod.bar(*works, method="bisection")
