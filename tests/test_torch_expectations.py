"""The rest of MBAR in pymbar_tpu_torch against pymbar_tpu on the CPU.

``compute_expectations`` (averages, differences, a state-dependent
observable, kln input, ``return_theta``, an observable with exact zeros),
``compute_multiple_expectations`` (with covariances),
``compute_perturbed_free_energies`` (and its ``DataError``),
``compute_entropy_and_enthalpy``, ``compute_covariance_of_sums`` and
``compute_expectations_inner`` with a permuted ``state_map``.  Each runs on
both branches in each package (``_AUG_STREAM_BYTES`` = 0: the streamed
passes; 2**62: the materializing branch) and under every uncertainty
method.  The same numpy inputs (harmonic oscillators made from a seed, K =
5, N = 900, state 2 empty) go to both packages; the port runs with
``device="cpu"``.  Both packages get one solution (the JAX package's f_k
and f_k_boots; the port draws the same ``bootstrap_rints`` from the same
``rseed``), so only the expectation machinery differs.

Tolerances: values (mu, f, Delta_*) 1e-12 and uncertainties (sigma,
dDelta_*, Theta, covariances) rtol 1e-10, atol 1e-12 between the packages
on one branch; between the port's two branches, the JAX suite's own bar,
rtol 1e-9, atol 1e-11 (``tests/test_mbar.py:466-500``).  Every JAX result
is computed once per module, so each jitted JAX body compiles once.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pymbar_tpu
import pymbar_tpu.mbar as jmbar
import pymbar_tpu_torch
import pymbar_tpu_torch.mbar as tmbar
from pymbar_tpu_torch.utils import DataError, ParameterError

# one intra-op thread per test process: the suite's workers share the CPUs
torch.set_num_threads(1)

N_K = [300, 200, 0, 250, 150]
BRANCHES = {"streamed": 0, "materialized": 2**62}
METHODS = [None, "approximate", "svd", "bootstrap"]
VALUE_KEYS = {"mu", "f", "observables", "Delta_f", "Delta_u", "Delta_s", "Amin"}


def _close(ours, ref, key, rtol=1e-10, atol=1e-12):
    if key in VALUE_KEYS:
        rtol = atol = 1e-12
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), rtol=rtol, atol=atol, err_msg=key)


def _check(ours, ref, **tol):
    assert set(ours) == set(ref)
    for key in ref:
        assert isinstance(ours[key], np.ndarray), key
        _close(ours[key], ref[key], key, **tol)


@pytest.fixture(scope="module")
def problem():
    tc = pymbar_tpu_torch.testsystems.HarmonicOscillatorsTestCase()
    x, u, N_k, _s = tc.sample(N_k=N_K, mode="u_kn", seed=1)
    ref = pymbar_tpu.MBAR(u, N_k, n_bootstraps=4, rseed=3)
    ours = pymbar_tpu_torch.MBAR(u, N_k, n_bootstraps=4, rseed=3, device="cpu")
    np.testing.assert_array_equal(ours.bootstrap_rints, np.asarray(ref.bootstrap_rints))
    ours.f_k = np.array(ref.f_k)
    ours.f_k_boots = np.array(ref.f_k_boots)
    # the kln layout of the same samples: x_kn[k, n] and u_kln[k, l, n] for
    # sample n of state k, zero-padded to N_max
    K, N_max = len(N_k), max(N_k)
    starts = np.concatenate([[0], np.cumsum(N_k)])
    x_kn, u_kln = np.zeros((K, N_max)), np.zeros((K, K, N_max))
    for k in range(K):
        x_kn[k, : N_k[k]] = x[starts[k] : starts[k + 1]]
        u_kln[k, :, : N_k[k]] = u[:, starts[k] : starts[k + 1]]
    calls = {
        "averages": lambda m, meth: m.compute_expectations(x, uncertainty_method=meth,
                                                     return_theta=True),
        "differences": lambda m, meth: m.compute_expectations(x, output="differences",
                                                        uncertainty_method=meth),
        "state_dependent": lambda m, meth: m.compute_expectations(u, state_dependent=True,
                                                            uncertainty_method=meth),
        "kln": lambda m, meth: m.compute_expectations(x_kn, u_kn=u_kln, uncertainty_method=meth),
        "zeros": lambda m, meth: m.compute_expectations(np.where(np.abs(x) < 0.5, 0.0, x),
                                                  uncertainty_method=meth),
        "multiple": lambda m, meth: m.compute_multiple_expectations(
            np.vstack([x, x**2]), u[3], compute_covariance=True, uncertainty_method=meth),
        "perturbed": lambda m, meth: m.compute_perturbed_free_energies(
            np.vstack([u[0], 1.5 * (x - 0.5) ** 2]), uncertainty_method=meth),
        "entropy": lambda m, meth: m.compute_entropy_and_enthalpy(uncertainty_method=meth),
        "inner_permuted": lambda m, meth: m.compute_expectations_inner(
            m.u_kn, m.u_kn, np.vstack([[2, 0, 4, 1, 3], np.arange(5)]),
            uncertainty_method=meth, return_theta=meth != "bootstrap"),
        # extra states 0 and 2 of three rows: state 2's column is also the
        # first pseudo-state's, which the reference fills one by one
        "inner_gapped": lambda m, meth: m.compute_expectations_inner(
            np.vstack([x, x**2]), u[:3], np.array([[0, 2], [0, 1]]), uncertainty_method=meth),
    }
    cache = {}

    def run(pkg, branch, method, call, m=None):
        key = (pkg, branch, method, call, m is not None)
        if key not in cache:
            mod = jmbar if pkg == "jax" else tmbar
            saved = mod._AUG_STREAM_BYTES
            mod._AUG_STREAM_BYTES = BRANCHES[branch]
            try:
                cache[key] = calls[call](m or (ref if pkg == "jax" else ours), method)
            finally:
                mod._AUG_STREAM_BYTES = saved
        return cache[key]

    return dict(x=x, u=u, N_k=N_k, ref=ref, ours=ours, run=run, calls=calls)


@pytest.mark.parametrize("call", ["averages", "differences", "state_dependent", "kln", "zeros",
                                  "multiple", "perturbed", "entropy", "inner_permuted",
                                  "inner_gapped"])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("branch", list(BRANCHES))
def test_matches_jax(problem, branch, method, call):
    run = problem["run"]
    _check(run("torch", branch, method, call), run("jax", branch, method, call))


@pytest.mark.parametrize("call", ["averages", "differences", "state_dependent", "multiple",
                                  "perturbed", "entropy"])
@pytest.mark.parametrize("method", [None, "bootstrap"])
def test_branches_agree(problem, method, call):
    run = problem["run"]
    _check(run("torch", "streamed", method, call), run("torch", "materialized", method, call),
           rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("call, counter", [("averages", "AUG_B_LOGROW_PASSES"),
                                           ("entropy", "AUG_B_DIAG_PASSES")])
def test_structured_and_general_gram(problem, monkeypatch, call, counter):
    """The structured pass B runs where u_ln aliases u_kn (one shared
    observable row; observable row k at state k), and the general
    (K + NL + S)^2 Gram gives the same result when it is switched off."""
    ours = problem["ours"]
    monkeypatch.setattr(tmbar, "_AUG_STREAM_BYTES", 0)
    counts = lambda: [getattr(tmbar, n) for n in (counter, "AUG_B_GENERAL_PASSES")]  # noqa: E731
    before = counts()
    structured = problem["calls"][call](ours, None)
    assert counts() == [before[0] + 1, before[1]]
    monkeypatch.setattr(tmbar, "_STRUCT_AUG_GRAM", False)
    general = problem["calls"][call](ours, None)
    assert counts() == [before[0] + 1, before[1] + 1]
    _check(general, structured, rtol=1e-10, atol=1e-12)
    _check(structured, problem["run"]("jax", "streamed", None, call))


@pytest.mark.parametrize("call", ["averages", "differences", "entropy"])
@pytest.mark.parametrize("method", [None, "bootstrap"])
def test_alias_routes_match_jax_device_resident(problem, method, call):
    """The port's u_kn is a tensor, so compute_expectations (u_ln = u_kn)
    and entropy (A_n = u_ln = u_kn, no copy) take the aliased streamed
    routes; the JAX package takes them with a device-resident u_kn."""
    run = problem["run"]
    ref_dev = copy.copy(problem["ref"])
    ref_dev.u_kn = jnp.asarray(problem["u"])
    _check(run("torch", "streamed", method, call), run("jax", "streamed", method, call, ref_dev))


def test_perturbed_too_few_samples(problem):
    u = problem["u"]
    for m in (problem["ours"], problem["ref"]):
        with pytest.raises((DataError, pymbar_tpu.utils.DataError)):
            m.compute_perturbed_free_energies(u[:, :-1])


def test_bootstrap_without_replicates_raises(problem):
    m = pymbar_tpu_torch.MBAR.from_solution(problem["u"], problem["N_k"], problem["ref"].f_k,
                                            device="cpu")
    with pytest.raises(ParameterError):
        m.compute_expectations(problem["x"], uncertainty_method="bootstrap")


def test_covariance_of_sums_matches_jax(problem):
    d_ij = problem["run"]("jax", "materialized", None, "entropy")["dDelta_f"]
    a = np.array([1.0, -0.5])
    ours = problem["ours"].compute_covariance_of_sums(torch.from_numpy(d_ij), 2, a)
    ref = problem["ref"].compute_covariance_of_sums(d_ij, 2, a)
    _close(ours, ref, "sigma")


def test_entropy_reads_u_kn_without_a_copy(problem, monkeypatch):
    """The aliased entropy keeps A_n = u_kn itself: no clone of u_kn."""
    ours = problem["ours"]
    monkeypatch.setattr(tmbar, "_AUG_STREAM_BYTES", 0)
    clones = []
    real = tmbar._f64

    def spy(x, copy=False):
        clones.append(copy and x is ours.u_kn)
        return real(x, copy)

    monkeypatch.setattr(tmbar, "_f64", spy)
    ours.compute_entropy_and_enthalpy()
    assert not any(clones)
