"""The port's bootstrap path against the JAX package's, on the CPU.

The same numpy inputs go to both packages: the double-word planes, base
solution, chord factor and resample counts of ``bootstrap_polish_dd``, the
f64 matrix of ``solve_mbar_dd_bootstrap``, and ``u_kn`` with one ``rseed``
for ``MBAR(n_bootstraps=B)``.  Tolerances: ``bootstrap_polish_dd`` within
1e-10 of JAX's (the JAX package's CPU dd exp is capped at ~1.4e-11
relative, docs/numerics.md; the port's is plain f64), the port's batched
engine within 5e-11 of its serial one (tests/test_solvers_large.py:324),
``MBAR``'s ``f_k_boots`` and bootstrap ``dDelta_f`` within 1e-9, and
``bootstrap_rints`` equal.  Each JAX result is computed once per module.
"""

import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pymbar_tpu
import pymbar_tpu_torch
from pymbar_tpu import solvers_large as jsl
from pymbar_tpu.ops.doubledouble import dd_from_f64
from pymbar_tpu.ops.mbar_core import precondition_u_kn
from pymbar_tpu_torch import mbar as tmbar
from pymbar_tpu_torch import solvers_large as tsl

# one intra-op thread per test process: the suite's workers share the CPUs
torch.set_num_threads(1)

B = 6


def _boot_counts(rng, N_k, n_boot):
    """Per-state block resample multiplicities, (n_boot, sum N_k) float32
    (tests/test_solvers_large.py:290)."""
    N_k = np.asarray(N_k, dtype=np.int64)
    counts = np.zeros((n_boot, int(N_k.sum())), np.float32)
    for b in range(n_boot):
        start = 0
        for nk in N_k:
            np.add.at(counts[b], start + rng.integers(int(nk), size=int(nk)), 1.0)
            start += int(nk)
    return counts


@pytest.fixture(scope="module")
def problem():
    """The JAX tests' problem (tests/test_solvers_large.py:27-39): K = 32
    oscillators x 256 samples, preconditioned; its dd planes, JAX's base
    solve (f_k, chord factor) and B resamples."""
    rng = np.random.default_rng(5)
    K, npk = 32, 256
    N = K * npk
    O = np.linspace(0, 4, K)
    Kf = np.linspace(1, 3, K)
    x = np.repeat(O, npk) + rng.normal(0, 1.0, N) / np.sqrt(np.repeat(Kf, npk))
    u64 = jnp.asarray(0.5 * Kf[:, None] * (x[None, :] - O[:, None]) ** 2)
    N_k = np.full(K, float(npk))
    u64 = precondition_u_kn(u64, jnp.asarray(N_k), jnp.zeros(K, jnp.float64))
    uh, ul = dd_from_f64(u64)
    f_k, info = jsl.solve_mbar_dd(uh, ul, N_k, tol=1e-12)
    counts = _boot_counts(np.random.default_rng(7), N_k, B)
    return dict(
        u64=np.array(u64), N_k=N_k, uh=np.array(uh), ul=np.array(ul),
        f_k=np.asarray(f_k), hinv=np.asarray(info["hinv"]), counts=counts,
    )


def _port_polish(p, counts=None, **kw):
    return tsl.bootstrap_polish_dd(
        torch.from_numpy(p["uh"]), torch.from_numpy(p["ul"]), p["N_k"], p["f_k"], p["hinv"],
        p["counts"] if counts is None else counts, **kw,
    )


@pytest.fixture(scope="module")
def port_batched(problem):
    return _port_polish(problem)


def _identity(n_fail, info, n_boot):
    assert info["at_floor"].shape == (n_boot,)
    assert n_fail + info["n_at_floor"] + info["n_tol_converged"] == n_boot


def test_batched_matches_jax(problem, port_batched):
    p = problem
    fb_j, nf_j, bi_j = jsl.bootstrap_polish_dd(
        p["uh"], p["ul"], p["N_k"], p["f_k"], p["hinv"], p["counts"]
    )
    fb, nf, bi = port_batched
    assert np.max(np.abs(fb - np.asarray(fb_j))) <= 1e-10
    assert nf == nf_j == 0
    _identity(nf, bi, B)
    assert set(bi) >= {"phase_walls", "fast_iters", "exact_iters", "exact_deltas"}
    assert bi["exact_iters"].shape == (B,) and bi["exact_deltas"].shape == (16, B)
    assert set(bi["phase_walls"]) == {
        "prep_s", "upload_s", "materialize_s", "fast_s", "exact_s", "total_s"}


def test_batched_matches_serial(problem, port_batched):
    fb, _nf, _bi = port_batched
    fs, nf, bi = _port_polish(problem, mode="serial")
    assert nf == 0
    _identity(nf, bi, B)
    assert bi["polish_iterations"].shape == (B,) and np.all(bi["polish_iterations"] >= 1)
    assert np.max(np.abs(fb - fs)) <= 5e-11
    # the replicates really moved away from the base solution
    assert np.max(np.abs(fb - problem["f_k"][None, :])) > 1e-3


@pytest.mark.parametrize("case", ["unreachable_tol", "loose_tol"])
def test_at_floor_vs_tol_converged(problem, port_batched, case):
    """tests/test_solvers_large.py:333-363: a tol below the dd floor stops
    every replicate by a floor rule (reported, not failed); a loose tol is
    certified outright, at the same fixed points."""
    if case == "unreachable_tol":
        fb, nf, bi = _port_polish(problem, tol=1e-30)
        assert nf == 0 and bi["n_at_floor"] == B and bi["at_floor"].all()
        assert bi["n_tol_converged"] == 0
    else:
        fb, nf, bi = _port_polish(problem, tol=1e-6)
        assert nf == 0 and bi["n_tol_converged"] == B and bi["n_at_floor"] == 0
    assert np.all(np.isfinite(fb))
    assert np.max(np.abs(fb - port_batched[0])) < 1e-5


def test_group_split(problem, monkeypatch):
    """Groups of 2 over 5 replicates (a short last group run as it is)
    give the replicates of one group."""
    counts = problem["counts"][:5]
    fb_one, _, _ = _port_polish(problem, counts)
    monkeypatch.setattr(tsl, "_batch_group_size", lambda n_boot, N: 2)
    fb_grp, nf, bi = _port_polish(problem, counts)
    assert nf == 0
    _identity(nf, bi, 5)
    assert np.max(np.abs(fb_grp - fb_one)) <= 1e-12


def test_counts_upload_forms_agree(problem, port_batched):
    """uint16 counts ride the uint8 upload; a float matrix that is not
    integral goes up as float32; both give the float32 counts' answer."""
    assert tsl._counts_upload_dtype(problem["counts"].astype(np.uint16)) == np.uint8
    assert tsl._counts_upload_dtype(problem["counts"] + 0.5) == np.float32
    fb, nf, _ = _port_polish(problem, problem["counts"].astype(np.uint16))
    assert nf == 0 and np.array_equal(fb, port_batched[0])


@pytest.fixture(scope="module")
def jax_dd_bootstrap(problem):
    p = problem
    return jsl.solve_mbar_dd_bootstrap(p["u64"], p["N_k"], np.zeros(len(p["N_k"])), p["counts"])


@pytest.mark.parametrize("split", ["tensor", "numpy"])
def test_solve_mbar_dd_bootstrap_matches_jax(problem, jax_dd_bootstrap, split):
    p = problem
    u = torch.from_numpy(p["u64"]) if split == "tensor" else p["u64"]
    f, fb, nf, info = tsl.solve_mbar_dd_bootstrap(
        u, p["N_k"], np.zeros(len(p["N_k"])), p["counts"], device="cpu"
    )
    f_j, fb_j, nf_j, info_j = jax_dd_bootstrap
    assert np.max(np.abs(f - np.asarray(f_j))) <= 1e-10
    assert np.max(np.abs(fb - np.asarray(fb_j))) <= 1e-10
    assert nf == nf_j == 0 and np.all(fb[:, 0] == 0.0)
    assert info["converged"]
    assert info["bootstrap_at_floor"].shape == (B,)
    assert nf + info["bootstrap_n_at_floor"] + info["bootstrap_n_tol_converged"] == B


def _oscillators(K, npk, seed):
    tc = pymbar_tpu_torch.testsystems.HarmonicOscillatorsTestCase(
        O_k=np.linspace(0, 3, K), K_k=np.linspace(1, 3, K)
    )
    _x, u_kn, N_k, _s = tc.sample(N_k=[npk] * K, mode="u_kn", seed=seed)
    return u_kn, N_k


def _quickstart():
    tc = pymbar_tpu_torch.testsystems.HarmonicOscillatorsTestCase(
        O_k=[0, 1, 2, 3, 4], K_k=[1, 2, 4, 8, 16]
    )
    _x, u_kn, N_k, _s = tc.sample(N_k=[3000, 1500, 0, 2500, 2000], mode="u_kn", seed=1)
    return u_kn, N_k


@pytest.fixture(scope="module")
def mbar_pairs():
    """(port MBAR, JAX MBAR) with one rseed: the dd counts route (K = 32 x
    256, an explicit dd protocol, B = 6) and the sequential route (the
    quickstart, state 2 empty, default protocols, B = 8)."""
    dd = (dict(method="dd"),)
    u, N_k = _oscillators(32, 256, seed=4)
    kw = dict(solver_protocol=dd, n_bootstraps=B, rseed=11)
    out = {"dd": (pymbar_tpu_torch.MBAR(u, N_k, device="cpu", **kw),
                  pymbar_tpu.MBAR(u, N_k, **kw))}
    u, N_k = _quickstart()
    kw = dict(n_bootstraps=8, rseed=3)
    out["sequential"] = (pymbar_tpu_torch.MBAR(u, N_k, device="cpu", **kw),
                         pymbar_tpu.MBAR(u, N_k, **kw))
    return out


@pytest.mark.parametrize("route", ["dd", "sequential"])
def test_mbar_bootstrap_matches_jax(mbar_pairs, route):
    ours, ref = mbar_pairs[route]
    assert ours.n_bootstraps == ref.n_bootstraps
    assert np.array_equal(ours.bootstrap_rints, ref.bootstrap_rints)
    assert np.max(np.abs(ours.f_k - ref.f_k)) <= 1e-10
    assert np.max(np.abs(ours.f_k_boots - np.asarray(ref.f_k_boots))) <= 1e-9
    res = ours.compute_free_energy_differences(uncertainty_method="bootstrap")
    res_j = ref.compute_free_energy_differences(uncertainty_method="bootstrap")
    assert np.max(np.abs(res["Delta_f"] - res_j["Delta_f"])) <= 1e-10
    assert np.max(np.abs(res["dDelta_f"] - res_j["dDelta_f"])) <= 1e-9
    if route == "dd":
        assert ours.solver_protocol[0]["method"] == "dd" and ours.solver_results[0]["success"]
        # which replicates stop at the floor rather than on tol is noise
        assert ours.bootstrap_at_floor.shape == ref.bootstrap_at_floor.shape == (B,)
    else:
        assert ours.bootstrap_at_floor is None and ref.bootstrap_at_floor is None
        assert np.all(np.isfinite(res["dDelta_f"]))


def test_bootstrap_theta_and_default_uncertainty_still_available(mbar_pairs):
    """return_theta with the bootstrap method gives the svd-ew Theta, and
    the analytic uncertainty stays the default, as in the JAX package."""
    ours, ref = mbar_pairs["sequential"]
    res = ours.compute_free_energy_differences(uncertainty_method="bootstrap", return_theta=True)
    res_j = ref.compute_free_energy_differences(uncertainty_method="bootstrap", return_theta=True)
    assert np.max(np.abs(res["Theta"] - np.asarray(res_j["Theta"]))) <= 1e-10
    default = ours.compute_free_energy_differences()
    default_j = ref.compute_free_energy_differences()
    off = ~np.eye(5, dtype=bool)
    rel = np.abs(default["dDelta_f"] - default_j["dDelta_f"])[off] / default_j["dDelta_f"][off]
    assert np.max(rel) <= 1e-8


def test_bootstrap_counts_layout():
    """uint16 multiplicities whose rows sum to N and whose state blocks sum
    to N_k; a multiplicity above 65535 widens the matrix to float32."""
    u, N_k = _oscillators(4, 50, seed=2)
    m = pymbar_tpu_torch.MBAR(u, N_k, device="cpu", n_bootstraps=3, rseed=5,
                              solver_protocol=(dict(method="dd"),))
    counts = tmbar.bootstrap_counts(m.bootstrap_rints, m.N)
    assert counts.dtype == np.uint16 and counts.shape == (3, 200)
    assert np.all(counts.sum(axis=1) == 200)
    assert np.all(counts.reshape(3, 4, 50).sum(axis=2) == 50)
    wide = tmbar.bootstrap_counts(np.zeros((2, 70000), int), 70000)
    assert wide.dtype == np.float32 and wide[0, 0] == 70000


def test_auto_mesh_bootstrap_stays_on_one_card(monkeypatch, caplog):
    """Where mesh="auto" would take several cards, a bootstrap runs on one
    (the mesh bootstrap is not yet ported) and says so."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)

    def no_mesh(*a, **k):
        raise AssertionError("the mesh was built")

    monkeypatch.setattr(tmbar, "default_mesh", no_mesh)
    u, N_k = _oscillators(4, 50, seed=2)
    with caplog.at_level(logging.INFO, logger=tmbar.__name__):
        m = pymbar_tpu_torch.MBAR(u, N_k, device="cpu", mesh="auto", n_bootstraps=2, rseed=1)
    assert m.mesh is None and m.f_k_boots.shape == (2, 4)
    assert "mesh bootstrap is not yet ported" in caplog.text


def test_rints_follow_the_jax_stream_for_interleaved_samples():
    """Samples of a state need not be contiguous: the draw for x_kindices in
    any order is the JAX package's loop (mbar.py:885-895), index for index."""
    u, N_k = _oscillators(4, 30, seed=6)
    perm = np.random.default_rng(2).permutation(u.shape[1])
    x_kindices = np.repeat(np.arange(4), 30)[perm]
    m = pymbar_tpu_torch.MBAR(u[:, perm], N_k, x_kindices=x_kindices, n_bootstraps=3, rseed=9,
                              device="cpu")
    rng = np.random.default_rng(9)
    rng.choice(np.arange(120), 50)  # the duplicate-state scan's draw
    for b in range(3):
        rints = np.zeros(120, int)
        for k in range(4):
            k_indices = np.where(x_kindices == k)[0]
            rints[k_indices] = k_indices[rng.integers(int(N_k[k]), size=int(N_k[k]))]
        assert np.array_equal(m.bootstrap_rints[b], rints)
