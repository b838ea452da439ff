"""The port's bootstrap path against the JAX package's, on the CPU.

The same numpy inputs go to both packages: the double-word planes, base
solution, chord factor and resample counts of ``bootstrap_polish_dd``, the
f64 matrix of ``solve_mbar_dd_bootstrap``, and ``u_kn`` with one ``rseed``
for ``MBAR(n_bootstraps=B)``.  Tolerances: ``bootstrap_polish_dd`` within
1e-10 of JAX's (the JAX package's CPU dd exp is capped at ~1.4e-11
relative, docs/numerics.md; the port's is plain f64), the port's batched
engine within 5e-11 of its serial one (tests/test_solvers_large.py:324),
``MBAR``'s ``f_k_boots`` and bootstrap ``dDelta_f`` within 1e-9, and
``bootstrap_rints`` equal.  The mesh bootstrap (CPU shards) is held to
JAX's single-card replicates within 5e-10, and ``MBAR(mesh=,
n_bootstraps=)`` to the JAX MBAR within tests/test_sharding.py's bars
(5e-8; 5e-7 with an empty state); ``batched_bootstrap_solve`` to JAX's
within 1e-9.  Each JAX result is computed once per module.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pymbar_tpu
import pymbar_tpu_torch
from pymbar_tpu import solvers as jsolvers
from pymbar_tpu import solvers_large as jsl
from pymbar_tpu.ops.doubledouble import dd_from_f64
from pymbar_tpu.ops.mbar_core import precondition_u_kn
from pymbar_tpu_torch import mbar as tmbar
from pymbar_tpu_torch import solvers as tsolvers
from pymbar_tpu_torch import solvers_large as tsl
from pymbar_tpu_torch.parallel import sharding as ts

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


@pytest.fixture(scope="module")
def port_serial(problem):
    return _port_polish(problem, mode="serial")


def _identity(n_fail, info, n_boot):
    assert info["at_floor"].shape == (n_boot,)
    assert n_fail + info["n_at_floor"] + info["n_tol_converged"] == n_boot


@pytest.fixture(scope="module")
def jax_batched(problem):
    """JAX's single-card bootstrap_polish_dd on the problem's planes."""
    p = problem
    fb_j, nf_j, _bi = jsl.bootstrap_polish_dd(
        p["uh"], p["ul"], p["N_k"], p["f_k"], p["hinv"], p["counts"]
    )
    return np.asarray(fb_j), nf_j


def test_batched_matches_jax(problem, port_batched, jax_batched):
    fb_j, nf_j = jax_batched
    fb, nf, bi = port_batched
    assert np.max(np.abs(fb - fb_j)) <= 1e-10
    assert nf == nf_j == 0
    _identity(nf, bi, B)
    assert set(bi) >= {"phase_walls", "fast_iters", "exact_iters", "exact_deltas"}
    assert bi["exact_iters"].shape == (B,) and bi["exact_deltas"].shape == (16, B)
    assert set(bi["phase_walls"]) == {
        "prep_s", "upload_s", "materialize_s", "fast_s", "exact_s", "total_s"}


def test_batched_matches_serial(problem, port_batched, port_serial):
    fb, _nf, _bi = port_batched
    fs, nf, bi = port_serial
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
def sharded_runs(problem):
    """sharded_bootstrap_polish_dd on P CPU shards of the problem's planes,
    from JAX's base solution and chord factor, cached by (P, mode)."""
    runs = {}

    def run(P, mode):
        if (P, mode) not in runs:
            p = problem
            mesh = ts.default_mesh(P, device="cpu")
            uh_s, ul_s, n_pad = ts.shard_dd_planes(p["uh"], p["ul"], mesh)
            runs[P, mode] = (n_pad, *ts.sharded_bootstrap_polish_dd(
                uh_s, ul_s, p["N_k"], p["f_k"], p["hinv"], p["counts"], mesh, mode=mode))
        return runs[P, mode]

    return run


@pytest.mark.parametrize("mode", ["batched", "serial"])
@pytest.mark.parametrize("P", [2, 3])
def test_sharded_bootstrap_matches_jax(sharded_runs, jax_batched, P, mode):
    """The mesh bootstrap on 2 and 3 CPU shards (3 leaves a pad column)
    within 5e-10 of JAX's single-card replicates; serial within 5e-11 of
    batched (tests/test_solvers_large.py:324's bar)."""
    n_pad, fb, nf, bi = sharded_runs(P, mode)
    assert n_pad == (0 if P == 2 else 1)
    assert np.max(np.abs(fb - jax_batched[0])) <= 5e-10
    assert nf == 0
    _identity(nf, bi, B)
    if mode == "serial":
        assert bi["polish_iterations"].shape == (B,) and np.all(bi["polish_iterations"] >= 1)
        assert np.max(np.abs(fb - sharded_runs(P, "batched")[1])) <= 5e-11


@pytest.mark.parametrize("P", [2, 3])
def test_sharded_serial_stops_as_one_card(sharded_runs, port_serial, P):
    """From the same base f_k, chord factor and counts, the mesh's serial
    polish stops each replicate where the single card's does: the same stop
    (d < tol or a noise-floor rule) after the same number of K1 passes."""
    _n_pad, _fb, nf, bi = sharded_runs(P, "serial")
    _fs, nf_1, bi_1 = port_serial
    assert nf == nf_1
    assert np.array_equal(bi["at_floor"], bi_1["at_floor"])
    assert np.array_equal(bi["polish_iterations"], bi_1["polish_iterations"])


@pytest.mark.parametrize("P", [2, 3])
def test_sharded_exact_phase_stops_as_one_card(problem, P):
    """The batched exact phase from one start F on the mesh and on one card
    stops every replicate alike (same stop, same iterations, at_floor
    counted alike).  The start is the single card's float32 fast phase: the
    mesh's own fast phase sums its float32 partials per shard, so it may
    hand the exact phase another start within _BATCH_FAST_TOL, and the
    stops then differ while the fixed points agree (the 5e-10 of
    test_sharded_bootstrap_matches_jax)."""
    p = problem
    uh, ul = torch.from_numpy(p["uh"]), torch.from_numpy(p["ul"])
    K, N = uh.shape
    C = torch.from_numpy(p["counts"].astype(np.uint8))
    N_k64 = torch.from_numpy(p["N_k"])
    f0 = torch.from_numpy(p["f_k"] - p["f_k"][0])
    hinv = torch.from_numpy(np.array(p["hinv"]))
    n_chunk = tsl._batch_chunk_width(K, N)
    F, _it = tsl._polish_while_dd_batch_fast(uh, ul, C, N_k64, f0, hinv, 1.0, n_chunk)
    one = tsl._polish_while_dd_batch_exact(uh, ul, C, N_k64, F, f0, hinv, 1e-12, 1.0, 16, n_chunk)
    mesh = ts.default_mesh(P, device="cpu")
    uh_s, ul_s, _n_pad = ts.shard_dd_planes(p["uh"], p["ul"], mesh)
    C_s = ts._split_columns(C, mesh, 0)[0]
    S_fn = ts._sharded_batch_S_fn(uh_s, ul_s, C_s, mesh, tsl._batch_chunk_width(K, uh_s[0].shape[1]))
    on_mesh = tsl._batch_exact_from_S_fn(S_fn, F, N_k64, f0, hinv, 1e-12, 1.0, 16)
    for name, a, b in zip(("F", "iters", "deltas", "converged", "at_floor"), on_mesh, one):
        if name == "F":
            assert float((a - b).abs().max()) <= 1e-13
        elif name == "deltas":
            assert torch.equal(torch.isnan(a), torch.isnan(b))
        else:
            assert torch.equal(a, b), name


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


def _dd_pair_problem():
    return _oscillators(32, 256, seed=4)


@pytest.fixture(scope="module")
def mbar_pairs():
    """(port MBAR, JAX MBAR) with one rseed: the dd counts route (K = 32 x
    256, an explicit dd protocol, B = 6) and the sequential route (the
    quickstart, state 2 empty, default protocols, B = 8)."""
    dd = (dict(method="dd"),)
    u, N_k = _dd_pair_problem()
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


def _assert_mesh_bootstrap_matches_jax(m, ref):
    """tests/test_sharding.py:454-464's bars against the JAX dd MBAR."""
    assert m.mesh is not None and m.bootstrap_at_floor.shape == (B,)
    assert np.array_equal(m.bootstrap_rints, ref.bootstrap_rints)
    assert np.max(np.abs(m.f_k - ref.f_k)) <= 1e-9
    assert np.max(np.abs(m.f_k_boots - np.asarray(ref.f_k_boots))) <= 5e-8
    assert m.solver_results[0]["success"] and "planes" not in m.solver_results[0]["info"]


def test_mesh_bootstrap_matches_jax(mbar_pairs):
    """MBAR(mesh=4 CPU shards, n_bootstraps=B) solves the base and the
    replicates on the mesh: the JAX dd MBAR's stream, its replicates."""
    u, N_k = _dd_pair_problem()
    mesh = ts.default_mesh(4, device="cpu")
    m = pymbar_tpu_torch.MBAR(u, N_k, device="cpu", mesh=mesh, n_bootstraps=B, rseed=11)
    assert m.mesh is mesh
    _assert_mesh_bootstrap_matches_jax(m, mbar_pairs["dd"][1])


def test_auto_mesh_bootstrap_takes_the_mesh(mbar_pairs, monkeypatch):
    """Where mesh="auto" sees several cards (two, patched, whose mesh is two
    CPU shards here) a bootstrap takes the mesh too."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(tmbar, "default_mesh", lambda: ts.default_mesh(2, device="cpu"))
    u, N_k = _dd_pair_problem()
    m = pymbar_tpu_torch.MBAR(u, N_k, device="cpu", mesh="auto", n_bootstraps=B, rseed=11)
    assert len(m.mesh.devices) == 2
    _assert_mesh_bootstrap_matches_jax(m, mbar_pairs["dd"][1])


def test_mesh_bootstrap_with_an_empty_state_falls_back(mbar_pairs):
    """With an empty state the mesh solves the base and the replicates take
    the sequential route on the CPU (tests/test_sharding.py:467-477's bar
    against the JAX MBAR's sequential replicates)."""
    u, N_k = _quickstart()
    m = pymbar_tpu_torch.MBAR(u, N_k, device="cpu", mesh=ts.default_mesh(4, device="cpu"),
                              n_bootstraps=8, rseed=3)
    ref = mbar_pairs["sequential"][1]
    assert m.mesh is not None and m.bootstrap_at_floor is None
    assert np.array_equal(m.bootstrap_rints, ref.bootstrap_rints)
    assert np.max(np.abs(m.f_k_boots - np.asarray(ref.f_k_boots))) <= 5e-7


@pytest.mark.parametrize("case", ["quickstart", "one_early"])
def test_batched_bootstrap_solve_matches_jax(mbar_pairs, monkeypatch, case):
    """solvers.batched_bootstrap_solve against pymbar_tpu's on the
    quickstart (state 2 empty, B = 8): within 1e-9, n_fail equal.
    "one_early": replicate 0 resamples the data as it is, so from the base
    solution it stops after 1 iteration while the others take ~50 forced SC
    iterations; it leaves the batch then, and every replicate still gives
    JAX's (and its own sequential solve's) result."""
    u, N_k = _quickstart()
    ours, ref = mbar_pairs["sequential"]
    rints = ours.bootstrap_rints.copy()
    kw = {}
    if case == "one_early":
        rints[0] = np.arange(u.shape[1])
        kw = dict(min_sc_iter=50)
    batch_sizes = []
    candidates = tsolvers._adaptive_candidates

    def recording(U, *a):
        batch_sizes.append(U.shape[0])
        return candidates(U, *a)

    monkeypatch.setattr(tsolvers, "_adaptive_candidates", recording)
    fb, nf = tsolvers.batched_bootstrap_solve(u, N_k, ours.f_k, rints, device="cpu", **kw)
    fb_j, nf_j = jsolvers.batched_bootstrap_solve(u, N_k, ref.f_k, rints, **kw)
    assert nf == nf_j == 0 and fb.shape == (8, 5) and np.all(fb[:, 0] == 0.0)
    assert np.max(np.abs(fb - np.asarray(fb_j))) <= 1e-9
    if case == "quickstart":
        assert np.max(np.abs(fb - ours.f_k_boots)) <= 1e-9
    else:
        assert batch_sizes[:2] == [8, 7] and batch_sizes.count(7) >= 50
        assert batch_sizes == sorted(batch_sizes, reverse=True)
        assert np.max(np.abs(fb[0] - ours.f_k)) <= 1e-12
        # a chunk of 3 replicates holds the same results
        fb3, _ = tsolvers.batched_bootstrap_solve(u, N_k, ours.f_k, rints, device="cpu",
                                                  chunk_bytes=3 * 6 * 8 * u.size, **kw)
        assert np.max(np.abs(fb3 - fb)) <= 1e-12


def test_mbar_batched_bootstrap_route(mbar_pairs, monkeypatch):
    """MBAR._bootstrap_solve_batched, its gate patched open on the CPU,
    against the JAX MBAR's sequential replicates."""
    monkeypatch.setattr(tmbar.MBAR, "_batched_boot_sized", lambda self: True)
    calls = []
    solve = tsolvers.batched_bootstrap_solve

    def counted(*a, **k):
        calls.append(1)
        return solve(*a, **k)

    monkeypatch.setattr(tsolvers, "batched_bootstrap_solve", counted)
    u, N_k = _quickstart()
    m = pymbar_tpu_torch.MBAR(u, N_k, device="cpu", n_bootstraps=8, rseed=3)
    ref = mbar_pairs["sequential"][1]
    assert calls == [1] and m.bootstrap_at_floor is None
    assert np.max(np.abs(m.f_k_boots - np.asarray(ref.f_k_boots))) <= 1e-9
    # a BAR start keeps the sequential route, as in the JAX package
    m = pymbar_tpu_torch.MBAR(u, N_k, device="cpu", n_bootstraps=2, rseed=3, initialize="BAR")
    assert calls == [1] and m.f_k_boots.shape == (2, 5)


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
