"""The port's 1-D mesh (pymbar_tpu_torch.parallel) against the JAX package's
on the CPU: the analogues of the 1-D parts of tests/test_sharding.py.

The port's mesh here is P CPU shards (``default_mesh(P, device="cpu")``),
the JAX package's the 8 virtual CPU devices of tests/conftest.py.  Inputs
are made with numpy from a seed and handed to both.  Every JAX mesh result
is computed once, in a module-scoped fixture: a JAX mesh solve costs tens
of seconds on the CPU (each adaptive iteration traces its shard_maps anew),
so the JAX mesh solves start from the single-device solution (they then
take one float32 iteration and a short polish), while the port's start from
zeros, and the coarse path is held to the JAX package's single-device
coarse solve, which tests/test_sharding.py:176-203 holds to its mesh.
Tolerances are those of tests/test_sharding.py, cited at each test.
"""

import logging

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose
from scipy.special import logsumexp

import jax.numpy as jnp

import pymbar_tpu
import pymbar_tpu_torch
from helpers import make_ho
from pymbar_tpu import solvers_large as jsl
from pymbar_tpu.ops.mbar_core import core_stats as jax_core_stats
from pymbar_tpu.parallel import sharding as js
from pymbar_tpu_torch import solvers_large as tsl
from pymbar_tpu_torch.ops import mbar_core as tcore
from pymbar_tpu_torch.ops.wsum import wsum_dd
from pymbar_tpu_torch.parallel import sharding as ts
from pymbar_tpu_torch.utils import ParameterError

# one intra-op thread per test process: the suite's workers share the CPUs
torch.set_num_threads(1)


def _mesh(P):
    return ts.default_mesh(P, device="cpu")


def _f64(pair):
    hi, lo = pair
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


def _oscillators(K, N_k, seed, O=None, Kf=None):
    """Preconditioned u_kn of K oscillators and its dd planes."""
    rng = np.random.default_rng(seed)
    O = np.linspace(0.0, 2.0, K) if O is None else O
    Kf = np.linspace(1.0, 3.0, K) if Kf is None else Kf
    x = np.concatenate([rng.normal(o, 1.0 / np.sqrt(s), n) for o, s, n in zip(O, Kf, N_k)])
    u = 0.5 * Kf[:, None] * (x[None, :] - O[:, None]) ** 2
    u -= u.min(axis=0, keepdims=True)
    return u, tsl.host_split_planes(u)


@pytest.fixture(scope="module")
def problem():
    """tests/test_sharding.py's problem: 4 oscillators, 2600 samples."""
    test = make_ho()
    _x, u_kn, _N, _s = test.sample([800, 500, 700, 600], mode="u_kn", seed=3)
    N_k = np.array([800, 500, 700, 600], dtype=np.float64)
    f_k = np.array([0.0, 0.1, -0.2, 0.3])
    return u_kn, N_k, f_k, test


@pytest.fixture(scope="module")
def jax_on_problem(problem):
    """The JAX package's 8-device reductions and adaptive mesh solve."""
    u_kn, N_k, f_k, _ = problem
    mesh = js.default_mesh(8)
    u_s, _ = js.shard_u_kn(u_kn, mesh)
    ld = np.asarray(js.sharded_log_denominator(u_s, N_k, f_k, mesh))[: u_kn.shape[1]]
    stats = [np.asarray(x) for x in js.sharded_core_stats(u_s, N_k, f_k, mesh)]
    gram = [np.asarray(x) for x in js.sharded_gram(u_s, N_k, f_k, mesh)]
    f_single = pymbar_tpu.MBAR(u_kn, N_k.astype(int)).f_k
    f_solve, info = js.sharded_solve_mbar(u_kn, N_k, f_k=f_single, mesh=mesh, tol=1e-12)
    assert info["success"]
    return dict(ld=ld, stats=stats, gram=gram, f_solve=np.asarray(f_solve))


@pytest.mark.parametrize("P", [2, 4, 8])
def test_sharded_reductions_match_jax_and_single_device(problem, jax_on_problem, P):
    """Tolerances of tests/test_sharding.py:37-65."""
    u_kn, N_k, f_k, _ = problem
    mesh = _mesh(P)
    u_s, n_pad = ts.shard_u_kn(u_kn, mesh)
    assert n_pad == (-u_kn.shape[1]) % P and len(u_s) == P
    u = torch.from_numpy(u_kn)

    ld = torch.cat(ts.sharded_log_denominator(u_s, N_k, f_k, mesh)).numpy()[: u_kn.shape[1]]
    for ref in (tcore.log_denominator_n(u, N_k, f_k).numpy(), jax_on_problem["ld"]):
        assert_allclose(ld, ref, rtol=1e-12)

    obj, g, fs = (x.numpy() for x in ts.sharded_core_stats(u_s, N_k, f_k, mesh))
    for ref in ([x.numpy() for x in tcore.core_stats(u, N_k, f_k)], jax_on_problem["stats"]):
        assert_allclose(obj, ref[0], rtol=1e-12)
        assert_allclose(g, ref[1], rtol=1e-10, atol=1e-10)
        assert_allclose(fs, ref[2], rtol=1e-12)

    gram, col = (x.numpy() for x in ts.sharded_gram(u_s, N_k, f_k, mesh))
    for ref in ([x.numpy() for x in tcore.mbar_w_nk_gram(u, N_k, f_k)], jax_on_problem["gram"]):
        assert_allclose(gram, ref[0], rtol=1e-10, atol=1e-12)
        assert_allclose(col, ref[1], rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("case", ["pads", "clash_columns"])
def test_sharded_core_stats_pads_and_huge_real_columns(problem, case):
    """+inf pad columns add exactly 0 (tests/test_sharding.py:85-104); a
    real column huge in one or in every state is kept, not taken for
    padding (:393-416).  Against the port's and JAX's single-device
    core_stats."""
    u_kn, N_k, f_k, _ = problem
    if case == "pads":
        u, N = u_kn[:, :-1], N_k.copy()
        N[-1] -= 1
        P = 8
    else:
        rng = np.random.default_rng(12)
        u = rng.uniform(0.0, 5.0, (4, 160))
        u -= u.min(axis=0, keepdims=True)
        u[0, 7] = 1.0e12
        u[:, 11] = 6.0e9 + rng.uniform(0, 1, 4)
        N, P = np.full(4, 40.0), 3
    u_s, n_pad = ts.shard_u_kn(u, _mesh(P))
    assert n_pad > 0
    obj, g, fs = (x.numpy() for x in ts.sharded_core_stats(u_s, N, f_k, _mesh(P)))
    refs = [
        [x.numpy() for x in tcore.core_stats(torch.from_numpy(u), N, f_k)],
        [np.asarray(x) for x in jax_core_stats(jnp.asarray(u), jnp.asarray(N), jnp.asarray(f_k))],
    ]
    for ref in refs:
        assert_allclose(obj, ref[0], rtol=1e-12)
        assert_allclose(g, ref[1], rtol=1e-10, atol=1e-10)
        assert_allclose(fs, ref[2], rtol=1e-12)


@pytest.mark.parametrize("P", [2, 3])
def test_sharded_solve_mbar_matches_jax(problem, jax_on_problem, P):
    """tests/test_sharding.py:68-82: 1e-9 against the JAX mesh solve; P = 3
    leaves 2600 samples with +inf pad columns."""
    u_kn, N_k, _, test = problem
    f, info = ts.sharded_solve_mbar(u_kn, N_k, mesh=_mesh(P), tol=1e-12)
    assert info["success"] and info["gnorm"] < 1e-6
    assert np.max(np.abs(f - jax_on_problem["f_solve"])) < 1e-9
    ours = pymbar_tpu_torch.MBAR(u_kn, N_k.astype(int), device="cpu")
    assert np.max(np.abs(f - ours.f_k)) < 1e-9
    fa = test.analytical_free_energies()
    assert np.max(np.abs(f - (fa - fa[0]))) < 0.2


@pytest.mark.parametrize("P", [3, 8])
def test_sharded_solve_mbar_dd_matches_single_device(P):
    """tests/test_sharding.py:148-173 (3603 samples: pads at both P): 5e-10
    against the port's and the JAX package's single-device dd solves."""
    N_k = np.array([1501, 1201, 901])
    k_spring = np.array([1.0, 2.0, 4.0])
    _u, (uh, ul) = _oscillators(3, N_k, 33, O=np.array([0.0, 1.0, 2.0]), Kf=k_spring)
    f, info = ts.sharded_solve_mbar_dd(uh, ul, N_k, mesh=_mesh(P))
    assert info["converged"] and info["polish_iterations"] > 0
    f_port, _ = tsl.solve_mbar_dd(uh, ul, N_k, device="cpu")
    f_jax, _ = jsl.solve_mbar_dd(uh, ul, N_k)
    assert np.max(np.abs(f - f_port)) < 5e-10
    assert np.max(np.abs(f - np.asarray(f_jax))) < 5e-10
    f_true = -0.5 * np.log(2 * np.pi / k_spring)
    assert np.max(np.abs(f - (f_true - f_true[0]))) < 0.1


@pytest.fixture(scope="module")
def coarse():
    """tests/test_sharding.py:176-203's problem (8 states x 403 samples) and
    the JAX package's single-device dd solve of it on the coarse path, which
    that test holds to its mesh solve at 5e-10 (a JAX mesh solve on the
    coarse path costs ~25 s here)."""
    N_k = np.full(8, 403)
    _u, (uh, ul) = _oscillators(8, N_k, 7)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsl, "COARSE_MIN_ELEMS", 1024)
        f_jax, info = jsl.solve_mbar_dd(uh, ul, N_k)
    assert info["f32_coarse_iterations"] > 0
    return uh, ul, N_k, np.asarray(f_jax)


@pytest.mark.parametrize("P", [3, 8])
def test_sharded_solve_mbar_dd_coarse_path(monkeypatch, coarse, P):
    """With COARSE_MIN_ELEMS moved to 1024 in both packages, the port's mesh
    solve takes the global strided subsample (3224 samples: pads, and shard
    starts that are not stride multiples) and agrees with its single-device
    solve and the JAX package's coarse solve to 5e-10."""
    uh, ul, N_k, f_jax = coarse
    monkeypatch.setattr(tsl, "COARSE_MIN_ELEMS", 1024)
    f_single, info_s = tsl.solve_mbar_dd(uh, ul, N_k, device="cpu")
    assert info_s["f32_coarse_iterations"] > 0
    f, info = ts.sharded_solve_mbar_dd(uh, ul, N_k, mesh=_mesh(P))
    assert info["f32_coarse_iterations"] > 0 and info["converged"]
    assert np.max(np.abs(f - f_single)) < 5e-10
    assert np.max(np.abs(f - f_jax)) < 5e-10


def test_strided_shards_are_the_global_subsample():
    u = torch.arange(2 * 23, dtype=torch.float32).reshape(2, 23)
    mesh = _mesh(4)
    u_s, _ = ts._split_columns(u, mesh, 1.0e10)
    sub = torch.cat(ts._strided_shards(u_s, mesh, 5), dim=1)
    padded = torch.cat([u, torch.full((2, 1), 1.0e10)], dim=1)
    assert torch.equal(sub, padded[:, ::5])


@pytest.fixture(scope="module")
def wsum_case(problem):
    """Preconditioned dd planes of the problem minus one sample (pads at
    P = 8), g = f + ln N_k, per-sample counts, and the JAX mesh's sums."""
    u_kn, N_k, f_k, _ = problem
    u = u_kn[:, :-1] - u_kn[:, :-1].min(axis=0, keepdims=True)
    N = N_k.copy()
    N[-1] -= 1
    uh = u.astype(np.float32)
    ul = (u - uh).astype(np.float32)
    g = f_k + np.log(N)
    gh = g.astype(np.float32)
    gl = (g - gh).astype(np.float32)
    c = np.random.default_rng(3).integers(0, 4, u.shape[1]).astype(np.float32)
    mesh = js.default_mesh(8)
    uh_s, ul_s, n_pad = js.shard_dd_planes(uh, ul, mesh)
    c_s = js.jax.device_put(np.concatenate([c, np.zeros(n_pad, np.float32)]),
                            js.NamedSharding(mesh, js.P("n")))
    jax_S = {
        False: _f64(js.sharded_wsum_dd(uh_s, ul_s, jnp.asarray(gh), jnp.asarray(gl), mesh)),
        True: _f64(js.sharded_wsum_dd(uh_s, ul_s, jnp.asarray(gh), jnp.asarray(gl), mesh, c=c_s)),
    }
    return uh, ul, gh, gl, c, jax_S


@pytest.mark.parametrize("counts", [False, True])
@pytest.mark.parametrize("P", [3, 8])
def test_sharded_wsum_dd_matches_jax(wsum_case, P, counts):
    """1e-12 relative against the JAX mesh's sums (tests/test_sharding.py:513)
    and against the port's single-device wsum_dd."""
    uh, ul, gh, gl, c, jax_S = wsum_case
    mesh = _mesh(P)
    uh_s, ul_s, n_pad = ts.shard_dd_planes(uh, ul, mesh)
    c_s = ts._split_columns(torch.from_numpy(c), mesh, 0.0)[0] if counts else None
    gt, glt = torch.from_numpy(gh), torch.from_numpy(gl)
    S = _f64(ts.sharded_wsum_dd(uh_s, ul_s, gt, glt, mesh, c=c_s))
    S1 = _f64(wsum_dd(torch.from_numpy(uh), torch.from_numpy(ul), gt, glt,
                      torch.from_numpy(c) if counts else None))
    assert_allclose(S, jax_S[counts], rtol=1e-12, atol=0)
    assert_allclose(S, S1, rtol=1e-12, atol=0)


@pytest.fixture(scope="module")
def lognum_case():
    """tests/test_sharding.py:337-364's planes (K 5 x N 1003) and the JAX
    mesh's sharded_fused_lognum_dd of them."""
    rng = np.random.default_rng(34)
    u64 = rng.normal(0, 3, (5, 1003)) + rng.normal(0, 2, (1, 1003))
    u64 -= u64.min()
    g64 = rng.normal(0, 1, 5)
    uh, gh = u64.astype(np.float32), g64.astype(np.float32)
    ul, gl = (u64 - uh).astype(np.float32), (g64 - gh).astype(np.float32)
    ld64 = logsumexp(g64[:, None] - u64, axis=0)
    m_k = np.max(-ld64[None, :] - u64, axis=1).astype(np.float32)
    ln64 = logsumexp(-ld64[None, :] - u64, axis=1)
    mesh = js.default_mesh(8)
    uh_s, ul_s, _ = js.shard_dd_planes(uh, ul, mesh)
    ln_jax = _f64(js.sharded_fused_lognum_dd(uh_s, ul_s, jnp.asarray(gh), jnp.asarray(gl),
                                             jnp.asarray(m_k), mesh))
    return uh, ul, gh, gl, m_k, ln64, ln_jax


@pytest.mark.parametrize("P", [1, 3, 8])
def test_sharded_fused_lognum_matches_jax_and_scipy(lognum_case, P):
    """1e-10 against scipy's f64 logsumexp (tests/test_sharding.py:364) and
    the JAX mesh; 1003 samples leave pads at P = 3 and 8."""
    uh, ul, gh, gl, m_k, ln64, ln_jax = lognum_case
    mesh = _mesh(P)
    uh_s, ul_s, _ = ts.shard_dd_planes(uh, ul, mesh)
    ln = _f64(ts.sharded_fused_lognum_dd(uh_s, ul_s, *(torch.from_numpy(a) for a in (gh, gl, m_k)),
                                         mesh))
    assert np.max(np.abs(ln - ln64)) < 1e-10
    assert np.max(np.abs(ln - ln_jax)) < 1e-10


@pytest.fixture(scope="module")
def with_empty_state(problem):
    """The problem with an empty state inserted (tests/test_sharding.py:206-225)
    and the JAX MBAR on its 8-device mesh, with its free energies."""
    u_kn, N_k, _, _ = problem
    u = np.insert(u_kn, 2, u_kn[1] + 0.7, axis=0)
    N = np.insert(N_k.astype(int), 2, 0)
    f_single = pymbar_tpu.MBAR(u, N).f_k
    jax_mesh = pymbar_tpu.MBAR(u, N, mesh=js.default_mesh(8), initial_f_k=f_single)
    assert jax_mesh.mesh is not None
    return u, N, jax_mesh.f_k, jax_mesh.compute_free_energy_differences()


def test_mbar_mesh_front_door_matches_jax(with_empty_state):
    """MBAR(mesh=) with an empty state: f_k within 1e-10 of the JAX MBAR on
    its mesh and of the port's single-device MBAR; Delta_f within 1e-9 and
    dDelta_f within 1e-8 (tests/test_sharding.py:219-225)."""
    u, N, f_jax, res_jax = with_empty_state
    mesh = _mesh(8)
    m = pymbar_tpu_torch.MBAR(u, N, mesh=mesh, device="cpu")
    assert m.mesh is mesh
    assert m.solver_results[0]["success"] and m.solver_results[0]["info"]["polish_iterations"] > 0
    single = pymbar_tpu_torch.MBAR(u, N, device="cpu")
    assert np.max(np.abs(m.f_k - f_jax)) < 1e-10
    assert np.max(np.abs(m.f_k - single.f_k)) < 1e-10
    res = m.compute_free_energy_differences()
    assert_allclose(res["Delta_f"], res_jax["Delta_f"], atol=1e-9)
    assert_allclose(res["dDelta_f"], res_jax["dDelta_f"], atol=1e-8)


def test_mesh_auto_without_a_card_is_no_mesh(problem):
    u_kn, N_k, _, _ = problem
    if torch.cuda.device_count() > 1:
        pytest.skip("several cards: mesh='auto' takes them")
    m = pymbar_tpu_torch.MBAR(u_kn, N_k.astype(int), mesh="auto", device="cpu")
    assert m.mesh is None
    single = pymbar_tpu_torch.MBAR(u_kn, N_k.astype(int), device="cpu")
    assert np.array_equal(m.f_k, single.f_k)


def test_mesh_with_a_protocol_warns_and_is_ignored(problem, caplog):
    """tests/test_sharding.py:237-250."""
    u_kn, N_k, _, _ = problem
    with caplog.at_level(logging.WARNING, logger="pymbar_tpu_torch.mbar"):
        m = pymbar_tpu_torch.MBAR(u_kn, N_k.astype(int), mesh=_mesh(8), device="cpu",
                                  solver_protocol=(dict(method="adaptive"),))
    assert m.mesh is None
    assert any("mesh is ignored" in r.message for r in caplog.records)


def test_mesh_with_bootstraps_raises(problem):
    u_kn, N_k, _, _ = problem
    with pytest.raises(ParameterError):
        pymbar_tpu_torch.MBAR(u_kn, N_k.astype(int), mesh=_mesh(2), n_bootstraps=4, device="cpu")


def test_default_mesh(monkeypatch):
    mesh = ts.default_mesh(8, device="cpu")
    assert mesh.devices == (torch.device("cpu"),) * 8 and mesh.axis_name == "n"
    assert ts.default_mesh(device="cpu").devices == (torch.device("cpu"),)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ParameterError, match='device="cpu"'):
        ts.default_mesh()
