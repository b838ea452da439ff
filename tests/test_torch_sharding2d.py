"""The port's 2-D k x n mesh (pymbar_tpu_torch.parallel: mesh_2d and the
sharded2d functions) against the JAX package's on the CPU.

The port's meshes are CPU blocks (``mesh_2d(kd, nd, device="cpu")``), the
JAX package's the 8 virtual CPU devices of tests/conftest.py.  The problem
is 5 oscillator states x 2599 samples, made with numpy from a seed and
handed to both, so both axes pad on the (2, 2) mesh, K on (4, 1) (whose
last k-block holds only pad rows) and N on (1, 4).  A JAX 2-D call costs
seconds on the CPU, so the JAX side runs once per module, on its (2, 2)
mesh (its blocks on all three); the port's three meshes are held to those
results, which do not depend on the mesh (tests/test_sharding.py holds the
JAX 2-D reductions to the single device at the same tolerances).  The ring
Gram is held to JAX's single-device float32 Gram (``gram_f32_acc64``), which
costs no shard_map.  JAX's 2-D solves take tens of seconds here and are not
called: its own tests hold them to the 1-D dd solve and to MBAR, and the
port's are held to those.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax.numpy as jnp

import pymbar_tpu
import pymbar_tpu_torch
from pymbar_tpu import solvers_large as jsl
from pymbar_tpu.ops.doubledouble import dd_from_f64 as jax_dd_from_f64
from pymbar_tpu.ops.mbar_core import core_stats as jax_core_stats
from pymbar_tpu.ops.mbar_core import gram_f32_acc64 as jax_gram_f32_acc64
from pymbar_tpu.parallel import sharding as js
from pymbar_tpu_torch import solvers_large as tsl
from pymbar_tpu_torch.ops.doubledouble import dd_to_f64
from pymbar_tpu_torch.ops.wsum import wsum_dd_plain
from pymbar_tpu_torch.parallel import sharding as ts
from pymbar_tpu_torch.utils import ParameterError

# one intra-op thread per test process: the suite's workers share the CPUs
torch.set_num_threads(1)

K = 5
N_K = np.array([520, 519, 520, 520, 520])
F_K = np.array([0.0, 0.1, -0.2, 0.3, 0.05])
SHAPES = [(2, 2), (4, 1), (1, 4)]


def _oscillators(N_k, seed):
    """u_kn of K oscillators with N_k samples each."""
    rng = np.random.default_rng(seed)
    O, Kf = np.linspace(0.0, 2.0, K), np.linspace(1.0, 3.0, K)
    x = np.concatenate([rng.normal(o, 1.0 / np.sqrt(s), n) for o, s, n in zip(O, Kf, N_k)])
    return 0.5 * Kf[:, None] * (x[None, :] - O[:, None]) ** 2


def _f64(pair):
    return np.asarray(pair[0], np.float64) + np.asarray(pair[1], np.float64)


def _blocks_of(jax_array, blocks):
    """The JAX array's addressable shards in the port's [i][j] layout."""
    kb, nb = blocks[0][0].shape
    out = [[None] * len(blocks[0]) for _ in blocks]
    for shard in jax_array.addressable_shards:
        rows, cols = shard.index
        out[(rows.start or 0) // kb][(cols.start or 0) // nb] = np.asarray(shard.data)
    return out


@pytest.fixture(scope="module")
def problem():
    """u_kn and its preconditioned dd planes (JAX's no-shift split)."""
    u = _oscillators(N_K, seed=5)
    uh, ul = (np.array(a) for a in jsl.split_u_kn_streamed(u - u.min(axis=0, keepdims=True)))
    return u, uh, ul


@pytest.fixture(scope="module")
def jax_2d(problem):
    """The JAX package's blocks on all three meshes, its (2, 2) core stats on
    the f64 blocks and weight sums on the dd planes, and its single-device
    float32 Gram of the hi plane, at F_K."""
    u, uh, ul = problem
    blocks = {}
    for shape in SHAPES:
        mesh = js.mesh_2d(*shape)
        blocks[shape] = (js.shard_u_kn_2d(u, N_K, F_K, mesh),
                         js.shard_dd_planes_2d(uh, ul, N_K, F_K, mesh))
    mesh = js.mesh_2d(2, 2)
    u_sh, N_pad, f_pad, _ = blocks[(2, 2)][0]
    stats = [np.asarray(x) for x in js.sharded2d_core_stats(u_sh, N_pad, f_pad, mesh)]
    uh_s, ul_s, N_pad, f_pad, _ = blocks[(2, 2)][1]
    gram, colsum = jax_gram_f32_acc64(jnp.asarray(uh), jnp.asarray(N_K, jnp.float32),
                                      jnp.asarray(F_K, jnp.float32))
    gh, gl = jax_dd_from_f64(jnp.asarray(np.pad(F_K + np.log(N_K), (0, len(N_pad) - K))))
    S = _f64(js.sharded2d_wsum_dd(uh_s, ul_s, gh, gl, mesh))
    return dict(blocks=blocks, stats=stats, gram=np.asarray(gram), colsum=np.asarray(colsum),
                g=(np.asarray(gh), np.asarray(gl)), S=S)


@pytest.fixture(scope="module")
def jax_solves(problem):
    """JAX's single-device answers the 2-D solves are held to: MBAR's f_k
    (tests/test_sharding.py:145) and solve_mbar_dd on the same planes
    (:296)."""
    u, uh, ul = problem
    return pymbar_tpu.MBAR(u, N_K).f_k, jsl.solve_mbar_dd(uh, ul, N_K)[0]


def test_exports_cover_the_jax_package():
    import pymbar_tpu.parallel as jax_parallel

    assert set(jax_parallel.__all__) <= set(pymbar_tpu_torch.parallel.__all__)
    assert set(js.__all__) <= set(ts.__all__) and "Mesh2D" in ts.__all__
    for name in ts.__all__:
        assert hasattr(ts, name), name
    for name in pymbar_tpu_torch.parallel.__all__:
        assert getattr(pymbar_tpu_torch.parallel, name) is getattr(ts, name)
    assert "split_u_kn_streamed" in tsl.__all__ and callable(tsl.split_u_kn_streamed)


def test_split_u_kn_streamed_bits(problem):
    u = problem[0] - 3.7
    ref = [np.asarray(a) for a in jsl.split_u_kn_streamed(u.copy())]
    for given in (u, torch.from_numpy(u)):
        hi, lo = tsl.split_u_kn_streamed(given)
        assert hi.dtype == lo.dtype == torch.float32 and hi.device.type == "cpu"
        assert np.array_equal(hi.numpy(), ref[0]) and np.array_equal(lo.numpy(), ref[1])


def test_mesh_2d(monkeypatch):
    mesh = ts.mesh_2d(2, 3, device="cpu")
    assert isinstance(mesh, ts.Mesh2D) and mesh.shape == {"k": 2, "n": 3}
    assert mesh.devices == ((torch.device("cpu"),) * 3,) * 2
    assert ts.mesh_2d(1, 2, axis_names=("s", "t"), device="cpu").shape == {"s": 1, "t": 2}
    with pytest.raises(ValueError):
        ts.mesh_2d(0, 2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ParameterError, match='device="cpu"'):
        ts.mesh_2d(2, 2)
    # a card, but fewer than the mesh needs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    with pytest.raises(ParameterError, match='device="cpu"'):
        ts.mesh_2d(2, 2)


@pytest.mark.parametrize("shape", SHAPES)
def test_shard_u_kn_2d_blocks_equal_jax(problem, jax_2d, shape):
    u = problem[0]
    u_jax, N_jax, f_jax, pads_jax = jax_2d["blocks"][shape][0]
    blocks, N_pad, f_pad, pads = ts.shard_u_kn_2d(u, N_K, F_K, ts.mesh_2d(*shape, device="cpu"))
    assert pads == pads_jax
    assert np.array_equal(N_pad, N_jax) and np.array_equal(f_pad, f_jax)
    for row, ref_row in zip(blocks, _blocks_of(u_jax, blocks)):
        for b, ref in zip(row, ref_row):
            assert b.dtype == torch.float64 and b.is_contiguous()
            assert np.array_equal(b.numpy(), ref)
    # a tensor input gives the same blocks
    again = ts.shard_u_kn_2d(torch.from_numpy(u), N_K, F_K, ts.mesh_2d(*shape, device="cpu"))[0]
    assert all(torch.equal(a, b) for ra, rb in zip(again, blocks) for a, b in zip(ra, rb))


@pytest.mark.parametrize("shape", SHAPES)
def test_shard_dd_planes_2d_blocks_equal_jax(problem, jax_2d, shape):
    _, uh, ul = problem
    uh_jax, ul_jax, N_jax, f_jax, pads_jax = jax_2d["blocks"][shape][1]
    hi, lo, N_pad, f_pad, pads = ts.shard_dd_planes_2d(uh, ul, N_K, F_K,
                                                        ts.mesh_2d(*shape, device="cpu"))
    assert pads == pads_jax
    assert np.array_equal(N_pad, N_jax) and np.array_equal(f_pad, f_jax)
    for blocks, ref in ((hi, uh_jax), (lo, ul_jax)):
        for row, ref_row in zip(blocks, _blocks_of(ref, blocks)):
            for b, r in zip(row, ref_row):
                assert b.dtype == torch.float32 and b.is_contiguous()
                assert np.array_equal(b.numpy(), r)


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded2d_core_stats_match_jax(problem, jax_2d, shape):
    """tests/test_sharding.py:117-132's tolerances; pad states give
    f_sci = +inf and gradient 0, as in JAX."""
    blocks, N_pad, f_pad, _ = ts.shard_u_kn_2d(problem[0], N_K, F_K,
                                               ts.mesh_2d(*shape, device="cpu"))
    obj, g, f_sci = (x.numpy() for x in ts.sharded2d_core_stats(
        blocks, N_pad, f_pad, ts.mesh_2d(*shape, device="cpu")))
    obj_j, g_j, f_sci_j = jax_2d["stats"]
    assert_allclose(float(obj), float(obj_j), rtol=1e-12)
    assert_allclose(g[:K], g_j[:K], rtol=1e-10, atol=1e-10)
    assert_allclose(f_sci[:K], f_sci_j[:K], atol=1e-10)
    assert np.all(f_sci[K:] == np.inf) and np.all(g[K:] == 0.0)


def test_pad_test_spans_k_blocks(problem):
    """A real column that is +inf in every row of one k-block is no pad
    column: the pad test takes the column min over all k-blocks (on the
    float64 blocks and, with its finite sentinel, on the float32 planes)."""
    u = problem[0].copy()
    u[:3, [7, 2000]] = np.inf  # k-block 0 of a (2, 2) mesh holds rows 0-2
    mesh = ts.mesh_2d(2, 2, device="cpu")
    blocks, N_pad, f_pad, _ = ts.shard_u_kn_2d(u, N_K, F_K, mesh)
    obj, g, f_sci = (x.numpy() for x in ts.sharded2d_core_stats(blocks, N_pad, f_pad, mesh))
    ref = [np.asarray(x) for x in jax_core_stats(jnp.asarray(u), jnp.asarray(N_K, jnp.float64),
                                                 jnp.asarray(F_K))]
    assert_allclose(float(obj), float(ref[0]), rtol=1e-12)
    assert_allclose(g[:K], ref[1], atol=1e-10)
    assert_allclose(f_sci[:K], ref[2], atol=1e-10)
    # the hi plane: the column holds the sentinel on k-block 0 only
    uh = (u - np.where(np.isinf(u), 0.0, u).min(axis=0)).astype(np.float32)
    uh[np.isinf(uh)] = 1.0e10
    hi, _, N_pad, f_pad, _ = ts.shard_dd_planes_2d(uh, uh, N_K, F_K, mesh)
    ld, pad = ts._column_logden([row[0] for row in hi],
                                [torch.as_tensor(N_pad[i * 3:(i + 1) * 3], dtype=torch.float32)
                                 for i in range(2)],
                                [torch.zeros(3, dtype=torch.float32)] * 2, torch.device("cpu"))
    assert not bool(pad[7]) and bool(pad.sum() == 0) and float(ld[7]) != 0.0


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded2d_gram_matches_jax(problem, jax_2d, shape):
    """The ring Gram on the f32 hi planes against JAX's single-device
    float32 Gram: float32 products, so each is held at 1e-5 of its own
    scale (the column sums are ~N/K times the Gram's entries)."""
    _, uh, ul = problem
    mesh = ts.mesh_2d(*shape, device="cpu")
    hi, _, N_pad, f_pad, _ = ts.shard_dd_planes_2d(uh, ul, N_K, F_K, mesh)
    gram, colsum = ts.sharded2d_gram(hi, N_pad.astype(np.float32), f_pad.astype(np.float32), mesh)
    assert gram.dtype == colsum.dtype == torch.float64
    gram, colsum = gram.numpy()[:K, :K], colsum.numpy()[:K]
    gram_j, colsum_j = jax_2d["gram"][:K, :K], jax_2d["colsum"][:K]
    assert np.abs(gram - gram_j).max() <= 1e-5 * np.abs(gram_j).max()
    assert np.abs(colsum - colsum_j).max() <= 1e-5 * np.abs(colsum_j).max()
    assert np.array_equal(gram, gram.T)


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded2d_wsum_dd_matches_jax_and_plain(problem, jax_2d, shape):
    """K3 and K4 per block (their plain versions on the CPU) under the
    column's shared shift: within 1e-12 relative of JAX's 2-D weight sums
    and of the port's plain wsum on the whole planes (tests/test_sharding.py
    :280); pad states give S = 0."""
    _, uh, ul = problem
    mesh = ts.mesh_2d(*shape, device="cpu")
    hi, lo, N_pad, _, _ = ts.shard_dd_planes_2d(uh, ul, N_K, F_K, mesh)
    gh, gl = (torch.from_numpy(np.pad(a[:K], (0, len(N_pad) - K))) for a in jax_2d["g"])
    S = dd_to_f64(*ts.sharded2d_wsum_dd(hi, lo, gh, gl, mesh)).numpy()
    S_plain = dd_to_f64(*wsum_dd_plain(torch.from_numpy(uh), torch.from_numpy(ul),
                                       gh[:K].contiguous(), gl[:K].contiguous())).numpy()
    S_jax = jax_2d["S"]
    assert np.max(np.abs(S[:K] - S_jax[:K]) / np.maximum(S_jax[:K], 1.0)) < 1e-12
    assert np.max(np.abs(S[:K] - S_plain) / np.maximum(S_plain, 1.0)) < 1e-12
    assert np.all(S[K:] == 0.0)


@pytest.mark.parametrize("shape", SHAPES + [(3, 2)])
def test_sharded2d_solve_mbar_matches_jax_mbar(problem, jax_solves, shape):
    """The float64 Anderson solve: f within 1e-9 of pymbar_tpu.MBAR
    (tests/test_sharding.py:145's decimal=9)."""
    f, info = ts.sharded2d_solve_mbar(problem[0], N_K, mesh=ts.mesh_2d(*shape, device="cpu"))
    assert info["success"] and info["gnorm"] < 1e-6
    assert np.max(np.abs(f - jax_solves[0])) < 1e-9
    with pytest.raises(ValueError, match="mesh"):
        ts.sharded2d_solve_mbar(problem[0], N_K)


@pytest.mark.parametrize("shape", SHAPES + [(3, 2)])
def test_sharded2d_solve_mbar_dd_matches_jax_1d(problem, jax_solves, shape):
    """The 2-D dd solve on the global stride-16 subsample (2599 // (32 K);
    N >= 64 K): converged, within 5e-10 of JAX's solve_mbar_dd on the same
    planes (tests/test_sharding.py:296, :390)."""
    _, uh, ul = problem
    assert int(np.clip(uh.shape[1] // (32 * K), 1, 64)) == 16
    f, info = ts.sharded2d_solve_mbar_dd(uh, ul, N_K, mesh=ts.mesh_2d(*shape, device="cpu"))
    assert info["converged"] and info["f32_iterations"] > 0 and info["polish_iterations"] > 0
    assert len(info["deltas"]) == info["polish_iterations"]
    assert np.max(np.abs(f - jax_solves[1])) < 5e-10
    with pytest.raises(ValueError, match="mesh"):
        ts.sharded2d_solve_mbar_dd(uh, ul, N_K)


@pytest.fixture(scope="module")
def unstrided():
    """A 5 x 300 problem (N < 64 K, so stride2 = 1), its dd planes, and JAX's
    solve_mbar_dd on those planes."""
    N_k = np.full(K, 60)
    u = _oscillators(N_k, seed=11)
    uh, ul = (np.array(a) for a in jsl.split_u_kn_streamed(u - u.min(axis=0, keepdims=True)))
    return N_k, uh, ul, np.asarray(jsl.solve_mbar_dd(uh, ul, N_k)[0])


def test_sharded2d_solve_mbar_dd_without_subsample(unstrided):
    """stride2 = 1 (N < 64 K), the slice's case on the card: the phases read
    the whole hi plane; within 5e-10 of JAX's solve_mbar_dd on the same
    planes (tests/test_sharding.py:296), and of the port's 1-D solve_mbar_dd."""
    N_k, uh, ul, f_jax = unstrided
    assert int(np.clip(uh.shape[1] // (32 * K), 1, 64)) == 1
    f, info = ts.sharded2d_solve_mbar_dd(uh, ul, N_k, mesh=ts.mesh_2d(2, 2, device="cpu"))
    assert info["converged"]
    assert np.max(np.abs(f - f_jax)) < 5e-10
    f_1d, _ = tsl.solve_mbar_dd(uh, ul, N_k, device="cpu")
    assert np.max(np.abs(f - f_1d)) < 5e-10


def test_sharded2d_dd_anderson_fallback(problem, jax_solves, monkeypatch):
    """A chord factor that does not contract (the NaN factor of a Gram that
    is not positive definite): the polish stops at once, the dd Anderson
    iteration takes over and still lands within 5e-10."""
    _, uh, ul = problem
    calls = []

    def nan_factor(gram, colsum, N_k64):
        calls.append(1)
        return torch.full((len(N_k64) - 1,) * 2, torch.nan, dtype=torch.float64)

    monkeypatch.setattr(ts, "_newton_factor", nan_factor)
    f, info = ts.sharded2d_solve_mbar_dd(uh, ul, N_K, mesh=ts.mesh_2d(2, 2, device="cpu"))
    assert calls and info["converged"]
    assert np.isnan(info["deltas"][0]) and info["polish_iterations"] > 1
    assert info["gnorm"] < 1e-8
    assert np.max(np.abs(f - jax_solves[1])) < 5e-10
