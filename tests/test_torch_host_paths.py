"""FES, the batched bootstrap, 'svd' and the 2-D mesh of pymbar_tpu_torch
through their streamed column-chunk passes on the CPU.

A CPU tensor ``u_kn`` with a CUDA ``device`` stays in host memory
(``FES(torch.from_numpy(u), N_k, device="cuda")``, as for ``MBAR``): each
pass streams its column chunks to the card (``ops.mbar_core.stream_columns``),
the batched bootstrap copies each replicate's columns out of those chunks,
'svd' folds the R factor of W chunk by chunk, the 2-D split writes each
chunk into the mesh's blocks.  Without a card the same code runs on the CPU, its chunks
views of u_kn; ``mbar_core._CHUNK_BYTES`` is moved small so that many ragged
chunks run.  The card's staging is held to the resident route in
tests/test_torch_host_paths_cuda.py.

The same seeded numpy inputs go to the JAX package, with the port's f_k set
to its solution where only the passes differ.  Tolerances:

* FES histogram (analytical, and B = 4 bootstrap replicates from the same
  ``seed``): f_i within 1e-12, df_i within 1e-10 relative of
  ``pymbar_tpu.FES``; the same against the port's unchunked run.
* ``solvers.batched_bootstrap_solve`` in chunks of 3 replicates, each
  copied out of 31-column chunks, against
  ``pymbar_tpu.solvers.batched_bootstrap_solve``: 1e-9.
* 'svd' dDelta_f and Theta within 1e-10 relative of ``pymbar_tpu``'s 'svd',
  with and without an empty state; the augmented 'svd' of
  ``compute_expectations`` (mu 1e-12, sigma 1e-10 relative) on both of the
  port's branches.
* The streamed 2-D split bit for bit against ``shard_dd_planes_2d`` of
  ``pymbar_tpu.solvers_large.host_split_planes(u)`` on (2, 2), (3, 2) and
  (1, 4) CPU meshes, K and N ragged; the 2-D dd solve from its blocks bit
  for bit the solve from the whole planes.
"""

import numpy as np
import pytest
import torch

import pymbar_tpu
import pymbar_tpu.mbar as jmbar
import pymbar_tpu_torch
import pymbar_tpu_torch.mbar as tmbar
from pymbar_tpu import solvers as jsolvers
from pymbar_tpu import solvers_large as jsl
from pymbar_tpu_torch import solvers as tsolvers
from pymbar_tpu_torch import solvers_large as tsl
from pymbar_tpu_torch.ops import mbar_core as tcore
from pymbar_tpu_torch.parallel import sharding as ts

# one intra-op thread per test process: the suite's workers share the CPUs
torch.set_num_threads(1)

# the inputs of tests/test_torch_fes.py, test_torch_bootstrap.py and
# test_torch_host_resident.py: each JAX shape compiles once per process
K0, KU = 20.0, 100.0
CENTERS = 0.2 * np.arange(-3, 4)
EDGES = np.linspace(-0.7, 0.7, 16)
CENT = 0.5 * (EDGES[1:] + EDGES[:-1])
BRANCHES = {"streamed": 0, "materialized": 2**62}
EMPTY_STATE = [120, 90, 0, 100, 93]


def _few_columns(monkeypatch, rows, cols=7):
    """Chunks of ``cols`` float64 columns of ``rows`` rows."""
    monkeypatch.setattr(tcore, "_CHUNK_BYTES", 8 * rows * cols)


def _rel(ours, ref, tol):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert float(np.max(np.abs(ours - ref))) <= tol * float(np.max(np.abs(ref)))


def _oscillators(N_k, seed, **kw):
    tc = pymbar_tpu_torch.testsystems.HarmonicOscillatorsTestCase(**kw)
    x, u, N_k, _s = tc.sample(N_k=N_k, mode="u_kn", seed=seed)
    return x, u, np.asarray(N_k)


@pytest.fixture(scope="module")
def umbrella():
    """7 harmonic windows (Ku = 100) on a quadratic base (K0 = 20), 300
    samples each (N = 2100), and the JAX package's FES results on them:
    the analytical histogram, then B = 4 bootstrap replicates (seed 4)."""
    rng = np.random.default_rng(3)
    sigma = 1.0 / (K0 + KU)
    x = (sigma * KU * CENTERS[:, None]
         + np.sqrt(sigma) * rng.standard_normal((CENTERS.size, 300))).reshape(-1)
    u_n = K0 / 2 * x**2
    u_kn = u_n[None, :] + KU / 2 * (x[None, :] - CENTERS[:, None]) ** 2
    N_k = np.full(CENTERS.size, 300)
    jf = pymbar_tpu.FES(u_kn, N_k)
    return u_kn, u_n, x, N_k, jf.mbar.f_k, _fes_results(jf, u_n, x)


def _fes_results(fes, u_n, x):
    """(analytical f_i, df_i), then (bootstrap f_i, df_i) from seed 4."""
    out = []
    for boot in (0, 4):
        fes.generate_fes(u_n, x, histogram_parameters={"bin_edges": EDGES}, n_bootstraps=boot,
                         seed=4)
        res = fes.get_fes(CENT, reference_point="from-lowest",
                          uncertainty_method="bootstrap" if boot else "analytical")
        out.append((np.asarray(res["f_i"]), np.asarray(res["df_i"])))
    return out


def _port_fes(u_kn, u_n, x, N_k, f_k):
    fes = pymbar_tpu_torch.FES(torch.from_numpy(u_kn), N_k, device="cpu")
    fes.mbar.f_k = np.array(f_k)  # the JAX solution: only the passes differ
    return _fes_results(fes, u_n, x)


@pytest.mark.parametrize("branch", BRANCHES)
def test_fes_histogram_in_many_chunks_matches_jax(umbrella, monkeypatch, branch):
    """The histogram through 127-column chunks (the augmented Gram streamed,
    or the materialized weights built chunk by chunk), analytical and
    bootstrap, against pymbar_tpu.FES and against the port's own run in
    one chunk."""
    u_kn, u_n, x, N_k, f_k, ref = umbrella
    monkeypatch.setattr(tmbar, "_AUG_STREAM_BYTES", BRANCHES[branch])
    whole = _port_fes(u_kn, u_n, x, N_k, f_k)
    _few_columns(monkeypatch, len(N_k), cols=127)
    ours = _port_fes(u_kn, u_n, x, N_k, f_k)
    for theirs in (ref, whole):
        for (f, df), (f_ref, df_ref) in zip(ours, theirs):
            np.testing.assert_allclose(f, f_ref, rtol=0, atol=1e-12)
            np.testing.assert_allclose(df, df_ref, rtol=1e-10, atol=0)


def test_batched_bootstrap_copies_replicates_out_of_column_chunks(monkeypatch):
    """A CPU tensor through batched_bootstrap_solve in chunks of 3
    replicates, each replicate's columns copied out of 1499-column chunks
    (bit for bit u_kn[:, rints]), against the JAX package's batched solve
    on the same numpy (the quickstart oscillators, state 2 empty, B = 8):
    within 1e-9, n_fail equal."""
    _x, u, N_k = _oscillators([3000, 1500, 0, 2500, 2000], 1, O_k=[0, 1, 2, 3, 4],
                              K_k=[1, 2, 4, 8, 16])
    m = pymbar_tpu_torch.MBAR(u, N_k, n_bootstraps=8, rseed=3, device="cpu")
    f_k, rints = m.f_k, m.bootstrap_rints
    gathered = []
    gather = tsolvers._gather_replicates

    def counted(u_t, r, dev):
        out = gather(u_t, r, dev)
        gathered.append(out.shape[0])
        assert torch.equal(out, u_t[:, torch.as_tensor(r)].permute(1, 0, 2))
        return out

    monkeypatch.setattr(tsolvers, "_gather_replicates", counted)
    _few_columns(monkeypatch, len(N_k), cols=1499)
    fb, nf = tsolvers.batched_bootstrap_solve(torch.from_numpy(u), N_k, f_k, rints,
                                              chunk_bytes=3 * 6 * 8 * u.size)
    fb_j, nf_j = jsolvers.batched_bootstrap_solve(u, N_k, f_k, rints)
    assert gathered == [3, 3, 2] and nf == nf_j
    assert np.max(np.abs(fb - np.asarray(fb_j))) <= 1e-9


@pytest.mark.parametrize("N_k", [EMPTY_STATE, [120, 90, 40, 60, 93]],
                         ids=["empty_state", "all_sampled"])
def test_svd_streams_the_r_factor(monkeypatch, N_k):
    """'svd' from 7-column chunks (W never formed: _W_nk_tensor is not
    called) against pymbar_tpu's 'svd' of the whole W: dDelta_f and Theta
    within 1e-10 relative; the augmented 'svd' of compute_expectations on
    both branches (mu 1e-12, sigma 1e-10 relative)."""
    x, u, N_k = _oscillators(N_k, 7)
    ref = pymbar_tpu.MBAR(u, N_k)
    m = pymbar_tpu_torch.MBAR(torch.from_numpy(u), N_k, device="cpu")
    m.f_k = np.array(ref.f_k)
    _few_columns(monkeypatch, len(N_k))

    def no_w(self):
        raise AssertionError("'svd' formed the N x K W")

    monkeypatch.setattr(tmbar.MBAR, "_W_nk_tensor", no_w)
    res = m.compute_free_energy_differences(uncertainty_method="svd", return_theta=True)
    res_j = ref.compute_free_energy_differences(uncertainty_method="svd", return_theta=True)
    _rel(res["Theta"], res_j["Theta"], 1e-10)
    np.testing.assert_allclose(res["dDelta_f"], res_j["dDelta_f"], rtol=1e-10, atol=1e-14)
    ex_j = ref.compute_expectations(x, uncertainty_method="svd")
    for branch in BRANCHES.values():
        monkeypatch.setattr(tmbar, "_AUG_STREAM_BYTES", branch)
        monkeypatch.setattr(jmbar, "_AUG_STREAM_BYTES", branch)
        ex = m.compute_expectations(x, uncertainty_method="svd")
        np.testing.assert_allclose(ex["mu"], ex_j["mu"], rtol=0, atol=1e-12)
        np.testing.assert_allclose(ex["sigma"], ex_j["sigma"], rtol=1e-10, atol=0)


def test_svd_of_an_assigned_log_w_takes_it_as_given():
    """An assigned Log_W_nk is factored as given (its row blocks folded):
    Theta equals the public _computeAsymptoticCovarianceMatrix of the same
    W, and pymbar_tpu's 'svd' of it within 1e-10 relative."""
    _x, u, N_k = _oscillators(EMPTY_STATE, 7)
    ref = pymbar_tpu.MBAR(u, N_k)
    m = pymbar_tpu_torch.MBAR(u, N_k, device="cpu")
    m.Log_W_nk = np.array(ref.Log_W_nk)
    theta = m.compute_free_energy_differences(uncertainty_method="svd", return_theta=True)["Theta"]
    W = np.exp(np.asarray(ref.Log_W_nk))
    np.testing.assert_array_equal(theta, m._computeAsymptoticCovarianceMatrix(W, N_k, "svd"))
    _rel(theta, ref._computeAsymptoticCovarianceMatrix(W, N_k, "svd"), 1e-10)


def _ragged_u():
    """K = 5 states x N = 403 samples (ragged on every mesh below)."""
    _x, u, N_k = _oscillators([120, 90, 60, 40, 93], 9)
    return u, N_k


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("shape", [(2, 2), (3, 2), (1, 4)], ids=["2x2", "3x2", "1x4"])
def test_stream_shard_planes_2d_bits(monkeypatch, shape, dtype):
    """The streamed 2-D split of a CPU tensor in 7-column chunks, bit for
    bit shard_dd_planes_2d of the JAX package's host_split_planes: every
    (hi, lo) block, its pad rows and pad columns, the padded N_k and f_k
    and the pad counts."""
    u, N_k = _ragged_u()
    u_in = u.astype(dtype)
    f_k = np.arange(5.0)
    mesh = ts.mesh_2d(*shape, device="cpu")
    _few_columns(monkeypatch, len(N_k))
    ours = ts.stream_shard_planes_2d(torch.from_numpy(u_in), N_k, f_k, mesh)
    ref = ts.shard_dd_planes_2d(*jsl.host_split_planes(u_in.astype(np.float64)), N_k, f_k, mesh)
    assert ours[4] == ref[4] and ours[4][1] > 0
    for a, b in zip(ours[2:4], ref[2:4]):
        np.testing.assert_array_equal(a, b)
    for ours_blocks, ref_blocks in zip(ours[:2], ref[:2]):
        for row, ref_row in zip(ours_blocks, ref_blocks):
            for blk, ref_blk in zip(row, ref_row):
                assert blk.dtype == torch.float32 and blk.is_contiguous()
                np.testing.assert_array_equal(blk.numpy(), ref_blk.numpy())


def test_2d_solve_from_streamed_blocks(monkeypatch):
    """sharded2d_solve_mbar_dd on the blocks of stream_shard_planes_2d (a
    (3, 2) CPU mesh, 7-column chunks) gives the solve from the whole
    planes bit for bit, within 1e-10 of pymbar_tpu.MBAR; shard_u_kn_2d
    read in the same chunks is the +inf-padded u_kn."""
    u, N_k = _ragged_u()
    mesh = ts.mesh_2d(3, 2, device="cpu")
    _few_columns(monkeypatch, len(N_k))
    hi, lo, _N, _f, _pads = ts.stream_shard_planes_2d(torch.from_numpy(u), N_k, np.zeros(5), mesh)
    f_blocks, info = ts.sharded2d_solve_mbar_dd(hi, lo, N_k, mesh=mesh)
    f_planes, _ = ts.sharded2d_solve_mbar_dd(*tsl.dev_split_planes(torch.from_numpy(u)), N_k,
                                             mesh=mesh)
    assert info["converged"]
    np.testing.assert_array_equal(f_blocks, f_planes)
    assert np.max(np.abs(f_blocks - np.asarray(pymbar_tpu.MBAR(u, N_k).f_k))) <= 1e-10
    blocks, _N, _f, pads = ts.shard_u_kn_2d(torch.from_numpy(u), N_k, np.zeros(5), mesh)
    whole = torch.cat([torch.cat(row, dim=1) for row in blocks]).numpy()
    np.testing.assert_array_equal(whole, np.pad(u, [(0, pads[0]), (0, pads[1])],
                                                constant_values=np.inf))
