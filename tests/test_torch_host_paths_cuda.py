"""FES, the batched bootstrap, 'svd' and the 2-D mesh from a host-resident
u_kn on the card, against the resident route.

Needs an NVIDIA card (marker ``cuda``); skips without one.  Imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_host_paths_cuda.py

A CPU tensor with ``device="cuda"`` stays in host memory and each pass
streams its column chunks to the card through pinned staging; the same
numpy matrix as a CUDA tensor takes the resident route.  The dd planes and
the 2-D blocks are bit-identical, so the dd solves agree bit for bit; the
passes after the solve are held within 1e-12 (values) and 1e-10
(uncertainties), relative to the largest entry.  Chunks are cut to 1 MiB
so that the 33.5 MB problem streams in many; each path's peak device
memory from the host stays below the resident route's, which holds u_kn.
"""

import numpy as np
import pytest
import torch

import pymbar_tpu_torch
from pymbar_tpu_torch import solvers as tsolvers
from pymbar_tpu_torch.ops import mbar_core as tcore
from pymbar_tpu_torch.parallel import sharding
from pymbar_tpu_torch.solvers_large import dev_split_planes

pytestmark = pytest.mark.cuda

K0, KU = 20.0, 100.0
EDGES = np.linspace(-1.5, 1.5, 31)
CENT = 0.5 * (EDGES[1:] + EDGES[:-1])


def _close(ours, ref, tol):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    scale = max(float(np.nanmax(np.abs(ref))), 1.0)
    assert float(np.nanmax(np.abs(ours - ref))) <= tol * scale


@pytest.fixture(autouse=True)
def _small_chunks(monkeypatch):
    monkeypatch.setattr(tcore, "_CHUNK_BYTES", 1 << 20)


def _peak(fn):
    """(fn's result, its peak device bytes above what was allocated before)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


@pytest.fixture(scope="module")
def umbrella():
    """32 umbrella windows x 4,096 samples (N = 131,072; 33.5 MB: the dd
    route), centres 0.1 (-16..15), on the quadratic base (K0 = 20)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # cuBLAS takes its 32 MiB workspace at its first call on a stream and
    # keeps it: take it before any peak below is read
    eye = torch.eye(8, dtype=torch.float64, device="cuda")
    torch.dot(eye[0], eye[0] @ eye)
    rng = np.random.default_rng(5)
    centers = 0.1 * np.arange(-16, 16)
    sigma = 1.0 / (K0 + KU)
    x = (sigma * KU * centers[:, None]
         + np.sqrt(sigma) * rng.standard_normal((centers.size, 4096))).reshape(-1)
    u_n = K0 / 2 * x**2
    u_kn = u_n[None, :] + KU / 2 * (x[None, :] - centers[:, None]) ** 2
    return u_kn, u_n, x, np.full(centers.size, 4096)


def _fes_run(u_in, u_n, x, N_k, **kw):
    """FES and its analytical histogram (with their peak above what was
    allocated before), then B = 4 bootstrap replicates (seed 4) and a KDE."""

    def histogram():
        fes = pymbar_tpu_torch.FES(u_in() if callable(u_in) else u_in, N_k, **kw)
        fes.generate_fes(u_n, x, histogram_parameters={"bin_edges": EDGES})
        return fes, fes.get_fes(CENT, reference_point="from-lowest",
                                uncertainty_method="analytical")

    (fes, hist), peak = _peak(histogram)
    fes.generate_fes(u_n, x, histogram_parameters={"bin_edges": EDGES}, n_bootstraps=4, seed=4)
    boot = (fes.bootstrap_route, fes.f_k_boots.copy())
    fes.generate_fes(u_n, x, fes_type="kde", kde_parameters={"bandwidth": 0.05})
    kde = fes.get_fes(CENT, reference_point="from-lowest")["f_i"]
    return fes, hist, boot, kde, peak


def test_fes_from_host_memory(umbrella):
    """FES on the host pair: the dd solve bit for bit, the histogram, the
    counts bootstrap and the KDE as the resident route's; the solve and the
    histogram peak at least half of u_kn's bytes below the resident
    route's, which uploads u_kn inside the window."""
    u, u_n, x, N_k = umbrella
    host, hist, boot, kde, peak_host = _fes_run(torch.from_numpy(u), u_n, x, N_k,
                                                device="cuda")
    res, hist_r, boot_r, kde_r, peak_res = _fes_run(lambda: torch.from_numpy(u).cuda(), u_n,
                                                    x, N_k)
    assert host.u_kn.device.type == "cpu" and host.mbar.device.type == "cuda"
    assert host.mbar.solver_protocol[0]["method"] == "dd"
    np.testing.assert_array_equal(host.mbar.f_k, res.mbar.f_k)
    _close(hist["f_i"], hist_r["f_i"], 1e-12)
    _close(hist["df_i"], hist_r["df_i"], 1e-10)
    assert boot[0] == boot_r[0] == "counts"
    _close(boot[1], boot_r[1], 1e-12)
    _close(kde, kde_r, 1e-12)
    assert peak_host <= peak_res - u.nbytes // 2, (peak_host, peak_res, u.nbytes)


def test_fes_replicates_batched_from_host_memory(umbrella):
    """With an unsampled unbiased state the replicates take the batched
    route: from host memory, the replicates copied out of uploaded column
    chunks, f_k_boots as the resident route's within 1e-12."""
    u, u_n, x, N_k = umbrella
    u65 = np.vstack([u, u_n[None, :]])
    N65 = np.append(N_k, 0)
    gathered = []
    gather = tsolvers._gather_replicates

    def counted(u_src, *a):
        gathered.append(u_src.device.type)
        return gather(u_src, *a)

    tsolvers._gather_replicates = counted
    try:
        host = _fes_run(torch.from_numpy(u65), u_n, x, N65, device="cuda")[2]
        res = _fes_run(lambda: torch.from_numpy(u65).cuda(), u_n, x, N65)[2]
    finally:
        tsolvers._gather_replicates = gather
    assert host[0] == res[0] == "replicate"
    assert "cpu" in gathered and "cuda" in gathered
    _close(host[1], res[1], 1e-12)


def test_batched_bootstrap_from_host_memory(umbrella):
    """batched_bootstrap_solve on a CPU tensor with device="cuda" against
    the CUDA tensor: within 1e-12, n_fail equal; u_kn never whole on the
    card (the peak within the two 1 MiB staging buffers and a chunk of the
    resident route's, which does not count the resident u_kn)."""
    u, _u_n, _x, N_k = umbrella
    f_k = pymbar_tpu_torch.MBAR(torch.from_numpy(u).cuda(), N_k).f_k
    rints = np.random.default_rng(2).integers(0, u.shape[1], (6, u.shape[1]))
    (fb, nf), peak_host = _peak(lambda: tsolvers.batched_bootstrap_solve(
        torch.from_numpy(u), N_k, f_k, rints, device="cuda", chunk_bytes=3 * 6 * u.nbytes))
    u_dev = torch.from_numpy(u).cuda()
    (fb_r, nf_r), peak_res = _peak(lambda: tsolvers.batched_bootstrap_solve(
        u_dev, N_k, f_k, rints, chunk_bytes=3 * 6 * u.nbytes))
    assert nf == nf_r
    _close(fb, fb_r, 1e-12)
    assert peak_host <= peak_res + 3 * (1 << 20), (peak_host, peak_res)


def test_svd_from_host_memory(umbrella):
    """'svd' from host memory folds W's R chunk by chunk: dDelta_f and
    Theta as the resident route's (1e-10 relative), and its peak under
    u_kn's bytes."""
    u, _u_n, _x, N_k = umbrella
    res = pymbar_tpu_torch.MBAR(torch.from_numpy(u).cuda(), N_k)
    host = pymbar_tpu_torch.MBAR(torch.from_numpy(u), N_k, device="cuda")
    out, peak = _peak(lambda: host.compute_free_energy_differences(
        uncertainty_method="svd", return_theta=True))
    ref = res.compute_free_energy_differences(uncertainty_method="svd", return_theta=True)
    ew = res.compute_free_energy_differences(return_theta=True)
    _close(out["Theta"], ref["Theta"], 1e-10)
    _close(out["dDelta_f"], ref["dDelta_f"], 1e-10)
    np.testing.assert_allclose(out["dDelta_f"], ew["dDelta_f"], rtol=0, atol=1e-8)
    assert peak < u.nbytes


@pytest.mark.parametrize("shape", [(2, 2), (3, 2), (1, 4)], ids=["2x2", "3x2", "1x4"])
def test_2d_blocks_from_host_memory(umbrella, shape):
    """stream_shard_planes_2d from host memory into blocks of cuda:0, bit
    for bit shard_dd_planes_2d of the resident planes, at a peak of the
    blocks (u_kn's bytes) and chunk-sized buffers, where the resident route
    holds u_kn, its planes and the blocks; shard_u_kn_2d from the host equals it from the
    card; on (2, 2) the 2-D dd solve from the streamed blocks equals the
    one from the planes."""
    u, _u_n, _x, N_k = umbrella
    N_k = N_k[:31].copy()  # ragged K and N
    N_k[-1] -= 5
    u = u[:31, : N_k.sum()]
    mesh = sharding.mesh_2d(*shape, device="cuda:0")
    zeros = np.zeros(len(N_k))
    ours, peak = _peak(lambda: sharding.stream_shard_planes_2d(torch.from_numpy(u), N_k, zeros,
                                                               mesh))
    ref = sharding.shard_dd_planes_2d(*dev_split_planes(torch.from_numpy(u).cuda()), N_k, zeros,
                                      mesh)
    assert ours[4] == ref[4]
    for a, b in zip(ours[:2], ref[:2]):
        for row, ref_row in zip(a, b):
            for blk, ref_blk in zip(row, ref_row):
                assert torch.equal(blk, ref_blk)
    assert peak < 1.5 * u.nbytes
    host_blocks = sharding.shard_u_kn_2d(torch.from_numpy(u), N_k, zeros, mesh)[0]
    res_blocks = sharding.shard_u_kn_2d(torch.from_numpy(u).cuda(), N_k, zeros, mesh)[0]
    for row, ref_row in zip(host_blocks, res_blocks):
        for blk, ref_blk in zip(row, ref_row):
            assert torch.equal(blk, ref_blk)
    if shape == (2, 2):
        f_blocks, info = sharding.sharded2d_solve_mbar_dd(ours[0], ours[1], N_k, mesh=mesh)
        f_planes, _ = sharding.sharded2d_solve_mbar_dd(
            *dev_split_planes(torch.from_numpy(u).cuda()), N_k, mesh=mesh)
        assert info["converged"]
        np.testing.assert_array_equal(f_blocks, f_planes)
