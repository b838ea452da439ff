"""A host-resident u_kn on the card against the resident route.

Needs an NVIDIA card (marker ``cuda``); skips without one.  Imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_host_resident_cuda.py

``MBAR(torch.from_numpy(u), N_k, device="cuda")`` keeps u_kn in host memory
and streams its column chunks through pinned staging to the card; the same
numpy matrix as a CUDA tensor takes the resident route.  The dd planes are
bit-identical, so the dd solves agree bit for bit (f_k, f_k_boots) with
equal kernel launch counts; the streamed passes after the solve compute
each chunk's weights as fresh tensors in both modes, and are held within
1e-12 (values) and 1e-10 (uncertainties), relative to the largest entry.
"""

import numpy as np
import pytest
import torch

import pymbar_tpu_torch
import pymbar_tpu_torch.mbar as tmbar
from pymbar_tpu_torch import solvers_large as tsl
from pymbar_tpu_torch.ops import mbar_core as tcore
from pymbar_tpu_torch.ops import wsum as tw
from pymbar_tpu_torch.ops import wsum_split as tws
from pymbar_tpu_torch.parallel import sharding

pytestmark = pytest.mark.cuda

SPLIT_COUNTERS = ("SHIFT_LAUNCHES", "DENOM_SUMS_LAUNCHES", "WSUM_DENOM_LAUNCHES")


def _close(ours, ref, tol):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    scale = max(float(np.max(np.abs(ref))), 1.0)
    assert float(np.max(np.abs(ours - ref))) <= tol * scale


def _sample(K, npk, seed, empty=()):
    tc = pymbar_tpu_torch.testsystems.HarmonicOscillatorsTestCase(
        O_k=np.linspace(0, 4, K), K_k=np.linspace(1, 3, K))
    N_k = [0 if k in empty else npk for k in range(K)]
    x, u, N_k, _s = tc.sample(N_k=N_k, mode="u_kn", seed=seed)
    return x, u, np.asarray(N_k)


@pytest.fixture(scope="module")
def dd_problem():
    """64 oscillators x 625 samples each (N = 40,000; 20 MB: the dd route)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return _sample(64, 625, 11)


def _counted(fn):
    """fn's result and the K1 and split-route launches it made."""
    tw.WSUM_LAUNCHES = 0
    for n in SPLIT_COUNTERS:
        setattr(tws, n, 0)
    out = fn()
    torch.cuda.synchronize()
    return out, [tw.WSUM_LAUNCHES] + [getattr(tws, n) for n in SPLIT_COUNTERS]


def _pair(u, N_k, **kw):
    """(host-mode MBAR, resident MBAR, their launch counts) on the same u."""
    host, n_host = _counted(lambda: pymbar_tpu_torch.MBAR(torch.from_numpy(u), N_k,
                                                          device="cuda", **kw))
    res, n_res = _counted(lambda: pymbar_tpu_torch.MBAR(torch.from_numpy(u).cuda(), N_k, **kw))
    return host, res, n_host, n_res


def test_dd_route_is_bit_identical(dd_problem):
    x, u, N_k = dd_problem
    uh, ul = tsl.stream_split_planes(torch.from_numpy(u), "cuda")
    dh, dl = tsl.dev_split_planes(torch.from_numpy(u).cuda())
    assert torch.equal(uh, dh) and torch.equal(ul, dl)
    host, res, n_host, n_res = _pair(u, N_k)
    assert host.u_kn.device.type == "cpu" and host.device.type == "cuda"
    assert host.solver_protocol[0]["method"] == res.solver_protocol[0]["method"] == "dd"
    np.testing.assert_array_equal(host.f_k, res.f_k)
    assert n_host == n_res and n_host[0] > 0
    a, b = host.compute_free_energy_differences(), res.compute_free_energy_differences()
    _close(a["Delta_f"], b["Delta_f"], 1e-12)
    _close(a["dDelta_f"], b["dDelta_f"], 1e-10)
    _close(host.compute_effective_sample_number(), res.compute_effective_sample_number(), 1e-10)
    _close(host.compute_overlap()["matrix"], res.compute_overlap()["matrix"], 1e-10)
    _close(host.Log_W_nk, res.Log_W_nk, 1e-12)
    _close(host.W_nk, res.W_nk, 1e-12)


def test_split_route_at_4097_states():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _x, u, N_k = _sample(4097, 2, 3)
    host, res, n_host, n_res = _pair(u, N_k)
    np.testing.assert_array_equal(host.f_k, res.f_k)
    assert n_host == n_res and n_host[0] == 0 and n_host[1] > 0


def test_counts_bootstrap_is_bit_identical(dd_problem):
    _x, u, N_k = dd_problem
    host, res, n_host, n_res = _pair(u, N_k, n_bootstraps=8, rseed=5)
    assert host.bootstrap_at_floor is not None
    np.testing.assert_array_equal(host.f_k, res.f_k)
    np.testing.assert_array_equal(host.f_k_boots, res.f_k_boots)
    assert n_host == n_res


def test_sequential_bootstrap_with_an_empty_state():
    """An empty state: the base dd solve streams the sampled rows (f_k bit
    for bit); the replicates take the sequential route from the host (each
    replicate's columns gathered there and uploaded) where the resident
    route batches them: within 1e-9, as chip_smoke.py holds the two."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _x, u, N_k = _sample(32, 2048, 9, empty=(5,))  # 16 MB: the dd route
    host, res, _n_host, _n_res = _pair(u, N_k, n_bootstraps=3, rseed=2)
    assert host.solver_protocol[0]["method"] == "dd"
    np.testing.assert_array_equal(host.f_k, res.f_k)
    assert np.max(np.abs(host.f_k_boots - res.f_k_boots)) <= 1e-9


def test_mesh_of_card_shards(dd_problem):
    _x, u, N_k = dd_problem
    mesh = sharding.default_mesh(4, device="cuda:0")
    host, res, n_host, n_res = _pair(u, N_k, mesh=mesh)
    assert host.mesh is mesh and res.mesh is mesh
    np.testing.assert_array_equal(host.f_k, res.f_k)
    assert n_host == n_res and n_host[0] > 0
    u_e = np.insert(u, 3, u[2] + 0.5, axis=0)
    N_e = np.insert(N_k, 3, 0)
    host_e, res_e, _a, _b = _pair(u_e, N_e, mesh=mesh)
    assert np.max(np.abs(host_e.f_k - res_e.f_k)) <= 1e-12


def test_from_solution_and_streamed_expectations(dd_problem, monkeypatch):
    x, u, N_k = dd_problem
    f = pymbar_tpu_torch.MBAR(torch.from_numpy(u).cuda(), N_k).f_k
    host = pymbar_tpu_torch.MBAR.from_solution(torch.from_numpy(u), N_k, f, device="cuda")
    res = pymbar_tpu_torch.MBAR.from_solution(torch.from_numpy(u).cuda(), N_k, f)
    assert host.u_kn.device.type == "cpu"
    monkeypatch.setattr(tmbar, "_AUG_STREAM_BYTES", 0)
    for call in (lambda m: m.compute_expectations(x),
                 lambda m: m.compute_expectations(x, uncertainty_method="approximate"),
                 lambda m: m.compute_perturbed_free_energies(np.vstack([u[0], u[7]])),
                 lambda m: m.compute_entropy_and_enthalpy()):
        a, b = call(host), call(res)
        for key in b:
            _close(a[key], b[key], 1e-12 if key in ("mu", "Delta_f", "Delta_u", "Delta_s")
                   else 1e-10)


@pytest.mark.parametrize("layout", ["pinned", "noncontiguous", "float32"])
def test_input_layouts(dd_problem, layout):
    _x, u, N_k = dd_problem
    ref = pymbar_tpu_torch.MBAR(torch.from_numpy(u), N_k, device="cuda")
    if layout == "pinned":
        u_in = torch.from_numpy(u).pin_memory()
    elif layout == "noncontiguous":
        u_in = torch.from_numpy(np.ascontiguousarray(u.T)).T
    else:
        u_in = torch.from_numpy(u.astype(np.float32))
        ref = pymbar_tpu_torch.MBAR(torch.from_numpy(u.astype(np.float32).astype(np.float64)),
                                    N_k, device="cuda")
    m = pymbar_tpu_torch.MBAR(u_in, N_k, device="cuda")
    assert m.u_kn is u_in
    np.testing.assert_array_equal(m.f_k, ref.f_k)


def test_below_the_dd_gate_uploads_for_the_solve_only():
    """A host-mode problem below the dd gate (8 x 500, 32 kB): the adaptive
    protocol runs on a whole upload, freed after the solve (what stays on
    the card is the solver's K-vectors); f_k within 1e-12 of the resident
    route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _x, u, N_k = _sample(8, 500, 4)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    host = pymbar_tpu_torch.MBAR(torch.from_numpy(u), N_k, device="cuda")
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() - before < u.nbytes // 4
    res = pymbar_tpu_torch.MBAR(torch.from_numpy(u).cuda(), N_k)
    assert host.solver_protocol[0]["method"] == "adaptive"
    np.testing.assert_allclose(host.f_k, res.f_k, rtol=0, atol=1e-12)


def test_host_mode_peak_is_below_the_resident_route(monkeypatch):
    """64 x 160,000 (82 MB) with 4 MB chunks: the peak device memory of the
    host-mode solve and free energies stays below the resident route's by
    at least 0.8 x u_kn's bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _x, u, N_k = _sample(64, 2500, 6)
    monkeypatch.setattr(tcore, "_CHUNK_BYTES", 4 * 2**20)

    def peak(make):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        u_in = make()
        m = pymbar_tpu_torch.MBAR(u_in, N_k, device="cuda")
        m.compute_free_energy_differences()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base, m.f_k

    p_host, f_host = peak(lambda: torch.from_numpy(u))
    p_res, f_res = peak(lambda: torch.from_numpy(u).cuda())
    np.testing.assert_array_equal(f_host, f_res)
    assert p_res - p_host >= 0.8 * u.nbytes, (p_host, p_res, u.nbytes)
