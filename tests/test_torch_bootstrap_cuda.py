"""The bootstrap path on the card against the same path on the CPU.

Needs an NVIDIA card (marker ``cuda``); skips without one.  Imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_bootstrap_cuda.py

Tolerances: replicates within 1e-10 of the CPU run on the same inputs (the
float32 fast phase differs in summation order, the float64 exact phase
converges both to the dd noise floor), batched within 5e-11 of serial; the
same on the mesh (4 shards of the card against 4 CPU shards), and the
batched small-problem solve within 1e-10 of its CPU run.
"""

import numpy as np
import pytest
import torch

import pymbar_tpu_torch
from pymbar_tpu_torch import mbar as tmbar
from pymbar_tpu_torch import solvers as tsolvers
from pymbar_tpu_torch import solvers_large as tsl
from pymbar_tpu_torch.ops import wsum as tw
from pymbar_tpu_torch.parallel import sharding

pytestmark = pytest.mark.cuda

B = 6


@pytest.fixture(scope="module")
def problem():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    K, npk = 32, 256
    tc = pymbar_tpu_torch.testsystems.HarmonicOscillatorsTestCase(
        O_k=np.linspace(0, 4, K), K_k=np.linspace(1, 3, K)
    )
    _x, u_kn, N_k, _s = tc.sample(N_k=[npk] * K, mode="u_kn", seed=5)
    uh, ul = tsl.host_split_planes(u_kn)
    f_k, info = tsl.solve_mbar_dd(uh, ul, N_k, device="cpu")
    m = pymbar_tpu_torch.MBAR(u_kn, N_k, n_bootstraps=B, rseed=7, device="cpu",
                              solver_protocol=(dict(method="dd"),))
    counts = tmbar.bootstrap_counts(m.bootstrap_rints, m.N)
    return dict(u_kn=u_kn, N_k=N_k, uh=uh, ul=ul, f_k=f_k, hinv=info["hinv"].numpy(),
                counts=counts, cpu_mbar=m)


def _polish(p, dev, **kw):
    return tsl.bootstrap_polish_dd(
        torch.as_tensor(p["uh"], device=dev), torch.as_tensor(p["ul"], device=dev), p["N_k"],
        p["f_k"], p["hinv"], p["counts"], **kw,
    )


def test_batched_on_the_card_matches_the_cpu(problem):
    fb, nf, bi = _polish(problem, "cuda")
    fb_cpu, nf_cpu, _ = _polish(problem, "cpu")
    assert nf == nf_cpu == 0
    assert nf + bi["n_at_floor"] + bi["n_tol_converged"] == B
    assert np.max(np.abs(fb - fb_cpu)) <= 1e-10


def test_serial_launches_k1_with_counts(problem):
    before = tw.WSUM_LAUNCHES
    fs, nf, info = _polish(problem, "cuda", mode="serial")
    torch.cuda.synchronize()
    assert nf == 0 and tw.WSUM_LAUNCHES - before == info["polish_iterations"].sum() >= B
    fb, _, _ = _polish(problem, "cuda")
    assert np.max(np.abs(fb - fs)) <= 5e-11


def test_mbar_bootstrap_on_the_card_matches_the_cpu(problem):
    m = pymbar_tpu_torch.MBAR(problem["u_kn"], problem["N_k"], n_bootstraps=B, rseed=7,
                              solver_protocol=(dict(method="dd"),))
    ref = problem["cpu_mbar"]
    assert m.u_kn.is_cuda and m.bootstrap_at_floor is not None
    assert np.array_equal(m.bootstrap_rints, ref.bootstrap_rints)
    assert np.max(np.abs(m.f_k_boots - ref.f_k_boots)) <= 1e-10
    res = m.compute_free_energy_differences(uncertainty_method="bootstrap")
    ref_res = ref.compute_free_energy_differences(uncertainty_method="bootstrap")
    assert np.max(np.abs(res["dDelta_f"] - ref_res["dDelta_f"])) <= 1e-9


def test_fast_phase_refuses_tf32(problem, monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="TF32"):
        _polish(problem, "cuda")


def _mesh_polish(p, mesh, **kw):
    uh_s, ul_s, _ = sharding.shard_dd_planes(p["uh"], p["ul"], mesh)
    return sharding.sharded_bootstrap_polish_dd(uh_s, ul_s, p["N_k"], p["f_k"], p["hinv"],
                                                p["counts"], mesh, **kw)


def test_mesh_bootstrap_on_the_card_matches_the_cpu(problem):
    """4 shards of the card against 4 CPU shards; the serial mode launches
    K1 once per shard per polish iteration."""
    fb, nf, bi = _mesh_polish(problem, sharding.default_mesh(4, device="cuda:0"))
    fb_cpu, nf_cpu, _ = _mesh_polish(problem, sharding.default_mesh(4, device="cpu"))
    assert nf == nf_cpu == 0
    assert nf + bi["n_at_floor"] + bi["n_tol_converged"] == B
    assert np.max(np.abs(fb - fb_cpu)) <= 1e-10
    before = tw.WSUM_LAUNCHES
    fs, nf, info = _mesh_polish(problem, sharding.default_mesh(4, device="cuda:0"), mode="serial")
    torch.cuda.synchronize()
    assert nf == 0 and tw.WSUM_LAUNCHES - before == 4 * info["polish_iterations"].sum() >= 4 * B
    assert np.max(np.abs(fb - fs)) <= 5e-11


def test_mesh_mbar_bootstrap_on_the_card_matches_the_cpu(problem):
    kw = dict(n_bootstraps=B, rseed=7)
    m = pymbar_tpu_torch.MBAR(problem["u_kn"], problem["N_k"],
                              mesh=sharding.default_mesh(4, device="cuda:0"), **kw)
    ref = problem["cpu_mbar"]
    assert m.u_kn.is_cuda and m.mesh is not None and m.bootstrap_at_floor is not None
    assert np.array_equal(m.bootstrap_rints, ref.bootstrap_rints)
    assert np.max(np.abs(m.f_k_boots - ref.f_k_boots)) <= 1e-10


def test_small_problem_bootstrap_is_batched_on_the_card(problem, monkeypatch):
    """Below the dd gate a CUDA MBAR's replicates take
    batched_bootstrap_solve, whose result is the CPU run's."""
    u = problem["u_kn"][:, :2048]
    N_k = [256] * 8
    u = u[:8]
    calls = []
    solve = tsolvers.batched_bootstrap_solve

    def counted(*a, **k):
        calls.append(1)
        return solve(*a, **k)

    monkeypatch.setattr(tsolvers, "batched_bootstrap_solve", counted)
    m = pymbar_tpu_torch.MBAR(u, N_k, n_bootstraps=B, rseed=3)
    assert m.u_kn.is_cuda and calls == [1] and m.f_k_boots.shape == (B, 8)
    fb_cpu, nf = solve(u, N_k, m.f_k, m.bootstrap_rints, device="cpu")
    assert nf == 0 and np.max(np.abs(m.f_k_boots - fb_cpu)) <= 1e-10
