"""pymbar_tpu_torch.checkpoint against pymbar_tpu.checkpoint on the CPU.

Both packages write the same ``.npz`` layout, so a file written by one
loads and resumes in the other.  Harmonic oscillators made from a seed
(K = 5, N = 900, state 2 empty, the shapes of ``test_torch_expectations``);
the port runs with ``device="cpu"``.
"""

import numpy as np
import pytest
import torch

import pymbar_tpu
import pymbar_tpu.checkpoint as jck
import pymbar_tpu_torch
import pymbar_tpu_torch.checkpoint as tck

# one intra-op thread per test process: the suite's workers share the CPUs
torch.set_num_threads(1)

N_K = [300, 200, 0, 250, 150]


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """(u_kn, the port's MBAR with 3 replicates, the JAX MBAR, {package:
    path of the file it wrote})."""
    tc = pymbar_tpu_torch.testsystems.HarmonicOscillatorsTestCase()
    _x, u, N_k, _s = tc.sample(N_k=N_K, mode="u_kn", seed=1)
    ours = pymbar_tpu_torch.MBAR(u, N_k, n_bootstraps=3, rseed=7, device="cpu")
    ref = pymbar_tpu.MBAR(u, N_k, n_bootstraps=3, rseed=7)
    d = tmp_path_factory.mktemp("checkpoints")
    paths = {"torch": d / "torch.npz", "jax": d / "jax.npz"}
    tck.save_mbar(ours, paths["torch"])
    jck.save_mbar(ref, paths["jax"])
    return u, ours, ref, paths


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_files_load_in_both_packages(saved, writer):
    u, ours, ref, paths = saved
    m = ours if writer == "torch" else ref
    for load in (tck.load_mbar_state, jck.load_mbar_state):
        state = load(paths[writer])
        assert set(state) == {"format_version", "f_k", "N_k", "x_kindices", "K", "N", "f_k_boots",
                              "bootstrap_rints"}
        np.testing.assert_array_equal(state["f_k"], m.f_k)
        np.testing.assert_array_equal(state["bootstrap_rints"], np.asarray(m.bootstrap_rints))
        np.testing.assert_array_equal(state["f_k_boots"], np.asarray(m.f_k_boots))
    # one rseed, one draw in both packages
    np.testing.assert_array_equal(ours.bootstrap_rints, np.asarray(ref.bootstrap_rints))


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_resume_resolves_to_the_saved_point(saved, writer):
    u, ours, ref, paths = saved
    m = tck.resume_mbar(paths[writer], u, device="cpu")
    m_ref = jck.resume_mbar(paths[writer], u)
    assert m.u_kn.device.type == "cpu"
    np.testing.assert_allclose(m.f_k, ours.f_k, atol=1e-9)
    np.testing.assert_allclose(m.f_k, m_ref.f_k, atol=1e-9)
    r, r_ref = m.compute_free_energy_differences(), m_ref.compute_free_energy_differences()
    np.testing.assert_allclose(r["Delta_f"], r_ref["Delta_f"], atol=1e-9)
    np.testing.assert_allclose(r["dDelta_f"], r_ref["dDelta_f"], rtol=1e-8, atol=1e-12)


def test_resume_rejects_wrong_shape(saved):
    u, _ours, _ref, paths = saved
    for u_bad in (u[:2], torch.from_numpy(u[:2])):
        with pytest.raises(ValueError):
            tck.resume_mbar(paths["torch"], u_bad, device="cpu")
        with pytest.raises(ValueError):
            tck.resume_mbar(paths["torch"], u_bad, skip_solve=True)


def test_skip_solve_wraps_the_same_tensor(saved):
    """skip_solve goes through MBAR.from_solution: the saved f_k bit for bit
    (the JAX package's too), and a tensor u_kn is wrapped, not copied."""
    u, ours, ref, paths = saved
    u_t = torch.from_numpy(u.copy())
    m = tck.resume_mbar(paths["torch"], u_t, skip_solve=True, rseed=1, verbose=False)
    assert m.u_kn.data_ptr() == u_t.data_ptr()
    np.testing.assert_array_equal(m.f_k, ours.f_k)
    assert m.n_bootstraps == 0 and m.solver_results == []
    m_ref = jck.resume_mbar(paths["torch"], u, skip_solve=True)
    np.testing.assert_array_equal(m.f_k, m_ref.f_k)
    r = m.compute_free_energy_differences()
    r_ref = m_ref.compute_free_energy_differences()
    np.testing.assert_allclose(r["Delta_f"], r_ref["Delta_f"], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(r["dDelta_f"], r_ref["dDelta_f"], rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("kwargs, error", [(dict(n_bootstraps=2), ValueError),
                                           (dict(relative_tolerance=1e-9), TypeError),
                                           (dict(solver_protocol="robust"), TypeError)])
def test_skip_solve_rejects_solver_options(saved, kwargs, error):
    u, _ours, _ref, paths = saved
    for resume in (tck.resume_mbar, jck.resume_mbar):
        with pytest.raises(error):
            resume(paths["torch"], u, skip_solve=True, **kwargs)
