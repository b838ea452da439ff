"""The streamed column-chunk path of pymbar_tpu_torch on the CPU.

A CPU tensor ``u_kn`` with a CUDA ``device`` stays in host memory
(``MBAR(torch.from_numpy(u), N_k, device="cuda")``): every pass streams its
column chunks to the card (``ops.mbar_core.stream_columns``), the dd split
fills the planes chunk by chunk (``solvers_large.stream_split_planes``,
``parallel.sharding.stream_shard_planes``).  Without a card the same code
runs on the CPU, its chunks then views of u_kn; ``mbar_core._CHUNK_BYTES``
is moved small here so that many chunks run.  The card's staging path is
held to the resident route in tests/test_torch_host_resident_cuda.py.

The same seeded numpy inputs go to the JAX package: the planes bit for bit
against ``pymbar_tpu.solvers_large.host_split_planes``; the mesh front door
within 5e-10 of ``pymbar_tpu.MBAR`` (tests/test_torch_sharding.py holds the
JAX package's own mesh solve to it; one costs ~20 s on the CPU); MBAR's values
within 1e-12 and uncertainties within rtol 1e-10 (the tolerances of
tests/test_torch_expectations.py).
"""

import numpy as np
import pytest
import torch

import pymbar_tpu
import pymbar_tpu.mbar as jmbar
import pymbar_tpu_torch
import pymbar_tpu_torch.mbar as tmbar
from pymbar_tpu import solvers_large as jsl
from pymbar_tpu_torch import solvers_large as tsl
from pymbar_tpu_torch.ops import mbar_core as tcore
from pymbar_tpu_torch.parallel import sharding as ts
from pymbar_tpu_torch.utils import ParameterError

# one intra-op thread per test process: the suite's workers share the CPUs
torch.set_num_threads(1)

N_K = [120, 90, 0, 100, 93]


@pytest.fixture(scope="module")
def problem():
    """Five oscillators, state 2 empty, N = 403 (odd: chunks and shards
    come out ragged); the samples x and the JAX package's MBAR on them."""
    tc = pymbar_tpu_torch.testsystems.HarmonicOscillatorsTestCase()
    x, u, N_k, _s = tc.sample(N_k=N_K, mode="u_kn", seed=7)
    return x, u, np.asarray(N_k), pymbar_tpu.MBAR(u, N_k)


def _few_columns(monkeypatch, rows, cols=7):
    """Chunks of ``cols`` float64 columns of ``rows`` rows."""
    monkeypatch.setattr(tcore, "_CHUNK_BYTES", 8 * rows * cols)


@pytest.mark.parametrize("case", ["all_rows", "rows", "noncontiguous", "float32"])
def test_stream_split_matches_dev_split_and_jax(problem, monkeypatch, case):
    """Bit for bit: the streamed split of u_kn[rows] (7-column chunks, N =
    403 not a multiple of 7) against dev_split_planes of the same rows and
    the JAX package's host_split_planes (0 ulp)."""
    _x, u, N_k, _ref = problem
    rows = np.flatnonzero(N_k > 0) if case == "rows" else None
    u_np = u.astype(np.float32) if case == "float32" else u
    # the non-contiguous input: a transposed view of an (N, K) array
    u_t = (torch.from_numpy(np.ascontiguousarray(u.T)).T if case == "noncontiguous"
           else torch.from_numpy(u_np))
    assert u_t.is_contiguous() == (case != "noncontiguous")
    _few_columns(monkeypatch, len(N_k))
    uh, ul = tsl.stream_split_planes(u_t, rows=rows)
    sel = u_np.astype(np.float64) if rows is None else u_np[rows].astype(np.float64)
    dh, dl = tsl.dev_split_planes(torch.from_numpy(sel))
    jh, jl = jsl.host_split_planes(sel)
    for ours, ref in ((uh, dh), (ul, dl), (uh, jh), (ul, jl)):
        assert ours.dtype == torch.float32
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("rows,start,stop", [(None, 0, None), ([4, 0, 3], 5, 398)])
def test_stream_columns_reassembles_u_kn(problem, monkeypatch, rows, start, stop):
    """The chunks of stream_columns cover [start, stop) in order, each within
    _CHUNK_BYTES, and put together give u_kn[rows, start:stop] exactly."""
    _x, u, _N, _ref = problem
    _few_columns(monkeypatch, 5, cols=11)
    u_t = torch.from_numpy(u)
    chunks = list(tcore.stream_columns(u_t, rows=rows, start=start, stop=stop))
    bounds = [(s, e) for s, e, _c in chunks]
    stop = u.shape[1] if stop is None else stop
    assert bounds[0][0] == start and bounds[-1][1] == stop
    assert all(b[1] == c[0] for b, c in zip(bounds, bounds[1:]))
    assert all(c.numel() * 8 <= tcore._CHUNK_BYTES for _s, _e, c in chunks)
    ref = u[:, start:stop] if rows is None else u[rows, start:stop]
    np.testing.assert_array_equal(torch.cat([c for _s, _e, c in chunks], dim=1).numpy(), ref)
    np.testing.assert_array_equal(tcore.u_kn_on(u_t, "cpu", rows).numpy()[:, start:stop], ref)


@pytest.mark.parametrize("n_cut", [3, 0], ids=["divisible", "padded"])
def test_mesh_front_door_streams_the_split(problem, monkeypatch, n_cut):
    """The 1-D mesh front door on 4 CPU shards, with the empty state (rows
    streamed into each shard's planes, the empty state filled by one
    streamed self-consistent pass): its shards equal shard_dd_planes of
    dev_split_planes(u_kn[rows]) bit for bit, and f_k lies within 5e-10 of
    the JAX package's MBAR.  N = 400 is divisible by the mesh; N = 403
    leaves pad columns."""
    _x, u, N_k, ref = problem
    N_k = N_k.copy()
    N_k[-1] -= n_cut
    u = u[:, : N_k.sum()]
    f_ref = pymbar_tpu.MBAR(u, N_k).f_k if n_cut else ref.f_k
    _few_columns(monkeypatch, 4)
    mesh = ts.default_mesh(4, device="cpu")
    sws = np.flatnonzero(N_k > 0)
    his, los = ts.stream_shard_planes(torch.from_numpy(u), mesh, sws)
    dh, dl, _ = ts.shard_dd_planes(*tsl.dev_split_planes(torch.from_numpy(u[sws])), mesh)
    for ours, theirs in zip(his + los, dh + dl):
        np.testing.assert_array_equal(ours.numpy(), theirs.numpy())
    f = ts.sharded_solve_mbar_for_all_states(torch.from_numpy(u), N_k, np.zeros(len(N_k)), sws,
                                             mesh)
    assert np.max(np.abs(f - f_ref)) < 5e-10


def test_dd_protocol_with_an_empty_state_streams_its_rows(problem, monkeypatch):
    """An explicit dd protocol with an empty state: the dd stage splits the
    sampled rows chunk by chunk (no gathered copy), the empty state is
    filled by one streamed pass; f_k within 1e-10 of the JAX package's."""
    _x, u, N_k, ref = problem
    _few_columns(monkeypatch, len(N_k))
    m = pymbar_tpu_torch.MBAR(torch.from_numpy(u), N_k, solver_protocol=({"method": "dd"},),
                              device="cpu")
    assert m.solver_results[0]["info"]["polish_iterations"] > 0
    assert np.max(np.abs(m.f_k - ref.f_k)) < 1e-10


def test_mbar_in_many_chunks_matches_jax(problem, monkeypatch):
    """MBAR with 7-column chunks and the streamed expectations branch
    against the JAX package on the same numpy: f_k, Delta_f, dDelta_f
    (svd-ew), N_eff, the overlap, Log_W_nk and one compute_expectations
    (values 1e-12, uncertainties rtol 1e-10)."""
    x, u, N_k, ref = problem
    _few_columns(monkeypatch, len(N_k))
    monkeypatch.setattr(tmbar, "_AUG_STREAM_BYTES", 0)
    monkeypatch.setattr(jmbar, "_AUG_STREAM_BYTES", 0)
    m = pymbar_tpu_torch.MBAR(torch.from_numpy(u), N_k)
    assert m.device == torch.device("cpu")
    np.testing.assert_allclose(m.f_k, ref.f_k, rtol=0, atol=1e-12)
    m.f_k = np.array(ref.f_k)  # the same solution: only the passes differ

    def close(ours, theirs, value):
        tol = dict(rtol=1e-12, atol=1e-12) if value else dict(rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs), **tol)

    res, res_j = m.compute_free_energy_differences(), ref.compute_free_energy_differences()
    close(res["Delta_f"], res_j["Delta_f"], True)
    close(res["dDelta_f"], res_j["dDelta_f"], False)
    close(m.compute_effective_sample_number(), ref.compute_effective_sample_number(), True)
    ov, ov_j = m.compute_overlap(), ref.compute_overlap()
    close(ov["matrix"], ov_j["matrix"], True)
    close(ov["eigenvalues"], ov_j["eigenvalues"], True)
    close(m.Log_W_nk, ref.Log_W_nk, True)
    close(m.W_nk, np.exp(np.asarray(ref.Log_W_nk)), True)
    ex, ex_j = m.compute_expectations(x), ref.compute_expectations(x)
    close(ex["mu"], ex_j["mu"], True)
    close(ex["sigma"], ex_j["sigma"], False)


def test_host_resident_needs_a_card(problem):
    """A CPU tensor with a CUDA device is the host-resident u_kn of MBAR and
    FES: without a card it raises ParameterError, as a numpy u_kn with no
    device does."""
    _x, u, N_k, _ref = problem
    u_t = torch.from_numpy(u)
    if torch.cuda.is_available():
        return
    for call in (lambda: pymbar_tpu_torch.MBAR(u_t, N_k, device="cuda"),
                 lambda: pymbar_tpu_torch.MBAR.from_solution(u_t, N_k, np.zeros(5), device="cuda"),
                 lambda: pymbar_tpu_torch.FES(u_t, N_k, device="cuda"),
                 lambda: pymbar_tpu_torch.MBAR(u, N_k)):
        with pytest.raises(ParameterError, match="CUDA"):
            call()


@pytest.mark.parametrize("make", ["numpy", "tensor", "float32"])
def test_other_placements_are_unchanged(problem, make):
    """numpy and device="cpu", a CPU tensor with no device, a float32 CPU
    tensor with device="cpu": u_kn lies on the CPU as float64 and the work
    runs there (the tensor itself is kept, never copied)."""
    _x, u, N_k, ref = problem
    u_in = {"numpy": u, "tensor": torch.from_numpy(u),
            "float32": torch.from_numpy(u.astype(np.float32))}[make]
    m = pymbar_tpu_torch.MBAR(u_in, N_k, device=None if make == "tensor" else "cpu")
    assert m.device == torch.device("cpu") and m.u_kn.device == torch.device("cpu")
    assert m.u_kn.dtype == torch.float64
    if make == "tensor":
        assert m.u_kn is u_in
    if make != "float32":
        np.testing.assert_allclose(m.f_k, ref.f_k, rtol=0, atol=1e-12)
