"""The hand-written CUDA kernel of Theta's weight build (``gram_weights``)
against its plain PyTorch version on the same CUDA tensors, and the Theta
pass that runs it against the CPU.

Needs an NVIDIA card (marker ``cuda``); skips without one.  Imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_gram_weights_cuda.py

Both sides compute in the work's dtype and differ in the order of their
sums and in the kernel's online log-sum-exp (a running max, rescaled as it
rises).  float64: w within 1e-12 relative where the plain version's is
above 1e-290 (below, both are denormal or 0); logden within 1e-13 relative
to max(|logden|, 1) (a log near 0 is the difference of two larger terms);
the row and column sums, sums of positive terms, within 1e-12 relative.
float32 in proportion: 1e-4 and 1e-5, w where above 1e-30.  The column sums
come from a fixed-order fold, so a second call gives the same bits.
"""

import numpy as np
import pytest
import torch

import pymbar_tpu_torch
from pymbar_tpu_torch.ops import gram_weights as gw
from pymbar_tpu_torch.ops import mbar_core as tc

pytestmark = pytest.mark.cuda

# (w, logden, row and column sums) relative tolerances; w's floor
TOL = {torch.float64: (1e-12, 1e-13, 1e-12, 1e-290), torch.float32: (1e-4, 1e-5, 1e-4, 1e-30)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _inputs(K, nc, dtype, dev, seed, case="random"):
    """(u, N_k, f_k, sampled) on the card.  u in [0, 10); ``case``:
    "pad" appends 37 sentinel columns, "empty" makes row 1 an empty state
    whose f - u lies above every other row and leaves it out of
    ``sampled``, "spans" puts a row of +inf (a state no sample reaches)
    into u in [-700, 700) (float64; [-80, 80) in float32), with row 1
    empty as in "empty"."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    width = 1400.0 if dtype == torch.float64 else 160.0
    u = torch.rand((K, nc), generator=gen, dtype=torch.float64, device=dev)
    u = u * width - width / 2 if case == "spans" else u * 10.0
    N_k = torch.randint(1, 50, (K,), generator=gen, device=dev).to(torch.float64)
    f_k = torch.randn(K, generator=gen, dtype=torch.float64, device=dev)
    sampled = None
    if case == "pad":
        u = torch.cat([u, torch.full((K, 37), 1.0e10, dtype=u.dtype, device=dev)], dim=1)
    if case in ("empty", "spans"):
        N_k[1] = 0.0
        u[1] = u.min() - 5.0
        sampled = torch.tensor([k for k in range(K) if k != 1], device=dev)
    if case == "spans":
        u[K - 1] = torch.inf
    return u.to(dtype), N_k.to(dtype), f_k.to(dtype), sampled


def _rel(ours, ref, floor):
    ours, ref = ours.double(), ref.double()
    same = (ours == ref) | (ours.isnan() & ref.isnan())
    err = ((ours - ref).abs() / ref.abs().clamp_min(floor)).masked_fill(same, 0.0)
    return float(err.max()) if err.numel() else 0.0


def _check(u, N_k, f_k, sampled):
    dtype = u.dtype
    tol_w, tol_ld, tol_sum, w_floor = TOL[dtype]
    before = gw.GRAM_WEIGHTS_LAUNCHES
    w, ld, rs, cs = gw.gram_weights(u, N_k, f_k, sampled)
    torch.cuda.synchronize()
    assert gw.GRAM_WEIGHTS_LAUNCHES == before + 1
    w_ref, ld_ref, rs_ref, cs_ref = gw.gram_weights_plain(u, N_k, f_k, sampled)
    for o, r in ((w, w_ref), (ld, ld_ref), (rs, rs_ref), (cs, cs_ref)):
        assert o.dtype == dtype and o.shape == r.shape
        assert torch.equal(o.isnan(), r.isnan())
    assert torch.equal(w == 0, w_ref == 0)  # pad columns, underflows
    big = w_ref.abs() > w_floor
    assert _rel(w[big], w_ref[big], 0.0) <= tol_w
    assert _rel(ld, ld_ref, 1.0) <= tol_ld
    assert _rel(rs, rs_ref, w_floor) <= tol_sum
    assert _rel(cs, cs_ref, w_floor) <= tol_sum
    assert torch.equal(gw.gram_weights(u, N_k, f_k, sampled)[3], cs)  # the same bits


SHAPES = [(1, 5), (3, 1000), (1024, 65536), (4096, 16384), (300, 1000 + 37)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("K,nc", SHAPES)
def test_kernel_matches_plain(dev, K, nc, dtype):
    """The main path's chunk shapes (1024, 65,536) and (4096, 16,384), one
    row, a column count that is no multiple of the 64-column tile."""
    _check(*_inputs(K, nc, dtype, dev, K + nc))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["pad", "empty", "spans"])
def test_kernel_matches_plain_on_edge_cases(dev, case, dtype):
    _check(*_inputs(300, 2000 + 5, dtype, dev, 7, case))


@pytest.mark.parametrize("layout", ["offset_view", "odd_row_stride", "transposed"])
def test_kernel_takes_any_layout(dev, layout):
    """A chunk not 16-byte aligned (a view one column in; rows of an odd
    stride) takes the kernel's 8-byte loads; a non-unit column stride is
    copied first."""
    u, N_k, f_k, _ = _inputs(64, 3001 if layout == "odd_row_stride" else 3002,
                             torch.float64, dev, 11)
    if layout == "offset_view":
        u = u[:, 1:]
    elif layout == "odd_row_stride":
        u = u[:, :3000]
    else:
        u = u.T.contiguous().T
    _check(u, N_k, f_k, None)


def test_free_energies_launch_once_per_chunk(dev, monkeypatch):
    """One compute_free_energy_differences() on a card u_kn: the Theta pass
    goes through the kernel, one launch per column chunk."""
    monkeypatch.setattr(tc, "_CHUNK_BYTES", 8 * 5 * 700)
    t = pymbar_tpu_torch.testsystems.HarmonicOscillatorsTestCase(
        O_k=[0, 1, 2, 3, 4], K_k=[1, 2, 4, 8, 16])
    _x, u_kn, N_k, _s = t.sample(N_k=[600, 300, 0, 500, 400], mode="u_kn", seed=1)
    mbar = pymbar_tpu_torch.MBAR(torch.as_tensor(u_kn, device=dev), N_k)
    chunks = len(tc._col_ranges(5, 8, 0, u_kn.shape[1]))
    assert chunks == 3
    before = gw.GRAM_WEIGHTS_LAUNCHES
    mbar.compute_free_energy_differences()
    assert gw.GRAM_WEIGHTS_LAUNCHES - before == chunks


def _close(ours, ref, rtol=1e-12):
    """As ``tests/test_torch_mbar_core.py``: 1e-12 of the largest entry."""
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape
    scale = max(float(np.max(np.abs(ref))), np.finfo(np.float64).tiny)
    assert float(np.max(np.abs(ours - ref))) <= rtol * scale


@pytest.mark.parametrize("case", ["one_chunk", "many_chunks", "pad_sampled"])
def test_gram_normalization_on_the_card_matches_the_cpu(dev, monkeypatch, case):
    """mbar_gram_normalization on a card u_kn against the same call on the
    CPU (the plain version): Gram, column sums, the row check."""
    rng = np.random.default_rng(5)
    K, npk = 32, 256
    x = np.repeat(np.linspace(0, 4, K), npk) + rng.normal(0, 1.0, K * npk)
    u = 0.5 * np.linspace(1, 3, K)[:, None] * (x[None, :] - np.linspace(0, 4, K)[:, None]) ** 2
    N_k, f = np.full(K, float(npk)), np.linspace(0.0, 0.5, K)
    sampled = None
    if case == "many_chunks":
        monkeypatch.setattr(tc, "_CHUNK_BYTES", 8 * K * 1000)
    if case == "pad_sampled":
        u = np.concatenate([u, np.full((K, 5), 1.0e10)], axis=1)
        sampled = np.arange(0, K, 2)
    u = torch.from_numpy(u)
    ours = tc.mbar_gram_normalization(u.to(dev), N_k, f, sampled=sampled)
    ref = tc.mbar_gram_normalization(u, N_k, f, sampled=sampled)
    _close(ours[0].cpu(), ref[0])
    _close(ours[1].cpu(), ref[1])
    assert ours[2][:2] == ref[2][:2]
    assert ours[2][2] == pytest.approx(ref[2][2], abs=1e-12)
