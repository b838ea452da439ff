"""The hand-written CUDA kernels of the many-state route (column shift, K3
denom_sums_dd, K4 wsum_denom_dd) against their plain PyTorch versions, and
wsum_dd's split route against the K1 kernel.

Needs an NVIDIA card (marker ``cuda``); skips without one.  Imports no JAX,
so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_wsum_split_cuda.py
"""

import pytest
import torch

from pymbar_tpu_torch.ops import wsum as tw
from pymbar_tpu_torch.ops import wsum_split as ts
from pymbar_tpu_torch.ops.doubledouble import dd_from_f64, dd_to_f64

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _planes(K, N, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    u = torch.rand((K, N), generator=gen, dtype=torch.float64, device=dev) * 10.0
    uh, ul = dd_from_f64(u)
    g = torch.randn(K, generator=gen, dtype=torch.float64, device=dev) * 0.5
    gh, gl = dd_from_f64(g + torch.log(torch.tensor(N / K, dtype=torch.float64)))
    c = torch.randint(0, 4, (N,), generator=gen, device=dev).to(torch.float32)
    return uh, ul, gh, gl, c


def _rel(a, b):
    return float(((a - b).abs() / b.abs()).max())


SHAPES = [(8192, 65536, False), (8192, 65536, True), (5000, 1000, False), (1, 1, False),
          (7, 33, True),
          # rows not a multiple of the row block, N not of the column tile
          # nor of 4 (the row pass's 4-byte copies), N below one tile
          (8200, 4099, True), (33, 127, False)]


@pytest.mark.parametrize("K,N,counts", SHAPES)
def test_kernels_match_plain(dev, K, N, counts):
    """Both sides are f64 inside; only the summation order differs: 1e-13.
    The f32 shift is the same single rounding on both sides: exact."""
    uh, ul, gh, gl, c = _planes(K, N, K + N, dev)
    c = c if counts else None
    before = (ts.SHIFT_LAUNCHES, ts.DENOM_SUMS_LAUNCHES, ts.WSUM_DENOM_LAUNCHES)
    m = ts.column_shift(uh, gh)
    d = ts.denom_sums_dd(uh, ul, gh, gl, m)
    S = dd_to_f64(*ts.wsum_denom_dd(uh, ul, gh, gl, m, *d, c))
    torch.cuda.synchronize()
    after = (ts.SHIFT_LAUNCHES, ts.DENOM_SUMS_LAUNCHES, ts.WSUM_DENOM_LAUNCHES)
    assert after == tuple(b + 1 for b in before)
    assert torch.equal(m, ts.column_shift_plain(uh, gh))
    assert _rel(dd_to_f64(*d), dd_to_f64(*ts.denom_sums_dd_plain(uh, ul, gh, gl, m))) <= 1e-13
    S_ref = dd_to_f64(*ts.wsum_denom_dd_plain(uh, ul, gh, gl, m, *d, c))
    assert _rel(S, S_ref) <= 1e-13


def test_split_route_matches_k1(dev, monkeypatch):
    uh, ul, gh, gl, c = _planes(1024, 16384, 5, dev)
    S1 = dd_to_f64(*tw.wsum_dd(uh, ul, gh, gl, c))
    monkeypatch.setattr(tw, "_SPLIT_ROUTE_K", 8)
    before = tw.WSUM_LAUNCHES
    S2 = dd_to_f64(*tw.wsum_dd(uh, ul, gh, gl, c))
    torch.cuda.synchronize()
    assert tw.WSUM_LAUNCHES == before
    assert _rel(S2, S1) <= 1e-13


def test_split_route_pad_columns(dev):
    """K = 4200 lies above the gate: the split route."""
    uh, ul, gh, gl, _ = _planes(4200, 4096, 11, dev)
    S0 = dd_to_f64(*tw.wsum_dd(uh, ul, gh, gl))
    pad_h = torch.full((4200, 77), 1.0e10, dtype=torch.float32, device=dev)
    S1 = dd_to_f64(*tw.wsum_dd(
        torch.cat([uh, pad_h], 1), torch.cat([ul, torch.zeros_like(pad_h)], 1), gh, gl
    ))
    assert _rel(S1, S0) <= 1e-13
    S_pad = dd_to_f64(*tw.wsum_dd(pad_h.contiguous(), torch.zeros_like(pad_h), gh, gl))
    assert bool((S_pad == 0).all())


def test_wsum_denom_masked_column_adds_zero_and_same_bits(dev):
    """A column with d = 0 whose exp overflows (m_n far below a) adds
    exactly 0 and no NaN; two calls give the same bits."""
    uh, ul, gh, gl, c = _planes(8192, 4096, 21, dev)
    m = ts.column_shift(uh, gh)
    dh, dl = ts.denom_sums_dd(uh, ul, gh, gl, m)
    S0 = ts.wsum_denom_dd(uh, ul, gh, gl, m, dh, dl, c)
    assert torch.equal(S0[0], ts.wsum_denom_dd(uh, ul, gh, gl, m, dh, dl, c)[0])
    m2, dh2, dl2 = m.clone(), dh.clone(), dl.clone()
    m2[[5, 4000]] = -2000.0  # exp(a - m) = exp(~2000): inf in f64
    dh2[[5, 4000]] = 0.0
    dl2[[5, 4000]] = 0.0
    S1 = ts.wsum_denom_dd(uh, ul, gh, gl, m2, dh2, dl2, c)
    keep = torch.ones(4096, dtype=torch.bool, device=dev)
    keep[[5, 4000]] = False
    cols = [t[keep].contiguous() for t in (m, dh, dl, c)]
    S_ref = dd_to_f64(*ts.wsum_denom_dd(uh[:, keep].contiguous(), ul[:, keep].contiguous(),
                                        gh, gl, *cols))
    S = dd_to_f64(*S1)
    assert bool(torch.isfinite(S).all())
    assert _rel(S, S_ref) <= 1e-13
    assert _rel(S, dd_to_f64(*ts.wsum_denom_dd_plain(uh, ul, gh, gl, m2, dh2, dl2, c))) <= 1e-13
