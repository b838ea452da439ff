"""The hand-written CUDA wsum_dd kernel against its plain PyTorch version.

Needs an NVIDIA card (marker ``cuda``); skips without one.  Imports no JAX,
so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_wsum_cuda.py
"""

import pytest
import torch

from pymbar_tpu_torch.ops import wsum as tw
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


@pytest.mark.parametrize(
    "K,N,counts",
    [(1024, 65536, False), (1024, 65536, True), (3, 1000, False), (4096, 8192, False),
     (1, 1, False), (7, 33, True)],
)
def test_kernel_matches_plain(dev, K, N, counts):
    """Both are f64 inside; only the summation order differs: 1e-13."""
    uh, ul, gh, gl, c = _planes(K, N, K + N, dev)
    c = c if counts else None
    before = tw.WSUM_LAUNCHES
    S = dd_to_f64(*tw.wsum_dd(uh, ul, gh, gl, c))
    torch.cuda.synchronize()
    assert tw.WSUM_LAUNCHES == before + 1
    S_ref = dd_to_f64(*tw.wsum_dd_plain(uh, ul, gh, gl, c))
    assert float(((S - S_ref).abs() / S_ref.abs()).max()) <= 1e-13


def test_kernel_pad_columns(dev):
    uh, ul, gh, gl, _ = _planes(1024, 4096, 11, dev)
    S0 = dd_to_f64(*tw.wsum_dd(uh, ul, gh, gl))
    pad_h = torch.full((1024, 77), 1.0e10, dtype=torch.float32, device=dev)
    S1 = dd_to_f64(*tw.wsum_dd(
        torch.cat([uh, pad_h], 1), torch.cat([ul, torch.zeros_like(pad_h)], 1), gh, gl
    ))
    assert float(((S1 - S0).abs() / S0).max()) <= 1e-13
    S_pad = dd_to_f64(*tw.wsum_dd(pad_h.contiguous(), torch.zeros_like(pad_h), gh, gl))
    assert bool((S_pad == 0).all())
