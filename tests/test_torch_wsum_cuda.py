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
     (1, 1, False), (7, 33, True),
     # K not a multiple of the cluster or of 256 rows; N not a multiple of
     # the column tile nor of 4 (the 4-byte copies)
     (1000, 4099, True), (257, 70, False),
     # N below one column tile; clusters of 2 and 3 blocks either side of
     # 1024 states, and of 8 just below the split-route gate
     (1024, 31, False), (1025, 5000, True), (4095, 130, False),
     # the flagship's mesh shard (4 shards of 999,424 samples)
     (1024, 249856, False), (1024, 249856, True)],
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


@pytest.mark.parametrize("K,N", [(1024, 65536), (4096, 8192)])
def test_kernel_gives_the_same_bits_twice(dev, K, N):
    """No atomics: clusters of 2 and of 8 blocks are deterministic."""
    uh, ul, gh, gl, c = _planes(K, N, 3, dev)
    a = tw.wsum_dd(uh, ul, gh, gl, c)
    b = tw.wsum_dd(uh, ul, gh, gl, c)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("K", [2500, 4096, 8192])
def test_fused_form_up_to_its_cluster_limit(dev, monkeypatch, K):
    """Clusters of 5, 8 and 16 blocks (16: the non-portable size), K1 run
    past the split-route gate as the many-state checks run it."""
    monkeypatch.setattr(tw, "_SPLIT_ROUTE_K", 2**31)
    uh, ul, gh, gl, c = _planes(K, 20000, K, dev)
    before = tw.WSUM_LAUNCHES
    S = dd_to_f64(*tw.wsum_dd(uh, ul, gh, gl, c))
    torch.cuda.synchronize()
    assert tw.WSUM_LAUNCHES == before + 1
    S_ref = dd_to_f64(*tw.wsum_dd_plain(uh, ul, gh, gl, c))
    assert float(((S - S_ref).abs() / S_ref.abs()).max()) <= 1e-13


def test_k1_raises_beyond_its_largest_cluster(dev, monkeypatch):
    """8193 states need 17 blocks of 512 rows: K1 raises, nothing falls
    back."""
    monkeypatch.setattr(tw, "_SPLIT_ROUTE_K", 2**31)
    uh, ul, gh, gl, _ = _planes(8193, 64, 5, dev)
    before = tw.WSUM_LAUNCHES
    with pytest.raises(RuntimeError):
        tw.wsum_dd(uh, ul, gh, gl)
    assert tw.WSUM_LAUNCHES == before
