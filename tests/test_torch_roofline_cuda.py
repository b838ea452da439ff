"""The roofline probe kernels (csrc/roofline.cu) against their plain versions.

Needs an NVIDIA card (marker ``cuda``); skips without one.  Imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_roofline_cuda.py

Tolerances: the chains within 16 ulp of the plain recurrence, over 2 FMA
steps (the kernel's fma rounds once where x * x + c rounds twice, and
x -> x^2 doubles a relative error each step: at most ~5 ulp) and 6 exp
steps (the map contracts); the pinned weight sum within 1e-13 relative of
steps x S(tile) (f64 inside, only the summation order differs).
"""

import math

import pytest
import torch

from pymbar_tpu_torch.ops import roofline as tr
from pymbar_tpu_torch.ops import wsum as tw
from pymbar_tpu_torch.ops.doubledouble import dd_to_f64

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _ulps(dtype):
    return 16 * torch.finfo(dtype).eps


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 1000, None])
def test_fma_chain_matches_plain(dev, dtype, n):
    n = n or tr.chain_width(dev)
    x0 = torch.rand(n, generator=torch.Generator(device=dev).manual_seed(n),
                    dtype=torch.float64, device=dev).mul_(0.4).add_(0.5).to(dtype)
    before = tr.FMA_LAUNCHES
    out = tr.fma_chain(x0, tr.FMA_C, 2)
    torch.cuda.synchronize()
    assert tr.FMA_LAUNCHES == before + 1
    ref = tr.fma_chain_plain(x0, tr.FMA_C, 2)
    assert float(((out - ref).abs() / ref).max()) <= _ulps(dtype)
    settled = tr.fma_chain(x0, tr.FMA_C, 64)
    assert torch.allclose(settled, torch.full_like(settled, tr.FMA_C), rtol=1e-8, atol=0)


def test_exp_chain_matches_plain(dev):
    n = tr.chain_width(dev)
    x0 = torch.rand(n, generator=torch.Generator(device=dev).manual_seed(3),
                    dtype=torch.float64, device=dev).mul_(0.4).add_(0.5)
    before = tr.EXP_LAUNCHES
    out = tr.exp_chain(x0, 6)
    torch.cuda.synchronize()
    assert tr.EXP_LAUNCHES == before + 1
    ref = tr.exp_chain_plain(x0, 6)
    assert float(((out - ref).abs() / ref).max()) <= _ulps(torch.float64)


@pytest.mark.parametrize("K,tile,steps", [(1024, 512, 64), (4096, 128, 32), (5, 16, 3)])
def test_wsum_pinned_matches_plain(dev, K, tile, steps):
    planes = tr.pinned_tile(K, tile, dev, seed=K)
    before = tr.PINNED_LAUNCHES
    S = dd_to_f64(*tr.wsum_pinned(*planes, steps))
    torch.cuda.synchronize()
    assert tr.PINNED_LAUNCHES == before + 1
    S_ref = dd_to_f64(*tr.wsum_pinned_plain(*planes, steps))
    assert float(((S - S_ref).abs() / S_ref).max()) <= 1e-13


def test_one_step_is_the_production_kernel(dev):
    """steps = 1 reads the tile once, as K1 does: the same sums."""
    planes = tr.pinned_tile(1024, 512, dev, seed=7)
    S1 = dd_to_f64(*tr.wsum_pinned(*planes, 1))
    S = dd_to_f64(*tw.wsum_dd(*planes))
    assert float(((S1 - S).abs() / S).max()) <= 1e-13


def test_measurements_are_rates(dev):
    rates = [
        tr.measure_fma_peak(torch.float32, steps=2**10, reps=1),
        tr.measure_fma_peak(torch.float64, steps=2**10, reps=1),
        tr.measure_exp_rate(steps=2**8, reps=1),
        tr.measure_wsum_ceiling(steps=64, reps=1),
    ]
    assert all(math.isfinite(r) and r > 0 for r in rates)
