"""The 2-D mesh's weight sums (sharded2d_wsum_dd: the column shift, K3
denom_sums_dd and K4 wsum_denom_dd on every block) on blocks of one card,
against the same composition of the plain versions and against one card's
split route on the whole planes.

Needs an NVIDIA card (marker ``cuda``); skips without one.  Imports no JAX,
so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_sharding2d_cuda.py
"""

import pytest
import torch

from pymbar_tpu_torch.ops import wsum as tw
from pymbar_tpu_torch.ops import wsum_split as tsp
from pymbar_tpu_torch.ops.doubledouble import dd_from_f64, dd_to_f64
from pymbar_tpu_torch.parallel import sharding as ts

pytestmark = pytest.mark.cuda

COUNTERS = ("SHIFT_LAUNCHES", "DENOM_SUMS_LAUNCHES", "WSUM_DENOM_LAUNCHES")


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
    return uh, ul, gh, gl


def _rel(a, b):
    return float(((a - b).abs() / b.abs().clamp_min(1.0)).max())


def _wsum_2d(uh, ul, gh, gl, shape, dev):
    """S of sharded2d_wsum_dd on a ``shape`` mesh of ``dev``, f64 on the
    real states, and the launch counts it added."""
    mesh = ts.mesh_2d(*shape, device=dev)
    hi, lo, N_pad, _, _ = ts.shard_dd_planes_2d(uh, ul, torch.ones(uh.shape[0]),
                                                torch.zeros(uh.shape[0]), mesh)
    pad = len(N_pad) - uh.shape[0]
    gh_p = torch.nn.functional.pad(gh, (0, pad))
    gl_p = torch.nn.functional.pad(gl, (0, pad))
    before = [getattr(tsp, n) for n in COUNTERS]
    S = dd_to_f64(*ts.sharded2d_wsum_dd(hi, lo, gh_p, gl_p, mesh))
    torch.cuda.synchronize()
    launches = [getattr(tsp, n) - b for n, b in zip(COUNTERS, before)]
    assert bool((S[uh.shape[0]:] == 0).all())
    return S[: uh.shape[0]], launches


CASES = [((2, 2), 8192, 16384), ((4, 1), 1000, 4099), ((1, 4), 1000, 4099),
         ((3, 2), 8193, 4099)]


@pytest.mark.parametrize("shape,K,N", CASES)
def test_wsum_2d_matches_plain_and_split_route(dev, monkeypatch, shape, K, N):
    """The kernels against the same composition of their plain versions
    (1e-13: f64 inside both, only the summation order differs), and
    against one card's split route on the whole planes (1e-12: the
    partials are summed in another order); kd x nd launches of each
    kernel per call, the same bits twice."""
    uh, ul, gh, gl = _planes(K, N, K + N, dev)
    S, launches = _wsum_2d(uh, ul, gh, gl, shape, dev)
    assert launches == [shape[0] * shape[1]] * 3
    S2, _ = _wsum_2d(uh, ul, gh, gl, shape, dev)
    assert torch.equal(S, S2)
    S_route = dd_to_f64(*tw.split_route(uh, ul, gh, gl))
    assert _rel(S, S_route) <= 1e-12
    for name in ("column_shift", "denom_sums_dd", "wsum_denom_dd"):
        monkeypatch.setattr(ts, name, getattr(tsp, f"{name}_plain"))
    S_plain, plain_launches = _wsum_2d(uh, ul, gh, gl, shape, dev)
    assert plain_launches == [0, 0, 0]
    assert _rel(S, S_plain) <= 1e-13


def test_wsum_2d_all_pad_is_zero(dev):
    """An all-pad matrix gives S == 0 exactly, on blocks of one card."""
    K, N = 300, 1000
    uh = torch.full((K, N), 1.0e10, dtype=torch.float32, device=dev)
    gh, gl = _planes(K, 8, 1, dev)[2:]
    S, launches = _wsum_2d(uh, torch.zeros_like(uh), gh, gl, (2, 2), dev)
    assert bool((S == 0).all()) and launches == [4, 4, 4]
