"""The roofline probes K8a-c (``pymbar_tpu_torch.ops.roofline``) on the CPU.

On CPU tensors the wrappers run their plain versions; the CUDA kernels are
held against those on the card (tests/test_torch_roofline_cuda.py and
chip_smoke.py).  The plain chains must be the numpy recurrences bit for
bit (x * x + c: the same two roundings) or within 4 ulp (exp: the two
libraries' exp may differ by an ulp, and the map contracts).  The pinned
weight sum must be steps x the JAX package's ``wsum_dd_ref`` of the tile,
1e-13 relative (both f64 inside; steps scales exactly).
"""

import numpy as np
import pytest
import torch

from pymbar_tpu.ops import pallas_kernels as pk
from pymbar_tpu_torch.ops import roofline as tr

# one intra-op thread per test process: the suite's workers share the CPUs
torch.set_num_threads(1)

OMEGA = 0.5671432904097838  # the fixed point of x = exp(-x)


def _start(n, dtype, seed=0):
    return np.random.default_rng(seed).uniform(0.5, 0.9, n).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fma_chain_plain_is_the_numpy_recurrence(dtype):
    x0 = _start(257, dtype)
    x = x0.copy()
    c = dtype(tr.FMA_C)
    for _ in range(6):
        x = x * x + c
    out = tr.fma_chain(torch.from_numpy(x0), tr.FMA_C, 6)
    assert out.dtype == torch.from_numpy(x0).dtype
    assert np.array_equal(out.numpy(), x)
    # the chain settles where x * x is below the ulp of c: x = c (float32)
    # or c + c^2 (float64), as on the TPU, and never underflows
    settled = tr.fma_chain_plain(torch.from_numpy(x0), tr.FMA_C, 40).numpy()
    assert np.allclose(settled, c, rtol=1e-8, atol=0) and np.all(settled > 0)


def test_exp_chain_plain_is_the_numpy_recurrence():
    x0 = _start(257, np.float64, seed=1)
    x = x0.copy()
    for _ in range(9):
        x = np.exp(-x)
    out = tr.exp_chain(torch.from_numpy(x0), 9).numpy()
    assert np.max(np.abs(out - x) / x) <= 4 * np.finfo(np.float64).eps
    settled = tr.exp_chain_plain(torch.from_numpy(x0), 200).numpy()
    assert np.max(np.abs(settled - OMEGA)) <= 4 * np.finfo(np.float64).eps


def test_cpu_chains_launch_nothing():
    before = (tr.FMA_LAUNCHES, tr.EXP_LAUNCHES, tr.PINNED_LAUNCHES)
    x = torch.from_numpy(_start(64, np.float64))
    tr.fma_chain(x, tr.FMA_C, 3)
    tr.exp_chain(x, 3)
    tr.wsum_pinned(*_tile(4, 8, 0), 3)
    assert (tr.FMA_LAUNCHES, tr.EXP_LAUNCHES, tr.PINNED_LAUNCHES) == before


@pytest.mark.parametrize(
    "fn,x,err",
    [
        ("fma", torch.zeros(8, dtype=torch.int32), TypeError),
        ("fma", torch.zeros((2, 4)), ValueError),
        ("fma", torch.zeros(0), ValueError),
        ("exp", torch.zeros(8, dtype=torch.float32), TypeError),
        ("exp", torch.zeros(16, dtype=torch.float64)[::2], ValueError),
    ],
)
def test_chain_rejects(fn, x, err):
    with pytest.raises(err):
        if fn == "fma":
            tr.fma_chain(x, tr.FMA_C, 2)
        else:
            tr.exp_chain(x, 2)


def _tile(K, tile, seed):
    """The probe's tile pair as numpy float32 (u_hi in [0, 50), u_lo tiny,
    g_hi in [-2, 2), g_lo = 0), as CPU tensors."""
    rng = np.random.default_rng(seed)
    uh = rng.uniform(0.0, 50.0, (K, tile)).astype(np.float32)
    ul = rng.uniform(-1e-7, 1e-7, (K, tile)).astype(np.float32)
    gh = rng.uniform(-2.0, 2.0, K).astype(np.float32)
    return [torch.from_numpy(a) for a in (uh, ul, gh, np.zeros(K, np.float32))]


@pytest.mark.parametrize("K,tile,steps", [(16, 128, 8192), (64, 32, 3), (5, 1, 7)])
def test_wsum_pinned_plain_is_steps_times_the_jax_tile_sum(K, tile, steps):
    planes = _tile(K, tile, K + tile)
    S = sum(t.double() for t in tr.wsum_pinned(*planes, steps)).numpy()
    Sh, Sl = pk.wsum_dd_ref(*(p.numpy() for p in planes))
    S_ref = steps * (np.asarray(Sh, np.float64) + np.asarray(Sl, np.float64))
    assert np.max(np.abs(S - S_ref) / S_ref) <= 1e-13


def test_wsum_pinned_rejects_a_tile_that_is_not_a_power_of_two():
    with pytest.raises(ValueError, match="power of two"):
        tr.wsum_pinned(*_tile(4, 12, 0), 2)
    with pytest.raises(ValueError):
        tr.wsum_pinned(*_tile(4, 8, 0), 0)


@pytest.mark.parametrize(
    "probe",
    [tr.measure_fma_peak, tr.measure_exp_rate, tr.measure_wsum_ceiling,
     tr.measure_wsum_big_ceiling],
)
def test_measurements_need_a_card(probe):
    """A measurement path that finds no card fails; it never times the CPU."""
    with pytest.raises(ValueError, match="CUDA card"):
        probe(device="cpu")
