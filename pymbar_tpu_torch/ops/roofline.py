"""The roofline probes K8a-c: the card's arithmetic peaks and K1's ceiling.

Counterparts of the JAX bench's Pallas probes (``bench.py``):
``measure_vpu_peak`` (K8a), ``measure_wsum_ceiling`` (K8b) and
``measure_wsum_big_ceiling`` (K8c).

* K8a: :func:`fma_chain` runs x <- fma(x, x, c) (2 FLOP per step) and
  :func:`exp_chain` runs x <- exp(-x) (one f64 exp per step) on
  register-resident values; :func:`measure_fma_peak` and
  :func:`measure_exp_rate` turn them into FLOP/s and exps/s.
* K8b/K8c: :func:`wsum_pinned` runs K1's own kernels (``csrc/wsum.cu``'s
  column and row passes, in their pinned instantiation) over a virtual
  N = tile x steps in which column n reads column n mod tile of one
  resident tile pair, so every plane read hits L2.  The result is exactly
  steps x S(tile).  :func:`measure_wsum_ceiling` (1024, 512, 8192 steps)
  and :func:`measure_wsum_big_ceiling` (4096, 128, 16384 steps), the JAX
  shapes, return elements/s; K1's streaming element rate over that is its
  roofline fraction (``bench.py:457``).

CUDA tensors launch the hand-written kernels of ``csrc/roofline.cu``; CPU
tensors run the plain versions (``*_plain``), used by the tests.  The
``measure_*`` functions need a card and raise without one.
``FMA_LAUNCHES``, ``EXP_LAUNCHES`` and ``PINNED_LAUNCHES`` count launches.
"""

import ctypes

import torch

from pymbar_tpu_torch.ops import _build
from pymbar_tpu_torch.ops.doubledouble import dd_from_f64, dd_to_f64
from pymbar_tpu_torch.ops.wsum import wsum_dd_plain
from pymbar_tpu_torch.ops.wsum_split import check_planes, row_splits

__all__ = [
    "fma_chain",
    "fma_chain_plain",
    "exp_chain",
    "exp_chain_plain",
    "wsum_pinned",
    "wsum_pinned_plain",
    "chain_width",
    "pinned_tile",
    "measure_fma_peak",
    "measure_exp_rate",
    "measure_wsum_ceiling",
    "measure_wsum_big_ceiling",
    "FMA_LAUNCHES",
    "EXP_LAUNCHES",
    "PINNED_LAUNCHES",
]

FMA_LAUNCHES = 0
EXP_LAUNCHES = 0
PINNED_LAUNCHES = 0

# Threads per block and chains per thread of the chain kernels
# (kChainThreads, kChains in the source), and resident blocks per SM that
# fill the H100's 2048 threads per SM.
_CHAIN_THREADS = 256
_CHAINS = 8
_BLOCKS_PER_SM = 8

# The chain's additive constant and start range, as the TPU probe's.
FMA_C = 1.0e-9


def fma_chain_plain(x, c, steps):
    """x <- x * x + c, ``steps`` times, in x's dtype (two roundings per
    step where the kernel's fma rounds once)."""
    for _ in range(steps):
        x = x * x + c
    return x


def exp_chain_plain(x, steps):
    """x <- exp(-x), ``steps`` times."""
    for _ in range(steps):
        x = torch.exp(-x)
    return x


def wsum_pinned_plain(u_hi, u_lo, g_hi, g_lo, steps):
    """steps x S(tile): K1's plain version on the one tile, scaled.
    Returns (S_hi, S_lo) float32."""
    return dd_from_f64(dd_to_f64(*wsum_dd_plain(u_hi, u_lo, g_hi, g_lo)) * float(steps))


def _lib():
    lib = _build.load("roofline")
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    signatures = {
        "fma_chain_f32_launch": [p, ctypes.c_float, i64, i64, p],
        "fma_chain_f64_launch": [p, ctypes.c_double, i64, i64, p],
        "exp_chain_launch": [p, i64, i64, p],
        "wsum_pinned_launch": [p, p, p, p, i32, i64, i64, i32, p, p, p, p, p, p],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _call(fn_name, dev, *args):
    """Launch on the current stream of ``dev``; raise on a CUDA error."""
    fn = getattr(_lib(), fn_name)
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: kernel launch failed with CUDA error {err}")


def _check_chain(fn, x, dtypes, steps):
    if not torch.is_tensor(x) or x.dtype not in dtypes:
        raise TypeError(f"{fn}: x must be a tensor of {dtypes}")
    if x.ndim != 1 or x.numel() == 0 or not x.is_contiguous():
        raise ValueError(f"{fn}: x must be a non-empty contiguous 1-D tensor")
    if steps < 0:
        raise ValueError(f"{fn}: steps must be >= 0")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: no kernel for device {x.device}")


def fma_chain(x, c, steps):
    """x <- fma(x, x, c) ``steps`` times on every element of a 1-D float32
    or float64 tensor; returns a new tensor (x is left as it is)."""
    global FMA_LAUNCHES
    _check_chain("fma_chain", x, (torch.float32, torch.float64), steps)
    if x.device.type == "cpu":
        return fma_chain_plain(x, c, steps)
    out = x.clone()
    name = "fma_chain_f32_launch" if x.dtype == torch.float32 else "fma_chain_f64_launch"
    _call(name, out.device, out.data_ptr(), float(c), int(steps), out.numel())
    FMA_LAUNCHES += 1
    return out


def exp_chain(x, steps):
    """x <- exp(-x) ``steps`` times on every element of a 1-D float64
    tensor; returns a new tensor."""
    global EXP_LAUNCHES
    _check_chain("exp_chain", x, (torch.float64,), steps)
    if x.device.type == "cpu":
        return exp_chain_plain(x, steps)
    out = x.clone()
    _call("exp_chain_launch", out.device, out.data_ptr(), int(steps), out.numel())
    EXP_LAUNCHES += 1
    return out


def wsum_pinned(u_hi, u_lo, g_hi, g_lo, steps):
    """K1's S over a virtual N = tile x steps of one (K, tile) pair, column
    n reading column n mod tile (tile a power of two); equals steps x the
    S of the tile.  Inputs as :func:`pymbar_tpu_torch.ops.wsum.wsum_dd`
    (no counts).  Returns (S_hi, S_lo), (K,) float32."""
    global PINNED_LAUNCHES
    check_planes("wsum_pinned", u_hi, u_lo, g_hi, g_lo)
    K, tile = u_hi.shape
    if tile & (tile - 1) or steps <= 0:
        raise ValueError(f"wsum_pinned: tile {tile} must be a power of two, steps {steps} > 0")
    dev = u_hi.device
    if dev.type == "cpu":
        return wsum_pinned_plain(u_hi, u_lo, g_hi, g_lo, steps)
    if dev.type != "cuda":
        raise ValueError(f"wsum_pinned: no kernel for device {dev}")
    N = tile * steps
    n_split = row_splits(K, N)
    m = torch.empty(N, dtype=torch.float64, device=dev)
    r = torch.empty(N, dtype=torch.float64, device=dev)
    partial = torch.empty((n_split, K), dtype=torch.float64, device=dev)
    s_hi = torch.empty(K, dtype=torch.float32, device=dev)
    s_lo = torch.empty(K, dtype=torch.float32, device=dev)
    _call("wsum_pinned_launch", dev, u_hi.data_ptr(), u_lo.data_ptr(), g_hi.data_ptr(),
          g_lo.data_ptr(), K, tile, int(steps), n_split, m.data_ptr(), r.data_ptr(),
          partial.data_ptr(), s_hi.data_ptr(), s_lo.data_ptr())
    PINNED_LAUNCHES += 1
    return s_hi, s_lo


def chain_width(device):
    """Elements of a chain tensor that fill every SM of ``device``:
    SMs x 8 blocks x 256 threads x 8 chains."""
    sms = torch.cuda.get_device_properties(torch.device(device)).multi_processor_count
    return sms * _BLOCKS_PER_SM * _CHAIN_THREADS * _CHAINS


def _card(device):
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise ValueError(f"the roofline probes measure a CUDA card, not {device!r}")
    return dev


def _best_s(dev, fn, reps):
    """Best of ``reps`` CUDA-event-timed calls of ``fn``, after one warm-up."""
    fn()
    torch.cuda.synchronize(dev)
    best = float("inf")
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        best = min(best, t0.elapsed_time(t1) * 1.0e-3)
    return best


def _chain_start(dev, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = chain_width(dev)
    return torch.rand(n, generator=gen, dtype=torch.float64, device=dev).mul_(0.4).add_(0.5).to(dtype)


def measure_fma_peak(dtype=torch.float64, steps=2**18, reps=3, device="cuda", seed=0):
    """Sustained FMA rate of the card in FLOP/s (2 per FMA, best of
    ``reps``): :func:`fma_chain` from x in [0.5, 0.9], c = 1e-9."""
    dev = _card(device)
    with torch.cuda.device(dev):
        x = _chain_start(dev, dtype, seed)
        best = _best_s(dev, lambda: fma_chain(x, FMA_C, steps), reps)
    return 2.0 * x.numel() * steps / best


def measure_exp_rate(steps=2**14, reps=3, device="cuda", seed=0):
    """Sustained f64 exp rate of the card in exps/s (best of ``reps``):
    :func:`exp_chain` from x in [0.5, 0.9]."""
    dev = _card(device)
    with torch.cuda.device(dev):
        x = _chain_start(dev, torch.float64, seed)
        best = _best_s(dev, lambda: exp_chain(x, steps), reps)
    return float(x.numel()) * steps / best


def pinned_tile(K, tile, device, seed=0):
    """The probe's tile pair as the JAX bench makes it: u_hi in [0, 50),
    u_lo in [-1e-7, 1e-7), g_hi in [-2, 2), g_lo = 0."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    uh = torch.rand((K, tile), generator=gen, device=dev).mul_(50.0)
    ul = torch.rand((K, tile), generator=gen, device=dev).mul_(2.0e-7).sub_(1.0e-7)
    gh = torch.rand(K, generator=gen, device=dev).mul_(4.0).sub_(2.0)
    return uh, ul, gh, torch.zeros_like(gh)


def measure_wsum_ceiling(K=1024, tile=512, steps=8192, reps=3, device="cuda", seed=0):
    """K1's compute ceiling in elements/s (best of ``reps``): its kernels
    over K x tile x steps elements whose plane reads hit L2."""
    dev = _card(device)
    with torch.cuda.device(dev):
        planes = pinned_tile(K, tile, dev, seed)
        best = _best_s(dev, lambda: wsum_pinned(*planes, steps), reps)
    return float(K) * tile * steps / best


def measure_wsum_big_ceiling(K=4096, tile=128, steps=16384, reps=3, device="cuda", seed=0):
    """:func:`measure_wsum_ceiling` at the shape of the JAX package's
    K > 2048 probe (K8c)."""
    return measure_wsum_ceiling(K, tile, steps, reps, device, seed)
