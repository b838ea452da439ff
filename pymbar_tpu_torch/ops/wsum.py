"""The polish kernel: S_k = sum_n c_n N_k W_nk from double-word planes.

``wsum_dd`` is the counterpart of :func:`pymbar_tpu.ops.pallas_kernels.wsum_dd`
with the same inputs, outputs and pad-column rule, minus the TPU knobs
(tile width, interpret mode, fast exp).  Any K and N are accepted; above
``_SPLIT_ROUTE_K`` states it takes the many-state route through the split
pair of :mod:`pymbar_tpu_torch.ops.wsum_split`, as the JAX package does.

* CUDA tensors launch the hand-written Hopper kernel of ``csrc/wsum.cu``
  (built by :mod:`pymbar_tpu_torch.ops._build` on first use): the
  single-read cluster kernel of ``csrc/wsum_fused.cuh``, which holds up to
  8192 states (clusters of at most 16 blocks of 512 rows).
* CPU tensors run :func:`wsum_dd_plain`, the plain PyTorch version with
  true f64 inner math (the same as ``pallas_kernels.wsum_dd_ref``).

Nothing else is accepted, and nothing falls back.  ``WSUM_LAUNCHES`` counts
the K1 kernel's launches (one per call that launches it).
"""

import ctypes

import torch

from pymbar_tpu_torch.ops import _build
from pymbar_tpu_torch.ops.doubledouble import dd_from_f64, dd_to_f64
from pymbar_tpu_torch.ops.mbar_core import _CHUNK_BYTES
from pymbar_tpu_torch.ops.wsum_split import (
    check_planes,
    column_shift,
    denom_sums_dd,
    wsum_denom_dd,
)

__all__ = [
    "wsum_dd",
    "wsum_dd_plain",
    "split_route",
    "fused_partial",
    "FUSED_MAX_K",
    "WSUM_LAUNCHES",
]

WSUM_LAUNCHES = 0

# A column is padding when max_k(g_hi - u_hi) falls below this (every row
# holds the +1e10 sentinel).
_PAD_M = -1.0e8

# Above this many states wsum_dd takes the many-state (split) route:
# column_shift -> denom_sums_dd -> pad mask -> wsum_denom_dd, as the JAX
# package does for padded K > 4096 (pallas_kernels.py:688-705).  The value
# is the JAX package's, set by the TPU's VMEM (K1 there holds a whole
# column tile of K rows); the H100's K1 holds up to 8192 states, and where
# the gate belongs on this card is still to be measured (PERF.md).  Module
# constant so tests can move it; above 8192 K1 raises.
_SPLIT_ROUTE_K = 4096

# The most states the single-read cluster kernel (K1, and K5 in
# ops/lognum.py) holds: clusters of at most 16 blocks of 512 rows
# (csrc/wsum_fused.cuh).
FUSED_MAX_K = 8192

# (card index, K) -> clusters of the fused kernel resident at once.
_MAX_CLUSTERS = {}


def wsum_dd_plain(u_hi, u_lo, g_hi, g_lo, c=None):
    """Plain PyTorch wsum with true f64 inner math, streamed over columns.

    S_k = sum_n c_n exp(a_kn - m_n) / sum_j exp(a_jn - m_n) with
    a = g - u rebuilt in f64 from the dd planes; sentinel pad columns
    (m_n < -1e8) contribute exactly zero.  Returns (S_hi, S_lo) float32.
    """
    K, N = u_hi.shape
    g64 = dd_to_f64(g_hi, g_lo)[:, None]
    S = torch.zeros(K, dtype=torch.float64, device=u_hi.device)
    width = max(1, _CHUNK_BYTES // (8 * K))
    for s in range(0, N, width):
        e = min(N, s + width)
        a = g64 - dd_to_f64(u_hi[:, s:e], u_lo[:, s:e])
        m = a.max(dim=0, keepdim=True).values
        t = a.sub_(m).exp_()
        w = t.div_(t.sum(dim=0, keepdim=True))
        w.masked_fill_(m < _PAD_M, 0.0)
        if c is not None:
            w.mul_(c[None, s:e].to(torch.float64))
        S += w.sum(dim=1)
    return dd_from_f64(S)


def _lib():
    lib = _build.load("wsum")
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    signatures = {
        "wsum_fused_launch": [p, p, p, p, p, i32, i64, i32, p, p, p, p],
        "wsum_fused_clusters": [i32, ctypes.POINTER(ctypes.c_int)],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def fused_partial(K, dev, caller="wsum_dd"):
    """The partial sums of one call of the cluster kernel (K1, or K5 for
    ``caller`` lognum_fused_dd) on K states on card ``dev``: an
    uninitialised (clusters, K) float64 tensor, one row per cluster that the
    card holds at once (the occupancy API's answer, cached per card and K).
    Raises RuntimeError above ``FUSED_MAX_K`` states."""
    if K > FUSED_MAX_K:
        raise RuntimeError(
            f"{caller}: the single-read cluster kernel holds at most {FUSED_MAX_K} states "
            f"(16 blocks of 512 rows), got {K}")
    key = (dev.index, K)
    if key not in _MAX_CLUSTERS:
        out = ctypes.c_int(0)
        with torch.cuda.device(dev):
            err = _lib().wsum_fused_clusters(K, ctypes.byref(out))
        if err != 0 or out.value <= 0:
            raise RuntimeError(
                f"{caller}: no cluster of the fused kernel holds {K} states on {dev} "
                f"(CUDA error {err})")
        _MAX_CLUSTERS[key] = out.value
    return torch.empty((_MAX_CLUSTERS[key], K), dtype=torch.float64, device=dev)


def _launch(u_hi, u_lo, g_hi, g_lo, c):
    global WSUM_LAUNCHES
    K, N = u_hi.shape
    dev = u_hi.device
    s_hi = torch.empty(K, dtype=torch.float32, device=dev)
    s_lo = torch.empty(K, dtype=torch.float32, device=dev)
    partial = fused_partial(K, dev)
    with torch.cuda.device(dev):
        err = _lib().wsum_fused_launch(
            u_hi.data_ptr(), u_lo.data_ptr(), g_hi.data_ptr(), g_lo.data_ptr(),
            None if c is None else c.data_ptr(), K, N, partial.shape[0], partial.data_ptr(),
            s_hi.data_ptr(), s_lo.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wsum_dd: kernel launch failed with CUDA error {err}")
    WSUM_LAUNCHES += 1
    return s_hi, s_lo


def split_route(u_hi, u_lo, g_hi, g_lo, c=None):
    """wsum_dd's many-state route, the JAX package's composition: the f32
    global shift, K3's denominators, pad columns (m_n < -1e8) set to
    d = 0, then K4.  The same inputs and outputs as :func:`wsum_dd`."""
    m_n = column_shift(u_hi, g_hi)
    d_hi, d_lo = denom_sums_dd(u_hi, u_lo, g_hi, g_lo, m_n)
    pad = m_n < _PAD_M
    d_hi.masked_fill_(pad, 0.0)
    d_lo.masked_fill_(pad, 0.0)
    return wsum_denom_dd(u_hi, u_lo, g_hi, g_lo, m_n, d_hi, d_lo, c)


def wsum_dd(u_hi, u_lo, g_hi, g_lo, c=None):
    """S_k = sum_n c_n N_k W_nk in (hi, lo) float32, one read of u.

    u_hi/u_lo: (K, N) float32 dd planes of the (preconditioned) reduced
    potentials; g_hi/g_lo: (K,) float32 dd planes of f_k + ln N_k; c:
    optional (N,) float32 per-sample counts.  All contiguous, on one device.
    Returns (S_hi, S_lo), (K,) float32 each: the gradient is S - N_k.
    More than ``_SPLIT_ROUTE_K`` states take the many-state route
    (:func:`split_route`).
    """
    check_planes("wsum_dd", u_hi, u_lo, g_hi, g_lo, c=c)
    if u_hi.shape[0] > _SPLIT_ROUTE_K:
        return split_route(u_hi, u_lo, g_hi, g_lo, c)
    if u_hi.device.type == "cuda":
        return _launch(u_hi, u_lo, g_hi, g_lo, c)
    if u_hi.device.type == "cpu":
        return wsum_dd_plain(u_hi, u_lo, g_hi, g_lo, c)
    raise ValueError(f"wsum_dd: no kernel for device {u_hi.device}")
