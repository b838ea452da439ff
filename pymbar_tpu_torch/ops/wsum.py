"""The polish kernel: S_k = sum_n c_n N_k W_nk from double-word planes.

``wsum_dd`` is the counterpart of :func:`pymbar_tpu.ops.pallas_kernels.wsum_dd`
with the same inputs, outputs and pad-column rule, minus the TPU knobs
(tile width, interpret mode, fast exp).  Any K and N are accepted; above
``_SPLIT_ROUTE_K`` states it takes the many-state route through the split
pair of :mod:`pymbar_tpu_torch.ops.wsum_split`, as the JAX package does.

* CUDA tensors launch the hand-written Hopper kernel ``csrc/wsum.cu``
  (built by :mod:`pymbar_tpu_torch.ops._build` on first use).
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
    row_splits,
    wsum_denom_dd,
)

__all__ = ["wsum_dd", "wsum_dd_plain", "split_route", "WSUM_LAUNCHES"]

WSUM_LAUNCHES = 0

# A column is padding when max_k(g_hi - u_hi) falls below this (every row
# holds the +1e10 sentinel).
_PAD_M = -1.0e8

# Above this many states wsum_dd takes the many-state (split) route:
# column_shift -> denom_sums_dd -> pad mask -> wsum_denom_dd, as the JAX
# package does for padded K > 4096 (pallas_kernels.py:688-705).  The value
# is the JAX package's, set by the TPU's VMEM (K1 there holds a whole
# column tile of K rows); the H100's K1 has no K cap, and where the gate
# belongs on this card is still to be measured (PERF.md).  Module constant
# so tests can move it.
_SPLIT_ROUTE_K = 4096


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
    fn = lib.wsum_dd_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                       p, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return lib


def _launch(u_hi, u_lo, g_hi, g_lo, c):
    global WSUM_LAUNCHES
    K, N = u_hi.shape
    n_split = row_splits(K, N)
    dev = u_hi.device
    m = torch.empty(N, dtype=torch.float64, device=dev)
    r = torch.empty(N, dtype=torch.float64, device=dev)
    partial = torch.empty((n_split, K), dtype=torch.float64, device=dev)
    s_hi = torch.empty(K, dtype=torch.float32, device=dev)
    s_lo = torch.empty(K, dtype=torch.float32, device=dev)
    fn = _lib().wsum_dd_launch
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            u_hi.data_ptr(), u_lo.data_ptr(), g_hi.data_ptr(), g_lo.data_ptr(),
            None if c is None else c.data_ptr(), K, N, n_split,
            m.data_ptr(), r.data_ptr(), partial.data_ptr(),
            s_hi.data_ptr(), s_lo.data_ptr(), stream,
        )
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
    """S_k = sum_n c_n N_k W_nk in (hi, lo) float32, one pass pair over u.

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
