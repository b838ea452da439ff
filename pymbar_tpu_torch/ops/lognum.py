"""The lognum family: K6 ``logden_dd``, K7 ``lognum_dd``, K5 ``lognum_fused_dd``.

Counterparts of :func:`pymbar_tpu.ops.pallas_kernels.logden_dd`,
:func:`~pymbar_tpu.ops.pallas_kernels.lognum_dd` and
:func:`~pymbar_tpu.ops.pallas_kernels.lognum_fused_dd`: the two reductions
of the MBAR self-consistent update on double-word planes,

* ``ld_n = log sum_k exp(g_k - u_kn)``            (K6, per sample)
* ``ln_k = log sum_n exp(-ld_n - u_kn)``          (K7, per state)

and their fusion K5, which computes ld in the same pass, drops pad columns
and returns ln_k or its raw sums (the form a sample-sharded solve merges
across devices, :func:`pymbar_tpu_torch.parallel.sharded_fused_lognum_dd`).
Same inputs, outputs and pad rules as the JAX package, minus its TPU knobs
(tile width, interpret mode, fast exp) and its K <= 2048 cap.

* CUDA tensors launch the hand-written Hopper kernels of ``csrc/lognum.cu``
  (built by :mod:`pymbar_tpu_torch.ops._build` on first use).  K5 is one
  read of the planes: the K5 instantiation of K1's single-read cluster
  kernel (``csrc/wsum_fused.cuh``), so on the card it holds at most
  8192 states (``wsum.FUSED_MAX_K``) and raises above.
* CPU tensors run the plain PyTorch versions (``*_plain``), with true f64
  inner math streamed over column chunks.

Nothing else is accepted, and nothing falls back.  ``LOGDEN_LAUNCHES``,
``LOGNUM_LAUNCHES`` and ``LOGNUM_FUSED_LAUNCHES`` count the launches (one
per call that launches).
"""

import ctypes

import torch

from pymbar_tpu_torch.ops import _build
from pymbar_tpu_torch.ops.doubledouble import dd_from_f64, dd_to_f64
from pymbar_tpu_torch.ops.mbar_core import _CHUNK_BYTES
from pymbar_tpu_torch.ops.wsum import _PAD_M, fused_partial
from pymbar_tpu_torch.ops.wsum_split import check_planes, row_splits

__all__ = [
    "logden_dd",
    "logden_dd_plain",
    "lognum_dd",
    "lognum_dd_plain",
    "lognum_fused_dd",
    "lognum_fused_dd_plain",
    "LOGDEN_LAUNCHES",
    "LOGNUM_LAUNCHES",
    "LOGNUM_FUSED_LAUNCHES",
]

LOGDEN_LAUNCHES = 0
LOGNUM_LAUNCHES = 0
LOGNUM_FUSED_LAUNCHES = 0


def _chunks(K, N):
    """(start, stop) column ranges of the plain versions' f64 chunks."""
    width = max(1, _CHUNK_BYTES // (8 * K))
    return [(s, min(N, s + width)) for s in range(0, N, width)]


def _logden64(u_hi, u_lo, g_hi, g_lo):
    """(ld_n in f64, the float32 shift m_n = max_k (g_hi - u_hi))."""
    K, N = u_hi.shape
    g64 = dd_to_f64(g_hi, g_lo)[:, None]
    ld = torch.empty(N, dtype=torch.float64, device=u_hi.device)
    m = torch.empty(N, dtype=torch.float32, device=u_hi.device)
    for s, e in _chunks(K, N):
        m[s:e] = (g_hi[:, None] - u_hi[:, s:e]).amax(dim=0)
        m64 = m[s:e].to(torch.float64)
        a = g64 - dd_to_f64(u_hi[:, s:e], u_lo[:, s:e])
        ld[s:e] = a.sub_(m64[None, :]).exp_().sum(dim=0).log_().add_(m64)
    return ld, m


def _lognum_sums64(u_hi, u_lo, ld64, m_k, pad=None):
    """S_k = sum_n exp((-m_k - u_kn) - ld_n) in f64; columns where ``pad``
    holds add exactly 0."""
    K, N = u_hi.shape
    neg_m = -m_k.to(torch.float64)[:, None]
    S = torch.zeros(K, dtype=torch.float64, device=u_hi.device)
    for s, e in _chunks(K, N):
        t = (neg_m - dd_to_f64(u_hi[:, s:e], u_lo[:, s:e])).sub_(ld64[None, s:e]).exp_()
        if pad is not None:
            t.masked_fill_(pad[None, s:e], 0.0)
        S += t.sum(dim=1)
    return S


def logden_dd_plain(u_hi, u_lo, g_hi, g_lo):
    """ld_n = log sum_k exp((g_k - u_kn) - m_n) + m_n in true f64, streamed
    over columns; no pad masking.  Returns (ld_hi, ld_lo), (N,) float32."""
    return dd_from_f64(_logden64(u_hi, u_lo, g_hi, g_lo)[0])


def lognum_dd_plain(u_hi, u_lo, ld_hi, ld_lo, m_k):
    """ln_k = log sum_n exp((-m_k - u_kn) - ld_n) + m_k in true f64, streamed
    over columns; no masking.  Returns (ln_hi, ln_lo), (K,) float32."""
    S = _lognum_sums64(u_hi, u_lo, dd_to_f64(ld_hi, ld_lo), m_k)
    return dd_from_f64(S.log_().add_(m_k.to(torch.float64)))


def lognum_fused_dd_plain(u_hi, u_lo, g_hi, g_lo, m_k, return_sums=False):
    """K6's ld rounded to its (hi, lo) pair, pad columns (m_n < -1e8)
    dropped, then K7's sums in true f64.  Returns (K,) float32 (hi, lo) of
    the sums s_k with ``return_sums``, else of log s_k + m_k."""
    ld, m = _logden64(u_hi, u_lo, g_hi, g_lo)
    S = _lognum_sums64(u_hi, u_lo, dd_to_f64(*dd_from_f64(ld)), m_k, pad=m < _PAD_M)
    if return_sums:
        return dd_from_f64(S)
    return dd_from_f64(S.log_().add_(m_k.to(torch.float64)))


def _lib():
    lib = _build.load("lognum")
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    signatures = {
        "logden_launch": [p, p, p, p, i32, i64, p, p, p],
        "lognum_launch": [p, p, p, p, p, i32, i64, i32, p, p, p, p, p, p, p, p],
        "lognum_fused_launch": [p, p, p, p, p, i32, i64, i32, i32, p, p, p, p],
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


def _row_scratch(K, N, dev):
    """Scratch of K7's row pass: ld64, r, g_hi, g_lo, partial, out_hi, out_lo."""
    f32, f64 = torch.float32, torch.float64
    n_split = row_splits(K, N)
    return n_split, [
        torch.empty(N, dtype=f64, device=dev),
        torch.empty(N, dtype=f64, device=dev),
        torch.empty(K, dtype=f32, device=dev),
        torch.empty(K, dtype=f32, device=dev),
        torch.empty((n_split, K), dtype=f64, device=dev),
        torch.empty(K, dtype=f32, device=dev),
        torch.empty(K, dtype=f32, device=dev),
    ]


def _no_kernel(fn, dev):
    return ValueError(f"{fn}: no kernel for device {dev}")


def logden_dd(u_hi, u_lo, g_hi, g_lo):
    """Per-sample mixture log-normalizer ld_n = log sum_k exp(g_k - u_kn).

    u_hi/u_lo: (K, N) float32 dd planes; g_hi/g_lo: (K,) float32 dd planes
    of f_k + ln N_k.  All contiguous, on one device.  The shift is the
    float32 m_n = max_k (g_hi - u_hi); there is no pad masking (an
    all-sentinel column gives ld ~ -1e10).  Returns (ld_hi, ld_lo), (N,)
    float32 each.
    """
    global LOGDEN_LAUNCHES
    check_planes("logden_dd", u_hi, u_lo, g_hi, g_lo)
    dev = u_hi.device
    if dev.type == "cpu":
        return logden_dd_plain(u_hi, u_lo, g_hi, g_lo)
    if dev.type != "cuda":
        raise _no_kernel("logden_dd", dev)
    K, N = u_hi.shape
    ld_hi = torch.empty(N, dtype=torch.float32, device=dev)
    ld_lo = torch.empty(N, dtype=torch.float32, device=dev)
    _call("logden_launch", dev, u_hi.data_ptr(), u_lo.data_ptr(), g_hi.data_ptr(),
          g_lo.data_ptr(), K, N, ld_hi.data_ptr(), ld_lo.data_ptr())
    LOGDEN_LAUNCHES += 1
    return ld_hi, ld_lo


def lognum_dd(u_hi, u_lo, ld_hi, ld_lo, m_k):
    """Per-state ln_k = log sum_n exp((-ld_n - u_kn) - m_k) + m_k.

    u_hi/u_lo: (K, N) float32 dd planes; ld_hi/ld_lo: (N,) float32 dd pair
    of the log-denominators; m_k: (K,) float32 shift (a nearby value, e.g.
    max_n (-ld_n - u_kn)).  All contiguous, on one device.  No masking: a
    sentinel column fed :func:`logden_dd`'s ld adds a phantom term, as in
    the JAX package (:func:`lognum_fused_dd` is the masked form).  Returns
    (ln_hi, ln_lo), (K,) float32 each.
    """
    global LOGNUM_LAUNCHES
    check_planes("lognum_dd", u_hi, u_lo, None, None, m_k=m_k, ld_hi=ld_hi, ld_lo=ld_lo)
    dev = u_hi.device
    if dev.type == "cpu":
        return lognum_dd_plain(u_hi, u_lo, ld_hi, ld_lo, m_k)
    if dev.type != "cuda":
        raise _no_kernel("lognum_dd", dev)
    K, N = u_hi.shape
    n_split, scratch = _row_scratch(K, N, dev)
    _call("lognum_launch", dev, u_hi.data_ptr(), u_lo.data_ptr(), ld_hi.data_ptr(),
          ld_lo.data_ptr(), m_k.data_ptr(), K, N, n_split, *(t.data_ptr() for t in scratch))
    LOGNUM_LAUNCHES += 1
    return scratch[5], scratch[6]


def lognum_fused_dd(u_hi, u_lo, g_hi, g_lo, m_k, return_sums=False):
    """Per-state lognum with the log-denominators computed in the same call.

    u_hi/u_lo: (K, N) float32 dd planes; g_hi/g_lo: (K,) float32 dd planes
    of f_k + ln N_k; m_k: (K,) float32 shift.  All contiguous, on one
    device.  A pad column (m_n = max_k (g_hi - u_hi) < -1e8: every row holds
    the +1e10 sentinel) adds exactly 0.  Returns (K,) float32 (hi, lo) of
    ln_k = log s_k + m_k, or with ``return_sums`` of the raw sums
    s_k = sum_n exp((-ld_n - u_kn) - m_k), which merge across sample shards.
    On a CUDA tensor more than 8192 states (``wsum.FUSED_MAX_K``, the
    cluster kernel's limit) raise RuntimeError.
    """
    global LOGNUM_FUSED_LAUNCHES
    check_planes("lognum_fused_dd", u_hi, u_lo, g_hi, g_lo, m_k=m_k)
    dev = u_hi.device
    if dev.type == "cpu":
        return lognum_fused_dd_plain(u_hi, u_lo, g_hi, g_lo, m_k, return_sums)
    if dev.type != "cuda":
        raise _no_kernel("lognum_fused_dd", dev)
    K, N = u_hi.shape
    partial = fused_partial(K, dev, "lognum_fused_dd")
    out_hi = torch.empty(K, dtype=torch.float32, device=dev)
    out_lo = torch.empty(K, dtype=torch.float32, device=dev)
    _call("lognum_fused_launch", dev, u_hi.data_ptr(), u_lo.data_ptr(), g_hi.data_ptr(),
          g_lo.data_ptr(), m_k.data_ptr(), K, N, partial.shape[0], int(bool(return_sums)),
          partial.data_ptr(), out_hi.data_ptr(), out_lo.data_ptr())
    LOGNUM_FUSED_LAUNCHES += 1
    return out_hi, out_lo
