"""The many-state weight-sum route: K3 ``denom_sums_dd``, K4 ``wsum_denom_dd``.

Counterparts of :func:`pymbar_tpu.ops.pallas_kernels.denom_sums_dd` and
:func:`~pymbar_tpu.ops.pallas_kernels.wsum_denom_dd`, with the same inputs,
outputs and pad rules, minus the TPU knobs (tile width, interpret mode,
fast exp), and of the f32 shift ``jnp.max(g_hi[:, None] - u_hi, axis=0)``
that ``wsum_dd`` computes before them (:func:`column_shift`).  Any K and N
are accepted.  :func:`pymbar_tpu_torch.ops.wsum.wsum_dd` chains the three
for many states; the pair is also the building block of a k-sharded solve.

* CUDA tensors launch the hand-written Hopper kernels of
  ``csrc/wsum_split.cu`` (built by :mod:`pymbar_tpu_torch.ops._build` on
  first use).
* CPU tensors run the plain PyTorch versions (``*_plain``), with true f64
  inner math streamed over column chunks (as ``pallas_kernels.*_ref``).

Nothing else is accepted, and nothing falls back.  ``SHIFT_LAUNCHES``,
``DENOM_SUMS_LAUNCHES`` and ``WSUM_DENOM_LAUNCHES`` count the launches (one
per call that launches).
"""

import ctypes

import torch

from pymbar_tpu_torch.ops import _build
from pymbar_tpu_torch.ops.doubledouble import dd_from_f64, dd_to_f64
from pymbar_tpu_torch.ops.mbar_core import _CHUNK_BYTES

__all__ = [
    "column_shift",
    "column_shift_plain",
    "denom_sums_dd",
    "denom_sums_dd_plain",
    "wsum_denom_dd",
    "wsum_denom_dd_plain",
    "check_planes",
    "row_splits",
    "SHIFT_LAUNCHES",
    "DENOM_SUMS_LAUNCHES",
    "WSUM_DENOM_LAUNCHES",
]

SHIFT_LAUNCHES = 0
DENOM_SUMS_LAUNCHES = 0
WSUM_DENOM_LAUNCHES = 0

# Threads per block of the column kernels (kColThreads in the source); the
# k axis is cut into blocks until the grid holds ~_TARGET_BLOCKS blocks
# (~16 per SM on 132 SMs), each of at least _MIN_ROWS rows.
_COL_THREADS = 256
_TARGET_BLOCKS = 2048
_MIN_ROWS = 256
# The row pass (csrc/wsum_rows.cuh): blocks over _ROWS_PER_BLOCK rows
# (kRowsPerBlock in the source), two blocks per SM.  Its grid is cut into
# column splits until it holds ~_ROW_TARGET_BLOCKS blocks (8 per SM on 132
# SMs: four waves of two), each split at least _MIN_COLS_PER_SPLIT columns
# wide (8 tiles) so the ring's start-up cost is spread.
_ROWS_PER_BLOCK = 32
_ROW_TARGET_BLOCKS = 1056
_MIN_COLS_PER_SPLIT = 1024
_MAX_GRID_Y = 65535


def check_planes(fn, u_hi, u_lo, g_hi, g_lo, m_k=None, **n_vectors):
    """Validate the dd planes (K, N), the (K,) g pair, an optional (K,) m_k
    and optional (N,) vectors: float32, contiguous, one device.  ``u_lo`` and
    the g pair may be None where ``fn`` takes none.  Raises TypeError /
    ValueError."""
    named = dict(u_hi=u_hi, u_lo=u_lo, g_hi=g_hi, g_lo=g_lo, m_k=m_k, **n_vectors)
    for name, t in named.items():
        if t is None:
            continue
        if not torch.is_tensor(t):
            raise TypeError(f"{fn}: {name} must be a torch.Tensor, got {type(t)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{fn}: {name} must be float32, got {t.dtype}")
        if t.device != u_hi.device:
            raise ValueError(f"{fn}: {name} is on {t.device}, u_hi on {u_hi.device}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    if u_hi.ndim != 2 or (u_lo is not None and u_lo.shape != u_hi.shape):
        raise ValueError(
            f"{fn}: u_hi and u_lo must be (K, N) of one shape, got "
            f"{tuple(u_hi.shape)} and {None if u_lo is None else tuple(u_lo.shape)}"
        )
    K, N = u_hi.shape
    if K == 0 or N == 0:
        raise ValueError(f"{fn}: empty planes {tuple(u_hi.shape)}")
    for name, t in (("g_hi", g_hi), ("g_lo", g_lo), ("m_k", m_k)):
        if t is not None and t.shape != (K,):
            raise ValueError(f"{fn}: {name} must be ({K},), got {tuple(t.shape)}")
    for name, t in n_vectors.items():
        if t is not None and t.shape != (N,):
            raise ValueError(f"{fn}: {name} must be ({N},), got {tuple(t.shape)}")
    if K > 2**31 - 1:
        raise ValueError(f"{fn}: K={K} exceeds the kernels' int range")


def _width(K, itemsize):
    """Columns per chunk of the plain versions."""
    return max(1, _CHUNK_BYTES // (itemsize * K))


def column_shift_plain(u_hi, g_hi):
    """m_n = max_k (g_hi_k - u_hi_kn) in float32, streamed over columns."""
    K, N = u_hi.shape
    m = torch.empty(N, dtype=torch.float32, device=u_hi.device)
    width = _width(K, 4)
    for s in range(0, N, width):
        e = min(N, s + width)
        m[s:e] = (g_hi[:, None] - u_hi[:, s:e]).amax(dim=0)
    return m


def denom_sums_dd_plain(u_hi, u_lo, g_hi, g_lo, m_n):
    """s_n = sum_k exp((g_k - u_kn) - m_n) in true f64, streamed over
    columns.  Returns (s_hi, s_lo) float32."""
    K, N = u_hi.shape
    g64 = dd_to_f64(g_hi, g_lo)[:, None]
    s = torch.empty(N, dtype=torch.float64, device=u_hi.device)
    width = _width(K, 8)
    for c0 in range(0, N, width):
        c1 = min(N, c0 + width)
        a = g64 - dd_to_f64(u_hi[:, c0:c1], u_lo[:, c0:c1])
        s[c0:c1] = a.sub_(m_n[None, c0:c1].to(torch.float64)).exp_().sum(dim=0)
    return dd_from_f64(s)


def wsum_denom_dd_plain(u_hi, u_lo, g_hi, g_lo, m_n, d_hi, d_lo, c=None):
    """S_k = sum_n c_n exp((g_k - u_kn) - m_n) / d_n in true f64, streamed
    over columns; a column with d_n <= 0 adds exactly 0.  Returns (S_hi,
    S_lo) float32."""
    K, N = u_hi.shape
    g64 = dd_to_f64(g_hi, g_lo)[:, None]
    d64 = dd_to_f64(d_hi, d_lo)
    S = torch.zeros(K, dtype=torch.float64, device=u_hi.device)
    width = _width(K, 8)
    for c0 in range(0, N, width):
        c1 = min(N, c0 + width)
        d = d64[c0:c1]
        pos = d > 0.0
        t = (g64 - dd_to_f64(u_hi[:, c0:c1], u_lo[:, c0:c1]))
        t.sub_(m_n[None, c0:c1].to(torch.float64)).exp_()
        t.div_(torch.where(pos, d, 1.0)[None, :]).masked_fill_(~pos[None, :], 0.0)
        if c is not None:
            t.mul_(c[None, c0:c1].to(torch.float64))
        S += t.sum(dim=1)
    return dd_from_f64(S)


def _lib():
    lib = _build.load("wsum_split")
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    signatures = {
        "column_shift_launch": [p, p, i32, i64, i32, p, p, p],
        "denom_sums_launch": [p, p, p, p, p, i32, i64, i32, p, p, p, p],
        "wsum_denom_launch": [p, p, p, p, p, p, p, p, i32, i64, i32, p, p, p, p, p, p],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _k_blocks(K, N):
    col_blocks = -(-N // _COL_THREADS)
    return max(1, min(-(-_TARGET_BLOCKS // col_blocks), -(-K // _MIN_ROWS), _MAX_GRID_Y))


def _call(fn_name, dev, *args):
    """Launch on the current stream of ``dev``; raise on a CUDA error."""
    fn = getattr(_lib(), fn_name)
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: kernel launch failed with CUDA error {err}")


def row_splits(K, N):
    """Column splits of the shared row pass (K4, K7, K5's second half):
    ~_ROW_TARGET_BLOCKS blocks of _ROWS_PER_BLOCK rows, each split
    at least _MIN_COLS_PER_SPLIT columns wide.  The kernel rounds each
    split up to whole column tiles."""
    k_tiles = -(-K // _ROWS_PER_BLOCK)
    return max(1, min(-(-_ROW_TARGET_BLOCKS // k_tiles), -(-N // _MIN_COLS_PER_SPLIT),
                      _MAX_GRID_Y))


def column_shift(u_hi, g_hi):
    """The route's global shift m_n = max_k (g_hi_k - u_hi_kn), (N,) float32.

    Read from the hi words only, as the JAX package's f32 ``jnp.max``; a
    sentinel pad column gives m_n ~ -1e10.
    """
    global SHIFT_LAUNCHES
    check_planes("column_shift", u_hi, None, g_hi, None)
    dev = u_hi.device
    if dev.type == "cpu":
        return column_shift_plain(u_hi, g_hi)
    if dev.type != "cuda":
        raise ValueError(f"column_shift: no kernel for device {dev}")
    K, N = u_hi.shape
    kb = _k_blocks(K, N)
    partial = torch.empty((kb, N), dtype=torch.float32, device=dev)
    m = torch.empty(N, dtype=torch.float32, device=dev)
    _call("column_shift_launch", dev, u_hi.data_ptr(), g_hi.data_ptr(), K, N, kb,
          partial.data_ptr(), m.data_ptr())
    SHIFT_LAUNCHES += 1
    return m


def denom_sums_dd(u_hi, u_lo, g_hi, g_lo, m_n):
    """Per-column denominator sums s_n = sum_k exp((g_k - u_kn) - m_n).

    u_hi/u_lo: (K, N) float32 dd planes; g_hi/g_lo: (K,) float32 dd planes
    of f_k + ln N_k; m_n: (N,) float32, the GLOBAL shift (max over all
    states, so sums over k blocks or devices share a scale).  All
    contiguous, on one device.  Returns (s_hi, s_lo), (N,) float32 each.
    """
    global DENOM_SUMS_LAUNCHES
    check_planes("denom_sums_dd", u_hi, u_lo, g_hi, g_lo, m_n=m_n)
    dev = u_hi.device
    if dev.type == "cpu":
        return denom_sums_dd_plain(u_hi, u_lo, g_hi, g_lo, m_n)
    if dev.type != "cuda":
        raise ValueError(f"denom_sums_dd: no kernel for device {dev}")
    K, N = u_hi.shape
    kb = _k_blocks(K, N)
    partial = torch.empty((kb, N), dtype=torch.float64, device=dev)
    s_hi = torch.empty(N, dtype=torch.float32, device=dev)
    s_lo = torch.empty(N, dtype=torch.float32, device=dev)
    _call("denom_sums_launch", dev, u_hi.data_ptr(), u_lo.data_ptr(), g_hi.data_ptr(),
          g_lo.data_ptr(), m_n.data_ptr(), K, N, kb, partial.data_ptr(),
          s_hi.data_ptr(), s_lo.data_ptr())
    DENOM_SUMS_LAUNCHES += 1
    return s_hi, s_lo


def wsum_denom_dd(u_hi, u_lo, g_hi, g_lo, m_n, d_hi, d_lo, c=None):
    """S_k = sum_n c_n exp((g_k - u_kn) - m_n) / d_n with the denominator
    sums (d_hi, d_lo) supplied; c = 1 when None.

    The shift m_n cancels in T/d, so with d from :func:`denom_sums_dd` (pad
    columns set to 0) S_k = sum_n c_n N_k W_nk as :func:`wsum_dd`.  Columns
    with d_n <= 0 add exactly 0.  Inputs as :func:`denom_sums_dd` plus
    (N,) float32 d_hi, d_lo and c.  Returns (S_hi, S_lo), (K,) float32.
    """
    global WSUM_DENOM_LAUNCHES
    check_planes("wsum_denom_dd", u_hi, u_lo, g_hi, g_lo, m_n=m_n, d_hi=d_hi, d_lo=d_lo, c=c)
    dev = u_hi.device
    if dev.type == "cpu":
        return wsum_denom_dd_plain(u_hi, u_lo, g_hi, g_lo, m_n, d_hi, d_lo, c)
    if dev.type != "cuda":
        raise ValueError(f"wsum_denom_dd: no kernel for device {dev}")
    K, N = u_hi.shape
    n_split = row_splits(K, N)
    m64 = torch.empty(N, dtype=torch.float64, device=dev)
    r = torch.empty(N, dtype=torch.float64, device=dev)
    partial = torch.empty((n_split, K), dtype=torch.float64, device=dev)
    s_hi = torch.empty(K, dtype=torch.float32, device=dev)
    s_lo = torch.empty(K, dtype=torch.float32, device=dev)
    _call("wsum_denom_launch", dev, u_hi.data_ptr(), u_lo.data_ptr(), g_hi.data_ptr(),
          g_lo.data_ptr(), m_n.data_ptr(), d_hi.data_ptr(), d_lo.data_ptr(),
          None if c is None else c.data_ptr(),
          K, N, n_split, m64.data_ptr(), r.data_ptr(), partial.data_ptr(),
          s_hi.data_ptr(), s_lo.data_ptr())
    WSUM_DENOM_LAUNCHES += 1
    return s_hi, s_lo
