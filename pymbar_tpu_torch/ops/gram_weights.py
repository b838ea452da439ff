"""Theta's weight build: one column chunk's normalized weights and their sums.

For a chunk u_c (K, nc) of the reduced potentials, with N_k, f_k and the
rows ``sampled`` of the log-denominator (every row when None),
:func:`gram_weights` returns, in the work's dtype,

* ``w`` (K, nc): W^T = exp(f_k - u_kn - logden_n), 0 on pad columns
  (u >= ``mbar_core._PAD_THRESHOLD``);
* ``logden`` (nc,): log sum_{k in sampled} N_k exp(f_k - u_kn);
* ``rowsum`` (nc,): sum_k N_k w_kn, the check sum_k N_k W_nk = 1;
* ``colsum`` (K,): sum_n w_kn, the chunk's share of sum_n W_nk = 1.

These are what :func:`pymbar_tpu_torch.ops.mbar_core.mbar_gram_normalization`
needs of each chunk besides the Gram product itself.

* CUDA tensors (float32 or float64) launch the hand-written Hopper kernel
  of ``csrc/gram_weights.cu`` (built by :mod:`pymbar_tpu_torch.ops._build`
  on first use): one pass that reads u twice and writes w once, in place of
  some twenty eager passes over the chunk.  It replaces no Pallas kernel:
  XLA fuses the same build inside the JAX package's jitted
  ``mbar_gram_normalization``.
* CPU tensors run :func:`gram_weights_plain`, the same build in plain
  PyTorch.

Nothing else is accepted, and nothing falls back.  ``GRAM_WEIGHTS_LAUNCHES``
counts the kernel's launches (one per chunk).
"""

import ctypes

import torch

from pymbar_tpu_torch.ops import _build
from pymbar_tpu_torch.ops.mbar_core import _PAD_THRESHOLD, _logden_direct, _weights

__all__ = ["gram_weights", "gram_weights_plain", "GRAM_WEIGHTS_LAUNCHES"]

GRAM_WEIGHTS_LAUNCHES = 0

_LAUNCHERS = {torch.float64: "gram_weights_launch_f64", torch.float32: "gram_weights_launch_f32"}


def gram_weights_plain(u_c, N_k, f_k, sampled=None):
    """(w, logden, rowsum, colsum) of one chunk in plain PyTorch."""
    if sampled is None:
        logden = _logden_direct(u_c, N_k, f_k)
    else:
        logden = _logden_direct(u_c.index_select(0, sampled), N_k[sampled], f_k[sampled])
    w = _weights(u_c, f_k, logden)
    w.masked_fill_(u_c >= _PAD_THRESHOLD, 0.0)  # pad columns: phantom samples
    return w, logden, N_k @ w, w.sum(dim=1)


def _lib():
    lib = _build.load("gram_weights")
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for name in _LAUNCHERS.values():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = [p, i64, p, p, p, i32, i64, p, p, p, p, p, p, p]
            fn.restype = ctypes.c_int
    if lib.gram_weights_buffer_rows.argtypes is None:
        lib.gram_weights_buffer_rows.argtypes = [i64, ctypes.POINTER(i64)]
        lib.gram_weights_buffer_rows.restype = None
    return lib


def _buffer_rows(lib, nc):
    """Rows of the kernel's (rows, K) partial and scratch buffers for nc
    columns, as the kernel's source sizes them."""
    rows = (ctypes.c_int64 * 2)()
    lib.gram_weights_buffer_rows(nc, rows)
    return rows[0], rows[1]


def gram_weights(u_c, N_k, f_k, sampled=None):
    """(w, logden, rowsum, colsum) of the chunk ``u_c`` (K, nc).

    N_k, f_k: (K,) in u_c's dtype on its device; ``sampled``: indices of the
    rows the log-denominator runs over (an empty state then cannot set a
    column's max), on the same device, or None for every row.  A CUDA chunk
    needs float32 or float64 and a unit column stride (else it is copied
    first); the kernel allocates w, the (nc,) vectors and its partials of
    colsum (about nc / 64 rows of K), nothing else.
    """
    global GRAM_WEIGHTS_LAUNCHES
    dev = u_c.device
    if dev.type == "cpu":
        return gram_weights_plain(u_c, N_k, f_k, sampled)
    launcher = _LAUNCHERS.get(u_c.dtype)
    if dev.type != "cuda" or launcher is None:
        raise ValueError(f"gram_weights: no kernel for {u_c.dtype} on {dev}")
    if u_c.ndim != 2 or N_k.shape != (u_c.shape[0],) or f_k.shape != N_k.shape:
        raise ValueError(f"gram_weights: shapes {tuple(u_c.shape)}, {tuple(N_k.shape)}, "
                         f"{tuple(f_k.shape)}")
    if u_c.stride(1) != 1:
        u_c = u_c.contiguous()
    K, nc = u_c.shape
    N_k = N_k.to(dev, u_c.dtype).contiguous()
    f_k = f_k.to(dev, u_c.dtype).contiguous()
    mask = None
    if sampled is not None:
        mask = torch.zeros(K, dtype=torch.uint8, device=dev).index_fill_(0, sampled.to(dev), 1)
    lib = _lib()
    partial_rows, scratch_rows = _buffer_rows(lib, nc)
    w = torch.empty((K, nc), dtype=u_c.dtype, device=dev)
    logden, rowsum = (torch.empty(nc, dtype=u_c.dtype, device=dev) for _ in range(2))
    colsum = torch.empty(K, dtype=u_c.dtype, device=dev)
    partial = torch.empty((partial_rows, K), dtype=u_c.dtype, device=dev)
    scratch = torch.empty((scratch_rows, K), dtype=u_c.dtype, device=dev)
    with torch.cuda.device(dev):
        err = getattr(lib, launcher)(
            u_c.data_ptr(), u_c.stride(0), f_k.data_ptr(), N_k.data_ptr(),
            None if mask is None else mask.data_ptr(), K, nc, w.data_ptr(), logden.data_ptr(),
            rowsum.data_ptr(), partial.data_ptr(), scratch.data_ptr(), colsum.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gram_weights: kernel launch failed with CUDA error {err}")
    GRAM_WEIGHTS_LAUNCHES += 1
    return w, logden, rowsum, colsum
