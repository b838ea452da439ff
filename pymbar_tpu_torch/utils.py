"""Host-side utilities: layout converters, validation, stable logsumexp.

A numpy carry-over of :mod:`pymbar_tpu.utils` (itself at parity with
pymbar 4.x utils.py:41-114, :279-337, :340-393 and :401-422), kept as its
own module so that the PyTorch port never imports the JAX package.
"""

import warnings
from itertools import zip_longest

import numpy as np
import torch

__all__ = [
    "kln_to_kn",
    "kn_to_n",
    "ensure_type",
    "logsumexp",
    "check_w_normalized",
    "ParameterError",
    "ConvergenceError",
    "BoundsError",
    "DataError",
    "TypeCastPerformanceWarning",
]


class TypeCastPerformanceWarning(RuntimeWarning):
    """Emitted when an implicit dtype cast may cost performance."""


def kln_to_kn(kln, N_k=None, cleanup=False):
    """Convert a (K, L, N_max) reduced-potential tensor to (L, N) layout.

    Sample blocks are concatenated along the last axis in state order: the
    first ``N_k[0]`` columns come from state 0's simulation, and so on.
    Mirrors reference utils.py:41-73.

    Parameters
    ----------
    kln : np.ndarray, shape=(K, L, N_max)
        ``kln[k, l, n]`` is the potential of sample n (drawn in state k)
        evaluated at state l.
    N_k : np.ndarray, optional
        Number of valid samples per origin state k.  Defaults to N_max for
        every state.
    cleanup : bool, optional
        Drop the (possibly huge) input tensor eagerly.

    Returns
    -------
    kn : np.ndarray, shape=(L, N) with N = sum(N_k)
    """
    kln = np.asarray(kln)
    K, L, N_max = kln.shape
    if N_k is None:
        N_k = np.full(L, N_max, dtype=np.int64)
    N_k = np.asarray(N_k, dtype=np.int64)

    # Vectorized gather: build a boolean mask of valid sample slots per
    # origin state, then slice columns out in one shot (the reference uses a
    # per-sample Python loop; this is equivalent and O(K*L*N) without the
    # interpreter overhead).
    slot = np.arange(N_max)
    valid = slot[None, :] < N_k[:K, None]  # (K, N_max)
    kn = np.ascontiguousarray(
        kln.transpose(1, 0, 2)[:, valid].astype(np.float64, copy=False)
    )
    if cleanup:
        del kln
    return kn


def kn_to_n(kn, N_k=None, cleanup=False):
    """Convert a (K, N_max) per-origin-state array to a flat (N,) array.

    Mirrors reference utils.py:76-114.
    """
    kn = np.asarray(kn)
    K, N_max = kn.shape
    if N_k is None:
        N_k = np.full(K, N_max, dtype=np.int64)
    N_k = np.asarray(N_k, dtype=np.int64)

    slot = np.arange(N_max)
    valid = slot[None, :] < N_k[:K, None]
    n = kn[valid].astype(np.float64, copy=False)
    if cleanup:
        del kn
    return n


def ensure_type(
    val,
    dtype,
    ndim,
    name,
    length=None,
    can_be_none=False,
    shape=None,
    warn_on_cast=True,
    add_newaxis_on_deficient_ndim=False,
):
    """Validate (and possibly cast) an array's dtype/ndim/shape.

    Behavioral parity with reference utils.py:117-232: scalars are promoted
    to 1-length 1-D arrays when ``add_newaxis_on_deficient_ndim`` and
    ``ndim == 1``; a deficient leading axis is added when requested; ``None``
    entries in ``shape`` match any extent; casting emits
    :class:`TypeCastPerformanceWarning`.

    Returns a C-contiguous ndarray of the requested dtype (or None when
    allowed).
    """
    if can_be_none and val is None:
        return None

    if not isinstance(val, np.ndarray):
        if add_newaxis_on_deficient_ndim and ndim == 1 and np.isscalar(val):
            val = np.array([val])
        else:
            raise TypeError(
                f"{name} must be numpy array.  You supplied type {type(val)}"
            )

    if warn_on_cast and val.dtype != dtype:
        warnings.warn(
            f"Casting {name} dtype={val.dtype} to {dtype} ",
            TypeCastPerformanceWarning,
        )

    if not val.ndim == ndim:
        if add_newaxis_on_deficient_ndim and val.ndim + 1 == ndim:
            val = val[np.newaxis, ...]
        else:
            raise ValueError(
                f"{name} must be ndim {ndim}. You supplied {val.ndim}"
            )

    val = np.ascontiguousarray(val, dtype=dtype)

    if length is not None and len(val) != length:
        raise ValueError(
            f"{name} must be length {length}. You supplied {len(val)}."
        )

    if shape is not None:
        sentinel = object()
        error = ValueError(
            "{} must be shape {}. You supplied  {}".format(
                name, str(shape).replace("None", "Any"), val.shape
            )
        )
        for a, b in zip_longest(val.shape, shape, fillvalue=sentinel):
            if a is sentinel or b is sentinel:
                raise error
            if b is None:
                continue
            if a != b:
                raise error

    return val


def logsumexp(a, axis=None, b=None, use_numexpr=True):
    """log(sum(b * exp(a))) computed stably.

    Same contract as reference utils.py:279-337 (itself modeled on
    ``scipy.special.logsumexp``): non-finite per-slice maxima are replaced by
    0 before shifting so all-(-inf) slices return -inf rather than nan, and
    ``b`` may carry negative/zero weights (result may be nan/-inf then, as in
    scipy).  ``use_numexpr`` is accepted for signature parity and ignored.
    """
    del use_numexpr
    a = np.asarray(a)

    a_max = np.amax(a, axis=axis, keepdims=True)
    if a_max.ndim > 0:
        a_max[~np.isfinite(a_max)] = 0
    elif not np.isfinite(a_max):
        a_max = 0

    if b is not None:
        b = np.asarray(b)
        out = np.log(np.sum(b * np.exp(a - a_max), axis=axis))
    else:
        out = np.log(np.sum(np.exp(a - a_max), axis=axis))

    a_max = np.squeeze(a_max, axis=axis)
    out += a_max
    return out


def check_w_normalized(W, N_k, tolerance=1.0e-4):
    """Verify sum_n W_nk = 1 for every k and sum_k N_k W_nk = 1 for every n.

    Raises :class:`ParameterError` with the same diagnostic content as the
    reference (utils.py:340-393) when either normalization fails; returns
    None on success.  ``W`` is a numpy array or a tensor on any device.
    """
    W = torch.as_tensor(W)  # both sums on W's device; only K + N values leave it
    N_k = np.asarray(N_k)
    column_sums = W.sum(dim=0).cpu().numpy()
    row_sums = (W @ torch.as_tensor(N_k, dtype=W.dtype, device=W.device)).cpu().numpy()
    badcolumns = np.abs(column_sums - 1) > tolerance
    if np.any(badcolumns):
        firstbad = int(np.flatnonzero(badcolumns)[0])
        raise ParameterError(
            "Warning: Should have \\sum_n W_nk = 1. "
            f"Actual column sum for state {firstbad:d} was "
            f"{column_sums[firstbad]:f}. "
            f"{int(np.sum(badcolumns)):d} other columns have similar "
            "problems. \n"
            "This generally indicates the free energies are not converged."
        )

    badrows = np.abs(row_sums - 1) > tolerance
    if np.any(badrows):
        firstbad = int(np.flatnonzero(badrows)[0])
        raise ParameterError(
            "Warning: Should have \\sum_k N_k W_nk = 1. "
            f"Actual row sum for sample {firstbad:d} was "
            f"{row_sums[firstbad]:f}. "
            f"{int(np.sum(badrows)):d} other rows have similar problems. \n"
            "This generally indicates the free energies are not converged."
        )
    return None


# ----------------------------------------------------------------------------
# Exception taxonomy (reference utils.py:401-422)
# ----------------------------------------------------------------------------


class ParameterError(Exception):
    """An invalid parameter was passed."""


class ConvergenceError(Exception):
    """An iterative procedure failed to converge."""


class BoundsError(Exception):
    """A quantity fell outside its permissible bounds."""


class DataError(Exception):
    """The supplied data is inconsistent or insufficient."""
