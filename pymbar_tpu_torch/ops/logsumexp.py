"""Stable (weighted) logsumexp on tensors.

The counterpart of :mod:`pymbar_tpu.ops.logsumexp` (reference pymbar 4.x
utils.py:279-337): the per-slice maximum is replaced by 0 where it is not
finite, so an all-(-inf) slice reduces to -inf instead of nan, and an
optional multiplicative weight ``b`` scales each exponential (a zero weight
drops its term exactly).  Computes on the device of ``a``: a tensor's
own, and for anything else :func:`pymbar_tpu_torch.config.target_device`,
where the JAX package's ``jnp.asarray`` puts it.
"""

import torch

from pymbar_tpu_torch.config import target_device

__all__ = ["logsumexp"]


def logsumexp(a, axis=None, b=None, keepdims=False):
    """log(sum(b * exp(a), axis)) computed stably.

    Parameters
    ----------
    a : torch.Tensor (or array-like, placed on :func:`target_device`)
        Log-space inputs.
    axis : int, tuple of ints or None
        Reduction axes (None: all).
    b : torch.Tensor or array-like, optional
        Multiplicative weights, broadcastable to ``a``; moved to ``a``'s
        device.  May hold zeros (their terms drop out exactly).
    keepdims : bool
        Keep the reduced axes with size 1.
    """
    if not torch.is_tensor(a):
        a = torch.as_tensor(a, device=target_device())
    dims = tuple(range(a.ndim)) if axis is None else axis
    a_max = torch.amax(a, dim=dims, keepdim=True)
    a_max = torch.where(torch.isfinite(a_max), a_max, 0.0)

    shifted = torch.exp(a - a_max)
    if b is not None:
        shifted = torch.as_tensor(b, dtype=shifted.dtype, device=a.device) * shifted
    out = torch.log(torch.sum(shifted, dim=dims, keepdim=keepdims))

    if not keepdims:
        a_max = a_max.squeeze(dims)
    return out + a_max
