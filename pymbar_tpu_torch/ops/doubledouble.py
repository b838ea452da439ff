"""Double-word (hi, lo) float32 pairs at the boundary of the dd solver.

The H100 has native FP64, so the port's kernels compute in f64 inside and
need none of the error-free transforms of :mod:`pymbar_tpu.ops.doubledouble`.
What remains is the storage format the dd solver and its kernel share: a
float64 value held as two float32 planes, hi and lo (the same 8 bytes per
element as f64).
"""

import torch

__all__ = ["dd_from_f64", "dd_to_f64"]


def dd_from_f64(x64):
    """Split a float64 tensor into a (hi, lo) float32 pair (exact to ~2^-48)."""
    hi = x64.to(torch.float32)
    lo = (x64 - hi.to(x64.dtype)).to(torch.float32)
    return hi, lo


def dd_to_f64(hi, lo):
    """Recombine a double-word pair into float64."""
    return hi.to(torch.float64) + lo.to(torch.float64)
