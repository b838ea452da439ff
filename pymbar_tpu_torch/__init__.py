"""pymbar_tpu_torch — the PyTorch/CUDA port of pymbar_tpu.

The MBAR solve and the free-energy differences, in PyTorch, with the
double-word polish's weight-sum pass (``wsum_dd``) as a hand-written CUDA
kernel for NVIDIA Hopper (sm_90a).  :mod:`pymbar_tpu` (JAX) stays the
reference; this package imports neither it nor JAX.

Exported so far: ``MBAR``, ``testsystems`` and ``utils``.  The rest of
pymbar_tpu's surface (FES, BAR/EXP, timeseries, confidenceintervals) is
still to be ported.
"""

from pymbar_tpu_torch import testsystems  # noqa: F401
from pymbar_tpu_torch import utils  # noqa: F401
from pymbar_tpu_torch.mbar import MBAR

__all__ = ["MBAR", "testsystems", "utils"]
