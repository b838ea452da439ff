"""pymbar_tpu_torch — the PyTorch/CUDA port of pymbar_tpu.

The MBAR solve and the free-energy differences, in PyTorch, with the
double-word polish's weight-sum pass (``wsum_dd``, and above 4096 states
its split pair ``denom_sums_dd`` + ``wsum_denom_dd``) and the lognum family
(``logden_dd``, ``lognum_dd``, ``lognum_fused_dd``) as hand-written CUDA
kernels for NVIDIA Hopper (sm_90a), and the 1-D sample-sharded solve in
:mod:`pymbar_tpu_torch.parallel` (``MBAR(mesh=)``).  Entry points place
numpy input on the CUDA card unless ``device="cpu"`` is asked for.
:mod:`pymbar_tpu` (JAX) stays the reference; this package imports neither
it nor JAX.

Exported so far: ``MBAR``, ``testsystems`` and ``utils``.  The rest of
pymbar_tpu's surface (FES, BAR/EXP, timeseries, confidenceintervals) is
still to be ported.
"""

from pymbar_tpu_torch import testsystems  # noqa: F401
from pymbar_tpu_torch import utils  # noqa: F401
from pymbar_tpu_torch.mbar import MBAR

__all__ = ["MBAR", "testsystems", "utils"]
