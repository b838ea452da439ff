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

Exported: ``MBAR`` (with its diagnostics: ``Log_W_nk``, ``W_nk``,
``weights()``, ``compute_effective_sample_number``, ``compute_overlap``;
and ``compute_expectations``, ``compute_multiple_expectations``,
``compute_perturbed_free_energies``, ``compute_entropy_and_enthalpy``,
``compute_covariance_of_sums``), the two-state estimators ``bar``,
``bar_overlap``, ``bar_zero``, ``exp`` and ``exp_gauss``, the host modules
``timeseries``, ``testsystems``, ``confidenceintervals`` and ``utils``, and
``checkpoint`` (``save_mbar``, ``load_mbar_state``, ``resume_mbar``).
``FES`` is still to be ported.
"""

from pymbar_tpu_torch import checkpoint  # noqa: F401
from pymbar_tpu_torch import confidenceintervals  # noqa: F401
from pymbar_tpu_torch import testsystems  # noqa: F401
from pymbar_tpu_torch import timeseries  # noqa: F401
from pymbar_tpu_torch import utils  # noqa: F401
from pymbar_tpu_torch.mbar import MBAR
from pymbar_tpu_torch.other_estimators import bar, bar_overlap, bar_zero, exp, exp_gauss

__all__ = [
    "MBAR",
    "bar",
    "bar_overlap",
    "bar_zero",
    "exp",
    "exp_gauss",
    "timeseries",
    "testsystems",
    "confidenceintervals",
    "utils",
    "checkpoint",
]
