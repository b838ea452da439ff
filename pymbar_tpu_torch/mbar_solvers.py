"""Drop-in alias of the reference's ``pymbar.mbar_solvers`` module surface.

The counterpart of :mod:`pymbar_tpu.mbar_solvers`: users of the reference
import solver primitives as ``from pymbar import mbar_solvers``; this
module re-exports the same names (pymbar 4.x mbar_solvers.py) from their
homes in :mod:`pymbar_tpu_torch.ops.mbar_core` and
:mod:`pymbar_tpu_torch.solvers`.  The ``ops.mbar_core`` functions take
``u_kn`` as a tensor; the ``solvers`` entry points also take numpy.
"""

from pymbar_tpu_torch.ops.mbar_core import (
    mbar_gradient,
    mbar_hessian,
    mbar_log_W_nk,
    mbar_objective,
    mbar_objective_and_gradient,
    mbar_W_nk,
    precondition_u_kn,
    self_consistent_update,
    validate_inputs,
)
from pymbar_tpu_torch.solvers import (
    BOOTSTRAP_SOLVER_PROTOCOL,
    DEFAULT_SOLVER_PROTOCOL,
    JAX_SOLVER_PROTOCOL,
    ROBUST_SOLVER_PROTOCOL,
    adaptive,
    anderson,
    scipy_minimize_options,
    scipy_nohess_options,
    scipy_root_options,
    solve_mbar,
    solve_mbar_for_all_states,
    solve_mbar_once,
)

__all__ = [
    "validate_inputs",
    "self_consistent_update",
    "mbar_gradient",
    "mbar_objective",
    "mbar_objective_and_gradient",
    "mbar_hessian",
    "mbar_log_W_nk",
    "mbar_W_nk",
    "adaptive",
    "anderson",
    "precondition_u_kn",
    "solve_mbar_once",
    "solve_mbar",
    "solve_mbar_for_all_states",
    "DEFAULT_SOLVER_PROTOCOL",
    "ROBUST_SOLVER_PROTOCOL",
    "JAX_SOLVER_PROTOCOL",
    "BOOTSTRAP_SOLVER_PROTOCOL",
    "scipy_minimize_options",
    "scipy_nohess_options",
    "scipy_root_options",
]
