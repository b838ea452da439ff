"""MBAR solver engine: adaptive Newton/self-consistent iteration + protocol chain.

The counterpart of :mod:`pymbar_tpu.solvers` (reference pymbar 4.x
mbar_solvers.py:102-1017):

* solver protocol constants (DEFAULT/ROBUST/JAX/BOOTSTRAP)
* ``adaptive``            — dual SC/Newton step, pick the smaller gradient
                            norm (reference :510-667)
* ``solve_mbar_once``     — f_0-pinned dispatch to adaptive / the dd solver /
                            scipy minimize / scipy root (reference :738-883)
* ``solve_mbar``          — protocol chain with best-gradient-norm fallback
                            (reference :886-974)
* ``solve_mbar_for_all_states`` — solve sampled states then one SC update to
                            fill empty states (reference :977-1017)

The JAX package runs the adaptive loop as one device ``while_loop``; here
it is a plain Python loop whose iterations run on the tensor's device and
sync once each to evaluate the stop rule.  ``anderson`` and the device
``BFGS`` stage are not ported yet and raise :class:`ParameterError`.
"""

import logging
import warnings

import numpy as np
import scipy.optimize
import torch

from pymbar_tpu_torch.ops.mbar_core import (
    core_stats,
    mbar_gradient,
    mbar_hessian,
    mbar_objective_and_gradient,
    mbar_W_nk,
    precondition_u_kn,
    self_consistent_update,
    validate_inputs,
)
from pymbar_tpu_torch.utils import ParameterError, check_w_normalized

logger = logging.getLogger(__name__)

__all__ = [
    "JAX_SOLVER_PROTOCOL",
    "DEFAULT_SOLVER_PROTOCOL",
    "ROBUST_SOLVER_PROTOCOL",
    "BOOTSTRAP_SOLVER_PROTOCOL",
    "adaptive",
    "solve_mbar_once",
    "solve_mbar",
    "solve_mbar_for_all_states",
    "target_device",
]

# Protocol constants (reference mbar_solvers.py:102-118), as in the JAX
# package: DEFAULT leads with the adaptive solver and keeps scipy's 'hybr'
# as the fallback stage.
JAX_SOLVER_PROTOCOL = (
    dict(method="BFGS", continuation=True),
    dict(method="adaptive", options=dict(min_sc_iter=0)),
)

DEFAULT_SOLVER_PROTOCOL = (
    dict(method="adaptive", continuation=True),
    dict(method="hybr", continuation=True),
)

ROBUST_SOLVER_PROTOCOL = (
    dict(method="adaptive", options=dict(maxiter=1000)),
    dict(method="L-BFGS-B", options=dict(maxiter=1000)),
)

BOOTSTRAP_SOLVER_PROTOCOL = (dict(method="adaptive", options=dict(min_sc_iter=0)),)

# Gradient-based scipy.optimize.minimize methods accepted for protocol-string
# parity (reference mbar_solvers.py:120-140).
scipy_minimize_options = [
    "L-BFGS-B",
    "dogleg",
    "CG",
    "BFGS",
    "Newton-CG",
    "TNC",
    "trust-ncg",
    "trust-krylov",
    "trust-exact",
    "SLSQP",
]
scipy_nohess_options = ["L-BFGS-B", "BFGS", "CG", "TNC", "SLSQP"]
scipy_root_options = ["hybr", "lm"]

_NOT_YET_PORTED = ("anderson", "BFGS")

# Options that belong to the adaptive solver, not to scipy.
_ADAPTIVE_ONLY = ("min_sc_iter", "print_warning", "gamma", "verbose", "nr_method")


def target_device(device=None):
    """Where an entry point places a numpy input: ``device`` when given,
    else the CUDA card.  Without a card, and with no device asked for, it
    raises :class:`ParameterError`: nothing falls back to the CPU unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise ParameterError(
            'no CUDA device is available: pass device="cpu" to run on the CPU'
        )
    return torch.device("cuda")


def _as_tensor(u_kn):
    """u_kn as a tensor: tensors as given, numpy as a CPU tensor sharing memory."""
    if torch.is_tensor(u_kn):
        return u_kn
    return torch.from_numpy(np.ascontiguousarray(u_kn, dtype=np.float64))


# -----------------------------------------------------------------------------
# Adaptive solver
# -----------------------------------------------------------------------------


def _lstsq_min_norm(H, g):
    """Minimum-norm least-squares solve of H x = g through the SVD, with the
    singular-value cutoff eps * s_max of ``jnp.linalg.lstsq(rcond=-1)``
    (the full MBAR Hessian is singular along the all-ones vector)."""
    U, S, Vh = torch.linalg.svd(H, full_matrices=False)
    mask = S >= torch.finfo(H.dtype).eps * S[0]
    s_inv = torch.where(mask, 1.0 / torch.where(mask, S, 1.0), 0.0)
    return Vh.T @ (s_inv * (U.T @ g))


def _adaptive_candidates(u_kn, N_k, f_k, gamma, nr_method="lstsq"):
    """One adaptive iteration's candidate steps and their gradient norms.

    Returns (f_sci, g_sci, gnorm_sci, f_nr, g_nr, gnorm_nr) as the
    reference's jax_core_adaptive (mbar_solvers.py:670-694); nr_method as
    :func:`_newton_direction`.
    """
    _, g, f_sci = core_stats(u_kn, N_k, f_k)
    f_nr = f_k - gamma * _newton_direction(mbar_hessian(u_kn, N_k, f_k), g, nr_method)

    f_sci = f_sci - f_sci[0]
    g_sci = mbar_gradient(u_kn, N_k, f_sci)
    g_nr = mbar_gradient(u_kn, N_k, f_nr)
    return f_sci, g_sci, torch.dot(g_sci, g_sci), f_nr, g_nr, torch.dot(g_nr, g_nr)


def _newton_direction(H, g, nr_method="lstsq"):
    """H^-1 g with f_0 re-pinned: the Newton step of an adaptive iteration.

    'lstsq' is the reference's min-norm solve of the singular full Hessian;
    'chol' solves the reduced system H[1:, 1:] by Cholesky (NaN when it is
    not positive definite, as JAX's cho_factor).
    """
    if nr_method == "chol":
        L, info = torch.linalg.cholesky_ex(H[1:, 1:])
        L = torch.where(info == 0, L, torch.nan)
        dx1 = torch.cholesky_solve(g[1:, None], L)[:, 0]
        Hinvg = torch.cat([torch.zeros(1, dtype=g.dtype, device=g.device), dx1])
    else:
        Hinvg = _lstsq_min_norm(H, g)
    return Hinvg - Hinvg[0]


def host_adaptive_metrics(f_new, f_old, f_sci, f_nr, tol, delta_mode="relative"):
    """Convergence metrics (max_delta, max_diff) of one adaptive iteration.

    'relative' reproduces the reference (mbar_solvers.py:627-640): divide by
    |f_k| (1 where |f_k| < min(1e-8, tol)).  'mixed' divides by
    max(|f_k|, 1), an absolute criterion for small values, used by the dd
    solver's float32 phase.
    """
    f_new = np.asarray(f_new)
    f_old = np.asarray(f_old)
    f_sci = np.asarray(f_sci)
    f_nr = np.asarray(f_nr)
    if delta_mode == "mixed":
        div = np.maximum(np.abs(f_new[1:]), 1.0)
    else:
        div = np.abs(f_new[1:]).copy()
        div[div < min(1.0e-8, tol)] = 1.0
    max_delta = float(np.max(np.abs(f_new[1:] - f_old[1:]) / div))
    max_diff = float(np.max(np.abs(f_sci[1:] - f_nr[1:]) / div))
    return max_delta, max_diff


def _adaptive_while(
    u_kn, N_k, f_k, gamma, tol, maxiter, min_sc_iter, nr_method="lstsq",
    delta_mode="relative", verbose=False,
):
    """The adaptive loop, one host sync per iteration.

    Semantics of the reference host loop (mbar_solvers.py:575-640): the SC
    step is forced for the first ``min_sc_iter`` iterations, otherwise
    whichever of the SC / Newton candidates has the smaller gradient 2-norm
    wins; the loop stops when the change in f is below tol AND the SC/NR
    candidates agree to sqrt(tol), or when the metric went NaN.  Computes in
    the dtype and on the device of ``u_kn``.  Returns
    (f_k, iterations, sci_iter, nr_iter, max_delta, done).
    """
    it = sci_iter = nr_iter = 0
    max_delta = np.inf
    done = False
    while it < maxiter and not done:
        f_sci, _g_sci, gnorm_sci, f_nr, _g_nr, gnorm_nr = _adaptive_candidates(
            u_kn, N_k, f_k, gamma, nr_method
        )
        gnorm_sci, gnorm_nr = float(gnorm_sci), float(gnorm_nr)
        take_sci = gnorm_sci < gnorm_nr or sci_iter < min_sc_iter
        if verbose:
            logger.info(
                "self consistent iteration gradient norm is %10.5g, "
                "Newton-Raphson gradient norm is %10.5g; choosing %s on "
                "iteration %d" % (np.sqrt(gnorm_sci), np.sqrt(gnorm_nr),
                                  "self-consistent" if take_sci else "Newton-Raphson", it)
            )
        f_new = f_sci if take_sci else f_nr
        sci_iter += int(take_sci)
        nr_iter += int(not take_sci)
        max_delta, max_diff = host_adaptive_metrics(
            f_new.cpu().numpy(), f_k.cpu().numpy(), f_sci.cpu().numpy(),
            f_nr.cpu().numpy(), tol, delta_mode,
        )
        done = bool(np.isnan(max_delta)) or (max_delta < tol and max_diff < np.sqrt(tol))
        f_k = f_new
        it += 1
    return f_k, it, sci_iter, nr_iter, max_delta, done


def adaptive(u_kn, N_k, f_k, tol=1.0e-8, options=None):
    """Hybrid Newton-Raphson / self-consistent-iteration solver.

    Per iteration both a Newton step (H^-1 g via least squares, f_0 re-pinned)
    and a self-consistent step are computed; the one with the smaller gradient
    norm is taken (reference mbar_solvers.py:510-667).  ``u_kn`` is a
    tensor; N_k and f_k are moved to its device and dtype.

    Options: ``gamma`` (Newton step scale, default 1.0), ``maxiter`` (default
    10000), ``min_sc_iter`` (minimum forced SC iterations, default 2),
    ``nr_method`` ('lstsq' or 'chol'), ``verbose``, ``print_warning``.

    Returns dict(success, message, x) like the reference, x a tensor.
    """
    options = dict(options or {})
    maxiter = int(options.get("maxiter", 10000))
    min_sc_iter = int(options.get("min_sc_iter", 2))
    nr_method = options.get("nr_method", "lstsq")
    verbose = options.get("verbose", False)
    gamma = float(options.get("gamma", 1.0))

    if verbose:
        logger.info(
            "Determining dimensionless free energies by Newton-Raphson / "
            "self-consistent iteration."
        )
    if tol < 4.0 * np.finfo(np.float64).eps:
        logger.info("Tolerance may be too close to machine precision to converge.")

    u_kn = _as_tensor(u_kn)
    N_k = torch.as_tensor(N_k, dtype=u_kn.dtype, device=u_kn.device)
    f_k = torch.as_tensor(f_k, dtype=u_kn.dtype, device=u_kn.device)

    if maxiter <= 0:
        logger.warning(
            f"No iterations ran because maximum_iterations was <= 0 ({maxiter})!"
        )
        return dict(success=False, message="Did not converge.", x=f_k)

    f_out, it, sci_iter, nr_iter, max_delta, success = _adaptive_while(
        u_kn, N_k, f_k, gamma, tol, maxiter, min_sc_iter, nr_method, verbose=verbose
    )
    if success:
        message = "Convergence achieved by change in f with respect to previous guess."
        if verbose:
            logger.info(f"Converged to tolerance of {max_delta:e} in {it:d} iterations.")
            logger.info(
                f"Of {it:d} iterations, {nr_iter:d} were Newton-Raphson "
                f"iterations and {sci_iter:d} were self-consistent iterations"
            )
            if bool(torch.all(f_out == 0.0)):
                logger.info("WARNING: All f_k appear to be zero.")
    else:
        message = "Did not converge."
        logger.warning("WARNING: Did not converge to within specified tolerance.")
        logger.warning(
            f"max_delta = {max_delta:e}, tol = {tol:e}, "
            f"maximum_iterations = {maxiter:d}, iterations completed = {it:d}"
        )
    return dict(success=success, message=message, x=f_out)


# -----------------------------------------------------------------------------
# Protocol machinery
# -----------------------------------------------------------------------------


def solve_mbar_once(
    u_kn_nonzero,
    N_k_nonzero,
    f_k_nonzero,
    method="adaptive",
    tol=1e-12,
    continuation=None,
    options=None,
):
    """Solve MBAR once with a single method, f_0 pinned to zero.

    Mirrors reference mbar_solvers.py:738-883: inputs are validated,
    preconditioned, and solved in the K-1 dimensional reduced coordinate
    system (f_0 := 0).  ``method`` may be "adaptive", "dd" (the two-phase
    double-word solver of :mod:`pymbar_tpu_torch.solvers_large`), any
    gradient-based scipy.optimize.minimize method, or a scipy.optimize.root
    method ("hybr"/"lm") with the analytic Jacobian.

    Returns (f_k_nonzero ndarray, results dict).
    """
    del continuation  # consumed by solve_mbar; accepted for **solver splat
    options = dict(options or {})
    if method in _NOT_YET_PORTED:
        raise ParameterError(f"Method {method} is not yet ported to pymbar_tpu_torch")
    u_kn_nonzero, N_k_nonzero, f_k_nonzero = validate_inputs(
        u_kn_nonzero, N_k_nonzero, f_k_nonzero
    )
    f_k_nonzero = f_k_nonzero - f_k_nonzero[0]

    if method == "dd":
        # Two-phase double-word solve.  The split happens on the matrix's
        # own device and applies the per-sample min shift (gradients are
        # shift-invariant; the dd solver never consumes the objective).
        from pymbar_tpu_torch.solvers_large import dev_split_planes, solve_mbar_dd

        uh, ul = dev_split_planes(u_kn_nonzero)
        opts = {
            k: options[k]
            for k in ("f32_tol", "f32_maxiter", "polish_maxiter", "gamma")
            if k in options
        }
        f_sol, info = solve_mbar_dd(uh, ul, N_k_nonzero, f_k=f_k_nonzero, tol=tol, **opts)
        results = {"x": f_sol, "success": bool(info["converged"]), "info": info}
        return f_sol - f_sol[0], results

    dev, dt = u_kn_nonzero.device, u_kn_nonzero.dtype
    N_dev = torch.as_tensor(N_k_nonzero, dtype=dt, device=dev)
    f_dev = torch.as_tensor(f_k_nonzero, dtype=dt, device=dev)
    u_dev = precondition_u_kn(u_kn_nonzero, N_dev, f_dev)

    def pad(x):
        return torch.as_tensor(np.pad(np.asarray(x), (1, 0)), dtype=dt, device=dev)

    def grad(x):
        return mbar_gradient(u_dev, N_dev, pad(x)).cpu().numpy()[1:]

    def grad_and_obj(x):
        obj, g = mbar_objective_and_gradient(u_dev, N_dev, pad(x))
        return float(obj), g.cpu().numpy()[1:]

    def hess(x):
        return mbar_hessian(u_dev, N_dev, pad(x)).cpu().numpy()[1:, 1:]

    scipy_opts = {k: v for k, v in options.items() if k not in _ADAPTIVE_ONLY}
    with warnings.catch_warnings(record=True) as w:
        if method == "adaptive":
            results = adaptive(u_dev, N_dev, f_dev, tol=tol, options=options)
            f_k_nonzero = results["x"].cpu().numpy()
        elif method in scipy_minimize_options:
            results = scipy.optimize.minimize(
                grad_and_obj,
                f_k_nonzero[1:],
                jac=True,
                hess=None if method in scipy_nohess_options else hess,
                method=method,
                tol=tol,
                options=scipy_opts,
            )
            f_k_nonzero = np.pad(results["x"], (1, 0))
        elif method in scipy_root_options:
            results = scipy.optimize.root(
                grad, f_k_nonzero[1:], jac=hess, method=method, tol=tol, options=scipy_opts
            )
            f_k_nonzero = np.pad(results["x"], (1, 0))
        else:
            raise ParameterError(
                f"Method {method} for solution of free energies not recognized"
            )

    # Scipy-warning fallback validation (reference mbar_solvers.py:860-882).
    if len(w) > 0:
        can_ignore = True
        for warn_msg in w:
            if "Unknown solver options" in str(warn_msg.message):
                continue
            warnings.showwarning(
                warn_msg.message, warn_msg.category, warn_msg.filename,
                warn_msg.lineno, warn_msg.file, "",
            )
            can_ignore = False
        if not can_ignore:
            f_chk = torch.as_tensor(np.asarray(f_k_nonzero), dtype=dt, device=dev)
            w_nk = mbar_W_nk(u_dev, N_dev, f_chk).cpu().numpy()
            check_w_normalized(w_nk, N_k_nonzero)
            logger.warning(
                "MBAR weights converged within tolerance, despite the SciPy "
                "Warnings. Please validate your results."
            )

    return np.asarray(f_k_nonzero), dict(results)


def solve_mbar(u_kn_nonzero, N_k_nonzero, f_k_nonzero, solver_protocol=None):
    """Run a chain of solvers, keeping the best-gradient-norm result on failure.

    Mirrors reference mbar_solvers.py:886-974: each protocol stage is tried
    in order; a successful stage short-circuits; on total failure the stage
    with the smallest final gradient norm wins; stages with
    ``continuation=True`` hand their f_k to the next stage.
    Returns (f_k_nonzero, list of per-stage result dicts).
    """
    if solver_protocol is None:
        solver_protocol = DEFAULT_SOLVER_PROTOCOL
    u_t = _as_tensor(u_kn_nonzero)

    all_fks = []
    all_gnorms = []
    all_results = []
    results = dict(success=False)

    for solver in solver_protocol:
        f_k_nonzero_result, results = solve_mbar_once(
            u_kn_nonzero, N_k_nonzero, f_k_nonzero, **solver
        )
        all_fks.append(f_k_nonzero_result)
        if "gnorm" in results.get("info", {}):
            # the dd stage certified its own gradient norm
            all_gnorms.append(float(results["info"]["gnorm"]))
        else:
            g = mbar_gradient(
                u_t,
                torch.as_tensor(np.asarray(N_k_nonzero), dtype=u_t.dtype, device=u_t.device),
                torch.as_tensor(f_k_nonzero_result, dtype=u_t.dtype, device=u_t.device),
            )
            all_gnorms.append(float(torch.linalg.norm(g)))
        all_results.append(results)

        if results["success"]:
            best_gnorm = all_gnorms[-1]
            logger.info(f"Reached a solution to within tolerance with {solver['method']}")
            break
        logger.warning(
            f"Failed to reach a solution to within tolerance with "
            f"{solver['method']}: trying next method"
        )
        logger.info(f"Ending gnorm of method {solver['method']} = {all_gnorms[-1]:e}")
        if solver.get("continuation"):
            f_k_nonzero = f_k_nonzero_result
            logger.info("Will continue with results from previous method")

    if results["success"]:
        logger.info("Solution found within tolerance!")
    else:
        i_best_gnorm = int(np.argmin(all_gnorms))
        logger.warning("No solution found to within tolerance.")
        best_method = solver_protocol[i_best_gnorm]["method"]
        best_gnorm = all_gnorms[i_best_gnorm]
        logger.warning(
            f"The solution with the smallest gradient {best_gnorm:e} norm is "
            f"{best_method}"
        )
        f_k_nonzero_result = all_fks[i_best_gnorm]
        logger.warning(
            "Please exercise caution with this solution and consider "
            "alternative methods or a different tolerance."
        )

    logger.info(f"Final gradient norm: {best_gnorm:.3g}")
    return f_k_nonzero_result, all_results


def solve_mbar_for_all_states(u_kn, N_k, f_k, states_with_samples, solver_protocol):
    """Solve sampled states, then one SC pass to fill empty states, re-pin f_0.

    Mirrors reference mbar_solvers.py:977-1017.  A tensor u_kn is used on
    its device as given (the sampled-state selection copies only when some
    state is empty).  Returns (f_k ndarray, list of per-stage result dicts);
    the JAX package returns f_k alone.
    """
    u_kn = _as_tensor(u_kn)
    N_k = np.asarray(N_k)
    f_k = np.array(f_k, dtype=np.float64, copy=True)
    states_with_samples = np.asarray(states_with_samples)

    all_results = []
    if len(states_with_samples) == 1:
        f_k_nonzero = np.array([0.0])
    else:
        all_sampled = len(states_with_samples) == len(N_k) and np.array_equal(
            states_with_samples, np.arange(len(N_k))
        )
        u_sel = u_kn if all_sampled else u_kn.index_select(
            0, torch.as_tensor(states_with_samples, device=u_kn.device)
        )
        f_k_nonzero, all_results = solve_mbar(
            u_sel,
            N_k[states_with_samples],
            f_k[states_with_samples],
            solver_protocol=solver_protocol,
        )

    f_k[states_with_samples] = np.asarray(f_k_nonzero)

    # With no empty states and a dd-only protocol the SC fill is pure cost:
    # f already satisfies the SC equations past the dd noise floor.
    dd_only = all(s.get("method") == "dd" for s in (solver_protocol or ()))
    if dd_only and len(states_with_samples) == len(N_k):
        return f_k - f_k[0], all_results
    f_k = self_consistent_update(u_kn, N_k.astype(np.float64), f_k).cpu().numpy()
    return f_k - f_k[0], all_results
