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
* ``anderson``            — Anderson-accelerated self-consistent iteration
* ``batched_bootstrap_solve`` — every bootstrap replicate's adaptive solve
                            batched over a (B, K, N) gather

The JAX package runs the adaptive loop as one device ``while_loop`` (and
the bootstrap replicates as a vmap of it); here it is a plain Python loop
whose iterations run on the tensor's device and sync once each to evaluate
the stop rule.  The JAX package's "BFGS" stage calls
``jax.scipy.optimize.minimize``; here :func:`_minimize_bfgs` is the same
algorithm in torch on u_kn's device.
"""

import logging
import math
import warnings

import numpy as np
import scipy.optimize
import torch

from pymbar_tpu_torch.ops.mbar_core import (
    _CHUNK_BYTES,
    _as_tensor,
    _work_on,
    core_stats,
    mbar_gradient,
    mbar_hessian,
    mbar_objective_and_gradient,
    mbar_W_nk,
    precondition_u_kn,
    self_consistent_update,
    u_kn_on,
    validate_inputs,
)
from pymbar_tpu_torch.utils import ParameterError, check_w_normalized, ensure_type

logger = logging.getLogger(__name__)

__all__ = [
    "JAX_SOLVER_PROTOCOL",
    "DEFAULT_SOLVER_PROTOCOL",
    "ROBUST_SOLVER_PROTOCOL",
    "BOOTSTRAP_SOLVER_PROTOCOL",
    "adaptive",
    "anderson",
    "solve_mbar_once",
    "solve_mbar",
    "solve_mbar_for_all_states",
    "batched_bootstrap_solve",
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

# Options that belong to the adaptive solver, not to scipy.
_ADAPTIVE_ONLY = ("min_sc_iter", "print_warning", "gamma", "verbose", "nr_method")


def target_device(device=None):
    """Where an entry point places a numpy input: ``device`` when given,
    else the CUDA card.  Without a card, with no device or a CUDA one asked
    for, it raises :class:`ParameterError`: nothing falls back to the CPU
    unasked."""
    if device is not None and torch.device(device).type != "cuda":
        return torch.device(device)
    if not torch.cuda.is_available():
        raise ParameterError(
            'no CUDA device is available: pass device="cpu" to run on the CPU'
        )
    return torch.device("cuda") if device is None else torch.device(device)


# -----------------------------------------------------------------------------
# Adaptive solver
# -----------------------------------------------------------------------------


def _lstsq_min_norm(H, g):
    """Minimum-norm least-squares solve of H x = g through the SVD, with the
    singular-value cutoff eps * s_max of ``jnp.linalg.lstsq(rcond=-1)``
    (the full MBAR Hessian is singular along the all-ones vector).  H may
    carry leading batch dimensions, g the same ones."""
    U, S, Vh = torch.linalg.svd(H, full_matrices=False)
    mask = S >= torch.finfo(H.dtype).eps * S[..., :1]
    s_inv = torch.where(mask, 1.0 / torch.where(mask, S, 1.0), 0.0)
    return (Vh.mT @ (s_inv * (U.mT @ g[..., None])[..., 0])[..., None])[..., 0]


def _adaptive_candidates(u_kn, N_k, f_k, gamma, nr_method="lstsq"):
    """One adaptive iteration's candidate steps and their gradient norms.

    Returns (f_sci, g_sci, gnorm_sci, f_nr, g_nr, gnorm_nr) as the
    reference's jax_core_adaptive (mbar_solvers.py:670-694); nr_method as
    :func:`_newton_direction`.  u_kn (B, K, N) with f_k (B, K) gives every
    replicate's candidates at once, batched over B.
    """
    _, g, f_sci = core_stats(u_kn, N_k, f_k)
    f_nr = f_k - gamma * _newton_direction(mbar_hessian(u_kn, N_k, f_k), g, nr_method)

    f_sci = f_sci - f_sci[..., :1]
    g_sci = mbar_gradient(u_kn, N_k, f_sci)
    g_nr = mbar_gradient(u_kn, N_k, f_nr)
    return (f_sci, g_sci, torch.linalg.vecdot(g_sci, g_sci),
            f_nr, g_nr, torch.linalg.vecdot(g_nr, g_nr))


def _newton_direction(H, g, nr_method="lstsq"):
    """H^-1 g with f_0 re-pinned: the Newton step of an adaptive iteration.

    'lstsq' is the reference's min-norm solve of the singular full Hessian;
    'chol' solves the reduced system H[1:, 1:] by Cholesky (NaN when it is
    not positive definite, as JAX's cho_factor).  H (..., K, K) and g
    (..., K) may carry leading batch dimensions.
    """
    if nr_method == "chol":
        L, info = torch.linalg.cholesky_ex(H[..., 1:, 1:])
        L = torch.where((info == 0)[..., None, None], L, torch.nan)
        dx1 = torch.cholesky_solve(g[..., 1:, None], L)[..., 0]
        Hinvg = torch.nn.functional.pad(dx1, (1, 0))
    else:
        Hinvg = _lstsq_min_norm(H, g)
    return Hinvg - Hinvg[..., :1]


def _adaptive_metrics(f_new, f_old, f_sci, f_nr, tol, delta_mode="relative"):
    """Convergence metrics (max_delta, max_diff) of one adaptive iteration,
    as tensors reduced over the last axis (one pair per replicate of a
    batch).

    'relative' reproduces the reference (mbar_solvers.py:627-640): divide by
    |f_k| (1 where |f_k| < min(1e-8, tol)).  'mixed' divides by
    max(|f_k|, 1), an absolute criterion for small values, used by the dd
    solver's float32 phase.
    """
    div = f_new[..., 1:].abs()
    if delta_mode == "mixed":
        div = div.clamp_min(1.0)
    else:
        div = torch.where(div < min(1.0e-8, tol), 1.0, div)
    max_delta = ((f_new[..., 1:] - f_old[..., 1:]).abs() / div).amax(dim=-1)
    max_diff = ((f_sci[..., 1:] - f_nr[..., 1:]).abs() / div).amax(dim=-1)
    return max_delta, max_diff


def _adaptive_stop(max_delta, max_diff, tol):
    """The adaptive stop rule: the change in f is below tol AND the SC/NR
    candidates agree to sqrt(tol), or the metric went NaN."""
    return torch.isnan(max_delta) | ((max_delta < tol) & (max_diff < math.sqrt(tol)))


def host_adaptive_metrics(f_new, f_old, f_sci, f_nr, tol, delta_mode="relative"):
    """:func:`_adaptive_metrics` of host arrays (their dtype kept), as floats."""
    max_delta, max_diff = _adaptive_metrics(
        *(torch.as_tensor(np.asarray(a)) for a in (f_new, f_old, f_sci, f_nr)), tol, delta_mode
    )
    return float(max_delta), float(max_diff)


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
        max_delta, max_diff = _adaptive_metrics(f_new, f_k, f_sci, f_nr, tol, delta_mode)
        done = bool(_adaptive_stop(max_delta, max_diff, tol))
        max_delta = float(max_delta)
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


def _anderson(sc, f, maxiter, tol, m_history, K=None, beta=1.0, delta_mode="relative",
              floor_stop=None, verbose=False):
    """Anderson-mixed iteration of the fixed-point map ``sc`` on the host, in
    float64 (the loop of :func:`anderson` and of the 2-D mesh's solves).

    Mixes the last ``m_history`` iterates by least squares on their residual
    differences (``beta`` < 1 damps the mix towards the previous iterates),
    re-pins f_0 = 0 and keeps the pad states (index >= ``K``, default none)
    at 0.  Stops when the change in f (``delta_mode`` of
    :func:`host_adaptive_metrics`) falls below ``tol``; with ``floor_stop``,
    also at the noise floor: the change, or its extrapolated next value,
    below it.  Returns (f, iterations, max_delta, converged, at_floor).
    """
    K = len(f) if K is None else K
    hist_x, hist_r = [], []
    it = 0
    max_delta = prev_delta = np.inf
    for it in range(1, maxiter + 1):
        gx = sc(f)
        gx[K:] = 0.0
        hist_x.append(gx)
        hist_r.append(gx - f)
        if len(hist_x) > m_history:
            hist_x.pop(0)
            hist_r.pop(0)
        f_new = gx
        if len(hist_r) > 1:
            # alpha minimizing || R alpha ||, sum(alpha) = 1, as an
            # unconstrained lstsq on residual differences
            R = np.stack(hist_r, axis=1)  # (K, q)
            dR = R[:, :-1] - R[:, -1:]
            try:
                gamma_c, *_ = np.linalg.lstsq(dR, R[:, -1], rcond=None)
                alpha = np.concatenate([-gamma_c, [1.0 + gamma_c.sum()]])
                f_new = np.stack(hist_x, axis=1) @ alpha
                if beta != 1.0:
                    x_prev = np.stack([x - r for x, r in zip(hist_x, hist_r)], axis=1)
                    f_new = (1 - beta) * (x_prev @ alpha) + beta * f_new
            except np.linalg.LinAlgError:
                pass
        f_new = f_new - f_new[0]
        f_new[K:] = 0.0
        max_delta, _ = host_adaptive_metrics(f_new[:K], f[:K], f_new[:K], f_new[:K], tol,
                                             delta_mode=delta_mode)
        f = f_new
        if verbose:
            logger.info(f"anderson iteration {it}: max_delta = {max_delta:.3e}")
        if max_delta < tol:
            return f, it, max_delta, True, False
        if floor_stop is not None:
            predicted = max_delta * max_delta / prev_delta if np.isfinite(prev_delta) else np.inf
            if max_delta < floor_stop or predicted < floor_stop:
                return f, it, max_delta, True, True
        prev_delta = max_delta
    return f, it, max_delta, False, False


def anderson(u_kn, N_k, f_k, tol=1.0e-12, options=None):
    """Anderson-accelerated self-consistent iteration (Hessian-free).

    The counterpart of :func:`pymbar_tpu.solvers.anderson` (no reference
    analog): the Eq. C3 fixed point with Anderson mixing over an ``m``-deep
    residual history (:func:`_anderson`).  Each iteration is one
    :func:`core_stats` pass pair on u_kn's device and O(K m^2) host algebra
    (numpy ``lstsq`` on the residual differences); no K x K Hessian.

    Options: ``maxiter`` (default 1000), ``m`` (history depth, default 5),
    ``beta`` (mixing, default 1.0), ``verbose``.
    Returns dict(success, message, x) like :func:`adaptive`, x a tensor.
    """
    options = dict(options or {})
    maxiter = int(options.get("maxiter", 1000))

    u_kn = _as_tensor(u_kn)
    N_k = torch.as_tensor(N_k, dtype=u_kn.dtype, device=u_kn.device)
    f = np.asarray(f_k.cpu() if torch.is_tensor(f_k) else f_k, dtype=np.float64)

    def sc(fv):
        _, _, f_sci = core_stats(u_kn, N_k, torch.as_tensor(fv, dtype=u_kn.dtype,
                                                            device=u_kn.device))
        return (f_sci - f_sci[0]).cpu().numpy().astype(np.float64)

    f, _, max_delta, success, _ = _anderson(
        sc, f - f[0], maxiter, tol, int(options.get("m", 5)),
        beta=float(options.get("beta", 1.0)), verbose=options.get("verbose", False))
    message = (
        "Convergence achieved by change in f with respect to previous guess."
        if success
        else "Did not converge."
    )
    if not success:
        logger.warning(
            f"anderson: did not converge (max_delta={max_delta:e}, maxiter={maxiter})"
        )
    return dict(success=success, message=message,
                x=torch.as_tensor(f, dtype=u_kn.dtype, device=u_kn.device))


# -----------------------------------------------------------------------------
# BFGS: jax.scipy.optimize.minimize(method="BFGS") in torch
# -----------------------------------------------------------------------------

# gtol of the BFGS stage.  The JAX package passes its ``tol`` to
# jax.scipy.optimize.minimize, which does not forward it to the BFGS
# (jax/_src/scipy/optimize/minimize.py), so that stage stops at the
# default gtol; the port keeps that stop so that both stop alike.
_BFGS_GTOL = 1.0e-5


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Minimizer of the cubic through (a, fa) with slope fpa, (b, fb) and
    (c, fc); NaN when it has none."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    d2_0 = fb - fa - C * db
    d2_1 = fc - fa - C * dc
    A = (dc ** 2 * d2_0 + -(db ** 2) * d2_1) / denom
    B = (-(dc ** 3) * d2_0 + db ** 3 * d2_1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + np.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Minimizer of the quadratic through (a, fa) with slope fpa and (b, fb)."""
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * B)


def _zoom(phi_dphi, wolfe_one, wolfe_two, a_lo, phi_lo, dphi_lo, a_hi, phi_hi, dphi_hi,
          g_0):
    """Zoom of Algorithm 3.6 (Wright and Nocedal 1999), in
    jax.scipy.optimize's form: a cubic, quadratic or bisection trial step
    per iteration; fails once the bracket is below 1e-10 or after 30
    iterations.  Returns (failed, a_star, phi_star, g_star)."""
    done = failed = False
    j = 0
    a_rec, phi_rec = (a_lo + a_hi) / 2.0, (phi_lo + phi_hi) / 2.0
    a_star, phi_star, g_star = np.float64(1.0), phi_lo, g_0
    while not done and not failed:
        dalpha = a_hi - a_lo
        a, b = min(a_hi, a_lo), max(a_hi, a_lo)
        cchk, qchk = 0.2 * dalpha, 0.1 * dalpha
        # the iteration still runs to its end, as there
        failed = bool(dalpha <= 1.0e-10)
        a_cubic = _cubicmin(a_lo, phi_lo, dphi_lo, a_hi, phi_hi, a_rec, phi_rec)
        use_cubic = j > 0 and a + cchk < a_cubic < b - cchk
        a_quad = _quadmin(a_lo, phi_lo, dphi_lo, a_hi, phi_hi)
        use_quad = not use_cubic and a + qchk < a_quad < b - qchk
        if use_cubic:
            a_j = a_cubic
        elif use_quad:
            a_j = a_quad
        else:
            a_j = (a_lo + a_hi) / 2.0
        phi_j, dphi_j, g_j = phi_dphi(a_j)

        hi_to_j = wolfe_one(a_j, phi_j) or phi_j >= phi_lo
        star_to_j = wolfe_two(dphi_j) and not hi_to_j
        hi_to_lo = dphi_j * (a_hi - a_lo) >= 0.0 and not hi_to_j and not star_to_j
        lo_to_j = not hi_to_j and not star_to_j
        if hi_to_j:
            a_hi, phi_hi, dphi_hi, a_rec, phi_rec = a_j, phi_j, dphi_j, a_hi, phi_hi
        if star_to_j:
            done = True
            a_star, phi_star, g_star = a_j, phi_j, g_j
        if hi_to_lo:
            a_hi, phi_hi, dphi_hi, a_rec, phi_rec = a_lo, phi_lo, dphi_lo, a_hi, phi_hi
        if lo_to_j and not hi_to_lo:
            a_rec, phi_rec = a_lo, phi_lo
        if lo_to_j:
            a_lo, phi_lo, dphi_lo = a_j, phi_j, dphi_j
        j += 1
        failed = failed or j >= 30
    return failed, a_star, phi_star, g_star


def _line_search(fun, xk, pk, phi_0, old_old_fval, gfk, c1=1.0e-4, c2=0.9, maxiter=10):
    """Inexact line search under the strong Wolfe conditions: Algorithm 3.5
    (Wright and Nocedal 1999) in jax.scipy.optimize's form, with its first
    trial step from the previous objective decrease and the trial step
    doubled after each iteration.  Returns (failed, a_k, f_k, g_k)."""

    def phi_dphi(t):
        phi, g = fun(xk + float(t) * pk)
        pair = torch.stack([phi, torch.dot(g, pk)]).cpu().numpy()
        return pair[0], pair[1], g

    dphi_0 = np.float64(float(torch.dot(gfk, pk)))
    candidate = 1.01 * 2 * (phi_0 - old_old_fval) / dphi_0
    start_value = np.float64(1.0) if candidate > 1 else candidate

    def wolfe_one(a_i, phi_i):
        return bool(phi_i > phi_0 + c1 * a_i * dphi_0)

    def wolfe_two(dphi_i):
        return bool(np.abs(dphi_i) <= -c2 * dphi_0)

    done = failed = False
    i = 1
    a_i1, phi_i1, dphi_i1 = np.float64(0.0), phi_0, dphi_0
    a_star, phi_star, g_star = np.float64(0.0), phi_0, gfk
    while not done and i <= maxiter and not failed:
        a_i = start_value if i == 1 else a_i1 * 2.0
        phi_i, dphi_i, g_i = phi_dphi(a_i)
        star_to_zoom1 = wolfe_one(a_i, phi_i) or (phi_i >= phi_i1 and i > 1)
        star_to_i = wolfe_two(dphi_i) and not star_to_zoom1
        star_to_zoom2 = dphi_i >= 0.0 and not star_to_zoom1 and not star_to_i
        if star_to_zoom1:
            z_failed, a_star, phi_star, g_star = _zoom(
                phi_dphi, wolfe_one, wolfe_two, a_i1, phi_i1, dphi_i1, a_i, phi_i, dphi_i, gfk
            )
            done, failed = True, failed or z_failed
        if star_to_i:
            done = True
            a_star, phi_star, g_star = a_i, phi_i, g_i
        if star_to_zoom2:
            z_failed, a_star, phi_star, g_star = _zoom(
                phi_dphi, wolfe_one, wolfe_two, a_i, phi_i, dphi_i, a_i1, phi_i1, dphi_i1, gfk
            )
            done, failed = True, failed or z_failed
        i += 1
        a_i1, phi_i1, dphi_i1 = a_i, phi_i, dphi_i
    return failed or not done, a_star, phi_star, g_star


def _minimize_bfgs(fun, x0, maxiter, gtol=_BFGS_GTOL, line_search_maxiter=10):
    """BFGS (Algorithm 6.1, Wright and Nocedal 1999) as
    ``jax.scipy.optimize.minimize(method="BFGS")`` runs it: identity initial
    inverse Hessian, :func:`_line_search` with ``line_search_maxiter``, the
    inverse-Hessian update skipped when 1 / (y . s) is not finite, and the
    stop on the inf-norm of the gradient below ``gtol``.  ``fun(x)`` returns
    (value, gradient) as tensors on x's device.  Returns (x, success,
    iterations), success = converged and no line search failed."""
    with np.errstate(all="ignore"):
        f, g = fun(x0)
        f = np.float64(float(f))
        x = x0
        H = torch.eye(x0.shape[0], dtype=x0.dtype, device=x0.device)
        converged = bool(torch.linalg.vector_norm(g, ord=np.inf) < gtol)
        failed = False
        old_old_fval = f + np.float64(float(torch.linalg.vector_norm(g))) / 2
        k = 0
        while not converged and not failed and k < maxiter:
            p = -(H @ g)
            failed, a_k, f_new, g_new = _line_search(
                fun, x, p, f, old_old_fval, g, maxiter=line_search_maxiter
            )
            s = float(a_k) * p
            y = g_new - g
            rho = 1.0 / torch.dot(y, s)
            if bool(torch.isfinite(rho)):
                w = torch.eye(x.shape[0], dtype=x.dtype, device=x.device) - rho * torch.outer(s, y)
                H = w @ H @ w.T + rho * torch.outer(s, s)
            converged = bool(torch.linalg.vector_norm(g_new, ord=np.inf) < gtol)
            k += 1
            old_old_fval = f
            x, f, g = x + s, f_new, g_new
    return x, converged and not failed, k


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
    device=None,
    rows=None,
):
    """Solve MBAR once with a single method, f_0 pinned to zero.

    Mirrors reference mbar_solvers.py:738-883: inputs are validated,
    preconditioned, and solved in the K-1 dimensional reduced coordinate
    system (f_0 := 0).  ``method`` may be "adaptive", "anderson", "BFGS"
    (:func:`_minimize_bfgs` on u's device, as the JAX package's
    device stage), "dd" (the two-phase double-word solver of
    :mod:`pymbar_tpu_torch.solvers_large`), any other gradient-based
    scipy.optimize.minimize method, or a scipy.optimize.root method
    ("hybr"/"lm") with the analytic Jacobian.

    ``rows`` solves the rows ``rows`` of ``u_kn_nonzero`` (N_k and f_k hold
    theirs only), ``device`` says where (default: u's own).  The dd stage
    streams those rows' column chunks into its planes; every other method
    reads the matrix each iteration and gathers it onto ``device`` whole
    (:func:`pymbar_tpu_torch.ops.mbar_core.u_kn_on`), freed on return.

    Returns (f_k_nonzero ndarray, results dict).
    """
    del continuation  # consumed by solve_mbar; accepted for **solver splat
    options = dict(options or {})
    if method == "dd":
        u_kn_nonzero = _as_tensor(u_kn_nonzero)
        K = u_kn_nonzero.shape[0] if rows is None else len(rows)
        N_k_nonzero = ensure_type(N_k_nonzero, "float", 1, "N_k", shape=(K,), warn_on_cast=False)
        f_k_nonzero = ensure_type(f_k_nonzero, "float", 1, "f_k", shape=(K,))
    else:
        u_kn_nonzero, N_k_nonzero, f_k_nonzero = validate_inputs(
            u_kn_on(u_kn_nonzero, device, rows), N_k_nonzero, f_k_nonzero
        )
    f_k_nonzero = f_k_nonzero - f_k_nonzero[0]

    if method == "dd":
        # Two-phase double-word solve.  The split streams the rows' column
        # chunks onto ``device`` and applies the per-sample min shift
        # (gradients are shift-invariant; the dd solver never consumes the
        # objective).
        from pymbar_tpu_torch.solvers_large import solve_mbar_dd, stream_split_planes

        uh, ul = stream_split_planes(u_kn_nonzero, device, rows)
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
        elif method == "anderson":
            results = anderson(u_dev, N_dev, f_dev, tol=tol, options=options)
            f_k_nonzero = results["x"].cpu().numpy()
        elif method == "BFGS":
            # the f_0-pinned objective on u's device (the reference's JAX
            # protocol stage, mbar_solvers.py:820-834)
            def obj_and_grad(x):
                obj, g = mbar_objective_and_gradient(u_dev, N_dev,
                                                     torch.nn.functional.pad(x, (1, 0)))
                return obj, g[1:]

            x, success, _k = _minimize_bfgs(obj_and_grad, f_dev[1:],
                                            maxiter=int(options.get("maxiter", 10000)))
            f_k_nonzero = np.pad(x.cpu().numpy(), (1, 0))
            results = dict(x=x, success=success)
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


def solve_mbar(u_kn_nonzero, N_k_nonzero, f_k_nonzero, solver_protocol=None, device=None,
               rows=None):
    """Run a chain of solvers, keeping the best-gradient-norm result on failure.

    Mirrors reference mbar_solvers.py:886-974: each protocol stage is tried
    in order; a successful stage short-circuits; on total failure the stage
    with the smallest final gradient norm wins; stages with
    ``continuation=True`` hand their f_k to the next stage.  ``device`` and
    ``rows`` as in :func:`solve_mbar_once`.
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
            u_kn_nonzero, N_k_nonzero, f_k_nonzero, **solver, device=device, rows=rows
        )
        all_fks.append(f_k_nonzero_result)
        if "gnorm" in results.get("info", {}):
            # the dd stage certified its own gradient norm
            all_gnorms.append(float(results["info"]["gnorm"]))
        else:
            g = mbar_gradient(u_t, N_k_nonzero, f_k_nonzero_result, device=device, rows=rows)
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
    state is empty).  Returns f_k, a float64 ndarray, as the JAX package
    does; :func:`_solve_mbar_for_all_states` also returns the per-stage
    result dicts.
    """
    return _solve_mbar_for_all_states(u_kn, N_k, f_k, states_with_samples, solver_protocol)[0]


def _solve_mbar_for_all_states(u_kn, N_k, f_k, states_with_samples, solver_protocol,
                               device=None):
    """:func:`solve_mbar_for_all_states` returning (f_k ndarray, list of
    per-stage result dicts): the MBAR class's front door.

    ``device``: where the work runs (default: u's own).  A CPU u_kn with a
    CUDA device stays in host memory under a dd-only protocol (the split
    and the empty-state fill stream its column chunks); any other protocol
    reads the matrix every iteration, so it is uploaded whole for the
    solve and freed on return."""
    u_kn = _as_tensor(u_kn)
    dev = _work_on(u_kn, device)[1]
    dd_only = all(s.get("method") == "dd" for s in (solver_protocol or ()))
    if not dd_only:
        u_kn = u_kn_on(u_kn, dev)
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
        f_k_nonzero, all_results = solve_mbar(
            u_kn,
            N_k[states_with_samples],
            f_k[states_with_samples],
            solver_protocol=solver_protocol,
            device=dev,
            rows=None if all_sampled else states_with_samples,
        )

    f_k[states_with_samples] = np.asarray(f_k_nonzero)

    # With no empty states and a dd-only protocol the SC fill is pure cost:
    # f already satisfies the SC equations past the dd noise floor.
    if dd_only and len(states_with_samples) == len(N_k):
        return f_k - f_k[0], all_results
    f_k = self_consistent_update(u_kn, N_k.astype(np.float64), f_k, device=dev).cpu().numpy()
    return f_k - f_k[0], all_results


# -----------------------------------------------------------------------------
# Batched bootstrap replicates
# -----------------------------------------------------------------------------

# Bytes of a chunk's working set per replicate, in units of the gathered
# (K, N) float64 matrix: the gather, its preconditioned sampled rows and
# the compaction's copy; the reductions' temporaries are column chunks of
# the whole batch, bounded by mbar_core._CHUNK_BYTES.  An H100 read 3.0
# per replicate at 545 MB (PERF.md); 6 leaves room.
_BOOT_BYTES_PER_MATRIX = 6

# Share of the card's free memory one chunk of replicates may take.  The
# chunk width changed the wall by under 20% at 545 MB (1 to 16 replicates
# per chunk, PERF.md); it matters below ~100 MB, where a chunk holds
# every replicate.
_BOOT_FREE_SHARE = 0.5


def _boot_chunk(B, K, N, dev, chunk_bytes=None):
    """Replicates per batched chunk: ``chunk_bytes`` (default: half of the
    card's free memory on CUDA, ``mbar_core._CHUNK_BYTES`` on the CPU)
    over the per-replicate working set."""
    if chunk_bytes is None:
        if dev.type == "cuda":
            chunk_bytes = int(torch.cuda.mem_get_info(dev)[0] * _BOOT_FREE_SHARE)
        else:
            chunk_bytes = _CHUNK_BYTES
    per = _BOOT_BYTES_PER_MATRIX * 8 * K * N
    return int(max(1, min(B, chunk_bytes // per)))


def _batched_adaptive(U, N_k, F, gamma, tol, maxiter, min_sc_iter, nr_method):
    """The adaptive loop of :func:`_adaptive_while` for every replicate of
    U (B, K, N) at once, one host sync per iteration: the same candidates,
    metrics and stop rule, batched over B.

    Each replicate keeps its own SC count and stop; a replicate that has
    stopped is dropped from U and never stepped again, so its result is the
    one it would reach alone (the select semantics of the JAX package's
    vmapped while_loop).  Returns ((B, K) f, (B,) bool done)."""
    B = U.shape[0]
    dev = U.device
    f_out = F.clone()
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    live = torch.arange(B, device=dev)
    sci_iter = torch.zeros(B, dtype=torch.int64, device=dev)
    it = 0
    while it < maxiter and live.numel():
        f_sci, _g_sci, gn_sci, f_nr, _g_nr, gn_nr = _adaptive_candidates(
            U, N_k, F, gamma, nr_method
        )
        take_sci = (gn_sci < gn_nr) | (sci_iter < min_sc_iter)
        f_new = torch.where(take_sci[:, None], f_sci, f_nr)
        sci_iter = sci_iter + take_sci.to(torch.int64)
        stop = _adaptive_stop(*_adaptive_metrics(f_new, F, f_sci, f_nr, tol), tol)
        F = f_new
        f_out[live] = F
        it += 1
        if bool(stop.any()):
            done[live[stop]] = True
            keep = torch.nonzero(~stop)[:, 0]
            live, U, F, sci_iter = live[keep], U[keep], F[keep], sci_iter[keep]
    return f_out, done


def batched_bootstrap_solve(
    u_kn,
    N_k,
    f_k,
    rints,
    maxiter=10000,
    min_sc_iter=2,
    gamma=1.0,
    tol=1.0e-12,
    nr_method="lstsq",
    chunk_bytes=None,
    verbose=False,
    device=None,
):
    """Solve every bootstrap replicate's f_k batched.

    The counterpart of :func:`pymbar_tpu.solvers.batched_bootstrap_solve`:
    per-replicate ``solve_mbar_for_all_states`` with a single-stage
    adaptive protocol warm-started at the converged ``f_k`` (reference
    mbar.py:417-449), with the gathers ``u_kn[:, r]``, the preconditioning,
    the adaptive loops and the empty-state SC fill batched over a (B_chunk,
    K, N) tensor (:func:`_batched_adaptive`; the JAX package vmaps its
    while_loop).  The chunk width comes from ``chunk_bytes``, by default
    half of the card's free memory (:func:`_boot_chunk`).

    ``u_kn``: a tensor (used on its device) or numpy (placed on ``device``,
    by default the card); ``rints``: the (B, N) resample indices.
    Returns (f_boots (B, K) ndarray with f_0 = 0, n_fail).
    """
    if torch.is_tensor(u_kn):
        u = u_kn
    else:
        u = torch.as_tensor(np.asarray(u_kn, dtype=np.float64), device=target_device(device))
    dev, dt = u.device, u.dtype
    N_k = np.asarray(N_k, dtype=np.float64)
    f_k = np.asarray(f_k, dtype=np.float64)
    rints = np.asarray(rints)
    B = rints.shape[0]
    K, N = u.shape
    sws = np.where(N_k != 0)[0]
    sws_dev = torch.as_tensor(sws, device=dev)
    N_all = torch.as_tensor(N_k, dtype=dt, device=dev)
    N_sub = N_all[sws_dev]
    f_init = torch.as_tensor(f_k - f_k[0], dtype=dt, device=dev)[sws_dev]

    chunk = _boot_chunk(B, K, N, dev, chunk_bytes)
    f_boots = np.zeros((B, K))
    n_fail = 0
    for start in range(0, B, chunk):
        r = torch.as_tensor(rints[start : start + chunk], device=dev)
        Bc = r.shape[0]
        U_full = u[:, r].permute(1, 0, 2)  # (Bc, K, N), a gather
        if len(sws) > 1:
            U = precondition_u_kn(U_full if len(sws) == K else U_full.index_select(1, sws_dev),
                                  N_sub, f_init)
            F, done = _batched_adaptive(U, N_sub, f_init.expand(Bc, -1).clone(), gamma, tol,
                                        maxiter, min_sc_iter, nr_method)
            del U
        else:
            F = torch.zeros((Bc, 1), dtype=dt, device=dev)
            done = torch.ones(Bc, dtype=torch.bool, device=dev)
        # empty-state fill: one SC update over all K states, f_0 re-pinned
        F_all = torch.zeros((Bc, K), dtype=dt, device=dev)
        F_all[:, sws_dev] = F
        F_all = self_consistent_update(U_full, N_all, F_all)
        del U_full
        f_boots[start : start + Bc] = (F_all - F_all[:, :1]).cpu().numpy()
        n_fail += int((~done).sum())
        if verbose:
            logger.info(f"Calculated {start + Bc:d}/{B:d} bootstrap samples (batched, "
                        f"{chunk:d} per chunk)")
    return f_boots, n_fail
