"""Two-state free-energy estimators: BAR, EXP and variants (PyTorch port).

A numpy carry-over of :mod:`pymbar_tpu.other_estimators` (at parity with
pymbar 4.x other_estimators.py:56-719).  These operate on 1-D work arrays
(typically small) and run on the host in float64 with stable log-space
arithmetic; :func:`bar_overlap` builds the port's :class:`MBAR`, on the CUDA
card unless ``device="cpu"`` is asked for.
"""

import logging

import numpy as np

from pymbar_tpu_torch import timeseries
from pymbar_tpu_torch.utils import (
    BoundsError,
    ConvergenceError,
    ParameterError,
    logsumexp,
)

logger = logging.getLogger(__name__)

__all__ = ["bar_zero", "bar", "bar_overlap", "exp", "exp_gauss"]


def _fermi_log_moments(x):
    """First and second moments of the Fermi function f(x) = 1/(1 + e^x)
    over a work array, evaluated in guarded log space.

    Uses the softplus identity log f(x) = -(max(x, 0) + log1p(e^-|x|)) —
    overflow-free on either tail — and one logsumexp per moment:
    <f^p> = exp(logsumexp(p log f) - log T).  Shared by the 'BAR'
    (Bennett Eq. 10a) and 'MBAR' (exact two-state Eq. E9) uncertainty
    variants of :func:`bar`.
    """
    log_f = -(np.maximum(x, 0.0) + np.log1p(np.exp(-np.abs(x))))
    log_T = np.log(float(x.size))
    return (
        np.exp(logsumexp(log_f) - log_T),
        np.exp(logsumexp(2.0 * log_f) - log_T),
    )


def bar_zero(w_F, w_R, DeltaF):
    """The implicit BAR function; zero when DeltaF solves the BAR equation.

    fzero = ln sum_F fermi(-(M + w_F - DeltaF)) - ln sum_R fermi(-( -(M - w_R
    - DeltaF))), with M = ln(T_F/T_R); overflow-guarded by exponentiating only
    non-positive arguments (reference other_estimators.py:56-153).  Returns
    nan when the inputs overflow even the guarded form.
    """
    w_F = np.array(w_F, np.float64)
    w_R = np.array(w_R, np.float64)
    DeltaF = float(DeltaF)

    T_F = float(w_F.size)
    T_R = float(w_R.size)
    M = np.log(T_F / T_R)

    with np.errstate(over="raise"):
        # log f(W) = -maxarg - log(exp(-maxarg) + exp(arg - maxarg)),
        # maxarg = max(arg, 0), for the Fermi function 1/(1+exp(arg)).
        exp_arg_F = M + w_F - DeltaF
        max_arg_F = np.where(exp_arg_F > 0.0, exp_arg_F, 0.0)
        try:
            log_f_F = -max_arg_F - np.log(
                np.exp(-max_arg_F) + np.exp(exp_arg_F - max_arg_F)
            )
        except FloatingPointError:
            logger.warning("The input data results in overflow in bar")
            return np.nan
        log_numer = logsumexp(log_f_F)

        exp_arg_R = -(M - w_R - DeltaF)
        max_arg_R = np.where(exp_arg_R > 0.0, exp_arg_R, 0.0)
        try:
            log_f_R = -max_arg_R - np.log(
                np.exp(-max_arg_R) + np.exp(exp_arg_R - max_arg_R)
            )
        except FloatingPointError:
            logger.info("The input data results in overflow in bar")
            return np.nan
        log_denom = logsumexp(log_f_R)

    return log_numer - log_denom


def bar(
    w_F, w_R, DeltaF=0.0, compute_uncertainty=True,
    uncertainty_method="BAR", maximum_iterations=500,
    relative_tolerance=1.0e-12, verbose=False,
    method="false-position", iterated_solution=True,
):
    """Bennett acceptance ratio estimate of the free energy difference.

    Root-solves :func:`bar_zero` via 'false-position' (default), 'bisection'
    or 'self-consistent-iteration', bracketing with the two EXP estimates;
    uncertainty via Bennett Eq. 10a ('BAR') or the exact two-state MBAR
    Eq. E9 ('MBAR').  ``iterated_solution=False`` gives the one-step
    TMS-equivalent estimate.  Returns dict('Delta_f'[, 'dDelta_f']).

    Reference other_estimators.py:156-531 (NaN/poor-overlap path returns
    Delta_f = 0 with a warning, :263-276).
    """
    w_F = np.asarray(w_F, dtype=np.float64)
    w_R = np.asarray(w_R, dtype=np.float64)

    result_vals = dict()

    if not iterated_solution:
        maximum_iterations = 1
        method = "self-consistent-iteration"
        DeltaF_initial = DeltaF

    if method not in ["self-consistent-iteration", "false-position", "bisection"]:
        raise ParameterError(f"method {method} is not defined for bar")
    if uncertainty_method not in ["BAR", "MBAR"]:
        raise ParameterError(
            f"uncertainty_method {uncertainty_method} is not defined for bar"
        )

    # Root solve.  Solver state: the current estimate plus, for the two
    # bracketing methods, the sign-change interval (lo, hi) with its
    # endpoint values (Flo, Fhi).  Every implicit-function evaluation goes
    # through the counting closure so the verbose convergence report can
    # quote the true cost.
    nfunc = 0
    relative_change = np.nan
    iteration = 0

    def feval(x):
        nonlocal nfunc
        nfunc += 1
        return bar_zero(w_F, w_R, x)

    bracketed = method in ("bisection", "false-position")
    if bracketed:
        # Seed the bracket with the two one-sided EXP estimates; if the
        # endpoint values share a sign, pull both endpoints toward the
        # midpoint by at least 0.1 per round until the sign flips
        # (reference widening rule, other_estimators.py:238-260).
        hi, lo = exp(w_F)["Delta_f"], -exp(w_R)["Delta_f"]
        Fhi, Flo = feval(hi), feval(lo)

        if np.isnan(Fhi) or np.isnan(Flo):
            logger.warning(
                "BAR is likely to be inaccurate because of poor overlap. "
                "Improve the sampling, or decrease the spacing between "
                "states.  For now, guessing that the free energy difference "
                "is 0 with no uncertainty."
            )
            result_vals["Delta_f"] = 0.0
            if compute_uncertainty:
                result_vals["dDelta_f"] = 0.0
            return result_vals

        while Fhi * Flo > 0:
            if verbose:
                logger.info("Initial brackets did not actually bracket, widening them")
            mid = (hi + lo) / 2
            hi, lo = hi - max(abs(hi - mid), 0.1), lo + max(abs(lo - mid), 0.1)
            Fhi, Flo = feval(hi), feval(lo)

    for iteration in range(maximum_iterations + 1):
        x_prev, FNew = DeltaF, np.nan

        if not bracketed:
            # fixed-point map x <- x - fzero(x)
            DeltaF = DeltaF - feval(DeltaF)
        elif method == "bisection":
            DeltaF = (hi + lo) / 2
            FNew = feval(DeltaF)
        else:
            # false position: secant through the bracket endpoints
            if hi == 0.0 and lo == 0.0:
                DeltaF, FNew = 0.0, 0.0
                nfunc += 1  # count parity with the evaluated branch
            else:
                DeltaF = hi - Fhi * (hi - lo) / (Fhi - Flo)
                FNew = feval(DeltaF)
            if FNew == 0:
                if verbose:
                    logger.info("Convergence achieved.")
                relative_change = 1.0e-15
                break

        if DeltaF == 0.0:
            # exact zero is a fixed point of every update rule above
            if verbose:
                logger.info("The free energy difference appears to be zero.")
            break

        if iterated_solution:
            relative_change = abs((DeltaF - x_prev) / DeltaF)
            if verbose:
                logger.info(f"relative_change = {relative_change:12.3f}")
            if iteration > 0 and relative_change < relative_tolerance:
                if verbose:
                    logger.info("Convergence achieved.")
                break

        if bracketed:
            # replace the endpoint that shares the new point's sign
            if Fhi * FNew < 0:
                lo, Flo = DeltaF, FNew
            elif Flo * FNew <= 0:
                hi, Fhi = DeltaF, FNew
            else:
                raise BoundsError("WARNING: Cannot determine bound on free energy")

        if verbose:
            logger.info(f"iteration {iteration:5d}: DeltaF = {DeltaF:16.3f}")

    if iterated_solution:
        if iteration >= maximum_iterations:
            raise ConvergenceError(
                "WARNING: Did not converge to within specified tolerance. "
                f"max_delta = {relative_change:f}, "
                f"TOLERANCE = {relative_tolerance:f}, "
                f"MAX_ITS = {maximum_iterations:d}"
            )
        if verbose:
            logger.info(
                f"Converged to tolerance of {relative_change:e} in "
                f"{iteration:d} iterations ({nfunc:d} function evaluations)"
            )

    if not compute_uncertainty:
        if verbose:
            logger.info(f"DeltaF = {DeltaF:8.3f}")
        result_vals["Delta_f"] = DeltaF
        return result_vals

    # Uncertainty: Bennett Eq. 10a ('BAR', with the n_1<f>_1^2 correction) or
    # the exact two-state MBAR Eq. E9 ('MBAR'); see reference
    # other_estimators.py:370-525 for the full derivation commentary.  Both
    # variants consume the same two Fermi moments per work direction, so the
    # guarded log-space evaluation lives in one helper.
    T_F = float(w_F.size)
    T_R = float(w_R.size)
    C = np.log(T_F / T_R) - (DeltaF if iterated_solution else DeltaF_initial)

    afF, afF2 = _fermi_log_moments(w_F + C)
    afR, afR2 = _fermi_log_moments(w_R - C)
    nrat = (T_F + T_R) / (T_F * T_R)

    if uncertainty_method == "BAR":
        dDeltaF = np.sqrt((afF2 / afF**2) / T_F + (afR2 / afR**2) / T_R - nrat)
    else:  # MBAR
        dDeltaF = np.sqrt(1.0 / ((afF - afF2) * T_F + (afR - afR2) * T_R) - nrat)

    if verbose:
        logger.info(f"DeltaF = {DeltaF:8.3f} +- {dDeltaF:8.3f}")
    result_vals["Delta_f"] = DeltaF
    result_vals["dDelta_f"] = dDeltaF
    return result_vals


def bar_overlap(w_F, w_R, device=None):
    """MBAR-definition overlap between forward and reverse work ensembles.

    Builds the exact 2-state MBAR problem from the work values, asserts the
    BAR and MBAR free energies agree, and returns the overlap scalar
    (reference other_estimators.py:534-569).  ``device`` places the MBAR
    problem as :class:`pymbar_tpu_torch.MBAR` does (default: the CUDA card).
    """
    from pymbar_tpu_torch.mbar import MBAR

    w_F = np.asarray(w_F, dtype=np.float64)
    w_R = np.asarray(w_R, dtype=np.float64)

    # Two-state reduced potentials, samples concatenated [F-ensemble |
    # R-ensemble]: state 0 is each sample's own ensemble (u = 0 offset),
    # state 1 the other, so the off-diagonal rows carry the work values.
    u_kn = np.stack(
        [
            np.concatenate([np.zeros_like(w_F), w_R]),
            np.concatenate([w_F, np.zeros_like(w_R)]),
        ]
    )
    mbar = MBAR(u_kn, np.array([w_F.size, w_R.size]), device=device)

    res = bar(w_F, w_R)
    mbar_df = mbar.f_k[1] - mbar.f_k[0]
    assert np.isclose(mbar_df, res["Delta_f"]), (
        f"BAR: {res['Delta_f']} +- {res['dDelta_f']} | MBAR: {mbar_df}"
    )

    return mbar.compute_overlap()["scalar"]


def exp(w_F, compute_uncertainty=True, is_timeseries=False):
    """Zwanzig exponential-averaging (EXP) free energy estimate.

    DeltaF = -(ln sum exp(-w) - ln T); uncertainty from the standard error of
    the shifted exponentials, optionally corrected by the statistical
    inefficiency when ``is_timeseries`` (reference other_estimators.py:572-647).
    """
    w_F = np.asarray(w_F, dtype=np.float64)
    T = float(w_F.size)
    out = {"Delta_f": -(logsumexp(-w_F) - np.log(T))}

    if compute_uncertainty:
        # standard error of the max-shifted exponentials, over effective
        # (independent) sample count T/g
        x = np.exp(-w_F - np.max(-w_F))
        g = 1.0
        if is_timeseries:
            g = timeseries.statistical_inefficiency(x, x)
        out["dDelta_f"] = (np.std(x) / np.sqrt(T / g)) / x.mean()

    return out


def exp_gauss(w_F, compute_uncertainty=True, is_timeseries=False):
    """Gaussian-approximation EXP: DeltaF = <w> - var(w)/2.

    Uncertainty dx^2 = var/T_eff + var^2 / (2 (T_eff - 1)) (reference
    other_estimators.py:650-719).
    """
    w_F = np.asarray(w_F, dtype=np.float64)
    T = float(np.size(w_F))

    var = np.var(w_F)
    DeltaF = np.average(w_F) - 0.5 * var

    result_vals = dict()
    if compute_uncertainty:
        T_eff = T
        if is_timeseries:
            g = timeseries.statistical_inefficiency(w_F, w_F)
            T_eff = T / g
        dx2 = var / T_eff + 0.5 * var * var / (T_eff - 1)
        result_vals["Delta_f"] = DeltaF
        result_vals["dDelta_f"] = np.sqrt(dx2)
    else:
        result_vals["Delta_f"] = DeltaF
    return result_vals
