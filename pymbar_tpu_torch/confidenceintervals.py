"""Statistical QA of uncertainty estimates over many replicates (PyTorch port).

A numpy/scipy carry-over of :mod:`pymbar_tpu.confidenceintervals` (at
parity with pymbar 4.x confidenceintervals.py:33-461):
``order_replicates`` (error z-scores, sorted per component),
``anderson_darling`` (case-1 A-D normality statistic), ``qq_plot``
(matplotlib Q-Q grids, imported only when called), and
``generate_confidence_intervals`` (observed P(error < alpha sigma) vs the
normal erf(alpha/sqrt 2) and the Chebyshev bound, plus bias/RMS summaries).

Each replicate is a dict with keys 'estimated', 'error', 'destimated', where
entries are scalars (dim 0), K-vectors (dim 1) or KxK matrices (dim 2).
Host-side analysis code; vectorized over replicates where the reference
loops.
"""

import logging
from textwrap import dedent

import numpy as np
import scipy.special
import scipy.stats

logger = logging.getLogger(__name__)

__all__ = [
    "order_replicates",
    "anderson_darling",
    "qq_plot",
    "generate_confidence_intervals",
]


def order_replicates(replicates, K):
    """Per-component sorted z-scores error/sigma across replicates.

    sigma is taken from the FIRST replicate's 'destimated' (as in the
    reference, confidenceintervals.py:33-74); zero sigmas are replaced by 1
    for the division and callers mask them out.
    """
    sigma = np.array(replicates[0]["destimated"], dtype=np.float64, copy=True)
    zerosigma = sigma == 0
    sigma_safe = sigma + zerosigma

    yi = np.asarray([np.asarray(r["error"]) / sigma_safe for r in replicates])
    # Sort along the replicate axis independently for every component.
    return np.sort(yi, axis=0)


def anderson_darling(replicates, K):
    """Case-1 Anderson-Darling statistic of error normality per component.

    Thresholds (reference confidenceintervals.py:95-106): 15% 1.610, 10%
    1.933, 5% 2.492, 2.5% 3.070, 1% 3.857; ~4.5 is a practical alarm level
    given sigma itself is estimated.  Components with zero estimated sigma
    return 0.
    """
    sortedyi = order_replicates(replicates, K)
    zerosigma = np.asarray(replicates[0]["destimated"]) == 0

    N = len(replicates)
    dims = np.shape(np.asarray(replicates[0]["destimated"]))
    total = np.zeros(dims)
    for i in range(N):
        cdfi = scipy.stats.norm.cdf(sortedyi[i])
        total = total + (2 * i - 1) * np.log(cdfi) + (2 * (N - i) + 1) * np.log(1 - cdfi)
    A2 = -N - total / N
    A2 = np.asarray(A2)
    if A2.ndim == 0:
        return 0.0 if zerosigma else float(A2)
    A2[zerosigma] = 0
    return A2


def qq_plot(replicates, K, title="Generic Q-Q plot", filename="qq.pdf"):
    """Grid of Q-Q plots of the error z-scores vs the standard normal.

    Reference confidenceintervals.py:128-223.  Requires matplotlib.
    """
    import matplotlib
    import matplotlib.pyplot as plt

    sortedyi = order_replicates(replicates, K)
    N = len(replicates)
    dim = len(np.shape(replicates[0]["error"]))
    xvals = scipy.stats.norm.ppf((np.arange(0, N) + 0.5) / N)

    labelij = {}
    if dim == 0:
        nplots = 1
        yy = sortedyi.reshape(N, 1)
    elif dim == 1:
        nplots = K
        yy = sortedyi
    else:
        nplots = K * (K - 1)
        yy = np.zeros([N, nplots])
        k = 0
        for i in range(K):
            for j in range(K):
                if i != j:
                    yy[:, k] = sortedyi[:, i, j]
                    labelij[k] = [i, j]
                    k += 1

    sq = nplots**0.5
    labelsize = 30.0 / sq
    matplotlib.rc("axes", facecolor="#E3E4FA")
    matplotlib.rc("axes", edgecolor="white")
    matplotlib.rc("xtick", labelsize=labelsize)
    matplotlib.rc("ytick", labelsize=labelsize)
    h = int(sq)
    w = h + 1 + 1 * (sq - h > 0.5)
    fig = plt.figure(figsize=(8, 6))
    for i in range(nplots):
        ax = plt.subplot(h, w, i + 1)
        ms = 75.0 / len(yy[:, i])
        ax.plot(xvals, yy[:, i], color="r", ms=ms, marker="o", mec="r")
        ax.plot(xvals, xvals, color="b", ls="-")
        plt.xlim(xvals.min(), xvals.max())
        if dim == 1:
            label = r"State $\mathrm{%d}$" % i
        elif dim == 2:
            label = r"State $\mathrm{%d-%d}$" % (labelij[i][0], labelij[i][1])
        else:
            label = None
        if label:
            ax.annotate(
                label,
                xy=(0.5, 0.9),
                xycoords=("axes fraction", "axes fraction"),
                xytext=(0, -2),
                size=labelsize,
                textcoords="offset points",
                va="top",
                ha="center",
                color="#151B54",
                bbox=dict(fc="w", ec="none", alpha=0.5),
            )
    plt.suptitle(title, fontsize=20)
    plt.savefig(filename)
    plt.close(fig)


def _component_arrays(replicates, K, dim):
    """Stack (|error|, destimated) per replicate over the tested components."""
    errs = []
    sigs = []
    for replicate in replicates:
        e = np.asarray(replicate["error"], dtype=np.float64)
        s = np.asarray(replicate["destimated"], dtype=np.float64)
        if np.any(np.isnan(e)) or np.any(np.isnan(s)):
            logger.warning("error")
            logger.warning(e)
            logger.warning("destimated")
            logger.warning(s)
            raise ArithmeticError("Encountered isnan in computation")
        if dim == 0:
            errs.append([abs(float(e))])
            sigs.append([float(s)])
        elif dim == 1:
            errs.append(np.abs(e[:K]))
            sigs.append(s[:K])
        else:
            il, jl = np.tril_indices(K, k=-1)  # j < i, as in the reference loops
            errs.append(np.abs(e[il, jl]))
            sigs.append(s[il, jl])
    return np.asarray(errs), np.asarray(sigs)


def generate_confidence_intervals(replicates, K):
    """Observed P(error < alpha sigma) vs normal and Chebyshev predictions.

    Returns (alpha_values, Pobs, Plow, Phigh, dPobs, Pnorm) and logs the
    comparison table plus bias/RMS/stddev summaries (reference
    confidenceintervals.py:226-461).
    """
    msg = """
    The uncertainty estimates are tested in this section.
    If the error is normally distributed, the actual error will be less than a
    multiplier 'alpha' times the computed uncertainty 'sigma' a fraction of
    time given by:
    P(error < alpha sigma) = erf(alpha / sqrt(2))
    For example, the true error should be less than 1.0 * sigma
    (one standard deviation) a total of 68% of the time, and
    less than 2.0 * sigma (two standard deviations) 95% of the time.
    The observed fraction of the time that error < alpha sigma, and its
    uncertainty, is given as 'obs' (with uncertainty 'obs err') below.
    This should be compared to the column labeled 'normal'.
    A weak lower bound that holds regardless of how the error is distributed is given
    by Chebyshev's inequality, and is listed as 'cheby' below.
    Uncertainty estimates are tested for both free energy differences and expectations.
    """
    logger.info(dedent(msg[1:]))

    min_alpha = 0.1
    max_alpha = 4.0
    nalpha = 40
    alpha_values = np.linspace(min_alpha, max_alpha, num=nalpha)

    nreplicates = len(replicates)
    dim = len(np.shape(replicates[0]["estimated"]))

    errs, sigs = _component_arrays(replicates, K, dim)  # (R, C) each

    # Vectorized Beta-Bernoulli counting over the alpha grid with the
    # reference's a=b=1 prior.
    within = errs[None, :, :] <= alpha_values[:, None, None] * sigs[None, :, :]
    a = 1.0 + within.sum(axis=(1, 2))
    b = 1.0 + (~within).sum(axis=(1, 2))

    Pobs = a / (a + b)
    Plow = scipy.stats.beta.ppf(0.025, a, b)
    Phigh = scipy.stats.beta.ppf(0.975, a, b)
    dPobs = np.sqrt(a * b / ((a + b) ** 2 * (a + b + 1)))
    Pnorm = scipy.special.erf(alpha_values / np.sqrt(2.0))

    logger.info("Error vs. alpha")
    logger.info(
        "{:5s} {:10s} {:10s} {:16s} {:17s}".format(
            "alpha", "cheby", "obs", "obs err", "normal"
        )
    )
    for ai, alpha in enumerate(alpha_values):
        logger.info(
            "{:5.1f} {:10.6f} {:10.6f} ({:10.6f},{:10.6f}) {:10.6f}".format(
                alpha, 1.0 - 1.0 / alpha**2, Pobs[ai], Plow[ai], Phigh[ai], Pnorm[ai]
            )
        )

    # Bias / RMS / stddev summaries per component.
    vals = np.asarray([np.asarray(r["estimated"], dtype=np.float64) for r in replicates])
    vals_error = np.asarray([np.asarray(r["error"], dtype=np.float64) for r in replicates])
    vals_std = np.asarray([np.asarray(r["destimated"], dtype=np.float64) for r in replicates])

    aveval = np.average(vals, axis=0)
    standarddev = np.std(vals, axis=0)
    bias = np.average(vals_error, axis=0)
    rms_error = np.sqrt(np.average(vals_error**2, axis=0))
    ave_std = np.sqrt(np.average(vals_std**2, axis=0))

    logger.info("")
    logger.info("     i      average    bias      rms_error     stddev  ave_analyt_std")
    logger.info("---------------------------------------------------------------------")
    if dim == 0:
        pave, pbias, prms, pstdev, pavestd = (
            aveval,
            bias,
            rms_error,
            standarddev,
            ave_std,
        )
    elif dim == 1:
        for i in range(K):
            pave, pbias, prms, pstdev, pavestd = (
                aveval[i],
                bias[i],
                rms_error[i],
                standarddev[i],
                ave_std[i],
            )
            logger.info(
                "{:7d} {:10.4f}  {:10.4f}  {:10.4f}  {:10.4f} {:10.4f}".format(
                    i, pave, pbias, prms, pstdev, pavestd
                )
            )
    else:
        for i in range(K):
            pave, pbias, prms, pstdev, pavestd = (
                aveval[0, i],
                bias[0, i],
                rms_error[0, i],
                standarddev[0, i],
                ave_std[0, i],
            )
            logger.info(
                "{:7d} {:10.4f}  {:10.4f}  {:10.4f}  {:10.4f} {:10.4f}".format(
                    i, pave, pbias, prms, pstdev, pavestd
                )
            )

    logger.info(
        "Totals: {:10.4f}  {:10.4f}  {:10.4f}  {:10.4f} {:10.4f}".format(
            pave, pbias, prms, pstdev, pavestd
        )
    )

    return alpha_values, Pobs, Plow, Phigh, dPobs, Pnorm
