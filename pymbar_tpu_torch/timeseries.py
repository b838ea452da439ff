"""Timeseries decorrelation tools: statistical inefficiency, autocorrelation,
equilibration detection, subsampling (PyTorch port).

A numpy carry-over of :mod:`pymbar_tpu.timeseries` (at parity with pymbar
4.x timeseries.py:83-970).  Every estimator computes the full correlation
function in one O(N log N) FFT pass and then applies the reference's
termination and accumulation rule (first non-positive C past ``mintime``,
triangle-weighted sum, ``fast``-mode stride growth), so results match the
reference's per-lag loop to floating-point roundoff; ``method="direct"``
keeps that loop for bit-level parity.  ``statistical_inefficiency_fft``
needs no statsmodels (reference timeseries.py:839-898).
"""

import logging
import math

import numpy as np

from pymbar_tpu_torch.utils import ParameterError

logger = logging.getLogger(__name__)

LongWarning = (
    "Warning on use of the timeseries module: If the inherent timescales of "
    "the system are long compared to those being analyzed, this statistical "
    "inefficiency may be an underestimate.  The estimate presumes the use of "
    "many statistically independent samples.  Tests should be performed to "
    "assess whether this condition is satisfied.   Be cautious in the "
    "interpretation of the data."
)
logger.warning(LongWarning)

__all__ = [
    "statistical_inefficiency",
    "statistical_inefficiency_multiple",
    "integrated_autocorrelation_time",
    "integrated_autocorrelation_timeMultiple",
    "normalized_fluctuation_correlation_function",
    "normalized_fluctuation_correlation_function_multiple",
    "subsample_correlated_data",
    "detect_equilibration",
    "statistical_inefficiency_fft",
    "detect_equilibration_binary_search",
]


def _fft_cross_corr(dA_n, dB_n):
    """corr[t] = sum_n dA[n] dB[n+t] for t = 0..N-1, via zero-padded FFT.

    Lag 0 is recomputed directly so identities that the reference's direct
    accumulation satisfies exactly (e.g. C(0) == 1 after normalization)
    survive FFT roundoff.
    """
    N = dA_n.size
    nfft = 1 << (2 * N - 1).bit_length()
    fA = np.fft.rfft(dA_n, nfft)
    fB = np.fft.rfft(dB_n, nfft)
    out = np.fft.irfft(np.conj(fA) * fB, nfft)[:N]
    out[0] = np.dot(dA_n, dB_n)
    return out


def _symmetric_corr(dA_n, dB_n):
    """C_raw[t] = sum(dA[0:N-t] dB[t:N] + dB[0:N-t] dA[t:N]) for all lags t."""
    c_ab = _fft_cross_corr(dA_n, dB_n)
    if dB_n is dA_n:
        return 2.0 * c_ab
    return c_ab + _fft_cross_corr(dB_n, dA_n)


def statistical_inefficiency(A_n, B_n=None, fast=False, mintime=3, fft=False, method="auto"):
    """g = 1 + 2 tau from the normalized fluctuation (cross-)correlation.

    Accumulation terminates at the first non-positive C(t) past ``mintime``;
    ``fast`` grows the lag stride by 1 each step; g >= 1 is enforced
    (reference timeseries.py:83-203).

    ``method`` selects how the correlation values are produced:

    * ``"fft"`` — all lags precomputed with one FFT correlation
      (O(N log N)); matches the direct accumulation to ~1e-10 relative.
    * ``"direct"`` — the reference's literal per-lag accumulation
      (bitwise-identical operation order; early exit costs only the lags
      actually visited).
    * ``"auto"`` (default) — ``"direct"`` when ``fast`` (which visits only
      ~sqrt(N) lags, cheaper than a full FFT), else ``"fft"``.
    """
    A_n = np.array(A_n)
    # legacy fft=True routing (reference semantics), but never override an
    # EXPLICIT method='direct' request for the bitwise-parity accumulation
    if fft and B_n is None and method != "direct":
        return statistical_inefficiency_fft(A_n, mintime=mintime)

    B_n = np.array(B_n) if B_n is not None else A_n

    N = A_n.size
    if A_n.shape != B_n.shape:
        raise ParameterError("A_n and B_n must have same dimensions.")

    dA_n = A_n.astype(np.float64) - A_n.mean()
    dB_n = B_n.astype(np.float64) - B_n.mean()

    if method == "auto":
        method = "direct" if fast else "fft"

    if method == "direct":
        # Reference-parity path: the same operations in the same order as
        # pymbar 4.x timeseries.py:155-203, so results are
        # bit-identical, with the early exit saving the unvisited lags.
        sigma2_AB = (dA_n * dB_n).mean()
        if sigma2_AB == 0:
            raise ParameterError(
                "Sample covariance sigma_AB^2 = 0 -- cannot compute statistical inefficiency"
            )
        g = 1.0
        t = 1
        increment = 1
        while t < N - 1:
            C = np.sum(dA_n[0 : (N - t)] * dB_n[t:N] + dB_n[0 : (N - t)] * dA_n[t:N]) / (
                2.0 * float(N - t) * sigma2_AB
            )
            if (C <= 0.0) and (t > mintime):
                break
            g += 2.0 * C * (1.0 - float(t) / float(N)) * float(increment)
            t += increment
            if fast:
                increment += 1
        return max(g, 1.0)

    if method != "fft":
        raise ParameterError(f"method must be 'auto', 'fft' or 'direct', got {method!r}")

    sigma2_AB = np.dot(dA_n, dB_n) / len(dA_n)
    if sigma2_AB == 0:
        raise ParameterError(
            "Sample covariance sigma_AB^2 = 0 -- cannot compute statistical inefficiency"
        )

    same = B_n is A_n or np.array_equal(A_n, B_n)
    C_raw = _symmetric_corr(dA_n, dB_n if not same else dA_n)

    g = 1.0
    t = 1
    increment = 1
    while t < N - 1:
        C = C_raw[t] / (2.0 * float(N - t) * sigma2_AB)
        if (C <= 0.0) and (t > mintime):
            break
        g += 2.0 * C * (1.0 - float(t) / float(N)) * float(increment)
        t += increment
        if fast:
            increment += 1

    return max(g, 1.0)


def statistical_inefficiency_multiple(A_kn, fast=False, return_correlation_function=False):
    """Pooled g over K stationary timeseries of potentially differing lengths.

    The unnormalized correlation at each lag averages over all trajectories
    long enough to contribute; termination is at the first non-positive C
    with t > 10 (reference timeseries.py:209-365).
    """
    if isinstance(A_kn, np.ndarray):
        if A_kn.ndim == 1:
            A_kn = [A_kn.copy()]
        else:
            A_kn = [A_kn[k, :].copy() for k in range(A_kn.shape[0])]

    K = len(A_kn)
    N_k = np.array([A_kn[k].size for k in range(K)], np.int64)
    Navg = N_k.astype(np.float64).mean()
    N = int(np.sum(N_k))

    mu = sum(np.sum(A_kn[k]) for k in range(K)) / float(N)
    dA_kn = [np.asarray(A_kn[k], dtype=np.float64) - mu for k in range(K)]
    sigma2 = sum(np.dot(dA_kn[k], dA_kn[k]) for k in range(K)) / float(N)

    # All per-trajectory autocorrelations in one FFT pass each; lag-t cross
    # terms then reduce to sums over trajectories with N_k > t.
    N_max = int(N_k.max())
    numer_t = np.zeros(N_max, np.float64)
    denom_t = np.zeros(N_max, np.float64)
    for k in range(K):
        c = _fft_cross_corr(dA_kn[k], dA_kn[k])
        numer_t[: N_k[k]] += c
        denom_t[: N_k[k]] += N_k[k] - np.arange(N_k[k], dtype=np.float64)

    g = 1.0
    Ct = []
    t = 1
    increment = 1
    while t < N_max - 1:
        C = (numer_t[t] / denom_t[t]) / sigma2
        Ct.append((t, C))
        if (C <= 0.0) and (t > 10):
            break
        g += 2.0 * C * (1.0 - float(t) / Navg) * float(increment)
        t += increment
        if fast:
            increment += 1

    g = max(g, 1.0)
    if return_correlation_function:
        return g, Ct
    return g


def integrated_autocorrelation_time(A_n, B_n=None, fast=False, mintime=3):
    """tau = (g - 1)/2 (reference timeseries.py:371-383)."""
    g = statistical_inefficiency(A_n, B_n, fast, mintime)
    return (g - 1.0) / 2.0


def integrated_autocorrelation_timeMultiple(A_kn, fast=False):
    """tau = (g - 1)/2 over multiple series (reference timeseries.py:387-399)."""
    g = statistical_inefficiency_multiple(A_kn, fast, False)
    return (g - 1.0) / 2.0


def normalized_fluctuation_correlation_function(A_n, B_n=None, N_max=None, norm=True):
    """C(t) = (<A(t)B(0)> - <A><B>) / (<AB> - <A><B>) for t <= N_max.

    Reference timeseries.py:405-503; computed via FFT instead of a per-lag loop.
    """
    if B_n is None:
        B_n = A_n

    A_n = np.array(A_n)
    B_n = np.array(B_n)
    N = A_n.size

    if (not N_max) or (N_max > N - 1):
        N_max = N - 1
    if A_n.shape != B_n.shape:
        raise ParameterError("A_n and B_n must have same dimensions.")

    mu_A = A_n.mean()
    mu_B = B_n.mean()
    dA_n = A_n.astype(np.float64) - mu_A
    dB_n = B_n.astype(np.float64) - mu_B

    sigma2_AB = np.dot(dA_n, dB_n) / len(dA_n)
    if sigma2_AB == 0:
        raise ParameterError(
            "Sample covariance sigma_AB^2 = 0 -- cannot compute statistical inefficiency"
        )

    C_raw = _symmetric_corr(dA_n, dB_n)
    t = np.arange(N_max + 1, dtype=np.float64)
    C_n = C_raw[: N_max + 1] / (2.0 * (N - t) * sigma2_AB)

    if norm:
        return C_n
    return C_n * sigma2_AB + mu_A * mu_B


def normalized_fluctuation_correlation_function_multiple(
    A_kn, B_kn=None, N_max=None, norm=True, truncate=False
):
    """Pooled C(t) over multiple (pairs of) timeseries (reference :509-658)."""
    if B_kn is None:
        B_kn = A_kn

    if (type(A_kn) is not list) or (type(B_kn) is not list):
        raise ParameterError("A_kn and B_kn must each be a list of numpy arrays.")
    if len(A_kn) != len(B_kn):
        raise ParameterError(
            "A_kn and B_kn must contain corresponding timeseries -- different "
            "numbers of timeseries detected in each."
        )

    K = len(A_kn)
    for k in range(K):
        if A_kn[k].size != B_kn[k].size:
            raise ParameterError(
                "A_kn and B_kn must contain corresponding timeseries -- lack "
                "of correspondence in timeseries lenghts detected."
            )

    N_k = np.array([A_kn[k].size for k in range(K)], np.int64)
    N = int(np.sum(N_k))

    if (not N_max) or (N_max > max(N_k) - 1):
        N_max = int(max(N_k) - 1)

    mu_A = sum(np.sum(A_kn[k]) for k in range(K)) / float(N)
    mu_B = sum(np.sum(B_kn[k]) for k in range(K)) / float(N)

    dA_kn = [np.asarray(A_kn[k], np.float64) - mu_A for k in range(K)]
    dB_kn = [np.asarray(B_kn[k], np.float64) - mu_B for k in range(K)]

    # np.dot matches the lag-0 FFT replacement bit-for-bit (same kernel),
    # keeping C(0) == 1 exact.
    sigma2_AB = sum(np.dot(dA_kn[k], dB_kn[k]) for k in range(K)) / float(N)

    numer_t = np.zeros(N_max + 1, np.float64)
    denom_t = np.zeros(N_max + 1, np.float64)
    for k in range(K):
        c = _fft_cross_corr(dA_kn[k], dB_kn[k])
        hi = min(int(N_k[k]), N_max + 1)
        numer_t[:hi] += c[:hi]
        denom_t[:hi] += N_k[k] - np.arange(hi, dtype=np.float64)

    C_n = (numer_t / denom_t) / sigma2_AB

    t = N_max
    if truncate:
        # Reference semantics: stop at the first lag whose (cumulative)
        # numerator goes negative; here the first negative C suffices since
        # the numerator is fully accumulated per lag.
        neg = np.where(C_n < 0)[0]
        if neg.size:
            t = int(neg[0])

    if norm:
        return C_n[:t]
    return C_n[:t] * sigma2_AB + mu_A * mu_B


def subsample_correlated_data(A_t, g=None, fast=False, conservative=False, verbose=False):
    """Indices of an effectively uncorrelated subsample at stride ~g.

    conservative=True uses uniform stride ceil(g); otherwise indices are
    round(n*g) without duplicates (reference timeseries.py:664-768).
    """
    A_t = np.array(A_t)
    T = A_t.size

    if not g:
        if verbose:
            logger.info("Computing statistical inefficiency...")
        g = statistical_inefficiency(A_t, A_t, fast=fast)
        if verbose:
            logger.info(f"g = {g:f}")

    if conservative:
        stride = int(math.ceil(g))
        if verbose:
            logger.info(f"conservative subsampling: using stride of {stride:d}")
        indices = range(0, T, stride)
    else:
        indices = []
        n = 0
        while int(round(n * g)) < T:
            t = int(round(n * g))
            if (n == 0) or (t != indices[-1]):
                indices.append(t)
            n += 1
        if verbose:
            logger.info(f"standard subsampling: using average stride of {g:f}")

    N = len(indices)
    if verbose:
        logger.info(
            f"The resulting subsampled set has {N:d} samples (original "
            f"timeseries had {T:d})."
        )
    return indices


def detect_equilibration(A_t, fast=True, nskip=1):
    """Pick the origin t maximizing Neff(t) = (T - t + 1)/g(t).

    Returns (t, g, Neff_max).  A constant series returns Neff = 1, and
    per-origin ParameterErrors from constant tails fall back to
    g = T - t + 1, as in the reference (timeseries.py:771-836).
    """
    A_t = np.asarray(A_t)
    T = A_t.size

    if A_t.std() == 0.0:
        return 0, 1, 1  # Neff=1 for constant series (the reference's rule)

    g_t = np.ones([T - 1], np.float32)
    Neff_t = np.ones([T - 1], np.float32)
    for t in range(0, T - 1, nskip):
        try:
            g_t[t] = statistical_inefficiency(A_t[t:T], fast=fast)
        except ParameterError:  # constant trailing sequence (the reference's rule)
            g_t[t] = T - t + 1
        Neff_t[t] = (T - t + 1) / g_t[t]
    Neff_max = Neff_t.max()
    t = Neff_t.argmax()
    g = g_t[t]

    return t, g, Neff_max


def statistical_inefficiency_fft(A_n, mintime=3):
    """g from the adjusted FFT autocorrelation function.

    Native jnp/numpy FFT implementation of the reference's statsmodels
    ``acf(fft=True, adjusted=True)`` path (timeseries.py:839-898): C(t) is
    the lag-adjusted normalized autocovariance; g = 1 + sum 2 C(t)(1 - t/N)
    up to the first non-positive C past ``mintime``.
    """
    A_n = np.array(A_n)
    N = A_n.size

    dA_n = A_n.astype(np.float64) - A_n.mean()
    var = np.sum(dA_n**2) / N
    if var == 0:
        raise ParameterError(
            "Sample variance is zero -- cannot compute statistical inefficiency"
        )

    raw = _fft_cross_corr(dA_n, dA_n)  # sum_n dA[n] dA[n+t]
    t_grid = np.arange(N).astype("float")
    C_t = (raw / (N - t_grid)) / var  # adjusted (unbiased-denominator) acf

    g_t = 2.0 * C_t * (1.0 - t_grid / float(N))

    nonpos = np.where((C_t <= 0) & (t_grid > mintime))[0]
    ind = int(nonpos[0]) if nonpos.size else N

    g = 1.0 + g_t[1:ind].sum()
    return max(1.0, g)


def detect_equilibration_binary_search(A_t, bs_nodes=10):
    """Equilibration detection by log-spaced grid refinement over origins.

    Reference timeseries.py:901-970; requires bs_nodes > 4.
    """
    assert bs_nodes > 4, "Number of nodes for binary search must be > 4"
    A_t = np.asarray(A_t)
    T = A_t.size

    if A_t.std() == 0.0:
        return 0, 1, T

    start = 1
    end = T - 1
    n_grid = min(bs_nodes, T)

    while True:
        time_grid = np.unique(
            (10 ** np.linspace(np.log10(start), np.log10(end), n_grid))
            .round()
            .astype("int")
        )
        g_t = np.ones(time_grid.size)
        Neff_t = np.ones(time_grid.size)

        for k, t in enumerate(time_grid):
            if t < T - 1:
                g_t[k] = statistical_inefficiency_fft(A_t[t:])
                Neff_t[k] = (T - t + 1) / g_t[k]

        Neff_max = Neff_t.max()
        k = Neff_t.argmax()
        t = time_grid[k]
        g = g_t[k]

        if end - start < 4:
            break

        if k == 0:
            start = time_grid[0]
            end = time_grid[1]
        elif k == time_grid.size - 1:
            start = time_grid[-2]
            end = time_grid[-1]
        else:
            start = time_grid[k - 1]
            end = time_grid[k + 1]

    return t, g, Neff_max
