"""The numbers that decide ``correct``, each held to its limit.

Every job answers with Delta_f and dDelta_f (``compute_free_energy_
differences``); a bootstrap job also drew its replicates' resample indices.
The numbers, each the worst over the jobs compared:

* ``failed_jobs``: jobs that raised (limit 0);
* ``df_err``: max |Delta_f - Delta_f_ref| over every pair of states;
* ``ddf_rel``: max over i != j of |dDelta_f - dDelta_f_ref| / dDelta_f_ref,
  the reference's uncertainty by the job's own method ('svd-ew' Theta, or the
  bootstrap's spread over the job's replicates), over the pairs where both
  are finite;
* ``ddf_nonfinite``: entries of dDelta_f that are NaN or infinite (limit 0);
* ``draws_bad`` (bootstrap jobs): replicates whose indices are not a
  stratified resample of the samples (an index outside its state's block),
  that repeat another replicate, or whose share of distinct samples lies
  over ten standard deviations (sqrt(0.1 / N) each) from the expected
  sum_k n_k (1 - (1 - 1/n_k)**n_k) / N (limit 0).

A NaN in Delta_f, or a wrong shape, reads inf.
"""

import hashlib
import math

import numpy as np

__all__ = ["job_numbers", "stratified_counts", "expected_unique_share", "merge", "judge"]


def _max_abs(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    if a.shape != b.shape:
        return math.inf
    d = np.abs(a - b)
    return math.inf if np.isnan(d).any() else float(d.max(initial=0.0))


def _uncertainty_numbers(a, b):
    """(ddf_rel, ddf_nonfinite) of an answer ``a`` against the reference
    ``b``: the largest relative gap over the pairs i != j where both are
    finite and the reference is above 0, and the count of entries where the
    answer is not finite (a wrong shape reads inf for both)."""
    if a is None:
        return math.inf, math.inf
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    if a.shape != b.shape or b.ndim != 2:
        return math.inf, math.inf
    judged = ~np.eye(b.shape[0], dtype=bool) & np.isfinite(a) & np.isfinite(b) & (b > 0)
    rel = np.abs(a[judged] - b[judged]) / b[judged]
    return float(rel.max(initial=0.0)), int(np.count_nonzero(~np.isfinite(a)))


def expected_unique_share(N_k):
    """Expected share of distinct samples in a stratified resample."""
    n = np.asarray(N_k, dtype=np.float64)
    n = n[n > 0]
    return float(np.sum(n * (1.0 - (1.0 - 1.0 / n) ** n)) / n.sum())


def stratified_counts(rints, N_k):
    """(counts, n_bad): each replicate's (N,) multiplicities and how many
    replicates are no sound stratified resample (see ``draws_bad``)."""
    rints = np.asarray(rints)
    B, N = rints.shape
    N_k = np.asarray(N_k, dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(N_k)])
    state = np.repeat(np.arange(N_k.size), N_k)
    lo, hi = starts[state], starts[state + 1]
    share = expected_unique_share(N_k)
    # the count of samples a resample leaves out has variance ~(1/e - 2/e**2) N
    tolerance = 10.0 * math.sqrt(0.1 / N)
    counts = np.zeros((B, N), dtype=np.int64)
    bad = np.zeros(B, dtype=bool)
    for b in range(B):
        row = rints[b]
        bad[b] = bool(((row < lo) | (row >= hi)).any())
        if not bad[b]:
            counts[b] = np.bincount(row, minlength=N)
            bad[b] = abs(np.count_nonzero(counts[b]) / N - share) > tolerance
    seen = set()
    for b in range(B):
        digest = hashlib.blake2b(counts[b].tobytes()).digest()
        bad[b] |= digest in seen
        seen.add(digest)
    return counts, int(np.count_nonzero(bad))


def job_numbers(out, delta_f_ref, ddelta_f_ref):
    """The numbers of one job's answer ``out`` (a dict with "Delta_f",
    "dDelta_f") against the reference's."""
    ddf_rel, ddf_nonfinite = _uncertainty_numbers(out["dDelta_f"], ddelta_f_ref)
    return {
        "df_err": _max_abs(out["Delta_f"], delta_f_ref),
        "ddf_rel": ddf_rel,
        "ddf_nonfinite": ddf_nonfinite,
    }


def merge(numbers, more):
    """The worse of two readings of each number."""
    for k, v in more.items():
        numbers[k] = max(numbers.get(k, -math.inf), v)
    return numbers


def judge(numbers, limits):
    """(correct, [(name, value, limit)]): every number at or under its limit;
    a number without a limit, or a limit without its number, fails.
    ``limits`` maps each name to {"limit": ...} (other keys are notes)."""
    limits = {k: v for k, v in limits.items() if isinstance(v, dict)}
    rows, ok = [], True
    for name in sorted(set(numbers) | set(limits)):
        value = numbers.get(name, math.inf)
        limit = limits.get(name, {}).get("limit", -math.inf)
        ok &= bool(value <= limit)
        rows.append((name, value, limit))
    return ok, rows
