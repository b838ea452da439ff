"""Core MBAR numerics as plain PyTorch functions of (u_kn, N_k, f_k).

The counterpart of :mod:`pymbar_tpu.ops.mbar_core` (reference pymbar 4.x
mbar_solvers.py:174-507, :697-735): the same two fused reductions over the
K x N reduced-potential matrix,

* ``log_denominator_n = logsumexp_k(f_k + log N_k - u_kn)``  (per sample)
* ``log_numerator_k   = logsumexp_n(-log_denominator_n - u_kn)`` (per state)

from which the self-consistent update, the gradient and the objective
follow, plus the Hessian and covariance aggregates in Gram form
(W W^T, K x K), so no N x K weight matrix is formed.

Every function takes ``u_kn`` as a tensor (the K-vectors N_k and f_k may
also be numpy) and computes on the device ``u_kn`` lives on; only the
K-vectors move there.  Eager PyTorch makes a full-size temporary
for each elementwise op, so every K x N pass walks the sample axis in
column chunks of at most ``_CHUNK_BYTES`` and updates its chunk
temporaries in place.
"""

import numpy as np
import torch

from pymbar_tpu_torch.utils import ensure_type

__all__ = [
    "validate_inputs",
    "log_denominator_n",
    "core_stats",
    "self_consistent_update",
    "mbar_gradient",
    "mbar_objective",
    "mbar_objective_and_gradient",
    "mbar_hessian",
    "mbar_W_nk",
    "mbar_log_W_nk",
    "mbar_w_nk_gram",
    "mbar_gram_normalization",
    "gram_f32_acc64",
    "precondition_u_kn",
]

# Column-chunk size of every K x N pass.  On the 80 GB H100 the flagship
# holds u_kn (8 GB) + its dd planes (8 GB) + a preconditioned copy (8 GB),
# and a chunk op keeps <= ~6 chunk-sized temporaries live: 512 MB chunks cap
# those at ~3 GB while each op still streams ~0.15 ms at 3.35 TB/s, far
# above the ~5 us launch cost.
_CHUNK_BYTES = 512 * 2**20

# u at or above this is the sentinel of a pad column (the kernels' +1e10).
_PAD_THRESHOLD = 5.0e9


def _col_chunks(u):
    """(start, stop) column ranges of at most ``_CHUNK_BYTES`` each."""
    K, N = u.shape
    width = max(1, _CHUNK_BYTES // max(1, K * u.element_size()))
    return [(s, min(N, s + width)) for s in range(0, N, width)]


def _like(x, u):
    """``x`` as a tensor of u's dtype on u's device (K-vectors only)."""
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           dtype=u.dtype, device=u.device)


def _matmul(a, b):
    """a @ b, refusing TF32: a float32 Gram here stands for the JAX
    package's ``Precision.HIGHEST`` (full f32 products)."""
    if a.dtype == torch.float32 and a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "float32 Gram products need torch.backends.cuda.matmul.allow_tf32 "
            "= False (TF32 keeps ~3 decimal digits)"
        )
    return a @ b


def validate_inputs(u_kn, N_k, f_k):
    """Shape/dtype validation (reference mbar_solvers.py:174-203).

    Returns (u_kn, N_k, f_k): u_kn as a floating tensor, kept on its device
    and never copied (a numpy matrix becomes a CPU tensor sharing its
    memory); N_k and f_k as float64 numpy arrays.
    """
    n_states, n_samples = u_kn.shape
    if torch.is_tensor(u_kn):
        if u_kn.ndim != 2:
            raise ValueError(f"u_kn or Q_kn must be ndim 2. You supplied {u_kn.ndim}")
        if not u_kn.is_floating_point():
            u_kn = u_kn.to(torch.float64)
    else:
        u_kn = torch.from_numpy(
            ensure_type(u_kn, "float", 2, "u_kn or Q_kn", shape=(n_states, n_samples))
        )
    N_k = ensure_type(N_k, "float", 1, "N_k", shape=(n_states,), warn_on_cast=False)
    f_k = ensure_type(f_k, "float", 1, "f_k", shape=(n_states,))
    return u_kn, N_k, f_k


# -----------------------------------------------------------------------------
# Fused reductions
# -----------------------------------------------------------------------------


def _logden_direct(u, N_k, f_k):
    a = f_k[:, None] - u  # the chunk's one temporary; updated in place below
    a_max = a.max(dim=0).values
    a_max = torch.where(torch.isfinite(a_max), a_max, 0.0)
    a.sub_(a_max[None, :]).exp_().mul_(N_k[:, None])
    return torch.log(a.sum(dim=0)) + a_max


def log_denominator_n(u_kn, N_k, f_k):
    """Per-sample mixture log-normalizer: logsumexp_k[f_k - u_kn] weighted by N_k.

    Shapes: u_kn (K, N); N_k, f_k (K,).  Returns (N,).  Empty states
    (N_k == 0) drop out exactly.
    """
    N_k, f_k = _like(N_k, u_kn), _like(f_k, u_kn)
    out = torch.empty(u_kn.shape[1], dtype=u_kn.dtype, device=u_kn.device)
    for s, e in _col_chunks(u_kn):
        out[s:e] = _logden_direct(u_kn[:, s:e], N_k, f_k)
    return out


def _log_numerator_k(u_kn, logden_n):
    """Per-state reweighted log-sum logsumexp_n[-logden_n - u_kn], streamed
    over column chunks with a running max (flash-style rescaling)."""
    K = u_kn.shape[0]
    m = torch.full((K,), -torch.inf, dtype=u_kn.dtype, device=u_kn.device)
    s = torch.zeros(K, dtype=u_kn.dtype, device=u_kn.device)
    for c0, c1 in _col_chunks(u_kn):
        a = -logden_n[None, c0:c1] - u_kn[:, c0:c1]
        m_new = torch.maximum(m, a.max(dim=1).values)
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        s = s * torch.exp(m - m_safe) + a.sub_(m_safe[:, None]).exp_().sum(dim=1)
        m = m_new
    m = torch.where(torch.isfinite(m), m, 0.0)
    return torch.log(s) + m


def core_stats(u_kn, N_k, f_k):
    """One fused pass pair producing (objective, gradient, f_sci).

    obj   = sum_n logden_n - N_k . f_k
    grad  = -N_k (1 - exp(f_k + lognum_k))          [Eq. C6]
    f_sci = -lognum_k                                [Eq. C3]
    """
    N_k, f_k = _like(N_k, u_kn), _like(f_k, u_kn)
    logden = log_denominator_n(u_kn, N_k, f_k)
    lognum = _log_numerator_k(u_kn, logden)
    obj = logden.sum() - torch.dot(N_k, f_k)
    grad = -N_k * (1.0 - torch.exp(f_k + lognum))
    return obj, grad, -lognum


def self_consistent_update(u_kn, N_k, f_k, states_with_samples=None):
    """Improved f_k guess via Eq. C3 (reference mbar_solvers.py:206-257).

    Only states in ``states_with_samples`` feed the denominator when given.
    """
    N_k, f_k = _like(N_k, u_kn), _like(f_k, u_kn)
    if states_with_samples is not None:
        sel = torch.as_tensor(np.asarray(states_with_samples), device=u_kn.device)
        u_kn = u_kn.index_select(0, sel)
        N_k = N_k[sel]
        f_k = f_k[sel]
    return -_log_numerator_k(u_kn, log_denominator_n(u_kn, N_k, f_k))


def mbar_gradient(u_kn, N_k, f_k):
    """Gradient of the MBAR objective, Eq. C6 (reference mbar_solvers.py:260-292)."""
    return core_stats(u_kn, N_k, f_k)[1]


def mbar_objective(u_kn, N_k, f_k):
    """MBAR objective (reference mbar_solvers.py:295-339)."""
    N_k, f_k = _like(N_k, u_kn), _like(f_k, u_kn)
    return log_denominator_n(u_kn, N_k, f_k).sum() - torch.dot(N_k, f_k)


def mbar_objective_and_gradient(u_kn, N_k, f_k):
    """Fused objective + gradient (reference mbar_solvers.py:341-392)."""
    obj, grad, _ = core_stats(u_kn, N_k, f_k)
    return obj, grad


# -----------------------------------------------------------------------------
# Gram-form aggregates
# -----------------------------------------------------------------------------


def _weights(u_c, f_k, logden_c):
    """The chunk's weights W^T = exp(f_k - u_kn - logden_n), (K, nc)."""
    return (f_k[:, None] - u_c).sub_(logden_c[None, :]).exp_()


def mbar_w_nk_gram(u_kn, N_k, f_k):
    """(W^T W, colsum W) in u's dtype, streamed over column chunks.

    W[n, k] = exp(f_k - u_kn[k, n] - logden_n).  These are the only
    aggregates the Hessian (Eq. C9) needs.
    """
    K = u_kn.shape[0]
    f_k = _like(f_k, u_kn)
    logden = log_denominator_n(u_kn, N_k, f_k)
    gram = torch.zeros((K, K), dtype=u_kn.dtype, device=u_kn.device)
    colsum = torch.zeros(K, dtype=u_kn.dtype, device=u_kn.device)
    for s, e in _col_chunks(u_kn):
        w = _weights(u_kn[:, s:e], f_k, logden[s:e])
        gram += _matmul(w, w.T)
        colsum += w.sum(dim=1)
    return gram, colsum


def mbar_hessian(u_kn, N_k, f_k):
    """Hessian of the MBAR objective, Eq. C9 (reference mbar_solvers.py:395-436)."""
    N_k = _like(N_k, u_kn)
    gram, colsum = mbar_w_nk_gram(u_kn, N_k, f_k)
    H = gram * N_k[None, :] * N_k[:, None]
    H -= torch.diag(colsum * N_k)
    return -H


def mbar_W_nk(u_kn, N_k, f_k):
    """Normalized weights, Eq. 9, materialized in (N, K) layout (reference
    mbar_solvers.py:479-507).  Only for small validation paths."""
    f_k = _like(f_k, u_kn)
    return _weights(u_kn, f_k, log_denominator_n(u_kn, N_k, f_k)).T


def mbar_log_W_nk(u_kn, N_k, f_k):
    """Normalized log-weights f_k - u_kn - logden_n, Eq. 9, as a contiguous
    (N, K) tensor on u's device (reference mbar_solvers.py:439-476).  Each
    column chunk's (K, nc) block is written transposed into the output, so
    the only full-size allocation is the result itself."""
    K, N = u_kn.shape
    f_k = _like(f_k, u_kn)
    logden = log_denominator_n(u_kn, N_k, f_k)
    out = torch.empty((N, K), dtype=u_kn.dtype, device=u_kn.device)
    for s, e in _col_chunks(u_kn):
        out[s:e] = (f_k[:, None] - u_kn[:, s:e]).sub_(logden[None, s:e]).T
    return out


def gram_f32_acc64(u_kn32, N_k32, f_k32, c32=None):
    """Gram with float32 products per column chunk and float64 accumulation.

    The products run with TF32 off (the JAX package's ``Precision.HIGHEST``).
    ``c32`` supplies optional (N,) per-sample counts: the result becomes
    W diag(c) W^T and sum_n c_n W_nk.  Sentinel pad columns get zero
    weight.  Returns (gram, colsum) in float64.
    """
    K = u_kn32.shape[0]
    dev = u_kn32.device
    f_k32 = _like(f_k32, u_kn32)
    logden = log_denominator_n(u_kn32, N_k32, f_k32)
    gram = torch.zeros((K, K), dtype=torch.float64, device=dev)
    colsum = torch.zeros(K, dtype=torch.float64, device=dev)
    for s, e in _col_chunks(u_kn32):
        u_c = u_kn32[:, s:e]
        w = _weights(u_c, f_k32, logden[s:e])
        # W columns normalize to 1 regardless of u, so sentinel pad
        # columns would be phantom weight-1 samples: zero them.
        w.masked_fill_(u_c >= _PAD_THRESHOLD, 0.0)
        wc = w if c32 is None else w * c32[None, s:e]
        gram += _matmul(wc, w.T).to(torch.float64)
        colsum += wc.sum(dim=1).to(torch.float64)
    return gram, colsum


def mbar_gram_normalization(u_kn, N_k, f_k, tolerance=1.0e-4, sampled=None,
                            extra_rows=None, observable=None):
    """(W^T W, colsum W, row-check stats) in one streamed f64 pass.

    The aggregates the covariance estimators (Eq. D4/D5, Kong 2003) and the
    reference's ``check_w_normalized`` need: Gram and per-state column sums,
    plus (bad row count, first bad row index, its row sum) for the
    sum_k N_k W_nk = 1 check, without an N-sized host array.  Computes in
    u's dtype (float64 on the card: the JAX package's float32 here was a
    TPU-only choice).

    The augmented-state expectations (``MBAR._expectations_streamed``'s pass
    B) ride the same chunk loop:

    * ``sampled``: indices of the states with samples; each chunk's
      log-denominator then runs over those rows only, so an empty state
      cannot set a column's max.
    * ``extra_rows(s, e, u_c, logden_c)``: (m, e - s) weight rows appended
      below the chunk's W; the Gram and the column sums then cover K + m
      rows, and the row check stays on the first K.
    * ``observable(s, e, u_c)``: the chunk's observable A, either an
      (e - s,) row shared by every state or a (K, e - s) slab (row k with
      state k).  The pass then also returns ``(M1, M2, cA)`` with
      M1 = W (A o W)^T, M2 = (A o W)(A o W)^T and cA = sum_n (A o W).
    """
    N_k, f_k = _like(N_k, u_kn), _like(f_k, u_kn)
    K, N = u_kn.shape
    dev = u_kn.device
    N_s, f_s = N_k, f_k
    if sampled is not None:
        sampled = torch.as_tensor(sampled, device=dev)
        N_s, f_s = N_k[sampled], f_k[sampled]
    gram = colsum = None
    big = torch.tensor(N + 1, dtype=torch.int64, device=dev)
    cnt = torch.zeros((), dtype=torch.int64, device=dev)
    fidx = big.clone()
    fval = torch.zeros((), dtype=torch.float64, device=dev)
    if observable is not None:
        m1 = torch.zeros((K, K), dtype=u_kn.dtype, device=dev)
        m2 = torch.zeros_like(m1)
        c_a = torch.zeros(K, dtype=u_kn.dtype, device=dev)
    for s, e in _col_chunks(u_kn):
        u_c = u_kn[:, s:e]
        logden = _logden_direct(u_c if sampled is None else u_c.index_select(0, sampled), N_s, f_s)
        w = _weights(u_c, f_k, logden)
        w.masked_fill_(u_c >= _PAD_THRESHOLD, 0.0)  # pad columns: phantom samples
        rowsum = (N_k @ w).to(torch.float64)
        if observable is not None:
            a = observable(s, e, u_c)
            wa = w * (a[None, :] if a.ndim == 1 else a)
            m1 += _matmul(w, wa.T)
            m2 += _matmul(wa, wa.T)
            c_a += wa.sum(dim=1)
        if extra_rows is not None:
            w = torch.cat([w, extra_rows(s, e, u_c, logden)])
        if gram is None:
            gram = torch.zeros((w.shape[0],) * 2, dtype=u_kn.dtype, device=dev)
            colsum = torch.zeros(w.shape[0], dtype=u_kn.dtype, device=dev)
        gram += _matmul(w, w.T)
        colsum += w.sum(dim=1)
        bad = torch.abs(rowsum - 1.0) > tolerance
        cnt += bad.sum()
        local_first = torch.argmax(bad.to(torch.int32))
        gidx = torch.where(bad.any(), s + local_first, big)
        take = gidx < fidx
        fidx = torch.where(take, gidx, fidx)
        fval = torch.where(take, rowsum[local_first], fval)
    out = (gram, colsum, (int(cnt), int(fidx), float(fval)))
    return out if observable is None else (*out, (m1, m2, c_a))


def precondition_u_kn(u_kn, N_k, f_k):
    """Shift u_kn per sample so the objective is ~0 (reference :697-735).

    u_kn <- u_kn - min_k u_kn, then add logden_n - (N_k.f_k)/N so the current
    objective value is exactly zero; derivatives are invariant.  Returns a
    new tensor (the caller's matrix is left as it is), built chunk by chunk.
    """
    N_k, f_k = _like(N_k, u_kn), _like(f_k, u_kn)
    c_shift = torch.dot(N_k, f_k) / N_k.sum()
    out = torch.empty_like(u_kn)
    for s, e in _col_chunks(u_kn):
        sl = u_kn[:, s:e] - u_kn[:, s:e].min(dim=0).values[None, :]
        out[:, s:e] = sl.add_((_logden_direct(sl, N_k, f_k) - c_shift)[None, :])
    return out
