"""Large-problem MBAR solver: float32 phase + double-word chord-Newton polish.

The counterpart of the single-device solve of :mod:`pymbar_tpu.solvers_large`.
The reduced-potential matrix is held as two float32 planes (hi, lo), the
same 8 bytes per element as f64, and the solve runs in two phases:

1. **float32 phase**: for large problems the adaptive solver
   (:func:`pymbar_tpu_torch.solvers._adaptive_while`) on a strided
   subsample of the hi plane, which also supplies the polish's chord factor
   from the subsample Gram; small problems run the adaptive loop on the
   full hi plane.  Convergence uses the 'mixed' metric (divide by
   max(|f_k|, 1)).
2. **double-word polish**: chord-Newton iterations, each ONE call of the
   ``wsum_dd`` kernel producing S_k = sum_n N_k W_nk and hence the exact
   gradient S_k - N_k; the frozen K x K factor comes from the float32
   Gram.  A full-plane float32 adaptive + fresh-factor retry covers the
   rare case where the subsample factor fails to contract.

The JAX package runs the polish as one device ``while_loop``; here it is a
Python loop that syncs once per iteration to evaluate its stop rules.

Bootstrap replicates (:func:`bootstrap_polish_dd`,
:func:`solve_mbar_dd_bootstrap`) ride the same planes: a resample is the
data reweighted by integer per-sample counts, so a replicate is a
counts-weighted polish from the base solution with the base chord factor.
The default batched engine advances every replicate per iteration from one
shared exp stream of the planes and two matmuls per chunk; the serial mode
runs one counts-weighted ``wsum_dd`` polish per replicate.
"""

import logging
import time

import numpy as np
import torch

from pymbar_tpu_torch.ops.doubledouble import dd_from_f64, dd_to_f64
from pymbar_tpu_torch.ops.mbar_core import (
    _CHUNK_BYTES,
    _as_tensor,
    _matmul,
    _same_device,
    _work_on,
    gram_f32_acc64,
    stream_columns,
)
from pymbar_tpu_torch.ops.wsum import wsum_dd
from pymbar_tpu_torch.solvers import _adaptive_while, target_device
from pymbar_tpu_torch.tracing import span

logger = logging.getLogger(__name__)

__all__ = [
    "solve_mbar_dd",
    "split_u_kn_streamed",
    "host_split_planes",
    "dev_split_planes",
    "stream_split_planes",
    "polish_to_host",
    "bootstrap_polish_dd",
    "solve_mbar_dd_bootstrap",
]

# Below this many K x N plane elements the coarse strided-subsample warm
# start is skipped and the float32 phase runs on the full plane.  The value
# is the JAX package's, sized for a TPU; the H100's own is still to be
# measured.  Module constant so tests can exercise the coarse path.
COARSE_MIN_ELEMS = 2**27


def _coarse_stride(N_k_host, n_elems):
    """Subsample stride for the coarse warm start (0 = don't).

    Capped so every state keeps >= 16 subsamples: the subsample Gram must
    remain a usable chord factor.
    """
    if n_elems < COARSE_MIN_ELEMS:
        return 0
    stride = min(16, int(N_k_host.min()) // 16)
    return stride if stride >= 2 else 0


def split_u_kn_streamed(u64):
    """Split a float64 u_kn into (hi, lo) float32 planes, with no shift:
    hi = f32(u), lo = f32(u - f64(hi)).  A tensor keeps its device, numpy
    gives CPU tensors.  The JAX package donates its input to the split; the
    port leaves it as it is."""
    return dd_from_f64(_as_tensor(u64).to(torch.float64))


def dev_split_planes(u64):
    """Double-word split of a float64 tensor u_kn on its own device.

    Applies the per-sample min shift (gradients are shift-invariant and the
    dd solver never consumes the objective value) and fills the (hi, lo)
    float32 planes chunk by chunk, so only chunk-sized f64 temporaries
    exist next to the matrix and the planes.
    """
    K, N = u64.shape
    shift = u64.min(dim=0).values
    uh = torch.empty((K, N), dtype=torch.float32, device=u64.device)
    ul = torch.empty((K, N), dtype=torch.float32, device=u64.device)
    width = max(1, _CHUNK_BYTES // (8 * K))
    for s in range(0, N, width):
        e = min(N, s + width)
        blk = u64[:, s:e] - shift[None, s:e]
        hi = blk.to(torch.float32)
        uh[:, s:e] = hi
        ul[:, s:e] = blk.sub_(hi.to(torch.float64)).to(torch.float32)
    return uh, ul


def stream_split_planes(u_kn, device=None, rows=None):
    """:func:`dev_split_planes` of u_kn[rows] (every row by default), with
    the (hi, lo) planes on ``device`` (default: u's own) and filled column
    chunk by column chunk from
    :func:`pymbar_tpu_torch.ops.mbar_core.stream_columns`.

    A CPU u_kn with a CUDA ``device`` stays in host memory: its chunks are
    uploaded through pinned staging and split on the card, so the card
    holds the planes and chunk-sized temporaries, never the float64
    matrix.  The shift is per column, so each chunk's own column min is
    the shift, and the planes are bit-identical to
    ``dev_split_planes(u_kn[rows])``; a float32 or non-contiguous u_kn is
    cast one chunk at a time.
    """
    u = _as_tensor(u_kn)
    dev = _work_on(u, device)[1]
    K = u.shape[0] if rows is None else len(rows)
    uh = torch.empty((K, u.shape[1]), dtype=torch.float32, device=dev)
    ul = torch.empty_like(uh)
    with span("dd.split"):
        _split_into(u, uh, ul, rows)
    return uh, ul


def _split_into(u_kn, uh, ul, rows=None, start=0):
    """Write the double-word split of u_kn[rows, start:start + n] into
    uh[:, :n] and ul[:, :n] on their device, n = min(uh's width, the
    columns left from ``start``), one streamed column chunk at a time (see
    :func:`stream_split_planes`)."""
    stop = min(u_kn.shape[1], start + uh.shape[1])
    # a chunk from another device is a fresh float64 copy (the staging
    # buffer of a host-resident u_kn): the split may overwrite it
    own = not _same_device(u_kn.device, uh.device)
    for s, e, u_c in stream_columns(u_kn, uh.device, rows=rows, start=start, stop=stop):
        blk = u_c if own else u_c.to(torch.float64, copy=True)
        blk.sub_(blk.amin(dim=0)[None, :])
        hi, lo = uh[:, s - start:e - start], ul[:, s - start:e - start]
        hi.copy_(blk)
        lo.copy_(blk.sub_(hi))  # hi widens exactly: the f64 residual of the pair


def host_split_planes(u_np):
    """Host (numpy) double-word split of a float64 u_kn into (hi, lo) planes.

    Same per-sample min shift as :func:`dev_split_planes`, chunkwise in
    numpy.  Returns (u_hi, u_lo) as numpy float32 arrays.
    """
    u_np = np.asarray(u_np, dtype=np.float64)
    shift = u_np.min(axis=0)
    K_, N_ = u_np.shape
    uh = np.empty((K_, N_), dtype=np.float32)
    ul = np.empty((K_, N_), dtype=np.float32)
    chunk = max(1, int(2**27 // max(K_, 1)))
    for s in range(0, N_, chunk):
        blk = u_np[:, s : s + chunk] - shift[s : s + chunk][None, :]
        bh = blk.astype(np.float32)
        uh[:, s : s + chunk] = bh
        ul[:, s : s + chunk] = (blk - bh.astype(np.float64)).astype(np.float32)
    return uh, ul


def _newton_factor(gram, colsum, N_k64):
    """Explicit inverse of the reduced Hessian from a Gram (f64 algebra).

    Computed once per polish and reused across iterations (chord Newton):
    each iteration only needs ~1e-2 contraction, so the stale factor costs
    nothing observable.  A Gram that is not positive definite gives a NaN
    factor (as JAX's cho_factor), which the polish's non-finite stop catches.
    """
    gram = gram.to(torch.float64)
    colsum = colsum.to(torch.float64)
    H = -(gram * N_k64[None, :] * N_k64[:, None] - torch.diag(colsum * N_k64))
    L, info = torch.linalg.cholesky_ex(H[1:, 1:])
    L = torch.where(info == 0, L, torch.nan)
    eye = torch.eye(H.shape[0] - 1, dtype=torch.float64, device=H.device)
    return torch.cholesky_solve(eye, L)


def _newton_step_g(f, g, hinv, gamma):
    """One f64 chord-Newton step from the exact gradient g_k = S_k - N_k."""
    dx1 = hinv @ g[1:]
    f_new = f - gamma * torch.cat([torch.zeros(1, dtype=f.dtype, device=f.device), dx1])
    return f_new - f_new[0]


def _polish_loop(wsum, u_hi, u_lo, N_k64, f0, hinv, logN, tol, gamma, maxiter):
    """The dd chord-Newton polish, one ``wsum`` pass per iteration.

    Stop rules: converged (delta < tol), stalled (>= 2nd iteration,
    delta < 1e-9 yet > 0.3 x previous), tiny (delta < 3e-13), or predictive
    (delta^2/prev < 1e-14: even the extrapolated next step would sit below
    the floor).  The last three mark the dd noise floor; a stop that met
    the requested tol is NOT flagged as noise-floor.  A non-finite step
    stops at once WITHOUT being taken, so a fallback restarts from the last
    finite iterate.

    Returns (f, iterations, g_last, deltas (maxiter,) nan-padded,
    converged, at_noise_floor).
    """
    f = f0
    g = torch.zeros_like(f0)
    deltas = np.full(maxiter, np.nan)
    prev_d = np.inf
    it = 0
    done = floor = bad = False
    while it < maxiter and not done:
        gh, gl = dd_from_f64(f + logN)
        Sh, Sl = wsum(u_hi, u_lo, gh, gl)
        g = dd_to_f64(Sh, Sl) - N_k64
        f_new = _newton_step_g(f, g, hinv, gamma)
        div = torch.clamp(torch.abs(f_new[1:]), min=1.0)
        d = float(torch.max(torch.abs(f_new[1:] - f[1:]) / div))
        deltas[it] = d

        bad = not np.isfinite(d)
        conv = d < tol
        stalled = it >= 1 and d < 1.0e-9 and d > 0.3 * prev_d
        tiny = d < 3.0e-13
        pred = d * d / prev_d if np.isfinite(prev_d) and prev_d > 0 else np.inf
        at_floor = not conv and (stalled or tiny or pred < 1.0e-14)
        if not bad:
            f = f_new
        prev_d = d
        done = conv or at_floor or bad
        floor = floor or at_floor
        it += 1
    # every stop except maxiter exhaustion or a non-finite step converged
    return f, it, g, deltas, done and not bad, floor


def polish_to_host(polish_results):
    """A polish loop's results as host types: (f64 tensor, iterations,
    g_last tensor, deltas list, converged, at_noise_floor)."""
    f64, it, g64, deltas_arr, converged, floor = polish_results
    it = int(it)
    deltas = [float(d) for d in np.asarray(deltas_arr)[:it]]
    return f64, it, g64, deltas, bool(converged), bool(floor)


def _strided_subsample(N_k, stride):
    """Every-``stride``-th column selection in kn block order.

    Returns (flat column indices, per-state subsample counts).  Sampling
    uniformly within each state block keeps the subproblem a consistent
    MBAR estimate of the full problem.
    """
    N_k = np.asarray(N_k, dtype=np.int64)
    idx = []
    counts = np.zeros_like(N_k)
    start = 0
    for k, nk in enumerate(N_k):
        sel = np.arange(start, start + nk, stride, dtype=np.int64)
        idx.append(sel)
        counts[k] = sel.size
        start += nk
    return np.concatenate(idx), counts


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def solve_mbar_dd(
    u_hi,
    u_lo,
    N_k,
    f_k=None,
    tol=1.0e-12,
    f32_tol=1.0e-4,
    f32_maxiter=40,
    polish_maxiter=12,
    gamma=1.0,
    device=None,
):
    """Solve the MBAR equations on double-word-split reduced potentials.

    Parameters
    ----------
    u_hi, u_lo : (K, N) float32 tensors, or numpy arrays
        Double-word planes of the (preconditioned) reduced potentials.  A
        tensor keeps its device; numpy goes to ``device``, by default the
        CUDA card (``device="cpu"`` or ``PYMBAR_TPU_TORCH_DEVICE=cpu`` runs
        on the CPU; :func:`pymbar_tpu_torch.config.target_device`).
    N_k : (K,) — all states must have samples (empty-state fill is the
        caller's job, as in solve_mbar_for_all_states).
    f_k : optional initial guess (float64).
    tol : relative convergence tolerance of the polish phase.
    device : where numpy planes go (see ``u_hi``).

    Returns (f_k float64 ndarray, info dict with gnorm/iteration counts).
    """
    if not torch.is_tensor(u_hi):
        u_hi = torch.as_tensor(np.asarray(u_hi), device=target_device(device))
    if not torch.is_tensor(u_lo):
        u_lo = torch.as_tensor(np.asarray(u_lo), device=u_hi.device)
    dev = u_hi.device
    K = u_hi.shape[0]
    N_k_host = np.asarray(N_k, dtype=np.int64)
    N_k64 = torch.as_tensor(np.asarray(N_k, dtype=np.float64), device=dev)
    N_k32 = N_k64.to(torch.float32)
    f64 = torch.zeros(K, dtype=torch.float64, device=dev)
    if f_k is not None:
        f64 = torch.as_tensor(np.asarray(f_k, dtype=np.float64), device=dev)
    f64 = f64 - f64[0]

    def f32_adaptive(u32, N32, f):
        return _adaptive_while(
            u32, N32, f.to(torch.float32), gamma, f32_tol, f32_maxiter, 2, "chol", "mixed"
        )

    _sync(dev)
    walls = {}
    with span("dd.phase1", walls, "phase1_s"):
        # ---- phase 1a: warm start on a strided subsample, whose f_k sits
        # ~1e-2..1e-3 from the full solution at ~1/stride the cost; the polish
        # starts directly from it, with its chord factor from the subsample Gram.
        it32_coarse = 0
        hinv = None
        stride = _coarse_stride(N_k_host, u_hi.numel())
        if stride:
            if (N_k_host % stride == 0).all():
                # every state block is stride-aligned: a plain strided copy
                u_sub = u_hi[:, ::stride].contiguous()
                N_k_sub = N_k_host // stride
            else:
                idx, N_k_sub = _strided_subsample(N_k_host, stride)
                u_sub = u_hi.index_select(1, torch.as_tensor(idx, device=dev))
            N_sub32 = torch.as_tensor(N_k_sub, dtype=torch.float32, device=dev)
            f32_coarse, it32_coarse, _, _, _, done32 = f32_adaptive(u_sub, N_sub32, f64)
            f64 = f32_coarse.to(torch.float64)
            f64 = f64 - f64[0]
            # W columns normalize to 1 whatever the sample count, so
            # gram_full ~ gram_sub / ratio while the column sums stay ~1.
            gram_s, colsum_s = gram_f32_acc64(u_sub, N_sub32, f32_coarse)
            ratio = float(N_k_host.sum()) / float(N_k_sub.sum())
            hinv = _newton_factor(gram_s / ratio, colsum_s, N_k64)
            del u_sub

        # ---- phase 1b (small problems only): full-plane float32 adaptive.
        it32 = 0
        if not it32_coarse:
            f32_out, it32, _, _, _, done32 = f32_adaptive(u_hi, N_k32, f64)
            f64 = f32_out.to(torch.float64)
            f64 = f64 - f64[0]
        _sync(dev)
    with span("dd.phase2", walls, "phase2_s"):
        # ---- phase 2: double-word chord-Newton polish on the wsum kernel.
        logN = torch.log(N_k64)
        if hinv is None:
            gram, colsum = gram_f32_acc64(u_hi, N_k32, f64.to(torch.float32))
            hinv = _newton_factor(gram, colsum, N_k64)

        def run_polish(f_start):
            return polish_to_host(
                _polish_loop(
                    wsum_dd, u_hi, u_lo, N_k64, f_start, hinv, logN, tol, gamma, polish_maxiter
                )
            )

        f64, it, g64, deltas, converged, at_noise_floor = run_polish(f64)
        max_delta = deltas[-1] if deltas else np.inf

        if not converged and it32_coarse:
            # The subsample factor failed to contract the polish: full-plane
            # float32 adaptive from the current iterate, a fresh full-plane
            # factor, and one more polish.
            logger.info(
                "dd polish did not converge off the subsample factor "
                "(last delta %.2e); re-running with the full-plane factor",
                max_delta,
            )
            f32_out, it32, _, _, _, done32 = f32_adaptive(u_hi, N_k32, f64)
            f64 = f32_out.to(torch.float64)
            f64 = f64 - f64[0]
            gram, colsum = gram_f32_acc64(u_hi, N_k32, f64.to(torch.float32))
            hinv = _newton_factor(gram, colsum, N_k64)
            f64, it2, g64, deltas2, converged, at_noise_floor = run_polish(f64)
            deltas += deltas2
            it += it2
            max_delta = deltas[-1] if deltas else np.inf

        gnorm = float(torch.linalg.norm(g64)) if it else np.nan
        f_out = f64.cpu().numpy()
    return f_out, dict(
        converged=converged,
        at_noise_floor=at_noise_floor,
        f32_iterations=int(it32),
        f32_coarse_iterations=int(it32_coarse),
        f32_converged=bool(done32),
        polish_iterations=it,
        max_delta=max_delta,
        deltas=deltas,
        gnorm=gnorm,
        phase1_s=walls["phase1_s"],
        phase2_s=walls["phase2_s"],
        hinv=hinv,
    )


# -----------------------------------------------------------------------------
# Bootstrap replicates
# -----------------------------------------------------------------------------


def _polish_while_dd_w(u_hi, u_lo, c, N_k64, f0, hinv, logN, tol, gamma, maxiter):
    """Counts-weighted dd polish of one bootstrap replicate:
    :func:`_polish_loop` over ``wsum_dd(..., c=c)`` (K1 with counts on a
    CUDA tensor), so the replicate's gradient is sum_n c_n N_k W_nk - N_k
    on the SAME planes.  ``c``: (N,) float32 counts on the planes' device."""

    def wsum(uh, ul, gh, gl):
        return wsum_dd(uh, ul, gh, gl, c)

    return _polish_loop(wsum, u_hi, u_lo, N_k64, f0, hinv, logN, tol, gamma, maxiter)


# Ceiling on (planes + resident th) bytes of one card for the batched
# bootstrap's materialized fast-phase plane: 12 B/element (8 B dd planes +
# 4 B f32 th), counted over every shard on the card.  Measured on an 80 GB
# H100 (PERF.md): at K = 1024 x N = 2.56e6 (30.7 GB) the resident th
# took the B = 64 polish from 2.48-2.52 s to 1.35-1.39 s at a peak of 53.0 GB
# (42.6 GB recomputing, u_kn included); above the ceiling the fast phase
# recomputes the exp every iteration.
_TH_RESIDENT_BUDGET_BYTES = 32.0e9


def _use_resident_th(K, N):
    return 12.0 * K * N <= _TH_RESIDENT_BUDGET_BYTES


def _exp_chunk(uh_c, ul_c, g0h, g0l):
    """T1_kn = exp((g0_k - u_kn) - m_n) in f64 for one column chunk, with
    the JAX package's stabilizer m_n = max_k (g0h_k - uh_kn) in float32
    (it cancels in every weight).  The JAX package evaluates this dd exp
    outside Pallas (``_exp_terms``); here it is plain f64."""
    m = (g0h[:, None] - uh_c).amax(dim=0)
    a = dd_to_f64(g0h, g0l)[:, None] - dd_to_f64(uh_c, ul_c)
    return a.sub_(m.to(torch.float64)[None, :]).exp_()


def _materialize_th(u_hi, u_lo, g0h, g0l, n_chunk):
    """The base-point fast plane th_kn = float32(T1_kn), written chunk by
    chunk.  T1 depends only on the base point g0, not on the replicate
    iterates, so every fast-phase iteration of every group reuses it and
    skips the exp."""
    K, N = u_hi.shape
    th = torch.empty((K, N), dtype=torch.float32, device=u_hi.device)
    for s in range(0, N, n_chunk):
        e = min(N, s + n_chunk)
        th[:, s:e] = _exp_chunk(u_hi[:, s:e], u_lo[:, s:e], g0h, g0l)
    return th


# Sample-segment width of the fast phase's weight-sum contraction: float32
# products summed over 512-wide segments, float64 adds between segments,
# which bounds each float32 accumulation chain at 512 terms (S error
# ~2.5e-8 relative where one flat chain gives ~1.7e-6, JAX package).
_FAST_SEG = 512


def _seg_wsum(W, th_c, seg=_FAST_SEG):
    """(B, nc) x (K, nc) -> (B, K) float64 weight sum: float32 products over
    ``seg``-wide sample segments (one batched matmul, TF32 refused), f64
    adds between segments; a ragged tail contracts flat."""
    B, nc = W.shape
    K = th_c.shape[0]
    nseg = nc // seg
    main = nseg * seg
    S = torch.zeros((B, K), dtype=torch.float64, device=W.device)
    if nseg:
        Wr = W[:, :main].reshape(B, nseg, seg).transpose(0, 1)  # (nseg, B, seg)
        Tr = th_c[:, :main].reshape(K, nseg, seg).permute(1, 2, 0)  # (nseg, seg, K)
        S = _matmul(Wr, Tr).to(torch.float64).sum(dim=0)
    if main < nc:
        S += _matmul(W[:, main:], th_c[:, main:].T).to(torch.float64)
    return S


def _batched_boot_chunk_th(th_c, R32, C_c):
    """Fast-phase chunk contribution from the resident th plane: the
    denominator matmul and :func:`_seg_wsum`, no exp."""
    den = _matmul(R32, th_c)
    return _seg_wsum(C_c / den, th_c)


def _batched_boot_chunk(uh_c, ul_c, g0h, g0l, R, C_c, exact):
    """One sample chunk's contribution to every replicate's weight sum.

    With T1_kn = exp((g0_k - u_kn) - m_n) at the base point g0 and
    r_bk = exp(f_bk - f_base,k), replicate b's weights are
    W_bnk = r_bk T1_kn / sum_j r_bj T1_jn (m_n cancels), so the exp is
    computed once for all replicates and the per-replicate work is two
    (B, K) x (K, nc) matmuls.  ``exact``: float64 matmuls (DGEMM); else
    float32 on the rounded T1 with the segmented weight sum.  Returns the
    (B, K) partial sum_n C_bn T1_kn / den_bn (the caller scales by r_bk).
    """
    T = _exp_chunk(uh_c, ul_c, g0h, g0l)
    if exact:
        W = C_c.to(torch.float64) / (R @ T)
        return W @ T.T
    th = T.to(torch.float32)
    del T
    return _batched_boot_chunk_th(th, R.to(torch.float32), C_c)


def _batched_wsum_S(u_hi, u_lo, g0h, g0l, R, C, n_chunk, exact, th=None):
    """S_bk = r_bk sum_n c_bn T1_kn / den_bn for all B replicates: one
    streamed exp pass over the planes and two matmuls per chunk, or, for
    the fast phase with the resident plane ``th``, the matmuls alone.
    ``C``: (B, N) counts on the device, uint8 or float32; each chunk is
    cast to float32 as it is used."""
    K, N = u_hi.shape
    use_th = th is not None and not exact
    R32 = R.to(torch.float32) if use_th else None
    S = torch.zeros((C.shape[0], K), dtype=torch.float64, device=u_hi.device)
    for s in range(0, N, n_chunk):
        e = min(N, s + n_chunk)
        C_c = C[:, s:e].to(torch.float32)
        if use_th:
            S += _batched_boot_chunk_th(th[:, s:e], R32, C_c)
        else:
            S += _batched_boot_chunk(u_hi[:, s:e], u_lo[:, s:e], g0h, g0l, R, C_c, exact)
    return R * S


# Fast-phase stop: the segmented pass's step-delta plateau sits at ~2e-7,
# so 1e-6 is reached in a few iterations; the fast fixed point itself lies
# ~2e-5 from the truth, which is the exact phase's start error.
_BATCH_FAST_TOL = 1.0e-6
_BATCH_FAST_MAXITER = 10


def _batch_step(S_fn, g0h, g0l, f0, N_k64, hinv, gamma, F, exact):
    """One batched frozen-factor chord-Newton step of all replicates:
    returns (F_new, per-replicate delta)."""
    R = torch.exp(F - f0[None, :])
    g = S_fn(g0h, g0l, R, exact) - N_k64[None, :]
    dx1 = g[:, 1:] @ hinv.T
    F_new = F - gamma * torch.nn.functional.pad(dx1, (1, 0))
    F_new = F_new - F_new[:, :1]
    div = torch.clamp(torch.abs(F_new[:, 1:]), min=1.0)
    d = (torch.abs(F_new[:, 1:] - F[:, 1:]) / div).amax(dim=1)
    return F_new, d


def _batch_fast_from_S_fn(S_fn, B, N_k64, f0, hinv, gamma):
    """FAST phase of the batched bootstrap: float32 matmul iterations take
    every replicate from its ~1/sqrt(N_k) start displacement to the
    segmented pass's delta plateau (stop at ``_BATCH_FAST_TOL``).  A
    replicate below the tol, or with a non-finite step, keeps its iterate;
    a non-finite iterate restarts from the base point.  One host sync per
    iteration.  Returns (F, iterations)."""
    g0h, g0l = dd_from_f64(f0 + torch.log(N_k64))
    F0 = f0[None, :].expand(B, f0.shape[0]).to(torch.float64).clone()
    F = F0
    prev_d = torch.full((B,), torch.inf, dtype=torch.float64, device=f0.device)
    it = 0
    while it < _BATCH_FAST_MAXITER and not bool((prev_d < _BATCH_FAST_TOL).all()):
        F_new, d = _batch_step(S_fn, g0h, g0l, f0, N_k64, hinv, gamma, F, exact=False)
        keep = torch.isfinite(d) & (prev_d >= _BATCH_FAST_TOL)
        F = torch.where(keep[:, None], F_new, F)
        prev_d = torch.where(torch.isfinite(d), d, prev_d)
        it += 1
    F = torch.where(torch.isfinite(F).all(dim=1)[:, None], F, F0)
    return F, it


def _batch_exact_from_S_fn(S_fn, F, N_k64, f0, hinv, tol, gamma, maxiter):
    """EXACT phase of the batched bootstrap: float64 matmuls with
    per-replicate certification, from the fast phase's iterates ``F``.

    Per-replicate stops: converged (d < tol), stalled, tiny, non-finite,
    and the predictive stop d^2/prev_d < 0.1 tol (under the measured linear
    contraction the next delta would sit 10x below tol, so the pass that
    would certify it is skipped).  The single-replicate polish keeps its
    own 1e-14 predictive rule.  A stopped replicate keeps its iterate.
    One host sync per iteration.  Returns (F, iters (B,), deltas
    (maxiter, B) nan-padded, converged (B,), at_floor (B,))."""
    g0h, g0l = dd_from_f64(f0 + torch.log(N_k64))
    B = F.shape[0]
    dev = F.device
    prev_d = torch.full((B,), torch.inf, dtype=torch.float64, device=dev)
    deltas = torch.full((maxiter, B), torch.nan, dtype=torch.float64, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    floor = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    it = 0
    while it < maxiter and not bool(done.all()):
        F_new, d = _batch_step(S_fn, g0h, g0l, f0, N_k64, hinv, gamma, F, exact=True)
        bad = ~torch.isfinite(d)
        conv = d < tol
        stalled = (iters >= 1) & (d < 1.0e-9) & (d > 0.3 * prev_d)
        tiny = d < 3.0e-13
        pred = torch.where(torch.isfinite(prev_d), d * d / prev_d, torch.inf)
        at_floor = ~conv & (stalled | tiny | (pred < 0.1 * tol))
        live = ~done
        deltas[it] = torch.where(live, d, torch.nan)
        F = torch.where((live & ~bad)[:, None], F_new, F)
        prev_d = torch.where(live, d, prev_d)
        iters += live.to(torch.int32)
        done = done | conv | at_floor | bad
        floor = floor | (live & at_floor)
        it += 1
    # converged unless it exhausted maxiter or its last delta was non-finite
    return F, iters, deltas, done & torch.isfinite(prev_d), floor


def _batch_loop_from_S_fn(S_fn, B, N_k64, f0, hinv, tol, gamma, maxiter):
    """The two-phase batched chord-Newton loop over an abstract weight-sum
    pass ``S_fn(g0h, g0l, R, exact) -> (B, K) f64``: the fast phase, then
    the exact phase.  The single-card engine runs the phases separately (to
    time each); this composition is the form a sharded engine reuses.
    Returns the exact phase's (F, iters, deltas, converged, at_floor)."""
    F, _it_f = _batch_fast_from_S_fn(S_fn, B, N_k64, f0, hinv, gamma)
    return _batch_exact_from_S_fn(S_fn, F, N_k64, f0, hinv, tol, gamma, maxiter)


def _polish_while_dd_batch_fast(u_hi, u_lo, C, N_k64, f0, hinv, gamma, n_chunk, th=None):
    """FAST phase of the single-card batched bootstrap over
    :func:`_batched_wsum_S`; with ``th`` it never evaluates the exp."""

    def S_fn(g0h, g0l, R, exact):
        return _batched_wsum_S(u_hi, u_lo, g0h, g0l, R, C, n_chunk, exact, th=th)

    return _batch_fast_from_S_fn(S_fn, C.shape[0], N_k64, f0, hinv, gamma)


def _polish_while_dd_batch_exact(u_hi, u_lo, C, N_k64, F, f0, hinv, tol, gamma, maxiter, n_chunk):
    """EXACT phase of the single-card batched bootstrap (float64 matmuls,
    per-replicate certification)."""

    def S_fn(g0h, g0l, R, exact):
        return _batched_wsum_S(u_hi, u_lo, g0h, g0l, R, C, n_chunk, exact)

    return _batch_exact_from_S_fn(S_fn, F, N_k64, f0, hinv, tol, gamma, maxiter)


def _polish_while_dd_batch(u_hi, u_lo, C, N_k64, f0, hinv, tol, gamma, maxiter, n_chunk, th=None):
    """All replicates of ``C`` polished together on one card: the fast and
    exact phases back to back.  Each iteration advances every live
    replicate from one shared exp stream of the planes, where the serial
    mode pays that stream once per replicate."""
    F, _it_f = _polish_while_dd_batch_fast(u_hi, u_lo, C, N_k64, f0, hinv, gamma, n_chunk, th=th)
    return _polish_while_dd_batch_exact(u_hi, u_lo, C, N_k64, F, f0, hinv, tol, gamma, maxiter,
                                        n_chunk)


def _batch_chunk_width(K, N):
    """Sample-chunk width of the batched pass: ~2^24 chunk elements (a
    128 MB f64 T1 chunk at K = 1024).  The JAX package's value, sized for a
    TPU; the H100's own is still to be measured."""
    return int(max(1024, min(N, (1 << 24) // max(K, 1))))


def _batch_group_size(B, N):
    """Replicates per batched group: the device counts matrix is at most
    ~2^28 elements (the JAX package's budget).  On an H100 at the flagship
    (N = 999,424, B = 256) one group of 256 took 0.89-0.90 s, groups of
    128 1.20-1.25 s and of 64 1.96 s, at peaks within 0.22 GB of each other
    (PERF.md): the largest group that the budget allows is the
    fastest measured."""
    return int(max(1, min(B, max(8, (1 << 28) // max(N, 1)))))


def _boot_info(at_floor, B, n_fail):
    """Bootstrap convergence accounting: 'certified d < tol' apart from
    'stopped at the dd noise floor' (stalled / tiny / predictive stop,
    worst-case residual ~tol/5), so callers see the relaxed stop."""
    n_at_floor = int(np.count_nonzero(at_floor))
    if n_at_floor:
        logger.info(
            f"{n_at_floor:d}/{B:d} bootstrap replicates stopped at the dd "
            "noise floor (stalled/tiny/predictive stop) rather than "
            "certifying d < tol; worst-case residual ~tol/5."
        )
    return dict(at_floor=at_floor, n_at_floor=n_at_floor, n_tol_converged=B - n_fail - n_at_floor)


def _counts_upload_dtype(counts):
    """uint8 when every count fits (resample multiplicities are small
    integers), else float32."""
    if counts.dtype == np.uint8:
        return np.uint8
    top = counts.max()
    if np.issubdtype(counts.dtype, np.integer):
        return np.uint8 if top <= 255 else np.float32
    integral = top <= 255 and counts.min() >= 0 and np.all(counts == np.round(counts))
    return np.uint8 if integral else np.float32


def _retry_polish(u_hi, u_lo, c, N_k64, f_b, logN, tol, gamma, maxiter):
    """A replicate the base factor failed to contract: a fresh
    counts-weighted float32-Gram factor at its current iterate and one
    more counts-weighted polish."""
    gram_b, colsum_b = gram_f32_acc64(u_hi, N_k64.to(torch.float32), f_b.to(torch.float32), c)
    hinv_b = _newton_factor(gram_b, colsum_b, N_k64)
    return polish_to_host(_polish_while_dd_w(u_hi, u_lo, c, N_k64, f_b, hinv_b, logN, tol, gamma,
                                             maxiter))


def bootstrap_polish_dd(
    u_hi,
    u_lo,
    N_k,
    f_k,
    hinv,
    counts,
    tol=1.0e-12,
    maxiter=16,
    gamma=1.0,
    verbose=False,
    mode="batched",
    device=None,
):
    """Solve B bootstrap replicates as counts-weighted dd chord-Newton polishes.

    The counterpart of :func:`pymbar_tpu.solvers_large.bootstrap_polish_dd`
    (minus its TPU knob ``fast_exp``).  A resample is the original data
    reweighted by integer per-sample multiplicities, so every replicate
    streams the SAME (hi, lo) planes and no K x N resampled copy exists.
    Each replicate starts from the base solution ``f_k`` with the base
    chord factor ``hinv``; one that fails to contract retries once with a
    fresh counts-weighted float32-Gram factor.

    ``counts``: (B, N) numpy resample multiplicities (rows sum to N, state
    blocks to N_k).  ``mode``: ``"batched"`` (default; every iteration
    advances all replicates of a group from one shared exp stream of the
    planes, a float32 fast phase then a float64 exact phase) or
    ``"serial"`` (one counts-weighted ``wsum_dd`` polish per replicate).
    Planes given as numpy go to ``device`` (default: the CUDA card).

    Returns (f_boots (B, K) float64 ndarray, n_fail, info): ``n_fail``
    counts replicates that neither met ``tol`` nor reached the dd noise
    floor; ``info["at_floor"]`` (B,) marks noise-floor stops,
    ``info["n_at_floor"]`` their count and ``info["n_tol_converged"]`` the
    replicates that certified d < tol (n_fail + n_at_floor +
    n_tol_converged == B).  The serial mode adds ``polish_iterations``
    (B,), one ``wsum_dd`` pass each.  The batched mode adds ``phase_walls`` (host
    seconds, synchronize-fenced: prep, upload, materialize, fast, exact,
    total; all but total from :func:`pymbar_tpu_torch.tracing.span`),
    ``fast_iters``, ``exact_iters`` (B,) and ``exact_deltas`` (maxiter,
    last group's width).
    """
    if not torch.is_tensor(u_hi):
        u_hi = torch.as_tensor(np.asarray(u_hi), device=target_device(device))
    if not torch.is_tensor(u_lo):
        u_lo = torch.as_tensor(np.asarray(u_lo), device=u_hi.device)
    dev = u_hi.device
    counts = np.asarray(counts)
    B = counts.shape[0]
    K, N = u_hi.shape
    N_k64 = torch.as_tensor(np.asarray(N_k, dtype=np.float64), device=dev)
    logN = torch.log(N_k64)
    f0 = torch.as_tensor(np.array(f_k, dtype=np.float64), device=dev)
    f0 = f0 - f0[0]
    hinv = torch.as_tensor(hinv if torch.is_tensor(hinv) else np.array(hinv),
                           dtype=torch.float64, device=dev)

    if mode == "serial":
        f_boots = np.zeros((B, K))
        at_floor = np.zeros(B, bool)
        iterations = np.zeros(B, np.int64)
        n_fail = 0
        for b in range(B):
            c = torch.as_tensor(np.asarray(counts[b], dtype=np.float32), device=dev)
            f_b, iterations[b], _g, _d, converged, floor_b = polish_to_host(
                _polish_while_dd_w(u_hi, u_lo, c, N_k64, f0, hinv, logN, tol, gamma, maxiter)
            )
            if not converged:
                f_b, it2, _g, _d, converged, floor_b = _retry_polish(
                    u_hi, u_lo, c, N_k64, f_b, logN, tol, gamma, maxiter
                )
                iterations[b] += it2
            at_floor[b] = converged and floor_b
            n_fail += not converged
            f_boots[b] = f_b.cpu().numpy()
            if verbose and (b + 1) % max(1, B // 10) == 0:
                logger.info(f"Calculated {b + 1:d}/{B:d} bootstrap samples")
        info = _boot_info(at_floor, B, n_fail)
        info["polish_iterations"] = iterations
        return f_boots, n_fail, info
    if mode != "batched":
        raise ValueError(f"bootstrap_polish_dd: unknown mode {mode!r}")

    t_all = time.perf_counter()
    n_chunk = _batch_chunk_width(K, N)
    group = _batch_group_size(B, N)
    walls = dict(prep_s=0.0, upload_s=0.0, materialize_s=0.0, fast_s=0.0, exact_s=0.0)
    th = None
    with span("boot.materialize", walls, "materialize_s"):
        if _use_resident_th(K, N):
            # one extra exp pass buys every fast iteration of every group
            g0h, g0l = dd_from_f64(f0 + logN)
            th = _materialize_th(u_hi, u_lo, g0h, g0l, n_chunk)
            _sync(dev)
    f_boots = np.zeros((B, K))
    at_floor = np.zeros(B, bool)
    fast_iters = 0
    exact_iters = np.zeros(B, np.int32)
    retry = []
    with span("boot.prep", walls, "prep_s"):
        up_dtype = _counts_upload_dtype(counts)
    for s in range(0, B, group):
        # a short last group runs as it is: replicate rows are independent
        e = min(B, s + group)
        with span("boot.prep", walls, "prep_s"):
            C = np.ascontiguousarray(counts[s:e], dtype=up_dtype)
        with span("boot.upload", walls, "upload_s"):
            C_dev = torch.as_tensor(C, device=dev)
            _sync(dev)
        with span("boot.fast", walls, "fast_s"):
            F, it_f = _polish_while_dd_batch_fast(u_hi, u_lo, C_dev, N_k64, f0, hinv, gamma,
                                                  n_chunk, th=th)
            _sync(dev)
        fast_iters = max(fast_iters, it_f)
        with span("boot.exact", walls, "exact_s"):
            F, iters, deltas_g, conv, floor = _polish_while_dd_batch_exact(
                u_hi, u_lo, C_dev, N_k64, F, f0, hinv, tol, gamma, maxiter, n_chunk
            )
            f_boots[s:e] = F.cpu().numpy()
        conv = conv.cpu().numpy()
        at_floor[s:e] = floor.cpu().numpy()
        exact_iters[s:e] = iters.cpu().numpy()
        retry.extend(s + i for i in np.nonzero(~conv)[0])
        del C_dev
        if verbose:
            logger.info(f"Calculated {e:d}/{B:d} bootstrap samples (batched)")
    del th  # release the 4 B/element fast plane before the retries
    n_fail = 0
    with span("boot.retry"):
        for b in retry:
            c = torch.as_tensor(np.asarray(counts[b], dtype=np.float32), device=dev)
            f_b = torch.as_tensor(f_boots[b], device=dev)
            f_b, _it, _g, _d, converged, floor_b = _retry_polish(
                u_hi, u_lo, c, N_k64, f_b, logN, tol, gamma, maxiter
            )
            at_floor[b] = converged and floor_b
            n_fail += not converged
            f_boots[b] = f_b.cpu().numpy()
    info = _boot_info(at_floor, B, n_fail)
    walls["total_s"] = time.perf_counter() - t_all
    info["phase_walls"] = walls
    info["fast_iters"] = fast_iters
    info["exact_iters"] = exact_iters
    info["exact_deltas"] = deltas_g.cpu().numpy()
    return f_boots, n_fail, info


def solve_mbar_dd_bootstrap(u_kn, N_k, f_k, counts, tol=1.0e-12, options=None, verbose=False,
                            device=None):
    """Base solve + bootstrap replicates on one set of dd planes.

    The counterpart of :func:`pymbar_tpu.solvers_large.solve_mbar_dd_bootstrap`,
    the front door of ``MBAR(u_kn, N_k, n_bootstraps=B)`` on the dd route:
    the planes are split once (:func:`stream_split_planes`: on ``device``,
    by default a tensor's own device and the card for numpy; a CPU tensor
    with a CUDA ``device`` streams its column chunks from host memory),
    the base problem solves with
    :func:`solve_mbar_dd`, and every replicate rides
    :func:`bootstrap_polish_dd` on the same planes with the base chord
    factor.  All states must have samples.  Returns (f_k, f_boots, n_fail,
    info), ``info`` the base solve's plus ``bootstrap_at_floor``,
    ``bootstrap_n_at_floor``, ``bootstrap_n_tol_converged`` and the
    engine's ``phase_walls`` as ``bootstrap_phase_walls``.
    """
    options = dict(options or {})
    dev = u_kn.device if torch.is_tensor(u_kn) and device is None else target_device(device)
    uh, ul = stream_split_planes(u_kn, dev)
    f_k = np.asarray(f_k, dtype=np.float64)
    f_sol, info = solve_mbar_dd(
        uh, ul, N_k, f_k=f_k - f_k[0], tol=tol,
        **{k: options[k] for k in ("f32_tol", "f32_maxiter", "polish_maxiter", "gamma")
           if k in options},
    )
    f_sol = f_sol - f_sol[0]
    f_boots, n_fail, boot_info = bootstrap_polish_dd(
        uh, ul, N_k, f_sol, info["hinv"], counts, tol=tol, verbose=verbose
    )
    info["bootstrap_at_floor"] = boot_info["at_floor"]
    info["bootstrap_n_at_floor"] = boot_info["n_at_floor"]
    info["bootstrap_n_tol_converged"] = boot_info["n_tol_converged"]
    info["bootstrap_phase_walls"] = boot_info["phase_walls"]
    return f_sol, f_boots - f_boots[:, :1], n_fail, info
