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
Bootstrap replicates are not ported yet.
"""

import logging
import time

import numpy as np
import torch

from pymbar_tpu_torch.ops.doubledouble import dd_from_f64, dd_to_f64
from pymbar_tpu_torch.ops.mbar_core import _CHUNK_BYTES, gram_f32_acc64
from pymbar_tpu_torch.ops.wsum import wsum_dd
from pymbar_tpu_torch.solvers import _adaptive_while, target_device

logger = logging.getLogger(__name__)

__all__ = ["solve_mbar_dd", "host_split_planes", "dev_split_planes", "polish_to_host"]

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
        CUDA card (``device="cpu"`` runs on the CPU).
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
    t_phase1 = time.time()

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
    t_phase1 = time.time() - t_phase1
    t_phase2 = time.time()

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
        phase1_s=t_phase1,
        phase2_s=time.time() - t_phase2,
        hinv=hinv,
    )
