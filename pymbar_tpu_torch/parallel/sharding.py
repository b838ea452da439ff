"""Sample-axis (1-D mesh) sharding of the MBAR solve.

The counterpart of the 1-D part of :mod:`pymbar_tpu.parallel.sharding`.
The MBAR math is map-reduce over the sample axis n: the per-sample
log-denominators need no communication, and every per-state reduction
(logsumexp over n, W W^T, sum_n W, the polish's weight sums) finishes with
one combine of K-sized partials.  Only K-sized vectors cross devices.

The JAX package's mesh is single-controller, and so is this one: one
process drives every device.  A :class:`Mesh` is an ordered tuple of
``torch.device``s, possibly the same device several times (P shards on one
card, or on the CPU as the tests do).  A sharded matrix is the list of its
per-device column shards, padded to a multiple of the mesh size, plus the
pad count.  Each function launches every shard's work before anything
waits on a result, then the collectives (:func:`_psum`, :func:`_pmax`)
bring each shard's partial to the mesh's first device and combine them
there in mesh order, so the result is the same bits on every run.  K-sized
results live on that first device.  The functions take no ``axis_name``:
the JAX package's shard_map needs one, a 1-D :class:`Mesh` carries its own.

Not ported here: the 2-D k x n mesh (``mesh_2d``, ``sharded2d_*``) and the
mesh bootstrap (``sharded_bootstrap_polish_dd``).
"""

import dataclasses
import logging
import time

import numpy as np
import torch

from pymbar_tpu_torch.ops.doubledouble import dd_from_f64, dd_to_f64
from pymbar_tpu_torch.ops.lognum import lognum_fused_dd
from pymbar_tpu_torch.ops.mbar_core import (
    _PAD_THRESHOLD,
    _col_chunks,
    _matmul,
    _weights,
    gram_f32_acc64,
    log_denominator_n,
)
from pymbar_tpu_torch.ops.wsum import wsum_dd
from pymbar_tpu_torch.solvers import _newton_direction, host_adaptive_metrics, target_device
from pymbar_tpu_torch.solvers_large import (
    _coarse_stride,
    _newton_factor,
    _polish_loop,
    dev_split_planes,
    polish_to_host,
)

logger = logging.getLogger(__name__)

__all__ = [
    "Mesh",
    "default_mesh",
    "shard_u_kn",
    "sharded_log_denominator",
    "sharded_core_stats",
    "sharded_gram",
    "sharded_adaptive_step",
    "sharded_solve_mbar",
    "shard_dd_planes",
    "sharded_fused_lognum_dd",
    "sharded_wsum_dd",
    "sharded_solve_mbar_dd",
    "sharded_solve_mbar_for_all_states",
]

# The finite sentinel potential of a double-word pad column (+inf cannot be
# split into float32 words); the kernels drop such columns.
_PAD_U = 1.0e10


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D device mesh: the devices that hold the sample shards, in order."""

    devices: tuple
    axis_name: str = "n"


def default_mesh(n_devices=None, axis_name="n", device=None):
    """1-D mesh for sample-axis sharding.

    With no ``device``, every visible CUDA card (the first ``n_devices`` of
    them when given); without a card this raises, naming ``device="cpu"``.
    With ``device``, ``n_devices`` shards (default 1) on that one device:
    ``device="cpu"`` for CPU shards, ``"cuda:0"`` for several shards on one
    card.
    """
    if device is None:
        target_device()  # raises without a card
        devices = tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
        devices = devices[:n_devices]
    else:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        devices = (dev,) * (1 if n_devices is None else n_devices)
    if not devices:
        raise ValueError(f"default_mesh: no devices (n_devices={n_devices})")
    return Mesh(devices, axis_name)


def _sync(mesh):
    for dev in set(mesh.devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _as_tensor(x, dtype):
    """A tensor as given (cast to ``dtype``), numpy as a CPU tensor."""
    if torch.is_tensor(x):
        return x.to(dtype)
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def _split_columns(x, mesh, pad_value):
    """Column shards of a (K, N) or (N,) tensor, one per mesh device.

    N is padded to a multiple of the mesh size with ``pad_value``; shard i
    holds padded columns [i w, (i + 1) w) as a contiguous tensor on device
    i.  One shard on x's own device is x itself.  Returns (shards, n_pad).
    """
    P = len(mesh.devices)
    N = x.shape[-1]
    n_pad = (-N) % P
    w = (N + n_pad) // P
    shards = []
    for i, dev in enumerate(mesh.devices):
        s, e = min(N, i * w), min(N, (i + 1) * w)
        part = x[..., s:e]
        if e - s < w:
            fill = torch.full((*x.shape[:-1], w - (e - s)), pad_value, dtype=x.dtype,
                              device=x.device)
            part = torch.cat([part, fill], dim=-1)
        shards.append(part.contiguous().to(dev))
    return shards, n_pad


def _psum(parts, mesh):
    """Sum of per-shard partials on the first device, in mesh order."""
    dev0 = mesh.devices[0]
    acc = parts[0].to(dev0)
    for p in parts[1:]:
        acc = acc + p.to(dev0)
    return acc


def _pmax(parts, mesh):
    """Elementwise max of per-shard partials on the first device."""
    dev0 = mesh.devices[0]
    acc = parts[0].to(dev0)
    for p in parts[1:]:
        acc = torch.maximum(acc, p.to(dev0))
    return acc


def _vec(x, dtype, dev):
    """A K-vector (numpy or tensor) as ``dtype`` on ``dev``."""
    if torch.is_tensor(x):
        return x.to(device=dev, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)


def shard_u_kn(u_kn, mesh):
    """u_kn (numpy or tensor) with its sample axis split over the mesh.

    Pads n up to a multiple of the mesh size with +inf columns: exp(-inf)
    adds exactly 0 to every reduction.  Returns (shards, n_pad).
    """
    return _split_columns(_as_tensor(u_kn, torch.float64), mesh, float("inf"))


def _is_pad_col(u_local):
    """Pad-column mask, a whole-column test through the column min.

    float64 inputs (the user's u_kn, +inf pads): only a whole +inf column is
    padding, so a column huge in every state is kept and a NaN propagates.
    float32 hi planes (finite ~1e10 sentinels on preconditioned potentials,
    real columns at col_min ~ 0): col_min >= 5e9, or not finite.
    """
    col_min = u_local.amin(dim=0)
    if u_local.dtype == torch.float64:
        return col_min == torch.inf
    return ~torch.isfinite(col_min) | (col_min >= _PAD_THRESHOLD)


def _local_logden(u, N_k, f_k):
    """One shard's log-denominators; pad columns give 0."""
    return log_denominator_n(u, N_k, f_k).masked_fill_(_is_pad_col(u), 0.0)


def sharded_log_denominator(u_kn_sharded, N_k, f_k, mesh):
    """Per-sample log-normalizer, one (N_local,) tensor per shard.

    No collective: each device reduces its own K x N_local slab along K;
    pad columns give 0.
    """
    dt = u_kn_sharded[0].dtype
    return [
        _local_logden(u, _vec(N_k, dt, dev), _vec(f_k, dt, dev))
        for u, dev in zip(u_kn_sharded, mesh.devices)
    ]


def sharded_core_stats(u_kn_sharded, N_k, f_k, mesh):
    """(objective, gradient, f_sci) with the per-state reductions combined
    over the mesh: the logsumexp over n takes a pmax of the per-shard
    maxima, then a psum of the sums rescaled by it."""
    dev0 = mesh.devices[0]
    dt = u_kn_sharded[0].dtype
    N0, f0 = _vec(N_k, dt, dev0), _vec(f_k, dt, dev0)
    lds, obj_parts, max_parts = [], [], []
    for u, dev in zip(u_kn_sharded, mesh.devices):
        ld = _local_logden(u, N0.to(dev), f0.to(dev))
        b_max = torch.full((u.shape[0],), -torch.inf, dtype=dt, device=dev)
        for s, e in _col_chunks(u):
            b_max = torch.maximum(b_max, (-ld[None, s:e] - u[:, s:e]).amax(dim=1))
        lds.append(ld)
        obj_parts.append(ld.sum())
        max_parts.append(b_max)
    b_max = _pmax(max_parts, mesh)
    b_max = torch.where(torch.isfinite(b_max), b_max, 0.0)
    sum_parts = []
    for u, ld, dev in zip(u_kn_sharded, lds, mesh.devices):
        shift = b_max.to(dev)[:, None]
        s = torch.zeros(u.shape[0], dtype=dt, device=dev)
        for c0, c1 in _col_chunks(u):
            s += (-ld[None, c0:c1] - u[:, c0:c1]).sub_(shift).exp_().sum(dim=1)
        sum_parts.append(s)
    lognum = torch.log(_psum(sum_parts, mesh)) + b_max
    obj = _psum(obj_parts, mesh) - torch.dot(N0, f0)
    grad = -N0 * (1.0 - torch.exp(f0 + lognum))
    return obj, grad, -lognum


def sharded_gram(u_kn_sharded, N_k, f_k, mesh):
    """(W^T W, colsum W) from per-shard K x K partial Grams, psum-combined.

    The N x K weight matrix never exists: each shard streams its weights in
    column chunks.  The products run in u's dtype with TF32 refused (the JAX
    package's TPU ``precision`` knob has no counterpart).
    """
    dt = u_kn_sharded[0].dtype
    K = u_kn_sharded[0].shape[0]
    grams, colsums = [], []
    for u, dev in zip(u_kn_sharded, mesh.devices):
        fk = _vec(f_k, dt, dev)
        ld = _local_logden(u, _vec(N_k, dt, dev), fk)
        gram = torch.zeros((K, K), dtype=dt, device=dev)
        colsum = torch.zeros(K, dtype=dt, device=dev)
        for s, e in _col_chunks(u):
            w = _weights(u[:, s:e], fk, ld[s:e])
            gram += _matmul(w, w.T)
            colsum += w.sum(dim=1)
        grams.append(gram)
        colsums.append(colsum)
    return _psum(grams, mesh), _psum(colsums, mesh)


def sharded_adaptive_step(u_kn_sharded, N_k, f_k, gamma, mesh, nr_method="lstsq"):
    """One adaptive iteration's candidates on the sharded problem:
    (f_sci, g_sci, |g_sci|^2, f_nr, g_nr, |g_nr|^2).  nr_method "lstsq" is
    the reference Newton step, "chol" the reduced system by Cholesky."""
    _, g, f_sci = sharded_core_stats(u_kn_sharded, N_k, f_k, mesh)
    gram, colsum = sharded_gram(u_kn_sharded, N_k, f_k, mesh)
    N = _vec(N_k, g.dtype, g.device)
    f = _vec(f_k, g.dtype, g.device)
    H = -(gram * N[None, :] * N[:, None] - torch.diag(colsum * N))
    f_nr = f - gamma * _newton_direction(H, g, nr_method)
    f_sci = f_sci - f_sci[0]
    _, g_sci, _ = sharded_core_stats(u_kn_sharded, N_k, f_sci, mesh)
    _, g_nr, _ = sharded_core_stats(u_kn_sharded, N_k, f_nr, mesh)
    return f_sci, g_sci, torch.dot(g_sci, g_sci), f_nr, g_nr, torch.dot(g_nr, g_nr)


def _precondition(u, N_k, f_k, c_shift):
    """u - min_k u + (logden - c_shift) per sample, into a new tensor; +inf
    pad columns stay +inf (the JAX package's in-place form turns them into
    NaN)."""
    out = torch.empty_like(u)
    for s, e in _col_chunks(u):
        sl = u[:, s:e]
        col_min = sl.amin(dim=0)
        sl = sl - torch.where(torch.isinf(col_min), 0.0, col_min)[None, :]
        out[:, s:e] = sl.add_((_local_logden(sl, N_k, f_k) - c_shift)[None, :])
    return out


def sharded_solve_mbar(
    u_kn, N_k, f_k=None, mesh=None, tol=1.0e-12, maxiter=10000, min_sc_iter=2, gamma=1.0
):
    """Full adaptive MBAR solve with u_kn (float64) sharded along n.

    A host loop of :func:`sharded_adaptive_step`, one sync per iteration.
    All states must have samples.  Returns (f_k ndarray, info dict with
    success, iterations, max_delta, gnorm).
    """
    if mesh is None:
        mesh = default_mesh()
    dev0 = mesh.devices[0]
    N_k = np.asarray(N_k, dtype=np.float64)
    u_sh, _ = shard_u_kn(u_kn, mesh)
    K = u_sh[0].shape[0]
    f_k = np.zeros(K) if f_k is None else np.asarray(f_k, dtype=np.float64)
    f_k = f_k - f_k[0]
    c_shift = float(np.dot(N_k, f_k) / N_k.sum())
    u_sh = [
        _precondition(u, _vec(N_k, u.dtype, dev), _vec(f_k, u.dtype, dev), c_shift)
        for u, dev in zip(u_sh, mesh.devices)
    ]
    f = _vec(f_k, torch.float64, dev0)

    sci_iter = 0
    converged = False
    it = 0
    max_delta = np.inf
    for it in range(1, maxiter + 1):
        f_sci, _, gn_sci, f_nr, _, gn_nr = sharded_adaptive_step(u_sh, N_k, f, gamma, mesh)
        take_sci = bool(gn_sci < gn_nr) or sci_iter < min_sc_iter
        f_old = f.cpu().numpy()
        f = f_sci if take_sci else f_nr
        sci_iter += int(take_sci)
        max_delta, max_diff = host_adaptive_metrics(
            f.cpu().numpy(), f_old, f_sci.cpu().numpy(), f_nr.cpu().numpy(), tol
        )
        if np.isnan(max_delta) or (max_delta < tol and max_diff < np.sqrt(tol)):
            converged = True
            break

    _, g, _ = sharded_core_stats(u_sh, N_k, f, mesh)
    return f.cpu().numpy(), dict(
        success=converged, iterations=it, max_delta=float(max_delta),
        gnorm=float(torch.linalg.norm(g)),
    )


# ---------------------------------------------------------------------------
# Double-word (two-float32) sharded solve
# ---------------------------------------------------------------------------


def shard_dd_planes(u_hi, u_lo, mesh):
    """Double-word (hi, lo) planes (numpy or float32 tensors) split along n.

    Pads n to a multiple of the mesh size with sentinel columns (hi +1e10,
    lo 0), which the dd kernels drop.  Returns (hi_shards, lo_shards, n_pad).
    """
    hi, n_pad = _split_columns(_as_tensor(u_hi, torch.float32), mesh, _PAD_U)
    lo, _ = _split_columns(_as_tensor(u_lo, torch.float32), mesh, 0.0)
    return hi, lo, n_pad


def _dd_combine_partials(parts, mesh):
    """Per-shard (hi, lo) partial sums merged in f64 on the first device, in
    mesh order.  Returns the float64 sum."""
    return _psum([dd_to_f64(h, l) for h, l in parts], mesh)


def sharded_fused_lognum_dd(u_hi_s, u_lo_s, g_hi, g_lo, m_k, mesh):
    """lognum over n-sharded dd planes: K5 per shard, f64 merge, one log.

    Each shard runs :func:`~pymbar_tpu_torch.ops.lognum.lognum_fused_dd`
    with ``return_sums``; the (K,) partials merge in f64 and
    ln_k = log s_k + m_k.  g_hi/g_lo/m_k: (K,) float32 tensors.  Returns
    (ln_hi, ln_lo), (K,) float32 on the first device.
    """
    parts = [
        lognum_fused_dd(uh, ul, g_hi.to(dev), g_lo.to(dev), m_k.to(dev), return_sums=True)
        for uh, ul, dev in zip(u_hi_s, u_lo_s, mesh.devices)
    ]
    S = _dd_combine_partials(parts, mesh)
    return dd_from_f64(torch.log(S) + m_k.to(S.device, torch.float64))


def sharded_wsum_dd(u_hi_s, u_lo_s, g_hi, g_lo, mesh, c=None):
    """S_k = sum_n c_n N_k W_nk over n-sharded dd planes: K1 (``wsum_dd``)
    per shard, the (K,) partials merged in f64.  ``c`` optionally holds
    per-sample counts as per-shard (N_local,) float32 tensors, split like
    the planes (0 on pad columns).  Returns (S_hi, S_lo) on the first device.
    """
    cs = [None] * len(mesh.devices) if c is None else c
    parts = [
        wsum_dd(uh, ul, g_hi.to(dev), g_lo.to(dev), cc)
        for uh, ul, cc, dev in zip(u_hi_s, u_lo_s, cs, mesh.devices)
    ]
    return dd_from_f64(_dd_combine_partials(parts, mesh))


def _sharded_gram(u_hi_s, N_k32, f32_val, mesh):
    """float32 Gram of n-sharded hi planes: per-shard f32 products with f64
    accumulation (:func:`gram_f32_acc64`, pad columns weigh 0), combined:
    (W W^T, sum_n W_nk) in float64."""
    grams, colsums = [], []
    for u, dev in zip(u_hi_s, mesh.devices):
        gram, colsum = gram_f32_acc64(u, N_k32.to(dev), f32_val.to(dev))
        grams.append(gram)
        colsums.append(colsum)
    return _psum(grams, mesh), _psum(colsums, mesh)


def _sharded_polish_dd(u_hi_s, u_lo_s, N_k64, f0, hinv, logN, tol, gamma, mesh, maxiter):
    """The n-sharded dd chord-Newton polish: the single-device polish loop
    (:func:`pymbar_tpu_torch.solvers_large._polish_loop`) with one
    :func:`sharded_wsum_dd` per iteration."""

    def wsum(uh, ul, gh, gl):
        return sharded_wsum_dd(uh, ul, gh, gl, mesh)

    return _polish_loop(wsum, u_hi_s, u_lo_s, N_k64, f0, hinv, logN, tol, gamma, maxiter)


def _strided_shards(u_s, mesh, stride):
    """Each shard's columns whose global (padded) index is a multiple of
    ``stride``: the sharded form of the global ``u[:, ::stride]``."""
    sub, start = [], 0
    for u in u_s:
        sub.append(u[:, (-start) % stride :: stride].contiguous())
        start += u.shape[1]
    return sub


def sharded_solve_mbar_dd(
    u_hi,
    u_lo,
    N_k,
    f_k=None,
    mesh=None,
    tol=1.0e-12,
    f32_tol=1.0e-4,
    f32_maxiter=40,
    polish_maxiter=12,
    gamma=1.0,
):
    """Double-word MBAR solve with the planes sharded along n.

    The sharded counterpart of
    :func:`pymbar_tpu_torch.solvers_large.solve_mbar_dd`, with the JAX
    package's sharded phases: a host-orchestrated float32 adaptive loop of
    :func:`sharded_adaptive_step` ("chol", 'mixed' metric) on the sharded hi
    plane, or for large problems on its global 1/stride subsample (which
    also gives the chord factor); then the dd chord-Newton polish, one K1
    pass per shard per iteration with the K-sized partials merged in f64;
    then, if the subsample factor failed to contract, a full-plane float32
    phase, a fresh factor and one more polish.  The caller supplies
    preconditioned (hi, lo) planes (numpy or float32 tensors; they are
    copied shard by shard to the mesh devices).  All states must have
    samples.  Returns (f_k float64 ndarray, info dict).
    """
    if mesh is None:
        mesh = default_mesh()
    dev0 = mesh.devices[0]
    K = u_hi.shape[0]
    N_k_host = np.asarray(N_k, dtype=np.int64)
    N_real = int(N_k_host.sum())
    N_k64 = _vec(np.asarray(N_k, dtype=np.float64), torch.float64, dev0)
    N_k32 = N_k64.to(torch.float32)
    f64 = torch.zeros(K, dtype=torch.float64, device=dev0)
    if f_k is not None:
        f64 = _vec(np.asarray(f_k, dtype=np.float64), torch.float64, dev0)
    f64 = f64 - f64[0]

    u_hi_s, u_lo_s, _ = shard_dd_planes(u_hi, u_lo, mesh)

    def f32_adaptive(u_s, N32, f_start):
        """Host-orchestrated float32 adaptive loop on sharded hi planes."""
        f = f_start
        sci_iter = its = 0
        for its in range(1, f32_maxiter + 1):
            f_sci, _, gn_sci, f_nr, _, gn_nr = sharded_adaptive_step(
                u_s, N32, f, gamma, mesh, nr_method="chol"
            )
            take_sci = bool(gn_sci < gn_nr) or sci_iter < 2
            f_old = f.cpu().numpy()
            f = f_sci if take_sci else f_nr
            sci_iter += int(take_sci)
            max_delta, _ = host_adaptive_metrics(
                f.cpu().numpy(), f_old, f_sci.cpu().numpy(), f_nr.cpu().numpy(), f32_tol,
                delta_mode="mixed",
            )
            if max_delta < f32_tol:
                break
        return f, its

    def to_f64(f32):
        f = f32.to(torch.float64)
        return f - f[0]

    _sync(mesh)
    t_phase1 = time.time()
    # ---- phase 1: float32 adaptive warm start.  Large problems solve the
    # global every-stride-th column subsample (a consistent MBAR estimate
    # ~1e-2 from the full solution) and take the polish's chord factor from
    # its Gram (gram_full ~ gram_sub / ratio).
    hinv = None
    it32 = it32_coarse = 0
    stride = _coarse_stride(N_k_host, K * N_real)
    if stride:
        sub = _strided_shards(u_hi_s, mesh, stride)
        # per-state counts of the global stride multiples in each contiguous
        # state block (the plane's pad columns lie past N_real: masked)
        starts = np.concatenate([[0], np.cumsum(N_k_host)])
        N_k_sub = np.diff(-(-starts // stride))
        N_sub32 = _vec(N_k_sub, torch.float32, dev0)
        f32c, it32_coarse = f32_adaptive(sub, N_sub32, f64.to(torch.float32))
        f64 = to_f64(f32c)
        gram_s, colsum_s = _sharded_gram(sub, N_sub32, f32c, mesh)
        hinv = _newton_factor(gram_s / (N_real / float(N_k_sub.sum())), colsum_s, N_k64)
        del sub
    else:
        f32_out, it32 = f32_adaptive(u_hi_s, N_k32, f64.to(torch.float32))
        f64 = to_f64(f32_out)
    _sync(mesh)
    t_phase1 = time.time() - t_phase1

    # ---- phase 2: the dd polish, its chord factor from the full sharded
    # Gram when no coarse phase gave one.
    t_phase2 = time.time()
    if hinv is None:
        gram, colsum = _sharded_gram(u_hi_s, N_k32, f64.to(torch.float32), mesh)
        hinv = _newton_factor(gram, colsum, N_k64)
    logN = torch.log(N_k64)

    def run_polish(f_start):
        return polish_to_host(_sharded_polish_dd(
            u_hi_s, u_lo_s, N_k64, f_start, hinv, logN, tol, gamma, mesh, polish_maxiter
        ))

    f64, it, g64, deltas, converged, at_noise_floor = run_polish(f64)

    if not converged and it32_coarse:
        # The subsample factor failed to contract the polish (rare): the
        # full-plane float32 phase, a fresh factor and one more polish.
        f32_out, it32 = f32_adaptive(u_hi_s, N_k32, f64.to(torch.float32))
        f64 = to_f64(f32_out)
        gram, colsum = _sharded_gram(u_hi_s, N_k32, f64.to(torch.float32), mesh)
        hinv = _newton_factor(gram, colsum, N_k64)
        f64, it2, g64, deltas2, converged, at_noise_floor = run_polish(f64)
        deltas += deltas2
        it += it2

    gnorm = float(torch.linalg.norm(g64)) if it else np.nan
    info = dict(
        converged=converged,
        at_noise_floor=at_noise_floor,
        f32_iterations=int(it32),
        f32_coarse_iterations=int(it32_coarse),
        polish_iterations=it,
        deltas=deltas,
        gnorm=gnorm,
        phase1_s=t_phase1,
        phase2_s=time.time() - t_phase2,
        hinv=hinv,
    )
    return f64.cpu().numpy(), info


def sharded_solve_mbar_for_all_states(
    u_kn, N_k, f_k, states_with_samples, mesh=None, tol=1.0e-12
):
    """The sharded counterpart of ``solve_mbar_for_all_states``, the MBAR
    class's mesh front door.

    Solves the sampled states by :func:`sharded_solve_mbar_dd` on the dd
    split of a private copy of their rows (min-shifted in place, and freed
    once split), then fills empty states with one self-consistent update
    over all K states on the +inf-padded float64 u_kn, and re-pins f_0 = 0.
    ``u_kn``: float64 tensor (split on its own device, the shards copied to
    the mesh) or numpy (split on the host).  Returns (f_k ndarray, list of
    the solve's result dict), as the port's single-device front door; the
    JAX package returns f_k alone.
    """
    if mesh is None:
        mesh = default_mesh()
    u = _as_tensor(u_kn, torch.float64)
    N_k = np.asarray(N_k, dtype=np.float64)
    f_k = np.array(f_k, dtype=np.float64, copy=True)
    sws = np.asarray(states_with_samples)

    results = []
    if len(sws) > 1:
        u_sub = u.index_select(0, torch.as_tensor(sws, device=u.device))
        # Per-sample shift (the MBAR equations are invariant under it) so the
        # dd split sees small values; in place on the private copy, so no
        # second K x N temporary exists.
        u_sub -= u_sub.amin(dim=0)[None, :]
        uh, ul = dev_split_planes(u_sub)
        del u_sub
        f_sub, info = sharded_solve_mbar_dd(
            uh, ul, N_k[sws], f_k=f_k[sws] - f_k[sws][0], mesh=mesh, tol=tol
        )
        del uh, ul
        if not info["converged"]:
            logger.warning(
                "sharded MBAR solve did not converge to within tolerance "
                f"(gnorm={info['gnorm']:.3e})"
            )
        f_k[sws] = f_sub
        results = [dict(x=f_sub, success=bool(info["converged"]), info=info)]
    else:
        f_k[sws] = 0.0

    if len(sws) < len(N_k):
        # Empty-state fill: one SC update over all K states (empty states
        # carry N_k = 0 and drop out of the denominator exactly).
        u_all, _ = shard_u_kn(u, mesh)
        _, _, f_sci = sharded_core_stats(u_all, N_k, f_k, mesh)
        f_k = f_sci.cpu().numpy()
    return f_k - f_k[0], results
