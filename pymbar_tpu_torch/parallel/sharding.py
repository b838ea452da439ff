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

Bootstrap replicates ride the sharded planes as counts-weighted polishes
(:func:`sharded_bootstrap_polish_dd`): each shard holds its columns' counts
(0 on pad columns), so no resampled matrix exists and no sample crosses
devices.  Not ported here: the 2-D k x n mesh (``mesh_2d``, ``sharded2d_*``).
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
from pymbar_tpu_torch.solvers import (
    _adaptive_metrics,
    _adaptive_stop,
    _newton_direction,
    host_adaptive_metrics,
    target_device,
)
from pymbar_tpu_torch.solvers_large import (
    _batch_chunk_width,
    _batch_group_size,
    _batch_loop_from_S_fn,
    _batched_wsum_S,
    _boot_info,
    _coarse_stride,
    _counts_upload_dtype,
    _materialize_th,
    _newton_factor,
    _polish_loop,
    _use_resident_th,
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
    "sharded_bootstrap_polish_dd",
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
        f_old = f
        f = f_sci if take_sci else f_nr
        sci_iter += int(take_sci)
        max_delta, max_diff = _adaptive_metrics(f, f_old, f_sci, f_nr, tol)
        if bool(_adaptive_stop(max_delta, max_diff, tol)):
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


def _sharded_gram(u_hi_s, N_k32, f32_val, mesh, c=None):
    """float32 Gram of n-sharded hi planes: per-shard f32 products with f64
    accumulation (:func:`gram_f32_acc64`, pad columns weigh 0), combined:
    (W diag(c) W^T, sum_n c_n W_nk) in float64.  ``c`` optionally holds
    per-shard (N_local,) float32 counts (a bootstrap replicate's Gram, the
    fresh factor of its retry); without it c_n = 1."""
    cs = [None] * len(mesh.devices) if c is None else c
    grams, colsums = [], []
    for u, cc, dev in zip(u_hi_s, cs, mesh.devices):
        gram, colsum = gram_f32_acc64(u, N_k32.to(dev), f32_val.to(dev), cc)
        grams.append(gram)
        colsums.append(colsum)
    return _psum(grams, mesh), _psum(colsums, mesh)


def _sharded_polish_dd(u_hi_s, u_lo_s, N_k64, f0, hinv, logN, tol, gamma, mesh, maxiter,
                       c=None):
    """The n-sharded dd chord-Newton polish: the single-device polish loop
    (:func:`pymbar_tpu_torch.solvers_large._polish_loop`) with one
    :func:`sharded_wsum_dd` per iteration.  ``c`` optionally holds a
    bootstrap replicate's per-shard float32 counts (0 on pad columns), which
    weigh every K1 pass."""

    def wsum(uh, ul, gh, gl):
        return sharded_wsum_dd(uh, ul, gh, gl, mesh, c=c)

    return _polish_loop(wsum, u_hi_s, u_lo_s, N_k64, f0, hinv, logN, tol, gamma, maxiter)


def _sharded_materialize_th(u_hi_s, u_lo_s, g0h, g0l, mesh, n_chunk):
    """Each shard's base-point fast plane
    (:func:`pymbar_tpu_torch.solvers_large._materialize_th`): the column
    stabilizer is column-local and K unsharded, so no communication; the
    result shards like the planes."""
    return [
        _materialize_th(uh, ul, g0h.to(dev), g0l.to(dev), n_chunk)
        for uh, ul, dev in zip(u_hi_s, u_lo_s, mesh.devices)
    ]


def _sharded_batch_S_fn(u_hi_s, u_lo_s, C_s, mesh, n_chunk, th_s=None):
    """The batched engines' weight-sum pass over n-sharded planes:
    :func:`_batched_wsum_S` on every shard, the (B, K) partials psummed.
    The denominators are shard-local (K is unsharded) and zero-count pad
    columns add exactly 0.  ``C_s``: per-shard (B, N_local) counts;
    ``th_s``: per-shard resident fast planes or None."""
    ths = [None] * len(mesh.devices) if th_s is None else th_s

    def S_fn(g0h, g0l, R, exact):
        parts = [
            _batched_wsum_S(uh, ul, g0h.to(dev), g0l.to(dev), R.to(dev), C, n_chunk, exact, th=th)
            for uh, ul, C, th, dev in zip(u_hi_s, u_lo_s, C_s, ths, mesh.devices)
        ]
        return _psum(parts, mesh)

    return S_fn


def _sharded_polish_dd_batch(u_hi_s, u_lo_s, C_s, N_k64, f0, hinv, tol, gamma, mesh, maxiter,
                             n_chunk, th_s=None):
    """All replicates of a group batched on the n-sharded planes: the
    single-card engine's two-phase loop
    (:func:`pymbar_tpu_torch.solvers_large._batch_loop_from_S_fn`) over
    :func:`_sharded_batch_S_fn`, one psum of the (B, K) sums per
    iteration.  Returns (F, iters, deltas, converged, at_floor)."""
    S_fn = _sharded_batch_S_fn(u_hi_s, u_lo_s, C_s, mesh, n_chunk, th_s)
    return _batch_loop_from_S_fn(S_fn, C_s[0].shape[0], N_k64, f0, hinv, tol, gamma, maxiter)


def _shards_per_card(mesh):
    """The largest number of shards that share one device."""
    return max(mesh.devices.count(d) for d in set(mesh.devices))


def sharded_bootstrap_polish_dd(
    u_hi_s,
    u_lo_s,
    N_k,
    f_k,
    hinv,
    counts,
    mesh,
    tol=1.0e-12,
    maxiter=16,
    gamma=1.0,
    verbose=False,
    mode="batched",
):
    """Solve B bootstrap replicates on the resident n-sharded dd planes.

    The mesh twin of
    :func:`pymbar_tpu_torch.solvers_large.bootstrap_polish_dd` and the
    counterpart of the JAX package's ``sharded_bootstrap_polish_dd`` (minus
    its TPU knob ``fast_exp``).  ``u_hi_s``/``u_lo_s``: the shards of
    :func:`shard_dd_planes`; ``counts``: (B, N) numpy resample
    multiplicities over the N real samples, which each shard receives for
    its own columns (0 on pad columns).  ``mode="batched"`` (default)
    advances every replicate of a group per iteration from one shared exp
    stream of each shard and one psum of the (B, K) sums
    (:func:`_sharded_polish_dd_batch`); the groups, the uint8 count upload
    and the resident fast plane are budgeted per device, over the shards
    that share it.  A replicate that does not converge retries once with a
    fresh counts-weighted factor (:func:`_sharded_gram` with counts) and
    one more counts-weighted polish (:func:`_sharded_polish_dd` with counts: one K1
    launch per shard per iteration).  ``mode="serial"`` polishes each
    replicate in turn that way, from the base factor ``hinv``.

    Returns (f_boots (B, K) float64 ndarray, n_fail, info): ``info`` as the
    single-card engine's (``at_floor``, ``n_at_floor``,
    ``n_tol_converged``); the serial mode adds ``polish_iterations`` (B,),
    K1 passes of the mesh each, and the batched mode ``exact_iters`` (B,),
    the exact-phase iterations of each replicate.  Given the same base f_k,
    factor and counts, both stop each replicate as the single-card engine
    does (the same rules on the same deltas, to rounding).
    """
    dev0 = mesh.devices[0]
    counts = np.asarray(counts)
    B, N = counts.shape
    K = u_hi_s[0].shape[0]
    w = u_hi_s[0].shape[1]
    N_k64 = _vec(np.asarray(N_k, dtype=np.float64), torch.float64, dev0)
    N_k32 = N_k64.to(torch.float32)
    logN = torch.log(N_k64)
    f0 = _vec(np.array(f_k, dtype=np.float64), torch.float64, dev0)
    f0 = f0 - f0[0]
    hinv = _vec(hinv if torch.is_tensor(hinv) else np.array(hinv), torch.float64, dev0)

    def count_shards(c_rows, dtype):
        return _split_columns(torch.as_tensor(np.ascontiguousarray(c_rows, dtype=dtype)),
                              mesh, 0)[0]

    def retry(c_s, f_b):
        gram_b, colsum_b = _sharded_gram(u_hi_s, N_k32, f_b.to(torch.float32), mesh, c=c_s)
        hinv_b = _newton_factor(gram_b, colsum_b, N_k64)
        return polish_to_host(_sharded_polish_dd(
            u_hi_s, u_lo_s, N_k64, f_b, hinv_b, logN, tol, gamma, mesh, maxiter, c=c_s))

    f_boots = np.zeros((B, K))
    at_floor = np.zeros(B, bool)
    n_fail = 0
    if mode == "serial":
        iterations = np.zeros(B, np.int64)
        for b in range(B):
            c_s = count_shards(counts[b], np.float32)
            f_b, iterations[b], _g, _d, converged, floor_b = polish_to_host(_sharded_polish_dd(
                u_hi_s, u_lo_s, N_k64, f0, hinv, logN, tol, gamma, mesh, maxiter, c=c_s))
            if not converged:
                f_b, it2, _g, _d, converged, floor_b = retry(c_s, f_b)
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
        raise ValueError(f"sharded_bootstrap_polish_dd: unknown mode {mode!r}")

    # budgets per device: the columns of every shard that shares it
    cols_per_card = w * _shards_per_card(mesh)
    n_chunk = _batch_chunk_width(K, w)
    group = _batch_group_size(B, cols_per_card)
    th_s = None
    if _use_resident_th(K, cols_per_card):
        g0h, g0l = dd_from_f64(f0 + logN)
        th_s = _sharded_materialize_th(u_hi_s, u_lo_s, g0h, g0l, mesh, n_chunk)
    up_dtype = _counts_upload_dtype(counts)
    retry_rows = []
    exact_iters = np.zeros(B, np.int32)
    for s in range(0, B, group):
        e = min(B, s + group)
        C_s = count_shards(counts[s:e], up_dtype)
        F, iters, _deltas, conv, floor = _sharded_polish_dd_batch(
            u_hi_s, u_lo_s, C_s, N_k64, f0, hinv, tol, gamma, mesh, maxiter, n_chunk, th_s=th_s)
        f_boots[s:e] = F.cpu().numpy()
        at_floor[s:e] = floor.cpu().numpy()
        exact_iters[s:e] = iters.cpu().numpy()
        retry_rows.extend(s + i for i in np.nonzero(~conv.cpu().numpy())[0])
        del C_s
        if verbose:
            logger.info(f"Calculated {e:d}/{B:d} bootstrap samples (batched)")
    del th_s  # release the fast-plane shards before the retries
    for b in retry_rows:
        c_s = count_shards(counts[b], np.float32)
        f_b, _it, _g, _d, converged, floor_b = retry(
            c_s, torch.as_tensor(f_boots[b], device=dev0))
        at_floor[b] = converged and floor_b
        n_fail += not converged
        f_boots[b] = f_b.cpu().numpy()
    info = _boot_info(at_floor, B, n_fail)
    info["exact_iters"] = exact_iters
    return f_boots, n_fail, info


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
    return_state=False,
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
    samples.  Returns (f_k float64 ndarray, info dict); with
    ``return_state`` the info also holds ``planes``, the (hi, lo) shard
    lists, for follow-on solves on the same data (bootstrap replicates).
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
    if return_state:
        info["planes"] = (u_hi_s, u_lo_s)
    return f64.cpu().numpy(), info


def sharded_solve_mbar_for_all_states(
    u_kn, N_k, f_k, states_with_samples, mesh=None, tol=1.0e-12, bootstrap_counts=None,
    verbose=False,
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

    With ``bootstrap_counts`` (a (B, N) resample-multiplicity matrix; every
    state must have samples, else ValueError) the B replicates are also
    solved on the same sharded planes from the base solution and its chord
    factor (:func:`sharded_bootstrap_polish_dd`), and the return is (f_k,
    results, f_boots (B, K), n_fail, info); the JAX package returns (f_k,
    f_boots, n_fail, info).
    """
    if mesh is None:
        mesh = default_mesh()
    u = _as_tensor(u_kn, torch.float64)
    N_k = np.asarray(N_k, dtype=np.float64)
    f_k = np.array(f_k, dtype=np.float64, copy=True)
    sws = np.asarray(states_with_samples)
    if bootstrap_counts is not None and len(sws) < len(N_k):
        raise ValueError(
            "bootstrap_counts requires every state to have samples (MBAR "
            "solves the replicates of a problem with an empty state one by "
            "one, or batched on the card)"
        )

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
            uh, ul, N_k[sws], f_k=f_k[sws] - f_k[sws][0], mesh=mesh, tol=tol,
            return_state=bootstrap_counts is not None,
        )
        del uh, ul
        if not info["converged"]:
            logger.warning(
                "sharded MBAR solve did not converge to within tolerance "
                f"(gnorm={info['gnorm']:.3e})"
            )
        f_k[sws] = f_sub
        if bootstrap_counts is not None:
            u_hi_s, u_lo_s = info.pop("planes")
            f_boots, n_fail, boot_info = sharded_bootstrap_polish_dd(
                u_hi_s, u_lo_s, N_k, f_sub, info["hinv"], bootstrap_counts, mesh, tol=tol,
                verbose=verbose,
            )
            del u_hi_s, u_lo_s
            results = [dict(x=f_sub, success=bool(info["converged"]), info=info)]
            return f_k - f_k[0], results, f_boots, n_fail, boot_info
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
