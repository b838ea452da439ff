"""Sharding of the MBAR solve over a 1-D (sample) or 2-D (state x sample) mesh.

The counterpart of :mod:`pymbar_tpu.parallel.sharding`.  The MBAR math is
map-reduce over the sample axis n: the per-sample log-denominators need no
communication, and every per-state reduction (logsumexp over n, W W^T,
sum_n W, the polish's weight sums) finishes with one combine of K-sized
partials.  Only K-sized vectors cross devices.

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
devices.

The 2-D mesh (:class:`Mesh2D`, :func:`mesh_2d`) also shards the states, for
state counts beyond one device: a sharded matrix is a kd x nd nested list
of blocks, K and N padded to the mesh shape.  The per-sample reductions
finish over the k-blocks of each n column, the per-state ones over the
n-blocks of each k row.  Its dd solve (:func:`sharded2d_solve_mbar_dd`)
runs the split pair K3 ``denom_sums_dd`` + K4 ``wsum_denom_dd`` on every
block under a shift shared by the column (:func:`sharded2d_wsum_dd`);
:func:`sharded2d_solve_mbar` is its plain float64 Anderson solve.
"""

import dataclasses
import logging
import time

import numpy as np
import torch

from pymbar_tpu_torch.config import default_device
from pymbar_tpu_torch.ops.doubledouble import dd_from_f64, dd_to_f64
from pymbar_tpu_torch.ops.lognum import lognum_fused_dd
from pymbar_tpu_torch.ops.mbar_core import (
    _PAD_THRESHOLD,
    _as_tensor as _u_as_tensor,
    _col_chunks,
    _matmul,
    _same_device,
    _weights,
    gram_f32_acc64,
    log_denominator_n,
    self_consistent_update,
    stream_columns,
)
from pymbar_tpu_torch.ops.wsum import _PAD_M, wsum_dd
from pymbar_tpu_torch.ops.wsum_split import column_shift, denom_sums_dd, wsum_denom_dd
from pymbar_tpu_torch.solvers import (
    _adaptive_metrics,
    _anderson,
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
    polish_to_host,
    _split_into,
)
from pymbar_tpu_torch.utils import ParameterError

logger = logging.getLogger(__name__)

__all__ = [
    "Mesh",
    "Mesh2D",
    "default_mesh",
    "mesh_2d",
    "shard_u_kn",
    "sharded_log_denominator",
    "sharded_core_stats",
    "sharded_gram",
    "sharded_adaptive_step",
    "sharded_solve_mbar",
    "shard_u_kn_2d",
    "sharded2d_core_stats",
    "sharded2d_gram",
    "sharded2d_solve_mbar",
    "shard_dd_planes",
    "stream_shard_planes",
    "sharded_fused_lognum_dd",
    "sharded_wsum_dd",
    "sharded_bootstrap_polish_dd",
    "sharded_solve_mbar_dd",
    "shard_dd_planes_2d",
    "stream_shard_planes_2d",
    "sharded2d_wsum_dd",
    "sharded2d_solve_mbar_dd",
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
    card.  A process default device that is not CUDA
    (``PYMBAR_TPU_TORCH_DEVICE=cpu``) stands for ``device``
    (:func:`_mesh_device`); a CUDA one still gives every card.
    """
    device = _mesh_device(device)
    if device is None:
        devices = _cards()[:n_devices]
    else:
        devices = (_one_device(device),) * (1 if n_devices is None else n_devices)
    if not devices:
        raise ValueError(f"default_mesh: no devices (n_devices={n_devices})")
    return Mesh(devices, axis_name)


def _mesh_device(device):
    """``device``, or when None the process default device
    (:func:`pymbar_tpu_torch.config.default_device`) if that is not CUDA:
    a mesh on the default CUDA device is every card."""
    if device is None:
        dflt = default_device()
        if dflt is not None and dflt.type != "cuda":
            return dflt
    return device


def _cards():
    """Every visible CUDA card; raises without one, naming ``device="cpu"``."""
    target_device()
    return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))


def _one_device(device):
    """``device`` as a torch.device, a bare "cuda" as the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _sync(mesh):
    devices = mesh.devices
    if isinstance(mesh, Mesh2D):
        devices = [d for row in devices for d in row]
    for dev in set(devices):
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


def _preduce(parts, dev, op):
    """Elementwise ``op`` (``torch.add``, ``torch.maximum``, ...) of
    per-shard partials on ``dev``, folded in mesh order."""
    acc = parts[0].to(dev)
    for p in parts[1:]:
        acc = op(acc, p.to(dev))
    return acc


def _psum(parts, dev):
    """Sum of per-shard partials on ``dev``, in mesh order."""
    return _preduce(parts, dev, torch.add)


def _pmax(parts, dev):
    """Elementwise max of per-shard partials on ``dev``."""
    return _preduce(parts, dev, torch.maximum)


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
    """Pad-column mask, a whole-column test through the column min."""
    return _pad_rule(u_local.amin(dim=0))


def _pad_rule(col_min):
    """Pad columns from their column min (over every state).

    float64 inputs (the user's u_kn, +inf pads): only a whole +inf column is
    padding, so a column huge in every state is kept and a NaN propagates.
    float32 hi planes (finite ~1e10 sentinels on preconditioned potentials,
    real columns at col_min ~ 0): col_min >= 5e9, or not finite.
    """
    if col_min.dtype == torch.float64:
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
    b_max = _pmax(max_parts, dev0)
    b_max = torch.where(torch.isfinite(b_max), b_max, 0.0)
    sum_parts = []
    for u, ld, dev in zip(u_kn_sharded, lds, mesh.devices):
        shift = b_max.to(dev)[:, None]
        s = torch.zeros(u.shape[0], dtype=dt, device=dev)
        for c0, c1 in _col_chunks(u):
            s += (-ld[None, c0:c1] - u[:, c0:c1]).sub_(shift).exp_().sum(dim=1)
        sum_parts.append(s)
    lognum = torch.log(_psum(sum_parts, dev0)) + b_max
    obj = _psum(obj_parts, dev0) - torch.dot(N0, f0)
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
    return _psum(grams, mesh.devices[0]), _psum(colsums, mesh.devices[0])


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
# 2-D (k x n) mesh: states shard over 'k', samples over 'n'.  The
# per-sample mixture reduction finishes over the k-blocks of one n column
# (a max, then a sum), the per-state reductions over the n-blocks of one k
# row.  A column's results are combined on the column's first device (row
# 0), the per-state results on the mesh's first device.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """A 2-D device mesh: ``devices[i][j]`` holds state block i of sample
    block j (``k`` rows of ``n`` torch.devices, each possibly repeated).
    The first axis shards states, the second samples."""

    devices: tuple
    axis_names: tuple = ("k", "n")

    @property
    def shape(self):
        """{axis name: size}, as a JAX mesh's ``shape``."""
        return dict(zip(self.axis_names, _grid(self)))


def _grid(mesh):
    """(kd, nd): the k and n sizes of a 2-D mesh."""
    return len(mesh.devices), len(mesh.devices[0])


def mesh_2d(k_devices, n_devices, axis_names=("k", "n"), device=None):
    """2-D mesh: the first axis shards states, the second samples.

    With no ``device``, the first ``k_devices * n_devices`` CUDA cards, row
    by row; without enough of them it raises, naming ``device="cpu"``.  With
    ``device``, every block on that one device: ``"cuda:0"`` for k x n
    shards of one card, ``"cpu"`` for CPU shards.  A non-CUDA process
    default device stands for ``device``, as in :func:`default_mesh`.
    """
    if k_devices < 1 or n_devices < 1:
        raise ValueError(f"mesh_2d: a {k_devices} x {n_devices} mesh has no devices")
    n = k_devices * n_devices
    device = _mesh_device(device)
    if device is None:
        devices = _cards()
        if len(devices) < n:
            raise ParameterError(
                f"mesh_2d: a {k_devices} x {n_devices} mesh needs {n} CUDA cards, "
                f'{len(devices)} visible: pass device="cuda:0" (or device="cpu") to put '
                "every block on one device"
            )
    else:
        devices = (_one_device(device),) * n
    rows = tuple(tuple(devices[i * n_devices : (i + 1) * n_devices]) for i in range(k_devices))
    return Mesh2D(rows, tuple(axis_names))


def _blocks_2d(x, mesh, pad_value, dtype):
    """The kd x nd blocks of a (K, N) matrix (numpy or tensor), K and N
    padded to the mesh shape with ``pad_value``.

    Block (i, j), a contiguous ``dtype`` tensor on ``mesh.devices[i][j]``,
    holds padded rows [i kb, (i + 1) kb) and columns [j nb, (j + 1) nb).
    Each block is copied (and cast) from its slice of x, so numpy input
    crosses to a device block by block.  Returns (blocks, (k_pad, n_pad)).
    """
    kd, nd = _grid(mesh)
    x = x if torch.is_tensor(x) else np.asarray(x)
    K, N = x.shape
    kb, nb = -(-K // kd), -(-N // nd)
    blocks = []
    for i, row in enumerate(mesh.devices):
        r0, r1 = min(K, i * kb), min(K, (i + 1) * kb)
        blocks.append([])
        for j, dev in enumerate(row):
            c0, c1 = min(N, j * nb), min(N, (j + 1) * nb)
            part = x[r0:r1, c0:c1]
            b = torch.full((kb, nb), pad_value, dtype=dtype, device=dev)
            b[: r1 - r0, : c1 - c0].copy_(part if torch.is_tensor(part) else torch.tensor(part))
            blocks[-1].append(b)
    return blocks, (kd * kb - K, nd * nb - N)


def _stream_blocks_2d(u_kn, mesh, pads, dtype, planes_of):
    """The kd x nd blocks of each plane that ``planes_of`` makes from u_kn's
    column chunks, K and N padded to the mesh shape, with no K x N copy.

    Column block j streams u_kn[:, j nb:(j + 1) nb] to
    ``mesh.devices[0][j]`` (:func:`~pymbar_tpu_torch.ops.mbar_core.
    stream_columns`: a host u_kn going to a card one chunk at a time
    through pinned staging).  ``planes_of(u_c, view)`` turns a (K, nc)
    chunk into one (K, nc) tensor per plane (``view``: u_c is a view of
    u_kn, which it must not change); row block i of each is copied into
    block (i, j) before the next chunk is asked for.  Plane p's blocks
    are contiguous ``dtype`` tensors padded with ``pads[p]``, as
    :func:`_blocks_2d` pads.  Returns (one nested list of blocks per
    plane, (k_pad, n_pad)).
    """
    u = _u_as_tensor(u_kn)
    kd, nd = _grid(mesh)
    K, N = u.shape
    kb, nb = -(-K // kd), -(-N // nd)
    planes = [[[torch.full((kb, nb), pad, dtype=dtype, device=dev) for dev in row]
               for row in mesh.devices] for pad in pads]
    for j in range(nd):
        c0, c1 = min(N, j * nb), min(N, (j + 1) * nb)
        dev = mesh.devices[0][j]
        view = _same_device(u.device, dev)
        for s, e, u_c in stream_columns(u, dev, start=c0, stop=c1):
            for blocks, part in zip(planes, planes_of(u_c, view)):
                for i in range(kd):
                    r0, r1 = min(K, i * kb), min(K, (i + 1) * kb)
                    blocks[i][j][: r1 - r0, s - c0 : e - c0].copy_(part[r0:r1])
    return planes, (kd * kb - K, nd * nb - N)


def _np64(x):
    """A K-vector (numpy or tensor) as float64 numpy."""
    return np.asarray(x.cpu() if torch.is_tensor(x) else x, dtype=np.float64)


def _pad_vectors(N_k, f_k, k_pad):
    """N_k and f_k as float64 numpy with k_pad pad states (N_k = f_k = 0)."""
    return np.pad(_np64(N_k), (0, k_pad)), np.pad(_np64(f_k), (0, k_pad))


def _k_slices(x, mesh, kb, dtype):
    """A padded K-vector's per-block slices: [i][j] holds rows
    [i kb, (i + 1) kb) as ``dtype`` on ``mesh.devices[i][j]``."""
    v = _vec(x, dtype, mesh.devices[0][0])
    return [[v[i * kb : (i + 1) * kb].to(dev) for dev in row] for i, row in enumerate(mesh.devices)]


def shard_u_kn_2d(u_kn, N_k, f_k, mesh):
    """u_kn (numpy or tensor) as float64 blocks of a 2-D mesh, K and N
    padded to the mesh shape, read one column chunk at a time
    (:func:`_stream_blocks_2d`: a host u_kn reaches a card through pinned
    staging, and no K x N copy is made).

    Pad rows and pad columns get u = +inf (exp(-inf) adds exactly 0), pad
    states N_k = 0 and f_k = 0.  Returns (blocks, N_k_padded, f_k_padded,
    (k_pad, n_pad)): ``blocks[i][j]`` a contiguous float64 tensor on
    ``mesh.devices[i][j]``, the padded K-vectors float64 numpy.
    """
    (blocks,), (k_pad, n_pad) = _stream_blocks_2d(
        u_kn, mesh, (float("inf"),), torch.float64, lambda u_c, view: (u_c,))
    return (blocks, *_pad_vectors(N_k, f_k, k_pad), (k_pad, n_pad))


def _finite_or_neg_inf(a):
    """a with every non-finite entry set to -inf, in place (the JAX
    package's ``where(isfinite(a), a, -inf)``)."""
    return torch.nan_to_num_(a, nan=-torch.inf, posinf=-torch.inf, neginf=-torch.inf)


def _column_logden(col, N_s, f_s, root):
    """The log-denominators of one n column of blocks and its pad-column
    mask, (N_local,) each on ``root``.

    ``col``: the column's kd k-blocks; ``N_s``/``f_s``: their N_k and f_k
    slices.  Per column chunk: each block's column max of f - u (non-finite
    terms as -inf), a max over the k-blocks, then the sum of the blocks'
    N_k-weighted exps in mesh order.  The pad test spans every k-block: a
    column is padding when its min over all of them passes
    :func:`_pad_rule`, and its log-denominator is then 0.
    """
    ld = torch.empty(col[0].shape[1], dtype=col[0].dtype, device=root)
    pad = torch.empty(col[0].shape[1], dtype=torch.bool, device=root)
    for s, e in _col_chunks(col[0]):
        a = [_finite_or_neg_inf(f[:, None] - u[:, s:e]) for u, f in zip(col, f_s)]
        m = _pmax([x.amax(dim=0) for x in a], root)
        m = torch.where(torch.isfinite(m), m, 0.0)
        parts = [x.sub_(m.to(x.device)).exp_().mul_(N[:, None]).sum(dim=0)
                 for x, N in zip(a, N_s)]
        del a
        pad[s:e] = _pad_rule(_preduce([u[:, s:e].amin(dim=0) for u in col], root,
                                       torch.minimum))
        ld[s:e] = (torch.log(_psum(parts, root)) + m).masked_fill_(pad[s:e], 0.0)
    return ld, pad


def sharded2d_core_stats(u_sharded, N_k, f_k, mesh):
    """(objective, gradient, f_sci) on a 2-D (k, n) mesh, on its first device.

    ``u_sharded``: the blocks of :func:`shard_u_kn_2d` (or a hi plane's of
    :func:`shard_dd_planes_2d`); N_k, f_k: the padded (K_pad,) vectors
    (numpy or tensors).  Computes in the blocks' dtype.  Each n column's
    log-denominators come from its k-blocks (:func:`_column_logden`); each
    state's logsumexp over n takes the max of its n-blocks' maxima, then the
    sum of their sums rescaled by it, both in mesh order.  Pad states
    (N_k = 0, u = +inf) give f_sci = +inf and gradient 0.
    """
    kd, nd = _grid(mesh)
    dev0 = mesh.devices[0][0]
    dt = u_sharded[0][0].dtype
    kb = u_sharded[0][0].shape[0]
    N_s, f_s = _k_slices(N_k, mesh, kb, dt), _k_slices(f_k, mesh, kb, dt)
    lds, obj_parts = [], []  # lds[j][i]: column j's log-denominators on block (i, j)
    for j in range(nd):
        ld, _ = _column_logden([row[j] for row in u_sharded], [N[j] for N in N_s],
                               [f[j] for f in f_s], mesh.devices[0][j])
        obj_parts.append(ld.sum())
        lds.append([ld.to(row[j]) for row in mesh.devices])

    def b_chunks(i, j):
        u, ld = u_sharded[i][j], lds[j][i]
        for s, e in _col_chunks(u):
            yield _finite_or_neg_inf(-ld[None, s:e] - u[:, s:e])

    lognum = []
    for i in range(kd):
        maxima = []
        for j, dev in enumerate(mesh.devices[i]):
            mx = torch.full((kb,), -torch.inf, dtype=dt, device=dev)
            for b in b_chunks(i, j):
                mx = torch.maximum(mx, b.amax(dim=1))
            maxima.append(mx)
        b_max = _pmax(maxima, dev0)
        b_max = torch.where(torch.isfinite(b_max), b_max, 0.0)
        sums = []
        for j, dev in enumerate(mesh.devices[i]):
            shift = b_max.to(dev)[:, None]
            acc = torch.zeros(kb, dtype=dt, device=dev)
            for b in b_chunks(i, j):
                acc += b.sub_(shift).exp_().sum(dim=1)
            sums.append(acc)
        lognum.append(torch.log(_psum(sums, dev0)) + b_max)
    lognum = torch.cat(lognum)
    N0, f0 = _vec(N_k, dt, dev0), _vec(f_k, dt, dev0)
    obj = _psum(obj_parts, dev0) - torch.dot(N0, f0)
    grad = -N0 * (1.0 - torch.exp(f0 + lognum))
    return obj, grad, -lognum


def _chunked_pair_gram(a, b):
    """a @ b^T of two (., N_local) float32 blocks: float32 products (TF32
    refused, :func:`~pymbar_tpu_torch.ops.mbar_core._matmul`) over 8 column
    chunks, accumulated in float64, as the JAX package chunks them."""
    width = max(1, -(-a.shape[1] // 8))
    out = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.float64, device=a.device)
    for s in range(0, a.shape[1], width):
        out += _matmul(a[:, s : s + width], b[:, s : s + width].T)
    return out


def _chunked_w_gram(w):
    """(W W^T, rowsum W) of one float32 weight block, in float64."""
    return _chunked_pair_gram(w, w), w.sum(dim=1, dtype=torch.float64)


def sharded2d_gram(u_sharded, N_k, f_k, mesh):
    """(W^T W, colsum W) on a 2-D (k, n) mesh, the chord-factor pass: a ring
    over k.

    In each n column, every k-block forms its own W block from the column's
    log-denominators (:func:`_column_logden`, pad columns weigh 0) and
    contracts it against the W block of each later k-block of the column,
    which visits it (formed on its own device, copied over, then dropped);
    the tile of the pair fills both its place and its transpose's.  At most
    two W blocks of a column exist at once, own and visiting, never the
    column's whole K x N_local.  Tiles and column sums combine over n in
    mesh order.  Products in float32 with float64 accumulation
    (:func:`_chunked_pair_gram`); works on float32 hi planes with their
    sentinels.  Returns the (K_pad, K_pad) Gram and the (K_pad,) colsum,
    float64 on the mesh's first device.
    """
    kd, nd = _grid(mesh)
    dev0 = mesh.devices[0][0]
    dt = u_sharded[0][0].dtype
    kb = u_sharded[0][0].shape[0]
    N_s, f_s = _k_slices(N_k, mesh, kb, dt), _k_slices(f_k, mesh, kb, dt)
    tiles, colsums = {}, [[] for _ in range(kd)]
    for j in range(nd):
        ld, pad = _column_logden([row[j] for row in u_sharded], [N[j] for N in N_s],
                                 [f[j] for f in f_s], mesh.devices[0][j])

        def w_block(i):
            dev = mesh.devices[i][j]
            w = (f_s[i][j][:, None] - u_sharded[i][j]).sub_(ld.to(dev)[None, :]).exp_()
            return w.masked_fill_(pad.to(dev)[None, :], 0.0)

        for i in range(kd):
            own = w_block(i)
            gram, colsum = _chunked_w_gram(own)
            tiles.setdefault((i, i), []).append(gram)
            colsums[i].append(colsum)
            for i2 in range(i + 1, kd):
                visiting = w_block(i2).to(own.device)
                tiles.setdefault((i, i2), []).append(_chunked_pair_gram(own, visiting))
                del visiting
            del own
    gram = torch.empty((kd * kb, kd * kb), dtype=torch.float64, device=dev0)
    for (i, i2), parts in tiles.items():
        tile = _psum(parts, dev0)
        gram[i * kb : (i + 1) * kb, i2 * kb : (i2 + 1) * kb] = tile
        gram[i2 * kb : (i2 + 1) * kb, i * kb : (i + 1) * kb] = tile.T
    return gram, torch.cat([_psum(c, dev0) for c in colsums])


def sharded2d_solve_mbar(u_kn, N_k, f_k=None, mesh=None, tol=1.0e-12, maxiter=2000, m_history=5):
    """Anderson-accelerated MBAR solve on a 2-D (k, n) mesh, float64
    throughout.

    Hessian-free: each iteration is one self-consistent map (the f_sci of
    :func:`sharded2d_core_stats` on the float64 blocks) mixed on the host
    (:func:`_anderson`).  The JAX package runs it in the TPU's emulated f64;
    true f64 takes its place here.  All states must have samples.  Returns
    (f_k ndarray, info dict with success, iterations, max_delta, gnorm).
    """
    if mesh is None:
        raise ValueError("sharded2d_solve_mbar requires an explicit 2-D mesh")
    K = u_kn.shape[0]
    f0 = np.zeros(K) if f_k is None else _np64(f_k)
    u_sh, N_pad, f_pad, _ = shard_u_kn_2d(u_kn, N_k, f0 - f0[0], mesh)

    def sc(fv):
        f_sci = sharded2d_core_stats(u_sh, N_pad, fv, mesh)[2].cpu().numpy()
        return f_sci - f_sci[0]

    f, it, max_delta, success, _ = _anderson(sc, f_pad, maxiter, tol, m_history, K=K)
    g = sharded2d_core_stats(u_sh, N_pad, f, mesh)[1][:K].cpu().numpy()
    return f[:K], dict(success=success, iterations=it, max_delta=max_delta,
                       gnorm=float(np.linalg.norm(g)))


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


def stream_shard_planes(u_kn, mesh, rows=None):
    """The double-word split of u_kn[rows] (every row by default) written
    straight into each shard's (hi, lo) planes, one streamed column chunk
    at a time (:func:`pymbar_tpu_torch.solvers_large._split_into`): shard i
    holds padded columns [i w, (i + 1) w) on mesh device i, pad columns
    as in :func:`shard_dd_planes`.  A host-resident u_kn (a CPU tensor, a
    CUDA mesh) is uploaded chunk by chunk; no K x N float64 copy exists on
    the host or a card.  Bit-identical to :func:`shard_dd_planes` of
    ``dev_split_planes(u_kn[rows])``.  Returns (hi_shards, lo_shards)."""
    u = u_kn if torch.is_tensor(u_kn) else _as_tensor(u_kn, torch.float64)
    K = u.shape[0] if rows is None else len(rows)
    N = u.shape[1]
    w = -(-N // len(mesh.devices))
    his, los = [], []
    for i, dev in enumerate(mesh.devices):
        uh = torch.empty((K, w), dtype=torch.float32, device=dev)
        ul = torch.empty_like(uh)
        n = max(0, min(N, (i + 1) * w) - i * w)
        uh[:, n:] = _PAD_U
        ul[:, n:] = 0.0
        if n:
            _split_into(u, uh, ul, rows, start=i * w)
        his.append(uh)
        los.append(ul)
    return his, los


def _dd_combine_partials(parts, mesh):
    """Per-shard (hi, lo) partial sums merged in f64 on the first device, in
    mesh order.  Returns the float64 sum."""
    return _psum([dd_to_f64(h, l) for h, l in parts], mesh.devices[0])


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
    return _psum(grams, mesh.devices[0]), _psum(colsums, mesh.devices[0])


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
        return _psum(parts, mesh.devices[0])

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
    u_hi_s, u_lo_s, _ = shard_dd_planes(u_hi, u_lo, mesh)
    return _sharded_solve_mbar_dd_shards(
        u_hi_s, u_lo_s, N_k, f_k=f_k, mesh=mesh, tol=tol, f32_tol=f32_tol,
        f32_maxiter=f32_maxiter, polish_maxiter=polish_maxiter, gamma=gamma,
        return_state=return_state,
    )


def _sharded_solve_mbar_dd_shards(u_hi_s, u_lo_s, N_k, f_k, mesh, tol, f32_tol=1.0e-4,
                                  f32_maxiter=40, polish_maxiter=12, gamma=1.0,
                                  return_state=False):
    """:func:`sharded_solve_mbar_dd` on planes already in shards (as
    :func:`shard_dd_planes` or :func:`stream_shard_planes` lay them out)."""
    dev0 = mesh.devices[0]
    K = u_hi_s[0].shape[0]
    N_k_host = np.asarray(N_k, dtype=np.int64)
    N_real = int(N_k_host.sum())
    N_k64 = _vec(np.asarray(N_k, dtype=np.float64), torch.float64, dev0)
    N_k32 = N_k64.to(torch.float32)
    f64 = torch.zeros(K, dtype=torch.float64, device=dev0)
    if f_k is not None:
        f64 = _vec(np.asarray(f_k, dtype=np.float64), torch.float64, dev0)
    f64 = f64 - f64[0]

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


# ---------------------------------------------------------------------------
# Double-word 2-D (k x n) mesh.  The weight sums split at the k-block
# boundary: every block's denominator partials under one shift shared by
# its n column (K3), summed exactly in f64 over the column's k-blocks, then
# every block's weight sums (K4), summed over its k row's n-blocks.
# ---------------------------------------------------------------------------


def shard_dd_planes_2d(u_hi, u_lo, N_k, f_k, mesh):
    """Double-word (hi, lo) planes (numpy or float32 tensors) as blocks of a
    2-D mesh, with the finite sentinel padding.

    Pad rows and pad columns get u_hi = +1e10 and u_lo = 0 (the dd kernels
    drop them), pad states N_k = 0 and f_k = 0.  Returns (u_hi_s, u_lo_s,
    N_k_padded, f_k_padded, (k_pad, n_pad)): kd x nd contiguous float32
    blocks, each on its mesh device, and float64 numpy K-vectors.  Every
    block is a copy, so the caller may drop planes that are already on the
    card once the blocks exist (:func:`sharded2d_solve_mbar_dd` drops its
    own references to them).
    """
    hi, pads = _blocks_2d(u_hi, mesh, _PAD_U, torch.float32)
    lo, _ = _blocks_2d(u_lo, mesh, 0.0, torch.float32)
    return (hi, lo, *_pad_vectors(N_k, f_k, pads[0]), pads)


def _split_chunk(u_c, view):
    """The double-word split of a (K, nc) chunk under its own column min,
    as (hi, lo) float32, by the arithmetic of
    :func:`~pymbar_tpu_torch.solvers_large._split_into` (a view of u_kn is
    copied to float64 first; any other chunk is split in place)."""
    blk = u_c.to(torch.float64, copy=True) if view else u_c
    blk.sub_(blk.amin(dim=0)[None, :])
    hi = blk.to(torch.float32)
    return hi, blk.sub_(hi).to(torch.float32)  # hi widens exactly


def stream_shard_planes_2d(u_kn, N_k, f_k, mesh):
    """:func:`shard_dd_planes_2d` of ``dev_split_planes(u_kn)``, bit for
    bit, with no whole planes: each column chunk of u_kn is split under
    its column min over every state and its row blocks are written
    straight into the (hi, lo) blocks of its n column
    (:func:`_stream_blocks_2d`).  A host-resident u_kn (a CPU tensor, a
    CUDA mesh) is uploaded chunk by chunk; no K x N float64 copy and no
    whole planes exist on the host or a card.  The 2-D counterpart of
    :func:`stream_shard_planes`; :func:`sharded2d_solve_mbar_dd` takes its
    blocks as they are.  Returns (u_hi_s, u_lo_s, N_k_padded, f_k_padded,
    (k_pad, n_pad)), as :func:`shard_dd_planes_2d` does."""
    (hi, lo), pads = _stream_blocks_2d(u_kn, mesh, (_PAD_U, 0.0), torch.float32, _split_chunk)
    return (hi, lo, *_pad_vectors(N_k, f_k, pads[0]), pads)


def sharded2d_wsum_dd(u_hi_s, u_lo_s, g_hi, g_lo, mesh):
    """S_k = sum_n N_k W_nk on a 2-D (k, n) mesh in dd precision.

    For each n column of blocks: the shift m_n, the max over its k-blocks of
    :func:`~pymbar_tpu_torch.ops.wsum_split.column_shift` (a float32 max,
    exact in any order); K3 ``denom_sums_dd`` on every block under that
    shared m; the kd (N_local,) partials summed in f64 in k order, and pad
    columns (m_n < -1e8) set to d = 0 after the sum; then K4
    ``wsum_denom_dd`` on every block.  Each k row's nd (K_local,) partials
    are summed in f64 in n order and the rows concatenated.  Every block's
    kernels are launched before anything waits.  g_hi/g_lo: the
    (K_padded,) float32 dd planes of f + ln N (0 on pad states, whose
    sentinel rows add exactly 0).  Returns (S_hi, S_lo), (K_padded,)
    float32 on the mesh's first device.
    """
    kd, nd = _grid(mesh)
    kb = u_hi_s[0][0].shape[0]
    gh_s, gl_s = _k_slices(g_hi, mesh, kb, torch.float32), _k_slices(g_lo, mesh, kb, torch.float32)
    rows = [[] for _ in range(kd)]
    for j in range(nd):
        root = mesh.devices[0][j]
        col = [(u_hi_s[i][j], u_lo_s[i][j], gh_s[i][j], gl_s[i][j], mesh.devices[i][j])
               for i in range(kd)]
        m = _pmax([column_shift(uh, gh) for uh, _, gh, _, _ in col], root)
        d = _psum([dd_to_f64(*denom_sums_dd(uh, ul, gh, gl, m.to(dev)))
                   for uh, ul, gh, gl, dev in col], root)
        d_hi, d_lo = dd_from_f64(d.masked_fill_(m < _PAD_M, 0.0))
        for row, (uh, ul, gh, gl, dev) in zip(rows, col):
            row.append(dd_to_f64(*wsum_denom_dd(uh, ul, gh, gl, m.to(dev), d_hi.to(dev),
                                                d_lo.to(dev))))
    return dd_from_f64(torch.cat([_psum(row, mesh.devices[0][0]) for row in rows]))


def _sharded2d_polish_dd(u_hi_s, u_lo_s, N_k64, f0, hinv, logN, tol, gamma, mesh, maxiter):
    """The 2-D-mesh dd chord-Newton polish: the single-device polish loop
    (:func:`pymbar_tpu_torch.solvers_large._polish_loop`) with one
    :func:`sharded2d_wsum_dd` per iteration.  Pad states carry N_k = 0,
    S_k = 0 and an identity block of ``hinv``, so their gradient and step
    are exactly 0."""

    def wsum(uh, ul, gh, gl):
        return sharded2d_wsum_dd(uh, ul, gh, gl, mesh)

    return _polish_loop(wsum, u_hi_s, u_lo_s, N_k64, f0, hinv, logN, tol, gamma, maxiter)


def _strided_blocks_2d(blocks, mesh, stride):
    """The blocks of the padded plane's every-``stride``-th global column
    (``u[:, ::stride]``), re-split over n and padded with the sentinel:
    each k row's selected columns are gathered on the row's first device,
    then split as :func:`shard_dd_planes` splits a plane."""
    out = []
    for row, devs in zip(blocks, mesh.devices):
        sel = torch.cat([c.to(devs[0]) for c in _strided_shards(row, mesh, stride)], dim=1)
        out.append(_split_columns(sel, Mesh(devs), _PAD_U)[0])
    return out


def sharded2d_solve_mbar_dd(
    u_hi,
    u_lo,
    N_k,
    f_k=None,
    mesh=None,
    tol=1.0e-12,
    f32_tol=1.0e-4,
    f32_maxiter=200,
    polish_maxiter=60,
    m_history=5,
):
    """Double-word MBAR solve on a 2-D (k, n) mesh, with the 1-D dd solve's
    ~1e-12 floor.

    The JAX package's phases, minus its TPU knob ``fast_exp``: phase 1 runs
    float32 Anderson (:func:`_anderson`, 'mixed' metric) on the
    self-consistent map of :func:`sharded2d_core_stats` over the hi blocks,
    on the plane's global every-``stride2``-th column subsample (stride2 =
    N // (32 K), clipped to [1, 64]).  The subsample's weights keep the
    full-N normalization (logden is column-local), so its map is the full
    map plus a uniform ln(stride2) that cancels on re-pinning, and its Gram
    and column sums scale by ratio = N / n_sub.  Phase 2 is the chord-Newton
    polish of the 1-D solves (:func:`_sharded2d_polish_dd`) with its factor
    from :func:`sharded2d_gram` on that subsample (an identity block for pad
    states); if the factor fails to contract, the Hessian-free dd Anderson
    iteration over :func:`sharded2d_wsum_dd` (floor stop 3e-13) takes over,
    and one more weight-sum pass gives the gradient.  The caller supplies
    preconditioned (hi, lo) planes (numpy or float32 tensors); they are
    copied block by block (:func:`shard_dd_planes_2d`), and the solve drops
    its references to them once the blocks exist, so a caller that passes
    its only references frees planes that sit on the card.  Or it supplies
    the planes' blocks, the nested lists u_hi_s and u_lo_s of
    :func:`stream_shard_planes_2d` (from a host-resident u_kn with no whole
    planes anywhere), with the unpadded N_k and f_k.  All states must have
    samples.  Returns (f_k float64 ndarray, info dict).
    """
    if mesh is None:
        raise ValueError("sharded2d_solve_mbar_dd requires an explicit 2-D mesh")
    dev0 = mesh.devices[0][0]
    K = len(N_k)
    f0 = np.zeros(K) if f_k is None else _np64(f_k)
    if isinstance(u_hi, list):
        u_hi_s, u_lo_s, N_cols = u_hi, u_lo, int(np.sum(_np64(N_k)))
        N_pad, f_pad = _pad_vectors(N_k, f0 - f0[0], len(u_hi) * u_hi[0][0].shape[0] - K)
    else:
        N_cols = u_hi.shape[1]
        u_hi_s, u_lo_s, N_pad, f_pad, _ = shard_dd_planes_2d(u_hi, u_lo, N_k, f0 - f0[0], mesh)
    del u_hi, u_lo
    N_pad32 = N_pad.astype(np.float32)
    stride2 = int(np.clip(N_cols // max(32 * K, 1), 1, 64))
    sub = u_hi_s if stride2 == 1 else _strided_blocks_2d(u_hi_s, mesh, stride2)
    ratio = N_cols / float(-(-N_cols // stride2))

    # ---- phase 1: float32 Anderson on the (subsampled) hi blocks
    _sync(mesh)
    t_phase1 = time.time()

    def sc32(fv):
        f_sci = sharded2d_core_stats(sub, N_pad32, fv.astype(np.float32), mesh)[2]
        f_sci = f_sci.cpu().numpy().astype(np.float64)
        return f_sci - f_sci[0]

    f, it32, _, _, _ = _anderson(sc32, f_pad, f32_maxiter, f32_tol, m_history, K=K,
                                delta_mode="mixed")
    t_phase1 = time.time() - t_phase1

    # ---- phase 2: the dd chord-Newton polish, dd Anderson as its fallback
    t_phase2 = time.time()
    logN = np.where(N_pad > 0, np.log(np.where(N_pad > 0, N_pad, 1.0)), 0.0)
    gram, colsum = sharded2d_gram(sub, N_pad32, f.astype(np.float32), mesh)
    del sub
    N_k64 = torch.as_tensor(N_pad, device=dev0)
    hinv = torch.eye(len(N_pad) - 1, dtype=torch.float64, device=dev0)
    hinv[: K - 1, : K - 1] = _newton_factor(gram[:K, :K] * ratio, colsum[:K] * ratio, N_k64[:K])
    del gram, colsum
    f64, it_dd, g64, deltas, converged, at_floor = polish_to_host(_sharded2d_polish_dd(
        u_hi_s, u_lo_s, N_k64, torch.as_tensor(f, device=dev0), hinv,
        torch.as_tensor(logN, device=dev0), tol, 1.0, mesh, polish_maxiter,
    ))
    max_delta = deltas[-1] if deltas else np.inf
    f = f64.cpu().numpy()
    g = g64[:K].cpu().numpy()

    if not converged:
        def wsum_at(fv):
            gh, gl = dd_from_f64(torch.as_tensor(fv + logN, device=dev0))
            return dd_to_f64(*sharded2d_wsum_dd(u_hi_s, u_lo_s, gh, gl, mesh)).cpu().numpy()

        def sc_dd(fv):
            S = wsum_at(fv)
            with np.errstate(divide="ignore", invalid="ignore"):
                f_sci = fv + logN - np.log(np.where(S > 0, S, 1.0))
            f_sci[N_pad == 0] = 0.0
            return f_sci - f_sci[0]

        f, it2, max_delta, converged, at_floor = _anderson(
            sc_dd, f, polish_maxiter, tol, m_history, K=K, delta_mode="mixed",
            floor_stop=3.0e-13)
        it_dd += it2
        g = (wsum_at(f) - N_pad)[:K]  # the gradient certificate
    t_phase2 = time.time() - t_phase2

    return f[:K], dict(
        converged=converged,
        at_noise_floor=at_floor,
        f32_iterations=int(it32),
        polish_iterations=int(it_dd),
        max_delta=max_delta,
        deltas=deltas,
        gnorm=float(np.linalg.norm(g)),
        phase1_s=t_phase1,
        phase2_s=t_phase2,
    )


def _sharded_solve_mbar_for_all_states(
    u_kn, N_k, f_k, states_with_samples, mesh=None, tol=1.0e-12, bootstrap_counts=None,
    verbose=False,
):
    """:func:`sharded_solve_mbar_for_all_states` that also returns the
    solve's result dicts: the MBAR class's mesh front door.

    Solves the sampled states by :func:`sharded_solve_mbar_dd` on the dd
    split of their rows, streamed column chunk by column chunk straight
    into each shard's planes (:func:`stream_shard_planes`), then fills
    empty states with one self-consistent pass over all K states on the
    first mesh device (streamed too), and re-pins f_0 = 0.  ``u_kn``: a
    float64 tensor (a CPU tensor for a CUDA mesh stays in host memory: its
    chunks are uploaded one at a time) or numpy (a CPU tensor then).  Returns
    (f_k ndarray, list of the solve's result dict), as the single-device
    :func:`pymbar_tpu_torch.solvers._solve_mbar_for_all_states`.

    With ``bootstrap_counts`` (a (B, N) resample-multiplicity matrix; every
    state must have samples, else ValueError) the B replicates are also
    solved on the same sharded planes from the base solution and its chord
    factor (:func:`sharded_bootstrap_polish_dd`), and the return is (f_k,
    results, f_boots (B, K), n_fail, info).
    """
    if mesh is None:
        mesh = default_mesh()
    u = u_kn if torch.is_tensor(u_kn) else _as_tensor(u_kn, torch.float64)
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
        uh_s, ul_s = stream_shard_planes(u, mesh, None if len(sws) == len(N_k) else sws)
        f_sub, info = _sharded_solve_mbar_dd_shards(
            uh_s, ul_s, N_k[sws], f_k[sws] - f_k[sws][0], mesh, tol,
            return_state=bootstrap_counts is not None,
        )
        del uh_s, ul_s
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
        # Empty-state fill: one self-consistent pass over all K states
        # (empty states carry N_k = 0 and drop out of the denominator
        # exactly), u's column chunks streamed to the first mesh device.
        f_k = self_consistent_update(u, N_k, f_k, device=mesh.devices[0]).cpu().numpy()
    return f_k - f_k[0], results


def sharded_solve_mbar_for_all_states(
    u_kn, N_k, f_k, states_with_samples, mesh=None, tol=1.0e-12, bootstrap_counts=None,
    verbose=False,
):
    """The sharded counterpart of ``solve_mbar_for_all_states``, as the JAX
    package's: the states with samples solved on the mesh, the empty ones
    filled by one self-consistent update, f_0 = 0 (see
    :func:`_sharded_solve_mbar_for_all_states`).  Returns f_k, a (K,)
    float64 ndarray; with ``bootstrap_counts``, (f_k, f_boots (B, K),
    n_fail, info).
    """
    out = _sharded_solve_mbar_for_all_states(
        u_kn, N_k, f_k, states_with_samples, mesh=mesh, tol=tol,
        bootstrap_counts=bootstrap_counts, verbose=verbose,
    )
    return out[0] if bootstrap_counts is None else (out[0], *out[2:])
