"""Core MBAR numerics as plain PyTorch functions of (u_kn, N_k, f_k).

The counterpart of :mod:`pymbar_tpu.ops.mbar_core` (reference pymbar 4.x
mbar_solvers.py:174-507, :697-735): the same two fused reductions over the
K x N reduced-potential matrix,

* ``log_denominator_n = logsumexp_k(f_k + log N_k - u_kn)``  (per sample)
* ``log_numerator_k   = logsumexp_n(-log_denominator_n - u_kn)`` (per state)

from which the self-consistent update, the gradient and the objective
follow, plus the Hessian and covariance aggregates in Gram form
(W W^T, K x K), so no N x K weight matrix is formed.

Every function takes ``u_kn`` as a tensor or as numpy, the K-vectors N_k
and f_k as either, and computes on the device ``u_kn`` lives on; only the
K-vectors move there.  A tensor keeps its device.  Numpy goes where the
JAX package's ``jnp.asarray`` puts it: the functions of the reference's
``mbar_solvers`` surface and their passes (:func:`_placed`) upload it as
float64 to :func:`pymbar_tpu_torch.config.target_device` (the card, or
the device ``device=`` or ``PYMBAR_TPU_TORCH_DEVICE`` names), while
:func:`validate_inputs` and the streaming helpers (:func:`stream_columns`,
:func:`u_kn_on`) keep it on the host as a CPU float64 tensor sharing its
memory.  A whole matrix goes from host memory to a card through
:func:`_upload_whole` (the numpy front door of ``MBAR`` and ``FES`` from
2 MiB up, and :func:`u_kn_on`): contiguous blocks cast into two pinned
buffers, each copied straight into its slice of the destination.  Eager
PyTorch makes a full-size temporary
for each elementwise op, so every K x N pass walks the sample axis in
column chunks of at most ``_CHUNK_BYTES`` (:func:`stream_columns`) and
updates its chunk temporaries in place.

The passes MBAR runs after placing ``u_kn`` (:func:`core_stats`,
:func:`self_consistent_update`, :func:`mbar_log_W_nk`,
:func:`mbar_gram_normalization`) also take ``device``, where the work
runs.  A CPU ``u_kn`` with a CUDA ``device`` stays in host memory
(host-resident): each pass uploads its column chunks through two pinned
staging buffers, the upload of one chunk overlapping the work on the one
before, and computes in float64 on the card.  With no ``device`` (or u's
own) the chunks are views of u_kn.
"""

import math
import warnings

import numpy as np
import torch

from pymbar_tpu_torch.config import target_device
from pymbar_tpu_torch.tracing import span
from pymbar_tpu_torch.utils import ensure_type

__all__ = [
    "stream_columns",
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
    "STAGED_UPLOADS",
]

# Column-chunk size of every K x N pass.  On the 80 GB H100 the flagship
# holds u_kn (8 GB) + its dd planes (8 GB) + a preconditioned copy (8 GB),
# and a chunk op keeps <= ~6 chunk-sized temporaries live: 512 MB chunks cap
# those at ~3 GB while each op still streams ~0.15 ms at 3.35 TB/s, far
# above the ~5 us launch cost.
_CHUNK_BYTES = 512 * 2**20

# Whole-matrix uploads through pinned staging (:func:`_upload_whole`).
STAGED_UPLOADS = 0

# u at or above this is the sentinel of a pad column (the kernels' +1e10).
_PAD_THRESHOLD = 5.0e9


def _col_ranges(rows, itemsize, start, stop, extra_rows=0):
    """(s, e) column ranges over [start, stop), each of at most
    ``_CHUNK_BYTES`` over ``rows`` + ``extra_rows`` rows of ``itemsize``
    bytes."""
    width = max(1, _CHUNK_BYTES // max(1, (rows + extra_rows) * itemsize))
    return [(s, min(stop, s + width)) for s in range(start, stop, width)]


def _col_chunks(u):
    """(start, stop) column ranges of at most ``_CHUNK_BYTES`` each.  The
    rows of every leading batch matrix of u count."""
    return _col_ranges(math.prod(u.shape[:-1]), u.element_size(), 0, u.shape[-1])


def _as_tensor(u_kn):
    """u_kn as a tensor: tensors as given, numpy as a CPU float64 tensor
    sharing its memory where it can."""
    if torch.is_tensor(u_kn):
        return u_kn
    return torch.from_numpy(np.ascontiguousarray(u_kn, dtype=np.float64))


def _placed(u_kn, device=None):
    """u_kn as a public entry point takes it: a tensor as given; numpy as
    float64 on :func:`target_device` of ``device`` (without a card, and with
    no device named, that raises), where the JAX package's ``jnp.asarray``
    puts it."""
    if torch.is_tensor(u_kn):
        return u_kn
    return _as_tensor(u_kn).to(target_device(device))


def _same_device(a, b):
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type == "cuda":
        ia = torch.cuda.current_device() if a.index is None else a.index
        ib = torch.cuda.current_device() if b.index is None else b.index
        return ia == ib
    return True


def _work_on(u, device=None):
    """(dtype, device) of the work on u's column chunks: u's own when
    ``device`` is None or u's device, else float64 on ``device``."""
    if device is None or _same_device(u.device, device):
        return u.dtype, u.device
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return torch.float64, dev


def stream_columns(u_kn, device=None, rows=None, start=0, stop=None, extra_rows=0):
    """Yield (s, e, u_c) over the column chunks of u_kn[..., start:stop]:
    u_c holds columns s:e, of the rows ``rows`` only when given (indices
    of u's second-to-last axis), on ``device`` (default: u's own).

    On u's own device u_c is a view of u_kn in its dtype (a gathered chunk
    with ``rows``).  A CPU u_kn with a CUDA ``device`` reaches the card
    through :func:`_staged_upload`: u_c is then a float64 staging tensor,
    valid until the next chunk is asked for.  Any other pair of devices
    moves each chunk with ``Tensor.to`` (float64).  A chunk spans at most
    ``_CHUNK_BYTES`` over its rows and ``extra_rows`` more rows of the
    work's dtype that the caller builds per chunk.
    """
    u = _as_tensor(u_kn)
    dt, dev = _work_on(u, device)
    stop = u.shape[-1] if stop is None else stop
    if rows is not None:
        rows = torch.as_tensor(rows if torch.is_tensor(rows) else np.asarray(rows),
                               dtype=torch.int64, device=u.device)
    n_rows = math.prod(u.shape[:-2]) * (u.shape[-2] if rows is None else rows.numel())
    ranges = _col_ranges(n_rows, dt.itemsize, start, stop, extra_rows)
    if u.device.type == "cpu" and dev.type == "cuda":
        yield from _staged_upload(u, dev, rows, ranges)
        return
    for s, e in ranges:
        u_c = u[..., s:e]
        if rows is not None:
            u_c = u_c.index_select(-2, rows)
        yield s, e, u_c.to(dev, dt)


def _staged_upload(u, dev, rows, ranges):
    """:func:`stream_columns` from host memory to a card.

    Two pinned staging buffers of at most ``_CHUNK_BYTES`` each: chunk i
    is cast to float64 into buffer i % 2 on the host, copied to its card
    buffer on a side stream with ``non_blocking``, and the current stream
    waits on that copy's event before the caller's work on the chunk.  The
    host staging and the upload of chunk i + 1 run while the card works on
    chunk i; a card buffer is overwritten only after the work on the chunk
    it held (an event recorded when the caller asks for the next one).
    """
    if not ranges:
        return
    R = u.shape[0] if rows is None else rows.numel()
    size = R * (ranges[0][1] - ranges[0][0])
    host = [torch.empty(size, dtype=torch.float64, pin_memory=True) for _ in range(2)]
    card = [torch.empty(size, dtype=torch.float64, device=dev) for _ in range(2)]
    work = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    uploaded = [torch.cuda.Event(), torch.cuda.Event()]
    consumed = [None, None]

    def stage(i):
        s, e = ranges[i]
        b, n = i % 2, R * (e - s)
        if i >= 2:
            uploaded[b].synchronize()  # the pinned buffer's last upload has left
        src = u[:, s:e] if rows is None else u[:, s:e].index_select(0, rows)
        host[b][:n].view(R, e - s).copy_(src)
        with torch.cuda.stream(side):
            if consumed[b] is not None:
                side.wait_event(consumed[b])
            card[b][:n].copy_(host[b][:n], non_blocking=True)
            uploaded[b].record(side)

    try:
        stage(0)
        for i, (s, e) in enumerate(ranges):
            if i + 1 < len(ranges):
                stage(i + 1)
            b = i % 2
            work.wait_event(uploaded[b])
            yield s, e, card[b][: R * (e - s)].view(R, e - s)
            consumed[b] = torch.cuda.Event()
            consumed[b].record(work)
    finally:
        # the card buffers return to the allocator on the current stream
        work.wait_stream(side)


def _upload_blocks(K, N, itemsize=8):
    """(k0, k1, j0, j1) blocks of a C-ordered (K, N) matrix, in order, that
    together cover it once: whole rows k0:k1 while one row fits in
    ``_CHUNK_BYTES``, else pieces j0:j1 of one row k0.  Each block is one
    contiguous run of at most ``_CHUNK_BYTES`` (of ``itemsize``-byte
    elements, one element at least)."""
    if K * N == 0:
        return []
    if N * itemsize <= _CHUNK_BYTES:
        rows = _CHUNK_BYTES // (N * itemsize)
        return [(k0, min(K, k0 + rows), 0, N) for k0 in range(0, K, rows)]
    width = max(1, _CHUNK_BYTES // itemsize)
    return [(k, k + 1, j0, min(N, j0 + width)) for k in range(K) for j0 in range(0, N, width)]


# numpy dtypes that torch views in place and casts to float64 as numpy does
_VIEWABLE = frozenset(np.dtype(t) for t in (
    np.float64, np.float32, np.float16, np.int64, np.int32, np.int16, np.int8, np.uint8,
    np.bool_))


def _host_view(u):
    """u (a CPU tensor, or numpy) as a CPU tensor sharing its memory; None
    for numpy that torch cannot view (another dtype or byte order, a
    negative or fractional stride)."""
    if torch.is_tensor(u):
        return u
    if u.dtype not in _VIEWABLE or any(s < 0 or s % u.itemsize for s in u.strides):
        return None
    with warnings.catch_warnings():
        # a read-only array is only read
        warnings.filterwarnings("ignore", "The given NumPy array is not writable")
        return torch.from_numpy(u)


def _upload_whole(u, dev):
    """u, a 2-D numpy array or CPU tensor of any dtype and layout, as a new
    float64 (K, N) tensor on the card ``dev``, bit-identical to
    ``torch.as_tensor(np.array(u, np.float64), device=dev)``, with no
    full-size temporary on the host or the card.

    The destination is walked in the contiguous blocks of
    :func:`_upload_blocks`.  Block i is cast-copied on the host into pinned
    buffer i % 2 (``Tensor.copy_``, on the intra-op threads; numpy's own
    cast for what torch cannot view), then copied with ``non_blocking``
    straight into its slice of the destination on the current stream, so
    the work after it is ordered after it without a host synchronize.  A
    pinned buffer is refilled only after its last copy has left (an event),
    so the host's cast of block i + 1 runs during the copy of block i.  The
    pinned buffers come from PyTorch's cached pinned allocator, which holds
    a buffer back from reuse until its copies are done; the card holds the
    destination alone.  Spans: ``place.host_copy`` per host cast,
    ``place.upload`` per wait for a copy; counted in ``STAGED_UPLOADS``."""
    global STAGED_UPLOADS
    K, N = u.shape
    out = torch.empty((K, N), dtype=torch.float64, device=dev)
    blocks = _upload_blocks(K, N)
    src = _host_view(u)
    stream = torch.cuda.current_stream(out.device)
    size = max(((k1 - k0) * (j1 - j0) for k0, k1, j0, j1 in blocks), default=0)
    host = [torch.empty(size, dtype=torch.float64, pin_memory=True)
            for _ in range(min(2, len(blocks)))]
    left = [None, None]
    for i, (k0, k1, j0, j1) in enumerate(blocks):
        b = i % 2
        if left[b] is not None:
            with span("place.upload"):
                left[b].synchronize()
        stage = host[b][: (k1 - k0) * (j1 - j0)].view(k1 - k0, j1 - j0)
        with span("place.host_copy"):
            if src is None:
                np.copyto(stage.numpy(), u[k0:k1, j0:j1], casting="unsafe")
            else:
                stage.copy_(src[k0:k1, j0:j1])
        out[k0:k1, j0:j1].copy_(stage, non_blocking=True)
        left[b] = torch.cuda.Event()
        left[b].record(stream)
    STAGED_UPLOADS += 1
    return out


def u_kn_on(u_kn, device=None, rows=None):
    """u_kn[rows] (every row by default) as one tensor on ``device``
    (default: u's own): a host-resident u_kn is uploaded (float64) and no
    host copy is made, whole by :func:`_upload_whole`, selected rows from
    :func:`stream_columns`.  u_kn itself when it lies there and no rows are
    selected."""
    u = _as_tensor(u_kn)
    dt, dev = _work_on(u, device)
    if rows is None and _same_device(u.device, dev):
        return u
    if rows is None and u.device.type == "cpu" and dev.type == "cuda":
        return _upload_whole(u, dev)
    K = u.shape[0] if rows is None else len(rows)
    out = torch.empty((K, u.shape[1]), dtype=dt, device=dev)
    for s, e, u_c in stream_columns(u, dev, rows=rows):
        out[:, s:e] = u_c
    return out


def _vec(x, dt, dev):
    """A K-vector (numpy or tensor) as ``dt`` on ``dev``."""
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x, dtype=dt, device=dev)


def _like(x, u):
    """``x`` (numpy or tensor) as a tensor of u's dtype on u's device
    (K-vectors only); ``u`` is a tensor (:func:`_as_tensor`)."""
    return _vec(x, u.dtype, u.device)


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
    a = f_k[..., :, None] - u  # the chunk's one temporary; updated in place below
    a_max = a.max(dim=-2).values
    a_max = torch.where(torch.isfinite(a_max), a_max, 0.0)
    a.sub_(a_max[..., None, :]).exp_().mul_(N_k[:, None])
    return torch.log(a.sum(dim=-2)) + a_max


def _prepare(u_kn, N_k, f_k, device=None):
    """(u tensor, N_k, f_k, device): the K-vectors in the work's dtype on
    the device the work runs on (:func:`_work_on`)."""
    u = _as_tensor(u_kn)
    dt, dev = _work_on(u, device)
    return u, _vec(N_k, dt, dev), _vec(f_k, dt, dev), dev


def log_denominator_n(u_kn, N_k, f_k):
    """Per-sample mixture log-normalizer: logsumexp_k[f_k - u_kn] weighted by N_k.

    Shapes: u_kn (K, N); N_k, f_k (K,).  Returns (N,).  Empty states
    (N_k == 0) drop out exactly.  Batched: u_kn (B, K, N) and f_k (B, K)
    give (B, N); :func:`core_stats`, :func:`self_consistent_update` (all
    states), :func:`mbar_gradient`, :func:`mbar_objective`,
    :func:`mbar_w_nk_gram` and :func:`mbar_hessian` take the same leading
    batch dimension.
    """
    u_kn, N_k, f_k, dev = _prepare(_placed(u_kn), N_k, f_k)
    out = torch.empty(u_kn.shape[:-2] + u_kn.shape[-1:], dtype=N_k.dtype, device=dev)
    for s, e, u_c in stream_columns(u_kn):
        out[..., s:e] = _logden_direct(u_c, N_k, f_k)
    return out


def _lse_init(shape, dt, dev):
    """(running max, rescaled sum) of an empty logsumexp of ``shape``."""
    return (torch.full(shape, -torch.inf, dtype=dt, device=dev),
            torch.zeros(shape, dtype=dt, device=dev))


def _lse_add(m, acc, a):
    """Fold a chunk's terms ``a`` (..., nc), consumed in place, into a
    running logsumexp over the last axis (flash-style rescaling)."""
    m_new = torch.maximum(m, a.max(dim=-1).values)
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    return m_new, acc * torch.exp(m - m_safe) + a.sub_(m_safe[..., None]).exp_().sum(dim=-1)


def _lse_end(m, acc):
    return torch.log(acc) + torch.where(torch.isfinite(m), m, 0.0)


def _log_numerator_k(u_kn, logden_n):
    """Per-state reweighted log-sum logsumexp_n[-logden_n - u_kn], streamed
    over column chunks with a running max."""
    u_kn = _as_tensor(u_kn)
    m, acc = _lse_init(u_kn.shape[:-1], logden_n.dtype, u_kn.device)
    for c0, c1, u_c in stream_columns(u_kn):
        m, acc = _lse_add(m, acc, -logden_n[..., None, c0:c1] - u_c)
    return _lse_end(m, acc)


def _core_pass(u_kn, N_k, f_k, dev, rows=None):
    """(logden_n, lognum_k) in one pass over u's column chunks (of the rows
    ``rows`` when given, which N_k and f_k already follow): each chunk's
    log-denominators, then its share of :func:`_log_numerator_k`."""
    lead = u_kn.shape[:-2]
    logden = torch.empty(lead + u_kn.shape[-1:], dtype=N_k.dtype, device=dev)
    m, acc = _lse_init(lead + N_k.shape[-1:], N_k.dtype, dev)
    for c0, c1, u_c in stream_columns(u_kn, dev, rows=rows):
        ld = _logden_direct(u_c, N_k, f_k)
        logden[..., c0:c1] = ld
        m, acc = _lse_add(m, acc, -ld[..., None, :] - u_c)
    return logden, _lse_end(m, acc)


def core_stats(u_kn, N_k, f_k, device=None, rows=None):
    """One fused pass producing (objective, gradient, f_sci).

    obj   = sum_n logden_n - N_k . f_k
    grad  = -N_k (1 - exp(f_k + lognum_k))          [Eq. C6]
    f_sci = -lognum_k                                [Eq. C3]

    ``rows`` restricts the pass to those rows of u_kn (N_k and f_k then
    hold theirs only); ``device`` is where it runs (:func:`stream_columns`).
    """
    u_kn, N_k, f_k, dev = _prepare(_placed(u_kn, device), N_k, f_k, device)
    logden, lognum = _core_pass(u_kn, N_k, f_k, dev, rows)
    obj = logden.sum(dim=-1) - f_k @ N_k
    grad = -N_k * (1.0 - torch.exp(f_k + lognum))
    return obj, grad, -lognum


def self_consistent_update(u_kn, N_k, f_k, states_with_samples=None, device=None):
    """Improved f_k guess via Eq. C3 (reference mbar_solvers.py:206-257).

    Only states in ``states_with_samples`` feed the denominator when given
    (each chunk gathers those rows).  One pass over u_kn on ``device``.
    """
    u_kn, N_k, f_k, dev = _prepare(_placed(u_kn, device), N_k, f_k, device)
    rows = None
    if states_with_samples is not None:
        rows = np.asarray(states_with_samples)
        sel = torch.as_tensor(rows, device=dev)
        N_k, f_k = N_k[sel], f_k[sel]
    return -_core_pass(u_kn, N_k, f_k, dev, rows)[1]


def mbar_gradient(u_kn, N_k, f_k, device=None, rows=None):
    """Gradient of the MBAR objective, Eq. C6 (reference mbar_solvers.py:260-292)."""
    return core_stats(u_kn, N_k, f_k, device, rows)[1]


def mbar_objective(u_kn, N_k, f_k):
    """MBAR objective (reference mbar_solvers.py:295-339)."""
    u_kn, N_k, f_k, _dev = _prepare(_placed(u_kn), N_k, f_k)
    return log_denominator_n(u_kn, N_k, f_k).sum(dim=-1) - f_k @ N_k


def mbar_objective_and_gradient(u_kn, N_k, f_k):
    """Fused objective + gradient (reference mbar_solvers.py:341-392)."""
    obj, grad, _ = core_stats(u_kn, N_k, f_k)
    return obj, grad


# -----------------------------------------------------------------------------
# Gram-form aggregates
# -----------------------------------------------------------------------------


def _weights(u_c, f_k, logden_c):
    """The chunk's weights W^T = exp(f_k - u_kn - logden_n), (K, nc)."""
    return (f_k[..., :, None] - u_c).sub_(logden_c[..., None, :]).exp_()


def mbar_w_nk_gram(u_kn, N_k, f_k):
    """(W^T W, colsum W) in u's dtype, in one pass over column chunks.

    W[n, k] = exp(f_k - u_kn[k, n] - logden_n).  These are the only
    aggregates the Hessian (Eq. C9) needs.
    """
    u_kn, N_k, f_k, dev = _prepare(_placed(u_kn), N_k, f_k)
    K = u_kn.shape[-2]
    gram = torch.zeros(u_kn.shape[:-1] + (K,), dtype=N_k.dtype, device=dev)
    colsum = torch.zeros(u_kn.shape[:-1], dtype=N_k.dtype, device=dev)
    for _s, _e, u_c in stream_columns(u_kn):
        w = _weights(u_c, f_k, _logden_direct(u_c, N_k, f_k))
        gram += _matmul(w, w.mT)
        colsum += w.sum(dim=-1)
    return gram, colsum


def mbar_hessian(u_kn, N_k, f_k):
    """Hessian of the MBAR objective, Eq. C9 (reference mbar_solvers.py:395-436)."""
    u_kn, N_k, f_k, _dev = _prepare(_placed(u_kn), N_k, f_k)
    gram, colsum = mbar_w_nk_gram(u_kn, N_k, f_k)
    H = gram * N_k[None, :] * N_k[:, None]
    H -= torch.diag_embed(colsum * N_k)
    return -H


def mbar_W_nk(u_kn, N_k, f_k):
    """Normalized weights, Eq. 9, materialized in (N, K) layout (reference
    mbar_solvers.py:479-507).  Only for small validation paths."""
    u_kn = _placed(u_kn)
    f_k = _like(f_k, u_kn)
    return _weights(u_kn, f_k, log_denominator_n(u_kn, N_k, f_k)).T


def _log_w_blocks(u_kn, N_k, f_k, device=None):
    """Yield (s, e, block): the (K, e - s) normalized log-weights
    f_k - u_kn - logden_n of each column chunk, on ``device`` (default:
    u's own), in one pass."""
    u_kn, N_k, f_k, dev = _prepare(u_kn, N_k, f_k, device)
    for s, e, u_c in stream_columns(u_kn, dev):
        yield s, e, (f_k[:, None] - u_c).sub_(_logden_direct(u_c, N_k, f_k)[None, :])


def mbar_log_W_nk(u_kn, N_k, f_k, device=None):
    """Normalized log-weights f_k - u_kn - logden_n, Eq. 9, as a contiguous
    (N, K) tensor on ``device`` (default: u's own; reference
    mbar_solvers.py:439-476).  Each column chunk's (K, nc) block
    (:func:`_log_w_blocks`) is written transposed into the output, so the
    only full-size allocation is the result itself."""
    u = _placed(u_kn, device)
    dt, dev = _work_on(u, device)
    K, N = u.shape
    out = torch.empty((N, K), dtype=dt, device=dev)
    for s, e, blk in _log_w_blocks(u, N_k, f_k, dev):
        out[s:e] = blk.T
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
    for s, e, u_c in stream_columns(u_kn32):
        w = _weights(u_c, f_k32, logden[s:e])
        # W columns normalize to 1 regardless of u, so sentinel pad
        # columns would be phantom weight-1 samples: zero them.
        w.masked_fill_(u_c >= _PAD_THRESHOLD, 0.0)
        wc = w if c32 is None else w * c32[None, s:e]
        gram += _matmul(wc, w.T).to(torch.float64)
        colsum += wc.sum(dim=1).to(torch.float64)
    return gram, colsum


def _tsqr_fold(R, rows):
    """The R factor of a tall-skinny QR after ``rows`` (n, m) are appended
    to the rows R was folded from: the chunk's own R
    (``torch.linalg.qr(mode="r")``, Q never formed), stacked under R and
    refactored.  R^T R is the Gram of every row folded in, so the SVD of
    R has their Sigma and V.  The result holds no reference to ``rows``
    (a staging buffer may be reused once this returns)."""
    R_c = torch.linalg.qr(rows, mode="r")[1]
    return R_c if R is None else torch.linalg.qr(torch.cat([R, R_c]), mode="r")[1]


def _tsqr_rows(W):
    """The R factor of the (N, m) W, folded over row blocks of at most
    ``_CHUNK_BYTES`` (:func:`_tsqr_fold`), on W's device: no N x m copy is
    made besides W."""
    R = None
    for s, e in _col_ranges(W.shape[1], W.element_size(), 0, W.shape[0]):
        R = _tsqr_fold(R, W[s:e])
    return R


def mbar_gram_normalization(u_kn, N_k, f_k, tolerance=1.0e-4, sampled=None,
                            extra_rows=None, observable=None, device=None, tsqr=False):
    """(W^T W, colsum W, row-check stats) in one streamed f64 pass.

    The aggregates the covariance estimators (Eq. D4/D5, Kong 2003) and the
    reference's ``check_w_normalized`` need: Gram and per-state column sums,
    plus (bad row count, first bad row index, its row sum) for the
    sum_k N_k W_nk = 1 check, without an N-sized host array.  Computes in
    the work's dtype on ``device`` (default: u's own; float64 on the card:
    the JAX package's float32 here was a TPU-only choice).  Each chunk's
    weights and their sums come from
    :func:`~pymbar_tpu_torch.ops.gram_weights.gram_weights` (one kernel on
    the card).

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

    The callbacks receive u's chunks on ``device``.  With ``tsqr`` the
    first result is the R factor of W (every row, extra rows too) folded
    chunk by chunk (:func:`_tsqr_fold`) in place of the Gram: R^T R =
    W^T W, and the SVD of R gives W's Sigma and V (the 'svd' covariance).
    """
    # imported here: the module imports this one
    from pymbar_tpu_torch.ops.gram_weights import gram_weights

    u_kn, N_k, f_k, dev = _prepare(_placed(u_kn, device), N_k, f_k, device)
    dt = N_k.dtype
    K, N = u_kn.shape
    if sampled is not None:
        sampled = torch.as_tensor(sampled, device=dev)
    gram = colsum = None
    big = torch.tensor(N + 1, dtype=torch.int64, device=dev)
    cnt = torch.zeros((), dtype=torch.int64, device=dev)
    fidx = big.clone()
    fval = torch.zeros((), dtype=torch.float64, device=dev)
    if observable is not None:
        m1 = torch.zeros((K, K), dtype=dt, device=dev)
        m2 = torch.zeros_like(m1)
        c_a = torch.zeros(K, dtype=dt, device=dev)
    for s, e, u_c in stream_columns(u_kn, dev):
        w, logden, rowsum, w_sum = gram_weights(u_c, N_k, f_k, sampled)
        rowsum = rowsum.to(torch.float64)
        if observable is not None:
            a = observable(s, e, u_c)
            wa = w * (a[None, :] if a.ndim == 1 else a)
            m1 += _matmul(w, wa.T)
            m2 += _matmul(wa, wa.T)
            c_a += wa.sum(dim=1)
        if extra_rows is not None:
            rows = extra_rows(s, e, u_c, logden)
            w, w_sum = torch.cat([w, rows]), torch.cat([w_sum, rows.sum(dim=1)])
        if colsum is None:
            colsum = torch.zeros(w.shape[0], dtype=dt, device=dev)
            if not tsqr:
                gram = torch.zeros((w.shape[0],) * 2, dtype=dt, device=dev)
        if tsqr:
            gram = _tsqr_fold(gram, w.T)
        else:
            gram += _matmul(w, w.T)
        colsum += w_sum
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
    u_kn (B, K, N) preconditions every replicate of a batch around the same
    (K,) f_k.
    """
    u_kn = _placed(u_kn)
    N_k, f_k = _like(N_k, u_kn), _like(f_k, u_kn)
    c_shift = torch.dot(N_k, f_k) / N_k.sum()
    out = torch.empty_like(u_kn)
    for s, e, u_c in stream_columns(u_kn):
        sl = u_c - u_c.min(dim=-2).values[..., None, :]
        out[..., s:e] = sl.add_((_logden_direct(sl, N_k, f_k) - c_shift)[..., None, :])
    return out
