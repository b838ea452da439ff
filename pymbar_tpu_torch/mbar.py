"""The MBAR estimator class (PyTorch port).

The counterpart of :class:`pymbar_tpu.mbar.MBAR` (reference pymbar 4.x
mbar.py:64-1988): the same constructor surface (initialization by zeros,
mean reduced potential or a BAR chain), result-dictionary schemas and
uncertainty methods None / 'svd-ew' / 'approximate' / 'svd' / 'bootstrap';
the free-energy differences, the weights (``Log_W_nk``, ``W_nk``,
``weights()``), the effective sample numbers and the overlap; the
expectations (``compute_expectations``, ``compute_multiple_expectations``,
``compute_expectations_inner``), the free energies of perturbed states,
the entropy and enthalpy and the covariance of sums; the solve on a 1-D
device mesh (``mesh=``) and bootstrap replicates (``n_bootstraps=``), on
one device or, with every state sampled, on the mesh's sharded planes.

``self.u_kn`` is the stored matrix and ``self.device`` where the work runs.
A tensor stays where it is and the work runs there; a numpy array goes to
``device`` as a float64 tensor (default: ``PYMBAR_TPU_TORCH_DEVICE`` when
set, else the CUDA card; without one, pass ``device="cpu"`` or set
``PYMBAR_TPU_TORCH_DEVICE=cpu``; :func:`pymbar_tpu_torch.config.target_device`).
A CPU tensor with a CUDA ``device`` is host-resident:
``MBAR(torch.from_numpy(u), N_k, device="cuda")`` copies nothing, and
every pass over u_kn streams its column chunks to the card through two
pinned staging buffers (``mbar_core.stream_columns``): the dd split into
the planes, the Gram of Theta, N_eff and the overlap, 'svd' (W's R
factor folded chunk by chunk), ``Log_W_nk`` and ``W_nk`` (into host
memory), the expectations' passes, the BAR and mean-reduced-potential
starts (only what they gather), the bootstrap replicates off the counts
route (each replicate's columns copied on the card out of the uploaded
column chunks).  The card then holds the dd planes and chunk-sized
buffers, never the float64 matrix, except where a route reads it whole,
as the JAX package's does: a protocol other than "dd" (below the dd gate,
or asked for) uploads it for the solve and frees it after, and the
expectations below ``_AUG_STREAM_BYTES`` upload it too.  Theta's K x K algebra
runs where the Gram is: on the card through the rank-nnz form, on the
CPU through the dense numpy eigh + pinv.  The expectations augment the
states on ``self.device``: below ``_AUG_STREAM_BYTES`` of u_kn they build
the N x (K + NL + S) log-weights, above it they stream u_kn's column
chunks through two passes and never form that matrix.
"""

import logging

import numpy as np
import torch

from pymbar_tpu_torch import solvers as mbar_solvers
from pymbar_tpu_torch.ops.mbar_core import (
    _log_w_blocks,
    _logden_direct,
    _same_device,
    _tsqr_rows,
    _work_on,
    log_denominator_n,
    mbar_gram_normalization,
    mbar_log_W_nk,
    stream_columns,
    u_kn_on,
)
from pymbar_tpu_torch.ops.logsumexp import logsumexp
from pymbar_tpu_torch.other_estimators import bar
from pymbar_tpu_torch.parallel.sharding import (
    _sharded_solve_mbar_for_all_states,
    default_mesh,
)
from pymbar_tpu_torch.solvers import (
    BOOTSTRAP_SOLVER_PROTOCOL,
    DEFAULT_SOLVER_PROTOCOL,
    JAX_SOLVER_PROTOCOL,
    ROBUST_SOLVER_PROTOCOL,
    target_device,
)
from pymbar_tpu_torch.solvers_large import solve_mbar_dd_bootstrap
from pymbar_tpu_torch.utils import (
    ConvergenceError,
    DataError,
    ParameterError,
    check_w_normalized,
    kln_to_kn,
    kn_to_n,
)

logger = logging.getLogger(__name__)

__all__ = ["MBAR"]

# dd-route threshold: a default-protocol solve of a CUDA u_kn at least this
# large rides the two-phase double-word solver (solvers_large) instead of
# the f64 adaptive solver.  Measured on an H100 (PERF.md, "Route gate"): dd
# is ahead by >= 15% from 8 MB up (40x at 8 GB) while below ~2 MB both
# routes are launch-bound and tie, so smaller problems keep the default
# protocol and its hybr fallback.  Module constant so tests can move it.
_DD_ROUTE_BYTES = 8 * 2**20

# Up to this many bytes of a CUDA u_kn, bootstrap replicates that do not
# ride the dd counts route (a small problem below _DD_ROUTE_BYTES, or an
# empty state) are solved batched (solvers.batched_bootstrap_solve), each
# chunk of replicates gathered at once; above it, one by one.  It is the
# largest size read, not a speed crossover.  On an 80 GB H100 (PERF.md)
# the batched route took 0.05-0.07 of the sequential route's time at 6.1
# MB, 0.47-0.62 at 67 MB, 0.83-0.93 at 268-545 MB and 0.98-1.02 at 2.1 GB;
# from 4.3 GB up a chunk holds one replicate, and the route runs the
# sequential route's passes at its peak (14.0 GB at 4.3 GB, 27.6 GB at
# 8.6 GB) in 0.95-0.99 of its time.  Larger problems were not read.
# Module constant so tests can move it.
_BATCHED_BOOT_BYTES = 8 * 2**30

# From this many bytes of u_kn up, compute_expectations_inner streams u_kn's
# column chunks through the augmented passes instead of building the
# N x (K + NL + S) log-weights.  Measured on an H100 (PERF.md §5,
# profiling/torch_profile.py expectations): from 1 MB to 1 GB the streamed
# branch takes the entropy in 0.35-0.85 of the time, and the expectations
# in about the same time (within ~3 ms) up to 17 MB and in less above;
# below 1 MB nothing was measured, and the reference's branch stays.
# Module constant so tests can move it.
_AUG_STREAM_BYTES = 2**20

# Collapse the aliased augmented Gram to three K x K Grams when eligible
# (see _aug_pass_b_struct); module switch so tests can pin the structured
# assembly against the general augmented Gram.
_STRUCT_AUG_GRAM = True

# Streamed pass-B forms run: the structured Gram with one shared observable
# row ("logrow"), with observable row k at state k ("diag"), and the general
# (K + NL + S)^2 Gram.  Each pass adds one where it runs.
AUG_B_LOGROW_PASSES = 0
AUG_B_DIAG_PASSES = 0
AUG_B_GENERAL_PASSES = 0


def bootstrap_counts(bootstrap_rints, n_total):
    """(B, N) per-sample multiplicities of every replicate's resample
    indices (the definition of a counts-weighted replicate), as the dd
    counts route builds them: uint16, widened to float32 if a multiplicity
    above 65535 appears."""
    counts = np.zeros((len(bootstrap_rints), n_total), np.uint16)
    for b, rints in enumerate(bootstrap_rints):
        row = np.bincount(rints, minlength=n_total)
        if row.max() > 65535 and counts.dtype == np.uint16:
            counts = counts.astype(np.float32)
        counts[b] = row
    return counts


def _unnormalized_log_weights(u_kn, u_n, N_k, f_k, device=None):
    """log w_n of a target state u_n, -logsumexp_k[f_k + u_n - u_kn] weighted
    by N_k, as an (N,) float64 tensor on ``device`` (default: u_kn's own):
    one pass over u_kn's column chunks, each column reduced alone
    (reference mbar.py:1919-1934)."""
    dev = _work_on(u_kn, device)[1]
    f = torch.as_tensor(np.asarray(f_k, dtype=np.float64), device=dev)[:, None]
    b = torch.as_tensor(np.asarray(N_k, dtype=np.float64), device=dev)[:, None]
    u_n = torch.as_tensor(u_n, dtype=torch.float64, device=dev)
    out = torch.empty(u_kn.shape[1], dtype=torch.float64, device=dev)
    for s, e, u_c in stream_columns(u_kn, dev):
        out[s:e] = -logsumexp(f + u_n[None, s:e] - u_c, axis=0, b=b)
    return out


def _kln_tensor(u_kln, N_k):
    """A (K, L, N_max) u_kln tensor as (L, N), sample blocks in state order."""
    K, _L, N_max = u_kln.shape
    slot = torch.arange(N_max, device=u_kln.device)
    n_k = torch.as_tensor(N_k[:K], device=u_kln.device)
    return u_kln.permute(1, 0, 2)[:, slot[None, :] < n_k[:, None]]


def _place(u_kn, N_k, device):
    """(u_kn, the device the work runs on) for :class:`MBAR`.

    A CPU tensor with a CUDA ``device`` is host-resident: it is kept as
    given (any dtype and layout; a u_kln is laid out as (L, N) on the
    host) and every pass streams its column chunks to the card.  Without
    a card that raises as :func:`target_device` does.  Anything else is
    placed by :func:`_u_tensor` and the work runs where it lies."""
    if (torch.is_tensor(u_kn) and u_kn.device.type == "cpu" and device is not None
            and torch.device(device).type == "cuda"):
        dev = _work_on(u_kn, target_device(device))[1]
        return (_kln_tensor(u_kn, N_k) if u_kn.ndim == 3 else u_kn), dev
    u = _u_tensor(u_kn, N_k, device)
    return u, u.device


def _u_tensor(u_kn, N_k, device):
    """u_kn as a float64 (K, N) tensor.  A tensor keeps its device (and must
    match ``device`` when one is given); numpy goes to ``device``, by
    default the CUDA card (:func:`target_device`)."""
    if torch.is_tensor(u_kn):
        if device is not None and not _same_device(device, u_kn.device):
            raise ParameterError(
                f"u_kn lies on {u_kn.device} but device={device!r} was given; "
                "move the tensor explicitly"
            )
        if u_kn.ndim == 3:
            u_kn = _kln_tensor(u_kn, N_k)
        return u_kn.to(torch.float64).contiguous()
    if np.ndim(u_kn) == 3:
        u_kn = kln_to_kn(np.asarray(u_kn), N_k=N_k)
    return torch.as_tensor(np.array(u_kn, dtype=np.float64), device=target_device(device))


def _host(x):
    """A tensor as a numpy array (the layout converters are numpy); anything
    else as it is."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else x


def _f64(x, copy=False):
    """x in float64: a tensor stays a tensor on its device, anything else
    becomes a numpy array."""
    if torch.is_tensor(x):
        return x.detach().to(torch.float64, copy=copy)
    return np.array(x, dtype=np.float64) if copy else np.asarray(x, dtype=np.float64)


def _cols(x, c0, c1, dev):
    """Columns c0:c1 of a numpy array or tensor as float64 on ``dev``: a
    numpy input or a host tensor goes to the card one chunk at a time."""
    return torch.as_tensor(x[..., c0:c1], dtype=torch.float64, device=dev)


def _finite(m):
    return torch.where(torch.isfinite(m), m, 0.0)


def _idx_mode(idx, nrows):
    """How the rows ``idx`` select from ``nrows`` rows: "empty";
    "identity" (idx == arange(nrows): the rows as they are); "zero" (every
    idx is 0: row 0 repeated); else "gather"."""
    idx = np.asarray(idx)
    if idx.size == 0:
        return "empty"
    if idx.size == nrows and np.array_equal(idx, np.arange(nrows)):
        return "identity"
    if np.all(idx == 0):
        return "zero"
    return "gather"


def _rows(x, idx, mode):
    """x[idx] for an index pattern classified by :func:`_idx_mode`: the rows
    themselves, a broadcast view of row 0, or ``index_select``, which
    carries +-inf and NaN as they are."""
    if mode == "identity":
        return x
    if mode == "zero":
        return x[:1].expand(idx.shape[0], -1)
    return x.index_select(0, idx)


def _aug_a_body(u_c, ul_c, la_c, sampled, N_s, f_s, lidx, lidx_mode, c=None, a_mode="log"):
    """Pass-A chunk math: for one column chunk, each extra state's and each
    observable pseudo-state's partial (max, rescaled sum) pair.

    The log-denominator runs over the sampled rows ``sampled`` (None: every
    row) with their N_s, f_s, so an empty state sets no column max.  Extra
    state l reduces a_l = -u_l - logden; pseudo-state s reduces
    la_s + a_{lidx[s]}, where ``la_c`` holds the (S, nc) log observable rows
    (``a_mode="log"``), or, with ``a_mode="diagmul"``, the raw shifted
    observable slab A = u - shift of entropy's aliased layout (pseudo-state
    k with extra state k): exp(log A + a_l - m) = A exp(a_l - m) exactly,
    so the pseudo-states reuse the extra states' exps under their shift.
    ``c`` holds optional per-sample counts, which make the sums a bootstrap
    replicate's over the same columns.
    """
    logden = _logden_direct(u_c if sampled is None else u_c.index_select(0, sampled), N_s, f_s)
    a_l = (-ul_c).sub_(logden[None, :])  # (NL, nc)
    if a_mode != "diagmul":
        a_s = la_c + _rows(a_l, lidx, lidx_mode)  # (S, nc)
    m_l = a_l.amax(dim=1)
    e_l = a_l.sub_(_finite(m_l)[:, None]).exp_()
    if a_mode == "diagmul":
        m_s = m_l
        e_s = la_c * e_l
    else:
        m_s = a_s.amax(dim=1)
        e_s = a_s.sub_(_finite(m_s)[:, None]).exp_()
    if c is not None:
        e_l.mul_(c[None, :])
        e_s.mul_(c[None, :])
    return m_l, e_l.sum(dim=1), m_s, e_s.sum(dim=1)


def _aug_combine(m, s, m_c, s_c):
    """Running-max rescaled-sum combine of (max, sum) pairs across chunks
    (flash-style logsumexp)."""
    m_new = torch.maximum(m, m_c)
    safe = _finite(m_new)
    return m_new, s * torch.exp(m - safe) + s_c * torch.exp(m_c - safe)


def _assemble_struct_gram(M0, M1, M2, D_L, E, l_of_s):
    """The (K + NL + S)^2 augmented Gram of the aliased layouts from the
    three K x K Grams of the structured pass B, on their device:
    W_L = diag(D_L) W_0 and W_S = diag(E) (A o W_0)[l_of_s] give

        [[M0,         M0 D_L,        M1s E     ],
         [D_L M0,     D_L M0 D_L,    D_L M1s E ],
         [E M1s^T,    E M1s^T D_L,   E M2ss E  ]]

    with M1s = M1[:, l_of_s] and M2ss = M2[l_of_s][:, l_of_s]."""
    dev = M0.device
    D_L = torch.as_tensor(D_L, dtype=M0.dtype, device=dev)
    E = torch.as_tensor(E, dtype=M0.dtype, device=dev)
    if _idx_mode(l_of_s, M0.shape[0]) == "identity":
        M1s, M2ss = M1, M2
    else:
        lidx = torch.as_tensor(l_of_s, device=dev)
        M1s = M1.index_select(1, lidx)
        M2ss = M2.index_select(0, lidx).index_select(1, lidx)
    G0L = M0 * D_L[None, :]
    GLL = D_L[:, None] * M0 * D_L[None, :]
    G0S = M1s * E[None, :]
    GLS = D_L[:, None] * G0S
    GSS = E[:, None] * M2ss * E[None, :]
    return torch.cat([
        torch.cat([M0, G0L, G0S], dim=1),
        torch.cat([G0L.T, GLL, GLS], dim=1),
        torch.cat([G0S.T, GLS.T, GSS], dim=1),
    ])


class MBAR:
    """Multistate Bennett acceptance ratio estimator on PyTorch.

    Parameters are those of :class:`pymbar_tpu.MBAR`, plus ``device``: where
    a numpy ``u_kn`` is placed (default ``PYMBAR_TPU_TORCH_DEVICE``, else
    "cuda", and without a card a :class:`ParameterError` that asks for
    ``device="cpu"``; a tensor's own device is used as it is).  A CPU
    tensor with a CUDA ``device`` is host-resident: ``self.u_kn`` keeps the
    caller's tensor in host memory
    (``MBAR(torch.from_numpy(u), N_k, device="cuda")`` copies nothing) and
    the work runs on ``self.device``, every pass streaming u_kn's column
    chunks through pinned staging to the card (see the module docstring).
    ``self.device`` is where the work runs in every mode.

    ``initialize="BAR"`` chains pairwise BAR along adjacent sampled states:
    each pair's work values are gathered from ``u_kn`` on its device in one
    pass and handed to the host :func:`pymbar_tpu_torch.bar`.

    ``n_bootstraps``: replicates drawn with the object's numpy
    ``default_rng(rseed)`` in the JAX package's order (replicate, then
    state), so a seed gives ``pymbar_tpu.MBAR``'s ``bootstrap_rints``.  On
    a dd or mesh solve with every state sampled, no BAR start and the
    default bootstrap protocol they ride the base solve's planes as
    counts-weighted polishes
    (:func:`pymbar_tpu_torch.solvers_large.solve_mbar_dd_bootstrap`, or on
    the mesh
    :func:`pymbar_tpu_torch.parallel.sharding.sharded_bootstrap_polish_dd`;
    both set ``bootstrap_at_floor``).  Otherwise, on a CUDA ``u_kn`` of at
    most ``_BATCHED_BOOT_BYTES`` with no BAR start and the default
    bootstrap protocol, every replicate is solved batched
    (:func:`pymbar_tpu_torch.solvers.batched_bootstrap_solve`); else each
    is solved in turn on ``u_kn[:, rints]`` under
    ``bootstrap_solver_protocol``, as on the CPU.

    ``mesh``: a :class:`pymbar_tpu_torch.parallel.Mesh` solves the sampled
    states by the sample-sharded double-word solver
    (:func:`pymbar_tpu_torch.parallel.sharding.sharded_solve_mbar_for_all_states`);
    "auto" takes every visible card when there are several, else no mesh.
    An explicit ``solver_protocol`` wins over a mesh, with a warning.
    ``self.mesh`` holds the mesh used (None when none).  Without a mesh, a
    CUDA ``u_kn`` of at least ``_DD_ROUTE_BYTES`` with no explicit
    ``solver_protocol`` is solved by the two-phase double-word solver
    (:func:`pymbar_tpu_torch.solvers_large.solve_mbar_dd`, whose polish runs
    on the hand-written ``wsum_dd`` kernel), sharded over every card when
    there are several; otherwise the protocol runs as in the JAX package.
    ``solver_protocol`` holds the resolved protocol (the default one on the
    mesh route, as in the JAX package) and ``solver_results`` each stage's
    result dict.  ``u_kn`` itself stays on its one device: the free
    energies stream it there.

    Examples
    --------
    >>> import numpy as np
    >>> from pymbar_tpu_torch import MBAR
    >>> from pymbar_tpu_torch.testsystems import HarmonicOscillatorsTestCase
    >>> tc = HarmonicOscillatorsTestCase(O_k=[0.0, 1.0, 2.0], K_k=[1.0, 1.5, 2.0])
    >>> x_n, u_kn, N_k, s_n = tc.sample(N_k=[400, 300, 300], mode="u_kn", seed=7)
    >>> mbar = MBAR(u_kn, N_k)
    >>> results = mbar.compute_free_energy_differences()
    >>> sorted(results)
    ['Delta_f', 'dDelta_f']
    >>> fa = tc.analytical_free_energies(); fa = fa - fa[0]
    >>> bool(np.all(np.abs(results["Delta_f"][0] - fa) < 6 * (results["dDelta_f"][0] + 1e-8)))
    True
    """

    def __init__(
        self,
        u_kn,
        N_k,
        maximum_iterations=10000,
        relative_tolerance=1.0e-7,
        verbose=False,
        initial_f_k=None,
        solver_protocol=None,
        initialize="zeros",
        x_kindices=None,
        n_bootstraps=0,
        bootstrap_solver_protocol=None,
        rseed=None,
        mesh=None,
        device=None,
    ):
        if n_bootstraps < 0:
            logger.warning("n_bootstraps must be an integer >= 0")

        self.N_k = np.array(N_k, dtype=np.int64)
        self.u_kn, self.device = _place(u_kn, self.N_k, device)
        K, N = self.u_kn.shape

        if verbose:
            logger.info(f"K (total states) = {K:d}, total samples = {N:d}")

        if np.sum(self.N_k) != N:
            raise ParameterError(
                "The sum of all N_k must equal the total number of samples "
                "(length of second dimension of u_kn."
            )

        self.K = K
        self.N = N

        if x_kindices is not None:
            self.x_kindices = np.array(x_kindices, dtype=np.int64)
        else:
            self.x_kindices = np.repeat(np.arange(K, dtype=np.int64), self.N_k)

        self.verbose = verbose

        if rseed is None:
            rseed = np.random.randint(np.iinfo(np.int32).max)
        self.rng = np.random.default_rng(rseed)
        self._scan_duplicate_states(relative_tolerance)

        self.states_with_samples = np.where(self.N_k != 0)[0].astype(np.int64)
        self.K_nonzero = self.states_with_samples.size
        if verbose:
            logger.info(f"There are {self.K_nonzero:d} states with samples.")

        self.f_k = np.zeros(self.K, dtype=np.float64)
        if initial_f_k is not None:
            initial_f_k = np.array(initial_f_k, dtype=np.float64)
            if initial_f_k.shape != self.f_k.shape:
                raise ParameterError(
                    f"initial_f_k must be a {self.K:d}-dimensional np array."
                )
            self.f_k = initial_f_k - initial_f_k[0]
        else:
            self._initializeFreeEnergies(verbose, method=initialize, f_k_init=initial_f_k)

        # The mesh front door: mesh="auto" takes every visible card when
        # there are several; a Mesh is honored as it is.  An explicit
        # solver_protocol wins over the mesh, with a warning.
        several = torch.cuda.device_count() > 1
        if mesh == "auto":
            mesh = default_mesh() if several else None
        self.mesh = mesh
        if mesh is not None and solver_protocol is not None:
            logger.warning(
                "Both mesh and an explicit solver_protocol were given; the "
                "explicit protocol runs on the default device and the mesh "
                "is ignored for the solve."
            )
            self.mesh = mesh = None

        # The route gate: large CUDA problems with no protocol take the
        # double-word solver, sharded over every card when there are several.
        if solver_protocol is None and mesh is None and self._dd_sized():
            if several:
                self.mesh = mesh = default_mesh()
            else:
                solver_protocol = (dict(method="dd", options=dict()),)

        self.solver_protocol = self._resolve_protocol(
            solver_protocol, DEFAULT_SOLVER_PROTOCOL, maximum_iterations
        )
        bootstrap_solver_protocol = self._resolve_protocol(
            bootstrap_solver_protocol, BOOTSTRAP_SOLVER_PROTOCOL, maximum_iterations
        )

        # Every replicate's resample indices, drawn before the solve (the
        # stream is the JAX package's: nothing else consumes it in between).
        self.n_bootstraps = max(int(n_bootstraps), 0)
        self.bootstrap_at_floor = None
        counts = None
        default_boot = (
            initialize != "BAR"
            and len(bootstrap_solver_protocol) == 1
            and bootstrap_solver_protocol[0]["method"] == "adaptive"
        )
        if self.n_bootstraps > 0:
            self.bootstrap_rints = self._draw_bootstrap_rints(self.n_bootstraps)
            dd_stage = (
                mesh is None
                and len(self.solver_protocol) == 1
                and self.solver_protocol[0]["method"] == "dd"
            )
            if default_boot and self.K_nonzero == self.K and (mesh is not None or dd_stage):
                counts = bootstrap_counts(self.bootstrap_rints, self.N)

        f_boots = None
        if mesh is not None:
            if counts is not None:
                (self.f_k, self.solver_results, f_boots, n_fail,
                 boot_info) = _sharded_solve_mbar_for_all_states(
                    self.u_kn, self.N_k, self.f_k, self.states_with_samples, mesh,
                    bootstrap_counts=counts, verbose=verbose,
                )
                self.bootstrap_at_floor = boot_info["at_floor"]
            else:
                self.f_k, self.solver_results = _sharded_solve_mbar_for_all_states(
                    self.u_kn, self.N_k, self.f_k, self.states_with_samples, mesh
                )
        elif counts is not None:
            stage = self.solver_protocol[0]
            self.f_k, f_boots, n_fail, info = solve_mbar_dd_bootstrap(
                self.u_kn, self.N_k, self.f_k, counts,
                tol=stage.get("tol", 1.0e-12), options=stage.get("options"), verbose=verbose,
                device=self.device,
            )
            self.solver_results = [dict(x=self.f_k, success=bool(info["converged"]), info=info)]
            self.bootstrap_at_floor = info["bootstrap_at_floor"]
            if not info["converged"]:
                logger.warning(
                    "dd MBAR solve did not converge to within tolerance "
                    f"(gnorm={info['gnorm']:.3e})"
                )
        else:
            self.f_k, self.solver_results = mbar_solvers._solve_mbar_for_all_states(
                self.u_kn, self.N_k, self.f_k, self.states_with_samples, self.solver_protocol,
                device=self.device,
            )

        if self.n_bootstraps > 0:
            if f_boots is None and default_boot and self._batched_boot_sized():
                f_boots, n_fail = self._bootstrap_solve_batched(
                    bootstrap_solver_protocol[0], verbose
                )
            if f_boots is None:
                f_boots = self._bootstrap_sequential(
                    bootstrap_solver_protocol, verbose, bar_start=initialize == "BAR"
                )
            elif n_fail:
                logger.warning(
                    f"{n_fail:d}/{self.n_bootstraps:d} bootstrap replicates did not "
                    "converge to within tolerance."
                )
            self.f_k_boots = f_boots

        # Log_W_nk materializes on first access: an N x K array that
        # solve-only users never need.
        self._Log_W_nk = None
        self._Log_W_nk_assigned = False

        if self.verbose:
            logger.info(f"Final dimensionless free energies f_k = {self.f_k}")

    def _u_bytes(self):
        """u_kn's size in float64, the dtype the work runs in."""
        return 8 * self.K * self.N

    def _dd_sized(self):
        """The route gate's size test: work on a card, u_kn of at least
        _DD_ROUTE_BYTES (host-resident or not)."""
        return self.device.type == "cuda" and self._u_bytes() >= _DD_ROUTE_BYTES

    def _batched_boot_sized(self):
        """The batched bootstrap's gate: work on a card, u_kn of at most
        _BATCHED_BOOT_BYTES (host-resident or not: the route copies each
        replicate's columns out of u_kn's column chunks on the card).  The
        CPU keeps the sequential route, as the JAX package does off a TPU."""
        return self.device.type == "cuda" and self._u_bytes() <= _BATCHED_BOOT_BYTES

    def _bootstrap_solve_batched(self, stage, verbose):
        """Every replicate solved batched on its resampled columns from the
        base f_k (:func:`pymbar_tpu_torch.solvers.batched_bootstrap_solve`),
        with the bootstrap stage's adaptive options and the tol of
        ``solve_mbar_once`` (the JAX package's mbar.py:1167-1188).
        Returns (f_k_boots (B, K), n_fail)."""
        options = stage.get("options") or {}
        return mbar_solvers.batched_bootstrap_solve(
            self.u_kn,
            self.N_k,
            self.f_k,
            self.bootstrap_rints,
            maxiter=int(options.get("maxiter", 10000)),
            min_sc_iter=int(options.get("min_sc_iter", 2)),
            gamma=float(options.get("gamma", 1.0)),
            tol=1.0e-12,
            verbose=verbose,
            device=self.device,
        )

    def _state_indices(self):
        """Each state's sample indices, ascending: ``np.where(x_kindices ==
        k)[0]`` for every k (the JAX package's per-state scans of N), from
        one stable sort."""
        order = np.argsort(self.x_kindices, kind="stable")
        starts = np.searchsorted(self.x_kindices[order], np.arange(self.K + 1))
        return [order[starts[k]:starts[k + 1]] for k in range(self.K)]

    def _draw_bootstrap_rints(self, n_bootstraps):
        """(B, N) resample indices from ``self.rng``, drawn replicate by
        replicate and state by state as the JAX package does (mbar.py:
        871-895)."""
        k_indices = self._state_indices()
        rints = np.zeros((n_bootstraps, self.N), int)
        for b in range(n_bootstraps):
            for k, idx in enumerate(k_indices):
                if len(idx) == 0:
                    continue
                n_k = int(self.N_k[k])
                rints[b, idx] = idx[self.rng.integers(n_k, size=n_k)]
        return rints

    def _bootstrap_sequential(self, bootstrap_solver_protocol, verbose, bar_start=False):
        """Each replicate solved in turn on its resampled columns
        ``u_kn[:, rints]`` from the base f_k, or with ``bar_start`` from a
        BAR chain on those columns (the JAX package's sequential route,
        mbar.py:1013-1031); a host-resident u_kn's columns are gathered on
        the host and uploaded.  Returns f_k_boots (B, K)."""
        f_k_boots = np.zeros((self.n_bootstraps, self.K))
        maxfrac = int(max(1, 0.1 * self.n_bootstraps))
        for b in range(self.n_bootstraps):
            rints = torch.as_tensor(self.bootstrap_rints[b], device=self.u_kn.device)
            u_b = self.u_kn.index_select(1, rints).to(self.device, torch.float64)
            f_k_init = self.f_k.copy()
            if bar_start:
                f_k_init = self._initialize_with_bar(u_b, f_k_init=self.f_k)
            f_k_boots[b], _ = mbar_solvers._solve_mbar_for_all_states(
                u_b, self.N_k, f_k_init, self.states_with_samples, bootstrap_solver_protocol,
            )
            if verbose and b % maxfrac == 0:
                logger.info(f"Calculated {b + 1:d}/{self.n_bootstraps:d} bootstrap samples")
        return f_k_boots

    @classmethod
    def from_solution(
        cls, u_kn, N_k, f_k, x_kindices=None, rseed=None, verbose=False, device=None
    ):
        """Construct an MBAR object around an ALREADY-CONVERGED solution.

        No solver stage runs: ``f_k`` is taken as the converged dimensionless
        free energies of ``(u_kn, N_k)`` (re-normalized to ``f_k[0] = 0``),
        e.g. from a checkpoint or from ``pymbar_tpu.MBAR(...).f_k``, and
        every ``compute_*`` surface then behaves as on a freshly solved
        object.  ``u_kn``, ``N_k`` and ``f_k`` may be numpy arrays; ``u_kn``
        is placed as in ``__init__`` (a CPU tensor with a CUDA ``device``
        stays in host memory).  Returns an MBAR with
        ``n_bootstraps = 0``.
        """
        self = cls.__new__(cls)
        self.N_k = np.array(N_k, dtype=np.int64)
        self.u_kn, self.device = _place(u_kn, self.N_k, device)
        K, N = self.u_kn.shape
        if int(np.sum(self.N_k)) != N:
            raise ParameterError(
                "The sum of all N_k must equal the total number of samples "
                "(length of second dimension of u_kn."
            )
        self.K = K
        self.N = N
        f_k = np.array(f_k, dtype=np.float64)
        if f_k.shape != (K,):
            raise ParameterError(f"f_k must be a {K:d}-dimensional np array.")
        self.f_k = f_k - f_k[0]
        if x_kindices is not None:
            self.x_kindices = np.array(x_kindices, dtype=np.int64)
        else:
            self.x_kindices = np.repeat(np.arange(K, dtype=np.int64), self.N_k)
        self.verbose = verbose
        if rseed is None:
            rseed = np.random.randint(np.iinfo(np.int32).max)
        self.rng = np.random.default_rng(rseed)
        self._scan_duplicate_states()
        self.states_with_samples = np.where(self.N_k != 0)[0].astype(np.int64)
        self.K_nonzero = self.states_with_samples.size
        self.n_bootstraps = 0
        self.mesh = None
        self.solver_protocol = ()
        self.solver_results = []
        self._Log_W_nk = None
        self._Log_W_nk_assigned = False
        return self

    def _scan_duplicate_states(self, relative_tolerance=1.0e-7):
        """Duplicate-state detection on a small random subsample (reference
        mbar.py:279-317).  The RNG draw is unconditional so the stream does
        not depend on verbosity; the O(K^2) comparison is verbose-gated.
        """
        self.samestates = []
        maxpoint = min(50, self.N)
        indices = self.rng.choice(np.arange(self.N), maxpoint)
        if self.verbose:
            sel = torch.as_tensor(indices, device=self.u_kn.device)
            u_sub = self.u_kn.index_select(1, sel).to(torch.float64).cpu().numpy()
            for k in range(self.K):
                for l in range(k):
                    uzero = u_sub[k] - u_sub[l]
                    if np.dot(uzero, uzero) < relative_tolerance:
                        self.samestates.append([k, l])
                        self.samestates.append([l, k])
                        logger.warning(
                            f"States {l:d} and {k:d} have the same energies on "
                            "the dataset.\nThey are therefore likely to to be "
                            "the same thermodynamic state. This can "
                            "occasionally cause\nnumerical problems with "
                            "computing the covariance of their energy "
                            "difference, which must be\nidentically zero in "
                            "any case. Consider combining them into a single "
                            "state.\n"
                        )

    @staticmethod
    def _resolve_protocol(prot, default, maximum_iterations):
        """Reference protocol-normalization semantics (mbar.py:367-411)."""
        if prot is None or prot == "default":
            prot = default
        elif prot == "robust":
            prot = ROBUST_SOLVER_PROTOCOL
        elif prot == "jax":
            prot = JAX_SOLVER_PROTOCOL
        else:
            for solver in prot:
                if not isinstance(solver, dict):
                    logger.warning(
                        "solver protocol is not 'robust','default' or a "
                        "tuple/list of dictionaries, setting to 'default'"
                    )
                    prot = default
                    break
        prot = tuple(dict(stage) for stage in prot)
        for solver in prot:
            solver["options"] = dict(solver.get("options") or {})
            solver.setdefault("continuation", None)
            if "maxiter" not in solver["options"]:
                solver["options"]["maxiter"] = maximum_iterations
            if maximum_iterations > solver["options"]["maxiter"]:
                solver["options"]["maxiter"] = maximum_iterations
                logger.info(
                    f"Explicitly overwriting maxiter={solver['options']['maxiter']} "
                    f"with maximum_iterations={maximum_iterations}"
                )
        return prot

    # -------------------------------------------------------------------------
    # Weights
    # -------------------------------------------------------------------------

    def _weights_to_host(self, exp=False):
        """Log_W_nk (or with ``exp`` W_nk) as an (N, K) numpy array, each
        column chunk's block computed on ``self.device`` and written
        transposed into host memory: the card never holds N x K."""
        out = np.empty((self.N, self.K))
        for s, e, blk in _log_w_blocks(self.u_kn, self.N_k, self.f_k, self.device):
            out[s:e] = (blk.exp_() if exp else blk).T.cpu().numpy()
        return out

    @property
    def Log_W_nk(self):
        """The N x K log-weight matrix (reference mbar.py:455) as a numpy
        array, computed on ``self.device`` chunk by chunk on first access
        and cached."""
        if self._Log_W_nk is None:
            self._Log_W_nk = self._weights_to_host()
        return self._Log_W_nk

    @Log_W_nk.setter
    def Log_W_nk(self, value):
        self._Log_W_nk = value
        self._Log_W_nk_assigned = True

    def _log_W_nk_tensor(self):
        """Log_W_nk as a new (N, K) tensor on ``self.device``.  Computed
        there (the cached host copy holds the same values, and moving it
        back would cost more than the pass), unless Log_W_nk was assigned."""
        if not self._Log_W_nk_assigned:
            return mbar_log_W_nk(self.u_kn, self.N_k, self.f_k, self.device)
        return torch.tensor(self._Log_W_nk, dtype=torch.float64, device=self.device)

    def _W_nk_tensor(self):
        """exp(Log_W_nk) as an (N, K) tensor on ``self.device``."""
        return self._log_W_nk_tensor().exp_()

    @property
    def W_nk(self):
        """The N x K weight matrix ``exp(Log_W_nk)`` as a numpy array.

        ``W_nk[n, k]`` is sample n's normalized weight in state k's
        estimate (columns sum to 1; rows weighted by N_k sum to 1).
        Computed chunk by chunk on ``self.device`` (from the assigned
        Log_W_nk when there is one).
        """
        if self._Log_W_nk_assigned:
            return self._W_nk_tensor().cpu().numpy()
        return self._weights_to_host(exp=True)

    def weights(self):
        """Retrieve the N x K weight matrix (method form of :attr:`W_nk`).

        Returns
        -------
        np.ndarray, shape (N, K)
            ``W_nk = exp(Log_W_nk)``.  Reference: ``pymbar.MBAR.weights``
            (pymbar 4.x mbar.py:481-493).
        """
        return self.W_nk

    # -------------------------------------------------------------------------
    # Diagnostics
    # -------------------------------------------------------------------------

    def _gram_colsum(self):
        """(W^T W, colsum W) as tensors on ``self.device``, from one streamed
        pass: W never exists in (N, K) form."""
        gram, colsum, _rowstats = mbar_gram_normalization(
            self.u_kn, self.N_k, self.f_k, tolerance=np.inf, device=self.device
        )
        return gram, colsum

    def compute_effective_sample_number(self, verbose=False):
        """Kish effective sample size of each state's MBAR estimate.

        ``N_eff[k] = 1 / sum_n W_nk^2`` -- how many independent samples the
        weighted estimate at state k is effectively worth; bounded by
        ``N_k <= N_eff[k] <= sum_k N_k`` for sampled states.  ``sum_n
        W_nk^2`` is the Gram diagonal, so this is one streamed pass on
        ``self.device`` and only the K diagonal values leave it.  Reference:
        ``pymbar.MBAR.compute_effective_sample_number`` (pymbar 4.x
        mbar.py:496-560).

        Returns
        -------
        np.ndarray, shape (K,)
        """
        gram, _colsum = self._gram_colsum()
        N_eff = 1.0 / torch.diagonal(gram).cpu().numpy()
        if verbose:
            for k in range(self.K):
                logger.info(f"Effective number of sample in state {k:d} is {N_eff[k]:10.3f}")
                logger.info(
                    "Efficiency for state {:d} is {:6f}/{:d} = {:10.4f}".format(
                        k, N_eff[k], self.N, N_eff[k] / self.N
                    )
                )
        return N_eff

    def compute_overlap(self):
        """Phase-space overlap between the sampled states.

        Returns
        -------
        dict
            ``'matrix'`` : (K, K) overlap matrix ``O = N_k (W^T W)`` (row k
            sums to 1); ``'eigenvalues'`` : its spectrum, descending;
            ``'scalar'`` : ``1 - lambda_2`` (1 = perfect overlap, 0 =
            disconnected).  Reference: ``pymbar.MBAR.compute_overlap``
            (pymbar 4.x mbar.py:563-617).

        Notes
        -----
        O = G diag(N_k) with G = W^T W symmetric, so O has the spectrum of
        the symmetric D^1/2 G D^1/2 (similar through D^1/2; empty states
        give exact zero rows and columns in both): the spectrum comes from
        ``eigvalsh`` on the Gram's device.

        Examples
        --------
        >>> import numpy as np
        >>> from pymbar_tpu_torch import MBAR
        >>> from pymbar_tpu_torch.testsystems import HarmonicOscillatorsTestCase
        >>> tc = HarmonicOscillatorsTestCase(O_k=[0.0, 0.0], K_k=[1.0, 1.0])
        >>> x_n, u_kn, N_k, s_n = tc.sample(N_k=[200, 200], mode="u_kn", seed=1)
        >>> O = MBAR(u_kn, N_k).compute_overlap()["matrix"]
        >>> bool(np.allclose(O, 0.5, atol=1e-6))  # identical states: 1/K
        True
        """
        gram, _colsum = self._gram_colsum()
        s = torch.sqrt(torch.as_tensor(self.N_k, dtype=torch.float64, device=gram.device))
        eigenvals = torch.linalg.eigvalsh(s[:, None] * gram * s[None, :])
        eigenvals = torch.flip(eigenvals, dims=(0,)).cpu().numpy()
        O = self.N_k * gram.cpu().numpy()
        return dict(scalar=1 - eigenvals[1], eigenvalues=eigenvals, matrix=O)

    # -------------------------------------------------------------------------
    # Free energy differences
    # -------------------------------------------------------------------------

    def compute_free_energy_differences(
        self,
        compute_uncertainty=True,
        uncertainty_method=None,
        warning_cutoff=1.0e-10,
        return_theta=False,
    ):
        """Free energy differences between all pairs of states.

        Parameters
        ----------
        compute_uncertainty : bool, optional, default True
        uncertainty_method : {None, 'approximate', 'svd', 'svd-ew', 'bootstrap'}, optional
            ``None``/'svd-ew' uses the eigendecomposition form of Eq. D4;
            'approximate' uses Theta = W^T W (Kong 2003); 'svd' the explicit
            SVD form of W; 'bootstrap' the standard deviation over the
            replicates of ``n_bootstraps``.
        warning_cutoff : float, optional, default 1.0e-10
            Warn when a squared uncertainty is more negative than this.
        return_theta : bool, optional, default False
            Also return the full K x K covariance matrix Theta.

        Returns
        -------
        dict
            ``'Delta_f'`` : (K, K) array, ``Delta_f[i, j] = f_j - f_i``;
            ``'dDelta_f'`` : (K, K) standard deviations (if
            ``compute_uncertainty``); ``'Theta'`` : (K, K) (if
            ``return_theta``).  Reference: ``pymbar.MBAR``
            (pymbar 4.x mbar.py:620-729).

        Examples
        --------
        >>> import numpy as np
        >>> from pymbar_tpu_torch import MBAR
        >>> from pymbar_tpu_torch.testsystems import HarmonicOscillatorsTestCase
        >>> tc = HarmonicOscillatorsTestCase(O_k=[0.0, 1.0], K_k=[1.0, 2.0])
        >>> x_n, u_kn, N_k, s_n = tc.sample(N_k=[300, 300], mode="u_kn", seed=3)
        >>> res = MBAR(u_kn, N_k).compute_free_energy_differences()
        >>> res["Delta_f"].shape, float(res["Delta_f"][0, 0])
        ((2, 2), 0.0)
        """
        Deltaf_ij = np.array(self.f_k - np.vstack(self.f_k))
        self._zerosamestates(Deltaf_ij)
        result_vals = dict(Delta_f=Deltaf_ij)

        if uncertainty_method == "bootstrap" and not self.n_bootstraps:
            raise ParameterError(
                "Cannot request bootstrap sampling of free energy differences "
                "without any bootstraps."
            )

        Theta_ij = None
        if (compute_uncertainty and uncertainty_method != "bootstrap") or return_theta:
            Theta_ij = self._compute_theta_streamed(method=uncertainty_method)

        if compute_uncertainty and uncertainty_method == "bootstrap":
            diffm = self.f_k_boots[:, None, :] - self.f_k_boots[:, :, None]
            result_vals["dDelta_f"] = np.std(diffm, axis=0)
        elif compute_uncertainty:
            dDeltaf_ij = np.array(
                self._ErrorOfDifferences(Theta_ij, warning_cutoff=warning_cutoff)
            )
            self._zerosamestates(dDeltaf_ij)
            result_vals["dDelta_f"] = dDeltaf_ij

        if return_theta:
            result_vals["Theta"] = Theta_ij
        return result_vals

    def _compute_theta_streamed(self, method=None):
        """Theta over the K states with W consumed in Gram form only: one
        streamed f64 pass (:func:`mbar_gram_normalization`) on ``self.device``
        gives W^T W, the column sums and the row-check aggregates.  A CUDA
        Gram stays on the card for the rank-nnz form
        (:meth:`_theta_svd_ew_lowrank`), as the JAX package does on its
        accelerator; a CPU Gram takes the dense numpy path
        (:meth:`_theta_from_gram`).  'svd' takes the same pass with W's R
        factor in place of the Gram (a QR of each chunk's rows of W folded
        into a K x K R, :func:`mbar_gram_normalization` with ``tsqr``), so
        only K x K and one chunk are on ``self.device``; an assigned
        Log_W_nk is factored as given
        (:meth:`_computeAsymptoticCovarianceMatrix`).  Theta is returned as
        a numpy array."""
        if method is None or method == "bootstrap":
            method = "svd-ew"
        if method == "svd" and self._Log_W_nk_assigned:
            return self._computeAsymptoticCovarianceMatrix(
                self._W_nk_tensor(), self.N_k, method="svd"
            )
        if method not in ("svd", "svd-ew", "approximate"):
            raise ParameterError(f"Method {method} unrecognized.")
        gram, colsum, rowstats = mbar_gram_normalization(
            self.u_kn, self.N_k, self.f_k, device=self.device, tsqr=method == "svd"
        )
        self._check_normalized_aggregates(colsum.cpu().numpy(), rowstats)
        if method == "svd":
            return self._theta_svd(gram, self.N_k).cpu().numpy()
        return self._theta_from_gram(gram, self.N_k, method).cpu().numpy()

    # -------------------------------------------------------------------------
    # Expectations
    # -------------------------------------------------------------------------

    def compute_expectations_inner(
        self,
        A_n,
        u_ln,
        state_map,
        uncertainty_method=None,
        warning_cutoff=1.0e-10,
        return_theta=False,
    ):
        """Augmented-state expectations workhorse (low-level API).

        Augments the state space to ``K + NL + S`` -- the K original states,
        NL extra states defined by ``u_ln``, and one pseudo-state per
        observable entry of ``state_map`` -- and evaluates free energies,
        observables, and the joint covariance over the augmented weights.
        Observables are shifted positive by ``A_min - 4 eps |A_min|`` so
        everything runs in log space.

        Parameters
        ----------
        A_n : np.ndarray or tensor, shape (n_obs, N)
            Observable rows referenced by ``state_map[1]``.
        u_ln : np.ndarray or tensor, shape (NL, N)
            Reduced potentials of the extra states.
        state_map : np.ndarray, int, shape (2, S) or (S,)
            Row 0: which extra state each observable pseudo-state attaches
            to; row 1: which ``A_n`` row it averages.  A 1-D array means
            "free energies only" (no observables).
        uncertainty_method, warning_cutoff, return_theta
            As in :meth:`compute_expectations`.

        Returns
        -------
        dict
            ``'observables'`` (S,), ``'f'`` (per state_list entry),
            ``'Theta'`` (block form: S observable rows first, then the
            state rows), ``'Amin'``, and -- under
            ``uncertainty_method='bootstrap'`` -- ``'bootstrapped_observables'``
            / ``'bootstrapped_f'``; numpy arrays.

        Notes
        -----
        Everything runs on ``self.device``; numpy inputs go there.  From
        ``_AUG_STREAM_BYTES`` of ``u_kn`` up the machinery streams over
        u_kn's column chunks and no N x (K+NL+S) matrix exists ('svd' too:
        it folds the augmented rows of W into their R factor).  ``u_ln is
        self.u_kn`` (and, for entropy, ``A_n is self.u_kn``) is used as an
        alias of the same tensor, never copied.  Reference: ``pymbar.MBAR.compute_expectations_inner``
        (pymbar 4.x mbar.py:732-1030).
        """
        result_vals = self._expectations_inner(
            A_n, u_ln, state_map, uncertainty_method, return_theta
        )
        if "Theta" in result_vals:
            result_vals["Theta"] = result_vals["Theta"].cpu().numpy()
        return result_vals

    def _expectations_inner(self, A_n, u_ln, state_map, uncertainty_method, return_theta):
        """:meth:`compute_expectations_inner` with Theta as a tensor on the
        device of the Gram it came from."""
        logfactor = 4.0 * np.finfo(np.float64).eps

        state_map = np.asarray(state_map)
        if state_map.ndim < 2:
            state_list = state_map.copy()
            state_map = np.zeros([0, 0], int)
            S = 0
        else:
            state_list = state_map[0, :]
            S = state_map.shape[1]

        # u_ln = self.u_kn (compute_expectations, entropy) is an alias of
        # the same tensor: detected before any conversion, never copied.
        u_ln_alias = u_ln is self.u_kn
        if not u_ln_alias:
            u_ln = _f64(u_ln)
            if u_ln.ndim == 1:
                u_ln = u_ln.reshape(1, -1)

        L_list = np.unique(state_list)
        NL = len(L_list)
        stream = (
            self._u_bytes() >= _AUG_STREAM_BYTES
            and (uncertainty_method != "bootstrap" or self.n_bootstraps > 0)
            # every public caller builds contiguous extra states; anything
            # else keeps the reference's materializing path
            and np.array_equal(L_list, np.arange(NL))
            and u_ln.shape[0] == NL
        )
        # Entropy's aliased observable A_n = u_kn (row k at state k): the
        # streamed passes rebuild each shifted observable chunk from u_kn
        # itself.  Only for the identity map over every state: the diag
        # layout pairs row s with state s positionally, so a permuted
        # state_map[0] must not take it.
        ident = np.arange(self.K)
        a_alias = (
            stream and A_n is self.u_kn and u_ln_alias and S == self.K
            and np.array_equal(state_map[0], ident) and np.array_equal(state_map[1], ident)
        )
        if not a_alias:
            # the reference shifts A_n in place and restores it
            # (mbar.py:864-878, :973-975): a copy has the same net effect
            A_n = _f64(A_n, copy=True)
            if A_n.ndim == 1:
                A_n = A_n.reshape(1, -1)

        K = self.K
        result_vals = dict()

        if S > 0:
            A_list = np.unique(state_map[1, :])
            A_min = np.zeros(int(np.max(A_list)) + 1, dtype=np.float64)
            logfactors = np.zeros(int(np.max(A_list)) + 1, dtype=np.float64)
        else:
            A_list = np.zeros(0, dtype=int)
            A_min = np.zeros(0, dtype=np.float64)
            logfactors = np.zeros(0, dtype=np.float64)

        if a_alias:
            # per-row min in one pass on self.device; the shift itself is
            # applied chunk by chunk inside the streamed passes
            row_min = torch.full((K,), torch.inf, dtype=torch.float64, device=self.device)
            for _s, _e, u_c in stream_columns(self.u_kn, self.device):
                row_min = torch.minimum(row_min, u_c.amin(dim=1))
            row_min = row_min.cpu().numpy()
            A_min[A_list] = row_min[A_list]
            logfactors[A_list] = np.abs(logfactor * A_min[A_list])
            a_shift = A_min - logfactors
        else:
            a_shift = None
            for i in A_list:
                A_min[i] = float(A_n[i, :].min())
                logfactors[i] = np.abs(logfactor * A_min[i])
                A_n[i, :] = A_n[i, :] - (A_min[i] - logfactors[i])
        i_of_s = state_map[1, :S].astype(int) if S > 0 else np.zeros(0, int)
        shift_s = A_min[i_of_s] - logfactors[i_of_s]

        if stream:
            f_aug, Theta_ij, boot = self._expectations_streamed(
                A_n, u_ln, state_map, S, NL, uncertainty_method, return_theta,
                bootstrap=uncertainty_method == "bootstrap",
                u_ln_alias=u_ln_alias, a_shift=a_shift,
            )
        else:
            f_aug, Theta_ij, boot = self._expectations_materialized(
                A_n, u_ln, state_map, S, L_list, uncertainty_method, return_theta,
            )

        if S > 0:
            result_vals["observables"] = np.exp(-f_aug[K + NL : K + NL + S]) + shift_s
        result_vals["f"] = f_aug[K + state_list]
        if boot is not None:
            A_boot, f_boot = boot
            result_vals["bootstrapped_observables"] = (
                A_boot + shift_s[None, :] if S > 0 else A_boot
            )
            result_vals["bootstrapped_f"] = f_boot[:, K + state_list]
        if return_theta:
            # block form: S observable rows first, then the state_list rows
            # (reference mbar.py:979-1000)
            idx = torch.as_tensor(
                np.concatenate((K + NL + np.arange(S), K + state_list)), device=Theta_ij.device
            )
            result_vals["Theta"] = Theta_ij.index_select(0, idx).index_select(1, idx)
            if S > 0:
                result_vals["Amin"] = shift_s
        return result_vals

    def _expectations_materialized(self, A_n, u_ln, state_map, S, L_list, method, need_theta):
        """The reference's branch (mbar.py:838-1000) on ``self.device``: the
        N x (K + NL + S) log-weights Log_W, each extra state's and
        pseudo-state's free energy from a logsumexp over its column, Theta
        from exp(Log_W) by :meth:`_asymptotic_theta`; with
        ``method="bootstrap"`` the same again on each replicate's resampled
        columns ``u_kn[:, rints]`` at its f_k.  A host-resident u_kn is
        uploaded whole for it (this branch builds N x (K + NL + S) there
        anyway).  Returns (f_aug (msize,), Theta tensor or None, boot or
        None) with boot = (raw bootstrapped observables (B, S), bootstrapped
        f_aug (B, msize))."""
        K, N = self.K, self.N
        NL = len(L_list)
        msize = K + NL + S
        dev = self.device
        u_full = u_kn_on(self.u_kn, dev)
        if u_ln is self.u_kn:
            u_ln = u_full
        l_of_s = state_map[0, :S].astype(int) if S > 0 else np.zeros(0, int)
        i_of_s = state_map[1, :S].astype(int) if S > 0 else np.zeros(0, int)
        u_ln = torch.as_tensor(u_ln, dtype=torch.float64, device=dev)
        u_l = _rows(u_ln, torch.as_tensor(L_list, device=dev), _idx_mode(L_list, u_ln.shape[0]))
        if S > 0:
            log_a = _rows(torch.log(torch.as_tensor(A_n, dtype=torch.float64, device=dev)),
                          torch.as_tensor(i_of_s, device=dev), _idx_mode(i_of_s, A_n.shape[0]))
        sws = np.where(self.N_k > 0)[0]
        sampled = torch.as_tensor(sws, device=dev)
        N_aug = np.zeros(msize, np.int64)
        N_aug[:K] = self.N_k
        f_aug = np.zeros(msize)
        Log_W = torch.zeros((N, msize), dtype=torch.float64, device=dev)
        cols_l = torch.as_tensor(K + L_list, device=dev)
        cols_s = torch.as_tensor(K + l_of_s, device=dev)
        n_total = self.n_bootstraps + 1 if method == "bootstrap" else 1
        boot_rows = np.zeros((n_total - 1, msize))
        Theta_ij = None

        for n in range(n_total):
            if n == 0:
                f_aug[:K] = self.f_k
                u_kn = u_full
                Log_W[:, :K] = self._log_W_nk_tensor()
                ri = None
            else:
                f_aug[:K] = self.f_k_boots[n - 1, :]
                ri = torch.as_tensor(self.bootstrap_rints[n - 1], device=dev)
                u_kn = u_full.index_select(1, ri)
                Log_W[:, :K] = mbar_log_W_nk(u_kn, self.N_k, f_aug[:K])
            # per-sample mixture log-normalizer over the sampled states only
            # (Eqns 13-14 of the MBAR paper)
            logden = log_denominator_n(
                u_kn.index_select(0, sampled), self.N_k[sws], f_aug[:K][sws]
            )
            u_lr = u_l if ri is None else u_l.index_select(1, ri)
            log_C = -torch.logsumexp(-u_lr - logden[None, :], dim=1)
            Log_W[:, cols_l] = (log_C[:, None] - u_lr - logden[None, :]).T
            f_aug[K + L_list] = log_C.cpu().numpy()
            if S > 0:
                la = log_a if ri is None else log_a.index_select(1, ri)
                if L_list.max() < NL:
                    lw = la.T + Log_W[:, cols_s]
                    f_sa = -torch.logsumexp(lw, dim=0)
                    Log_W[:, K + NL :] = lw + f_sa[None, :]
                    f_aug[K + NL :] = f_sa.cpu().numpy()
                else:
                    # extra states outside arange(NL) share columns with the
                    # pseudo-states: keep the reference's order, one by one
                    for s in range(S):
                        lw = la[s] + Log_W[:, K + l_of_s[s]]
                        f_s = -torch.logsumexp(lw, dim=0)
                        Log_W[:, K + NL + s] = lw + f_s
                        f_aug[K + NL + s] = float(f_s)
            if n == 0:
                if need_theta:
                    Theta_ij = self._asymptotic_theta(Log_W.exp(), N_aug, method=method)
                f_out = f_aug.copy()
            else:
                boot_rows[n - 1] = f_aug
        boot = None
        if method == "bootstrap":
            boot = (np.exp(-boot_rows[:, K + NL :]), boot_rows)
        return f_out, Theta_ij, boot

    def _expectations_streamed(
        self, A_n, u_ln, state_map, S, NL, method, need_theta,
        bootstrap=False, u_ln_alias=False, a_shift=None,
    ):
        """Augmented-state expectations without the N x (K + NL + S) matrix.

        The algebra of :meth:`_expectations_materialized` in two passes over
        u_kn's column chunks (``mbar_core.stream_columns``) on
        ``self.device``, a host-resident u_kn's uploaded one at a time; a
        numpy ``u_ln`` or ``A_n`` goes there one chunk at a time too:

        * pass A (:func:`_aug_a_body`) accumulates each extra state's log
          normalizer log C_l = -logsumexp_n(-u_ln[l] - logden_n) and each
          pseudo-state's logsumexp_n(log A + (-u_l - logden)) as running
          (max, rescaled sum) pairs;
        * pass B (only when a covariance is asked for) rides
          :func:`mbar_gram_normalization`'s chunk loop: the three K x K
          Grams of the structured form (u_ln aliasing u_kn with one shared
          observable row, or observable row k at state k), assembled by
          :func:`_assemble_struct_gram`, else the general (K + NL + S)^2
          Gram of the appended extra-state and pseudo-state rows; with the
          column sums and the row check.

        ``a_shift`` set means A_n is u_kn itself (entropy's alias): each
        observable chunk is u_c - a_shift.  With ``bootstrap=True`` pass A
        runs again once per replicate, weighted by its resample counts and
        at its f_k: no resampled matrix is gathered.  Returns (f_aug
        (msize,), Theta tensor or None, boot or None) with boot = (raw
        bootstrapped observables (B, S), bootstrapped f_aug (B, msize)).
        """
        global AUG_B_LOGROW_PASSES, AUG_B_DIAG_PASSES, AUG_B_GENERAL_PASSES

        K = self.K
        msize = K + NL + S
        dev = self.device
        a_alias = a_shift is not None
        sws = np.where(self.N_k > 0)[0]
        sampled = None if len(sws) == K else torch.as_tensor(sws, device=dev)
        N_s = torch.as_tensor(self.N_k[sws], dtype=torch.float64, device=dev)
        l_of_s = state_map[0, :S].astype(int) if S > 0 else np.zeros(0, int)
        i_of_s = state_map[1, :S].astype(int) if S > 0 else np.zeros(0, int)
        lidx = torch.as_tensor(l_of_s, device=dev)
        lidx_mode = _idx_mode(l_of_s, NL)
        n_obs = int(A_n.shape[0]) if S > 0 else 0
        iofs = torch.as_tensor(i_of_s, device=dev)
        iofs_mode = _idx_mode(i_of_s, n_obs)
        if a_alias:
            shift = torch.as_tensor(a_shift, dtype=torch.float64, device=dev)

        def u_ln_cols(u_c, c0, c1):
            return u_c if u_ln_alias else _cols(u_ln, c0, c1, dev)

        def log_obs(c0, c1):
            """The chunk's (S, nc) log observable rows (broadcast views where
            the rows repeat)."""
            if S == 0:
                return torch.empty((0, c1 - c0), dtype=torch.float64, device=dev)
            return _rows(torch.log(_cols(A_n, c0, c1, dev)), iofs, iofs_mode)

        def run_pass_a(f_k, counts=None):
            """(log_C (NL,), f_sa (S,)) at the states' free energies f_k,
            optionally counts-weighted: one pass over u_kn."""
            f_s = torch.as_tensor(f_k[sws], dtype=torch.float64, device=dev)
            m_l = torch.full((NL,), -torch.inf, dtype=torch.float64, device=dev)
            s_l = torch.zeros(NL, dtype=torch.float64, device=dev)
            m_s = torch.full((S,), -torch.inf, dtype=torch.float64, device=dev)
            s_s = torch.zeros(S, dtype=torch.float64, device=dev)
            for c0, c1, u_c in stream_columns(self.u_kn, dev):
                ml, sl, ms, ss = _aug_a_body(
                    u_c, u_ln_cols(u_c, c0, c1),
                    u_c - shift[:, None] if a_alias else log_obs(c0, c1),
                    sampled, N_s, f_s, lidx, lidx_mode,
                    None if counts is None else counts[c0:c1],
                    "diagmul" if a_alias else "log",
                )
                m_l, s_l = _aug_combine(m_l, s_l, ml, sl)
                m_s, s_s = _aug_combine(m_s, s_s, ms, ss)
            m_l, s_l, m_s, s_s = (t.cpu().numpy() for t in (m_l, s_l, m_s, s_s))
            with np.errstate(divide="ignore"):
                log_C = -(np.log(s_l) + m_l)
                R_s = np.log(s_s) + m_s
            return log_C, (-(log_C[l_of_s] + R_s) if S > 0 else np.zeros(0))

        log_C, f_sa = run_pass_a(self.f_k)
        f_aug = np.concatenate([self.f_k, log_C, f_sa])

        boot = None
        if bootstrap:
            counts = bootstrap_counts(self.bootstrap_rints, self.N)
            boot_rows = np.zeros((self.n_bootstraps, msize))
            for b in range(self.n_bootstraps):
                c_b = torch.as_tensor(counts[b].astype(np.float32), device=dev).double()
                logC_b, f_sa_b = run_pass_a(self.f_k_boots[b], c_b)
                boot_rows[b] = np.concatenate([self.f_k_boots[b], logC_b, f_sa_b])
            boot = (np.exp(-boot_rows[:, K + NL :]), boot_rows)

        if not need_theta:
            return f_aug, None, boot

        # ---- pass B: augmented Gram + normalization aggregates
        # 'svd' factors the augmented W itself: the general rows, folded
        row0_b = (
            _STRUCT_AUG_GRAM and method != "svd" and u_ln_alias and S > 0 and NL == K
            and not a_alias and iofs_mode == "zero"
        )
        diag_b = (
            _STRUCT_AUG_GRAM and method != "svd" and u_ln_alias and S == K and NL == K
            and not row0_b
            and lidx_mode == "identity" and (a_alias or iofs_mode == "identity")
        )
        if row0_b or diag_b:
            if row0_b:
                AUG_B_LOGROW_PASSES += 1

                def observable(c0, c1, u_c):
                    return _cols(A_n[0], c0, c1, dev)
            else:
                AUG_B_DIAG_PASSES += 1

                def observable(c0, c1, u_c):
                    return u_c - shift[:, None] if a_alias else _cols(A_n, c0, c1, dev)

            M0, c0s, rowstats, (M1, M2, cAs) = mbar_gram_normalization(
                self.u_kn, self.N_k, self.f_k, sampled=sampled, observable=observable,
                device=dev,
            )
            # exact f64 diagonal scalings: W_L = diag(D_L) W_0 and
            # W_S = diag(E) (A o W_0)[l_of_s]
            D_L = np.exp(log_C - self.f_k)
            E = np.exp(f_sa + log_C[l_of_s] - self.f_k[l_of_s])
            gram = _assemble_struct_gram(M0, M1, M2, D_L, E, l_of_s)
            c0s, cAs = c0s.cpu().numpy(), cAs.cpu().numpy()
            colsum = np.concatenate([c0s, D_L * c0s, E * cAs[l_of_s]])
        else:
            AUG_B_GENERAL_PASSES += 1
            log_c = torch.as_tensor(log_C, device=dev)
            # pseudo-state rows: (f_sa + log C_l) + log A - u_l - logden
            obs_shift = torch.as_tensor(f_sa + log_C[l_of_s], device=dev)

            def extra_rows(c0, c1, u_c, logden):
                ul_c = u_ln_cols(u_c, c0, c1)
                rows = [log_c[:, None] - ul_c - logden[None, :]]
                if S > 0:
                    la = torch.log(u_c - shift[:, None]) if a_alias else log_obs(c0, c1)
                    rows.append(obs_shift[:, None] + la - _rows(ul_c, lidx, lidx_mode)
                                - logden[None, :])
                return torch.cat(rows).exp_()

            gram, colsum, rowstats = mbar_gram_normalization(
                self.u_kn, self.N_k, self.f_k, sampled=sampled, extra_rows=extra_rows,
                device=dev, tsqr=method == "svd",
            )
            colsum = colsum.cpu().numpy()

        self._check_normalized_aggregates(colsum, rowstats)
        if method == "approximate":
            return f_aug, gram, boot
        N_aug = np.zeros(msize)
        N_aug[:K] = self.N_k
        if method == "svd":
            return f_aug, self._theta_svd(gram, N_aug), boot
        # default / svd-ew (the reference maps 'bootstrap' here too)
        return f_aug, self._theta_from_gram(gram, N_aug, "svd-ew"), boot

    def compute_covariance_of_sums(self, d_ij, K, a):
        """Uncertainty of weighted sums of free-energy differences.

        For ``n`` chunks of ``K`` states stacked into one estimator,
        computes ``sigma[i, j] = sqrt(var(sum_k a_k (f_{i,k} - f_{j,k})))``
        from the pairwise standard deviations ``d_ij`` of the stacked
        states -- e.g. the uncertainty of a heat-capacity-style linear
        combination across temperature chunks.

        Parameters
        ----------
        d_ij : np.ndarray, shape (>= n*K, >= n*K)
            Pairwise standard deviations of the stacked free energies (as
            returned in ``dDelta_f`` by a stacked-state MBAR).
        K : int
            States per chunk.
        a : array_like, shape (n,)
            Weight of each chunk in the sum.

        Returns
        -------
        np.ndarray, shape (K, K)
            The combined standard deviations.

        Notes
        -----
        Numpy on the host.  Vectorized einsum over (n, n, K, K) covariance
        blocks in place of the reference's quadruple loop:
        ``pymbar.MBAR.compute_covariance_of_sums`` (pymbar 4.x
        mbar.py:1033-1121).
        """
        a = np.asarray(a, dtype=np.float64)
        var_ij = np.square(np.asarray(_host(d_ij)))
        n = len(a)

        # blocks[k, l, i, j] = var_ij[i + k*K, j + l*K].  Rows/cols beyond
        # n*K are ignored, as the reference's index loops never touch them.
        var_ij = var_ij[: n * K, : n * K]
        blocks = var_ij.reshape(n, K, n, K).transpose(0, 2, 1, 3)
        # Single terms: sum_k a_k^2 var(f_i - f_j) within chunk k.
        d2 = np.einsum("k,kkij->ij", a**2, blocks)
        # Cross terms:
        #   a_k a_l [-var(i_k,i_l) + var(i_k,j_l) + var(j_k,i_l) - var(j_k,j_l)]
        diag = blocks.diagonal(axis1=2, axis2=3)  # [k, l, i] = var(i_k, i_l)
        term = (
            -diag[:, :, :, None]  # var(i_k, i_l), broadcast over j
            + blocks  # var(i_k, j_l)
            + blocks.transpose(0, 1, 3, 2)  # var(j_k, i_l)
            - diag[:, :, None, :]  # var(j_k, j_l), broadcast over i
        )
        d2 += np.einsum("k,l,klij->ij", a, a, term)
        return np.sqrt(d2)

    def compute_expectations(
        self,
        A_n,
        u_kn=None,
        output="averages",
        state_dependent=False,
        compute_uncertainty=True,
        uncertainty_method=None,
        warning_cutoff=1.0e-10,
        return_theta=False,
    ):
        """Equilibrium expectation of one observable at every state.

        Parameters
        ----------
        A_n : np.ndarray or tensor, shape (N,), (K, N_max) or (N, K)
            The observable per sample.  With ``state_dependent=True``,
            ``A_n[k, n]`` gives the observable's value in state ``k`` (e.g.
            the potential energy itself).
        u_kn : np.ndarray or tensor, optional
            Alternative reduced potentials to evaluate at (defaults to the
            constructor's matrix, used as it is); accepts kn, n, or kln
            layouts.
        output : {'averages', 'differences'}, optional
            'averages' returns per-state vectors; 'differences' returns
            (K, K) matrices of pairwise differences.
        state_dependent : bool, optional, default False
            Whether the observable's definition varies by state.
        compute_uncertainty : bool, optional, default True
        uncertainty_method : {None, 'approximate', 'svd', 'svd-ew', 'bootstrap'}, optional
            As in :meth:`compute_free_energy_differences`.
        warning_cutoff : float, optional, default 1.0e-10
        return_theta : bool, optional, default False

        Returns
        -------
        dict
            ``'mu'`` : expectations (K,) or (K, K); ``'sigma'`` :
            uncertainties (same shape, if ``compute_uncertainty``);
            ``'Theta'`` : covariance of the augmented observables (if
            ``return_theta``); numpy arrays.

        Notes
        -----
        Observables are shifted positive (``A_min - 4 eps |A_min|``) so the
        whole computation stays in log space; from ``_AUG_STREAM_BYTES`` of
        ``u_kn`` up the augmented-state machinery streams over sample
        chunks.  Reference: ``pymbar.MBAR.compute_expectations``
        (pymbar 4.x mbar.py:1124-1312) -- with the JAX package's fix that
        ``return_theta=True`` without uncertainties does not crash.

        Examples
        --------
        >>> import numpy as np
        >>> from pymbar_tpu_torch import MBAR
        >>> from pymbar_tpu_torch.testsystems import HarmonicOscillatorsTestCase
        >>> tc = HarmonicOscillatorsTestCase(O_k=[0.0, 1.0], K_k=[1.0, 2.0])
        >>> x_n, u_kn, N_k, s_n = tc.sample(N_k=[500, 500], mode="u_kn", seed=5)
        >>> ex = MBAR(u_kn, N_k).compute_expectations(x_n)
        >>> bool(np.all(np.abs(ex["mu"] - tc.analytical_means()) < 6 * ex["sigma"] + 0.05))
        True
        """
        if uncertainty_method == "bootstrap" and (
            self.n_bootstraps is None or self.n_bootstraps <= 0
        ):
            raise ParameterError(
                "Cannot request bootstrap sampling of expectations without any bootstraps."
            )

        dims = len(np.shape(A_n))
        if dims > 2:
            logger.warning(
                "dim=3 for (state_dependent==True) matrices for observables "
                "and dim=2 for (state_dependent==False) observables are "
                "deprecated; we suggest you convert to NxK form instead of "
                "NxKxK form."
            )

        if (dims == 2 and not state_dependent) or (dims == 3 and state_dependent):
            A_n = (kn_to_n if dims == 2 else kln_to_kn)(_host(A_n), N_k=self.N_k)
            if u_kn is not None:
                if len(np.shape(u_kn)) == 3:
                    u_kn = kln_to_kn(_host(u_kn), N_k=self.N_k)
                elif len(np.shape(u_kn)) == 2:
                    u_kn = kn_to_n(_host(u_kn), N_k=self.N_k)

        if u_kn is None:
            u_kn = self.u_kn

        ushape = np.shape(u_kn)
        K = 1 if len(ushape) == 1 else ushape[0]

        state_map = np.zeros([2, K], int)
        state_map[0, :] = np.arange(K)
        if state_dependent:
            state_map[1, :] = np.arange(K)

        inner_results = self._expectations_inner(
            A_n, u_kn, state_map, uncertainty_method,
            # return_theta alone must also produce Theta (the reference asks
            # the inner call only for compute_uncertainty, mbar.py:1257-1262,
            # and crashes on return_theta without uncertainties).
            compute_uncertainty or return_theta,
        )

        result_vals = dict()
        Theta = covA_ij = None
        if (compute_uncertainty and uncertainty_method != "bootstrap") or return_theta:
            # sandwich Theta with the shifted observables: covariances of the
            # observables themselves (reference mbar.py:1267-1281)
            Theta = self._sandwich(inner_results)
            covA_ij = (
                Theta[0:K, 0:K]
                + Theta[K : 2 * K, K : 2 * K]
                - Theta[0:K, K : 2 * K]
                - Theta[K : 2 * K, 0:K]
            )

        if output == "averages":
            result_vals["mu"] = inner_results["observables"]
            if compute_uncertainty:
                if uncertainty_method == "bootstrap":
                    result_vals["sigma"] = np.std(
                        inner_results["bootstrapped_observables"], axis=0
                    )
                else:
                    result_vals["sigma"] = torch.sqrt(covA_ij.diagonal()).cpu().numpy()

        if output == "differences":
            A_im = inner_results["observables"]
            result_vals["mu"] = A_im - np.vstack(A_im)
            if compute_uncertainty:
                if uncertainty_method == "bootstrap":
                    boots = inner_results["bootstrapped_observables"]
                    result_vals["sigma"] = np.std(boots[:, None, :] - boots[:, :, None], axis=0)
                else:
                    result_vals["sigma"] = self._ErrorOfDifferences(
                        covA_ij, warning_cutoff=warning_cutoff
                    )

        if return_theta:
            result_vals["Theta"] = Theta.cpu().numpy()

        return result_vals

    @staticmethod
    def _sandwich(inner_results):
        """diag(d) Theta diag(d) on Theta's device, with d the shifted
        observables twice over (reference mbar.py:1267-1281)."""
        Th = inner_results["Theta"]
        a = inner_results["observables"] - inner_results["Amin"]
        d = torch.as_tensor(np.concatenate([a, a]), device=Th.device)
        return d[:, None] * Th * d[None, :]

    def compute_multiple_expectations(
        self,
        A_in,
        u_n,
        compute_uncertainty=True,
        compute_covariance=False,
        uncertainty_method=None,
        warning_cutoff=1.0e-10,
        return_theta=False,
    ):
        """Expectations of several observables at one (possibly new) state.

        Parameters
        ----------
        A_in : np.ndarray or tensor, shape (I, N) or (I, K, N_max)
            ``I`` observables evaluated at every sample.
        u_n : np.ndarray or tensor, shape (N,) or (K, N_max)
            Reduced potential of the single target state.
        compute_uncertainty : bool, optional, default True
        compute_covariance : bool, optional, default False
            Also return the I x I covariance matrix of the observables.
        uncertainty_method : {None, 'approximate', 'svd', 'svd-ew', 'bootstrap'}, optional
        warning_cutoff : float, optional, default 1.0e-10
        return_theta : bool, optional, default False

        Returns
        -------
        dict
            ``'mu'`` : (I,) expectations at the target state; ``'sigma'`` :
            (I,) uncertainties; ``'covariances'`` : (I, I) covariance;
            ``'Theta'`` : augmented covariance -- each as requested, as
            numpy arrays.

        Notes
        -----
        Reference: ``pymbar.MBAR.compute_multiple_expectations``
        (pymbar 4.x mbar.py:1315-1439), including its
        ``compute_uncertainty != "bootstrap"`` comparison quirk.

        Examples
        --------
        >>> import numpy as np
        >>> from pymbar_tpu_torch import MBAR
        >>> from pymbar_tpu_torch.testsystems import HarmonicOscillatorsTestCase
        >>> tc = HarmonicOscillatorsTestCase(O_k=[0.0, 1.0], K_k=[1.0, 2.0])
        >>> x_n, u_kn, N_k, s_n = tc.sample(N_k=[400, 400], mode="u_kn", seed=9)
        >>> A_in = np.vstack([x_n, x_n**2])
        >>> out = MBAR(u_kn, N_k).compute_multiple_expectations(A_in, u_kn[0])
        >>> out["mu"].shape, out["sigma"].shape
        ((2,), (2,))
        """
        if not torch.is_tensor(A_in):
            A_in = np.asarray(A_in)
        I = A_in.shape[0]

        if len(A_in.shape) == 3:
            A_3 = _host(A_in)
            A_in = np.zeros([I, self.N], np.float64)
            for i in range(I):
                A_in[i, :] = kn_to_n(A_3[i, :, :], N_k=self.N_k)

        if len(np.shape(u_n)) == 2:
            u_n = kn_to_n(_host(u_n), N_k=self.N_k)

        state_map = np.zeros([2, I], int)
        state_map[1, :] = np.arange(I)

        inner_results = self._expectations_inner(
            A_in, u_n, state_map, uncertainty_method,
            compute_uncertainty or compute_covariance or return_theta,
        )
        result_vals = dict()
        result_vals["mu"] = inner_results["observables"]

        if (
            (compute_uncertainty or compute_covariance)
            and compute_uncertainty != "bootstrap"
        ) or return_theta:
            Theta = self._sandwich(inner_results)

            if compute_uncertainty:
                covA_ij = (
                    Theta[0:I, 0:I]
                    + Theta[I : 2 * I, I : 2 * I]
                    - Theta[0:I, I : 2 * I]
                    - Theta[I : 2 * I, 0:I]
                )
                result_vals["sigma"] = torch.sqrt(covA_ij.diagonal()).cpu().numpy()

            if compute_covariance:
                result_vals["covariances"] = inner_results["Theta"][0:I, 0:I].cpu().numpy()

            if return_theta:
                result_vals["Theta"] = Theta.cpu().numpy()

        if uncertainty_method == "bootstrap":
            if compute_uncertainty:
                result_vals["sigma"] = np.std(
                    inner_results["bootstrapped_observables"], axis=0
                )
            if compute_covariance:
                result_vals["covariances"] = np.cov(
                    inner_results["bootstrapped_observables"].T
                )
        return result_vals

    def compute_perturbed_free_energies(
        self,
        u_ln,
        compute_uncertainty=True,
        uncertainty_method=None,
        warning_cutoff=1.0e-10,
    ):
        """Free energy differences between L perturbed (unsampled) states.

        Parameters
        ----------
        u_ln : np.ndarray or tensor, shape (L, N) or (L, K, N_max)
            Reduced potentials of every original sample evaluated in each of
            the L new states (all N original samples are required).
        compute_uncertainty : bool, optional, default True
        uncertainty_method : {None, 'approximate', 'svd', 'svd-ew', 'bootstrap'}, optional
        warning_cutoff : float, optional, default 1.0e-10

        Returns
        -------
        dict
            ``'Delta_f'`` : (L, L) free energy differences between the new
            states; ``'dDelta_f'`` : (L, L) uncertainties (if requested).

        Raises
        ------
        DataError
            If ``u_ln`` has fewer samples than the estimator was built on.

        Notes
        -----
        Reference: ``pymbar.MBAR.compute_perturbed_free_energies``
        (pymbar 4.x mbar.py:1442-1520).

        Examples
        --------
        >>> import numpy as np
        >>> from pymbar_tpu_torch import MBAR
        >>> from pymbar_tpu_torch.testsystems import HarmonicOscillatorsTestCase
        >>> tc = HarmonicOscillatorsTestCase(O_k=[0.0, 1.0], K_k=[1.0, 2.0])
        >>> x_n, u_kn, N_k, s_n = tc.sample(N_k=[400, 400], mode="u_kn", seed=2)
        >>> u_ln = np.vstack([u_kn[0], 0.5 * 3.0 * (x_n - 0.5) ** 2])
        >>> out = MBAR(u_kn, N_k).compute_perturbed_free_energies(u_ln)
        >>> out["Delta_f"].shape
        (2, 2)
        """
        if len(np.shape(u_ln)) == 3:
            u_ln = kln_to_kn(_host(u_ln), N_k=self.N_k)
        if not torch.is_tensor(u_ln):
            u_ln = np.asarray(u_ln)
        L, N = u_ln.shape

        if N < self.N:
            raise DataError(
                "There seems to be too few samples in u_kn. You must evaluate "
                "at the new potential with all of the samples used originally."
            )

        inner_results = self._expectations_inner(
            np.array([0]), u_ln, np.arange(L), uncertainty_method, compute_uncertainty
        )

        f_k = inner_results["f"]
        result_vals = dict()
        result_vals["Delta_f"] = f_k - np.vstack(f_k)

        if compute_uncertainty:
            if uncertainty_method == "bootstrap":
                result_vals["dDelta_f"] = np.std(inner_results["bootstrapped_f"], axis=0)
            else:
                result_vals["dDelta_f"] = self._ErrorOfDifferences(
                    inner_results["Theta"], warning_cutoff=warning_cutoff
                )

        return result_vals

    def compute_entropy_and_enthalpy(
        self, u_kn=None, uncertainty_method=None, verbose=False, warning_cutoff=1.0e-10
    ):
        """Decompose free energy differences into enthalpy and entropy.

        Computes ``Delta_u`` (differences of average reduced potential) and
        ``Delta_s = Delta_u - Delta_f`` with the 3K x 3K covariance algebra
        for their uncertainties.

        Parameters
        ----------
        u_kn : np.ndarray or tensor, optional
            Reduced potentials to average (defaults to the constructor's
            matrix, used as it is: never copied; kln layouts accepted).
        uncertainty_method : {None, 'approximate', 'svd', 'svd-ew', 'bootstrap'}, optional
        verbose : bool, optional, default False
        warning_cutoff : float, optional, default 1.0e-10

        Returns
        -------
        dict
            ``'Delta_f'``/``'dDelta_f'``, ``'Delta_u'``/``'dDelta_u'``,
            ``'Delta_s'``/``'dDelta_s'`` -- each a (K, K) numpy array.

        Notes
        -----
        The three sigma matrices come from the blocks of the (2K, 2K)
        Theta in f64 on its device (:meth:`_entropy_sigmas`).  Reference:
        ``pymbar.MBAR.compute_entropy_and_enthalpy`` (pymbar 4.x
        mbar.py:1524-1681).

        Examples
        --------
        >>> import numpy as np
        >>> from pymbar_tpu_torch import MBAR
        >>> from pymbar_tpu_torch.testsystems import HarmonicOscillatorsTestCase
        >>> tc = HarmonicOscillatorsTestCase(O_k=[0.0, 1.0], K_k=[1.0, 2.0])
        >>> x_n, u_kn, N_k, s_n = tc.sample(N_k=[400, 400], mode="u_kn", seed=4)
        >>> out = MBAR(u_kn, N_k).compute_entropy_and_enthalpy()
        >>> sorted(out)
        ['Delta_f', 'Delta_s', 'Delta_u', 'dDelta_f', 'dDelta_s', 'dDelta_u']
        """
        if verbose:
            logger.info("Computing average energy and entropy by MBAR.")

        if len(np.shape(u_kn)) == 3:
            u_kn = kln_to_kn(_host(u_kn), N_k=self.N_k)
        if u_kn is None:
            u_kn = self.u_kn

        K, N = np.shape(u_kn)
        state_map = np.vstack([np.arange(K), np.arange(K)])
        # A_n is u_kn itself: the inner call copies it where it must, and
        # streams the alias of self.u_kn without a copy
        inner_results = self._expectations_inner(
            u_kn, u_kn, state_map, uncertainty_method, True
        )

        result_vals = dict()
        f_k = inner_results["f"]
        result_vals["Delta_f"] = f_k - np.vstack(f_k)
        u_k = inner_results["observables"]
        result_vals["Delta_u"] = u_k - np.vstack(u_k)
        s_k = u_k - f_k
        result_vals["Delta_s"] = s_k - np.vstack(s_k)

        if uncertainty_method == "bootstrap":
            fb = self.f_k_boots
            result_vals["dDelta_f"] = np.std(fb[:, None, :] - fb[:, :, None], axis=0)
            ub = inner_results["bootstrapped_observables"]
            result_vals["dDelta_u"] = np.std(ub[:, None, :] - ub[:, :, None], axis=0)
            sb = ub - fb
            result_vals["dDelta_s"] = np.std(sb[:, None, :] - sb[:, :, None], axis=0)
        else:
            a = inner_results["observables"] - inner_results["Amin"]
            for name, cov in zip(("dDelta_f", "dDelta_u", "dDelta_s"),
                                 self._entropy_sigmas(inner_results["Theta"], a)):
                result_vals[name] = self._ErrorOfDifferences(cov, warning_cutoff=warning_cutoff)

        return result_vals

    @staticmethod
    def _entropy_sigmas(Th2, a):
        """The covariances of f, u and s from the (2K, 2K) augmented Theta's
        blocks (observables first, then the free energies), in f64 on
        Th2's device.  The reference assembles a 3K x 3K Theta whose third
        block copies the free energies unscaled and sandwiches it by
        diag([a, a, 1]) (mbar.py:1600-1610); with S(X) = diag(a) X diag(a):

        * covf = T_ff
        * covu = S(T_AA) + S(T_ff) - S(T_Af) - S(T_fA)
        * covs = covu + T_ff + a o T_Af + T_fA o a - a o T_ff - T_ff o a

        (row scaling on the left of o, column scaling on the right), summed
        in the reference's order."""
        K = Th2.shape[0] // 2
        a = torch.as_tensor(a, device=Th2.device)
        TAA, TAf = Th2[:K, :K], Th2[:K, K:]
        TfA, Tff = Th2[K:, :K], Th2[K:, K:]

        def S(X):
            return a[:, None] * X * a[None, :]

        covu = S(TAA) + S(Tff) - S(TAf) - S(TfA)
        covs = (covu + Tff + a[:, None] * TAf + TfA * a[None, :]
                - a[:, None] * Tff - Tff * a[None, :])
        return Tff, covu, covs

    @classmethod
    def _theta_from_gram(cls, gram, N_k, method):
        """Theta, a tensor on the Gram's device, from the Gram W^T W for
        'approximate' (the Gram itself) or 'svd-ew': on a CUDA Gram by the
        rank-nnz form (:meth:`_theta_svd_ew_lowrank`), as the JAX package
        does on its accelerator; on a CPU Gram by the dense numpy path."""
        if method == "approximate":
            return gram
        if gram.is_cuda:
            return cls._theta_svd_ew_lowrank(gram, N_k)
        return torch.from_numpy(cls._theta_svd_ew_from_gram(gram.numpy(), N_k))

    @staticmethod
    def _sigma_v(R):
        """Sigma and V of W from the R factor of a QR of W: the SVD of R =
        U_R Sigma V^T has W's Sigma and V."""
        _U, S, Vh = torch.linalg.svd(R, full_matrices=False)
        return S, Vh.T

    @classmethod
    def _theta_svd(cls, R, N_k):
        """The 'svd' covariance, Eq. D4, from W's R factor (reference
        mbar.py:1818-1835): V Sigma pinv(I - Sigma V^T diag(N) V Sigma)
        Sigma V^T, a tensor on R's device."""
        S, V = cls._sigma_v(R)
        VS = V * S[None, :]  # V @ Sigma
        Np = torch.as_tensor(np.asarray(N_k, dtype=np.float64), dtype=R.dtype, device=R.device)
        inner = torch.eye(S.numel(), dtype=R.dtype, device=R.device) - VS.T @ (Np[:, None] * VS)
        return VS @ cls._pseudoinverse(inner) @ VS.T

    @staticmethod
    def _pseudoinverse(A, tol=1.0e-10):
        """Moore-Penrose pseudoinverse of a tensor, cutting singular values
        at ``tol`` times the largest (np.linalg.pinv's rcond; reference
        mbar.py:1717-1735)."""
        return torch.linalg.pinv(A, rtol=tol)

    def _computeAsymptoticCovarianceMatrix(self, W, N_k, method=None):
        """Asymptotic covariance Theta of the log normalization constants
        from the (N, K) weights ``W`` (numpy, or a tensor on any device),
        returned as a numpy array (reference mbar.py:1756-1864):

        * 'approximate' -- Theta = W^T W (Kong 2003; underestimates);
        * 'svd'         -- Eq. D4 from the SVD of W;
        * 'svd-ew'      -- Eq. D4/D5 from eigh(W^T W) (the default).

        W^T W is one matmul on W's device.  'svd' needs only Sigma and V of
        W, from the R of its row blocks (:meth:`_theta_svd`), with no N x K
        factor besides W.
        """
        return self._asymptotic_theta(W, N_k, method).cpu().numpy()

    def _asymptotic_theta(self, W, N_k, method=None):
        """:meth:`_computeAsymptoticCovarianceMatrix` as a tensor on W's
        device (a numpy W is taken as a CPU tensor)."""
        if method is None or method == "bootstrap":
            method = "svd-ew"
        W = torch.as_tensor(W)
        N, K = W.shape
        N_k = np.asarray(N_k)
        if K != N_k.size:
            raise ParameterError("W must be NxK, where N_k is a K-dimensional array.")
        if np.sum(N_k) != N:
            raise ParameterError("W must be NxK, where N = sum_k N_k.")
        check_w_normalized(W, N_k)

        if method in ("approximate", "svd-ew"):
            return self._theta_from_gram(W.T @ W, N_k, method)
        if method != "svd":
            raise ParameterError(f"Method {method} unrecognized.")
        return self._theta_svd(_tsqr_rows(W), N_k)

    @staticmethod
    def _theta_svd_ew_from_gram(gram, N_k):
        """Eq. D4/D5 covariance from the K x K Gram alone (reference
        mbar.py:1837-1858): eigh(W^T W) supplies Sigma^2 and V, negative
        eigenvalues clamp to zero, and the inner pinv uses rcond=1e-10."""
        S2, V = np.linalg.eigh(gram)
        S2 = np.where(S2 < 0.0, 0.0, S2)
        Sigma_diag = np.sqrt(S2)
        Np = np.asarray(N_k, dtype=np.float64)
        I = np.identity(gram.shape[0], dtype=np.float64)
        VS = V * Sigma_diag[None, :]  # V @ Sigma
        inner = I - VS.T @ (Np[:, None] * VS)
        inner_pinv = np.linalg.pinv(inner, rcond=1.0e-10)
        return (VS @ inner_pinv) @ VS.T

    @staticmethod
    def _theta_svd_ew_lowrank(gram, N_k, rows=None):
        """The covariance of :meth:`_theta_svd_ew_from_gram`, computed
        through the rank structure of ``diag(N)`` on the Gram's device
        (the JAX package's ``MBAR._theta_svd_ew_lowrank``).

        With X = V Sigma (G = X X^T) and Z holding sqrt(N_k) e_k for the
        nnz sampled states, the inner matrix is I - U U^T with U = X^T Z,
        so its pinv expands spectrally from the eigh of the nnz x nnz

            H = diag(sqrt(N)) G_ss diag(sqrt(N)),

        giving Theta = G + F diag(phi) F^T with F = G Z P (P the
        eigenvectors of H) and phi_i = 1/(1 - lam_i), or -1/lam_i on
        directions the pinv truncates (|1 - lam_i| <= 1e-10 smax, smax >= 1,
        np.linalg.pinv's relative cutoff).  One nnz-sized eigh and two thin
        f64 matmuls replace a K-sized eigh, a pinv and three K^2 products.

        ``gram``: (K, K) float64 tensor (or array, taken as a CPU tensor).
        ``rows`` restricts the result to Theta[rows][:, rows].  Returns a
        float64 tensor on the Gram's device.
        """
        gram = torch.as_tensor(gram, dtype=torch.float64)
        dev = gram.device
        Np = torch.as_tensor(np.asarray(N_k, dtype=np.float64), device=dev)
        nz = torch.nonzero(Np > 0).flatten()
        sq = torch.sqrt(Np[nz])
        G_nz = gram.index_select(1, nz)
        H = G_nz.index_select(0, nz) * sq[:, None] * sq[None, :]
        lam, P = torch.linalg.eigh(H)
        one_minus = 1.0 - lam
        smax = torch.clamp(one_minus.abs().max(), min=1.0)
        trunc = one_minus.abs() <= 1.0e-10 * smax
        phi = torch.where(trunc, -1.0 / lam, 1.0 / torch.where(trunc, 1.0, one_minus))
        if rows is None:
            base, Gr_nz = gram, G_nz
        else:
            rows = torch.as_tensor(np.asarray(rows), device=dev)
            base = gram.index_select(0, rows).index_select(1, rows)
            Gr_nz = G_nz.index_select(0, rows)
        F = (Gr_nz * sq[None, :]) @ P
        return base + (F * phi[None, :]) @ F.T

    @staticmethod
    def _check_normalized_aggregates(column_sums, rowstats, tolerance=1.0e-4):
        """check_w_normalized (utils.py:340-393 parity) from streamed
        aggregates: the K column sums plus (count, first index, value) of
        the bad rows."""
        badcolumns = np.abs(column_sums - 1) > tolerance
        if np.any(badcolumns):
            firstbad = int(np.flatnonzero(badcolumns)[0])
            raise ParameterError(
                "Warning: Should have \\sum_n W_nk = 1. "
                f"Actual column sum for state {firstbad:d} was "
                f"{column_sums[firstbad]:f}. "
                f"{int(np.sum(badcolumns)):d} other columns have similar "
                "problems. \n"
                "This generally indicates the free energies are not converged."
            )
        n_bad_rows, first_bad_row, first_bad_val = rowstats
        if n_bad_rows > 0:
            raise ParameterError(
                "Warning: Should have \\sum_k N_k W_nk = 1. "
                f"Actual row sum for sample {first_bad_row:d} was "
                f"{first_bad_val:f}. "
                f"{n_bad_rows:d} other rows have similar problems. \n"
                "This generally indicates the free energies are not converged."
            )

    def _ErrorOfDifferences(self, cov, warning_cutoff=1.0e-10):
        """sigma_ij = sqrt(Theta_ii + Theta_jj - 2 Theta_ij), clamping tiny
        negatives and warning on large ones (reference mbar.py:1687-1715).
        ``cov`` is a numpy array or a tensor, computed on its device; the
        result is a numpy array."""
        cov = torch.as_tensor(cov)
        diag = cov.diagonal()
        d2 = diag[None, :] + diag[:, None] - 2 * cov
        cutoff = -abs(warning_cutoff)
        if bool((d2 < 0.0).any()):
            if bool((d2 < cutoff).any()):
                logger.warning(
                    "A squared uncertainty is negative. Largest Magnitude = "
                    "{0:f}".format(abs(float(d2[d2 < cutoff].min())))
                )
            else:
                d2[(0 > d2) & (d2 > cutoff)] = 0.0
        return torch.sqrt(d2).cpu().numpy()

    def _zerosamestates(self, A):
        """Zero entries for state pairs detected as identical (reference :1741-1754)."""
        for pair in self.samestates:
            A[pair[0], pair[1]] = 0
            A[pair[1], pair[0]] = 0

    def _initializeFreeEnergies(self, verbose=False, method="zeros", f_k_init=None):
        """Initial f_k guess: zeros, mean reduced potential or a BAR chain
        (reference mbar.py:1868-1917)."""
        if method == "zeros":
            if verbose:
                logger.info("Initializing free energies to zero.")
            self.f_k[:] = 0.0
        elif method == "mean-reduced-potential":
            if verbose:
                logger.info(
                    "Initializing free energies with mean reduced potential for each state."
                )
            means = np.zeros(self.K, float)
            for k in self.states_with_samples:
                means[k] = float(self.u_kn[k, 0 : self.N_k[k]].to(self.device, torch.float64).mean())
            if np.max(np.abs(means)) < 0.000001:
                logger.warning(
                    "Warning: All mean reduced potentials are close to zero. "
                    "If you are using energy differences in the u_kln matrix, "
                    "then the mean reduced potentials will be zero, and this "
                    "is expected behavior."
                )
            self.f_k = means
        elif method == "BAR":
            self.f_k = self._initialize_with_bar(self.u_kn, f_k_init)
        else:
            raise ParameterError("Method " + method + " unrecognized.")
        self.f_k[:] = self.f_k[:] - self.f_k[0]

    def _bar_pair_work(self, u_kn):
        """The BAR chain's pairs (k, l) of adjacent sampled states and each
        pair's host work values (w_F, w_R): w_F = u_l - u_k on state k's
        samples, w_R = u_k - u_l on state l's.  ``u_kn`` is a (K, N) tensor
        whose columns follow ``x_kindices``; every pair's values come out of
        it in one gather on its device, then are subtracted in float64 on
        ``self.device`` (a host-resident u_kn uploads only what it gathered)."""
        initialization_order = np.where(self.N_k > 0)[0]
        pairs = list(zip(initialization_order[:-1], initialization_order[1:]))
        if not pairs:
            return pairs, []
        k_indices = self._state_indices()
        rows_a, rows_b, cols, bounds = [], [], [], [0]
        for k, l in pairs:
            for a, b, idx in ((l, k, k_indices[k]), (k, l, k_indices[l])):
                rows_a.append(np.full(idx.size, a))
                rows_b.append(np.full(idx.size, b))
                cols.append(idx)
                bounds.append(bounds[-1] + idx.size)
        dev = u_kn.device
        ra, rb, c = (torch.as_tensor(np.concatenate(x), device=dev) for x in (rows_a, rows_b, cols))
        w = (u_kn[ra, c].to(self.device, torch.float64)
             - u_kn[rb, c].to(self.device, torch.float64)).cpu().numpy()
        return pairs, [(w[bounds[2 * i]:bounds[2 * i + 1]], w[bounds[2 * i + 1]:bounds[2 * i + 2]])
                       for i in range(len(pairs))]

    def _computeUnnormalizedLogWeights(self, u_n):
        """log w_n for a target potential u_n (numpy or a tensor):
        -logsumexp_k[f_k + u_n - u_kn] weighted by N_k (reference
        mbar.py:1919-1934), one reduction on ``self.device``.  Returns numpy."""
        return _unnormalized_log_weights(
            self.u_kn, u_n, self.N_k, self.f_k, self.device
        ).cpu().numpy()

    def _initialize_with_bar(self, u_kn, f_k_init=None):
        """Chain pairwise BAR along adjacent sampled states (reference
        mbar.py:1936-1988), on the work values of ``_bar_pair_work(u_kn)``;
        each pair's BAR solve runs on the host."""
        if f_k_init is None:
            f_k_init = np.zeros(len(self.f_k))
        else:
            f_k_init = np.array(f_k_init, dtype=np.float64, copy=True)
        pairs, works = self._bar_pair_work(u_kn)

        starting_f_k_init = f_k_init.copy()
        for (k, l), (w_F, w_R) in zip(pairs, works):
            if len(w_F) > 0 and len(w_R) > 0:
                try:
                    f_k_init[l] = (
                        f_k_init[k]
                        + bar(
                            w_F,
                            w_R,
                            method="bisection",
                            DeltaF=starting_f_k_init[l] - starting_f_k_init[k],
                            relative_tolerance=0.00001,
                            verbose=False,
                            maximum_iterations=100,
                            compute_uncertainty=False,
                        )["Delta_f"]
                    )
                except ConvergenceError:
                    logger.warning("WARNING: BAR did not converge to within tolerance")
                    f_k_init[l] = f_k_init[k]
            else:
                f_k_init[l] = 0

        return f_k_init
