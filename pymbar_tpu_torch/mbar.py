"""The MBAR estimator class (PyTorch port).

The counterpart of :class:`pymbar_tpu.mbar.MBAR` (reference pymbar 4.x
mbar.py:64-1988) for the solve, the free-energy differences and the
diagnostics: the same constructor surface (initialization by zeros, mean
reduced potential or a BAR chain), result-dictionary schema and uncertainty
methods None / 'svd-ew' / 'approximate' / 'svd' / 'bootstrap', the weights
(``Log_W_nk``, ``W_nk``, ``weights()``), the effective sample numbers and
the overlap, the solve on a 1-D device mesh (``mesh=``) and bootstrap
replicates on one device (``n_bootstraps=``).  Expectations, entropy and
the mesh bootstrap are still to be ported; the constructor raises
:class:`ParameterError` where it would need the mesh bootstrap.

``u_kn`` is held as a float64 tensor on one device: a tensor stays where it
is, a numpy array goes to ``device`` (default: the CUDA card; without one,
pass ``device="cpu"``).  Nothing moves between devices on its own.  Theta's
K x K algebra runs where the Gram is: on the card through the rank-nnz
form, on the CPU through the dense numpy eigh + pinv; the 'svd' estimator
factors W on u_kn's device.
"""

import logging

import numpy as np
import torch

from pymbar_tpu_torch import solvers as mbar_solvers
from pymbar_tpu_torch.ops.mbar_core import mbar_gram_normalization, mbar_log_W_nk
from pymbar_tpu_torch.other_estimators import bar
from pymbar_tpu_torch.parallel.sharding import default_mesh, sharded_solve_mbar_for_all_states
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
    ParameterError,
    check_w_normalized,
    kln_to_kn,
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


def _same_device(a, b):
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type == "cuda":
        ia = torch.cuda.current_device() if a.index is None else a.index
        ib = torch.cuda.current_device() if b.index is None else b.index
        return ia == ib
    return True


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
            # u_kln (K, L, N_max) -> (L, N), sample blocks in state order
            K, _L, N_max = u_kn.shape
            slot = torch.arange(N_max, device=u_kn.device)
            n_k = torch.as_tensor(N_k[:K], device=u_kn.device)
            u_kn = u_kn.permute(1, 0, 2)[:, slot[None, :] < n_k[:, None]]
        return u_kn.to(torch.float64).contiguous()
    if np.ndim(u_kn) == 3:
        u_kn = kln_to_kn(np.asarray(u_kn), N_k=N_k)
    return torch.as_tensor(np.array(u_kn, dtype=np.float64), device=target_device(device))


class MBAR:
    """Multistate Bennett acceptance ratio estimator on PyTorch.

    Parameters are those of :class:`pymbar_tpu.MBAR`, plus ``device``: where
    a numpy ``u_kn`` is placed (default "cuda", and without a card a
    :class:`ParameterError` that asks for ``device="cpu"``; a tensor's own
    device is used as it is).  ``n_bootstraps > 0`` with a mesh is not yet
    ported and raises :class:`ParameterError`.

    ``initialize="BAR"`` chains pairwise BAR along adjacent sampled states:
    each pair's work values are gathered from ``u_kn`` on its device in one
    pass and handed to the host :func:`pymbar_tpu_torch.bar`.

    ``n_bootstraps``: replicates drawn with the object's numpy
    ``default_rng(rseed)`` in the JAX package's order (replicate, then
    state), so a seed gives ``pymbar_tpu.MBAR``'s ``bootstrap_rints``.  On
    a dd solve with every state sampled, no BAR start and the default
    bootstrap protocol they ride the base solve's planes as counts-weighted
    polishes (:func:`pymbar_tpu_torch.solvers_large.solve_mbar_dd_bootstrap`,
    which sets ``bootstrap_at_floor``); otherwise each replicate is solved
    in turn on ``u_kn[:, rints]`` under ``bootstrap_solver_protocol``.  Where
    the automatic choice would take the mesh of several cards, a bootstrap
    takes the single-card dd route instead (the mesh bootstrap is not yet
    ported).

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
        self.u_kn = _u_tensor(u_kn, self.N_k, device)
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
        # solver_protocol wins over the mesh, with a warning.  A bootstrap
        # keeps to one card: the mesh bootstrap is not yet ported.
        several = torch.cuda.device_count() > 1
        if several and n_bootstraps > 0 and (
            mesh == "auto"
            or (solver_protocol is None and mesh is None and self._dd_sized())
        ):
            logger.info(
                "n_bootstraps > 0: the mesh bootstrap is not yet ported, so "
                "the solve and its replicates run on one card"
            )
            mesh = None
        elif mesh == "auto":
            mesh = default_mesh() if several else None
        self.mesh = mesh
        if mesh is not None and solver_protocol is not None:
            logger.warning(
                "Both mesh and an explicit solver_protocol were given; the "
                "explicit protocol runs on the default device and the mesh "
                "is ignored for the solve."
            )
            self.mesh = mesh = None
        if mesh is not None and n_bootstraps > 0:
            raise ParameterError(
                "n_bootstraps > 0 with a mesh (the mesh bootstrap) is not yet "
                "ported to pymbar_tpu_torch"
            )

        # The route gate: large CUDA problems with no protocol take the
        # double-word solver, sharded over every card when there are several.
        if solver_protocol is None and mesh is None and self._dd_sized():
            if several and n_bootstraps <= 0:
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
        if self.n_bootstraps > 0:
            self.bootstrap_rints = self._draw_bootstrap_rints(self.n_bootstraps)
            counts_route = (
                len(bootstrap_solver_protocol) == 1
                and bootstrap_solver_protocol[0]["method"] == "adaptive"
                and len(self.solver_protocol) == 1
                and self.solver_protocol[0]["method"] == "dd"
                and self.K_nonzero == self.K
                and initialize != "BAR"
            )
            if counts_route:
                counts = bootstrap_counts(self.bootstrap_rints, self.N)

        f_boots = None
        if counts is not None:
            stage = self.solver_protocol[0]
            self.f_k, f_boots, n_fail, info = solve_mbar_dd_bootstrap(
                self.u_kn, self.N_k, self.f_k, counts,
                tol=stage.get("tol", 1.0e-12), options=stage.get("options"), verbose=verbose,
            )
            self.solver_results = [dict(x=self.f_k, success=bool(info["converged"]), info=info)]
            self.bootstrap_at_floor = info["bootstrap_at_floor"]
            if not info["converged"]:
                logger.warning(
                    "dd MBAR solve did not converge to within tolerance "
                    f"(gnorm={info['gnorm']:.3e})"
                )
            if n_fail:
                logger.warning(
                    f"{n_fail:d}/{self.n_bootstraps:d} bootstrap replicates did not "
                    "converge to within tolerance."
                )
        elif mesh is not None:
            self.f_k, self.solver_results = sharded_solve_mbar_for_all_states(
                self.u_kn, self.N_k, self.f_k, self.states_with_samples, mesh
            )
        else:
            self.f_k, self.solver_results = mbar_solvers.solve_mbar_for_all_states(
                self.u_kn, self.N_k, self.f_k, self.states_with_samples, self.solver_protocol
            )

        if self.n_bootstraps > 0:
            self.f_k_boots = (
                f_boots if f_boots is not None
                else self._bootstrap_sequential(
                    bootstrap_solver_protocol, verbose, bar_start=initialize == "BAR"
                )
            )

        # Log_W_nk materializes on first access: an N x K array that
        # solve-only users never need.
        self._Log_W_nk = None
        self._Log_W_nk_assigned = False

        if self.verbose:
            logger.info(f"Final dimensionless free energies f_k = {self.f_k}")

    def _dd_sized(self):
        """The route gate's size test: a CUDA u_kn of at least _DD_ROUTE_BYTES."""
        return self.u_kn.is_cuda and self.u_kn.nbytes >= _DD_ROUTE_BYTES

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
        mbar.py:1013-1031).  Returns f_k_boots (B, K)."""
        f_k_boots = np.zeros((self.n_bootstraps, self.K))
        maxfrac = int(max(1, 0.1 * self.n_bootstraps))
        for b in range(self.n_bootstraps):
            rints = torch.as_tensor(self.bootstrap_rints[b], device=self.u_kn.device)
            u_b = self.u_kn.index_select(1, rints)
            f_k_init = self.f_k.copy()
            if bar_start:
                f_k_init = self._initialize_with_bar(u_b, f_k_init=self.f_k)
            f_k_boots[b], _ = mbar_solvers.solve_mbar_for_all_states(
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
        is placed as in ``__init__``.  Returns an MBAR with
        ``n_bootstraps = 0``.
        """
        self = cls.__new__(cls)
        self.N_k = np.array(N_k, dtype=np.int64)
        self.u_kn = _u_tensor(u_kn, self.N_k, device)
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
            u_sub = self.u_kn.index_select(1, sel).cpu().numpy()
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

    @property
    def Log_W_nk(self):
        """The N x K log-weight matrix (reference mbar.py:455) as a numpy
        array, computed on u_kn's device on first access and cached."""
        if self._Log_W_nk is None:
            self._Log_W_nk = mbar_log_W_nk(self.u_kn, self.N_k, self.f_k).cpu().numpy()
        return self._Log_W_nk

    @Log_W_nk.setter
    def Log_W_nk(self, value):
        self._Log_W_nk = value
        self._Log_W_nk_assigned = True

    def _W_nk_tensor(self):
        """exp(Log_W_nk) as an (N, K) tensor on u_kn's device.  Computed
        there (the cached host copy holds the same values, and moving it
        back would cost more than the pass), unless Log_W_nk was assigned."""
        if not self._Log_W_nk_assigned:
            return mbar_log_W_nk(self.u_kn, self.N_k, self.f_k).exp_()
        return torch.as_tensor(self._Log_W_nk, dtype=torch.float64, device=self.u_kn.device).exp()

    @property
    def W_nk(self):
        """The N x K weight matrix ``exp(Log_W_nk)`` as a numpy array.

        ``W_nk[n, k]`` is sample n's normalized weight in state k's
        estimate (columns sum to 1; rows weighted by N_k sum to 1).
        """
        return self._W_nk_tensor().cpu().numpy()

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
        """(W^T W, colsum W) as tensors on u_kn's device, from one streamed
        pass: W never exists in (N, K) form."""
        gram, colsum, _rowstats = mbar_gram_normalization(
            self.u_kn, self.N_k, self.f_k, tolerance=np.inf
        )
        return gram, colsum

    def compute_effective_sample_number(self, verbose=False):
        """Kish effective sample size of each state's MBAR estimate.

        ``N_eff[k] = 1 / sum_n W_nk^2`` -- how many independent samples the
        weighted estimate at state k is effectively worth; bounded by
        ``N_k <= N_eff[k] <= sum_k N_k`` for sampled states.  ``sum_n
        W_nk^2`` is the Gram diagonal, so this is one streamed pass on
        u_kn's device and only the K diagonal values leave it.  Reference:
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
        streamed f64 pass (:func:`mbar_gram_normalization`) on u_kn's device
        gives W^T W, the column sums and the row-check aggregates.  A CUDA
        Gram stays on the card for the rank-nnz form
        (:meth:`_theta_svd_ew_lowrank`), as the JAX package does on its
        accelerator; a CPU Gram takes the dense numpy path
        (:meth:`_theta_from_gram`).  'svd' needs W itself and factors
        exp(Log_W_nk) on u_kn's device
        (:meth:`_computeAsymptoticCovarianceMatrix`).  Theta is returned as a
        numpy array."""
        if method is None or method == "bootstrap":
            method = "svd-ew"
        if method == "svd":
            return self._computeAsymptoticCovarianceMatrix(
                self._W_nk_tensor(), self.N_k, method="svd"
            )
        if method not in ("svd-ew", "approximate"):
            raise ParameterError(f"Method {method} unrecognized.")
        gram, colsum, rowstats = mbar_gram_normalization(self.u_kn, self.N_k, self.f_k)
        self._check_normalized_aggregates(colsum.cpu().numpy(), rowstats)
        return self._theta_from_gram(gram, self.N_k, method)

    @classmethod
    def _theta_from_gram(cls, gram, N_k, method):
        """Theta (numpy) from the K x K Gram W^T W for 'approximate' (the
        Gram itself) or 'svd-ew': on a CUDA Gram by the rank-nnz form
        (:meth:`_theta_svd_ew_lowrank`), as the JAX package does on its
        accelerator; on a CPU Gram by the dense numpy path."""
        if method == "approximate":
            return gram.cpu().numpy()
        if gram.is_cuda:
            return cls._theta_svd_ew_lowrank(gram, N_k).cpu().numpy()
        return cls._theta_svd_ew_from_gram(gram.numpy(), N_k)

    @staticmethod
    def _svd_sigma_v(W):
        """Sigma and V of the (N, K) W = U Sigma V^T, on W's device: an f64
        Householder QR W = Q R (``mode="r"``, Q never formed), then the SVD
        of the K x K R = U_R Sigma V^T, which has W's Sigma and V."""
        R = torch.linalg.qr(W, mode="r")[1]
        _U, S, Vh = torch.linalg.svd(R)
        return S, Vh.T

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
        W, from :meth:`_svd_sigma_v`, with no N x K factor besides W.
        """
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
        S, V = self._svd_sigma_v(W)
        VS = V * S[None, :]  # V @ Sigma
        Np = torch.as_tensor(N_k, dtype=W.dtype, device=W.device)
        inner = torch.eye(K, dtype=W.dtype, device=W.device) - VS.T @ (Np[:, None] * VS)
        return (VS @ self._pseudoinverse(inner) @ VS.T).cpu().numpy()

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
        negatives and warning on large ones (reference mbar.py:1687-1715)."""
        diag = cov.diagonal()
        d2 = diag + np.vstack(diag) - 2 * cov
        cutoff = -abs(warning_cutoff)
        if np.any(d2 < 0.0):
            if np.any(d2 < cutoff):
                logger.warning(
                    "A squared uncertainty is negative. Largest Magnitude = "
                    "{0:f}".format(abs(np.min(d2[d2 < cutoff])))
                )
            else:
                d2[np.logical_and(0 > d2, d2 > cutoff)] = 0.0
        return np.sqrt(np.array(d2))

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
                means[k] = float(self.u_kn[k, 0 : self.N_k[k]].mean())
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
        it in one gather on its device."""
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
        w = (u_kn[ra, c] - u_kn[rb, c]).cpu().numpy()
        return pairs, [(w[bounds[2 * i]:bounds[2 * i + 1]], w[bounds[2 * i + 1]:bounds[2 * i + 2]])
                       for i in range(len(pairs))]

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
