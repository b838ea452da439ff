"""The MBAR estimator class (PyTorch port).

The counterpart of :class:`pymbar_tpu.mbar.MBAR` (reference pymbar 4.x
mbar.py:64-1988) for the solve and the free-energy differences: the same
constructor surface, result-dictionary schema and uncertainty methods
None / 'svd-ew' / 'approximate' / 'bootstrap', the solve on a 1-D device
mesh (``mesh=``) and bootstrap replicates on one device
(``n_bootstraps=``).  Expectations, entropy, overlap, BAR initialization
and the mesh bootstrap are still to be ported and raise
:class:`ParameterError` where the constructor would need them.

``u_kn`` is held as a float64 tensor on one device: a tensor stays where it
is, a numpy array goes to ``device`` (default: the CUDA card; without one,
pass ``device="cpu"``).  Nothing moves between devices on its own.  Theta's
K x K algebra runs where the Gram is: on the card through the rank-nnz
form, on the CPU through the dense numpy eigh + pinv.
"""

import logging

import numpy as np
import torch

from pymbar_tpu_torch import solvers as mbar_solvers
from pymbar_tpu_torch.ops.mbar_core import mbar_gram_normalization
from pymbar_tpu_torch.parallel.sharding import default_mesh, sharded_solve_mbar_for_all_states
from pymbar_tpu_torch.solvers import (
    BOOTSTRAP_SOLVER_PROTOCOL,
    DEFAULT_SOLVER_PROTOCOL,
    JAX_SOLVER_PROTOCOL,
    ROBUST_SOLVER_PROTOCOL,
    target_device,
)
from pymbar_tpu_torch.solvers_large import solve_mbar_dd_bootstrap
from pymbar_tpu_torch.utils import ParameterError, kln_to_kn

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
    device is used as it is).  ``initialize="BAR"`` and ``n_bootstraps > 0``
    with a mesh are not yet ported and raise :class:`ParameterError`.

    ``n_bootstraps``: replicates drawn with the object's numpy
    ``default_rng(rseed)`` in the JAX package's order (replicate, then
    state), so a seed gives ``pymbar_tpu.MBAR``'s ``bootstrap_rints``.  On
    a dd solve with every state sampled and the default bootstrap protocol
    they ride the base solve's planes as counts-weighted polishes
    (:func:`pymbar_tpu_torch.solvers_large.solve_mbar_dd_bootstrap`, which
    sets ``bootstrap_at_floor``); otherwise each replicate is solved in
    turn on ``u_kn[:, rints]`` under ``bootstrap_solver_protocol``.  Where
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
        if initialize == "BAR":
            raise ParameterError("initialize='BAR' is not yet ported to pymbar_tpu_torch")

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
            self._initializeFreeEnergies(verbose, method=initialize)

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
                else self._bootstrap_sequential(bootstrap_solver_protocol, verbose)
            )

        if self.verbose:
            logger.info(f"Final dimensionless free energies f_k = {self.f_k}")

    def _dd_sized(self):
        """The route gate's size test: a CUDA u_kn of at least _DD_ROUTE_BYTES."""
        return self.u_kn.is_cuda and self.u_kn.nbytes >= _DD_ROUTE_BYTES

    def _draw_bootstrap_rints(self, n_bootstraps):
        """(B, N) resample indices from ``self.rng``, drawn replicate by
        replicate and state by state as the JAX package does (mbar.py:
        871-895).  The per-state index lists (``np.where(x_kindices == k)``
        there, one scan of N per state and replicate) draw nothing, so they
        come once from one stable sort, which keeps each list ascending."""
        order = np.argsort(self.x_kindices, kind="stable")
        starts = np.searchsorted(self.x_kindices[order], np.arange(self.K + 1))
        k_indices = [order[starts[k]:starts[k + 1]] for k in range(self.K)]
        rints = np.zeros((n_bootstraps, self.N), int)
        for b in range(n_bootstraps):
            for k, idx in enumerate(k_indices):
                if len(idx) == 0:
                    continue
                n_k = int(self.N_k[k])
                rints[b, idx] = idx[self.rng.integers(n_k, size=n_k)]
        return rints

    def _bootstrap_sequential(self, bootstrap_solver_protocol, verbose):
        """Each replicate solved in turn on its resampled columns
        ``u_kn[:, rints]`` from the base f_k (the JAX package's sequential
        route, mbar.py:1013-1031).  Returns f_k_boots (B, K)."""
        f_k_boots = np.zeros((self.n_bootstraps, self.K))
        maxfrac = int(max(1, 0.1 * self.n_bootstraps))
        for b in range(self.n_bootstraps):
            rints = torch.as_tensor(self.bootstrap_rints[b], device=self.u_kn.device)
            f_k_boots[b], _ = mbar_solvers.solve_mbar_for_all_states(
                self.u_kn.index_select(1, rints), self.N_k, self.f_k.copy(),
                self.states_with_samples, bootstrap_solver_protocol,
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
        uncertainty_method : {None, 'approximate', 'svd-ew', 'bootstrap'}, optional
            ``None``/'svd-ew' uses the eigendecomposition form of Eq. D4;
            'approximate' uses Theta = W^T W (Kong 2003); 'bootstrap' the
            standard deviation over the replicates of ``n_bootstraps``.
            'svd' is not yet ported.
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
        accelerator; a CPU Gram takes the dense numpy path.  Theta is
        returned as a numpy array."""
        if method is None or method == "bootstrap":
            method = "svd-ew"
        if method == "svd":
            raise ParameterError(
                "uncertainty_method='svd' is not yet ported to pymbar_tpu_torch"
            )
        if method not in ("svd-ew", "approximate"):
            raise ParameterError(f"Method {method} unrecognized.")
        gram, colsum, rowstats = mbar_gram_normalization(self.u_kn, self.N_k, self.f_k)
        self._check_normalized_aggregates(colsum.cpu().numpy(), rowstats)
        if method == "approximate":
            return gram.cpu().numpy()
        if gram.is_cuda:
            return self._theta_svd_ew_lowrank(gram, self.N_k).cpu().numpy()
        return self._theta_svd_ew_from_gram(gram.numpy(), self.N_k)

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

    def _initializeFreeEnergies(self, verbose=False, method="zeros"):
        """Initial f_k guess: zeros or mean reduced potential (reference
        mbar.py:1868-1917; the BAR chain is not yet ported)."""
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
        else:
            raise ParameterError("Method " + method + " unrecognized.")
        self.f_k[:] = self.f_k[:] - self.f_k[0]
