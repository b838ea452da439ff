"""Free energy surfaces from MBAR-weighted samples: histogram, KDE, spline
(PyTorch port).

The counterpart of :mod:`pymbar_tpu.fes`, with capability parity with the
reference ``pymbar/fes.py`` class ``FES`` (pymbar 4.x fes.py:47-2477):

* histogram FES with analytical (augmented-Theta) or bootstrap uncertainties
* kernel-density FES -- the weighted Gaussian KDE of
  :mod:`pymbar_tpu_torch.kde` replaces the reference's sklearn dependency
* B-spline maximum-likelihood / MAP FES (Shirts & Ferguson,
  arXiv:2001.01170) with Custom-NR or scipy optimizers, AIC/BIC
* Metropolis MC sampling of the spline-coefficient posterior with
  decorrelation and Bayesian confidence intervals

``u_kn`` is one tensor shared with the internal
:class:`pymbar_tpu_torch.MBAR`, placed as MBAR places it: a tensor stays
where it is, numpy goes to ``device`` (default: ``PYMBAR_TPU_TORCH_DEVICE``
when set, else the CUDA card; without one, pass ``device="cpu"`` or set the
variable to "cpu"), and a CPU tensor with a CUDA ``device`` stays in host
memory, its column chunks streamed to the card by every pass
(``mbar_core.stream_columns``), as the JAX package keeps a numpy u_kn on
the host.  The device work runs on ``self.mbar.device``: the MBAR solve,
the per-sample log weights of the target state (one reduction over u_kn's
column chunks), the histogram's augmented covariance (streamed Gram, or
the materialized weights below ``mbar._AUG_STREAM_BYTES``), bootstrap
replicate solves (only their columns reach the device) and the KDE.
The histogram bookkeeping, the spline fits and the MC chain are host
numpy/scipy, as in the JAX package; only w_n comes from the device.

Known reference bugs intentionally fixed rather than reproduced (as in the
JAX package):
* the bootstrap loop re-created the MBAR object once per origin state
  instead of once per bootstrap (fes.py:394-406 indentation);
* the 'all-differences' analytical path indexed the covariance diagonal
  with a tuple (fes.py:1487) and crashed; implemented correctly here;
* querying an unpopulated bin raised KeyError; returns NaN here.
"""

import logging
import math
from timeit import default_timer as timer

import numpy as np
import torch
from scipy.integrate import quad
from scipy.interpolate import BSpline, make_lsq_spline
from scipy.optimize import minimize

from pymbar_tpu_torch import mbar as _mbar
from pymbar_tpu_torch import timeseries
from pymbar_tpu_torch.kde import GaussianKDE
from pymbar_tpu_torch.mbar import (
    MBAR,
    _host,
    _place,
    _unnormalized_log_weights,
    bootstrap_counts,
)
from pymbar_tpu_torch.ops.mbar_core import _logden_direct, stream_columns
from pymbar_tpu_torch.solvers import (
    DEFAULT_SOLVER_PROTOCOL,
    _solve_mbar_for_all_states,
    batched_bootstrap_solve,
)
from pymbar_tpu_torch.solvers_large import bootstrap_polish_dd, stream_split_planes
from pymbar_tpu_torch.utils import DataError, ParameterError, kn_to_n, logsumexp

logger = logging.getLogger(__name__)

__all__ = ["FES"]


def _hist_aug_gram(u_kn, u_n, flabel, f_bins, sampled, f_k, N_k, nbins, dev):
    """(K+nbins)^2 Gram of the histogram-augmented weight matrix, streamed
    over u_kn's column chunks on ``dev`` (:func:`stream_columns`: a host
    u_kn's chunks uploaded one at a time), in float64.

    The bin pseudo-state columns are disjoint selections of the target
    state's weights, B[n, l] = exp(log w_n + f_l) 1[flabel_n = l] in (0, 1],
    so the augmented Gram is the K x K Gram W0 W0^T, a K x nbins cross
    block W0 B^T (one matmul per chunk against the chunk's one-hot bin rows)
    and a diagonal bin block (the bin sums of B^2); the reference
    materializes the N x (K+nbins) matrix instead (pymbar 4.x
    fes.py:1382-1415).  The counterpart of the JAX package's
    ``_hist_aug_gram_scan``.  ``flabel`` (N,) holds each sample's bin column
    (-1: none), ``f_bins`` the bins' f, ``sampled`` the states with samples,
    whose N_k and f_k form the log-denominator.  Returns the (m, m) Gram as
    a float64 tensor on ``dev``.
    """
    K = u_kn.shape[0]
    f_k = torch.as_tensor(np.asarray(f_k, dtype=np.float64), device=dev)
    N_k = np.asarray(N_k, dtype=np.float64)
    all_sampled = sampled.size == K
    sel = None if all_sampled else torch.as_tensor(sampled, device=dev)
    N_s = torch.as_tensor(N_k[sampled], device=dev)
    f_s = f_k if all_sampled else f_k.index_select(0, sel)
    u_n = torch.as_tensor(u_n, dtype=torch.float64, device=dev)
    flabel = torch.as_tensor(flabel, device=dev)
    f_bins = torch.as_tensor(f_bins, dtype=torch.float64, device=dev)
    lidx = torch.arange(nbins, device=dev)[:, None]
    G00 = torch.zeros((K, K), dtype=torch.float64, device=dev)
    G0B = torch.zeros((K, nbins), dtype=torch.float64, device=dev)
    gbb = torch.zeros(nbins, dtype=torch.float64, device=dev)
    # a chunk builds nbins one-hot rows beside its K weight rows; a staging
    # chunk is reused once the next is asked for, so its products end here
    for s, e, u_c in stream_columns(u_kn, dev, extra_rows=nbins):
        fl = flabel[s:e]
        ld = _logden_direct(u_c if sel is None else u_c.index_select(0, sel), N_s, f_s)
        W0 = (f_k[:, None] - u_c).sub_(ld[None, :]).exp_()
        # exp(log w_n + f_l) <= 1 by construction (f_l normalizes its bin);
        # a sample with no bin column is masked before the exp
        inb = fl >= 0
        logB = torch.where(inb, (-u_n[s:e] - ld).add_(f_bins[fl.clamp_min(0)]), -torch.inf)
        Bv = logB.exp_()
        Brows = (fl[None, :] == lidx).to(torch.float64).mul_(Bv[None, :])  # (nbins, nc)
        G00 += W0 @ W0.T
        G0B += W0 @ Brows.T
        gbb += Brows @ Bv
        del W0, Brows
    return torch.cat([
        torch.cat([G00, G0B], dim=1),
        torch.cat([G0B.T, torch.diag(gbb)], dim=1),
    ])


class FES:
    """Free energy surface (profile) generation with statistical uncertainties.

    References: Shirts & Chodera JCP 129:124105 (2008); Shirts & Ferguson
    arXiv:2001.01170.  Input samples must be uncorrelated (subsample first).
    """

    def __init__(self, u_kn, N_k, verbose=False, mbar_options=None, timings=True, device=None,
                 **kwargs):
        """Prepare a free-energy-surface estimator over the sampled states.

        Builds an internal :class:`pymbar_tpu_torch.MBAR` whose weights
        unbias the samples; :meth:`generate_fes` then fits a surface over
        any collective variable.

        Parameters
        ----------
        u_kn : np.ndarray or torch.Tensor, float, shape (K, N) or (K, K, N_max)
            Reduced potential of each sample in each sampled (biased) state.
            A tensor stays on its device; numpy goes to ``device``; a CPU
            tensor with a CUDA ``device`` stays in host memory (as in
            :class:`pymbar_tpu_torch.MBAR`).
        N_k : np.ndarray, int, shape (K,)
            Samples per state.
        verbose : bool, optional, default False
        mbar_options : dict, optional
            Passed through to the internal MBAR: ``maximum_iterations``,
            ``relative_tolerance``, ``verbose``, ``initial_f_k``,
            ``solver_protocol``, ``initialize``, ``x_kindices``.
        timings : bool, optional, default True
            Return wall-time in :meth:`generate_fes`'s result dict.
        device : str or torch.device, optional
            Where the work runs and a numpy ``u_kn`` goes (default:
            ``PYMBAR_TPU_TORCH_DEVICE`` when set, else the CUDA card;
            without one, pass ``"cpu"``).  The internal MBAR and the KDE use
            the same device.

        Notes
        -----
        Reference: ``pymbar.FES.__init__``
        (pymbar 4.x fes.py:74-210).

        Examples
        --------
        >>> import numpy as np
        >>> from pymbar_tpu_torch import FES
        >>> rng = np.random.default_rng(0)
        >>> K_bias, centers = 25.0, np.linspace(0.0, 1.0, 5)
        >>> x_kn = centers[:, None] + rng.normal(0, 0.2, (5, 200))
        >>> u_kn = 0.5 * K_bias * (x_kn.reshape(-1)[None, :] - centers[:, None]) ** 2
        >>> fes = FES(u_kn, np.full(5, 200))
        >>> fes.mbar.f_k.shape
        (5,)
        """
        for key, val in kwargs.items():
            logger.warning(f"Warning: parameter {key}={val} is unrecognized and unused.")

        self.N_k = np.array(N_k, dtype=np.int64)
        # one tensor, shared with the internal MBAR, which works on `dev`
        self.u_kn, dev = _place(u_kn, self.N_k, device)
        K, N = self.u_kn.shape

        if np.sum(self.N_k) != N:
            raise ParameterError(
                "The sum of all N_k must equal the total number of samples "
                "(length of second dimension of u_kn."
            )

        self.K = K
        self.N = N
        self.verbose = verbose
        self.timings = bool(timings)

        if mbar_options is None:
            fes_mbar = MBAR(self.u_kn, N_k, device=dev)
        else:
            mbar_options = dict(mbar_options)
            for o in (
                "maximum_iterations",
                "relative_tolerance",
                "verbose",
                "initial_f_k",
                "solver_protocol",
                "initialize",
                "x_kindices",
            ):
                mbar_options.setdefault(o, None)
            if mbar_options["maximum_iterations"] is None:
                mbar_options["maximum_iterations"] = 10000
            if mbar_options["relative_tolerance"] is None:
                mbar_options["relative_tolerance"] = 1.0e-7
            if mbar_options["initialize"] is None:
                mbar_options["initialize"] = "zeros"

            fes_mbar = MBAR(
                self.u_kn,
                N_k,
                maximum_iterations=mbar_options["maximum_iterations"],
                relative_tolerance=mbar_options["relative_tolerance"],
                verbose=bool(mbar_options["verbose"]),
                initial_f_k=mbar_options["initial_f_k"],
                solver_protocol=mbar_options["solver_protocol"],
                initialize=mbar_options["initialize"],
                x_kindices=mbar_options["x_kindices"],
                device=dev,
            )

        self.mbar = fes_mbar

        self.fes_type = None
        self.u_n = None
        self.n_bootstraps = 0
        self.w_n = None
        self.fes_function = None
        self.fes_functions = None
        self.histogram_data = None
        self.histogram_datas = None
        self.histogram_parameters = None
        self.kde = None
        self.kdes = None
        self.kde_parameters = None
        self.spline_data = None
        self.spline_parameters = None
        self.mc_data = None
        self.bootstrap_indices = None
        self.bootstrap_route = None
        self.f_k_boots = None

        if self.verbose:
            logger.info("FES initialized")

    @property
    def w_kn(self):
        """The N x K MBAR weight matrix (reference fes.py attribute parity),
        computed on access from the internal MBAR's ``Log_W_nk``."""
        return np.exp(self.mbar.Log_W_nk)

    # -------------------------------------------------------------------------
    # Generation
    # -------------------------------------------------------------------------

    def generate_fes(
        self,
        u_n,
        x_n,
        fes_type="histogram",
        histogram_parameters=None,
        kde_parameters=None,
        spline_parameters=None,
        n_bootstraps=0,
        seed=-1,
    ):
        """Fit a free energy surface at the target (unbiased) state.

        Parameters
        ----------
        u_n : np.ndarray, shape (N,) or (K, N_max)
            Reduced potential of every sample in the TARGET state the
            surface is wanted for (often the unbiased Hamiltonian).
        x_n : np.ndarray, shape (N,) or (N, D)
            The collective-variable value of each sample.
        fes_type : {'histogram', 'kde', 'spline'}, optional
            Estimator family.  'histogram' bins the unbiased weights
            (D-dimensional), 'kde' fits a weighted Gaussian kernel density,
            'spline' maximizes the continuous-FES likelihood over a
            B-spline basis (1-D).
        histogram_parameters : dict, optional
            ``{'bin_edges': [edges_d ...]}`` — bin edges per dimension.
        kde_parameters : dict, optional
            sklearn ``KernelDensity``-style surface: ``bandwidth`` etc.
        spline_parameters : dict, optional
            ``spline_weights`` ('biasedstates'/'unbiasedstate'/'simplesum'),
            ``objective`` ('ml'/'map' + logprior/dlogprior/ddlogprior),
            ``optimization_algorithm``, ``nspline``, ``kdegree``,
            ``fes_reference``, initialization controls.
        n_bootstraps : int, optional, default 0
            0 or >= 2; replicate MBAR re-solves power bootstrap
            uncertainties in :meth:`get_fes`.
        seed : int, optional, default -1
            Seeds ``np.random`` when >= 0 (bootstrap reproducibility).

        Returns
        -------
        dict
            ``{'timing': seconds}`` when the estimator was built with
            ``timings=True``.

        Notes
        -----
        Reference: ``pymbar.FES.generate_fes``
        (pymbar 4.x fes.py:221-438), with the reference's mis-indented
        bootstrap loop bug fixed.  The replicates' resample indices are the
        JAX package's draws from ``np.random`` (``bootstrap_indices``).
        When the internal MBAR took the double-word route on one device
        with every state sampled, the replicates solve as counts-weighted
        polishes of its planes (:func:`pymbar_tpu_torch.solvers_large.
        bootstrap_polish_dd`, ``bootstrap_route == "counts"``); otherwise
        each solves in turn on its gathered columns from the base f_k
        (``"replicate"``).  ``f_k_boots`` holds their (B, K) f_k.

        Examples
        --------
        >>> import numpy as np
        >>> from pymbar_tpu_torch import FES
        >>> rng = np.random.default_rng(0)
        >>> K_bias, centers = 25.0, np.linspace(0.0, 1.0, 5)
        >>> x_kn = centers[:, None] + rng.normal(0, 0.2, (5, 200))
        >>> x_n = x_kn.reshape(-1)
        >>> u_kn = 0.5 * K_bias * (x_n[None, :] - centers[:, None]) ** 2
        >>> fes = FES(u_kn, np.full(5, 200), timings=False)
        >>> _ = fes.generate_fes(np.zeros_like(x_n), x_n, fes_type="histogram",
        ...     histogram_parameters=dict(bin_edges=[np.linspace(-0.5, 1.5, 11)]))
        >>> out = fes.get_fes(np.array([0.25, 0.75]), reference_point="from-lowest")
        >>> out["f_i"].shape
        (2,)
        """
        result_vals = dict()
        self.fes_type = fes_type

        u_n = _host(u_n)
        if len(np.shape(u_n)) == 2:
            u_n = kn_to_n(u_n, N_k=self.N_k)
        self.u_n = np.asarray(u_n)

        if seed >= 0:
            np.random.seed(seed)

        if not np.issubdtype(type(n_bootstraps), np.integer) or n_bootstraps == 1:
            raise ValueError(
                f"n_bootstraps must be an integer of 0 or >=2, it was set to {n_bootstraps}"
            )
        self.n_bootstraps = n_bootstraps

        if self.timings:
            start = timer()

        self.fes_function = list()
        self.mc_data = None

        if fes_type == "histogram":
            self._setup_fes_histogram(histogram_parameters)
        elif fes_type == "kde":
            self._setup_fes_kde(kde_parameters)
        elif fes_type == "spline":
            self._setup_fes_spline(spline_parameters)
        else:
            raise ParameterError(f"fes_type {fes_type} is not defined!")

        N_k = self.mbar.N_k
        K = self.mbar.K
        N = int(np.sum(N_k))

        x_n = np.asarray(_host(x_n))

        # Every replicate's per-state resample indices, drawn first (the
        # same np.random draws, in the same order, as the reference's loop,
        # fes.py:388-406), then every replicate's f_k.
        self.bootstrap_indices = self.bootstrap_route = self.f_k_boots = None
        if n_bootstraps > 0:
            all_indices = np.zeros((n_bootstraps, N), int)
            for b in range(n_bootstraps):
                index = 0
                for k in range(K):
                    all_indices[b, index : index + N_k[k]] = index + np.random.randint(
                        0, N_k[k], size=N_k[k]
                    )
                    index += N_k[k]
                    # Stream parity: the reference's (mis-indented)
                    # bootstrap loop reconstructs an MBAR object after
                    # every state's draw, and each construction consumes
                    # one rseed scalar from the global np.random stream
                    # (pymbar 4.x mbar.py:274).  Discard the same draw so
                    # a given seed yields the reference's replicate index
                    # streams.
                    np.random.randint(np.iinfo(np.int32).max)
            self.bootstrap_indices = all_indices
            self.bootstrap_route = "counts" if self._counts_route() else "replicate"
            self.f_k_boots, n_fail = self._replicate_free_energies(all_indices, self.bootstrap_route)
            if n_fail:
                logger.warning(
                    f"{n_fail:d}/{n_bootstraps:d} bootstrap replicates "
                    "did not converge to within tolerance."
                )

        # log w_n of the target state at every f (base and replicates), on
        # the MBAR's device, in one pass each
        for b in range(n_bootstraps + 1):
            if b == 0:
                log_w_nb = self._unnormalized_log_weights(None, self.mbar.f_k)
                x_nb = x_n
            else:
                log_w_nb = self._unnormalized_log_weights(all_indices[b - 1],
                                                          self.f_k_boots[b - 1])
                x_nb = x_n[all_indices[b - 1]]
            max_log_w_nb = np.max(log_w_nb)
            w_nb = np.exp(log_w_nb - max_log_w_nb)
            w_nb = w_nb / np.sum(w_nb)

            if b == 0:
                self.w_n = w_nb

            if fes_type == "histogram":
                self._generate_fes_histogram(b, x_nb, w_nb, log_w_nb)
            elif fes_type == "kde":
                self._generate_fes_kde(b, x_nb, w_nb)
            elif fes_type == "spline":
                self._generate_fes_spline(b, x_nb, w_nb)

        if self.timings:
            result_vals["timing"] = timer() - start

        return result_vals

    def _counts_route(self):
        """Whether bootstrap replicates can ride the internal MBAR's
        double-word planes: a single-device dd solve (its chord factor in
        ``solver_results``) with every state sampled."""
        m = self.mbar
        info = m.solver_results[0].get("info", {}) if m.solver_results else {}
        return (
            m.mesh is None
            and len(m.solver_protocol) == 1
            and m.solver_protocol[0]["method"] == "dd"
            and m.K_nonzero == m.K
            and info.get("hinv") is not None
        )

    def _replicate_free_energies(self, all_indices, route):
        """(f_k_boots (B, K) with f_0 = 0, n_fail) of the replicates whose
        resample indices are the rows of ``all_indices``.

        ``route="counts"``: every replicate is the base data reweighted by
        its per-sample multiplicities, solved by the batched counts-weighted
        dd polish on the internal MBAR's planes from its f_k and chord
        factor (the counterpart of the JAX package's batched TPU branch).
        ``route="replicate"``: each solves on its gathered columns
        ``u_kn[:, indices]`` warm from the base f_k: on a card within the
        internal MBAR's batched gate all at once by
        :func:`pymbar_tpu_torch.solvers.batched_bootstrap_solve` (the JAX
        package's TPU branch), else in turn by ``_solve_mbar_for_all_states``
        under the default protocol (its off-TPU branch; ``n_fail`` is then
        0, as there).  A host-resident u_kn never reaches the device whole:
        the batched route copies each replicate's columns out of its
        uploaded column chunks, the sequential one gathers them on the
        host."""
        m = self.mbar
        if route == "counts":
            uh, ul = stream_split_planes(m.u_kn, m.device)
            f_boots, n_fail, _info = bootstrap_polish_dd(
                uh, ul, m.N_k, m.f_k, m.solver_results[0]["info"]["hinv"],
                bootstrap_counts(all_indices, m.N),
            )
            return f_boots - f_boots[:, :1], n_fail
        if route != "replicate":
            raise ParameterError(f"unknown bootstrap route {route!r}")
        if m._batched_boot_sized():
            return batched_bootstrap_solve(m.u_kn, m.N_k, m.f_k, all_indices, device=m.device)
        protocol = MBAR._resolve_protocol(None, DEFAULT_SOLVER_PROTOCOL, 10000)
        f_boots = np.zeros((len(all_indices), m.K))
        for b, indices in enumerate(all_indices):
            cols = torch.as_tensor(indices, device=m.u_kn.device)
            f_boots[b], _results = _solve_mbar_for_all_states(
                m.u_kn.index_select(1, cols).to(m.device, torch.float64),
                m.N_k, np.asarray(m.f_k), m.states_with_samples, protocol,
            )
        return f_boots, 0

    def _unnormalized_log_weights(self, indices, f_b):
        """log w_n of the target state at free energies f_b:
        -logsumexp_k[f_b + u_n - u_kn] weighted by N_k (the f_k
        generalization of MBAR._computeUnnormalizedLogWeights, reference
        mbar.py:1919-1934), as numpy.  One reduction over u_kn's column
        chunks on the MBAR's device; a replicate's values are those of its
        resampled columns (``indices``; None: every sample once), gathered
        on the host, since each column reduces alone."""
        log_w = _unnormalized_log_weights(self.u_kn, self.u_n, self.mbar.N_k, f_b,
                                          self.mbar.device).cpu().numpy()
        return log_w if indices is None else log_w[indices]

    # --------------------------- histogram ----------------------------------

    def _setup_fes_histogram(self, histogram_parameters):
        """Validate bin_edges (list of per-dimension edge arrays)."""
        if "bin_edges" not in histogram_parameters:
            raise ParameterError(
                "histogram_parameters['bin_edges'] cannot be undefined with "
                "fes_type = histogram"
            )
        # Normalize to a list of per-dimension edge arrays.  (np.shape on a
        # ragged list of unequal-length edge arrays raises; probe the first
        # element instead so unequal grids per dimension work.)
        be = histogram_parameters["bin_edges"]
        if isinstance(be, np.ndarray) and be.ndim == 1:
            be = [be]
        elif np.isscalar(be[0]):
            be = [np.asarray(be)]
        else:
            be = [np.asarray(e) for e in be]
        histogram_parameters["bin_edges"] = be

        self.histogram_parameters = histogram_parameters
        self.histogram_data = None
        self.histogram_datas = list() if self.n_bootstraps > 0 else None

    def _generate_fes_histogram(self, b, x_n, w_nb, log_w_nb):
        """Bin samples and compute per-bin free energies f_i = -logsumexp(log w).

        Bin bookkeeping follows the reference (fes.py:440-600): integer bin
        labels by positional encoding sum_d bin_d * len(bins_d)^d; out-of-grid
        samples get label -1; a stable ``bin_order`` fixed by the b==0 pass
        keeps free energies aligned across bootstraps.  The per-sample loops
        are vectorized here.
        """
        histogram_parameters = self.histogram_parameters
        bins = histogram_parameters["bin_edges"]
        dims = len(bins)

        histogram_data = dict(dims=dims, bins=bins)

        if len(np.shape(x_n)) == 1:
            x_n = x_n.reshape(-1, 1)

        bin_n = np.zeros(x_n.shape, int)
        bin_length = np.zeros(dims, int)
        for d in range(dims):
            bin_length[d] = len(bins[d])
            bin_n[:, d] = np.digitize(x_n[:, d], bins[d]) - 1

        histogram_data["bin_n"] = bin_n

        # Positional-encoded integer label per sample; -1 when out of grid.
        weights_d = bin_length.astype(np.int64) ** np.arange(dims)
        encoded = bin_n @ weights_d
        out_of_grid = np.any(bin_n < 0, axis=1)
        sample_label = np.where(out_of_grid, -1, encoded).astype(int)

        # First-occurrence-ordered unique bins (reference appends bins in
        # sample order).
        _, first_idx = np.unique(sample_label, return_index=True)
        first_idx = np.sort(first_idx)
        nonzero_bins = [tuple(bin_n[i]) for i in first_idx]
        bin_label = {tuple(bin_n[i]): int(sample_label[i]) for i in first_idx}

        histogram_data["nonzero_bins"] = nonzero_bins
        histogram_data["sample_label"] = sample_label

        if b == 0:
            bin_order = {}
            i = 0
            for bv in bin_label.values():
                if bv not in bin_order:
                    bin_order[bv] = i
                    i += 1
            histogram_data["bin_order"] = bin_order
            histogram_data["bin_label"] = bin_label
        else:
            bin_order = self.histogram_data["bin_order"]

        f_i = np.zeros(max(len(bin_label), len(bin_order)), np.float64)
        for label in bin_label.values():
            indices = np.where(sample_label == label)
            if len(indices[0]) == 0:
                raise DataError(
                    f"WARNING: bin {label} has no samples -- all bins must "
                    "have at least one sample."
                )
            if label in bin_order:
                f_i[bin_order[label]] = -logsumexp(log_w_nb[indices])

        histogram_data["f"] = f_i

        if b == 0:
            self.histogram_data = histogram_data
        else:
            self.histogram_datas.append(histogram_data)

    # ------------------------------ KDE -------------------------------------

    def _setup_fes_kde(self, kde_parameters):
        """Configure the weighted Gaussian KDE (sklearn surface), on u_kn's
        device."""
        kde = GaussianKDE(device=self.mbar.device)
        kde_defaults = kde.get_params()
        for k in kde_defaults:
            if k in kde_parameters:
                kde_defaults[k] = kde_parameters[k]
        for k in kde_parameters:
            if k not in kde_defaults:
                raise ParameterError(
                    f"Warning: {k} is not a parameter in KernelDensity"
                )
        kde.set_params(**kde_defaults)

        self.kde_parameters = kde_parameters
        self.kdes = list() if self.n_bootstraps > 0 else None
        self.kde = kde

    def _generate_fes_kde(self, b, x_n, w_n):
        """Fit the (bootstrap) KDE with the MBAR weights of the target state."""
        if len(np.shape(x_n)) == 1:
            x_n = x_n.reshape(-1, 1)

        if b > 0:
            kde = GaussianKDE(device=self.mbar.device)
            kde.set_params(**self.kde.get_params())
        else:
            kde = self.kde
        kde.fit(x_n, sample_weight=self.w_n)

        if b > 0:
            self.kdes.append(kde)

    # ----------------------------- spline -----------------------------------

    def _setup_fes_spline(self, spline_parameters):
        """Validate spline options and build the initial B-spline
        (reference fes.py:701-969)."""
        spline_parameters = dict(spline_parameters)
        spline_parameters.setdefault("objective", "ml")
        objective = spline_parameters["objective"]

        if objective not in ["ml", "map"]:
            raise ParameterError(
                f"objective may only be 'ml' or 'map': you have selected {objective}"
            )

        if objective == "ml":
            if spline_parameters.get("map_data") is not None:
                raise ParameterError(
                    "if 'objective' is 'ml' then 'map_data' structure "
                    "containing priors should not be included"
                )
            spline_parameters["map_data"] = dict(
                logprior=None, dlogprior=None, ddlogprior=None
            )
        else:
            map_data = spline_parameters.get("map_data")
            if map_data is None:
                raise ParameterError("MAP data must be defined if objective is MAP")
            if map_data.get("logprior") is None:
                raise ParameterError("log prior must be included if objective is MAP")
            if map_data.get("dlogprior") is None:
                raise ParameterError("d(log prior) must be included if objective is MAP")
            if map_data.get("ddlogprior") is None:
                raise ParameterError("d^2(log prior) must be included if objective is MAP")

        if spline_parameters["optimization_algorithm"] != "Custom-NR":
            if "optimize_options" not in spline_parameters:
                spline_parameters["optimize_options"] = {
                    "disp": True,
                    "ftol": 1e-7,
                    "xtol": 1e-7,
                }
            if "tol" in spline_parameters["optimize_options"]:
                spline_parameters["scipy_tol"] = spline_parameters["optimize_options"]["tol"]
                spline_parameters["optimize_options"].pop("tol", None)
            else:
                spline_parameters["scipy_tol"] = None
            if spline_parameters["optimization_algorithm"] not in [
                "Newton-CG",
                "CG",
                "BFGS",
                "L-BFGS-B",
                "TNC",
                "SLSQP",
            ]:
                raise ParameterError(
                    "Optimization method {:s} is not supported".format(
                        spline_parameters["optimization_algorithm"]
                    )
                )
        else:
            spline_parameters.setdefault("optimize_options", dict())
            if "gtol" not in spline_parameters["optimize_options"]:
                spline_parameters["optimize_options"]["tol"] = 1e-7

        self.spline_parameters = spline_parameters

        xinit, yinit = self._get_initial_spline_points()
        self.spline_data = self._get_initial_spline(xinit, yinit)

        self.fes_functions = list() if self.n_bootstraps > 0 else None

    def _get_initial_spline_points(self):
        """Initial (x, y) control data: bias free energies / explicit / zeros."""
        spline_parameters = self.spline_parameters
        nspline = spline_parameters["nspline"]
        kdegree = spline_parameters["kdegree"]
        xrange = spline_parameters["xrange"]

        mode = spline_parameters["spline_initialize"]
        if mode == "bias_free_energies":
            initvals = self.mbar.f_k
            if "bias_centers" in spline_parameters:
                bias_centers = np.asarray(spline_parameters["bias_centers"])
                sort_indices = np.argsort(bias_centers)
                K = self.mbar.K
                if K < 2 * nspline:
                    noverfit = int(np.round(K / 2))
                    tinit = np.zeros(noverfit + kdegree + 1)
                    tinit[0:kdegree] = xrange[0]
                    tinit[kdegree : noverfit + 1] = np.linspace(
                        xrange[0], xrange[1], num=noverfit + 1 - kdegree, endpoint=True
                    )
                    tinit[noverfit + 1 :] = xrange[1]
                    binit = make_lsq_spline(
                        bias_centers[sort_indices], initvals[sort_indices], tinit, k=kdegree
                    )
                    xinit = np.linspace(xrange[0], xrange[1], num=2 * nspline)
                    yinit = binit(xinit)
                else:
                    xinit = bias_centers[sort_indices]
                    yinit = initvals[sort_indices]
            else:
                xinit = np.linspace(xrange[0], xrange[1], self.mbar.K + 1)[1:-1]
                yinit = initvals
        elif mode == "explicit":
            if "xinit" not in spline_parameters:
                raise ParameterError(
                    "spline_initialize set as explicit, but no xinit array specified"
                )
            if "yinit" not in spline_parameters:
                raise ParameterError(
                    "spline_initialize set as explicit, but no yinit array specified"
                )
            xinit = spline_parameters["xinit"]
            yinit = spline_parameters["yinit"]
        elif mode == "zeros":
            xinit = np.linspace(xrange[0], xrange[1], nspline + kdegree)
            yinit = np.zeros(len(xinit))
        else:
            raise ParameterError(f"Initialization type {mode} not recognized")

        return np.asarray(xinit), np.asarray(yinit)

    def _get_initial_spline(self, xinit, yinit):
        """LSQ-fit the initial spline; precompute basis derivatives and their
        support ranges (reference fes.py:881-969)."""
        spline_data = {}
        spline_parameters = self.spline_parameters

        kdegree = spline_parameters["kdegree"]
        nspline = spline_parameters["nspline"]
        xrange = spline_parameters["xrange"]

        t = np.zeros(nspline + kdegree + 1)
        t[0:kdegree] = xrange[0]
        t[kdegree : nspline + 1] = np.linspace(
            xrange[0], xrange[1], num=nspline + 1 - kdegree, endpoint=True
        )
        t[nspline + 1 :] = xrange[1]

        sort_indices = np.argsort(xinit)
        b = make_lsq_spline(xinit[sort_indices], yinit[sort_indices], t, k=kdegree)
        b.c = b.c - b.c[0]  # FES defined up to a constant; pin c_0 = 0
        xi = b.c[1:]

        # Basis functions (derivatives of the spline wrt each coefficient).
        db_c = []
        for i in range(nspline):
            dc = np.zeros(nspline)
            dc[i] = 1.0
            db_c.append(BSpline(b.t, dc, b.k))

        # Support ranges: basis i lives on [t_i, t_{i+k+1}].
        xrangei = np.zeros([nspline, 2])
        for i in range(nspline):
            xrangei[i, 0] = t[i]
            xrangei[i, 1] = t[i + kdegree + 1]

        xrangeij = np.zeros([nspline, nspline, 2])
        for i in range(nspline):
            for j in range(nspline):
                xrangeij[i, j, 0] = max(xrangei[i, 0], xrangei[j, 0])
                xrangeij[i, j, 1] = min(xrangei[i, 1], xrangei[j, 1])

        spline_data["initial_coefficients"] = xi
        spline_data["bspline_derivatives"] = db_c
        spline_data["bspline"] = b
        spline_data["xrangei"] = xrangei
        spline_data["xrangeij"] = xrangeij

        # Fixed quadrature grid replacing the reference's per-basis-pair
        # adaptive scipy.quad (reference fes.py:2418-2428; SURVEY §7 hard
        # part #4).  Every integrand in the likelihood is (piecewise
        # polynomial) x exp(-spline - bias): composite Gauss-Legendre on
        # the knot intervals (4 subpanels x order 12 each) integrates them
        # to ~1e-12 for any smooth bias, and turns the O(nspline^2 K)
        # quad calls per Newton iteration into a handful of small matrix
        # contractions on a P ~ 1e3-point grid.
        breaks = np.unique(t)
        nodes, weights = np.polynomial.legendre.leggauss(12)
        sub = 4
        qx, qw = [], []
        for lo, hi in zip(breaks[:-1], breaks[1:]):
            edges = np.linspace(lo, hi, sub + 1)
            for s in range(sub):
                a, c = edges[s], edges[s + 1]
                half = 0.5 * (c - a)
                qx.append(0.5 * (a + c) + half * nodes)
                qw.append(half * weights)
        quad_x = np.concatenate(qx)
        quad_w = np.concatenate(qw)
        # Basis values at the grid (row 0 = the pinned-c_0 basis).
        quad_B = np.stack([db_c[i](quad_x) for i in range(nspline)], axis=0)
        spline_data["quad_x"] = quad_x
        spline_data["quad_w"] = quad_w
        spline_data["quad_B"] = quad_B
        spline_data["quad_range"] = (float(breaks[0]), float(breaks[-1]))
        return spline_data

    def _generate_fes_spline(self, b, x_n, w_n):
        """Maximize the spline log-likelihood (scipy or custom Newton with
        backtracking); store AIC/BIC on the b==0 fit (reference fes.py:971-1098)."""
        # Splines are 1-D; accept (N, 1) column layout and flatten so the
        # objective/gradient return true scalars/vectors.
        x_n = np.asarray(x_n)
        if x_n.ndim == 2 and x_n.shape[1] == 1:
            x_n = x_n[:, 0]

        if b == 0:
            xi = self.spline_data["initial_coefficients"].copy()
        else:
            xi = self.spline_data["first_coefficients"].copy()

        spline_parameters = self.spline_parameters
        func = self._bspline_calculate_f
        grad = self._bspline_calculate_g
        hess = self._bspline_calculate_h
        spline_args = (x_n, w_n)

        if spline_parameters["optimization_algorithm"] != "Custom-NR":
            results = minimize(
                func,
                xi,
                args=spline_args,
                method=spline_parameters["optimization_algorithm"],
                jac=grad,
                tol=spline_parameters["scipy_tol"],
                hess=hess if spline_parameters["optimization_algorithm"] == "Newton-CG" else None,
                options=spline_parameters["optimize_options"],
            )
            bspline = self._val_to_spline(results["x"], form="log")
            savexi = results["x"]
        else:
            opts = spline_parameters["optimize_options"]
            tol = opts.get("gtol", opts.get("tol"))
            # The reference's Custom-NR loop has no iteration cap and spins
            # forever when quadrature noise floors the gradient norm above
            # tol; bound it here and warn instead.
            maxiter = opts.get("maxiter", 200)

            dg = tol * 1e10
            firsttime = True
            fold = np.inf
            xold = xi.copy()
            dx = np.zeros_like(xi)
            iteration = 0
            while dg > tol and iteration < maxiter:
                iteration += 1
                f = func(xi, *spline_args)
                if firsttime:
                    firsttime = False
                else:
                    count = 0
                    # Backtrack when the step overshot.  (The reference's
                    # isinf branch is uncapped and can spin forever and its
                    # 0.9 shrink can't rescue a wildly long Newton step,
                    # fes.py:1049-1056; halve with a hard cap instead.)
                    while (f >= fold + abs(fold) * 0.1 or not np.isfinite(f)) and count < 60:
                        f = fold
                        dx = 0.5 * dx
                        xi = xold - dx
                        xold = xi.copy()
                        f = func(xi, *spline_args)
                        count += 1

                fold = f
                xold = xi.copy()
                g = grad(xi, *spline_args)
                h = hess(xi, *spline_args)
                if not (np.all(np.isfinite(g)) and np.all(np.isfinite(h))):
                    logger.warning(
                        "Custom-NR encountered non-finite derivatives; "
                        "stopping at the last finite iterate."
                    )
                    break
                dx = np.linalg.lstsq(h, g, rcond=None)[0]
                xi = xold - dx
                dg = np.sqrt(np.dot(g, g))
                if opts.get("disp"):
                    logger.info(f"f = {float(f):.10f}. gradient norm = {np.sqrt(dg):.10f}")
            if dg > tol:
                logger.warning(
                    f"Custom-NR did not reach gradient tolerance {tol:g} in "
                    f"{maxiter:d} iterations (gnorm = {dg:g}); quadrature "
                    "noise may floor the achievable gradient norm."
                )
            bspline = self._val_to_spline(xi, form="log")
            savexi = xi

        if b == 0:
            nparameters = len(savexi)
            minus_log_likelihood = func(savexi, *spline_args)
            self.spline_data["first_coefficients"] = savexi
            results_ic = self._calculate_information_criteria(
                nparameters, minus_log_likelihood, self.N
            )
            self.spline_data["aic"] = results_ic["aic"]
            self.spline_data["bic"] = results_ic["bic"]
            self.fes_function = bspline
        else:
            self.fes_functions.append(bspline)

    @staticmethod
    def _calculate_information_criteria(nparameters, minus_log_likelihood, N):
        """AIC = 2p + 2(-lnL); BIC = 2 ln(N) p + 2(-lnL) (reference :1100-1134)."""
        return dict(
            aic=2 * nparameters + 2 * minus_log_likelihood,
            bic=2 * np.log(N) * nparameters + 2 * minus_log_likelihood,
        )

    def get_information_criteria(self, type="akaike"):
        """Information criterion of the fitted spline model.

        Parameters
        ----------
        type : {'akaike', 'AIC', 'bayesian', 'BIC'}, optional

        Returns
        -------
        float
            The requested criterion (stored at spline fit time).

        Notes
        -----
        Reference: ``pymbar.FES.get_information_criteria``
        (pymbar 4.x fes.py:1136-1165).
        """
        if self.fes_type != "spline":
            raise ParameterError(
                "Information criteria currently only defined for spline "
                f"approaches, you are currently using {self.fes_type}"
            )
        if type in ["akaike", "Akaike", "AIC", "aic"]:
            return self.spline_data["aic"]
        if type in ["bayesian", "Bayesian", "BIC", "bic"]:
            return self.spline_data["bic"]
        raise ParameterError(f"Information criteria of type '{type}' not defined")

    # -------------------------------------------------------------------------
    # Evaluation
    # -------------------------------------------------------------------------

    def get_fes(
        self, x, reference_point="from-lowest", fes_reference=None, uncertainty_method=None
    ):
        """Evaluate the fitted free energy surface at query points.

        Parameters
        ----------
        x : np.ndarray, shape (M,) or (M, D)
            Query points in collective-variable space.
        reference_point : str, optional, default 'from-lowest'
            Zero of the surface: 'from-lowest' (minimum over the queried
            values), 'from-specified' (the point given in
            ``fes_reference``), 'from-normalization' (int exp(-F) = 1;
            KDE/spline only), or 'all-differences' (histogram analytical
            mode: return pairwise difference matrices instead).
        fes_reference : array_like, optional
            The reference point for 'from-specified'.
        uncertainty_method : {None, 'analytical', 'bootstrap'}, optional
            'analytical' augments the weight matrix per histogram bin and
            propagates the asymptotic covariance (histogram only);
            'bootstrap' uses the replicate fits from ``generate_fes``.

        Returns
        -------
        dict
            ``'f_i'`` : (M,) surface values (NaN outside the fitted
            domain); ``'df_i'`` : (M,) uncertainties when requested; in
            'all-differences' mode ``'df_ij'`` matrices instead.

        Notes
        -----
        Reference: ``pymbar.FES.get_fes``
        (pymbar 4.x fes.py:1167-1231); the reference's broken
        'all-differences' covariance indexing (fes.py:1487) is fixed here.
        """
        x = np.array(x)
        if len(np.shape(x)) <= 1:
            x = x.reshape(-1, 1)

        if reference_point == "from-specified" and fes_reference is None:
            logger.info(
                "No reference state specified for FES, using "
                "uncertainty_method = from-specified"
            )

        if self.fes_type == "histogram":
            return self._get_fes_histogram(x, reference_point, fes_reference, uncertainty_method)
        if self.fes_type == "kde":
            return self._get_fes_kde(x, reference_point, fes_reference, uncertainty_method)
        if self.fes_type == "spline":
            return self._get_fes_spline(x, reference_point, fes_reference, uncertainty_method)
        raise ParameterError(f"fes_type {self.fes_type} is not supported")

    def get_mbar(self):
        """The internal :class:`pymbar_tpu_torch.MBAR` object.

        Returns
        -------
        MBAR
            The estimator built over the biased states at construction.

        Raises
        ------
        DataError
            If the internal MBAR was never initialized.
        """
        if self.mbar is not None:
            return self.mbar
        raise DataError("MBAR in the FES object is not initialized, cannot return it.")

    def get_kde(self):
        """The fitted weighted kernel-density object (KDE surfaces only).

        Returns
        -------
        pymbar_tpu_torch.kde.GaussianKDE
            The sklearn-``KernelDensity``-surface object fitted by
            :meth:`generate_fes`.

        Raises
        ------
        ParameterError
            If no KDE has been fitted or ``fes_type != 'kde'``.
        """
        if self.fes_type == "kde":
            if self.kde is not None:
                return self.kde
            raise ParameterError(
                "Can't return the KernelDensity object because kde not yet defined"
            )
        raise ParameterError("Can't return the KernelDensity object because fes_type != kde")

    def _get_fes_histogram(
        self, x, reference_point="from-lowest", fes_reference=None, uncertainty_method=None
    ):
        """Histogram FES evaluation with analytical (augmented W_nk -> Theta)
        or bootstrap uncertainties (reference fes.py:1263-1521)."""
        histogram_data = self.histogram_data
        histogram_datas = self.histogram_datas

        if np.shape(x)[1] != histogram_data["dims"]:
            raise DataError(
                "query coordinates have inconsistent dimension with the data "
                "the FES is fit to."
            )

        if uncertainty_method not in ["bootstrap", "analytical", None]:
            raise ParameterError(
                f"Uncertainty_method {uncertainty_method} is not a valid option"
            )

        if uncertainty_method == "bootstrap":
            if histogram_datas is None:
                raise ParameterError(
                    "Can't calculate uncertainties via bootstrap if "
                    "bootstrapping was not performed when running get_fes"
                )
            n_bootstraps = len(histogram_datas)

        result_vals = {}

        bins = histogram_data["bins"]
        dims = histogram_data["dims"]
        bin_order = histogram_data["bin_order"]
        nbins = len(bin_order)

        loc_indices = np.zeros([len(x), dims], dtype=int)
        for d in range(dims):
            loc_indices[:, d] = np.digitize(x[:, d], bins[d]) - 1

        if reference_point == "from-specified":
            if fes_reference is None:
                raise ParameterError("Specified reference point for FES not given")
            if dims == 1 and np.ndim(fes_reference) == 0:
                fes_reference = [fes_reference]
            fes_ref_grid = np.zeros([dims], dtype=int)
            for d in range(dims):
                fes_ref_grid[d] = np.digitize(fes_reference[d], bins[d]) - 1
                if fes_ref_grid[d] == -1 or fes_ref_grid[d] == len(bins[d]):
                    raise ParameterError(
                        "Specified reference point coordinate {:f} in dim {:d} "
                        "grid point is out of the FES region [{:f},{:f}]".format(
                            fes_ref_grid[d], d, np.min(bins[d]), np.max(bins[d])
                        )
                    )

        Theta_ij = None
        j = 0
        f_i = histogram_data["f"].copy()
        df_i = np.zeros(len(f_i), np.float64)

        if reference_point in ["from-lowest", "from-specified", "all-differences"]:
            if reference_point == "from-lowest":
                j = histogram_data["f"].argmin()
            elif reference_point == "from-specified":
                ref_bin_label = histogram_data["bin_label"][tuple(fes_ref_grid)]
                j = bin_order[ref_bin_label]

            f_i = histogram_data["f"] - histogram_data["f"][j]

            if uncertainty_method == "analytical" or (
                reference_point == "all-differences" and uncertainty_method == "analytical"
            ):
                Theta_ij = self._histogram_augmented_theta(histogram_data, nbins, bin_order)
                K = self.mbar.K
                for i in range(nbins):
                    df_i[i] = math.sqrt(
                        Theta_ij[K + i, K + i]
                        + Theta_ij[K + j, K + j]
                        - 2.0 * Theta_ij[K + i, K + j]
                    )
            elif uncertainty_method == "bootstrap":
                fall = np.zeros([len(histogram_data["f"]), n_bootstraps])
                for b in range(n_bootstraps):
                    h = histogram_datas[b]
                    fall[:, b] = h["f"] - h["f"][j]
                df_i = np.std(fall, axis=1)

        elif reference_point == "from-normalization":
            raise ParameterError(
                "uncertainty_method 'from-normalization' is not currently "
                "supported for histograms"
            )

        # Map query points to bins; out-of-grid / unpopulated -> NaN.
        fx_vals = np.zeros(len(x))
        dfx_vals = np.zeros(len(x))
        maxp = np.array([len(bins[d]) for d in range(dims)])

        query_orders = np.full(len(x), -1, dtype=int)
        for i, l in enumerate(loc_indices):
            if np.any(l < 0) or np.any(l >= maxp - 1):
                fx_vals[i] = np.nan
                dfx_vals[i] = np.nan
                continue
            bl = histogram_data["bin_label"].get(tuple(l), -1)
            if bl >= 0:
                fx_vals[i] = f_i[bin_order[bl]]
                dfx_vals[i] = df_i[bin_order[bl]]
                query_orders[i] = bin_order[bl]
            else:
                fx_vals[i] = np.nan
                dfx_vals[i] = np.nan

        result_vals["f_i"] = fx_vals
        if uncertainty_method is not None:
            result_vals["df_i"] = dfx_vals

        if reference_point == "all-differences":
            # Full matrix of pairwise uncertainties between query points.
            # (The reference's analytical branch here is broken, fes.py:1487;
            # implemented correctly from the same covariance algebra.)
            if uncertainty_method == "analytical":
                if Theta_ij is None:
                    Theta_ij = self._histogram_augmented_theta(
                        histogram_data, nbins, bin_order
                    )
                K = self.mbar.K
                bin_block = Theta_ij[K : K + nbins, K : K + nbins]
                diag = bin_block.diagonal()
                d2f_ij = diag[:, None] + diag[None, :] - 2 * bin_block
                df_ij = np.sqrt(np.clip(d2f_ij, 0.0, None))

                dfxij_vals = np.full([len(x), len(x)], np.nan)
                for a, va in enumerate(query_orders):
                    for c, vc in enumerate(query_orders):
                        if va >= 0 and vc >= 0:
                            dfxij_vals[a, c] = df_ij[va, vc]
            elif uncertainty_method == "bootstrap":
                nb = len(histogram_datas)
                fall = np.zeros([nbins, nbins, nb])
                for b in range(nb):
                    fb = histogram_datas[b]["f"]
                    fall[:, :, b] = fb[:, None] - fb[None, :]
                df_ij = np.std(fall, axis=2)
                dfxij_vals = np.full([len(x), len(x)], np.nan)
                for a, va in enumerate(query_orders):
                    for c, vc in enumerate(query_orders):
                        if va >= 0 and vc >= 0:
                            dfxij_vals[a, c] = df_ij[va, vc]
            if uncertainty_method is not None:
                result_vals["df_ij"] = dfxij_vals

        return result_vals

    @staticmethod
    def _bin_columns(histogram_data):
        """Each sample's bin column (-1: none) from the b=0 labeling
        (``histogram_data["bin_order"]``).  Every labeled bin -- the pooled
        out-of-grid pseudo-bin (label -1) too, when present -- occupies a
        column, as in the reference."""
        bin_order = histogram_data["bin_order"]
        labels = np.array(list(bin_order), dtype=np.int64)
        columns = np.array(list(bin_order.values()), dtype=np.int64)
        order = np.argsort(labels)
        labels, columns = labels[order], columns[order]
        slab = histogram_data["sample_label"]
        pos = np.minimum(np.searchsorted(labels, slab), labels.size - 1)
        return np.where(labels[pos] == slab, columns[pos], -1)

    def _histogram_augmented_theta(self, histogram_data, nbins, bin_order):
        """Theta over [K states | nbins bin pseudo-states]: W_nk augmented
        with per-bin renormalized weights (reference fes.py:1382-1415), as
        numpy, computed on u_kn's device.

        From ``mbar._AUG_STREAM_BYTES`` of u_kn up the N x (K+nbins)
        augmented W never exists: the bin columns are disjoint selections of
        the target state's weights, so the augmented Gram streams in one
        pass (:func:`_hist_aug_gram`) and Theta comes from the rank-nnz
        svd-ew form (``MBAR._theta_svd_ew_lowrank``), as in the JAX
        package's device branch.  Below it the augmented W is built and goes
        through ``_computeAsymptoticCovarianceMatrix``, as in its host
        branch."""
        m = self.mbar
        K = m.K
        N_k = np.zeros(K + nbins, np.int64)
        N_k[0:K] = m.N_k
        flabel = self._bin_columns(histogram_data)

        if m._u_bytes() >= _mbar._AUG_STREAM_BYTES:
            gram = _hist_aug_gram(m.u_kn, self.u_n, flabel, histogram_data["f"],
                                  m.states_with_samples, m.f_k, m.N_k, nbins, m.device)
            return m._theta_svd_ew_lowrank(gram, N_k).cpu().numpy()

        dev = m.device
        W_nk = torch.zeros((m.N, K + nbins), dtype=torch.float64, device=dev)
        W_nk[:, 0:K] = m._W_nk_tensor()
        log_w_n = _unnormalized_log_weights(m.u_kn, self.u_n, m.N_k, m.f_k, dev)
        n = torch.as_tensor(np.flatnonzero(flabel >= 0), device=dev)
        col = torch.as_tensor(flabel[flabel >= 0], device=dev)
        f_bins = torch.as_tensor(histogram_data["f"], dtype=torch.float64, device=dev)
        W_nk[n, K + col] = torch.exp(log_w_n[n] + f_bins[col])
        return m._computeAsymptoticCovarianceMatrix(W_nk, N_k)

    def _get_fes_kde(
        self, x, reference_point="from-normalization", fes_reference=None, uncertainty_method=None
    ):
        """KDE FES evaluation (reference fes.py:1523-1609)."""
        if np.shape(x)[1] != self.kde.n_features_in_:
            raise DataError(
                "query coordinates have inconsistent dimension with the data "
                "the FES is fit to."
            )

        result_vals = {}
        f_i = -self.kde.score_samples(x)

        fmin = 0.0
        if reference_point == "from-lowest":
            fmin = np.min(f_i)
            f_i = f_i - fmin
        elif reference_point == "from-specified":
            fmin = -self.kde.score_samples(np.array(fes_reference).reshape(1, -1))
            f_i = f_i - fmin
        elif reference_point == "from-normalization":
            pass
        else:
            raise ParameterError(
                f"reference point choice {reference_point} for kde is unavailable"
            )

        result_vals["f_i"] = f_i

        if uncertainty_method is None:
            df_i = None
        elif uncertainty_method == "bootstrap":
            if self.kdes is None:
                raise ParameterError(
                    "Cannot calculate bootstrap error of bootstrap KDE's not determined"
                )
            n_bootstraps = len(self.kdes)
            fall = np.zeros([len(x), n_bootstraps])
            for b in range(n_bootstraps):
                fall[:, b] = -self.kdes[b].score_samples(x) - fmin
            df_i = np.std(fall, axis=1)
        else:
            raise ParameterError(
                f"Uncertainty method {uncertainty_method} for kde is not implemented"
            )

        result_vals["df_i"] = df_i
        return result_vals

    def _get_fes_spline(
        self, x, reference_point="from-lowest", fes_reference=0.0, uncertainty_method=None
    ):
        """Spline FES evaluation (1-D only; reference fes.py:1611-1694)."""
        if np.shape(x)[1] != 1:
            raise DataError("splines FES only supported in 1D")

        result_vals = {}
        x = x[:, 0]
        f_i = self.fes_function(x)

        fmin = 0.0
        if reference_point == "from-lowest":
            fmin = np.min(f_i)
            f_i = f_i - fmin
        elif reference_point == "from-specified":
            fmin = -self.fes_function(np.array(fes_reference).reshape(1, -1))
            f_i = f_i - fmin
        else:
            raise ParameterError(
                f"reference point {reference_point} not implemented for spline fes"
            )

        df_i = None
        if uncertainty_method == "bootstrap":
            if self.fes_functions is None:
                raise ParameterError(
                    "Cannot calculate via uncertainties error if bootstrapping "
                    "was not performed running get_fes"
                )
            n_bootstraps = len(self.fes_functions)
            fall = np.zeros(list(x.shape) + [n_bootstraps])
            for b in range(n_bootstraps):
                fall[:, b] = self.fes_functions[b](x) - fmin
            df_i = np.std(fall, axis=-1)

        result_vals["f_i"] = f_i
        result_vals["df_i"] = df_i
        return result_vals

    # -------------------------------------------------------------------------
    # MCMC over spline parameters
    # -------------------------------------------------------------------------

    def sample_parameter_distribution(self, x_n, mc_parameters=None, decorrelate=True, verbose=True):
        """Metropolis sampling of the spline-coefficient posterior.

        One coefficient is perturbed per step; the spline is renormalized
        (``int exp(-F) = 1``) after every move; the accepted chain is
        optionally decorrelated with the timeseries tools.  Results are
        stored for :meth:`get_confidence_intervals` / :meth:`get_mc_data`.

        Parameters
        ----------
        x_n : np.ndarray, shape (N,)
            The samples' collective-variable values (as in generate_fes).
        mc_parameters : dict, optional
            ``niterations`` (default 5000), ``fraction_change`` (step size,
            0.01), ``sample_every`` (50), ``logprior`` / ``dlogprior``
            (callables; flat prior by default), ``print_every``.
        decorrelate : bool, optional, default True
            Subsample the chain at its statistical inefficiency.
        verbose : bool, optional, default True

        Notes
        -----
        Spline surfaces only.  Reference:
        ``pymbar.FES.sample_parameter_distribution``
        (pymbar 4.x fes.py:1696-1857).
        """
        if self.fes_type != "spline":
            raise ParameterError("Sampling of posterior is only supported for spline type")

        spline_parameters = self.spline_parameters
        if spline_parameters is None:
            raise ParameterError("Must specify spline_parameters to sample the distributions")

        spline_weights = spline_parameters["spline_weights"]
        xrange = spline_parameters["xrange"]

        if self.fes_function is None:
            raise ParameterError(
                "Need to generate an initial splined FES using generate_fes "
                "before performing MCMC sampling"
            )

        if mc_parameters is None:
            logger.info("Using default MC parameters")
            mc_parameters = dict()
        mc_parameters.setdefault("niterations", 5000)
        mc_parameters.setdefault("fraction_change", 0.01)
        mc_parameters.setdefault("sample_every", 50)
        mc_parameters.setdefault("print_every", 1000)
        mc_parameters.setdefault("logprior", lambda x: 0)

        niterations = mc_parameters["niterations"]
        fraction_change = mc_parameters["fraction_change"]
        sample_every = mc_parameters["sample_every"]
        print_every = mc_parameters["print_every"]
        logprior = mc_parameters["logprior"]

        self.mc_data = dict()
        self.mc_data["bspline"] = self.fes_function
        bspline = self.mc_data["bspline"]

        def prob(x):
            return np.exp(-bspline(x))

        norm = self._integrate(prob, xrange[0], xrange[1])
        bspline.c = bspline.c + np.log(norm)

        self.mc_data["original_spline"] = BSpline(bspline.t, bspline.c, bspline.k)

        c = bspline.c
        crange = np.max(c) - np.min(c)
        dc = fraction_change * crange

        self.mc_data["naccept"] = 0
        csamples = np.zeros([len(c), int(niterations) // int(sample_every)])
        logposteriors = np.zeros(int(niterations) // int(sample_every))
        self.mc_data["first_step"] = True

        for n in range(niterations):
            results = self._MC_step(x_n, self.w_n, dc, xrange, spline_weights, logprior)
            if n % sample_every == 0:
                csamples[:, n // sample_every] = results["c"]
                logposteriors[n // sample_every] = results["logposterior"]
            if n % print_every == 0 and verbose:
                logger.info(
                    f"MC Step {n:d} of {niterations:d} "
                    f"{results['logposterior']} {bspline.c}"
                )

        t_mc = 0
        g_mc = None

        if verbose:
            logger.info("Done MC sampling")

        if decorrelate:
            t_mc, g_mc, Neff = timeseries.detect_equilibration(logposteriors)
            logger.info(
                f"First equilibration sample is {t_mc:d} of {len(logposteriors):d}"
            )
            equil_logp = logposteriors[t_mc:]
            g_mc = timeseries.statistical_inefficiency(equil_logp)
            if verbose:
                logger.info(f"Statistical inefficiency of log posterior is {g_mc:.3g}")
            g_c = np.zeros(len(c))
            for nc in range(len(c)):
                g_c[nc] = timeseries.statistical_inefficiency(csamples[nc, t_mc:])
            if verbose:
                logger.info(f"Time series for spline parameters are : {g_c}")
            guse = g_mc
            indices = timeseries.subsample_correlated_data(equil_logp, g=guse)
            logposteriors = equil_logp[indices]
            csamples = (csamples[:, t_mc:])[:, indices]
            if verbose:
                logger.info(f"samples after decorrelation : {np.shape(csamples)[1]:d}")
            self.mc_data["g_parameters"] = g_c
            self.mc_data["g"] = guse

        self.mc_data["samples"] = csamples
        self.mc_data["logposteriors"] = logposteriors
        self.mc_data["mc_parameters"] = mc_parameters
        self.mc_data["acceptance_ratio"] = self.mc_data["naccept"] / niterations
        if verbose:
            logger.info(f"Acceptance rate : {self.mc_data['acceptance_ratio']:5.3f}")
        self.mc_data["nequil"] = t_mc
        self.mc_data["g_logposterior"] = g_mc

    def get_confidence_intervals(self, xplot, plow, phigh, reference="zero"):
        """Confidence bands of the MCMC-sampled FES at given points.

        Parameters
        ----------
        xplot : array_like
            Points to evaluate the band at.
        plow, phigh : float
            Lower/upper percentiles (e.g. 2.5 and 97.5).
        reference : {'zero', None}, optional
            'zero' shifts each sampled surface so its first value is 0.

        Returns
        -------
        dict
            ``'plow'``/``'phigh'`` : the percentile curves; ``'median'``;
            ``'values'`` : the full (n_samples, len(xplot)) matrix.

        Notes
        -----
        Requires :meth:`sample_parameter_distribution` first.  Reference:
        ``pymbar.FES.get_confidence_intervals``
        (pymbar 4.x fes.py:1859-1926).
        """
        if self.mc_data is None:
            raise DataError("No MC sampling has been done, cannot construct confidence intervals")

        nplot = len(xplot)
        nsamples = len(self.mc_data["logposteriors"])
        samplevals = np.zeros([nplot, nsamples])

        csamples = self.mc_data["samples"]
        base_spline = self.mc_data["original_spline"]

        yvals = base_spline(xplot)
        for n in range(nsamples):
            pcurve = BSpline(base_spline.t, csamples[:, n], base_spline.k)
            samplevals[:, n] = pcurve(xplot)

        ylows = np.percentile(samplevals, plow, axis=1)
        yhighs = np.percentile(samplevals, phigh, axis=1)
        ymedians = np.percentile(samplevals, 50, axis=1)

        if reference == "zero":
            ref = np.min(yvals)
        elif reference is None:
            ref = 0
        else:
            raise ParameterError(f"{reference} is not a valid value for 'reference'")

        return dict(
            plow=ylows - ref,
            phigh=yhighs - ref,
            median=ymedians - ref,
            values=yvals - ref,
        )

    def get_mc_data(self):
        """The stored MCMC chain data.

        Returns
        -------
        dict
            ``'samples'`` (decorrelated coefficient sets), ``'logposteriors'``,
            ``'mc_parameters'``, ``'acceptance_ratio'``, ``'nequil'``,
            ``'g_logposterior'``, ``'g_parameters'``, ``'g'``.

        Notes
        -----
        Requires :meth:`sample_parameter_distribution` first.  Reference:
        ``pymbar.FES.get_mc_data`` (pymbar 4.x fes.py:1928-1952).
        """
        if self.mc_data is None:
            raise DataError("No MC sampling has been done, cannot construct confidence intervals")
        return self.mc_data

    def _get_MC_loglikelihood(self, x_n, w_n, spline_weights, spline, xrange):
        """Minus-log-likelihood of a spline under the chosen weighting
        (reference fes.py:1954-2010)."""
        N = self.N
        K = self.K

        if spline_weights in ["simplesum", "biasedstates"]:
            loglikelihood = 0.0

            def splinek(x, kf):
                return spline(x) + self.spline_parameters["fkbias"][kf](x)

            def expk(x, kf):
                return np.exp(-splinek(x, kf))

            for k in range(K):
                x_kn = x_n[self.mbar.x_kindices == k]
                normalize = np.log(self._integrate(expk, xrange[0], xrange[1], args=(k,)))
                if spline_weights == "simplesum":
                    loglikelihood += (N / K) * np.mean(splinek(x_kn, k))
                    loglikelihood += (N / K) * normalize
                else:
                    loglikelihood += np.sum(splinek(x_kn, k))
                    loglikelihood += self.N_k[k] * normalize
        elif spline_weights == "unbiasedstate":
            loglikelihood = N * np.dot(w_n, spline(x_n))
        else:
            raise ParameterError(f"Unknown spline_weights {spline_weights}")

        return loglikelihood

    def _MC_step(self, x_n, w_n, stepsize, xrange, spline_weights, logprior):
        """One Metropolis step over a single random spline coefficient
        (reference fes.py:2012-2100)."""
        mc_data = self.mc_data
        bspline = mc_data["bspline"]

        if mc_data["first_step"]:
            c = bspline.c
            mc_data["previous_logposterior"] = self._get_MC_loglikelihood(
                x_n,
                w_n,
                self.spline_parameters["spline_weights"],
                bspline,
                self.spline_parameters["xrange"],
            ) - logprior(c)
            mc_data["first_step"] = False
            mc_data["newspline"] = BSpline(bspline.t, bspline.c.copy(), bspline.k)

        mc_data["cold"] = bspline.c
        psize = len(mc_data["cold"])
        rchange = stepsize * np.random.normal()
        cnew = mc_data["cold"].copy()
        ci = np.random.randint(psize)
        cnew[ci] += rchange
        mc_data["newspline"].c = cnew

        def prob(x):
            return np.exp(-mc_data["newspline"](x))

        new_integral = self._integrate(prob, xrange[0], xrange[1])
        cnew = cnew + np.log(new_integral)
        mc_data["newspline"].c = cnew

        loglikelihood = self._get_MC_loglikelihood(
            x_n, w_n, spline_weights, mc_data["newspline"], xrange
        )
        newlogposterior = loglikelihood - logprior(cnew)
        dlogposterior = newlogposterior - mc_data["previous_logposterior"]

        accept = dlogposterior <= 0
        if dlogposterior > 0 and np.random.random() < np.exp(-dlogposterior):
            accept = True

        if accept:
            mc_data["bspline"].c = mc_data["newspline"].c
            mc_data["cold"] = bspline.c
            mc_data["previous_logposterior"] = newlogposterior
            mc_data["naccept"] = mc_data["naccept"] + 1

        return dict(c=mc_data["bspline"].c, logposterior=mc_data["previous_logposterior"])

    # -------------------------------------------------------------------------
    # Spline objective / gradient / Hessian
    # -------------------------------------------------------------------------

    # -- likelihood internals, evaluated on the fixed Gauss-Legendre grid --
    #
    # The reference evaluates every integral with adaptive scipy.quad, one
    # call per basis function (gradient) and per banded basis PAIR per
    # state (Hessian) inside every Newton iteration — O(nspline^2 K)
    # quadratures each resolving the same smooth exp(-F - bias) integrand
    # (reference fes.py:2102-2428).  Here the basis matrix is evaluated
    # once on the grid (quad_B, built at setup) and each f/g/h call is a
    # handful of dense (nspline x P x K) matrix contractions; support
    # restrictions need no special-casing because the basis is exactly
    # zero outside its support.  Sample-side basis sums depend only on
    # (x_n, w_n) and are cached per fit.

    @staticmethod
    def _eval_on_grid(func, qx, args=()):
        """Evaluate a user callable on the grid, tolerating scalar-only
        functions.  The reference only ever calls these inside scipy.quad
        (one scalar x at a time, fes.py:2418-2428), so user-supplied bias
        functions need not vectorize — probe, validate the output shape,
        and fall back to a per-point loop (the grid is ~1e3 points)."""
        try:
            vals = np.asarray(func(qx, *args), dtype=np.float64)
            # A function that reduces over x (e.g. a multi-dim bias summing
            # "coordinates") can still broadcast back to the right shape;
            # spot-check one point against its scalar evaluation.
            v0 = float(func(qx[0], *args))
            if vals.shape == qx.shape and np.isclose(
                vals[0], v0, rtol=1e-10, atol=1e-300
            ):
                return vals
        except Exception:
            pass
        return np.array([float(func(x, *args)) for x in qx], dtype=np.float64)

    def _quad_bias(self):
        """Bias values (K, P) on the quadrature grid, computed once."""
        if "quad_bias" not in self.spline_data:
            fkbias = self.spline_parameters["fkbias"]
            qx = self.spline_data["quad_x"]
            self.spline_data["quad_bias"] = np.stack(
                [self._eval_on_grid(fkbias[k], qx) for k in range(self.mbar.K)],
                axis=0,
            )
        return self.spline_data["quad_bias"]

    def _spline_sample_sums(self, x_n, w_n):
        """Weighted basis-sample sums S (nspline,): f_sample = c_full . S
        and g_sample = S[1:].  Pure functions of (x_n, w_n, weighting mode)
        — computed once per fit and cached (the reference re-evaluates
        every basis spline over all N samples in every f and g call)."""
        mode = self.spline_parameters["spline_weights"]
        # The cache holds REFERENCES to the keyed arrays (not bare id()s):
        # CPython reuses freed addresses, so an id-only key can collide
        # across bootstrap replicates; keeping the arrays alive makes the
        # identity test sound.
        cache = getattr(self, "_spline_sums_cache", None)
        if (
            cache is not None
            and cache[0] is x_n
            and cache[1] is w_n
            and cache[2] == mode
        ):
            return cache[3]

        mbar = self.mbar
        K = mbar.K
        N = self.N
        nspline = self.spline_parameters["nspline"]
        db_c = self.spline_data["bspline_derivatives"]
        Bx = np.stack([db_c[i](x_n) for i in range(nspline)], axis=0)
        if mode == "simplesum":
            S = np.zeros(nspline)
            for k in range(K):
                S += (N / K) * Bx[:, mbar.x_kindices == k].mean(axis=1)
        elif mode == "biasedstates":
            S = Bx.sum(axis=1)
        elif mode == "unbiasedstate":
            S = N * (Bx @ np.asarray(w_n))
        else:
            raise ParameterError(f"Unknown spline_weights {mode}")
        self._spline_sums_cache = (x_n, w_n, mode, S)
        return S

    def _spline_quad_core(self, xi):
        """(c_full, E, pF, integral_scaling) at coefficients xi: the
        Boltzmann factors on the grid and their normalizers per state."""
        spline_weights = self.spline_parameters["spline_weights"]
        qw = self.spline_data["quad_w"]
        qB = self.spline_data["quad_B"]
        c_full = np.concatenate([[self.spline_data["bspline"].c[0]], xi])
        Fq = c_full @ qB  # (P,)

        if spline_weights in ("simplesum", "biasedstates"):
            E = np.exp(-Fq[None, :] - self._quad_bias())  # (K, P)
            pF = E @ qw  # (K,)
            if spline_weights == "simplesum":
                integral_scaling = (self.N / self.mbar.K) * np.ones(self.mbar.K)
            else:
                integral_scaling = np.asarray(self.mbar.N_k, dtype=np.float64)
        else:
            E = np.exp(-Fq)[None, :]  # (1, P)
            pF = E @ qw  # (1,)
            integral_scaling = None
        return c_full, E, pF, integral_scaling

    def _bspline_calculate_f(self, xi, x_n, w_n):
        """Minus log likelihood of the splined FES (reference fes.py:2102-2186).

        f = sum_n scale_n F(x_n) + sum_k scale_k ln int exp(-F - bias_k),
        with weighting per ``spline_weights``; MAP subtracts the log prior.
        """
        spline_weights = self.spline_parameters["spline_weights"]
        c_full, E, pF, integral_scaling = self._spline_quad_core(xi)
        S = self._spline_sample_sums(x_n, w_n)

        f = float(c_full @ S)
        if spline_weights in ("simplesum", "biasedstates"):
            f += float(np.dot(integral_scaling, np.log(pF)))
        else:
            f += float(self.N * np.log(pF[0]))

        logprior = self.spline_parameters["map_data"]["logprior"]
        if logprior is not None:
            f -= logprior(np.concatenate([[0], xi], axis=None))
        return f

    def _bspline_calculate_g(self, xi, x_n, w_n):
        """Gradient: basis sums over samples minus Boltzmann-weighted basis
        expectations (reference fes.py:2188-2306)."""
        spline_weights = self.spline_parameters["spline_weights"]
        qw = self.spline_data["quad_w"]
        qB = self.spline_data["quad_B"]
        c_full, E, pF, integral_scaling = self._spline_quad_core(xi)
        S = self._spline_sample_sums(x_n, w_n)

        g = S[1:].astype(np.float64, copy=True)
        Bw = qB[1:] * qw[None, :]  # (nspline-1, P)
        if spline_weights in ("simplesum", "biasedstates"):
            gkquad = (Bw @ E.T) / pF[None, :]  # (nspline-1, K)
            g -= gkquad @ integral_scaling
        else:
            g -= self.N * (Bw @ E[0]) / pF[0]

        dlogprior = self.spline_parameters["map_data"]["dlogprior"]
        if dlogprior is not None:
            g -= dlogprior(np.concatenate([[0], xi], axis=None))
        return g

    def _bspline_calculate_h(self, xi, x_n, w_n):
        """Hessian: second-moment basis integrals minus the outer product of
        the first moments (reference fes.py:2308-2416; banded |i-j| <= degree
        structure arises naturally — basis products vanish pointwise off the
        band, no special-casing needed)."""
        spline_weights = self.spline_parameters["spline_weights"]
        qw = self.spline_data["quad_w"]
        qB = self.spline_data["quad_B"]
        c_full, E, pF, integral_scaling = self._spline_quad_core(xi)

        B1 = qB[1:]  # (nspline-1, P)
        Bw = B1 * qw[None, :]
        if spline_weights in ("simplesum", "biasedstates"):
            gkquad = (Bw @ E.T) / pF[None, :]  # (nspline-1, K)
            h = -(gkquad * integral_scaling[None, :]) @ gkquad.T
            # sum_k (scale_k / pF_k) * int B_i B_j exp(-F - bias_k)
            Escaled = (integral_scaling / pF)[:, None] * E  # (K, P)
            h += (Bw * Escaled.sum(axis=0)[None, :]) @ B1.T
        else:
            pE = (Bw @ E[0]) / pF[0]
            h = -self.N * np.outer(pE, pE)
            h += (self.N / pF[0]) * (Bw * E[0][None, :]) @ B1.T

        ddlogprior = self.spline_parameters["map_data"]["ddlogprior"]
        if ddlogprior is not None:
            h -= ddlogprior(np.concatenate([[0], xi], axis=None))
        return h

    def _integrate(self, func, xlow, xhigh, args=(), method=None):
        """Integrate a smooth FES-type integrand over [xlow, xhigh].

        Defaults to the fixed composite Gauss-Legendre grid when one covers
        the requested interval (every caller integrates exp(-spline - bias)
        over the spline range); method="quad" forces the reference's
        adaptive scipy.quad (fes.py:2418-2428) — kept for cross-validation.
        """
        if method is None:
            sd = getattr(self, "spline_data", None) or {}
            qrange = sd.get("quad_range")
            if qrange is not None:
                lo, hi = qrange
                eps = 1e-12 * max(1.0, abs(hi - lo))
                if abs(xlow - lo) <= eps and abs(xhigh - hi) <= eps:
                    return float(
                        np.dot(
                            sd["quad_w"],
                            self._eval_on_grid(func, sd["quad_x"], args),
                        )
                    )
            method = "quad"
        if method == "quad":
            return quad(func, xlow, xhigh, args)[0]
        raise ParameterError(f"integration method {method} not yet implemented")

    def _val_to_spline(self, x, form=None):
        """Coefficients (c_0 pinned from the template) -> BSpline object
        (reference fes.py:2430-2456)."""
        template_bspline = self.spline_data["bspline"]
        xnew = np.zeros(len(x) + 1)
        xnew[0] = template_bspline.c[0]
        xnew[1:] = x
        bspline = BSpline(template_bspline.t, xnew, template_bspline.k)
        if form == "exp":
            return lambda xq: -np.log(bspline(xq))
        return bspline
