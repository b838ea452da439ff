"""Weighted Gaussian kernel density estimation on a torch device.

The counterpart of :mod:`pymbar_tpu.kde`: a stand-in for the sklearn
``KernelDensity`` surface the reference FES uses (pymbar 4.x
fes.py:620-699, :1523-1609): ``fit(X, sample_weight)``,
``score_samples(X)`` (log density), ``score``, ``sample()``,
``get_params``/``set_params`` with the same parameter names (unknown names
raise, and only the Gaussian kernel is implemented).

The density is  p(x) = sum_n w_n N(x; x_n, h^2 I)  with normalized weights.
``fit`` keeps the centred samples and log w as float64 tensors on
``device`` (default: the CUDA card; without one, pass ``device="cpu"``);
``score_samples`` evaluates one max-shifted logsumexp over (queries x
samples) there, chunked over queries so the working set stays bounded.
"""

import numpy as np
import torch

from pymbar_tpu_torch.solvers import target_device

__all__ = ["GaussianKDE"]

_DEFAULT_PARAMS = dict(
    algorithm="auto",
    atol=0,
    bandwidth=1.0,
    breadth_first=True,
    kernel="gaussian",
    leaf_size=40,
    metric="euclidean",
    metric_params=None,
    rtol=0,
)


# Device-memory budget for one query chunk's (Q_chunk, N) working set: the
# evaluation keeps two float64 (Q_chunk, N) buffers live, so a chunk holds
# budget / (16 N) queries.  The JAX package's value, set for TPU memory; not
# yet measured on the card.
_PAIRWISE_BUDGET_BYTES = 1 << 31


def _query_chunk(Q, N):
    return int(max(16, min(Q, _PAIRWISE_BUDGET_BYTES // max(1, 16 * N))))


def _log_density(xq, xs, log_w, inv_h2):
    """log sum_n exp(log_w_n - ||xq - xs_n||^2 * inv_h2 / 2); (Q,D),(N,D)->(Q,).

    Squared distances come from the Gram expansion ||q||^2 + ||s||^2 - 2 q.s:
    the (Q, N) cross term is one float64 matmul (float64 products: no TF32)
    and no (Q, N, D) tensor exists.  Callers centre the data (``fit``
    subtracts the sample mean), so the expansion's cancellation error stays
    ~eps * var(x).  Two (Q, N) buffers live, updated in place.
    """
    qq = torch.sum(xq * xq, dim=1)[:, None]
    ss = torch.sum(xs * xs, dim=1)[None, :]
    cross = torch.matmul(xq, xs.T)
    a = torch.add(qq, ss).sub_(cross.mul_(2.0)).clamp_min_(0.0)
    del cross
    a.mul_(0.5 * inv_h2).neg_().add_(log_w[None, :])  # log_w - inv_h2 / 2 * d2
    m = torch.amax(a, dim=1)
    m = torch.where(torch.isfinite(m), m, 0.0)
    return torch.log(a.sub_(m[:, None]).exp_().sum(dim=1)) + m


class GaussianKDE:
    """Weighted Gaussian KDE with the sklearn KernelDensity parameter surface.

    ``device``: where ``fit`` places the samples (default: the CUDA card;
    ``"cpu"`` runs on the CPU).  It is not one of the estimator's
    parameters: ``get_params`` does not list it.
    """

    def __init__(self, device=None, **params):
        self._params = dict(_DEFAULT_PARAMS)
        self.set_params(**params)
        self.device = device
        self._X = None
        self._log_w = None

    def get_params(self, deep=True):
        return dict(self._params)

    def set_params(self, **params):
        for k, v in params.items():
            if k not in _DEFAULT_PARAMS:
                raise ValueError(f"Invalid parameter {k} for estimator KernelDensity.")
            self._params[k] = v
        if self._params["kernel"] != "gaussian":
            raise ValueError(
                f"kernel={self._params['kernel']!r} is not supported; only "
                "'gaussian' is implemented in the weighted KDE."
            )
        return self

    def fit(self, X, y=None, sample_weight=None):
        X = np.asarray(X, dtype=np.float64)
        if X.ndim == 1:
            X = X.reshape(-1, 1)
        if sample_weight is None:
            w = np.full(X.shape[0], 1.0 / X.shape[0])
        else:
            w = np.asarray(sample_weight, dtype=np.float64)
            if np.any(w < 0):
                raise ValueError("sample_weight must be non-negative")
            w = w / np.sum(w)
        dev = target_device(self.device)
        # Centre on the sample mean: the Gram-expansion distance of
        # _log_density is exact up to ~eps * ||x||^2, so coordinates near
        # the origin pin its cancellation error at ~eps * var(x).
        self._center = X.mean(axis=0)
        self._X = torch.as_tensor(X - self._center, device=dev)
        with np.errstate(divide="ignore"):
            self._log_w = torch.as_tensor(np.log(w), device=dev)
        return self

    def _fitted(self):
        if self._X is None:
            raise ValueError("This KernelDensity instance is not fitted yet.")

    @property
    def n_features_in_(self):
        """The dimension D of the fitted samples."""
        self._fitted()
        return self._X.shape[1]

    def score_samples(self, X):
        """Log density at query points X, shape (Q, D) -> (Q,), as numpy."""
        self._fitted()
        X = np.asarray(X, dtype=np.float64)
        if X.ndim == 1:
            X = X.reshape(-1, 1)
        h = float(self._params["bandwidth"])
        D = self._X.shape[1]
        log_norm = -D * np.log(h * np.sqrt(2.0 * np.pi))

        N = self._X.shape[0]
        chunk = _query_chunk(X.shape[0], N)
        Xq = torch.as_tensor(X - self._center, device=self._X.device)
        out = torch.cat([
            _log_density(Xq[s : s + chunk], self._X, self._log_w, 1.0 / h**2)
            for s in range(0, X.shape[0], chunk)
        ])
        return out.cpu().numpy() + log_norm

    def score(self, X, y=None):
        return float(np.sum(self.score_samples(X)))

    def sample(self, n_samples=1, random_state=None):
        """Draw samples from the fitted density (host numpy, with
        ``default_rng(random_state)``: the JAX package's draws)."""
        self._fitted()
        rng = np.random.default_rng(random_state)
        X = self._X.cpu().numpy() + self._center
        w = np.exp(self._log_w.cpu().numpy())
        idx = rng.choice(X.shape[0], size=n_samples, p=w / w.sum())
        h = float(self._params["bandwidth"])
        return X[idx] + rng.normal(scale=h, size=(n_samples, X.shape[1]))
