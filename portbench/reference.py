"""The plain reference that decides ``correct``: MBAR in plain PyTorch.

It follows the published equations (Shirts & Chodera 2008; pymbar 4.x,
``mbar.py`` and ``mbar_solvers.py``) and nothing of the program: it imports
no module of ``pymbar_tpu_torch``, ``pymbar_tpu`` or JAX, and takes no
number that the program made.  It works on the same u_kn that the benchmark
hands to the program, in column chunks on u_kn's device, in the dtype it is
given: float64 for the reference, float32 for the control (the nearest
precision below the configuration's float64).

* :func:`solve` -- the free energies f_k (f_0 = 0) by Newton's method on
  the convex MBAR objective
  F(f) = sum_n c_n ln sum_k N_k exp(f_k - u_kn) - sum_k N_k f_k,
  c_n = 1, or a bootstrap replicate's multiplicities;
* :func:`sigma_svd_ew` -- the asymptotic uncertainties of f_j - f_i from
  Theta by pymbar's 'svd-ew' form (Eq. D4: eigh of W^T W, the inner
  pseudoinverse cut at 1e-10 of its largest singular value);
* :func:`sigma_bootstrap` -- the standard deviation of f_j - f_i over
  bootstrap replicates, each solved on its multiplicities from the solution.
"""

import numpy as np
import torch

__all__ = ["solve", "sigma_svd_ew", "sigma_bootstrap", "differences"]

# Elements per column chunk: 2**26 (512 MB in float64).
_CHUNK_ELEMS = 2**26
# Far from the solution a Newton step is damped by halving until F falls
# by at least this share of its predicted decrease.
_ARMIJO = 1.0e-4
# Steps longer than this (in max |step|) are line-searched; shorter ones lie
# in Newton's quadratic region, where F's rounding would hide the decrease.
_SEARCH_ABOVE = 1.0e-3
_PINV_RCOND = 1.0e-10
_NEG_D2_CUTOFF = 1.0e-10


def _pass(u, log_N, f, c, dtype, gram):
    """One pass over u_kn's column chunks at f: (sum_n c_n ln D_n, S, G) with
    w_kn = N_k exp(f_k - u_kn) / D_n, S_k = sum_n c_n w_kn and, when
    ``gram``, G = sum_n c_n w_n w_n^T (else None)."""
    K, N = u.shape
    shift = f + log_N
    obj = torch.zeros((), dtype=dtype, device=u.device)
    S = torch.zeros(K, dtype=dtype, device=u.device)
    G = torch.zeros((K, K), dtype=dtype, device=u.device) if gram else None
    width = max(1, _CHUNK_ELEMS // K)
    for s in range(0, N, width):
        e = min(N, s + width)
        w = shift[:, None] - u[:, s:e].to(dtype)
        m = w.amax(dim=0)
        w.sub_(m).exp_()
        d = w.sum(dim=0)
        log_d = m + d.log()
        w.div_(d)
        if c is None:
            obj += log_d.sum()
            wc = w
        else:
            cc = c[s:e]
            obj += (cc * log_d).sum()
            wc = w * cc
        S += wc.sum(dim=1)
        if gram:
            G.addmm_(wc, w.T)
        del w, wc
    return obj, S, G


def solve(u_kn, N_k, counts=None, f_init=None, dtype=torch.float64, maxiter=40):
    """f_k - f_0 (float64 numpy) solving the MBAR equations on ``u_kn`` (a
    (K, N) tensor) with every state sampled, computed in ``dtype``.

    ``counts`` (N,) weights each sample (a bootstrap replicate's
    multiplicities); ``f_init`` is the starting point (default zeros).  The
    iteration stops when a full step is below 64 ulps of f, or when steps
    stop shrinking near the solution (the dtype's noise floor).
    Returns (f, iterations)."""
    K, N = u_kn.shape
    dev = u_kn.device
    N_k = torch.as_tensor(np.asarray(N_k, dtype=np.float64), dtype=dtype, device=dev)
    log_N = N_k.log()
    c = None if counts is None else torch.as_tensor(np.asarray(counts), device=dev).to(dtype)
    f = torch.zeros(K, dtype=dtype, device=dev)
    if f_init is not None:
        f = torch.as_tensor(np.asarray(f_init, dtype=np.float64), device=dev).to(dtype)
        f = f - f[0]
    tol = 64 * torch.finfo(dtype).eps
    last = np.inf
    it = 0
    with _no_tf32():
        for it in range(1, maxiter + 1):
            obj, S, G = _pass(u_kn, log_N, f, c, dtype, gram=True)
            g = (S - N_k)[1:]
            H = torch.diag(S)[1:, 1:] - G[1:, 1:]
            del G
            step = -torch.linalg.solve(H, g)
            size = float(step.abs().max())
            t = 1.0
            if size > _SEARCH_ABOVE:
                F0 = float(obj - N_k @ f)
                decrease = float(-(g @ step))
                while t > 1.0e-6:
                    trial = f.clone()
                    trial[1:] += t * step
                    obj_t = _pass(u_kn, log_N, trial, c, dtype, gram=False)[0]
                    if float(obj_t - N_k @ trial) <= F0 - _ARMIJO * t * decrease:
                        break
                    t *= 0.5
            f[1:] += t * step
            scale = max(1.0, float(f.abs().max()))
            if t == 1.0 and (size <= tol * scale or (size < _SEARCH_ABOVE and size >= last)):
                break
            last = size if t == 1.0 else np.inf
    return f.to(torch.float64).cpu().numpy(), it


def differences(f):
    """Delta_f[i, j] = f_j - f_i of a (K,) array."""
    f = np.asarray(f, dtype=np.float64)
    return f[None, :] - f[:, None]


def _d2_to_sigma(d2):
    """sqrt of squared uncertainties, tiny negatives (above -1e-10) set to 0
    as pymbar's ``_ErrorOfDifferences`` does; larger negatives give NaN."""
    d2 = torch.where((d2 < 0) & (d2 > -_NEG_D2_CUTOFF), torch.zeros_like(d2), d2)
    return torch.sqrt(d2)


def sigma_svd_ew(u_kn, N_k, f, dtype=torch.float64):
    """(K, K) float64 numpy: the 'svd-ew' uncertainty of f_j - f_i at the
    solution ``f``, computed in ``dtype``."""
    K, N = u_kn.shape
    dev = u_kn.device
    N_k = torch.as_tensor(np.asarray(N_k, dtype=np.float64), dtype=dtype, device=dev)
    f_t = torch.as_tensor(np.asarray(f, dtype=np.float64), device=dev).to(dtype)
    with _no_tf32():
        _obj, _S, G = _pass(u_kn, N_k.log(), f_t, None, dtype, gram=True)
        gram_w = G / (N_k[:, None] * N_k[None, :])  # W^T W, W_nk = w_kn / N_k
        del G
        s2, V = torch.linalg.eigh(gram_w)
        VS = V * s2.clamp(min=0).sqrt()[None, :]
        inner = torch.eye(K, dtype=dtype, device=dev) - VS.T @ (N_k[:, None] * VS)
        lam, P = torch.linalg.eigh(inner)
        keep = lam.abs() > _PINV_RCOND * lam.abs().max()
        inv = torch.where(keep, 1.0 / torch.where(keep, lam, torch.ones_like(lam)), 0.0)
        theta = VS @ ((P * inv[None, :]) @ P.T) @ VS.T
        diag = theta.diagonal()
        d2 = diag[:, None] + diag[None, :] - 2.0 * theta
    return _d2_to_sigma(d2).to(torch.float64).cpu().numpy()


def sigma_bootstrap(u_kn, N_k, f, counts, dtype=torch.float64, maxiter=40):
    """(K, K) float64 numpy: the standard deviation (ddof 0) of f_j - f_i
    over the replicates whose per-sample multiplicities are the rows of
    ``counts`` ((B, N)), each solved from the solution ``f`` in ``dtype``.
    Also returns the replicates' (B, K) f and the iterations taken.

    A replicate's solution is f + delta_b.  Its weights are exactly
    w_b,kn = e^delta_bk w_kn / sum_j e^delta_bj w_jn with w the weights at
    ``f``, so every replicate iterates on the one (K, N) matrix w: all B
    gradients S_b - N_k come from two matrix products a step.  Each
    replicate steps by Newton's method with its own Hessian at delta = 0,
    diag(S_b) - sum_n c_bn w_n w_n^T, held for the later steps (which then
    contract by ~|delta|).  The steps stop when the largest is below 64
    ulps, or stops shrinking near the solution (the dtype's noise floor)."""
    K, N = u_kn.shape
    dev = u_kn.device
    N_k = torch.as_tensor(np.asarray(N_k, dtype=np.float64), dtype=dtype, device=dev)
    f_t = torch.as_tensor(np.asarray(f, dtype=np.float64), device=dev).to(dtype)
    C = torch.as_tensor(np.asarray(counts), device=dev).to(dtype)
    B = C.shape[0]
    shift = f_t + N_k.log()
    w = torch.empty((K, N), dtype=dtype, device=dev)
    gram = torch.zeros((B, K, K), dtype=dtype, device=dev)
    width = max(1, _CHUNK_ELEMS // K)
    with _no_tf32():
        for s in range(0, N, width):
            e = min(N, s + width)
            w_c = torch.softmax(shift[:, None] - u_kn[:, s:e].to(dtype), dim=0)
            w[:, s:e] = w_c
            for b in range(B):
                gram[b].addmm_(w_c * C[b, s:e], w_c.T)
            del w_c
        S0 = C @ w.T
        H = torch.diag_embed(S0) - gram
        del gram
        L = torch.linalg.cholesky(H[:, 1:, 1:])
        del H
        delta = torch.zeros((B, K), dtype=dtype, device=dev)
        tol = 64 * torch.finfo(dtype).eps
        last = np.inf
        it = 0
        for it in range(1, maxiter + 1):
            e = delta.exp()
            S = e * ((C / (e @ w)) @ w.T)
            step = -torch.cholesky_solve((S - N_k)[:, 1:, None], L)[..., 0]
            delta[:, 1:] += step
            size = float(step.abs().max())
            if size <= tol * max(1.0, float(delta.abs().max())) or (size < 1e-6 and size >= last):
                break
            last = size
        del w, L
        f_boots = f_t[None, :] + delta
        f_boots = f_boots - f_boots[:, :1]
        spread = (f_boots[:, None, :] - f_boots[:, :, None]).std(dim=0, unbiased=False)
    return spread.to(torch.float64).cpu().numpy(), f_boots.to(torch.float64).cpu().numpy(), it


class _no_tf32:
    """Keep float32 matrix products in float32 (no TF32) inside the block."""

    def __enter__(self):
        self.saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.saved
