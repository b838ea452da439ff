"""The port's wsum_dd against the JAX package's, on the CPU.

On CPU tensors ``pymbar_tpu_torch.ops.wsum.wsum_dd`` runs its plain PyTorch
version; the CUDA kernel itself is held against that version on the card
(tests/test_torch_wsum_cuda.py and chip_smoke.py).  Inputs are float32 dd
planes made with numpy from a seed and handed to both packages.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pymbar_tpu.ops import pallas_kernels as pk
from pymbar_tpu_torch.ops import wsum as tw


def _planes(K, N, seed, counts=False):
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.0, 10.0, (K, N))
    u -= u.min(axis=0, keepdims=True)  # preconditioned: column min 0
    g = rng.normal(0.0, 0.5, K) + np.log(N / K)
    uh = u.astype(np.float32)
    ul = (u - uh.astype(np.float64)).astype(np.float32)
    gh = g.astype(np.float32)
    gl = (g - gh.astype(np.float64)).astype(np.float32)
    c = rng.integers(0, 4, N).astype(np.float32) if counts else None
    return uh, ul, gh, gl, c


def _torch_S(uh, ul, gh, gl, c=None):
    t = [torch.from_numpy(a) for a in (uh, ul, gh, gl)]
    Sh, Sl = tw.wsum_dd(*t, None if c is None else torch.from_numpy(c))
    return Sh.double().numpy() + Sl.double().numpy()


def _jax_S(fn, uh, ul, gh, gl, c=None, **kw):
    j = [jnp.asarray(a) for a in (uh, ul, gh, gl)]
    Sh, Sl = fn(*j, c=None if c is None else jnp.asarray(c), **kw)
    return np.asarray(Sh, np.float64) + np.asarray(Sl, np.float64)


@pytest.mark.parametrize(
    "K,N,counts", [(32, 1000, False), (32, 1000, True), (5, 37, False), (1, 64, False)]
)
def test_plain_matches_jax_f64_reference(K, N, counts):
    """Both sides compute in true f64 inside, so 1e-13 relative holds."""
    uh, ul, gh, gl, c = _planes(K, N, seed=K * 1000 + N, counts=counts)
    S = _torch_S(uh, ul, gh, gl, c)
    S_ref = _jax_S(pk.wsum_dd_ref, uh, ul, gh, gl, c)
    assert np.max(np.abs(S - S_ref) / np.abs(S_ref)) <= 1e-13


@pytest.mark.parametrize("counts", [False, True])
def test_plain_matches_pallas_interpret(counts):
    """The Pallas kernel's dd exp is capped at ~1.4e-11 relative on XLA:CPU
    (docs/numerics.md:41-44), hence 1e-10."""
    uh, ul, gh, gl, c = _planes(8, 256, seed=3, counts=counts)
    S = _torch_S(uh, ul, gh, gl, c)
    S_pl = _jax_S(pk.wsum_dd, uh, ul, gh, gl, c, interpret=True)
    assert np.max(np.abs(S - S_pl) / np.abs(S_pl)) <= 1e-10


def test_pad_columns_add_zero():
    """Sentinel pad columns (every row +1e10) contribute nothing, and a
    matrix of pad columns only gives S == 0 exactly."""
    uh, ul, gh, gl, _ = _planes(4, 100, seed=7)
    S0 = _torch_S(uh, ul, gh, gl)
    pad = 12
    uhp = np.pad(uh, ((0, 0), (0, pad)), constant_values=np.float32(pk._PAD_U))
    ulp = np.pad(ul, ((0, 0), (0, pad)))
    S1 = _torch_S(uhp, ulp, gh, gl)
    assert np.max(np.abs(S1 - S0) / S0) <= 1e-15
    only = np.full((4, pad), np.float32(pk._PAD_U))
    assert np.all(_torch_S(only, np.zeros_like(only), gh, gl) == 0.0)


def test_high_energy_real_sample_still_counts():
    """A real sample that one state assigns clash-level energy keeps its
    weight in the other states: only all-row sentinels are padding."""
    rng = np.random.default_rng(11)
    K, N = 3, 64
    u = rng.uniform(0.0, 5.0, (K, N))
    u -= u.min(axis=0, keepdims=True)
    u[0, 5] = 6.0e9
    u[1, 5] = 0.0
    u[2, 5] = 1.3
    g = np.array([0.0, 0.1, -0.2]) + np.log(N / K)
    uh = u.astype(np.float32)
    ul = (u - uh.astype(np.float64)).astype(np.float32)
    gh = g.astype(np.float32)
    gl = (g - gh.astype(np.float64)).astype(np.float32)
    S = _torch_S(uh, ul, gh, gl)

    a = g[:, None] - u
    w = np.exp(a - a.max(axis=0)) / np.exp(a - a.max(axis=0)).sum(axis=0)
    assert np.max(np.abs(S - w.sum(axis=1))) < 1e-10
    assert w[1:, 5].sum() > 0.99
    np.testing.assert_allclose(S, _jax_S(pk.wsum_dd_ref, uh, ul, gh, gl), rtol=1e-13)


def test_plain_streams_over_column_chunks(monkeypatch):
    """A chunk budget far below the matrix gives the same S."""
    uh, ul, gh, gl, c = _planes(16, 2000, seed=5, counts=True)
    S_one = _torch_S(uh, ul, gh, gl, c)
    monkeypatch.setattr(tw, "_CHUNK_BYTES", 16 * 8 * 300)
    S_many = _torch_S(uh, ul, gh, gl, c)
    assert np.max(np.abs(S_many - S_one) / S_one) <= 1e-14


def test_cpu_tensors_run_the_plain_version_without_launching():
    uh, ul, gh, gl, _ = _planes(4, 50, seed=1)
    before = tw.WSUM_LAUNCHES
    _torch_S(uh, ul, gh, gl)
    assert tw.WSUM_LAUNCHES == before


@pytest.mark.parametrize(
    "bad,error",
    [
        ("f64_planes", TypeError),
        ("numpy_planes", TypeError),
        ("shape_mismatch", ValueError),
        ("g_length", ValueError),
        ("c_length", ValueError),
        ("non_contiguous", ValueError),
        ("meta_device", ValueError),
    ],
)
def test_wrapper_rejects_what_it_cannot_take(bad, error):
    uh, ul, gh, gl, c = (
        torch.from_numpy(a) for a in _planes(4, 50, seed=2, counts=True)
    )
    args = dict(u_hi=uh, u_lo=ul, g_hi=gh, g_lo=gl, c=None)
    if bad == "f64_planes":
        args["u_hi"] = uh.double()
    elif bad == "numpy_planes":
        args["u_lo"] = ul.numpy()
    elif bad == "shape_mismatch":
        args["u_lo"] = ul[:, :10].contiguous()
    elif bad == "g_length":
        args["g_hi"] = gh[:3]
    elif bad == "c_length":
        args["c"] = c[:10]
    elif bad == "non_contiguous":
        args["u_hi"] = uh.T.contiguous().T
    elif bad == "meta_device":
        args = {k: (None if v is None else v.to("meta")) for k, v in args.items()}
    with pytest.raises(error):
        tw.wsum_dd(**args)
