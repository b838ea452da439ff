"""The port's wsum_dd against the JAX package's, on the CPU.

On CPU tensors ``pymbar_tpu_torch.ops.wsum.wsum_dd`` runs its plain PyTorch
version; the CUDA kernel itself is held against that version on the card
(tests/test_torch_wsum_cuda.py and chip_smoke.py).  Inputs are float32 dd
planes made with numpy from a seed and handed to both packages.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pymbar_tpu.ops import pallas_kernels as pk
from pymbar_tpu_torch.ops import wsum as tw

# one intra-op thread per test process: the suite's workers share the CPUs
torch.set_num_threads(1)


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
    "K,N,counts",
    [(32, 1000, False), (32, 1000, True), (5, 37, False), (1, 64, False),
     # either side of the card kernel's cluster sizes (512 rows a block),
     # where the card tests hold the kernel against this plain version
     (512, 40, False), (513, 40, True), (1000, 31, True), (1024, 16, False), (1025, 33, True),
     (2048, 12, True), (2500, 9, False), (3000, 7, True), (4096, 9, True),
     # above the split-route gate: the plain many-state route
     (4097, 9, False)],
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
        ("f64_counts", TypeError),
        ("g_lo_length", ValueError),
        ("empty_planes", ValueError),
        ("one_d_planes", ValueError),
        ("counts_on_another_device", ValueError),
        ("non_contiguous_g", ValueError),
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
    elif bad == "f64_counts":
        args["c"] = c.double()
    elif bad == "g_lo_length":
        args["g_lo"] = gl[:3]
    elif bad == "empty_planes":
        args["u_hi"], args["u_lo"] = uh[:, :0].contiguous(), ul[:, :0].contiguous()
    elif bad == "one_d_planes":
        args["u_hi"], args["u_lo"] = uh[0].contiguous(), ul[0].contiguous()
    elif bad == "counts_on_another_device":
        args["c"] = c.to("meta")
    elif bad == "non_contiguous_g":
        args["g_hi"] = torch.stack([gh, gh], 1)[:, 0]
    with pytest.raises(error):
        tw.wsum_dd(**args)


_CSRC = Path(tw.__file__).parent.parent / "csrc"


def _constexprs(*headers):
    """The integer constexprs of csrc headers, evaluated in order from the
    source (``/`` of the source is integer division on these positive
    values)."""
    env = {}
    for name in headers:
        src = re.sub(r"//[^\n]*", "", (_CSRC / name).read_text())
        for key, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", src, re.M):
            env[key] = eval(f"({expr})".replace("/", "//"), {}, env)
    return env


def test_fused_plan_fits_the_card():
    """K1's block (csrc/wsum_fused.cuh, read from the source) within the
    H100's 227 KB of shared memory per block, and its largest cluster
    holds every K wsum_dd sends it and the 8192-state slice."""
    c = _constexprs("wsum_rows.cuh", "wsum_fused.cuh")
    assert c["kFusedSmemBytes"] <= 232448
    assert c["kFusedRows"] * c["kFusedMaxCluster"] >= max(tw._SPLIT_ROUTE_K, 8192)
    assert c["kFusedMaxCluster"] <= 16  # the H100's largest cluster


def _exp_tab(x, consts):
    """csrc/wsum_rows.cuh's exp_tab step by step, each fma in extended
    precision (np.longdouble) and rounded once to f64, as on the card."""
    L = np.longdouble

    def fma(a, b, c):
        return float(L(a) * L(b) + L(c))

    shifter = 6755399441055744.0
    x = -1400.0 if x < -1400.0 else (800.0 if x > 800.0 else x)
    t = fma(x, consts["kInvLn2x64"], shifter)
    n = int(np.array([t]).view(np.int64)[0] & 0xFFFFFFFF)
    n = n - 2**32 if n >= 2**31 else n
    kf = t - shifter
    r = fma(kf, -consts["kLn2d64Hi"], x)
    r = fma(kf, -consts["kLn2d64Lo"], r)
    q = fma(r, 1.0 / 120.0, 1.0 / 24.0)
    for c in (1.0 / 6.0, 0.5, 1.0):
        q = fma(r, q, c)
    q = r * q
    tj = float(np.exp2(L(n & 63) / 64))
    p = fma(tj, q, tj)
    k = n >> 6
    return p * 2.0 ** (k >> 1) * 2.0 ** (k - (k >> 1))


def test_exp_tab_algorithm_within_an_ulp():
    """The kernels' branch-free exp (its constants read from the source)
    within an ulp of exp over the range the weight sums meet, 0 below
    underflow and inf above overflow, as exp."""
    src = (_CSRC / "wsum_rows.cuh").read_text()
    consts = {name: float(re.search(rf"{name} = ([0-9.e+-]+);", src).group(1))
              for name in ("kInvLn2x64", "kLn2d64Hi", "kLn2d64Lo")}
    rng = np.random.default_rng(7)
    xs = np.concatenate([rng.uniform(-40.0, 1.0, 1500), rng.uniform(-700.0, 700.0, 500),
                         [0.0, -1e-300, 1e-17, -0.0054, -0.0055, 709.7, -708.3]])
    err = max(abs(_exp_tab(x, consts) - float(np.exp(np.longdouble(x)))) / float(
        np.exp(np.longdouble(x))) for x in xs)
    assert err <= np.finfo(np.float64).eps
    assert _exp_tab(-1.0e300, consts) == 0.0 and _exp_tab(-np.inf, consts) == 0.0
    assert _exp_tab(750.0, consts) == np.inf
