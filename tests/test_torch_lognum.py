"""The port's lognum family (K6 logden_dd, K7 lognum_dd, K5 lognum_fused_dd)
against the JAX package's, on the CPU.

On CPU tensors the wrappers of ``pymbar_tpu_torch.ops.lognum`` run their
plain PyTorch versions; the CUDA kernels themselves are held against those
on the card (tests/test_torch_lognum_cuda.py and chip_smoke.py).  Inputs
are float32 dd planes made with numpy from a seed and handed to both
packages.  Tolerances: 1e-11 absolute on the logs against the JAX
references and the Pallas kernels in interpret mode (double-word math
there, ~1e-13 of |log|), 1e-12 against scipy's f64 logsumexp (both f64
inside), relative 1e-13 between sums of the port itself.  A sentinel
column's log-denominator sits near -1e10, where f64 holds ~2e-6: it is
compared relative to its size.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.special import logsumexp

import jax.numpy as jnp

from pymbar_tpu.ops import pallas_kernels as pk
from pymbar_tpu_torch.ops import lognum as tl
from pymbar_tpu_torch.ops import wsum as tw

# one intra-op thread per test process: the suite's workers share the CPUs
torch.set_num_threads(1)

PAD = np.float32(pk._PAD_U)


def _planes(K, N, seed, pad_cols=0):
    """Shifted dd planes, g = f + ln N_k, the f64 truth (ld, ln) and the
    f32 shift m_k = max_n (-ld - u), as tests/test_sharding.py:348-357;
    ``pad_cols`` sentinel columns appended to the planes."""
    rng = np.random.default_rng(seed)
    u64 = rng.normal(0, 3, (K, N)) + rng.normal(0, 2, (1, N))
    u64 -= u64.min()
    g64 = rng.normal(0, 1, K) + np.log(N / K)
    ld64 = logsumexp(g64[:, None] - u64, axis=0)
    ln64 = logsumexp(-ld64[None, :] - u64, axis=1)
    m_k = np.max(-ld64[None, :] - u64, axis=1).astype(np.float32)
    uh = u64.astype(np.float32)
    ul = (u64 - uh).astype(np.float32)
    if pad_cols:
        uh = np.pad(uh, ((0, 0), (0, pad_cols)), constant_values=PAD)
        ul = np.pad(ul, ((0, 0), (0, pad_cols)))
    gh = g64.astype(np.float32)
    gl = (g64 - gh).astype(np.float32)
    return dict(uh=uh, ul=ul, gh=gh, gl=gl, m_k=m_k, ld64=ld64, ln64=ln64)


def _f64(pair):
    hi, lo = pair
    if torch.is_tensor(hi):
        hi, lo = hi.numpy(), lo.numpy()
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _log_err(a, b):
    """|a - b|, relative for the sentinel-sized logs (|b| > 1)."""
    return np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0))


def _run(kernel, p, port=True, **kw):
    """One kernel of the family on p's planes, by the port or by JAX (kw
    goes to the JAX call); K7 takes JAX's reference ld, the same pair for
    both packages."""
    args = dict(
        logden_dd=("uh", "ul", "gh", "gl"),
        lognum_dd=("uh", "ul", "ldh", "ldl", "m_k"),
        lognum_fused_dd=("uh", "ul", "gh", "gl", "m_k"),
    )[kernel]
    if kernel == "lognum_dd" and "ldh" not in p:
        p["ldh"], p["ldl"] = (np.asarray(x) for x in pk.logden_dd_ref(*_j(p["uh"], p["ul"], p["gh"], p["gl"])))
    vals = [p[a] for a in args]
    if port:
        return _f64(getattr(tl, kernel)(*_t(*vals)))
    return _f64(getattr(pk, kernel)(*_j(*vals), **kw))


KERNELS = ["logden_dd", "lognum_dd", "lognum_fused_dd"]


@pytest.mark.parametrize("shape", [(5, 1003), (3, 130), (16, 600)])
@pytest.mark.parametrize("kernel", KERNELS)
def test_plain_matches_jax_reference(kernel, shape):
    """With sentinel columns, except for K7, whose phantom terms f64 holds
    only to ~1e-6 (test_pad_rules_k5_masks_k7_does_not)."""
    p = _planes(*shape, seed=sum(shape), pad_cols=0 if kernel == "lognum_dd" else 7)
    ref = {
        "logden_dd": lambda: _f64(pk.logden_dd_ref(*_j(p["uh"], p["ul"], p["gh"], p["gl"]))),
        "lognum_dd": lambda: _f64(pk.lognum_dd_ref(*_j(p["uh"], p["ul"], p["ldh"], p["ldl"], p["m_k"]))),
        "lognum_fused_dd": lambda: _f64(pk.lognum_fused_dd_ref(
            *_j(p["uh"], p["ul"], p["gh"], p["gl"], p["m_k"]))),
    }
    ours = _run(kernel, p)
    assert _log_err(ours, ref[kernel]()) <= 1e-11


def _far_row(kind):
    """(5, 1003) planes with 7 sentinel columns (the shape of the K5 case
    above, so JAX's jit cache holds it) where row 2 is one that K5's
    single-read kernel cannot factorize: its g lowered by 750 below the
    others ("lowered") or the -1e10 sentinel over real u ("clash"), with
    m_2 its own lognum from the plain twin, so that s_2 ~ 1 while every
    exp(a_2n - m_n) underflows (to 0 or below f64's normal range).  Returns
    the planes with the scipy truth."""
    p = _planes(5, 1003, seed=1008, pad_cols=7)
    g = p["gh"].astype(np.float64) + p["gl"]
    g[2] = g[2] - 750.0 if kind == "lowered" else -1.0e10
    p["gh"] = g.astype(np.float32)
    p["gl"] = (g - p["gh"]).astype(np.float32)
    g = p["gh"].astype(np.float64) + p["gl"]
    u = (p["uh"].astype(np.float64) + p["ul"])[:, :1003]
    m_n = np.max(p["gh"][:, None] - p["uh"][:, :1003], axis=0).astype(np.float64)
    assert np.all(np.exp(g[2] - u[2] - m_n) < np.finfo(np.float64).tiny)
    p["m_k"][2] = _f64(tl.lognum_fused_dd(*_t(p["uh"], p["ul"], p["gh"], p["gl"], p["m_k"])))[2]
    ld64 = logsumexp(g[:, None] - u, axis=0)
    p["ln64"] = logsumexp(-ld64[None, :] - u, axis=1)
    return p


@pytest.mark.parametrize("kind", ["lowered", "clash"])
def test_plain_holds_rows_the_fused_kernel_takes_directly(kind):
    """The contract K5's kernel meets on the card in its direct form
    (tests/test_torch_lognum_cuda.py), pinned on the plain twin: its logs
    against JAX's lognum_fused_dd_ref (1e-11) and scipy's f64 logsumexp
    (1e-12), and s_2 ~ 1."""
    p = _far_row(kind)
    args = (p["uh"], p["ul"], p["gh"], p["gl"], p["m_k"])
    ln = _f64(tl.lognum_fused_dd(*_t(*args)))
    assert _log_err(ln, _f64(pk.lognum_fused_dd_ref(*_j(*args)))) <= 1e-11
    assert np.max(np.abs(ln - p["ln64"])) <= 1e-12
    assert abs(_f64(tl.lognum_fused_dd(*_t(*args), return_sums=True))[2] - 1.0) <= 1e-5


_CSRC = Path(tl.__file__).parent.parent / "csrc"


def test_k5_state_limit_is_k1s():
    """K5 is an instantiation of K1's cluster kernel: csrc/lognum.cu
    includes csrc/wsum_fused.cuh and launches its kLognum form, whose state
    limit (blocks of kFusedRows rows, clusters of at most kFusedMaxCluster
    blocks, read from the source) is K1's 8192, the wrappers'
    ``FUSED_MAX_K``; K5's block fits the H100's 227 KB."""
    src = (_CSRC / "lognum.cu").read_text()
    assert re.findall(r'^#include "(\S+)"', src, re.M) == ["wsum_fused.cuh"]
    assert "launch_fused<false, true>(" in src
    env = {}
    for name in ("wsum_rows.cuh", "wsum_fused.cuh"):
        code = re.sub(r"//[^\n]*", "", (_CSRC / name).read_text())
        for key, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", code, re.M):
            env[key] = eval(f"({expr})".replace("/", "//"), {}, env)
    assert env["kFusedRows"] * env["kFusedMaxCluster"] == 8192 == tw.FUSED_MAX_K
    assert env["kLognumSmemBytes"] <= 232448


# Interpret mode walks the Pallas grid in Python, at a cost that grows
# with K: K5 at (5, 1003) took ~7 s in one process, so K5 alone runs at
# K = 2 (still a reduction over states).
_INTERPRET_SHAPES = {
    "logden_dd": [(5, 1003), (3, 1024)],
    "lognum_dd": [(5, 1003), (3, 1024)],
    "lognum_fused_dd": [(2, 1003), (2, 1024)],
}


@pytest.mark.parametrize("case", [0, 1], ids=["shape0", "shape1"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_plain_matches_pallas_interpret(kernel, case):
    """Tiny shapes only (_INTERPRET_SHAPES).  At (3, 130) the interpreted
    K5 itself strays ~2e-9 from scipy's f64 logsumexp (so do (3, 257),
    (5, 300) and (5, 1003) with tile_n=128), while the port meets scipy to
    1e-13 there: the shapes here are ones where it holds 1e-11."""
    shape = _INTERPRET_SHAPES[kernel][case]
    p = _planes(*shape, seed=7 + sum(shape))
    ours = _run(kernel, p)
    assert _log_err(ours, _run(kernel, p, port=False, interpret=True)) <= 1e-11


@pytest.mark.parametrize("shape", [(5, 1003), (64, 3000), (3000, 40)])
def test_plain_matches_scipy_logsumexp(shape):
    """K = 3000 lies above the JAX package's 2048 cap; the port has none."""
    p = _planes(*shape, seed=3 * shape[0] + shape[1])
    ld = _run("logden_dd", p)
    assert np.max(np.abs(ld - p["ld64"])) <= 1e-12
    p["ldh"], p["ldl"] = (x.numpy() for x in tl.logden_dd(*_t(p["uh"], p["ul"], p["gh"], p["gl"])))
    assert np.max(np.abs(_run("lognum_dd", p) - p["ln64"])) <= 1e-12
    assert np.max(np.abs(_run("lognum_fused_dd", p) - p["ln64"])) <= 1e-12


def test_return_sums():
    """K5's raw sums s_k: log s_k + m_k is its lognum, and the sums are
    sum_n exp(-ld_n - u_kn - m_k) in f64; JAX's sums agree."""
    p = _planes(6, 2000, seed=61, pad_cols=5)
    args = _t(p["uh"], p["ul"], p["gh"], p["gl"], p["m_k"])
    s = _f64(tl.lognum_fused_dd(*args, return_sums=True))
    ln = _f64(tl.lognum_fused_dd(*args))
    assert np.max(np.abs(np.log(s) + p["m_k"] - ln)) <= 1e-13 * np.max(np.abs(ln))
    s_true = np.exp(p["ln64"] - p["m_k"].astype(np.float64))
    assert np.max(np.abs(s - s_true) / s_true) <= 1e-12
    s_jax = _f64(pk.lognum_fused_dd_ref(*_j(p["uh"], p["ul"], p["gh"], p["gl"], p["m_k"]),
                                        return_sums=True))
    assert np.max(np.abs(s - s_jax) / s_jax) <= 1e-11


def test_pad_rules_k5_masks_k7_does_not():
    """Appended sentinel columns change nothing in K5 and an all-pad matrix
    gives sums of exactly 0; K7 fed K6's ld keeps the phantom term of each
    sentinel column, as JAX's lognum_dd_ref does (to 1e-7: f64 holds the
    sentinel's 1e10 to ~2e-6, the JAX package's double words hold more)."""
    p0 = _planes(8, 600, seed=5)
    p = _planes(8, 600, seed=5, pad_cols=40)
    k5 = lambda q, **kw: _f64(tl.lognum_fused_dd(*_t(q["uh"], q["ul"], q["gh"], q["gl"], q["m_k"]), **kw))
    s0, s1 = k5(p0, return_sums=True), k5(p, return_sums=True)
    assert np.max(np.abs(s1 - s0) / s0) <= 1e-13
    only = dict(p, uh=np.full((8, 9), PAD), ul=np.zeros((8, 9), np.float32))
    assert np.all(k5(only, return_sums=True) == 0.0)

    ld = tl.logden_dd(*_t(p["uh"], p["ul"], p["gh"], p["gl"]))
    assert np.all(_f64(ld)[-40:] < -1e9)  # no masking in K6
    ln_pad = _f64(tl.lognum_dd(*_t(p["uh"], p["ul"]), *ld, torch.from_numpy(p["m_k"])))
    ln_ref = _f64(pk.lognum_dd_ref(*_j(p["uh"], p["ul"], ld[0].numpy(), ld[1].numpy(), p["m_k"])))
    assert np.max(np.abs(ln_pad - ln_ref)) <= 1e-7
    assert np.min(ln_pad - p0["ln64"]) > 1e-3  # the phantom terms are there
    assert np.max(np.abs(k5(p) - p0["ln64"])) <= 1e-12  # and K5 drops them


def test_k6_then_k7_with_k5s_mask_is_k5():
    p = _planes(7, 900, seed=9, pad_cols=11)
    uh, ul, gh, gl, m_k = _t(p["uh"], p["ul"], p["gh"], p["gl"], p["m_k"])
    ld_hi, ld_lo = tl.logden_dd(uh, ul, gh, gl)
    pad = (gh[:, None] - uh).amax(dim=0) < -1.0e8
    ln = _f64(tl.lognum_dd(uh, ul, ld_hi.masked_fill(pad, float(PAD)), ld_lo.masked_fill(pad, 0.0), m_k))
    assert np.max(np.abs(ln - _f64(tl.lognum_fused_dd(uh, ul, gh, gl, m_k)))) <= 1e-13


def test_plain_versions_stream_over_column_chunks(monkeypatch):
    p = _planes(16, 3000, seed=4, pad_cols=3)
    args = _t(p["uh"], p["ul"], p["gh"], p["gl"], p["m_k"])

    def run():
        ld = tl.logden_dd(*args[:4])
        return (_f64(ld), _f64(tl.lognum_dd(*args[:2], *ld, args[4])),
                _f64(tl.lognum_fused_dd(*args, return_sums=True)))

    one = run()
    monkeypatch.setattr(tl, "_CHUNK_BYTES", 16 * 8 * 250)
    many = run()
    assert _log_err(many[0], one[0]) <= 1e-13
    assert np.max(np.abs(many[1] - one[1])) <= 1e-14
    assert np.max(np.abs(many[2] - one[2]) / one[2]) <= 1e-14


def test_cpu_tensors_run_the_plain_versions_without_launching():
    p = _planes(4, 50, seed=1)
    args = _t(p["uh"], p["ul"], p["gh"], p["gl"], p["m_k"])
    before = (tl.LOGDEN_LAUNCHES, tl.LOGNUM_LAUNCHES, tl.LOGNUM_FUSED_LAUNCHES)
    ld = tl.logden_dd(*args[:4])
    tl.lognum_dd(*args[:2], *ld, args[4])
    tl.lognum_fused_dd(*args)
    assert (tl.LOGDEN_LAUNCHES, tl.LOGNUM_LAUNCHES, tl.LOGNUM_FUSED_LAUNCHES) == before


@pytest.mark.parametrize("bad,error", [
    ("f64_m", TypeError), ("m_length", ValueError), ("ld_length", ValueError),
    ("numpy_g", TypeError), ("meta_device", ValueError),
])
def test_wrappers_reject_what_they_cannot_take(bad, error):
    p = _planes(4, 50, seed=2)
    uh, ul, gh, gl, m_k = _t(p["uh"], p["ul"], p["gh"], p["gl"], p["m_k"])
    ld_hi, ld_lo = tl.logden_dd(uh, ul, gh, gl)
    if bad == "f64_m":
        m_k = m_k.double()
    elif bad == "m_length":
        m_k = m_k[:3]
    elif bad == "ld_length":
        ld_lo = ld_lo[:10]
    elif bad == "numpy_g":
        gh = p["gh"]
    elif bad == "meta_device":
        uh, ul, gh, gl, m_k, ld_hi, ld_lo = (t.to("meta") for t in (uh, ul, gh, gl, m_k, ld_hi, ld_lo))
    if bad in ("numpy_g", "meta_device"):
        with pytest.raises(error):
            tl.logden_dd(uh, ul, gh, gl)
    if bad != "numpy_g":
        with pytest.raises(error):
            tl.lognum_dd(uh, ul, ld_hi, ld_lo, m_k)
    if bad != "ld_length":
        with pytest.raises(error):
            tl.lognum_fused_dd(uh, ul, gh, gl, m_k)
