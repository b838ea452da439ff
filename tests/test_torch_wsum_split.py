"""The port's many-state route (K3 denom_sums_dd, K4 wsum_denom_dd and the
split route of wsum_dd) against the JAX package's, on the CPU.

On CPU tensors the wrappers of ``pymbar_tpu_torch.ops.wsum_split`` run their
plain PyTorch versions; the CUDA kernels themselves are held against those
on the card (tests/test_torch_wsum_split_cuda.py and chip_smoke.py).  Inputs
are float32 dd planes made with numpy from a seed and handed to both
packages.  Tolerances: 1e-13 relative where both sides are f64 inside,
1e-10 against the Pallas kernels in interpret mode (their dd exp is capped
at ~1.4e-11 relative on XLA:CPU, docs/numerics.md:41-44), 1e-10 in f for
whole dd solves (the dd noise floor is ~1e-12).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pymbar_tpu import solvers_large as jsl
from pymbar_tpu.ops import pallas_kernels as pk
from pymbar_tpu_torch import solvers_large as tsl
from pymbar_tpu_torch.ops import wsum as tw
from pymbar_tpu_torch.ops import wsum_split as tsplit

# one intra-op thread per test process: the suite's workers share the CPUs
torch.set_num_threads(1)

PAD = np.float32(pk._PAD_U)


def _planes(K, N, seed, counts=False, pad_cols=0, clash=False):
    """Preconditioned dd planes (column min 0), g = f + ln(N/K), optional
    counts, ``pad_cols`` sentinel columns appended and, with ``clash``, one
    real sample that state 0 gives a clash-level energy."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.0, 10.0, (K, N))
    u -= u.min(axis=0, keepdims=True)
    if clash:
        u[0, 3] = 6.0e9
    g = rng.normal(0.0, 0.5, K) + np.log(N / K)
    uh = u.astype(np.float32)
    ul = (u - uh.astype(np.float64)).astype(np.float32)
    if pad_cols:
        uh = np.pad(uh, ((0, 0), (0, pad_cols)), constant_values=PAD)
        ul = np.pad(ul, ((0, 0), (0, pad_cols)))
    gh = g.astype(np.float32)
    gl = (g - gh.astype(np.float64)).astype(np.float32)
    c = rng.integers(0, 4, uh.shape[1]).astype(np.float32) if counts else None
    return uh, ul, gh, gl, c


def _shift_and_denoms(uh, ul, gh, gl):
    """The JAX package's f32 shift and true-f64 denominators, pad columns
    set to d = 0 (pallas_kernels.py:692-701)."""
    m = jnp.max(jnp.asarray(gh)[:, None] - jnp.asarray(uh), axis=0)
    dh, dl = pk.denom_sums_dd_ref(*(jnp.asarray(a) for a in (uh, ul, gh, gl)), m)
    pad = m < jnp.float32(-1.0e8)
    dh = jnp.where(pad, jnp.float32(0.0), dh)
    dl = jnp.where(pad, jnp.float32(0.0), dl)
    return np.asarray(m), np.asarray(dh), np.asarray(dl)


def _f64(pair):
    hi, lo = pair
    if torch.is_tensor(hi):
        hi, lo = hi.numpy(), lo.numpy()
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.array(a)) for a in arrays]


def _rel(a, b):
    return np.max(np.abs(a - b) / np.abs(b))


@pytest.mark.parametrize("K,N", [(32, 1000), (5, 37), (1, 64)])
def test_denom_sums_plain_matches_jax_f64_reference(K, N):
    uh, ul, gh, gl, _ = _planes(K, N, seed=K * 100 + N, pad_cols=3)
    m, _, _ = _shift_and_denoms(uh, ul, gh, gl)
    s = _f64(tsplit.denom_sums_dd(*_t(uh, ul, gh, gl, m)))
    s_ref = _f64(pk.denom_sums_dd_ref(*(jnp.asarray(a) for a in (uh, ul, gh, gl, m))))
    assert _rel(s, s_ref) <= 1e-13


@pytest.mark.parametrize("counts", [False, True])
def test_wsum_denom_plain_matches_jax_f64_reference(counts):
    uh, ul, gh, gl, c = _planes(32, 1000, seed=5, counts=counts, pad_cols=4)
    m, dh, dl = _shift_and_denoms(uh, ul, gh, gl)
    S = _f64(tsplit.wsum_denom_dd(*_t(uh, ul, gh, gl, m, dh, dl, c)))
    S_ref = _f64(pk.wsum_denom_dd_ref(
        *(jnp.asarray(a) for a in (uh, ul, gh, gl, m, dh, dl)),
        c=None if c is None else jnp.asarray(c),
    ))
    assert _rel(S, S_ref) <= 1e-13


def test_column_shift_matches_jax_f32_max():
    uh, _, gh, _, _ = _planes(24, 300, seed=9, pad_cols=5, clash=True)
    m = tsplit.column_shift(*_t(uh, gh)).numpy()
    m_ref = np.asarray(jnp.max(jnp.asarray(gh)[:, None] - jnp.asarray(uh), axis=0))
    assert np.array_equal(m, m_ref)
    assert np.all(m[-5:] < -1.0e8) and np.all(m[:-5] > -1.0e8)


@pytest.mark.parametrize("kernel", ["denom_sums_dd", "wsum_denom_dd"])
def test_plain_matches_pallas_interpret(kernel):
    uh, ul, gh, gl, c = _planes(16, 256, seed=3, counts=True)
    m, dh, dl = _shift_and_denoms(uh, ul, gh, gl)
    j = [jnp.asarray(a) for a in (uh, ul, gh, gl, m)]
    if kernel == "denom_sums_dd":
        ours = _f64(tsplit.denom_sums_dd(*_t(uh, ul, gh, gl, m)))
        ref = _f64(pk.denom_sums_dd(*j, interpret=True))
    else:
        ours = _f64(tsplit.wsum_denom_dd(*_t(uh, ul, gh, gl, m, dh, dl, c)))
        ref = _f64(pk.wsum_denom_dd(
            *j, jnp.asarray(dh), jnp.asarray(dl), c=jnp.asarray(c), interpret=True
        ))
    assert _rel(ours, ref) <= 1e-10


@pytest.mark.parametrize("counts", [False, True])
def test_split_route_matches_jax(monkeypatch, counts):
    """wsum_dd above the gate (moved to 8; K = 24) against JAX wsum_dd_ref
    and against the JAX split composition, with pad columns and a
    clash-level real sample."""
    monkeypatch.setattr(tw, "_SPLIT_ROUTE_K", 8)
    calls = {"split": 0, "k1_plain": 0}
    real_split, real_plain = tw.split_route, tw.wsum_dd_plain

    def split_spy(*a):
        calls["split"] += 1
        return real_split(*a)

    def plain_spy(*a):
        calls["k1_plain"] += 1
        return real_plain(*a)

    monkeypatch.setattr(tw, "split_route", split_spy)
    monkeypatch.setattr(tw, "wsum_dd_plain", plain_spy)
    uh, ul, gh, gl, c = _planes(24, 500, seed=13, counts=counts, pad_cols=7, clash=True)
    S = _f64(tw.wsum_dd(*_t(uh, ul, gh, gl, c)))
    assert calls == {"split": 1, "k1_plain": 0}

    jc = None if c is None else jnp.asarray(c)
    j = [jnp.asarray(a) for a in (uh, ul, gh, gl)]
    S_ref = _f64(pk.wsum_dd_ref(*j, c=jc))
    m, dh, dl = _shift_and_denoms(uh, ul, gh, gl)
    S_comp = _f64(pk.wsum_denom_dd_ref(
        *j, jnp.asarray(m), jnp.asarray(dh), jnp.asarray(dl), c=jc
    ))
    assert _rel(S, S_ref) <= 1e-13
    assert _rel(S, S_comp) <= 1e-13
    # the appended pad columns change nothing
    S_no_pad = _f64(tw.wsum_dd(*_t(uh[:, :-7], ul[:, :-7], gh, gl,
                                   None if c is None else c[:-7])))
    assert _rel(S, S_no_pad) <= 1e-13


def test_split_route_all_pad_gives_zero(monkeypatch):
    monkeypatch.setattr(tw, "_SPLIT_ROUTE_K", 8)
    _, _, gh, gl, _ = _planes(24, 10, seed=1)
    only = np.full((24, 9), PAD)
    assert np.all(_f64(tw.wsum_dd(*_t(only, np.zeros_like(only), gh, gl))) == 0.0)


def test_solve_mbar_dd_on_the_split_route_matches_jax(monkeypatch):
    """The slice at small size: the port's dd solve with every polish
    iteration on the split route (gate at 8, K = 24) against the JAX
    package's solve_mbar_dd (wsum_dd_ref off-TPU)."""
    rng = np.random.default_rng(24)
    K, npk = 24, 100
    O, Kf = np.linspace(0.0, 3.0, K), np.linspace(1.0, 3.0, K)
    x = np.concatenate([rng.normal(o, 1.0 / np.sqrt(s), npk) for o, s in zip(O, Kf)])
    u = 0.5 * Kf[:, None] * (x[None, :] - O[:, None]) ** 2
    N_k = np.full(K, npk)
    uh, ul = jsl.host_split_planes(u)

    monkeypatch.setattr(tw, "_SPLIT_ROUTE_K", 8)
    calls = {"split": 0}
    real_split = tw.split_route

    def split_spy(*a):
        calls["split"] += 1
        return real_split(*a)

    monkeypatch.setattr(tw, "split_route", split_spy)
    f, info = tsl.solve_mbar_dd(uh, ul, N_k, device="cpu")
    f_ref, info_ref = jsl.solve_mbar_dd(uh, ul, N_k)
    assert info["converged"] and info_ref["converged"]
    assert calls["split"] == info["polish_iterations"] > 0
    df = f - f[0]
    df_ref = np.asarray(f_ref) - np.asarray(f_ref)[0]
    assert np.max(np.abs(df - df_ref)) <= 1e-10


def test_plain_versions_stream_over_column_chunks(monkeypatch):
    """A chunk budget far below the matrix gives the same results."""
    uh, ul, gh, gl, c = _planes(16, 2000, seed=5, counts=True, pad_cols=2)
    m, dh, dl = _shift_and_denoms(uh, ul, gh, gl)
    args = _t(uh, ul, gh, gl, m, dh, dl, c)

    def run():
        return (tsplit.column_shift(args[0], args[2]).numpy(),
                _f64(tsplit.denom_sums_dd(*args[:5])),
                _f64(tsplit.wsum_denom_dd(*args)))

    one = run()
    monkeypatch.setattr(tsplit, "_CHUNK_BYTES", 16 * 8 * 300)
    many = run()
    assert np.array_equal(one[0], many[0])
    assert _rel(many[1], one[1]) <= 1e-14
    assert _rel(many[2], one[2]) <= 1e-14


def test_cpu_tensors_run_the_plain_versions_without_launching(monkeypatch):
    monkeypatch.setattr(tw, "_SPLIT_ROUTE_K", 2)
    uh, ul, gh, gl, _ = _planes(4, 50, seed=1)
    before = (tw.WSUM_LAUNCHES, tsplit.SHIFT_LAUNCHES, tsplit.DENOM_SUMS_LAUNCHES,
              tsplit.WSUM_DENOM_LAUNCHES)
    tw.wsum_dd(*_t(uh, ul, gh, gl))
    after = (tw.WSUM_LAUNCHES, tsplit.SHIFT_LAUNCHES, tsplit.DENOM_SUMS_LAUNCHES,
             tsplit.WSUM_DENOM_LAUNCHES)
    assert after == before


@pytest.mark.parametrize(
    "bad,error",
    [
        ("f64_m", TypeError),
        ("m_length", ValueError),
        ("d_length", ValueError),
        ("numpy_d", TypeError),
        ("meta_device", ValueError),
    ],
)
def test_wrappers_reject_what_they_cannot_take(bad, error):
    uh, ul, gh, gl, c = _planes(4, 50, seed=2, counts=True)
    m, dh, dl = _shift_and_denoms(uh, ul, gh, gl)
    args = dict(zip(("u_hi", "u_lo", "g_hi", "g_lo", "m_n", "d_hi", "d_lo", "c"),
                    _t(uh, ul, gh, gl, m, dh, dl, c)))
    if bad == "f64_m":
        args["m_n"] = args["m_n"].double()
    elif bad == "m_length":
        args["m_n"] = args["m_n"][:10]
    elif bad == "d_length":
        args["d_lo"] = args["d_lo"][:10]
    elif bad == "numpy_d":
        args["d_hi"] = dh
    elif bad == "meta_device":
        args = {k: v.to("meta") for k, v in args.items()}
    with pytest.raises(error):
        tsplit.wsum_denom_dd(**args)
    if bad in ("f64_m", "m_length", "meta_device"):
        with pytest.raises(error):
            tsplit.denom_sums_dd(*(args[k] for k in ("u_hi", "u_lo", "g_hi", "g_lo", "m_n")))


@pytest.mark.parametrize(
    "K,N,splits",
    [(8192, 327680, 5), (1024, 999424, 33), (1024, 249856, 33), (4096, 262144, 9),
     (1, 1, 1), (33, 127, 1), (8192, 4096, 4), (5, 1000000, 977)],
)
def test_row_splits(K, N, splits):
    """~1056 blocks of 32 rows (8 per SM), each split at least 1024 columns
    wide, at most 65535 splits."""
    assert tsplit.row_splits(K, N) == splits
    k_tiles = -(-K // tsplit._ROWS_PER_BLOCK)
    assert splits == 1 or k_tiles * (splits - 1) < tsplit._ROW_TARGET_BLOCKS
    assert splits == 1 or -(-N // splits) >= tsplit._MIN_COLS_PER_SPLIT // 2


def test_row_pass_plan_fits_two_blocks_per_sm():
    """Two blocks of the row pass (csrc/wsum_rows.cuh, read from the
    source) share an SM's 228 KB (1 KB reserved per block), and row_splits
    plans with the kernel's rows per block."""
    src = (Path(tsplit.__file__).parent.parent / "csrc" / "wsum_rows.cuh").read_text()
    c = {}
    for key, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", re.sub(r"//[^\n]*", "", src),
                                re.M):
        c[key] = eval(f"({expr})".replace("/", "//"), {}, c)
    assert 2 * (c["kRowSmemBytes"] + 1024) <= 233472
    assert c["kRowsPerBlock"] == tsplit._ROWS_PER_BLOCK
