"""pymbar_tpu_torch.ops.mbar_core against pymbar_tpu.ops.mbar_core on the CPU.

The same float64 inputs (harmonic oscillators, K = 32 states x 256 samples,
made with numpy from a seed) go through each function of both packages.
Both compute in true f64 and differ only in summation order, so the
tolerance is 1e-12 relative to the largest entry; ``gram_f32_acc64`` has
float32 products and is held to 1e-5.  Each case also runs with a chunk
budget far below the matrix, so the port's column streaming is covered.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pymbar_tpu.ops import mbar_core as jc
from pymbar_tpu_torch.ops import mbar_core as tc

# one intra-op thread per test process: the suite's workers share the CPUs
torch.set_num_threads(1)

K, NPK = 32, 256


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(5)
    N = K * NPK
    O = np.linspace(0, 4, K)
    Kf = np.linspace(1, 3, K)
    x = np.repeat(O, NPK) + rng.normal(0, 1.0, N) / np.sqrt(np.repeat(Kf, NPK))
    u = 0.5 * Kf[:, None] * (x[None, :] - O[:, None]) ** 2
    N_k = np.full(K, float(NPK))
    f = np.linspace(0.0, 0.5, K)
    return u, N_k, f


@pytest.fixture(params=["one_chunk", "many_chunks"])
def chunking(request, monkeypatch):
    if request.param == "many_chunks":
        monkeypatch.setattr(tc, "_CHUNK_BYTES", 8 * K * 1000)  # 9 chunks, the last ragged
    return request.param


def _close(ours, ref, rtol=1e-12):
    ours = np.asarray(ours, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert ours.shape == ref.shape
    scale = max(float(np.max(np.abs(ref))), np.finfo(np.float64).tiny)
    assert float(np.max(np.abs(ours - ref))) <= rtol * scale


def _np(x):
    if isinstance(x, tuple):
        return tuple(_np(v) for v in x)
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


CASES = {
    "log_denominator_n": lambda m, u, N, f: m.log_denominator_n(u, N, f),
    "log_numerator_k": lambda m, u, N, f: m._log_numerator_k(u, m.log_denominator_n(u, N, f)),
    "core_stats": lambda m, u, N, f: m.core_stats(u, N, f),
    "self_consistent_update": lambda m, u, N, f: m.self_consistent_update(u, N, f),
    "self_consistent_update_subset": lambda m, u, N, f: m.self_consistent_update(
        u, N, f, states_with_samples=np.arange(0, K, 3)
    ),
    "mbar_gradient": lambda m, u, N, f: m.mbar_gradient(u, N, f),
    "mbar_objective": lambda m, u, N, f: m.mbar_objective(u, N, f),
    "mbar_objective_and_gradient": lambda m, u, N, f: m.mbar_objective_and_gradient(u, N, f),
    "mbar_w_nk_gram": lambda m, u, N, f: m.mbar_w_nk_gram(u, N, f),
    "mbar_hessian": lambda m, u, N, f: m.mbar_hessian(u, N, f),
    "mbar_W_nk": lambda m, u, N, f: m.mbar_W_nk(u, N, f),
    "mbar_log_W_nk": lambda m, u, N, f: m.mbar_log_W_nk(u, N, f),
    "precondition_u_kn": lambda m, u, N, f: m.precondition_u_kn(u, N, f),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(problem, chunking, name):
    u, N_k, f = problem
    fn = CASES[name]
    ours = _np(fn(tc, torch.from_numpy(u), torch.from_numpy(N_k), torch.from_numpy(f)))
    ref = _np(fn(jc, jnp.asarray(u), jnp.asarray(N_k), jnp.asarray(f)))
    for o, r in zip(ours if isinstance(ours, tuple) else (ours,),
                    ref if isinstance(ref, tuple) else (ref,)):
        _close(o, r)


BATCHED = [
    "log_denominator_n", "log_numerator_k", "core_stats", "self_consistent_update",
    "mbar_gradient", "mbar_objective", "mbar_objective_and_gradient", "mbar_w_nk_gram",
    "mbar_hessian", "precondition_u_kn",
]


@pytest.mark.parametrize("name", BATCHED)
def test_batched_forms_match_jax(problem, chunking, name):
    """A leading batch axis: three replicates (the problem's columns
    resampled, each at its own f_k; precondition_u_kn shares one f_k) in
    one call, each against JAX's call on that replicate alone."""
    u, N_k, f = problem
    rng = np.random.default_rng(11)
    cols = [np.arange(u.shape[1])] + [rng.integers(u.shape[1], size=u.shape[1]) for _ in "ab"]
    u_b = np.stack([u[:, c] for c in cols])
    f_b = np.stack([f, 0.9 * f, 1.1 * f]) if name != "precondition_u_kn" else f
    ours = _np(CASES[name](tc, torch.from_numpy(u_b), torch.from_numpy(N_k),
                           torch.from_numpy(f_b)))
    for b in range(len(cols)):
        f_one = f_b[b] if f_b.ndim == 2 else f
        ref = _np(CASES[name](jc, jnp.asarray(u_b[b]), jnp.asarray(N_k), jnp.asarray(f_one)))
        for o, r in zip(ours if isinstance(ours, tuple) else (ours,),
                        ref if isinstance(ref, tuple) else (ref,)):
            _close(o[b], r)


@pytest.mark.parametrize("pad_columns", [0, 5])
def test_gram_normalization_matches_jax(problem, chunking, pad_columns):
    """Gram, column sums and the row-check aggregates; sentinel pad columns
    are phantom samples whose row sums (0) fail the check."""
    u, N_k, f = problem
    if pad_columns:
        u = np.concatenate([u, np.full((K, pad_columns), 1.0e10)], axis=1)
    g, cs, rows = tc.mbar_gram_normalization(torch.from_numpy(u), N_k, f)
    g_ref, cs_ref, rows_ref = jc.mbar_gram_normalization(jnp.asarray(u), N_k, f)
    _close(_np(g), _np(g_ref))
    _close(_np(cs), _np(cs_ref))
    assert rows[:2] == rows_ref[:2]
    assert rows[2] == pytest.approx(rows_ref[2], abs=1e-12)
    if pad_columns:
        assert rows == (pad_columns, K * NPK, 0.0)


@pytest.mark.parametrize("counts", [False, True])
def test_gram_f32_acc64_matches_jax(problem, chunking, counts):
    """float32 products on both sides: 1e-5 relative to the largest entry."""
    u, N_k, f = problem
    u32 = (u - u.min(axis=0)).astype(np.float32)
    N32 = N_k.astype(np.float32)
    f32 = f.astype(np.float32)
    c = np.random.default_rng(1).integers(0, 3, u.shape[1]).astype(np.float32)
    ours = tc.gram_f32_acc64(
        torch.from_numpy(u32), torch.from_numpy(N32), torch.from_numpy(f32),
        torch.from_numpy(c) if counts else None,
    )
    ref = jc.gram_f32_acc64(
        jnp.asarray(u32), jnp.asarray(N32), jnp.asarray(f32),
        jnp.asarray(c) if counts else None,
    )
    for o, r in zip(ours, ref):
        assert o.dtype == torch.float64
        _close(_np(o), _np(r), rtol=1e-5)


def test_validate_inputs(problem):
    u, N_k, f = problem
    ut, Nt, ft = tc.validate_inputs(u, N_k, f)
    assert torch.is_tensor(ut) and ut.dtype == torch.float64
    assert ut.data_ptr() == u.__array_interface__["data"][0]  # no copy
    assert Nt.dtype == np.float64 and ft.dtype == np.float64
    t = torch.from_numpy(u)
    assert tc.validate_inputs(t, N_k, f)[0] is t
    for bad in ((u, N_k[:-1], f), (u, N_k, f[:-1])):
        with pytest.raises(ValueError):
            tc.validate_inputs(*bad)
        with pytest.raises(ValueError):
            jc.validate_inputs(*bad)


def _old_chunk_body(u_c, N_k, f_k, sampled=None):
    """The chunk body ``mbar_gram_normalization`` ran before
    ``gram_weights``: (w, logden, rowsum, column sums)."""
    N_s, f_s = (N_k, f_k) if sampled is None else (N_k[sampled], f_k[sampled])
    logden = tc._logden_direct(u_c if sampled is None else u_c.index_select(0, sampled), N_s, f_s)
    w = tc._weights(u_c, f_k, logden)
    w.masked_fill_(u_c >= tc._PAD_THRESHOLD, 0.0)
    return w, logden, N_k @ w, w.sum(dim=1)


def _old_gram_normalization(u, N_k, f_k, sampled=None, tolerance=1.0e-4):
    """``mbar_gram_normalization``'s loop before ``gram_weights``, without
    its callbacks: (gram, colsum, rowstats)."""
    gram = torch.zeros((u.shape[0],) * 2, dtype=u.dtype)
    colsum = torch.zeros(u.shape[0], dtype=u.dtype)
    cnt, fidx, fval = 0, u.shape[1] + 1, 0.0
    for s, e, u_c in tc.stream_columns(u):
        w, _, rowsum, cs = _old_chunk_body(u_c, N_k, f_k, sampled)
        gram += w @ w.T
        colsum += cs
        bad = torch.nonzero(torch.abs(rowsum.to(torch.float64) - 1.0) > tolerance).flatten()
        if len(bad) and cnt == 0:
            fidx, fval = s + int(bad[0]), float(rowsum[bad[0]])
        cnt += len(bad)
    return gram, colsum, (cnt, fidx, fval)


def _weights_case(problem, case):
    """(u, N_k, f, sampled) of a ``gram_weights`` case: pad columns; an
    empty state whose f - u lies above every other row, with and without
    ``sampled``; a row of +inf (a state no sample reaches)."""
    u, N_k, f = (torch.from_numpy(x.copy()) for x in problem)
    sampled = None
    if case in ("pad_columns", "inf_row"):
        u = torch.cat([u, torch.full((K, 5), 1.0e10, dtype=u.dtype)], dim=1)
    if case.startswith("empty_state") or case == "inf_row":
        N_k[7] = 0.0
        u[7] = u.min() - 5.0
        if case != "empty_state_all_rows":
            sampled = torch.tensor([k for k in range(K) if k != 7])
    if case == "inf_row":
        u[7] = torch.inf
    return u, N_k, f, sampled


WEIGHTS_CASES = ["pad_columns", "empty_state_sampled", "empty_state_all_rows", "inf_row"]


@pytest.mark.parametrize("case", WEIGHTS_CASES)
def test_gram_weights_plain_is_the_old_chunk_body(problem, case):
    """``gram_weights`` on a CPU chunk runs ``gram_weights_plain``: bit for
    bit the chunk body it replaced, NaNs and infinities in the same places."""
    from pymbar_tpu_torch.ops import gram_weights as gw

    u, N_k, f, sampled = _weights_case(problem, case)
    before = gw.GRAM_WEIGHTS_LAUNCHES
    ours = gw.gram_weights(u, N_k, f, sampled)
    assert gw.GRAM_WEIGHTS_LAUNCHES == before  # the plain version launches nothing
    for o, r in zip(ours, _old_chunk_body(u.clone(), N_k, f, sampled)):
        assert torch.equal(o.isnan(), r.isnan())
        assert torch.equal(o.nan_to_num(), r.nan_to_num())


@pytest.mark.parametrize("case", WEIGHTS_CASES)
def test_chunked_gram_normalization_matches_the_old_loop(problem, chunking, case):
    """The whole pass against the loop it replaced, in one chunk and in
    nine: column sums and row checks bit for bit, the Gram to 1e-12 of
    its largest entry."""
    u, N_k, f, sampled = _weights_case(problem, case)
    g, cs, rows = tc.mbar_gram_normalization(u, N_k, f, sampled=sampled)
    g_ref, cs_ref, rows_ref = _old_gram_normalization(u, N_k, f, sampled)
    _close(_np(g), _np(g_ref))
    assert torch.equal(cs, cs_ref)
    assert rows == rows_ref
