"""The hand-written CUDA kernels of the lognum family (K6 logden_dd, K7
lognum_dd, K5 lognum_fused_dd) against their plain PyTorch versions, their
identity with K1, and a P = 4 mesh dd solve on one card.  K5 is the K5
instantiation of K1's cluster kernel: also at its largest clusters, above
its 8192 states, bit for bit twice, and on the rows it takes directly.

Needs an NVIDIA card (marker ``cuda``); skips without one.  Imports no JAX,
so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_lognum_cuda.py
"""

import numpy as np
import pytest
import torch

from pymbar_tpu_torch.ops import lognum as tl
from pymbar_tpu_torch.ops import wsum as tw
from pymbar_tpu_torch.ops.doubledouble import dd_from_f64, dd_to_f64
from pymbar_tpu_torch.parallel import sharding as ts
from pymbar_tpu_torch.solvers_large import dev_split_planes, solve_mbar_dd

pytestmark = pytest.mark.cuda

PAD = 1.0e10


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _planes(K, N, seed, dev, pad_cols=0):
    """dd planes of u in [0, 10), g = f + ln(N/K), m_k = max_n (-ld - u) in
    float32, and ``pad_cols`` sentinel columns appended."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    u = torch.rand((K, N), generator=gen, dtype=torch.float64, device=dev) * 10.0
    g = torch.randn(K, generator=gen, dtype=torch.float64, device=dev) * 0.5
    g = g + torch.log(torch.tensor(N / K, dtype=torch.float64))
    ld = torch.logsumexp(g[:, None] - u, dim=0)
    m_k = (-ld[None, :] - u).amax(dim=1).to(torch.float32)
    uh, ul = dd_from_f64(u)
    if pad_cols:
        uh = torch.cat([uh, torch.full((K, pad_cols), PAD, dtype=torch.float32, device=dev)], 1)
        ul = torch.cat([ul, torch.zeros((K, pad_cols), dtype=torch.float32, device=dev)], 1)
    return uh, ul, *dd_from_f64(g), m_k


def _log_err(a, b):
    return float(((a - b).abs() / b.abs().clamp_min(1.0)).max())


def _rel(a, b):
    return float(((a - b).abs() / b.abs()).max())


SHAPES = [(1024, 65536, 0), (5, 1003, 0), (1, 1, 0), (3000, 4096, 0), (512, 8192, 77)]


@pytest.mark.parametrize("K,N,pad", SHAPES)
def test_kernels_match_plain(dev, K, N, pad):
    """Both sides are f64 inside, in another summation order: 1e-12 on the
    logs (relative for a sentinel column's ~-1e10), 1e-13 relative on K5's
    sums."""
    uh, ul, gh, gl, m_k = _planes(K, N, K + N, dev, pad)
    before = (tl.LOGDEN_LAUNCHES, tl.LOGNUM_LAUNCHES, tl.LOGNUM_FUSED_LAUNCHES)
    ld = tl.logden_dd(uh, ul, gh, gl)
    ln = tl.lognum_dd(uh, ul, *ld, m_k)
    s = tl.lognum_fused_dd(uh, ul, gh, gl, m_k, return_sums=True)
    torch.cuda.synchronize()
    after = (tl.LOGDEN_LAUNCHES, tl.LOGNUM_LAUNCHES, tl.LOGNUM_FUSED_LAUNCHES)
    assert after == tuple(b + 1 for b in before)
    assert _log_err(dd_to_f64(*ld), dd_to_f64(*tl.logden_dd_plain(uh, ul, gh, gl))) <= 1e-12
    assert _log_err(dd_to_f64(*ln), dd_to_f64(*tl.lognum_dd_plain(uh, ul, *ld, m_k))) <= 1e-12
    s_ref = dd_to_f64(*tl.lognum_fused_dd_plain(uh, ul, gh, gl, m_k, return_sums=True))
    assert _rel(dd_to_f64(*s), s_ref) <= 1e-13
    ln5 = dd_to_f64(*tl.lognum_fused_dd(uh, ul, gh, gl, m_k))
    assert _log_err(ln5, dd_to_f64(*tl.lognum_fused_dd_plain(uh, ul, gh, gl, m_k))) <= 1e-12


def test_kernel_at_its_largest_clusters(dev):
    """K5 at K1's limit, 8192 states: clusters of 16 blocks (non-portable)."""
    uh, ul, gh, gl, m_k = _planes(8192, 65536, 8192, dev)
    s = dd_to_f64(*tl.lognum_fused_dd(uh, ul, gh, gl, m_k, return_sums=True))
    assert _rel(s, dd_to_f64(*tl.lognum_fused_dd_plain(uh, ul, gh, gl, m_k, return_sums=True))) <= 1e-13
    ln5 = dd_to_f64(*tl.lognum_fused_dd(uh, ul, gh, gl, m_k))
    assert _log_err(ln5, dd_to_f64(*tl.lognum_fused_dd_plain(uh, ul, gh, gl, m_k))) <= 1e-12


def test_more_states_than_the_cluster_kernel_raise(dev):
    uh, ul, gh, gl, m_k = _planes(8193, 64, 1, dev)
    before = (tl.LOGNUM_FUSED_LAUNCHES, tw.WSUM_LAUNCHES)
    with pytest.raises(RuntimeError, match="8192"):
        tl.lognum_fused_dd(uh, ul, gh, gl, m_k)
    assert (tl.LOGNUM_FUSED_LAUNCHES, tw.WSUM_LAUNCHES) == before


@pytest.mark.parametrize("K", [1024, 4096], ids=["clusters_of_2", "clusters_of_8"])
def test_two_calls_give_the_same_bits(dev, K):
    """No atomics; a K5 call launches no K1 (WSUM_LAUNCHES unmoved)."""
    uh, ul, gh, gl, m_k = _planes(K, 20000, K, dev, pad_cols=5)
    before = tw.WSUM_LAUNCHES
    a = tl.lognum_fused_dd(uh, ul, gh, gl, m_k, return_sums=True)
    b = tl.lognum_fused_dd(uh, ul, gh, gl, m_k, return_sums=True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert tw.WSUM_LAUNCHES == before


def _far_row(K, N, kind, dev):
    """Planes where row 3 is one the factorization T_kn r_n F_k cannot take:
    its g lowered by 750 below the others ("lowered") or the -1e10 sentinel
    over real u ("clash", a clash-level row), with m_3 its own lognum from
    the plain twin, so that s_3 ~ 1 while its T_kn = exp(a_kn - m_n)
    underflow."""
    uh, ul, gh, gl, m_k = _planes(K, N, K + N, dev)
    g = dd_to_f64(gh, gl)
    g[3] = g[3] - 750.0 if kind == "lowered" else -1.0e10
    gh, gl = dd_from_f64(g)
    m_n = (gh[:, None] - uh).amax(dim=0).to(torch.float64)
    T3 = torch.exp(dd_to_f64(gh, gl)[3] - dd_to_f64(uh[3], ul[3]) - m_n)
    assert float(T3.max()) < torch.finfo(torch.float64).tiny
    m_k[3] = dd_to_f64(*tl.lognum_fused_dd_plain(uh, ul, gh, gl, m_k))[3].to(torch.float32)
    return uh, ul, gh, gl, m_k


@pytest.mark.parametrize("K", [1024, 3000])
@pytest.mark.parametrize("kind", ["lowered", "clash"])
def test_direct_form_rows_match_plain(dev, kind, K):
    """The rows K5 takes in its direct form, against the plain twin: sums
    1e-13 relative, logs 1e-12."""
    uh, ul, gh, gl, m_k = _far_row(K, 8192, kind, dev)
    s = dd_to_f64(*tl.lognum_fused_dd(uh, ul, gh, gl, m_k, return_sums=True))
    s_ref = dd_to_f64(*tl.lognum_fused_dd_plain(uh, ul, gh, gl, m_k, return_sums=True))
    assert abs(float(s_ref[3]) - 1.0) <= 1e-5
    assert _rel(s, s_ref) <= 1e-13
    ln5 = dd_to_f64(*tl.lognum_fused_dd(uh, ul, gh, gl, m_k))
    assert _log_err(ln5, dd_to_f64(*tl.lognum_fused_dd_plain(uh, ul, gh, gl, m_k))) <= 1e-12


def test_fused_is_k6_then_k7_masked_and_matches_k1(dev):
    """K5 = K6, K5's pad mask, K7; and lognum_k + g_k = log S_k of K1 on the
    same planes, since S_k = exp(g_k) sum_n exp(-u_kn - ld_n)."""
    uh, ul, gh, gl, m_k = _planes(1024, 16384, 3, dev, pad_cols=77)
    ld_hi, ld_lo = tl.logden_dd(uh, ul, gh, gl)
    pad = (gh[:, None] - uh).amax(dim=0) < -1.0e8
    ln7 = dd_to_f64(*tl.lognum_dd(uh, ul, ld_hi.masked_fill(pad, PAD), ld_lo.masked_fill(pad, 0.0), m_k))
    ln5 = dd_to_f64(*tl.lognum_fused_dd(uh, ul, gh, gl, m_k))
    assert _log_err(ln7, ln5) <= 1e-13
    S = dd_to_f64(*tw.wsum_dd(uh, ul, gh, gl))
    assert float((ln5 + dd_to_f64(gh, gl) - torch.log(S)).abs().max()) <= 1e-12


def test_pad_columns(dev):
    """K5 drops appended sentinel columns and gives sums of exactly 0 on an
    all-pad matrix; K7 fed K6's ld keeps their phantom terms."""
    uh, ul, gh, gl, m_k = _planes(512, 8192, 4, dev)
    uhp, ulp, *_ = _planes(512, 8192, 4, dev, pad_cols=77)
    s0 = dd_to_f64(*tl.lognum_fused_dd(uh, ul, gh, gl, m_k, return_sums=True))
    s1 = dd_to_f64(*tl.lognum_fused_dd(uhp, ulp, gh, gl, m_k, return_sums=True))
    assert _rel(s1, s0) <= 1e-13
    only = torch.full((512, 300), PAD, dtype=torch.float32, device=dev)
    z = dd_to_f64(*tl.lognum_fused_dd(only, torch.zeros_like(only), gh, gl, m_k, return_sums=True))
    assert bool((z == 0).all())
    ln0 = dd_to_f64(*tl.lognum_dd(uh, ul, *tl.logden_dd(uh, ul, gh, gl), m_k))
    ln1 = dd_to_f64(*tl.lognum_dd(uhp, ulp, *tl.logden_dd(uhp, ulp, gh, gl), m_k))
    assert float((ln1 - ln0).min()) > 1e-4


def test_mesh_of_four_shards_on_one_card(dev):
    """sharded_solve_mbar_dd over 4 shards of cuda:0 (10,003 samples: pad
    columns) against solve_mbar_dd: 5e-10; one K1 launch per shard per
    polish iteration; K5 on the mesh equals K5 on the whole planes."""
    K, npk = 64, 157
    O = torch.linspace(0.0, 5.0, K, dtype=torch.float64, device=dev)
    Kf = torch.linspace(1.0, 3.0, K, dtype=torch.float64, device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    x = (O[:, None] + torch.randn((K, npk), generator=gen, dtype=torch.float64, device=dev)
         / torch.sqrt(Kf)[:, None]).reshape(-1)[:-45]
    N_k = np.full(K, npk)
    N_k[-1] -= 45
    uh, ul = dev_split_planes(0.5 * Kf[:, None] * (x[None, :] - O[:, None]) ** 2)
    f1, info1 = solve_mbar_dd(uh, ul, N_k)
    mesh = ts.default_mesh(4, device="cuda:0")
    before = tw.WSUM_LAUNCHES
    f4, info4 = ts.sharded_solve_mbar_dd(uh, ul, N_k, mesh=mesh)
    assert info1["converged"] and info4["converged"]
    assert tw.WSUM_LAUNCHES - before == 4 * info4["polish_iterations"]
    assert np.max(np.abs(f4 - f1)) < 5e-10

    gh, gl = dd_from_f64(torch.as_tensor(f4, device=dev) + torch.log(torch.as_tensor(N_k, dtype=torch.float64, device=dev)))
    m_k = torch.as_tensor(-f4, dtype=torch.float32, device=dev)
    uh_s, ul_s, n_pad = ts.shard_dd_planes(uh, ul, mesh)
    assert n_pad == 1
    before = tl.LOGNUM_FUSED_LAUNCHES
    ln4 = dd_to_f64(*ts.sharded_fused_lognum_dd(uh_s, ul_s, gh, gl, m_k, mesh))
    assert tl.LOGNUM_FUSED_LAUNCHES - before == 4
    ln1 = dd_to_f64(*tl.lognum_fused_dd(uh, ul, gh, gl, m_k))
    assert float((ln4 - ln1).abs().max()) <= 1e-12
    f_sci = (-ln4 + ln4[0]).cpu().numpy()
    assert np.max(np.abs(f_sci - (f4 - f4[0]))) <= 1e-10
