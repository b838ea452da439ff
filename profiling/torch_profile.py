#!/usr/bin/env python3
"""Where the time goes in the PyTorch port, on one CUDA card.

    python3 profiling/torch_profile.py [flagship] [slice] [mesh] [bootstrap] [diagnostics]
                                       [expectations] [clusters] [fes] [mesh_bootstrap]
                                       [batched_bootstrap] [boot_budgets] [host]

Configurations (harmonic oscillators, O = linspace(0, 5), K_f =
linspace(1, 3), float64 u_kn made on the card from a seed):

* ``flagship``: bench.py's K = 1024 x 976 samples (8.2 GB);
* ``slice``: the many-state slice, K = 8192 x 40 samples (21.5 GB), which
  takes wsum_dd's split route (K3 + K4) in every polish iteration.

For each (both when none is named) it warms up ``MBAR(u_kn, N_k)`` and
``compute_free_energy_differences()`` once, then prints JSON lines:

* host-clock walls (fenced by ``torch.cuda.synchronize()``): the
  double-word split, the dd solve's phase 1 (float32 warm start and chord
  factor) and phase 2 (polish), the Theta Gram pass, the rank-nnz Theta
  algebra on the card and the dense numpy algebra on the host for the
  same Gram, the free energies, and peak device memory;
* ``MBAR`` walls by the route the state count picks and by the other
  wsum route (``_SPLIT_ROUTE_K`` moved), in turns this, other, other, this;
* for the flagship, one ``torch.profiler`` trace of MBAR + free energies:
  device time per kernel name (top 15).  The device's busy and idle
  shares are ``portbench``'s (``python3 portbench/run.py ... --trace 1``:
  ``device_idle_pct.*``, from the union of the device's intervals).

``mesh`` runs the flagship through ``MBAR(u_kn, N_k, mesh=...)`` on 1-D
meshes of 2, 4 and 8 shards of cuda:0 (and of every card when there are
several), each in turns against the single-device dd solve (no mesh,
mesh, mesh, no mesh: init wall, the solve's phases, polish iterations, peak
memory); times ``sharded_fused_lognum_dd`` on each mesh against one K5 call
on the whole planes (median of 5 fenced calls); and takes the profiler
trace of MBAR + free energies on the 4-shard mesh.

``bootstrap`` runs the flagship with B = 64 replicates: ``MBAR`` init with
and without them in turns, the host draws of the resample indices and the
counts, ``bootstrap_polish_dd`` at tol 1e-12 and 1e-7 in turns (walls,
reps/s, phase walls, iterations), the exact phase alone from the base
point (the same replicates without the float32 fast phase), and one
profiler trace of ``bootstrap_polish_dd`` at 1e-12.

``diagnostics`` wraps the flagship's solution in ``MBAR.from_solution`` and
times, three times each after one warm-up: the BAR chain
(``_initialize_with_bar``), ``Log_W_nk`` on the card alone and with its
copy to the host, ``compute_effective_sample_number``, ``compute_overlap``
and the 'svd' Theta with its steps (W on the card, ``check_w_normalized``,
the R of W's row blocks folded by QRs, ``mbar_core._tsqr_rows``, and the
SVD of R, ``MBAR._sigma_v``); then ``torch.linalg.svd`` of W once, the direct factorization the
QR route stands in for; then the R factor of W by one Householder QR of
the whole W against the streamed fold over row blocks of 128 MB, 512 MB
and 2 GB (``mbar_core._tsqr_rows``: each block's R, stacked under the
running R and refactored) and against a fold that refactors the running
R stacked on the block itself, each in turns after a warm-up, with its
peak memory.

``expectations`` measures ``mbar._AUG_STREAM_BYTES``: at (K, samples per
state) = (128, 8), (512, 4), (1024, 2), (1024, 12) and (1024, 122) (1.05
MB, 8.4 MB, 16.8 MB, 101 MB and 1.02 GB of u_kn), ``compute_expectations(x)`` and ``compute_entropy_and_enthalpy()`` by the
materializing and by the streamed branch in turns (materialized, streamed,
streamed, materialized, after one warm-up of each), with their peak
memory.  Then, at the flagship, the walls of those two calls and of their
steps, three times each after one warm-up: pass A alone, pass B (the
structured Gram pass), the Gram assembly and the rank-nnz Theta, and for
entropy the three sigma matrices; and one profiler trace of each call.

``clusters`` reads the single-read cluster kernel (csrc/wsum_fused.cuh) by
its cluster size: at K = 1024, 2048, 4096 and 8192 states (clusters of 2,
4, 8 and 16 blocks of 512 rows) over 2^30 elements each (N = 2^30 / K,
random planes), the clusters the card holds at once and the SMs they
fill, K1's and K5's (its second instantiation) medians of 5 fenced calls
in turns (K1, K5, K5, K1), their element rates per SM, and K1's pinned
ceiling at the same K (``roofline.measure_wsum_ceiling`` over a (K,
2^19 / K) tile, 4 MB of planes in L2, 2^32 elements).

``fes`` runs bench.py's fes_slice configuration (64 umbrella windows x
16,384 samples, 537 MB of u_kn made on the card): warm walls (three after
one warm-up) of ``FES(u_kn, N_k)``, the histogram's ``generate_fes`` and
its steps (the target state's log weights on the card, the host
bookkeeping), the analytical ``get_fes`` and its steps (the streamed
augmented Gram, the rank-nnz Theta), the KDE's generate + get, and one
profiler trace of FES + histogram; then the histogram on the flagship's
u_kn (target state K/2, 100 bins): walls and a trace.

``mesh_bootstrap`` runs the flagship with B = 64 replicates on 4 shards of
cuda:0 (and on every card when there are several): ``MBAR`` init on one
card and on the mesh in turns (one card, mesh, mesh, one card: walls,
peak); then ``sharded_bootstrap_polish_dd`` on the mesh's planes with the
resident fast plane and without it (``_use_resident_th`` patched) in turns,
and with groups of 16, 32 and 64 replicates (``_batch_group_size``
patched): walls, reps/s and peak memory, the inputs of the per-card
budgets ``_TH_RESIDENT_BUDGET_BYTES`` and ``_batch_group_size``.

``batched_bootstrap`` measures ``mbar._BATCHED_BOOT_BYTES`` and the chunk
width of ``solvers.batched_bootstrap_solve``: at 6.1 MB (16 oscillators x
3,000 samples, B = 100), 67 MB (64 x 2,048, B = 32), 268 MB (128 x
2,048, B = 16), 545 MB (the umbrella
configuration plus its unbiased state, unsampled, B = 16), 2.1 GB (256 x
4,096, B = 8), 4.3 GB (512 x 2,048, B = 4) and 8.6 GB (1024 x 1,024,
B = 2), the
batched solve against the sequential route (one adaptive solve per
replicate on its gathered columns; both with the bootstrap protocol's
min_sc_iter = 0, as MBAR runs them) in turns (batched, sequential,
sequential, batched: walls, peak, the chunk the free memory gave); then at
545 MB the batched solve with chunks of 1, 2, 4, 8 and 16 replicates,
and profiler traces of 2 replicates by each route; last, the batched Gram
W W^T three ways (one bmm, a matmul per replicate, a bmm over
16,384-column blocks) at the cases' chunk shapes (median of 5).

``boot_budgets`` measures the single-card bootstrap engine's budgets:
``solvers_large._batch_group_size`` at the flagship with B = 256 (groups
of 64, 128, 256 in turns) and ``_TH_RESIDENT_BUDGET_BYTES`` at K = 1024 x
2,500 samples per state (21 GB of u_kn), the resident fast plane against
the recomputed exp in turns: walls, phase walls, peak memory.

``host`` holds the flagship's u_kn in host memory (pageable, as
``torch.from_numpy`` gives it) against the same matrix on the card:
``MBAR``, ``compute_free_energy_differences()`` and
``compute_expectations(x)`` by the resident and the host-resident route in
turns (resident, host, host, resident, after one warm-up of each: walls
and peak above what was resident); one pinned 512 MB upload (median of
5), and a streamed pass over u_kn (``mbar_core.stream_columns``, nothing
done with the chunks) from pageable and from pinned host memory, three
each: GB/s; then one profiler trace of the host-resident MBAR + free
energies (device time per kernel and copy).
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name: (K, samples per state, take a profiler trace).  The profiler's trace
# of the slice (thousands of eager ops on 8192^2 matrices) did not finish
# within ten minutes on an H100, so the slice reports walls only.
CONFIGS = {"flagship": (1024, 976, True), "slice": (8192, 40, False)}


def oscillators(torch, K, npk, dev, with_x=False):
    gen = torch.Generator(device=dev).manual_seed(1)
    O = torch.linspace(0.0, 5.0, K, dtype=torch.float64, device=dev)
    Kf = torch.linspace(1.0, 3.0, K, dtype=torch.float64, device=dev)
    z = torch.randn((K, npk), generator=gen, dtype=torch.float64, device=dev)
    x = (O[:, None] + z / torch.sqrt(Kf)[:, None]).reshape(-1)
    N = K * npk
    u = torch.empty((K, N), dtype=torch.float64, device=dev)
    step = max(1, 2**26 // K)
    for s in range(0, N, step):
        u[:, s : s + step] = 0.5 * Kf[:, None] * (x[None, s : s + step] - O[:, None]) ** 2
    return (u, [npk] * K, x) if with_x else (u, [npk] * K)


def timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def profile_config(torch, name, card):
    from pymbar_tpu_torch import MBAR
    from pymbar_tpu_torch.ops import wsum
    from pymbar_tpu_torch.ops.mbar_core import mbar_gram_normalization
    from pymbar_tpu_torch.solvers_large import dev_split_planes

    dev = torch.device("cuda", 0)
    K, npk, trace = CONFIGS[name]
    u, N_k = oscillators(torch, K, npk, dev)
    timed(torch, lambda: MBAR(u, N_k).compute_free_energy_differences())  # warm-up

    walls = {}
    torch.cuda.reset_peak_memory_stats()
    walls["split_s"], planes = timed(torch, lambda: dev_split_planes(u))
    del planes
    walls["mbar_init_s"], m = timed(torch, lambda: MBAR(u, N_k))
    info = m.solver_results[0]["info"]
    walls["dd_phase1_s"] = info["phase1_s"]
    walls["dd_phase2_s"] = info["phase2_s"]
    walls["polish_iterations"] = info["polish_iterations"]
    walls["f32_coarse_iterations"] = info["f32_coarse_iterations"]
    walls["gram_pass_s"], (gram, _, _) = timed(
        torch, lambda: mbar_gram_normalization(u, m.N_k, m.f_k)
    )
    walls["theta_card_lowrank_s"], _ = timed(
        torch, lambda: m._theta_svd_ew_lowrank(gram, m.N_k).cpu().numpy()
    )
    gram = gram.cpu().numpy()
    t0 = time.perf_counter()
    m._theta_svd_ew_from_gram(gram, m.N_k)
    walls["theta_host_dense_s"] = time.perf_counter() - t0
    del gram
    walls["free_energies_s"], _ = timed(torch, lambda: m.compute_free_energy_differences())
    walls["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    print(json.dumps(dict(config=name, card=card, K=K, N=K * npk, **walls)), flush=True)

    # the other wsum route on the same tensor, in turns
    this = "split" if K > wsum._SPLIT_ROUTE_K else "k1"
    other = "k1" if this == "split" else "split"
    gates = {"split": 0, "k1": 2**31}
    saved = wsum._SPLIT_ROUTE_K
    turns = {this: [], other: []}
    try:
        for route in (this, other, other, this):
            wsum._SPLIT_ROUTE_K = gates[route]
            turns[route].append(timed(torch, lambda: MBAR(u, N_k))[0])
    finally:
        wsum._SPLIT_ROUTE_K = saved
    print(json.dumps(dict(config=name, card=card, route_by_state_count=this,
                          mbar_init_s_by_route=turns)), flush=True)
    if trace:
        print(json.dumps(dict(config=name, card=card, **device_trace(torch, u, N_k, walls))),
              flush=True)
    del u, m
    torch.cuda.empty_cache()


def device_trace(torch, u, N_k, walls, mesh=None):
    """Device time per kernel over one MBAR + free energies, beside the
    unprofiled wall of the same work."""
    from pymbar_tpu_torch import MBAR

    return trace_kernels(
        torch, lambda: MBAR(u, N_k, mesh=mesh).compute_free_energy_differences(),
        walls["mbar_init_s"] + walls["free_energies_s"],
    )


def trace_kernels(torch, fn, unprofiled):
    """Device time per kernel over one call of ``fn`` (the program's own
    ``pymbar_tpu_torch.*`` annotations left out), beside the profiled wall
    and ``unprofiled``, the unprofiled wall of the same work (the profiler
    slows the host side).  Summed kernel times count overlaps twice, so no
    busy share is made of them: ``portbench --trace 1`` measures it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    def dev_us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, attr):
                return getattr(e, attr)
        return 0.0

    # device-side events only (the aten ops' own device totals would count
    # their kernels twice; an annotation's device range spans its kernels)
    kernels = [
        (e.key, dev_us(e), e.count) for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0
        and not e.key.startswith("pymbar_tpu_torch.")
    ]
    kernels.sort(key=lambda t: -t[1])
    return dict(
        profiled_wall_s=wall, unprofiled_wall_s=unprofiled,
        top_kernels=[dict(name=k[:90], device_ms=t / 1e3, calls=c) for k, t, c in kernels[:15]],
    )


def median_ms(torch, fn, reps=5):
    fn()
    times = [timed(torch, fn)[0] * 1e3 for _ in range(reps)]
    return sorted(times)[reps // 2]


def profile_mesh(torch, card):
    """The flagship on 1-D meshes against the single-device dd solve."""
    from pymbar_tpu_torch import MBAR
    from pymbar_tpu_torch.ops.doubledouble import dd_from_f64
    from pymbar_tpu_torch.ops.lognum import lognum_fused_dd
    from pymbar_tpu_torch.parallel import default_mesh, shard_dd_planes, sharded_fused_lognum_dd
    from pymbar_tpu_torch.solvers_large import dev_split_planes

    dev = torch.device("cuda", 0)
    u, N_k = oscillators(torch, *CONFIGS["flagship"][:2], dev)
    meshes = {f"{P} shards of cuda:0": default_mesh(P, device="cuda:0") for P in (2, 4, 8)}
    if torch.cuda.device_count() > 1:
        meshes[f"{torch.cuda.device_count()} cards"] = default_mesh()
    single = dict(solver_protocol=(dict(method="dd"),))  # no mesh, whatever the card count

    def run(mesh):
        torch.cuda.reset_peak_memory_stats()
        t, m = timed(torch, lambda: MBAR(u, N_k, **(single if mesh is None else dict(mesh=mesh))))
        info = m.solver_results[0]["info"]
        return m, dict(init_s=t, phase1_s=info["phase1_s"], phase2_s=info["phase2_s"],
                       polish_iterations=info["polish_iterations"],
                       max_memory_allocated=torch.cuda.max_memory_allocated())

    for mesh in (None, *meshes.values()):  # warm-up
        run(mesh)[0].compute_free_energy_differences()
    for label, mesh in meshes.items():
        turns = {"no mesh": [], label: []}
        for which in ("no mesh", label, label, "no mesh"):
            turns[which].append(run(None if which == "no mesh" else mesh)[1])
        print(json.dumps(dict(config="mesh", card=card, mesh=label, turns=turns)), flush=True)

    m, _ = run(None)
    uh, ul = dev_split_planes(u)
    logN = torch.log(torch.as_tensor(N_k, dtype=torch.float64, device=dev))
    gh, gl = dd_from_f64(torch.as_tensor(m.f_k, device=dev) + logN)
    m_k = torch.as_tensor(-m.f_k, dtype=torch.float32, device=dev)
    k5_ms = {"one call": median_ms(torch, lambda: lognum_fused_dd(uh, ul, gh, gl, m_k, return_sums=True))}
    for label, mesh in meshes.items():
        uh_s, ul_s, _ = shard_dd_planes(uh, ul, mesh)
        k5_ms[label] = median_ms(torch, lambda: sharded_fused_lognum_dd(uh_s, ul_s, gh, gl, m_k, mesh))
        del uh_s, ul_s
    del uh, ul
    print(json.dumps(dict(config="mesh", card=card, k5_ms=k5_ms)), flush=True)

    mesh4 = meshes["4 shards of cuda:0"]
    walls = {}
    walls["mbar_init_s"], m = timed(torch, lambda: MBAR(u, N_k, mesh=mesh4))
    walls["free_energies_s"], _ = timed(torch, lambda: m.compute_free_energy_differences())
    print(json.dumps(dict(config="mesh", card=card, mesh="4 shards of cuda:0", **walls,
                          **device_trace(torch, u, N_k, walls, mesh=mesh4))), flush=True)
    del u, m
    torch.cuda.empty_cache()


def profile_bootstrap(torch, card):
    """The flagship with B = 64 bootstrap replicates (see the module doc)."""
    import numpy as np

    from pymbar_tpu_torch import MBAR
    from pymbar_tpu_torch import solvers_large as sl
    from pymbar_tpu_torch.mbar import bootstrap_counts

    dev = torch.device("cuda", 0)
    B = 64
    u, N_k = oscillators(torch, *CONFIGS["flagship"][:2], dev)
    MBAR(u, N_k, n_bootstraps=B, rseed=1)  # warm-up
    turns = {"no bootstrap": [], "B = 64": []}
    for which in ("no bootstrap", "B = 64", "B = 64", "no bootstrap"):
        kw = dict(n_bootstraps=B, rseed=1) if which == "B = 64" else {}
        torch.cuda.reset_peak_memory_stats()
        t, m = timed(torch, lambda: MBAR(u, N_k, **kw))
        turns[which].append(dict(init_s=t, max_memory_allocated=torch.cuda.max_memory_allocated()))
    t0 = time.perf_counter()
    rints = m._draw_bootstrap_rints(B)
    draw_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts = bootstrap_counts(rints, m.N)
    counts_s = time.perf_counter() - t0
    print(json.dumps(dict(config="bootstrap", card=card, B=B, mbar_init_by_route=turns,
                          host_draw_s=draw_s, host_counts_s=counts_s)), flush=True)

    uh, ul = sl.dev_split_planes(u)
    hinv = m.solver_results[0]["info"]["hinv"]

    def polish(tol):
        return sl.bootstrap_polish_dd(uh, ul, N_k, m.f_k, hinv, counts, tol=tol)

    runs, f_boots = {}, {}
    for tol in (1.0e-12, 1.0e-7, 1.0e-7, 1.0e-12):
        t, (fb, nf, info) = timed(torch, lambda: polish(tol))
        f_boots[tol] = fb
        runs.setdefault(f"{tol:g}", []).append(dict(
            wall_s=t, reps_per_s=B / t, n_fail=nf, n_at_floor=info["n_at_floor"],
            fast_iters=info["fast_iters"], exact_iters_mean=float(info["exact_iters"].mean()),
            exact_iters_max=int(info["exact_iters"].max()), phase_walls=info["phase_walls"],
        ))
    print(json.dumps(dict(config="bootstrap", card=card, polish_by_tol=runs)), flush=True)

    # the exact phase alone, from the base point
    N_k64 = torch.as_tensor(np.asarray(N_k, dtype=np.float64), device=dev)
    f0 = torch.as_tensor(m.f_k, device=dev)
    C = torch.as_tensor(counts.astype(np.uint8), device=dev)
    F0 = f0[None, :].expand(B, -1).clone()
    n_chunk = sl._batch_chunk_width(*uh.shape)
    exact_only = {}
    for tol in (1.0e-12, 1.0e-7):
        t, (F, iters, _d, conv, _floor) = timed(torch, lambda: sl._polish_while_dd_batch_exact(
            uh, ul, C, N_k64, F0, f0, hinv, tol, 1.0, 16, n_chunk))
        F = F.cpu().numpy()
        exact_only[f"{tol:g}"] = dict(
            wall_s=t, iters_mean=float(iters.float().mean()), iters_max=int(iters.max()),
            all_converged=bool(conv.all()),
            max_dev_vs_two_phase=float(np.abs((F - F[:, :1]) - (f_boots[tol] - f_boots[tol][:, :1])).max()),
        )
    print(json.dumps(dict(config="bootstrap", card=card, exact_phase_only=exact_only)), flush=True)
    del C, F0
    unprofiled = runs["1e-12"][1]["wall_s"]
    print(json.dumps(dict(config="bootstrap", card=card, tol=1e-12,
                          **trace_kernels(torch, lambda: polish(1.0e-12), unprofiled))), flush=True)
    del u, m, uh, ul
    torch.cuda.empty_cache()


def profile_diagnostics(torch, card):
    from pymbar_tpu_torch import MBAR
    from pymbar_tpu_torch.ops.mbar_core import _tsqr_rows, mbar_log_W_nk
    from pymbar_tpu_torch.utils import check_w_normalized

    K, npk, _ = CONFIGS["flagship"]
    u, N_k = oscillators(torch, K, npk, "cuda")
    m = MBAR.from_solution(u, N_k, MBAR(u, N_k).f_k)
    state = {}

    def w_on_card():
        state["W"] = m._W_nk_tensor()

    steps = {
        "bar_chain_s": lambda: m._initialize_with_bar(u),
        "log_w_nk_card_s": lambda: mbar_log_W_nk(u, N_k, m.f_k),
        "log_w_nk_to_host_s": lambda: mbar_log_W_nk(u, N_k, m.f_k).cpu().numpy(),
        "n_eff_s": m.compute_effective_sample_number,
        "overlap_s": m.compute_overlap,
        "theta_svd_s": lambda: m._compute_theta_streamed("svd"),
        "theta_svd_ew_s": lambda: m._compute_theta_streamed("svd-ew"),
        "svd_w_on_card_s": w_on_card,
        "svd_check_w_normalized_s": lambda: check_w_normalized(state["W"], N_k),
        "svd_sigma_v_s": lambda: m._sigma_v(_tsqr_rows(state["W"])),
    }
    walls = {name: [] for name in steps}
    peak = {}
    for rep in range(4):
        for name, fn in steps.items():
            torch.cuda.reset_peak_memory_stats()
            wall = timed(torch, fn)[0]
            peak[name] = torch.cuda.max_memory_allocated()
            if rep:
                walls[name].append(wall)
    print(json.dumps(dict(config="diagnostics", card=card, K=K, N=K * npk, walls=walls,
                          max_memory_allocated=peak)), flush=True)
    torch.cuda.empty_cache()
    direct_s, (_U, S, _Vh) = timed(torch, lambda: torch.linalg.svd(state["W"], full_matrices=False))
    R_S = m._sigma_v(_tsqr_rows(state["W"]))[0]
    print(json.dumps(dict(config="diagnostics", card=card, direct_svd_s=direct_s,
                          sigma_max_rel_diff_qr_vs_direct=float(((R_S - S).abs() / S.max()).max()))),
          flush=True)
    del _U, S, _Vh
    torch.cuda.empty_cache()
    profile_tsqr(torch, card, state.pop("W"))
    del u, m, state
    torch.cuda.empty_cache()


def profile_tsqr(torch, card, W):
    """The R factor of W (N, K) by the whole QR and by row-block folds."""
    from pymbar_tpu_torch.ops import mbar_core

    def fold_stacked(block_bytes):
        rows = max(1, block_bytes // (8 * W.shape[1]))
        R = None
        for s in range(0, W.shape[0], rows):
            R = torch.linalg.qr(W[s:s + rows] if R is None else torch.cat([R, W[s:s + rows]]),
                                mode="r")[1]
        return R

    def fold(block_bytes):
        def run():
            old = mbar_core._CHUNK_BYTES
            mbar_core._CHUNK_BYTES = block_bytes
            try:
                return mbar_core._tsqr_rows(W)
            finally:
                mbar_core._CHUNK_BYTES = old
        return run

    variants = {"whole_qr": lambda: torch.linalg.qr(W, mode="r")[1]}
    for mb in (128, 512, 2048):
        variants[f"fold_{mb}MB"] = fold(mb * 2**20)
        variants[f"fold_stacked_{mb}MB"] = lambda b=mb * 2**20: fold_stacked(b)
    walls = {name: [] for name in variants}
    peak = {}
    resident = torch.cuda.memory_allocated()
    R_ref = None
    dev_sigma = {}
    for rep in range(3):
        order = list(variants) if rep % 2 == 0 else list(reversed(variants))
        for name in order:
            torch.cuda.reset_peak_memory_stats()
            wall, R = timed(torch, variants[name])
            peak[name] = torch.cuda.max_memory_allocated() - resident
            if rep:
                walls[name].append(wall)
            S = torch.linalg.svdvals(R)
            if R_ref is None:
                R_ref = S
            dev_sigma[name] = float(((S - R_ref).abs() / R_ref.max()).max())
            del R
    print(json.dumps(dict(config="tsqr", card=card, N=W.shape[0], K=W.shape[1], walls=walls,
                          peak_above_w=peak, sigma_max_rel_diff=dev_sigma)), flush=True)


def profile_expectations(torch, card):
    import numpy as np

    from pymbar_tpu_torch import MBAR
    from pymbar_tpu_torch import mbar as tmbar
    from pymbar_tpu_torch.ops.mbar_core import mbar_gram_normalization

    saved = tmbar._AUG_STREAM_BYTES
    branches = {"materialized": 2**62, "streamed": 0}
    try:
        for K, npk in ((128, 8), (512, 4), (1024, 2), (1024, 12), (1024, 122)):
            u, N_k, x = oscillators(torch, K, npk, "cuda", with_x=True)
            m = MBAR.from_solution(u, N_k, MBAR(u, N_k).f_k)
            calls = {"expectations": lambda: m.compute_expectations(x),
                     "entropy": m.compute_entropy_and_enthalpy}
            walls, peak = {}, {}
            for call, fn in calls.items():
                # one warm-up of each branch, then the turns M S S M
                turns = ("materialized", "streamed") * 2 + ("streamed", "materialized")
                for i, branch in enumerate(turns):
                    tmbar._AUG_STREAM_BYTES = branches[branch]
                    torch.cuda.reset_peak_memory_stats()
                    wall = timed(torch, fn)[0]
                    if i >= 2:
                        walls.setdefault(f"{call}_{branch}_s", []).append(wall)
                    peak[f"{call}_{branch}"] = torch.cuda.max_memory_allocated()
            print(json.dumps(dict(config="expectations_route_gate", card=card, K=K, N=K * npk,
                                  u_kn_bytes=u.nbytes, walls=walls, max_memory_allocated=peak)),
                  flush=True)
            del u, m, x
            torch.cuda.empty_cache()
    finally:
        tmbar._AUG_STREAM_BYTES = saved

    # the flagship's two calls and their steps, by the streamed branch
    K = 1024
    u, N_k, x = oscillators(torch, K, 976, "cuda", with_x=True)
    m = MBAR.from_solution(u, N_k, MBAR(u, N_k).f_k)
    K_ = m.K
    ident = np.vstack([np.arange(K_), np.arange(K_)])
    row = np.zeros((2, K_), int)
    row[0] = np.arange(K_)
    eps4 = 4.0 * np.finfo(np.float64).eps
    x_min = float(x.min())
    x_shift = x_min - abs(eps4 * x_min)
    a_row = (x - x_shift).reshape(1, -1)
    u_min = u.amin(dim=1).cpu().numpy()
    u_shift = u_min - np.abs(eps4 * u_min)
    u_shift_t = torch.as_tensor(u_shift, device=u.device)
    N_aug = np.concatenate([m.N_k, np.zeros(2 * K_)])
    state = {}

    def pass_a(A_n, state_map, a_shift):
        state["f"] = m._expectations_streamed(A_n, u, state_map, K_, K_, None, False,
                                              u_ln_alias=True, a_shift=a_shift)[0]

    def pass_b(observable):
        state["b"] = mbar_gram_normalization(u, m.N_k, m.f_k, observable=observable)

    def theta():
        f = state["f"]
        log_C, f_sa = f[K_ : 2 * K_], f[2 * K_ :]
        M0, _c0, _rows, (M1, M2, _cA) = state["b"]
        gram = tmbar._assemble_struct_gram(M0, M1, M2, np.exp(log_C - m.f_k),
                                           np.exp(f_sa + log_C - m.f_k), np.arange(K_))
        state["theta"] = m._theta_from_gram(gram, N_aug, "svd-ew")

    def sigmas():
        a = np.exp(-state["f"][2 * K_ :])
        th = state["theta"]
        idx = torch.as_tensor(np.concatenate([2 * K_ + np.arange(K_), K_ + np.arange(K_)]),
                              device=th.device)
        th2 = th.index_select(0, idx).index_select(1, idx)
        return [m._ErrorOfDifferences(c) for c in m._entropy_sigmas(th2, a)]

    steps = {
        "a_compute_expectations_s": lambda: m.compute_expectations(x),
        "a_pass_a_s": lambda: pass_a(a_row, row, None),
        "a_pass_b_s": lambda: pass_b(lambda c0, c1, u_c: a_row[0, c0:c1]),
        "a_assembly_and_theta_s": theta,
        "f_compute_entropy_and_enthalpy_s": m.compute_entropy_and_enthalpy,
        "f_pass_a_s": lambda: pass_a(u, ident, u_shift),
        "f_pass_b_s": lambda: pass_b(lambda c0, c1, u_c: u_c - u_shift_t[:, None]),
        "f_assembly_and_theta_s": theta,
        "f_sigmas_s": sigmas,
    }
    walls = {name: [] for name in steps}
    peak = {}
    for rep in range(4):
        for name, fn in steps.items():
            torch.cuda.reset_peak_memory_stats()
            wall = timed(torch, fn)[0]
            peak[name] = torch.cuda.max_memory_allocated()
            if rep:
                walls[name].append(wall)
    print(json.dumps(dict(config="expectations", card=card, K=K, N=K * 976, walls=walls,
                          max_memory_allocated=peak)), flush=True)
    for name, fn in (("compute_expectations", lambda: m.compute_expectations(x)),
                     ("compute_entropy_and_enthalpy", m.compute_entropy_and_enthalpy)):
        unprofiled = sorted(walls["a_compute_expectations_s" if name == "compute_expectations"
                                  else "f_compute_entropy_and_enthalpy_s"])[1]
        print(json.dumps(dict(config="expectations", card=card, call=name,
                              **trace_kernels(torch, fn, unprofiled))), flush=True)
    del u, m, x, state
    torch.cuda.empty_cache()


def umbrella(torch, dev, KW=64, NPW=16384, K0=20.0, Ku=100.0):
    """bench.py's fes_slice configuration: 64 harmonic windows on a
    quadratic base, u_kn made on the card from the seed's x_n; with u_n,
    x_n, N_k and 100 bin edges over [min x, max x]."""
    import numpy as np

    rng = np.random.RandomState(23)
    centers = np.linspace(-3.0, 3.0, KW) * 0.2
    sigma = 1.0 / (K0 + Ku)
    x_n = (sigma * Ku * centers[:, None]
           + np.sqrt(sigma) * rng.standard_normal((KW, NPW))).reshape(-1)
    x = torch.as_tensor(x_n, device=dev)
    u = (K0 / 2.0) * x[None, :] ** 2 + (Ku / 2.0) * (
        x[None, :] - torch.as_tensor(centers, device=dev)[:, None]) ** 2
    edges = np.linspace(x_n.min() - 1e-6, x_n.max() + 1e-6, 101)
    return u, (K0 / 2.0) * x_n**2, x_n, np.full(KW, NPW), edges


def profile_fes(torch, card):
    """FES at the umbrella configuration and the flagship histogram: warm
    walls of each call and of the histogram's steps, then profiler traces."""
    import numpy as np

    from pymbar_tpu_torch import FES
    from pymbar_tpu_torch import fes as tfes

    u, u_n, x_n, N_k, edges = umbrella(torch, "cuda")
    cent = 0.5 * (edges[1:] + edges[:-1])
    hist = dict(bin_edges=edges)
    fes = FES(u, N_k)
    state = {}

    def gram():
        hd = fes.histogram_data
        state["nb"] = len(hd["bin_order"])
        state["gram"] = tfes._hist_aug_gram(
            fes.u_kn, fes.u_n, fes._bin_columns(hd), hd["f"],
            fes.mbar.states_with_samples, fes.mbar.f_k, fes.mbar.N_k, state["nb"])

    def theta():
        N_aug = np.concatenate([fes.mbar.N_k, np.zeros(state["nb"], np.int64)])
        return fes.mbar._theta_svd_ew_lowrank(state["gram"], N_aug).cpu().numpy()

    steps = {
        "fes_init_s": lambda: FES(u, N_k),
        "histogram_generate_s": lambda: fes.generate_fes(u_n, x_n, histogram_parameters=hist),
        "histogram_log_weights_s": lambda: fes._unnormalized_log_weights(None, fes.mbar.f_k),
        "histogram_bookkeeping_s": lambda: fes._generate_fes_histogram(0, x_n, fes.w_n,
                                                                       state["log_w"]),
        "histogram_get_analytical_s": lambda: fes.get_fes(
            cent, reference_point="from-lowest", uncertainty_method="analytical"),
        "histogram_streamed_gram_s": gram,
        "histogram_theta_s": theta,
        "kde_generate_and_get_s": lambda: (
            fes.generate_fes(u_n, x_n, fes_type="kde",
                             kde_parameters={"bandwidth": 0.5 * (edges[1] - edges[0])}),
            fes.get_fes(cent, reference_point="from-lowest")),
    }
    fes.generate_fes(u_n, x_n, histogram_parameters=hist)
    state["log_w"] = fes._unnormalized_log_weights(None, fes.mbar.f_k)
    walls = {name: [] for name in steps}
    for rep in range(4):
        # each histogram step reads what histogram_generate_s leaves
        for name, fn in steps.items():
            wall = timed(torch, fn)[0]
            if rep:
                walls[name].append(wall)
    print(json.dumps(dict(config="fes_umbrella", card=card, shape=list(u.shape),
                          u_kn_bytes=u.nbytes, walls=walls)), flush=True)

    def histogram_flow():
        f = FES(u, N_k)
        f.generate_fes(u_n, x_n, histogram_parameters=hist)
        return f.get_fes(cent, reference_point="from-lowest", uncertainty_method="analytical")

    unprofiled = sorted(timed(torch, histogram_flow)[0] for _ in range(3))[1]
    print(json.dumps(dict(config="fes_umbrella", card=card, call="FES + histogram (analytical)",
                          **trace_kernels(torch, histogram_flow, unprofiled))), flush=True)
    del fes, u, state
    torch.cuda.empty_cache()

    # the flagship histogram: oscillators' u_kn, target state K/2
    uf, N_kf, xf = oscillators(torch, 1024, 976, "cuda", with_x=True)
    xf_n = xf.cpu().numpy()
    uf_n = uf[uf.shape[0] // 2].cpu().numpy()
    ef = np.linspace(xf_n.min() - 1e-6, xf_n.max() + 1e-6, 101)
    cf = 0.5 * (ef[1:] + ef[:-1])

    def flagship_flow():
        f = FES(uf, N_kf)
        f.generate_fes(uf_n, xf_n, histogram_parameters=dict(bin_edges=ef))
        return f.get_fes(cf, reference_point="from-lowest", uncertainty_method="analytical")

    flag_walls = [timed(torch, flagship_flow)[0] for _ in range(4)][1:]
    print(json.dumps(dict(config="fes_flagship_histogram", card=card, shape=list(uf.shape),
                          walls=flag_walls)), flush=True)
    print(json.dumps(dict(config="fes_flagship_histogram", card=card,
                          call="FES + histogram (analytical)",
                          **trace_kernels(torch, flagship_flow, sorted(flag_walls)[1]))),
          flush=True)
    del uf, xf
    torch.cuda.empty_cache()


def profile_clusters(torch, card):
    """The cluster kernel by cluster size: occupancy, K1, K5, pinned ceiling."""
    from pymbar_tpu_torch.ops import lognum, roofline, wsum
    from pymbar_tpu_torch.ops.doubledouble import dd_from_f64

    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(8)
    for K in (1024, 2048, 4096, 8192):
        N = 2**30 // K
        uh = torch.empty((K, N), dtype=torch.float32, device=dev)
        ul = torch.empty_like(uh)
        step = 2**26 // K
        for s0 in range(0, N, step):  # u in [0, 10), made in column chunks
            uh[:, s0:s0 + step], ul[:, s0:s0 + step] = dd_from_f64(
                torch.rand((K, min(step, N - s0)), generator=gen, dtype=torch.float64,
                           device=dev).mul_(10.0))
        gh, gl = dd_from_f64(torch.randn(K, generator=gen, dtype=torch.float64, device=dev) * 0.5
                             + float(torch.log(torch.tensor(N / K))))
        m_k = torch.full((K,), -8.8, dtype=torch.float32, device=dev)
        gate = wsum._SPLIT_ROUTE_K
        wsum._SPLIT_ROUTE_K = 2**31  # K1 itself at 8192, not the split route
        try:
            calls = {"wsum_dd": lambda: wsum.wsum_dd(uh, ul, gh, gl),
                     "lognum_fused_dd": lambda: lognum.lognum_fused_dd(uh, ul, gh, gl, m_k,
                                                                       return_sums=True)}
            ms = {"wsum_dd": [], "lognum_fused_dd": []}
            for name in ("wsum_dd", "lognum_fused_dd", "lognum_fused_dd", "wsum_dd"):
                ms[name].append(median_ms(torch, calls[name]))
        finally:
            wsum._SPLIT_ROUTE_K = gate
        del uh, ul
        torch.cuda.empty_cache()
        clusters = wsum.fused_partial(K, dev).shape[0]
        C = (K + 511) // 512
        tile = 2**19 // K
        ceiling = roofline.measure_wsum_ceiling(K, tile, 2**32 // (K * tile), device=dev)
        k1 = sorted(ms["wsum_dd"])[0]
        print(json.dumps(dict(
            config="clusters", card=card, K=K, N=N, cluster_blocks=C, resident_clusters=clusters,
            sms_filled=C * clusters, sms=sms, ms=ms,
            k1_elements_per_s_per_sm=K * N / (k1 * 1e-3) / (C * clusters),
            k5_over_k1=sorted(ms["lognum_fused_dd"])[0] / k1,
            pinned_tile=[K, tile], pinned_elements_per_s=ceiling,
            pinned_ms_for_these_elements=K * N / ceiling * 1e3)), flush=True)


def profile_mesh_bootstrap(torch, card):
    """The flagship's B = 64 bootstrap on the mesh (see the module doc)."""
    import numpy as np

    from pymbar_tpu_torch import MBAR
    from pymbar_tpu_torch.mbar import bootstrap_counts
    from pymbar_tpu_torch.parallel import sharding
    from pymbar_tpu_torch.solvers_large import dev_split_planes

    dev = torch.device("cuda", 0)
    B = 64
    u, N_k = oscillators(torch, *CONFIGS["flagship"][:2], dev)
    meshes = {"4 shards of cuda:0": sharding.default_mesh(4, device="cuda:0")}
    if torch.cuda.device_count() > 1:
        meshes["every card"] = sharding.default_mesh()
    for label, mesh in meshes.items():
        MBAR(u, N_k, n_bootstraps=B, rseed=1, mesh=mesh)  # warm-up
        turns = {"one card": [], "mesh": []}
        for which in ("one card", "mesh", "mesh", "one card"):
            kw = dict(mesh=mesh) if which == "mesh" else {}
            torch.cuda.reset_peak_memory_stats()
            t, m = timed(torch, lambda: MBAR(u, N_k, n_bootstraps=B, rseed=1, **kw))
            turns[which].append(dict(init_s=t, max_memory_allocated=torch.cuda.max_memory_allocated()))
        print(json.dumps(dict(config="mesh_bootstrap", card=card, mesh=label, B=B,
                              mbar_init_by_route=turns)), flush=True)

        f_k = m.f_k
        hinv = m.solver_results[0]["info"]["hinv"]
        counts = bootstrap_counts(m.bootstrap_rints, m.N)
        uh, ul = dev_split_planes(u)
        uh_s, ul_s, _ = sharding.shard_dd_planes(uh, ul, mesh)
        del uh, ul, m
        torch.cuda.empty_cache()

        def polish():
            torch.cuda.reset_peak_memory_stats()
            t, (fb, nf, info) = timed(torch, lambda: sharding.sharded_bootstrap_polish_dd(
                uh_s, ul_s, N_k, f_k, hinv, counts, mesh))
            return dict(wall_s=t, reps_per_s=B / t, n_fail=nf, n_at_floor=info["n_at_floor"],
                        max_memory_allocated=torch.cuda.max_memory_allocated())

        resident = sharding._use_resident_th
        runs = {"resident th": [], "th recomputed": []}
        for which in ("resident th", "th recomputed", "th recomputed", "resident th"):
            if which == "th recomputed":
                sharding._use_resident_th = lambda K, N: False
            try:
                runs[which].append(polish())
            finally:
                sharding._use_resident_th = resident
        group_size = sharding._batch_group_size
        by_group = {}
        for g in (16, 32, 64, 64, 32, 16):
            sharding._batch_group_size = lambda n_boot, N, g=g: g
            try:
                by_group.setdefault(str(g), []).append(polish())
            finally:
                sharding._batch_group_size = group_size
        print(json.dumps(dict(config="mesh_bootstrap", card=card, mesh=label,
                              default_resident_th=resident(u.shape[0], u.shape[1]),
                              default_group=group_size(B, u.shape[1]), polish_by_th=runs,
                              polish_by_group=by_group)), flush=True)
        del uh_s, ul_s
        torch.cuda.empty_cache()
    del u
    torch.cuda.empty_cache()


def profile_batched_bootstrap(torch, card):
    """The batched small-problem bootstrap against the sequential route by
    size, and its chunk width (see the module doc)."""
    import numpy as np

    from pymbar_tpu_torch import MBAR
    from pymbar_tpu_torch import solvers as tsolvers
    from pymbar_tpu_torch.solvers import BOOTSTRAP_SOLVER_PROTOCOL, solve_mbar_for_all_states

    dev = torch.device("cuda", 0)
    prot = MBAR._resolve_protocol(None, BOOTSTRAP_SOLVER_PROTOCOL, 10000)
    chunks = []
    chunk_fn = tsolvers._boot_chunk

    def recorded_chunk(*a):
        chunks.append(chunk_fn(*a))
        return chunks[-1]

    def umbrella_unbiased():
        u, u_n, _x, N_k, _edges = umbrella(torch, dev)
        u = torch.cat([u, torch.as_tensor(u_n, device=u.device)[None, :]])
        return u, np.append(N_k, 0)

    cases = [
        ("16 x 3000", lambda: oscillators(torch, 16, 3000, dev), 100),
        ("64 x 2048", lambda: oscillators(torch, 64, 2048, dev), 32),
        ("128 x 2048", lambda: oscillators(torch, 128, 2048, dev), 16),
        ("umbrella 64 x 16384 + unbiased", umbrella_unbiased, 16),
        ("256 x 4096", lambda: oscillators(torch, 256, 4096, dev), 8),
        ("512 x 2048", lambda: oscillators(torch, 512, 2048, dev), 4),
        ("1024 x 1024", lambda: oscillators(torch, 1024, 1024, dev), 2),
    ]
    tsolvers._boot_chunk = recorded_chunk
    try:
        for label, make, B in cases:
            u, N_k = make()
            m = MBAR(u, N_k)
            rints = MBAR.from_solution(u, N_k, m.f_k, rseed=1)._draw_bootstrap_rints(B)
            sws = np.where(np.asarray(N_k) > 0)[0]

            def batched():
                return tsolvers.batched_bootstrap_solve(u, N_k, m.f_k, rints, min_sc_iter=0)[0]

            def sequential():
                out = np.zeros((B, len(N_k)))
                for b in range(B):
                    idx = torch.as_tensor(rints[b], device=u.device)
                    out[b] = solve_mbar_for_all_states(u.index_select(1, idx), N_k, m.f_k,
                                                       sws, prot)
                return out

            batched()  # warm-up
            turns = {"batched": [], "sequential": []}
            outs = {}
            for which in ("batched", "sequential", "sequential", "batched"):
                torch.cuda.reset_peak_memory_stats()
                t, outs[which] = timed(torch, batched if which == "batched" else sequential)
                turns[which].append(dict(wall_s=t, reps_per_s=B / t,
                                         max_memory_allocated=torch.cuda.max_memory_allocated()))
            print(json.dumps(dict(
                config="batched_bootstrap", card=card, case=label, u_kn_bytes=u.nbytes, B=B,
                chunk_from_free_memory=chunks[-1], walls=turns,
                max_dev_batched_vs_sequential=float(np.abs(outs["batched"] - outs["sequential"]).max()),
            )), flush=True)
            if label.startswith("umbrella"):
                one = rints[:2]
                traces = dict(
                    batched_chunk1=trace_kernels(torch, lambda: tsolvers.batched_bootstrap_solve(
                        u, N_k, m.f_k, one, min_sc_iter=0, chunk_bytes=1), float("nan")),
                    sequential=trace_kernels(torch, lambda: [solve_mbar_for_all_states(
                        u.index_select(1, torch.as_tensor(r, device=u.device)), N_k, m.f_k, sws,
                        prot) for r in one], float("nan")),
                )
                print(json.dumps(dict(config="batched_bootstrap", card=card, case=label,
                                      two_replicates_traces=traces)), flush=True)
                by_chunk = {}
                for c in (1, 2, 4, 8, 16):
                    per = tsolvers._BOOT_BYTES_PER_MATRIX * 8 * u.numel()
                    torch.cuda.reset_peak_memory_stats()
                    t, _fb = timed(torch, lambda: tsolvers.batched_bootstrap_solve(
                        u, N_k, m.f_k, rints, min_sc_iter=0, chunk_bytes=c * per))
                    by_chunk[str(c)] = dict(wall_s=t, reps_per_s=B / t,
                                            max_memory_allocated=torch.cuda.max_memory_allocated())
                print(json.dumps(dict(config="batched_bootstrap", card=card, case=label,
                                      by_chunk=by_chunk)), flush=True)
            del u, m
            torch.cuda.empty_cache()
    finally:
        tsolvers._boot_chunk = chunk_fn

    # the batched Gram W W^T of every replicate: one bmm, a matmul per
    # replicate, or a bmm over 16,384-column blocks summed
    grams = {}
    for B, K, N in ((100, 16, 48000), (10, 65, 2**20), (2, 256, 2**20), (1, 512, 2**20)):
        W = torch.rand((B, K, N), dtype=torch.float64, device=dev)
        w_blk = 16384

        def blocked():
            nb = N // w_blk
            Wb = W[:, :, : nb * w_blk].reshape(B, K, nb, w_blk).transpose(1, 2)
            g = (Wb @ Wb.mT).sum(dim=1)
            if nb * w_blk < N:
                g += W[:, :, nb * w_blk:] @ W[:, :, nb * w_blk:].mT
            return g

        forms = dict(bmm=lambda: W @ W.mT,
                     per_replicate=lambda: torch.stack([w @ w.T for w in W]),
                     blocked=blocked)
        grams[f"{B}x{K}x{N}"] = {name: median_ms(torch, fn) for name, fn in forms.items()}
        del W
        torch.cuda.empty_cache()
    print(json.dumps(dict(config="batched_bootstrap", card=card, gram_ms=grams)), flush=True)


def profile_boot_budgets(torch, card):
    """The bootstrap engine's per-card budgets on one card: the counts
    group at the flagship with B = 256 (groups of 64, 128 and 256), and the
    resident fast plane at K = 1024 x 2,500 samples per state (N =
    2,560,000; 21 GB of u_kn, planes + th 30.7 GB), resident against
    recomputed, B = 64."""
    import numpy as np

    from pymbar_tpu_torch import MBAR
    from pymbar_tpu_torch import solvers_large as sl
    from pymbar_tpu_torch.mbar import bootstrap_counts

    dev = torch.device("cuda", 0)
    for K, npk, B, knob, values in ((1024, 976, 256, "group", (64, 128, 256, 256, 128, 64)),
                                    (1024, 2500, 64, "th", (True, False, False, True))):
        u, N_k = oscillators(torch, K, npk, dev)
        m = MBAR(u, N_k)
        rints = MBAR.from_solution(u, N_k, m.f_k, rseed=1)._draw_bootstrap_rints(B)
        counts = bootstrap_counts(rints, m.N)
        uh, ul = sl.dev_split_planes(u)
        hinv = m.solver_results[0]["info"]["hinv"]
        del u
        torch.cuda.empty_cache()
        runs = {}
        group_size, resident = sl._batch_group_size, sl._use_resident_th
        for v in values:
            if knob == "group":
                sl._batch_group_size = lambda n_boot, N, v=v: v
            else:
                sl._use_resident_th = lambda K_, N_, v=v: v
            try:
                torch.cuda.reset_peak_memory_stats()
                t, (fb, nf, info) = timed(torch, lambda: sl.bootstrap_polish_dd(
                    uh, ul, N_k, m.f_k, hinv, counts))
            finally:
                sl._batch_group_size, sl._use_resident_th = group_size, resident
            runs.setdefault(str(v), []).append(dict(
                wall_s=t, reps_per_s=B / t, n_fail=nf, phase_walls=info["phase_walls"],
                max_memory_allocated=torch.cuda.max_memory_allocated()))
        print(json.dumps(dict(config="boot_budgets", card=card, K=K, N=m.N, B=B, knob=knob,
                              default_group=group_size(B, m.N),
                              default_resident_th=resident(K, m.N), runs=runs)), flush=True)
        del uh, ul, m
        torch.cuda.empty_cache()


def profile_host(torch, card):
    """The flagship with u_kn in host memory against the resident route."""
    from pymbar_tpu_torch import MBAR
    from pymbar_tpu_torch.ops.mbar_core import stream_columns

    dev = torch.device("cuda", 0)
    u, N_k, x = oscillators(torch, *CONFIGS["flagship"][:2], dev, with_x=True)
    u_host = u.cpu()
    sources = {"resident": u, "host": u_host}

    def run(route):
        """Walls and peaks above resident of MBAR, free energies and
        expectations on ``route``'s u_kn."""
        out = {}
        resident = torch.cuda.memory_allocated()
        steps = (("mbar_init", lambda: MBAR(sources[route], N_k, device="cuda")),
                 ("free_energies", lambda: m.compute_free_energy_differences()),
                 ("expectations", lambda: m.compute_expectations(x)))
        m = None
        for name, fn in steps:
            torch.cuda.reset_peak_memory_stats()
            out[f"{name}_s"], res = timed(torch, fn)
            out[f"{name}_peak_above_resident"] = torch.cuda.max_memory_allocated() - resident
            if m is None:
                m = res
        return out

    for route in ("resident", "host"):
        run(route)  # warm-up
    turns = {"resident": [], "host": []}
    for route in ("resident", "host", "host", "resident"):
        turns[route].append(run(route))
    print(json.dumps(dict(config="host", card=card, u_kn_bytes=u.nbytes, turns=turns)), flush=True)

    pinned = torch.empty(2**26, dtype=torch.float64, pin_memory=True)
    on_card = torch.empty(2**26, dtype=torch.float64, device=dev)
    h2d_ms = median_ms(torch, lambda: on_card.copy_(pinned, non_blocking=True))
    del pinned, on_card
    passes = {}
    for name, src in (("pageable", u_host), ("pinned", u_host.pin_memory())):
        walls = []
        for _ in range(3):
            wall, _ = timed(torch, lambda: [None for _c in stream_columns(src, dev)])
            walls.append(wall)
        passes[name] = dict(walls_s=walls, gb_per_s=u.nbytes / min(walls) / 1e9)
        del src
    print(json.dumps(dict(config="host", card=card, pinned_h2d_gb_per_s=2**29 / (h2d_ms * 1e-3) / 1e9,
                          streamed_pass=passes)), flush=True)
    del u
    torch.cuda.empty_cache()
    def both():
        return MBAR(u_host, N_k, device="cuda").compute_free_energy_differences()

    wall, _ = timed(torch, both)
    print(json.dumps(dict(config="host", card=card, **trace_kernels(torch, both, wall))), flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    extra = {"mesh": profile_mesh, "bootstrap": profile_bootstrap, "diagnostics": profile_diagnostics,
             "expectations": profile_expectations, "clusters": profile_clusters,
             "fes": profile_fes, "mesh_bootstrap": profile_mesh_bootstrap,
             "batched_bootstrap": profile_batched_bootstrap, "boot_budgets": profile_boot_budgets,
             "host": profile_host}
    names = sys.argv[1:] or [*CONFIGS, *extra]
    unknown = [n for n in names if n not in CONFIGS and n not in extra]
    if unknown:
        raise SystemExit(f"unknown configuration(s) {unknown}; choose from {[*CONFIGS, *extra]}")
    sys.path.insert(0, REPO)
    from pymbar_tpu_torch.ops import _build

    for lib in ("wsum", "wsum_split", "lognum", "roofline"):  # build outside every timed region
        _build.load(lib)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    for name in names:
        if name in extra:
            extra[name](torch, card)
        else:
            profile_config(torch, name, card)


if __name__ == "__main__":
    main()
