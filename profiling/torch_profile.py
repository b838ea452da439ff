#!/usr/bin/env python3
"""Where the time goes in the PyTorch port, on one CUDA card.

    python3 profiling/torch_profile.py [flagship] [slice] [mesh] [bootstrap] [diagnostics]
                                       [expectations]

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
  device time per kernel name (top 15), and the device-busy share of the
  unprofiled wall of the same work.

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
``MBAR._svd_sigma_v``: the QR of W and the SVD of R); then
``torch.linalg.svd`` of W once, the direct factorization the QR route
stands in for.

``expectations`` measures ``mbar._AUG_STREAM_BYTES``: at (K, samples per
state) = (128, 8), (512, 4), (1024, 2), (1024, 12) and (1024, 122) (1.05
MB, 8.4 MB, 16.8 MB, 101 MB and 1.02 GB of u_kn), ``compute_expectations(x)`` and ``compute_entropy_and_enthalpy()`` by the
materializing and by the streamed branch in turns (materialized, streamed,
streamed, materialized, after one warm-up of each), with their peak
memory.  Then, at the flagship, the walls of those two calls and of their
steps, three times each after one warm-up: pass A alone, pass B (the
structured Gram pass), the Gram assembly and the rank-nnz Theta, and for
entropy the three sigma matrices; and one profiler trace of each call.
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
    """Device time per kernel over one MBAR + free energies, and the
    device-busy share of the unprofiled wall of the same work."""
    from pymbar_tpu_torch import MBAR

    return trace_kernels(
        torch, lambda: MBAR(u, N_k, mesh=mesh).compute_free_energy_differences(),
        walls["mbar_init_s"] + walls["free_energies_s"],
    )


def trace_kernels(torch, fn, unprofiled):
    """Device time per kernel over one call of ``fn``, and the device-busy
    share of ``unprofiled``, the unprofiled wall of the same work (the
    profiler slows the host side)."""
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
    # their kernels twice)
    kernels = [
        (e.key, dev_us(e), e.count) for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0
    ]
    kernels.sort(key=lambda t: -t[1])
    busy_s = sum(t[1] for t in kernels) / 1e6
    return dict(
        profiled_wall_s=wall, unprofiled_wall_s=unprofiled, device_busy_s=busy_s,
        device_idle_share=1.0 - busy_s / unprofiled,
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
    from pymbar_tpu_torch.ops.mbar_core import mbar_log_W_nk
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
        "svd_sigma_v_s": lambda: m._svd_sigma_v(state["W"]),
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
    R_S = m._svd_sigma_v(state["W"])[0]
    print(json.dumps(dict(config="diagnostics", card=card, direct_svd_s=direct_s,
                          sigma_max_rel_diff_qr_vs_direct=float(((R_S - S).abs() / S.max()).max()))),
          flush=True)
    del u, m, state, _U, S, _Vh
    torch.cuda.empty_cache()


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


def main():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    extra = {"mesh": profile_mesh, "bootstrap": profile_bootstrap, "diagnostics": profile_diagnostics,
             "expectations": profile_expectations}
    names = sys.argv[1:] or [*CONFIGS, *extra]
    unknown = [n for n in names if n not in CONFIGS and n not in extra]
    if unknown:
        raise SystemExit(f"unknown configuration(s) {unknown}; choose from {[*CONFIGS, *extra]}")
    sys.path.insert(0, REPO)
    from pymbar_tpu_torch.ops import _build

    for lib in ("wsum", "wsum_split", "lognum"):  # build outside every timed region
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
