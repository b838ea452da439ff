#!/usr/bin/env python3
"""Smoke run of the PyTorch port (pymbar_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero.

0. The card's name and power limit (nvidia-smi); build csrc/wsum.cu and
   csrc/wsum_split.cu with nvcc, in parallel.
1. Each kernel against its plain PyTorch version on the same CUDA tensors.
   K1 wsum_dd: relative error of S <= 1e-13 at several shapes, pad columns
   change nothing, an all-pad matrix gives S == 0 exactly, the launch count
   rises; times at the flagship shape.  The many-state route (column shift,
   K3 denom_sums_dd, K4 wsum_denom_dd): the shift exact, s and S <= 1e-13
   at (8192, 65536) with and without counts, (5000, 1000), (1, 1) and the
   slice's (8192, 327680); wsum_dd's split route against K1 on the same
   planes; appended pad columns, an all-pad matrix, the launch counts;
   times of each kernel, of the split route and of K1 at the slice's shape.
   Times are medians of 5 synchronize-fenced calls.
2. The main path at full size: the flagship problem of bench.py (K = 1024
   harmonic-oscillator states x 976 samples, ~8 GB of float64 u_kn) made
   on the card from a seed, then MBAR(u_kn, N_k) with the default protocol
   and compute_free_energy_differences().  It must take the dd route
   through K1, converge (gradient norm / N <= 1e-11), agree with the
   analytic free energies (|z| < 6), lie within 1e-8 of an explicit float64
   adaptive solve, and its Theta (rank-nnz, on the card) must match the
   dense host Theta of the same Gram (rtol 1e-8, atol 1e-12 max|Theta|).
3. The many-state slice: K = 8192 oscillator states x 40 samples (N =
   327,680, 21.5 GB of float64 u_kn) through MBAR and the free energies.
   It must take the dd route with every polish iteration on the split
   route and no K1 launch, reach gradient norm / N <= 1e-11 by the
   solver's and by a plain float64 evaluation, lie within 1e-10 in
   Delta_f of a dd solve of the same planes through K1, and give |z| < 6
   and a finite dDelta_f.

Then the card, the kernels line and {"ok": true, "device": {...}} close the
output.  Without a CUDA card, or without the repository beside this file,
it exits non-zero and prints no result.  Imports nothing of JAX.
"""

import concurrent.futures
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
FLAGSHIP_K = 1024
FLAGSHIP_NPK = 976
SLICE_K = 8192
SLICE_NPK = 40
S_REL_TOL = 1.0e-13
SOURCES = ("wsum", "wsum_split")

# Lower bounds of a kernel's time: HBM3 at 3.35 TB/s and the H100 SXM's
# vector peaks (NVIDIA data sheet, 700 W): 67 TFLOP/s float32, 34 TFLOP/s
# float64.  Operations are counted as one per add, subtract, max, multiply,
# divide and exp (an exp costs ~20 FP64 instructions, so the op bound is an
# underestimate; it stays below the byte bound either way).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg):
    raise RuntimeError(msg)


def rel_err(S, S_ref):
    return float(((S - S_ref).abs() / S_ref.abs().clamp_min(1e-300)).max())


def bound(read_bytes, write_bytes, ops, ops_per_s):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and ops over peak."""
    t_bytes = (read_bytes + write_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def make_planes(torch, K, N, gen, dev):
    """Random dd planes of u in [0, 10) and g = f + ln(N/K), from a generator,
    filled column chunk by column chunk (no full-size float64 temporary)."""
    from pymbar_tpu_torch.ops.doubledouble import dd_from_f64

    uh = torch.empty((K, N), dtype=torch.float32, device=dev)
    ul = torch.empty((K, N), dtype=torch.float32, device=dev)
    width = max(1, 2**26 // K)
    for s in range(0, N, width):
        e = min(N, s + width)
        u = torch.rand((K, e - s), generator=gen, dtype=torch.float64, device=dev).mul_(10.0)
        uh[:, s:e], ul[:, s:e] = dd_from_f64(u)
    f = torch.randn(K, generator=gen, dtype=torch.float64, device=dev) * 0.5
    gh, gl = dd_from_f64(f + torch.log(torch.tensor(N / K, dtype=torch.float64)))
    return uh, ul, gh, gl


def oscillators(torch, K, npk, gen, dev):
    """u_kn of K harmonic oscillators (O = linspace(0, 5), K_f =
    linspace(1, 3)), npk samples from each, made on the card; with the
    analytic f_k - f_0."""
    N = K * npk
    O = torch.linspace(0.0, 5.0, K, dtype=torch.float64, device=dev)
    Kf = torch.linspace(1.0, 3.0, K, dtype=torch.float64, device=dev)
    z = torch.randn((K, npk), generator=gen, dtype=torch.float64, device=dev)
    x = (O[:, None] + z / torch.sqrt(Kf)[:, None]).reshape(-1)
    del z
    u_kn = torch.empty((K, N), dtype=torch.float64, device=dev)
    step = max(1, 2**26 // K)
    for s in range(0, N, step):
        u_kn[:, s : s + step] = 0.5 * Kf[:, None] * (x[None, s : s + step] - O[:, None]) ** 2
    fa = (-0.5 * torch.log(2 * torch.pi / Kf)).cpu().numpy()
    return u_kn, [npk] * K, fa - fa[0]


def median_ms(torch, fn, reps=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def max_abs_z(res, fa):
    """max |z| of Delta_f[0] against the analytic free energies (nan when
    any z is not finite)."""
    import numpy as np

    z = (res["Delta_f"][0, 1:] - fa[1:]) / res["dDelta_f"][0, 1:]
    return float(np.abs(z).max()) if np.isfinite(z).all() else float("nan")


def check_free_energies(res, z, label):
    import numpy as np

    if not z < 6:
        fail(f"{label}: |z| >= 6 against the analytic free energies: max {z:.3f}")
    if not np.isfinite(res["dDelta_f"]).all():
        fail(f"{label}: dDelta_f is not finite")


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA card")
    if not os.path.isdir(os.path.join(REPO, "pymbar_tpu_torch")):
        fail(f"pymbar_tpu_torch/ not found beside {__file__}")
    sys.path.insert(0, REPO)
    import numpy as np

    from pymbar_tpu_torch import MBAR
    from pymbar_tpu_torch.ops import _build, wsum, wsum_split
    from pymbar_tpu_torch.ops.doubledouble import dd_to_f64
    from pymbar_tpu_torch.ops.mbar_core import mbar_gradient, mbar_gram_normalization
    from pymbar_tpu_torch.solvers_large import dev_split_planes, solve_mbar_dd

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- phase 0: card and build (one nvcc per source, all at once)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        lib_paths = dict(zip(SOURCES, pool.map(_build.build, SOURCES)))
    for name in SOURCES:
        _build.load(name)
    build_s = time.perf_counter() - t0
    ptxas = {
        name: [line.strip() for line in (_build._BUILD / f"{name}.log").read_text().splitlines()
               if "Function properties" in line or "Used" in line or "spill" in line]
        for name in SOURCES
    }
    emit(
        "0_build", card=smi, torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0), build_s=build_s,
        libraries={k: os.path.relpath(v, REPO) for k, v in lib_paths.items()}, ptxas=ptxas,
    )

    # ---- phase 1a: K1 against its plain version on the card
    gen = torch.Generator(device=dev).manual_seed(SEED)
    err = {"wsum_dd": 0.0, "column_shift": 0.0, "denom_sums_dd": 0.0, "wsum_denom_dd": 0.0}
    checks = []

    def compare(label, uh, ul, gh, gl, c=None):
        before = wsum.WSUM_LAUNCHES
        S = dd_to_f64(*wsum.wsum_dd(uh, ul, gh, gl, c))
        torch.cuda.synchronize()
        if wsum.WSUM_LAUNCHES != before + 1:
            fail(f"{label}: WSUM_LAUNCHES did not rise")
        S_ref = dd_to_f64(*wsum.wsum_dd_plain(uh, ul, gh, gl, c))
        e = rel_err(S, S_ref)
        err["wsum_dd"] = max(err["wsum_dd"], float((S - S_ref).abs().max()))
        checks.append(dict(kernel="wsum_dd", case=label, K=uh.shape[0], N=uh.shape[1], rel_err=e))
        if not e <= S_REL_TOL:
            fail(f"{label}: kernel vs plain relative error {e:.3e} > {S_REL_TOL:g}")
        return S

    uh, ul, gh, gl = make_planes(torch, 1024, 65536, gen, dev)
    compare("1024x65536", uh, ul, gh, gl)
    c = torch.randint(0, 4, (65536,), generator=gen, device=dev).to(torch.float32)
    compare("1024x65536 counts", uh, ul, gh, gl, c)
    compare("3x1000 ragged", *make_planes(torch, 3, 1000, gen, dev))
    compare("4096x8192", *make_planes(torch, 4096, 8192, gen, dev))
    uh, ul, gh, gl = make_planes(torch, 1024, 4096, gen, dev)
    S0 = compare("1024x4096", uh, ul, gh, gl)
    uhp = torch.cat([uh, torch.full((1024, 77), 1.0e10, dtype=torch.float32, device=dev)], 1)
    ulp = torch.cat([ul, torch.zeros((1024, 77), dtype=torch.float32, device=dev)], 1)
    S1 = compare("1024x4096 + 77 pad columns", uhp.contiguous(), ulp.contiguous(), gh, gl)
    if rel_err(S1, S0) > S_REL_TOL:
        fail("pad columns changed S")
    pad_only = torch.full((1024, 300), 1.0e10, dtype=torch.float32, device=dev)
    S_pad = dd_to_f64(*wsum.wsum_dd(pad_only, torch.zeros_like(pad_only), gh, gl))
    if not bool((S_pad == 0).all()):
        fail("an all-pad matrix gave S != 0")
    del uh, ul, uhp, ulp, pad_only

    N_flag = FLAGSHIP_K * FLAGSHIP_NPK
    planes = make_planes(torch, FLAGSHIP_K, N_flag, gen, dev)
    compare(f"{FLAGSHIP_K}x{N_flag} flagship shape", *planes)
    times = {"wsum_dd": (median_ms(torch, lambda: wsum.wsum_dd(*planes)),
                         median_ms(torch, lambda: wsum.wsum_dd_plain(*planes)))}
    del planes
    torch.cuda.empty_cache()
    emit("1_kernel", checks=checks, max_abs_err=err["wsum_dd"], kernel_ms=times["wsum_dd"][0],
         plain_ms=times["wsum_dd"][1], shape=[FLAGSHIP_K, N_flag])

    # ---- phase 1b: the many-state route's kernels against their plain versions
    split_checks = []
    counters = ("SHIFT_LAUNCHES", "DENOM_SUMS_LAUNCHES", "WSUM_DENOM_LAUNCHES")

    def split_steps(uh, ul, gh, gl, c):
        """The route's steps by the kernels: m, the denominators, the masked
        denominators K4 takes, and S."""
        m = wsum_split.column_shift(uh, gh)
        d = wsum_split.denom_sums_dd(uh, ul, gh, gl, m)
        pad = m < wsum._PAD_M
        d_masked = (d[0].masked_fill(pad, 0.0), d[1].masked_fill(pad, 0.0))
        return m, d, d_masked, wsum_split.wsum_denom_dd(uh, ul, gh, gl, m, *d_masked, c)

    def compare_split(label, uh, ul, gh, gl, c=None):
        before = [getattr(wsum_split, n) for n in counters]
        m, d, d_masked, S = split_steps(uh, ul, gh, gl, c)
        torch.cuda.synchronize()
        if [getattr(wsum_split, n) for n in counters] != [b + 1 for b in before]:
            fail(f"{label}: a split-route launch count did not rise")
        # each plain version on the kernel's own inputs
        m_ref = wsum_split.column_shift_plain(uh, gh)
        s = dd_to_f64(*d)
        s_ref = dd_to_f64(*wsum_split.denom_sums_dd_plain(uh, ul, gh, gl, m))
        S = dd_to_f64(*S)
        S_ref = dd_to_f64(*wsum_split.wsum_denom_dd_plain(uh, ul, gh, gl, m, *d_masked, c))
        e = dict(column_shift=float((m - m_ref).abs().max()), denom_sums_dd=rel_err(s, s_ref),
                 wsum_denom_dd=rel_err(S, S_ref))
        err["column_shift"] = max(err["column_shift"], e["column_shift"])
        err["denom_sums_dd"] = max(err["denom_sums_dd"], float((s - s_ref).abs().max()))
        err["wsum_denom_dd"] = max(err["wsum_denom_dd"], float((S - S_ref).abs().max()))
        split_checks.append(dict(case=label, K=uh.shape[0], N=uh.shape[1], **e))
        if e["column_shift"] != 0.0:
            fail(f"{label}: column_shift differs from its plain version")
        if not (e["denom_sums_dd"] <= S_REL_TOL and e["wsum_denom_dd"] <= S_REL_TOL):
            fail(f"{label}: split kernels vs plain {e} > {S_REL_TOL:g}")
        return S

    def route_vs_k1(label, *planes):
        """wsum_dd's split route against K1 on the same planes."""
        S_split = dd_to_f64(*wsum.split_route(*planes))
        gate = wsum._SPLIT_ROUTE_K
        wsum._SPLIT_ROUTE_K = 2**31
        try:
            S_k1 = dd_to_f64(*wsum.wsum_dd(*planes))
        finally:
            wsum._SPLIT_ROUTE_K = gate
        e = rel_err(S_split, S_k1)
        split_checks.append(dict(case=f"{label}: split route vs K1", rel_err=e))
        if not e <= S_REL_TOL:
            fail(f"{label}: split route vs K1 relative error {e:.3e}")

    uh, ul, gh, gl = make_planes(torch, SLICE_K, 65536, gen, dev)
    compare_split(f"{SLICE_K}x65536", uh, ul, gh, gl)
    c = torch.randint(0, 4, (65536,), generator=gen, device=dev).to(torch.float32)
    compare_split(f"{SLICE_K}x65536 counts", uh, ul, gh, gl, c)
    route_vs_k1(f"{SLICE_K}x65536 counts", uh, ul, gh, gl, c)
    compare_split("5000x1000 ragged", *make_planes(torch, 5000, 1000, gen, dev))
    compare_split("1x1", *make_planes(torch, 1, 1, gen, dev))
    uh, ul, gh, gl = make_planes(torch, SLICE_K, 4096, gen, dev)
    S0 = dd_to_f64(*wsum.wsum_dd(uh, ul, gh, gl))
    uhp = torch.cat([uh, torch.full((SLICE_K, 77), 1.0e10, dtype=torch.float32, device=dev)], 1)
    ulp = torch.cat([ul, torch.zeros((SLICE_K, 77), dtype=torch.float32, device=dev)], 1)
    S1 = compare_split(f"{SLICE_K}x4096 + 77 pad columns", uhp, ulp, gh, gl)
    if rel_err(S1, S0) > S_REL_TOL or rel_err(dd_to_f64(*wsum.wsum_dd(uhp, ulp, gh, gl)), S0) > S_REL_TOL:
        fail("pad columns changed S on the split route")
    pad_only = torch.full((SLICE_K, 300), 1.0e10, dtype=torch.float32, device=dev)
    if not bool((dd_to_f64(*wsum.wsum_dd(pad_only, torch.zeros_like(pad_only), gh, gl)) == 0).all()):
        fail("an all-pad matrix gave S != 0 on the split route")
    del uh, ul, uhp, ulp, pad_only, c
    torch.cuda.empty_cache()

    N_slice = SLICE_K * SLICE_NPK
    planes = make_planes(torch, SLICE_K, N_slice, gen, dev)
    compare_split(f"{SLICE_K}x{N_slice} slice shape", *planes)
    route_vs_k1(f"{SLICE_K}x{N_slice} slice shape", *planes)
    uh, ul, gh, gl = planes
    m, _, (dh, dl), _ = split_steps(uh, ul, gh, gl, None)
    times["column_shift"] = (median_ms(torch, lambda: wsum_split.column_shift(uh, gh)),
                             median_ms(torch, lambda: wsum_split.column_shift_plain(uh, gh)))
    times["denom_sums_dd"] = (
        median_ms(torch, lambda: wsum_split.denom_sums_dd(uh, ul, gh, gl, m)),
        median_ms(torch, lambda: wsum_split.denom_sums_dd_plain(uh, ul, gh, gl, m)))
    times["wsum_denom_dd"] = (
        median_ms(torch, lambda: wsum_split.wsum_denom_dd(uh, ul, gh, gl, m, dh, dl)),
        median_ms(torch, lambda: wsum_split.wsum_denom_dd_plain(uh, ul, gh, gl, m, dh, dl)))
    route_ms = median_ms(torch, lambda: wsum.split_route(*planes))
    gate = wsum._SPLIT_ROUTE_K
    wsum._SPLIT_ROUTE_K = 2**31
    try:
        k1_slice_ms = median_ms(torch, lambda: wsum.wsum_dd(*planes))
    finally:
        wsum._SPLIT_ROUTE_K = gate
    del planes, uh, ul, gh, gl, m, dh, dl
    torch.cuda.empty_cache()
    emit("1_split_kernels", checks=split_checks,
         max_abs_err={k: err[k] for k in ("column_shift", "denom_sums_dd", "wsum_denom_dd")},
         shape=[SLICE_K, N_slice],
         ms={k: times[k][0] for k in ("column_shift", "denom_sums_dd", "wsum_denom_dd")},
         plain_ms={k: times[k][1] for k in ("column_shift", "denom_sums_dd", "wsum_denom_dd")},
         split_route_ms=route_ms, k1_ms=k1_slice_ms)

    # ---- phase 2: the main path at full size (K1 route, Theta on the card)
    u_kn, N_k, fa = oscillators(torch, FLAGSHIP_K, FLAGSHIP_NPK, gen, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    wsum.WSUM_LAUNCHES = 0
    for n in counters:
        setattr(wsum_split, n, 0)
    t0 = time.perf_counter()
    mbar = MBAR(u_kn, N_k)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    flag_launches = wsum.WSUM_LAUNCHES
    flag_split = [getattr(wsum_split, n) for n in counters]
    t0 = time.perf_counter()
    res = mbar.compute_free_energy_differences()
    torch.cuda.synchronize()
    theta_s = time.perf_counter() - t0
    peak_bytes = torch.cuda.max_memory_allocated()

    route = mbar.solver_protocol[0]["method"]
    info = mbar.solver_results[0]["info"] if route == "dd" else {}
    gnorm_per_n = info.get("gnorm", float("nan")) / N_flag
    summary = dict(
        route=route, wsum_launches=flag_launches, split_launches=flag_split, init_s=init_s,
        theta_s=theta_s, phase1_s=info.get("phase1_s"), phase2_s=info.get("phase2_s"),
        f32_coarse_iterations=info.get("f32_coarse_iterations"),
        polish_iterations=info.get("polish_iterations"), deltas=info.get("deltas"),
        converged=info.get("converged"), at_noise_floor=info.get("at_noise_floor"),
        gradient_norm_per_sample=gnorm_per_n, max_memory_allocated=peak_bytes,
        max_abs_z=max_abs_z(res, fa),
    )

    gram, _, _ = mbar_gram_normalization(mbar.u_kn, mbar.N_k, mbar.f_k)
    t0 = time.perf_counter()
    theta_dev = MBAR._theta_svd_ew_lowrank(gram, mbar.N_k).cpu().numpy()
    lowrank_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    theta_host = MBAR._theta_svd_ew_from_gram(gram.cpu().numpy(), mbar.N_k)
    dense_host_s = time.perf_counter() - t0
    scale = float(np.abs(theta_host).max())
    theta_err = float(np.abs(theta_dev - theta_host).max())
    summary.update(theta_lowrank_card_s=lowrank_s, theta_dense_host_s=dense_host_s,
                   theta_max_abs_diff=theta_err, theta_scale=scale)
    emit("2_main_path", **summary)
    if route != "dd" or flag_launches <= 0 or any(flag_split):
        fail(f"the flagship did not take the dd route through K1 alone ({summary})")
    if not info["converged"] or not gnorm_per_n <= 1.0e-11:
        fail(f"dd solve not converged: gnorm/N = {gnorm_per_n:.3e}")
    check_free_energies(res, summary["max_abs_z"], "flagship")
    np.testing.assert_allclose(theta_dev, theta_host, rtol=1e-8, atol=1e-12 * scale)
    del gram, theta_dev, theta_host

    t0 = time.perf_counter()
    ref = MBAR(u_kn, N_k, maximum_iterations=60, solver_protocol=(dict(method="adaptive"),))
    torch.cuda.synchronize()
    adaptive_s = time.perf_counter() - t0
    vs_f64 = float(abs(ref.f_k - mbar.f_k).max())
    emit("2_vs_f64_adaptive", adaptive_s=adaptive_s, delta_f_max_err_vs_f64=vs_f64,
         adaptive_success=bool(ref.solver_results[0]["success"]))
    if not vs_f64 <= 1.0e-8:
        fail(f"dd Delta_f differs from the f64 adaptive solve by {vs_f64:.3e}")
    del u_kn, mbar, ref, res
    torch.cuda.empty_cache()

    # ---- phase 3: the many-state slice (split route, Theta on the card)
    u_kn, N_k, fa = oscillators(torch, SLICE_K, SLICE_NPK, gen, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    wsum.WSUM_LAUNCHES = 0
    for n in counters:
        setattr(wsum_split, n, 0)
    t0 = time.perf_counter()
    mbar = MBAR(u_kn, N_k)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    slice_k1 = wsum.WSUM_LAUNCHES
    slice_split = [getattr(wsum_split, n) for n in counters]
    t0 = time.perf_counter()
    res = mbar.compute_free_energy_differences()
    torch.cuda.synchronize()
    theta_s = time.perf_counter() - t0
    peak_bytes = torch.cuda.max_memory_allocated()

    route = mbar.solver_protocol[0]["method"]
    info = mbar.solver_results[0]["info"] if route == "dd" else {}
    iters = info.get("polish_iterations", 0)
    gnorm_per_n = info.get("gnorm", float("nan")) / N_slice
    g64 = mbar_gradient(u_kn, mbar.N_k.astype(np.float64), mbar.f_k)
    g64_per_n = float(torch.linalg.norm(g64)) / N_slice
    summary = dict(
        route=route, K=SLICE_K, N=N_slice, wsum_launches=slice_k1,
        column_shift_launches=slice_split[0], denom_sums_launches=slice_split[1],
        wsum_denom_launches=slice_split[2], init_s=init_s, theta_s=theta_s,
        phase1_s=info.get("phase1_s"), phase2_s=info.get("phase2_s"),
        f32_coarse_iterations=info.get("f32_coarse_iterations"),
        fallback_ran=bool(info.get("f32_coarse_iterations") and info.get("f32_iterations")),
        polish_iterations=iters, deltas=info.get("deltas"), converged=info.get("converged"),
        at_noise_floor=info.get("at_noise_floor"), gradient_norm_per_sample=gnorm_per_n,
        f64_gradient_norm_per_sample=g64_per_n, max_memory_allocated=peak_bytes,
        max_abs_z=max_abs_z(res, fa),
    )
    emit("3_slice", **summary)
    if route != "dd" or slice_k1 != 0 or iters <= 0 or slice_split != [iters] * 3:
        fail(f"the slice did not take the split route on every polish iteration ({summary})")
    if not info["converged"] or not gnorm_per_n <= 1.0e-11 or not g64_per_n <= 1.0e-11:
        fail(f"slice solve not converged: gnorm/N = {gnorm_per_n:.3e}, f64 {g64_per_n:.3e}")
    check_free_energies(res, summary["max_abs_z"], "slice")
    del res, g64

    uh, ul = dev_split_planes(u_kn)
    gate = wsum._SPLIT_ROUTE_K
    wsum._SPLIT_ROUTE_K = 2**31
    try:
        t0 = time.perf_counter()
        f_k1, info_k1 = solve_mbar_dd(uh, ul, N_k)
        torch.cuda.synchronize()
        k1_solve_s = time.perf_counter() - t0
    finally:
        wsum._SPLIT_ROUTE_K = gate
    df_err = float(np.abs((f_k1 - f_k1[0]) - (mbar.f_k - mbar.f_k[0])).max())
    emit("3_vs_k1_route", k1_solve_s=k1_solve_s, k1_polish_iterations=info_k1["polish_iterations"],
         k1_converged=info_k1["converged"], delta_f_max_err_vs_k1_route=df_err)
    if not df_err <= 1.0e-10:
        fail(f"split-route Delta_f differs from the K1-route solve by {df_err:.3e}")
    del uh, ul, u_kn, mbar
    torch.cuda.empty_cache()

    # ---- the kernels line: launches from each one's main-path run
    K, Nf, Ns = FLAGSHIP_K, N_flag, N_slice
    KS = SLICE_K
    rows = [
        ("wsum_dd", "pymbar_tpu_torch/csrc/wsum.cu", "pymbar_tpu/ops/pallas_kernels.py:584",
         flag_launches, bound(8 * K * Nf + 8 * K, 8 * K, 6 * K * Nf, F64_OPS_PER_S)),
        ("column_shift", "pymbar_tpu_torch/csrc/wsum_split.cu",
         "pymbar_tpu/ops/pallas_kernels.py:692", slice_split[0],
         bound(4 * KS * Ns + 4 * KS, 4 * Ns, 2 * KS * Ns, F32_OPS_PER_S)),
        ("denom_sums_dd", "pymbar_tpu_torch/csrc/wsum_split.cu",
         "pymbar_tpu/ops/pallas_kernels.py:785", slice_split[1],
         bound(8 * KS * Ns + 8 * KS + 4 * Ns, 8 * Ns, 5 * KS * Ns, F64_OPS_PER_S)),
        ("wsum_denom_dd", "pymbar_tpu_torch/csrc/wsum_split.cu",
         "pymbar_tpu/ops/pallas_kernels.py:890", slice_split[2],
         bound(8 * KS * Ns + 8 * KS + 12 * Ns, 8 * KS, 6 * KS * Ns, F64_OPS_PER_S)),
    ]
    print(smi)
    print(json.dumps({"kernels": [dict(
        name=name, route="cuda", source=source, replaces=replaces, launches=launches,
        max_abs_err=err[name], ms=times[name][0], plain_ms=times[name][1],
        bound_ms=b[0], bound_by=b[1], library_ms=None,
    ) for name, source, replaces, launches, b in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
