#!/usr/bin/env python3
"""Smoke run of the PyTorch port (pymbar_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero.

0. The card's name and power limit (nvidia-smi); build csrc/wsum.cu with nvcc.
1. The wsum_dd kernel against its plain PyTorch version on the same CUDA
   tensors: relative error of S <= 1e-13 at several shapes, an all-pad
   matrix gives S == 0 exactly, the launch count rises; at the flagship
   shape the kernel's and the plain version's times (median of 5).
2. The main path at full size: the flagship problem of bench.py (K = 1024
   harmonic-oscillator states x 976 samples, ~8 GB of float64 u_kn) made
   on the card from a seed, then MBAR(u_kn, N_k) with the default protocol
   and compute_free_energy_differences().  It must take the dd route
   through the kernel, converge (gradient norm / N <= 1e-11), agree with
   the analytic free energies (|z| < 6), and lie within 1e-8 of an
   explicit float64 adaptive solve of the same tensor.

The last line is {"ok": true, "device": {...}}.  Without a CUDA card, or
without the repository beside this file, it exits non-zero and prints no
result.  Imports nothing of JAX.
"""

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
S_REL_TOL = 1.0e-13


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg):
    raise RuntimeError(msg)


def rel_err(S, S_ref):
    return float(((S - S_ref).abs() / S_ref.abs().clamp_min(1e-300)).max())


def make_planes(torch, K, N, gen, dev):
    """Random dd planes of u in [0, 10) and g = f + ln(N/K), from a generator."""
    from pymbar_tpu_torch.ops.doubledouble import dd_from_f64

    u = torch.rand((K, N), generator=gen, dtype=torch.float64, device=dev).mul_(10.0)
    uh, ul = dd_from_f64(u)
    del u
    f = torch.randn(K, generator=gen, dtype=torch.float64, device=dev) * 0.5
    gh, gl = dd_from_f64(f + torch.log(torch.tensor(N / K, dtype=torch.float64)))
    return uh, ul, gh, gl


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


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA card")
    if not os.path.isdir(os.path.join(REPO, "pymbar_tpu_torch")):
        fail(f"pymbar_tpu_torch/ not found beside {__file__}")
    sys.path.insert(0, REPO)
    from pymbar_tpu_torch import MBAR
    from pymbar_tpu_torch.ops import _build, wsum
    from pymbar_tpu_torch.ops.doubledouble import dd_to_f64

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- phase 0: card and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    lib_path = _build.build("wsum")
    _build.load("wsum")
    build_s = time.perf_counter() - t0
    log = (_build._BUILD / "wsum.log").read_text().splitlines()
    emit(
        "0_build", card=smi, torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0), build_s=round(build_s, 3),
        library=os.path.relpath(lib_path, REPO),
        ptxas=[line.strip() for line in log if "Used" in line or "spill" in line],
    )

    # ---- phase 1: kernel against the plain version on the card
    gen = torch.Generator(device=dev).manual_seed(SEED)
    max_abs = 0.0
    checks = []

    def compare(label, uh, ul, gh, gl, c=None):
        nonlocal max_abs
        before = wsum.WSUM_LAUNCHES
        S = dd_to_f64(*wsum.wsum_dd(uh, ul, gh, gl, c))
        torch.cuda.synchronize()
        if wsum.WSUM_LAUNCHES != before + 1:
            fail(f"{label}: WSUM_LAUNCHES did not rise")
        S_ref = dd_to_f64(*wsum.wsum_dd_plain(uh, ul, gh, gl, c))
        err = rel_err(S, S_ref)
        max_abs = max(max_abs, float((S - S_ref).abs().max()))
        checks.append(dict(case=label, K=uh.shape[0], N=uh.shape[1], rel_err=err))
        if not err <= S_REL_TOL:
            fail(f"{label}: kernel vs plain relative error {err:.3e} > {S_REL_TOL:g}")
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
    kernel_ms = median_ms(torch, lambda: wsum.wsum_dd(*planes))
    plain_ms = median_ms(torch, lambda: wsum.wsum_dd_plain(*planes))
    del planes
    torch.cuda.empty_cache()
    emit("1_kernel", checks=checks, max_abs_err=max_abs, kernel_ms=kernel_ms,
         plain_ms=plain_ms, shape=[FLAGSHIP_K, N_flag])

    # ---- phase 2: the main path at full size
    K = FLAGSHIP_K
    O = torch.linspace(0.0, 5.0, K, dtype=torch.float64, device=dev)
    Kf = torch.linspace(1.0, 3.0, K, dtype=torch.float64, device=dev)
    z = torch.randn((K, FLAGSHIP_NPK), generator=gen, dtype=torch.float64, device=dev)
    x = (O[:, None] + z / torch.sqrt(Kf)[:, None]).reshape(-1)
    del z
    u_kn = torch.empty((K, N_flag), dtype=torch.float64, device=dev)
    step = 65536
    for s in range(0, N_flag, step):
        u_kn[:, s : s + step] = 0.5 * Kf[:, None] * (x[None, s : s + step] - O[:, None]) ** 2
    del x
    N_k = [FLAGSHIP_NPK] * K
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    wsum.WSUM_LAUNCHES = 0
    t0 = time.perf_counter()
    mbar = MBAR(u_kn, N_k)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    launches = wsum.WSUM_LAUNCHES
    t0 = time.perf_counter()
    res = mbar.compute_free_energy_differences()
    torch.cuda.synchronize()
    theta_s = time.perf_counter() - t0
    peak_bytes = torch.cuda.max_memory_allocated()

    route = mbar.solver_protocol[0]["method"]
    info = mbar.solver_results[0]["info"] if route == "dd" else {}
    fa = (-0.5 * torch.log(2 * torch.pi / Kf)).cpu().numpy()
    fa = fa - fa[0]
    dF = res["Delta_f"][0]
    ddF = res["dDelta_f"][0]
    zscore = (dF[1:] - fa[1:]) / ddF[1:]
    gnorm_per_n = info.get("gnorm", float("nan")) / N_flag
    summary = dict(
        route=route, wsum_launches=launches, init_s=init_s, theta_s=theta_s,
        phase1_s=info.get("phase1_s"), phase2_s=info.get("phase2_s"),
        f32_coarse_iterations=info.get("f32_coarse_iterations"),
        polish_iterations=info.get("polish_iterations"), deltas=info.get("deltas"),
        converged=info.get("converged"), at_noise_floor=info.get("at_noise_floor"),
        gradient_norm_per_sample=gnorm_per_n, max_abs_z=float(abs(zscore).max()),
        max_memory_allocated=peak_bytes,
    )
    emit("2_main_path", **summary)
    if route != "dd" or launches <= 0:
        fail(f"the flagship did not take the dd route through wsum_dd ({summary})")
    if not info["converged"] or not gnorm_per_n <= 1.0e-11:
        fail(f"dd solve not converged: gnorm/N = {gnorm_per_n:.3e}")
    if not (abs(zscore) < 6).all():
        fail(f"|z| >= 6 against the analytic free energies: max {abs(zscore).max():.3f}")
    if not bool(torch.isfinite(torch.as_tensor(res["dDelta_f"])).all()):
        fail("dDelta_f is not finite")

    t0 = time.perf_counter()
    ref = MBAR(u_kn, N_k, maximum_iterations=60, solver_protocol=(dict(method="adaptive"),))
    torch.cuda.synchronize()
    adaptive_s = time.perf_counter() - t0
    vs_f64 = float(abs(ref.f_k - mbar.f_k).max())
    emit("2_vs_f64_adaptive", adaptive_s=adaptive_s, delta_f_max_err_vs_f64=vs_f64,
         adaptive_success=bool(ref.solver_results[0]["success"]))
    if not vs_f64 <= 1.0e-8:
        fail(f"dd Delta_f differs from the f64 adaptive solve by {vs_f64:.3e}")

    print(smi)
    print(json.dumps({"kernels": [dict(
        name="wsum_dd", route="cuda", source="pymbar_tpu_torch/csrc/wsum.cu",
        replaces="pymbar_tpu/ops/pallas_kernels.py:584", launches=launches,
        max_abs_err=max_abs, ms=kernel_ms, plain_ms=plain_ms,
    )]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
