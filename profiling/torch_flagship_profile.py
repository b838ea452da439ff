#!/usr/bin/env python3
"""Where the flagship's time goes in the PyTorch port, on one CUDA card.

    python3 profiling/torch_flagship_profile.py

Makes the flagship problem of bench.py (K = 1024 x 976 samples, float64,
on the card from a seed), warms up ``MBAR(u_kn, N_k)`` and
``compute_free_energy_differences()`` once, then:

* host-clock walls (fenced by ``torch.cuda.synchronize()``) of the steps:
  the double-word split, the dd solve's phase 1 (float32 warm start and
  chord factor) and phase 2 (polish), the Theta Gram pass and the host
  K x K algebra;
* one ``torch.profiler`` trace of MBAR + free energies: device time per
  kernel name (top 15), and the device-busy share of the unprofiled wall
  of the same work.

Prints two JSON lines.
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, NPK = 1024, 976


def main():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    sys.path.insert(0, REPO)
    from pymbar_tpu_torch import MBAR
    from pymbar_tpu_torch.ops.mbar_core import mbar_gram_normalization
    from pymbar_tpu_torch.solvers_large import dev_split_planes

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    gen = torch.Generator(device=dev).manual_seed(1)
    O = torch.linspace(0.0, 5.0, K, dtype=torch.float64, device=dev)
    Kf = torch.linspace(1.0, 3.0, K, dtype=torch.float64, device=dev)
    z = torch.randn((K, NPK), generator=gen, dtype=torch.float64, device=dev)
    x = (O[:, None] + z / torch.sqrt(Kf)[:, None]).reshape(-1)
    N = K * NPK
    u = torch.empty((K, N), dtype=torch.float64, device=dev)
    for s in range(0, N, 65536):
        u[:, s : s + 65536] = 0.5 * Kf[:, None] * (x[None, s : s + 65536] - O[:, None]) ** 2
    N_k = [NPK] * K

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    timed(lambda: MBAR(u, N_k).compute_free_energy_differences())  # warm-up

    walls = {}
    walls["split_s"], planes = timed(lambda: dev_split_planes(u))
    del planes
    walls["mbar_init_s"], m = timed(lambda: MBAR(u, N_k))
    info = m.solver_results[0]["info"]
    walls["dd_phase1_s"] = info["phase1_s"]
    walls["dd_phase2_s"] = info["phase2_s"]
    walls["polish_iterations"] = info["polish_iterations"]
    walls["f32_coarse_iterations"] = info["f32_coarse_iterations"]
    walls["gram_pass_s"], (g, cs, _rows) = timed(
        lambda: mbar_gram_normalization(u, m.N_k, m.f_k)
    )
    gram = g.cpu().numpy()
    t0 = time.perf_counter()
    m._theta_svd_ew_from_gram(gram, m.N_k)
    walls["theta_host_algebra_s"] = time.perf_counter() - t0
    walls["free_energies_s"], _ = timed(lambda: m.compute_free_energy_differences())
    print(json.dumps(dict(card=card, **walls)), flush=True)

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        MBAR(u, N_k).compute_free_energy_differences()
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
    # the profiler slows the host side, so the idle share is taken against
    # the unprofiled wall of the same work
    unprofiled = walls["mbar_init_s"] + walls["free_energies_s"]
    trace = dict(
        card=card, profiled_wall_s=wall, unprofiled_wall_s=unprofiled,
        device_busy_s=busy_s, device_idle_share=1.0 - busy_s / unprofiled,
        top_kernels=[dict(name=k[:90], device_ms=t / 1e3, calls=c) for k, t, c in kernels[:15]],
    )
    print(json.dumps(trace), flush=True)


if __name__ == "__main__":
    main()
