#!/usr/bin/env python3
"""Walls of the port's two MBAR routes on one CUDA card, to set the dd-route gate.

    python3 profiling/torch_route_gate.py [--sizes 32x1024,64x15625,...]

For each problem size (K states x samples per state of the harmonic
oscillators of bench.py, made on the card from a seed) it times
``pymbar_tpu_torch.MBAR(u_kn, N_k)`` by the float64 adaptive route
(``solver_protocol="default"``) and by the double-word route
(``solver_protocol=(dict(method="dd"),)``) in turns (adaptive, dd, dd,
adaptive), after one untimed warm-up of both on a small problem, with
``torch.cuda.synchronize()`` around each.  Prints one JSON line per size.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_SIZES = "32x1024,64x2048,64x15625,256x3906,1024x976"


def make_problem(torch, K, npk, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    O = torch.linspace(0.0, 5.0, K, dtype=torch.float64, device=dev)
    Kf = torch.linspace(1.0, 3.0, K, dtype=torch.float64, device=dev)
    z = torch.randn((K, npk), generator=gen, dtype=torch.float64, device=dev)
    x = (O[:, None] + z / torch.sqrt(Kf)[:, None]).reshape(-1)
    u = torch.empty((K, K * npk), dtype=torch.float64, device=dev)
    step = max(1, (256 * 2**20) // (8 * K))
    for s in range(0, K * npk, step):
        u[:, s : s + step] = 0.5 * Kf[:, None] * (x[None, s : s + step] - O[:, None]) ** 2
    return u, [npk] * K


def main():
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sizes", default=DEFAULT_SIZES)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    sys.path.insert(0, REPO)
    from pymbar_tpu_torch import MBAR

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    routes = {"adaptive": "default", "dd": (dict(method="dd"),)}

    def wall(u, N_k, route):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = MBAR(u, N_k, solver_protocol=routes[route])
        torch.cuda.synchronize()
        return time.perf_counter() - t0, m.f_k

    u, N_k = make_problem(torch, 16, 512, 0, dev)
    for route in routes:
        wall(u, N_k, route)

    for size in args.sizes.split(","):
        K, npk = (int(v) for v in size.split("x"))
        u, N_k = make_problem(torch, K, npk, K * 7919 + npk, dev)
        walls = {"adaptive": [], "dd": []}
        f = {}
        for route in ("adaptive", "dd", "dd", "adaptive"):
            t, f[route] = wall(u, N_k, route)
            walls[route].append(t)
        row = dict(
            card=card, K=K, N=K * npk, u_kn_bytes=u.nbytes,
            adaptive_s=walls["adaptive"], dd_s=walls["dd"],
            dd_vs_adaptive_max_abs=float(abs(f["dd"] - f["adaptive"]).max()),
        )
        print(json.dumps(row), flush=True)
        del u
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
