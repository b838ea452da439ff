#!/usr/bin/env python3
"""What K5's extra over K1 is made of, by cluster size, on one CUDA card.

    python3 profiling/torch_k5_variants.py

K5 (lognum_fused_dd) is the kLognum instantiation of K1's single-read
cluster kernel (pymbar_tpu_torch/csrc/wsum_fused.cuh).  This script builds
csrc/lognum.cu four times into a scratch directory, each time with one
change to the header, and times each build's lognum_fused_launch against
K1 (wsum_dd) at K = 1024, 4096 and 8192 states (clusters of 2, 8 and 16
blocks) over 2^30 random elements, medians of 5 fenced calls in turns
(K1, the builds in order, the builds in reverse, K1):

* ``as_committed``: the header as it is;
* ``arrive_before_weight``: K5's cluster arrive for the next tile's maxima
  issued before its column weight (log and exp), not after it;
* ``division_weight``: K5's column weight replaced by K1's 1 / s_n (a
  timing probe only: its sums are not K5's);
* ``no_direct_branch``: the direct-form branch of the tile loop removed
  (the same sums here: no row of these planes takes the direct form).

Each build's ptxas spill lines and the times print as JSON lines.
"""

import concurrent.futures
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "pymbar_tpu_torch" / "csrc"
SN = """    double sn = 0.0;
    for (int b = 0; b < C; ++b) sn += cluster.map_shared_rank(lsum, b)[par * kFusedCols + col];
"""
ARRIVE = """    r_prev = rn;
    if (i + 1 < ntiles) cluster_arrive();
"""
WEIGHT = "        rn = lognum_column_weight(sn, md, tab);"
DIRECT = "      if (any_direct) {"
SHUFFLE = "#pragma unroll\n    for (int off = kFusedCols; off < 32; off <<= 1) s += __shfl_xor_sync"


def variants():
    hdr = (CSRC / "wsum_fused.cuh").read_text()
    for piece in (SN, ARRIVE, WEIGHT, DIRECT, SHUFFLE):
        if piece not in hdr:
            raise RuntimeError(f"wsum_fused.cuh no longer holds {piece.splitlines()[0]!r}")
    i0, i1 = hdr.index(DIRECT), hdr.index(SHUFFLE)
    return {
        "as_committed": hdr,
        "arrive_before_weight": hdr.replace(
            SN, SN + "    if constexpr (kLognum) { if (i + 1 < ntiles) cluster_arrive(); }\n").replace(
            ARRIVE,
            "    r_prev = rn;\n    if constexpr (!kLognum) { if (i + 1 < ntiles) cluster_arrive(); }\n"),
        "division_weight": hdr.replace(WEIGHT, "        rn = 1.0 / sn;"),
        "no_direct_branch": hdr[:i0] + "      (void)any_direct;\n    }\n" + hdr[i1:],
    }


def build(args):
    """Compile lognum.cu against one header variant; (name, library, spill lines)."""
    from pymbar_tpu_torch.ops import _build

    root, name, header = args
    d = Path(root) / name
    d.mkdir()
    for f in ("wsum_rows.cuh", "lognum.cu"):
        (d / f).write_text((CSRC / f).read_text())
    (d / "wsum_fused.cuh").write_text(header)
    out = d / "liblognum.so"
    p = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(d / "lognum.cu")],
                       capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{p.stdout}{p.stderr}")
    return name, out, [line.strip() for line in (p.stdout + p.stderr).splitlines() if "spill" in line]


def main():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    sys.path.insert(0, str(REPO))
    from pymbar_tpu_torch.ops import _build, wsum
    from pymbar_tpu_torch.ops.doubledouble import dd_from_f64

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _build.load("wsum")
    libs = {}
    with tempfile.TemporaryDirectory() as root:
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            for name, path, spills in pool.map(build, [(root, n, h) for n, h in variants().items()]):
                lib = ctypes.CDLL(str(path))
                p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
                lib.lognum_fused_launch.argtypes = [p, p, p, p, p, i32, i64, i32, i32, p, p, p, p]
                lib.lognum_fused_launch.restype = ctypes.c_int
                libs[name] = lib
                print(json.dumps(dict(variant=name, ptxas_spills=spills)), flush=True)

        dev = torch.device("cuda", 0)
        gen = torch.Generator(device=dev).manual_seed(8)

        def median_ms(fn, reps=5):
            fn()
            torch.cuda.synchronize()
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(ts)

        for K in (1024, 4096, 8192):
            N = 2**30 // K
            uh = torch.empty((K, N), dtype=torch.float32, device=dev)
            ul = torch.empty_like(uh)
            step = 2**26 // K
            for s0 in range(0, N, step):
                uh[:, s0:s0 + step], ul[:, s0:s0 + step] = dd_from_f64(torch.rand(
                    (K, min(step, N - s0)), generator=gen, dtype=torch.float64, device=dev).mul_(10.0))
            gh, gl = dd_from_f64(torch.randn(K, generator=gen, dtype=torch.float64, device=dev) * 0.5
                                 + float(torch.log(torch.tensor(N / K))))
            m_k = torch.full((K,), -8.8, dtype=torch.float32, device=dev)  # |g + m_k| < 64
            partial = wsum.fused_partial(K, dev)
            out = [torch.empty(K, dtype=torch.float32, device=dev) for _ in range(2)]
            stream = torch.cuda.current_stream(dev).cuda_stream

            def k5(name):
                def call():
                    err = libs[name].lognum_fused_launch(
                        uh.data_ptr(), ul.data_ptr(), gh.data_ptr(), gl.data_ptr(), m_k.data_ptr(),
                        K, N, partial.shape[0], 1, partial.data_ptr(), out[0].data_ptr(),
                        out[1].data_ptr(), stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                return call

            gate = wsum._SPLIT_ROUTE_K
            wsum._SPLIT_ROUTE_K = 2**31  # K1 itself at 8192 states
            try:
                names = list(libs)
                ms = {n: [] for n in ["wsum_dd", *names]}
                sums = {}
                for n in ["wsum_dd", *names, *reversed(names), "wsum_dd"]:
                    fn = (lambda: wsum.wsum_dd(uh, ul, gh, gl)) if n == "wsum_dd" else k5(n)
                    ms[n].append(median_ms(fn))
                    if n != "wsum_dd":
                        sums[n] = out[0].double() + out[1].double()
            finally:
                wsum._SPLIT_ROUTE_K = gate
            ref = sums["as_committed"]
            k1 = statistics.median(ms["wsum_dd"])
            print(json.dumps(dict(
                card=card, K=K, N=N, cluster_blocks=(K + 511) // 512, ms=ms,
                over_k1={n: statistics.median(v) / k1 for n, v in ms.items()},
                max_rel_diff_vs_committed={
                    n: float(((v - ref).abs() / ref.abs()).max()) for n, v in sums.items()})),
                flush=True)
            del uh, ul
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
