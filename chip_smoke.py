#!/usr/bin/env python3
"""Smoke run of the PyTorch port (pymbar_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero.

0. The card's name and power limit (nvidia-smi); build csrc/wsum.cu,
   csrc/wsum_split.cu, csrc/lognum.cu, csrc/roofline.cu and
   csrc/gram_weights.cu with nvcc, in parallel.
1. Each kernel against its plain PyTorch version on the same CUDA tensors.
   K1 wsum_dd: relative error of S <= 1e-13 at K = 1, 3, 257, 1000 (not a
   multiple of the cluster's blocks or rows), the split-route gate 4096
   (and 4097 states, which take the split route and launch no K1), K1's
   limit 8192 (clusters of 16 blocks; 8193 states must raise), N below one
   column tile and N not a multiple of it nor of 4, the flagship's mesh
   shard (1024, 249856) with and without counts, and the flagship shape;
   two calls give the same bits (clusters of 2 and of 8); pad columns
   change nothing, an all-pad matrix gives S == 0 exactly (clusters of 2
   and of 8), the launch count rises; times at the flagship shape.  The
   many-state route (column shift, K3 denom_sums_dd, K4 wsum_denom_dd):
   the shift exact, s and S <= 1e-13 at (8192, 65536) with
   and without counts, (5000, 1000), (1, 1), (8200, 4099) with counts,
   (33, 127) and the slice's (8192, 327680); K4 gives the same bits twice,
   and a masked column (d = 0) whose exp overflows adds exactly 0 and no
   NaN; wsum_dd's split route against K1 on the same planes; appended pad
   columns, an all-pad matrix, the launch counts; times of each kernel, of
   the split route and of K1 at the slice's shape, and of the PyTorch calls
   that compute the shift's, K3's and K4's functions (torch.amax over k;
   torch.logsumexp over k; over n with the (N,) m_n + log s_n), from the
   planes (the kernels line's library_ms) and on an f64 u.
   The lognum family (K6 logden_dd, K7 lognum_dd, K5 lognum_fused_dd) at
   (1024, 65536), (5, 1003), (1, 1), (4096, 8192) + 77 pad columns,
   (3000, 4096), the flagship shard (1024, 249856) and the flagship shape:
   each kernel against its plain version (logs <= 1e-12, relative for a
   sentinel column's ~-1e10; K5's sums <= 1e-13 relative), K6 then K7 on
   K5's masked ld equal to K5 (<= 1e-13), K5's lognum_k + g_k = log S_k of
   K1 (<= 1e-12), K5 unmoved by pad columns and exactly 0 on an all-pad
   matrix, K7's phantom terms kept on pad columns.  K5, which runs K1's
   cluster kernel, also at (8192, 65536) (clusters of 16), raising on 8193
   states, the same bits twice at clusters of 2 and 8 with no K1 launch,
   and on the rows it takes in its direct form (one row's g lowered by
   750, one the -1e10 sentinel over real u, each with m_k its own lognum:
   s_k ~ 1 while the row's T_kn underflow) against its plain version.
   Times at the flagship, with those of the PyTorch calls that compute
   K6's and K7's functions (torch.logsumexp over k, over n; both in turn
   for K5) on an f64 u built once from the same planes and with the plane
   combine; K5's and K1's medians in turns on one line.
   Times are medians of 5 synchronize-fenced calls.
   1d. The roofline probes (K8a-c): fma_chain in float32 and float64 over 2
   steps and exp_chain over 6 against their plain recurrences (16 ulp; x^2
   doubles a relative error each step, the exp map contracts), the
   pinned-tile weight sum at (1024, 512, 64 steps), (4096, 128, 32) and
   (5, 16, 3) against steps x S(tile) and, at one step, against K1 itself
   bit for bit (both run K1's kernel: clusters of 2 and of 8); then the
   probe path, each probe with its launch count
   set to 0 before it: FMA FLOP/s (float32, float64), f64 exps/s, K8b's
   and K8c's elements/s.  The float64 FMA rate must not exceed 105% of
   34 TFLOP/s (nor float32 105% of 67), and each pinned ceiling must reach
   K1's streaming element rate at its K (the flagship; K = 4096 x 262,144).
   Prints K1's roofline fraction (its flagship element rate over K8b's).
   1e. Theta's weight build (gram_weights) at the main path's float64
   chunk shapes, (1024, 65,536) and (4096, 16,384): the kernel against its
   plain version (w within 1e-12 relative where above 1e-290, logden within
   1e-13 relative to max(|logden|, 1), the row and column sums within
   1e-12 relative), the column sums the same bits twice, one launch a
   call; its time beside its 16-byte bound (read u, write w) and the plain
   version's.
2. The main path at full size: the flagship problem of bench.py (K = 1024
   harmonic-oscillator states x 976 samples, ~8 GB of float64 u_kn) made
   on the card from a seed, then MBAR(u_kn, N_k) with the default protocol
   and compute_free_energy_differences().  It must take the dd route
   through K1, converge (gradient norm / N <= 1e-11), agree with the
   analytic free energies (|z| < 6), lie within 1e-8 of an explicit float64
   adaptive solve, its Theta pass must launch gram_weights once a column
   chunk (16), and its Theta (rank-nnz, on the card) must match the dense
   host Theta of the same Gram (rtol 1e-8, atol 1e-12 max|Theta|).
3. The many-state slice: K = 8192 oscillator states x 40 samples (N =
   327,680, 21.5 GB of float64 u_kn) through MBAR and the free energies.
   It must take the dd route with every polish iteration on the split
   route and no K1 launch, reach gradient norm / N <= 1e-11 by the
   solver's and by a plain float64 evaluation, lie within 1e-10 in
   Delta_f of a dd solve of the same planes through K1, and give |z| < 6
   and a finite dDelta_f.
   On a machine with several cards, MBAR sends phases 2 and 3 to the mesh
   of every card; their checks then read the route from mbar.mesh and count
   K1 (or the split kernels) once per shard per polish iteration.
4. The sample-sharded path at full width: the flagship u_kn of phase 2
   through MBAR(u_kn, N_k, mesh=...) on every card when there are several,
   else on 4 shards of cuda:0, and the free energies (Delta_f within 5e-10
   of phase 2's solve and 1e-8 of the f64 adaptive solve, |z| < 6, K1
   launches = shards x polish iterations); sharded_solve_mbar_dd on its
   planes (gradient norm / N <= 1e-11); K5 on the mesh at the converged f
   (sharded_fused_lognum_dd: -lognum_k + lognum_0 within 1e-10 of
   f_k - f_0, within 1e-12 of one K5 call on the whole planes, one K5
   launch per shard); and a 3-shard pass on cuda:0, where 999,424 samples
   leave pad columns.  Peak device memory of each card.
5. The bootstrap at the flagship: phase 2's u_kn through MBAR(u_kn, N_k,
   n_bootstraps=64, rseed=SEED), which must take the dd counts route
   (bootstrap_at_floor set), then the free energies with the bootstrap
   uncertainty: f_k within 1e-10 of phase 2's, dDelta_f finite, the median
   over states of sigma_boot / sigma_asym (phase 2's svd-ew) in [0.8, 1.25],
   |z| < 6 with the bootstrap sigma.  bootstrap_polish_dd on the planes with
   the base chord factor and the same counts at tol 1e-12 and 1e-7: no
   failure, n_fail + n_at_floor + n_tol_converged = 64, and the two within
   0.01 x the smallest sigma_boot; the serial mode on the first 4
   replicates within 5e-11 of the batched ones, with one K1 launch per
   polish iteration.  Reps/s at both tolerances, the phase walls, the fast
   and exact iterations and the peak memory.
6. The diagnostics and the host estimators at the flagship, on phase 5's
   u_kn (phase 2's seed), each check on its own line with its wall and the
   peak device memory: MBAR(u_kn, N_k, initialize="BAR") (f_k within 1e-10
   of phase 2's; the BAR chain's wall alone; every pair's gathered work
   values equal, bit for bit, to rows of u_kn indexed per pair as the JAX
   package does, the chain within 1e-12 of BAR chained on those, and within
   6 accumulated pairwise BAR sigmas of the solved f_k); Log_W_nk (N, K) passing
   check_w_normalized on the card; compute_effective_sample_number (N_k <=
   N_eff <= N to 1e-9 relative, and 1 / sum_n W_nk^2 from Log_W_nk to 1e-10
   relative); compute_overlap (rows sum to 1 and the top eigenvalue is 1,
   within 1e-10; the scalar in [0, 1]); the free energies with
   uncertainty_method="svd" (W's R factor folded chunk by chunk on the
   card) equal to "svd-ew" to 8 decimals, its peak under half of the 25.3
   GB the whole-W route took; bar and exp on the state-0/state-1 work
   values (Delta_f within
   6 sigma of MBAR's and of the analytic value); statistical_inefficiency
   and subsample_correlated_data on correlated_timeseries_example at its
   published length (g within 50% of its analytic value, one sample per g).
7. The rest of MBAR at the flagship, on phase 5's u_kn and its samples
   x_n, around phase 2's solution (MBAR.from_solution), each call on its
   own line with its wall, its peak device memory above what was resident
   and the streamed pass-B forms it ran: compute_expectations of x_n and
   x_n^2 (|z| < 6 against the analytic means, by the structured one-row
   Gram), the differences (mu equal to the averages' within 1e-12, sigma
   symmetric with a zero diagonal), compute_multiple_expectations of both
   at state K/2 as a new state (mu within 1e-10 and sigma within 1e-6
   relative of the averages', |z| < 6), compute_perturbed_free_energies of
   four new oscillators (|z| < 6) and of states 0, K/2, K-1 (Delta_f
   within 1e-10 and dDelta_f within 1e-6 relative of phase 2's),
   compute_entropy_and_enthalpy (Delta_f within 1e-10 of phase 2's, |z| <
   6 for Delta_s and Delta_u, finite symmetric sigmas, the structured diag
   Gram on u_kn itself with a peak under half of u_kn), the bootstrap of
   the expectations on phase 5's 64 replicates (mu within 1e-9, the
   median sigma_boot / sigma_asym in [0.8, 1.25]), and phase 2's
   checkpoint resumed with skip_solve (f_k bit for bit, the same u_kn
   storage) and by a solve (f_k within 1e-10, no more polish iterations
   than phase 2's, one K1 launch each).
8. FES.  (a) bench.py's fes_slice configuration at full size: 64 umbrella
   windows (Ku = 100, centres 0.2 linspace(-3, 3)) on a quadratic base
   (K0 = 20), 16,384 samples each (N = 1,048,576; 537 MB of float64 u_kn
   built on the card from the seed's x_n), 100 bins over [min x, max x].
   FES(u_kn, N_k) must share u_kn and take the dd route through K1 (one
   launch per polish iteration).  The analytical histogram from the lowest
   bin by the streamed augmented Gram: f_i and df_i finite on every
   populated bin, RMSE < 0.05 against (K0/2) x^2 on |x| < 0.5, and df_i and
   the all-differences df_ij within 1e-8 of the materializing branch's.
   The bootstrap, B = 16, on the dd counts route: the median over bins of
   df_boot / df_analytical in [0.8, 1.25], and 2 replicates again by the
   per-replicate route within 1e-8.  The KDE at half a bin's bandwidth
   (finite f_i at the bin centres; on a 4096-sample subset in 16-query
   chunks within 1e-9 of the plain pairwise evaluation on the card), the
   ML spline of fes_slice (finite, RMSE < 0.05), and a 200-step MC chain
   with finite, ordered confidence intervals.  (b) The analytical histogram
   on phase 7's flagship u_kn (target state K/2, 100 bins) by the streamed
   branch: df_i finite on every populated bin, and the peak above the
   resident u_kn below half of u_kn (the N x (K + nbins) weights would be
   9 GB).  Each call on its own line with its wall, peak above resident and
   K1 launches.

9. The bootstraps that are not the flagship's counts route, each call on
   its own line with its wall, the peak device memory of each card and K1's
   launches.  (a) Phase 5's u_kn through MBAR(u_kn, N_k, mesh=M,
   n_bootstraps=64, rseed=SEED), M every card when there are several, else
   4 shards of cuda:0: it must take the mesh bootstrap (mbar.mesh is M,
   bootstrap_at_floor set, n_fail 0) with f_k within 5e-10 of phase 2's,
   f_k_boots within 5e-10 of phase 5's single-card replicates (same seed,
   same counts), the median sigma_boot / sigma_asym in [0.8, 1.25] and
   |z| < 6; sharded_bootstrap_polish_dd in serial mode on the first 4
   replicates within 5e-11 of the batched ones, with K1 launched shards x
   polish iterations times.  Reps/s and the walls.  The stop rule across
   routes: the mesh engine from phase 5's base solution and factor, the
   single-card engine from the mesh's, and both exact phases from one start
   (the single card's float32 fast phase): from one base each engine must
   count the other's noise-floor stops, and from one start both must stop
   every replicate alike (the same stops, the same iterations).  (b) 16 oscillators x
   3,000 samples (6.1 MB, below the dd gate), B = 100: one
   batched_bootstrap_solve call; the first 8 replicates within 1e-9 of the
   sequential route, whose 100 solves are timed too.  (c) Phase 8's
   umbrella configuration plus its unbiased state (K0/2) x^2 as a 65th,
   unsampled state (545 MB), B = 16: the dd base solve, then the batched
   route (the chunk width it took from free memory recorded); 2 replicates
   within 1e-9 of the sequential route.  (d) solver_protocol anderson and
   BFGS on (b)'s problem: f_k within 1e-8 of its adaptive solve, with
   anderson's iterations, BFGS's iterations and objective evaluations.

10. The 2-D k x n mesh (pymbar_tpu_torch.parallel.mesh_2d) on blocks of
   cuda:0, each check on its own line with its wall and peak device memory.
   (a) sharded2d_wsum_dd (the shift, K3 and K4 on every block under a shift
   shared by each n column) against wsum.split_route on the same whole
   planes, S within 1e-12 relative: a (2, 2) mesh on phase 3's planes (the
   slice remade bit for bit from phase 3's generator state) at g of phase
   3's solution, with the medians of 5 fenced calls of both beside phase
   1b's split-route time, and of each kernel alone on one block; (4, 1)
   and (1, 4) at (8192, 65536); (3, 2) at (8193, 4099), which pads both
   axes.  Two calls give the same bits, each call launches each kernel
   kd x nd times, pad states give S = 0, and an all-pad matrix S == 0
   exactly.  On every mesh each kernel is held against its plain version
   on block (0, 0), with the inputs the path gives it there (column 0's
   shared shift, its denominators summed over the k-blocks): the shift
   exactly, K3 and K4 within 1e-13 relative; their largest absolute
   errors join phase 1b's in the kernels line.  (b) sharded2d_solve_mbar_dd on phase
   3's planes (the slice; stride2 = 1, so phase 1 and the Gram read the
   whole hi plane) on a (2, 2) mesh, the planes dropped once the blocks
   exist (phase 3's float64 u_kn freed before; what is resident then must
   be the blocks alone, and the peak after it is read): converged, Delta_f within
   5e-10 of phase 3's solve, gradient norm / N <= 1e-11 by a plain float64
   evaluation on the slice remade, no K1 launch, and the shift, K3 and K4
   launched 4 times per weight-sum pass of the polish; phase1_s,
   phase2_s and the iterations.  (c) sharded2d_solve_mbar (float64
   Anderson, no kernel) on a (2, 2) mesh at K = 1024 oscillators x 96
   samples (805 MB): converged, f within 1e-9 of the single-card MBAR.

11. A host-resident u_kn: MBAR(cpu_tensor, N_k, device="cuda") keeps
   u_kn in host memory and streams its column chunks to the card through
   pinned staging; each call on its own line with its wall, its peak device
   memory and its K1 launches.  (a) The flagship remade from phase 2's seed,
   moved to host memory and freed on the card: MBAR and the free energies
   against phase 2's resident route (f_k within 1e-12, expected bit for
   bit; Delta_f within 1e-12, dDelta_f within 1e-10 relative; the same K1
   launches; the peak at most 0.6 x phase 2's), compute_expectations(x_n)
   within 1e-10 of phase 7's (sigma relative); the pinned upload's GB/s
   (one 512 MB copy) and a streamed pass's (bytes over its wall) with its
   share of each wall.  (c) The 1-D mesh from the host (phase 4's mesh)
   against phase 4's f_k (5e-10).  (d) The B = 64 counts route from the
   host: f_k_boots within 1e-12 of phase 5's.  (b) 1024 oscillators x
   5,856 samples each (N = 5,996,544, 49.1 GB of f64), made on the card
   row block by row block into host memory: the resident route's need (u_kn
   and its planes, 98.3 GB) printed against the card's memory; the dd route
   through K1 from the host, converged (gradient norm / N <= 1e-11 by the
   solver and by a streamed f64 evaluation), |z| < 6, the peak below the
   card's memory; then 'svd' from host memory (W alone would be 49.1 GB)
   equal to svd-ew to 8 decimals, its peak below the card's memory.

12. The public surface as users meet it, with PYMBAR_TPU_TORCH_DEVICE
   unset (the phase fails if it is set; only its CPU reruns set it, and
   restore it after).  (a) The six synthetic examples/*.py, unchanged, with
   sys.modules["pymbar_tpu"] pointed at pymbar_tpu_torch for each run:
   each on the card (its wall; the CUDA allocation count must grow during
   it), then again on the CPU under PYMBAR_TPU_TORCH_DEVICE=cpu; the text
   must match and every number printed on the card lie within one unit of
   the last printed digit of the CPU run (NaN only against NaN).  The CPU
   port is held against pymbar_tpu in the CPU tests, so the card is held
   against the JAX package through it.  (b) doctest.testmod of the port's
   mbar, fes and the four testsystems modules: 0 failures.  (c) The
   README's port quickstart (|z| < 6 against the analytic free energies
   and means) and every python block of docs/torch_port.md, in page order;
   its card block, 64 oscillator states x 16,384 samples (537 MB of f64):
   |z| < 6, K1 launched, gradient norm / N <= 1e-11 by the solver and by a
   float64 evaluation, and the host-resident solve's f_k within 1e-12 of
   the resident one.

13. The paths a host-resident u_kn reached last, each a CPU tensor with
   device="cuda", each run on its own line with its wall, its peak above
   what was resident and its launches.  (a) Phase 8's umbrella cell made
   as there and moved to host memory: FES from the host (the dd route,
   K1), the analytical histogram (f_i within 1e-12 and df_i within 1e-10
   relative of phase 8's), the B = 16 counts bootstrap (f_k_boots within
   1e-12) and the KDE (1e-12); then the flagship histogram of phase 8b
   from host memory, the same bars, its peak at most 0.6 x phase 8b's
   including u_kn.  (b) Phase 9c's 545 MB umbrella cell with its unbiased
   state unsampled, B = 16 on the batched route at phase 9c's chunk width,
   each replicate's columns copied on the card out of u_kn's uploaded
   column chunks: f_k_boots within 1e-12 of phase 9c's, n_fail equal, the
   peak at most phase 9c's above its resident u_kn plus the two staging
   buffers.  (c) 'svd' at the flagship from host
   memory beside phase 6's wall and peak: svd-ew's to 8 decimals, the
   peak under half of 25.3 GB.  (d) Phase 3's slice remade and moved to
   host memory, streamed into (2, 2) blocks of cuda:0
   (stream_shard_planes_2d, peak under 1.5 x the blocks) and solved by
   sharded2d_solve_mbar_dd: f within 1e-12 of phase 10b's, no K1 launch,
   the shift, K3 and K4 launched as in phase 10b.  The wall phase 13 and
   phase 11b's 'svd' add to the run is printed.

Then the card, the kernels line (K1's launches: phase 2's MBAR, phase 9
(a)'s, phase 11's, phase 12's and phase 13's runs; the shift's, K3's and
K4's: phase 3's MBAR, phase 10 (b)'s and phase 13 (d)'s solves;
gram_weights': phase 2's Theta, one a column chunk, and its time at
(1024, 65,536)) and
{"ok": true, "device": {...}} close the output.  Without a CUDA card, or
without the repository beside this
file, it exits non-zero and prints no result.  Imports nothing of JAX.
"""

import concurrent.futures
import contextlib
import doctest
import importlib
import importlib.util
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
FLAGSHIP_K = 1024
FLAGSHIP_NPK = 976
SLICE_K = 8192
SLICE_NPK = 40
S_REL_TOL = 1.0e-13
CHAIN_ULPS = 16
# The probe path: chain lengths (each timed launch runs ~4-20 ms), and the
# pinned shapes (K, tile, steps) of the JAX bench's K8b and K8c.
FMA_STEPS = 2**16
EXP_STEPS = 2**12
PINNED = {"wsum_pinned_1024x512": (1024, 512, 8192), "wsum_pinned_4096x128": (4096, 128, 16384)}
N_BOOT = 64
# Phase 8: the umbrella FES configuration of bench.py's fes_slice (windows,
# samples per window, bins), its bootstrap replicates and MC steps.
FES_KW = 64
FES_NPW = 16384
FES_NBINS = 100
FES_BOOT = 16
FES_MC_STEPS = 200
# Phase 9 (b): an alchemical ladder's size, below the dd gate (6.1 MB).
SMALL_K = 16
SMALL_NPK = 3000
SMALL_BOOT = 100
SOURCES = ("wsum", "wsum_split", "lognum", "roofline", "gram_weights")
# Phase 1e: the column-chunk shapes of the Theta pass at K = 1024 and 4096
# (512 MiB of float64 each, ops/mbar_core._CHUNK_BYTES).
GRAM_SHAPES = ((1024, 65536), (4096, 16384))
LOG_ABS_TOL = 1.0e-12
MESH_DF_TOL = 5.0e-10
# The peak of 'svd' at the flagship when it factored the whole N x K W on
# the card, before the streamed R factor (H100 80GB HBM3, 700 W; PERF.md)
SVD_WHOLE_W_PEAK = 25.3e9

# Lower bounds of a kernel's time: HBM3 at 3.35 TB/s and the H100 SXM's
# vector peaks (NVIDIA data sheet, 700 W): 67 TFLOP/s float32, 34 TFLOP/s
# float64.  Operations are counted as one per add, subtract, max, multiply,
# divide and exp (an exp costs ~20 FP64 instructions, so the op bound is an
# underestimate; it stays below the byte bound either way).
# Phase 12: the examples that run without data files, the process default
# device's variable, a printed number, and the marker of a docs block that
# needs a card.
EXAMPLES = ("harmonic_oscillators.py", "alchemical_free_energy.py", "heat_capacity.py",
            "umbrella_sampling_fes.py", "constant_force_optical_trap.py",
            "parallel_tempering_2dfes.py")
DEVICE_VAR = "PYMBAR_TPU_TORCH_DEVICE"
NUMBER = re.compile(r"[-+]?(?:nan|inf|(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?)", re.IGNORECASE)
CARD_MARK = "# needs a CUDA card"

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
    analytic f_k - f_0 and the samples x."""
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
    return u_kn, [npk] * K, fa - fa[0], x


def log_err(a, b):
    """max |a - b| of logs, relative where |b| > 1 (a sentinel column's
    log-denominator sits near -1e10, where f64 holds ~2e-6)."""
    return float(((a - b).abs() / b.abs().clamp_min(1.0)).max())


def lognum_shift(torch, uh, ld_hi):
    """m_k = max_n (-ld_hi_n - u_hi_kn) in float32, column chunk by chunk."""
    K, N = uh.shape
    m = torch.full((K,), -torch.inf, dtype=torch.float32, device=uh.device)
    width = max(1, 2**26 // K)
    for s in range(0, N, width):
        m = torch.maximum(m, (-ld_hi[None, s : s + width] - uh[:, s : s + width]).amax(dim=1))
    return m


def sync_all(torch):
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


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


def mesh_route(mbar):
    """(route, shards): "mesh" and the mesh's size when MBAR took a mesh
    (solver_protocol then holds the resolved default, as in the JAX
    package), else the first stage's method and 1."""
    if mbar.mesh is not None:
        return "mesh", len(mbar.mesh.devices)
    return mbar.solver_protocol[0]["method"], 1


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


def phase7(torch, np, u_kn, N_k, x_n, f_flag, flag_df3, flag_ddf3, flag_polish, boot_mbar,
           ck_path):
    """Expectations, perturbed free energies, entropy and enthalpy, the
    bootstrap of expectations and the checkpoint at the flagship: u_kn and
    its samples x_n (phase 2's draw), phase 2's solution f_flag (with its
    Delta_f and dDelta_f on states 0, K/2, K-1 and its polish iterations),
    phase 5's B = 64 object and phase 2's checkpoint file."""
    from pymbar_tpu_torch import MBAR, checkpoint, testsystems
    from pymbar_tpu_torch import mbar as tmbar
    from pymbar_tpu_torch.ops import wsum

    K = FLAGSHIP_K
    mid = K // 2
    tc = testsystems.HarmonicOscillatorsTestCase(O_k=np.linspace(0.0, 5.0, K),
                                                  K_k=np.linspace(1.0, 3.0, K))
    routes = ("AUG_B_LOGROW_PASSES", "AUG_B_DIAG_PASSES", "AUG_B_GENERAL_PASSES")

    def run(label, fn, route=None):
        """fn's result; one line with its wall (synchronize-fenced), its
        peak device memory above what was resident before it, and the
        streamed pass-B forms it ran, which must be ``route`` when given."""
        for n in routes:
            setattr(tmbar, n, 0)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - resident
        passes = {n: getattr(tmbar, n) for n in routes}
        emit(f"7_{label}", s=wall, peak_above_resident=peak, pass_b=passes)
        if route is not None and passes != {n: int(n == route) for n in routes}:
            fail(f"{label}: pass B ran {passes}, not one {route}")
        return out, peak

    def z_max(est, truth, sigma):
        z = np.abs((np.asarray(est) - truth) / np.asarray(sigma))
        return float(z.max()) if np.isfinite(z).all() else float("nan")

    def z_diff_max(delta, d_delta, truth):
        """max |z| of the off-diagonal differences against truth_j - truth_i."""
        off = ~np.eye(delta.shape[0], dtype=bool)
        z = (delta - (truth[None, :] - truth[:, None]))[off] / d_delta[off]
        return float(np.abs(z).max()) if np.isfinite(z).all() else float("nan")

    def rel(a, b):
        return float(np.max(np.abs(a - b) / np.abs(b)))

    m = MBAR.from_solution(u_kn, N_k, f_flag)
    checks = {}

    # (a), (b): averages at every state, by the structured one-row Gram
    ex1, _ = run("a_expectations_x", lambda: m.compute_expectations(x_n), "AUG_B_LOGROW_PASSES")
    ex2, _ = run("b_expectations_x2", lambda: m.compute_expectations(x_n**2), "AUG_B_LOGROW_PASSES")
    checks["a_max_z"] = z_max(ex1["mu"], tc.analytical_means(), ex1["sigma"])
    checks["b_max_z"] = z_max(ex2["mu"], tc.analytical_observable("position^2"), ex2["sigma"])
    # (c): differences
    exd, _ = run("c_differences", lambda: m.compute_expectations(x_n, output="differences"),
                 "AUG_B_LOGROW_PASSES")
    checks["c_mu_vs_a"] = float(np.abs(exd["mu"] - (ex1["mu"][None, :] - ex1["mu"][:, None])).max())
    checks["c_sigma_asymmetry"] = float(np.abs(exd["sigma"] - exd["sigma"].T).max()
                                        / np.abs(exd["sigma"]).max())
    checks["c_sigma_diagonal"] = float(np.abs(np.diag(exd["sigma"])).max())
    # (d): two observables at state K/2 as a new state
    mult, _ = run("d_multiple", lambda: m.compute_multiple_expectations(
        torch.stack([x_n, x_n**2]), u_kn[mid], compute_covariance=True), "AUG_B_GENERAL_PASSES")
    mu_ab = np.array([ex1["mu"][mid], ex2["mu"][mid]])
    sig_ab = np.array([ex1["sigma"][mid], ex2["sigma"][mid]])
    checks["d_mu_vs_ab"] = float(np.abs(mult["mu"] - mu_ab).max())
    checks["d_sigma_rel_vs_ab"] = rel(mult["sigma"], sig_ab)
    checks["d_max_z"] = z_max(mult["mu"], np.array(
        [tc.analytical_means()[mid], tc.analytical_observable("position^2")[mid]]), mult["sigma"])
    checks["d_covariances_shape"] = list(mult["covariances"].shape)
    # (e): four new oscillators inside the sampled range, then three sampled
    # states as perturbed ones
    O_new = np.array([0.6, 1.25, 2.5, 3.75])
    K_new = np.array([1.2, 1.5, 2.0, 2.5])
    u_ln = 0.5 * torch.as_tensor(K_new, device=x_n.device)[:, None] * (
        x_n[None, :] - torch.as_tensor(O_new, device=x_n.device)[:, None]) ** 2
    pert, _ = run("e_perturbed_new", lambda: m.compute_perturbed_free_energies(u_ln),
                  "AUG_B_GENERAL_PASSES")
    checks["e_max_z"] = z_diff_max(pert["Delta_f"], pert["dDelta_f"],
                                   -0.5 * np.log(2 * np.pi / K_new))
    rows3 = u_kn[[0, mid, K - 1]]
    pert3, _ = run("e_perturbed_sampled", lambda: m.compute_perturbed_free_energies(rows3),
                   "AUG_B_GENERAL_PASSES")
    off = ~np.eye(3, dtype=bool)
    checks["e_delta_f_vs_phase2"] = float(np.abs(pert3["Delta_f"] - flag_df3).max())
    checks["e_ddelta_f_rel_vs_phase2"] = rel(pert3["dDelta_f"][off], flag_ddf3[off])
    del u_ln, rows3
    # (f): entropy and enthalpy on the aliased u_kn, by the structured diag Gram
    ent, ent_peak = run("f_entropy", m.compute_entropy_and_enthalpy, "AUG_B_DIAG_PASSES")
    checks["f_delta_f_vs_phase2"] = float(
        np.abs(ent["Delta_f"] - (f_flag[None, :] - f_flag[:, None])).max())
    checks["f_delta_s_max_z"] = z_diff_max(ent["Delta_s"], ent["dDelta_s"],
                                           tc.analytical_entropies())
    checks["f_delta_u_max_z"] = z_diff_max(ent["Delta_u"], ent["dDelta_u"], np.zeros(K))
    checks["f_sigmas_finite_symmetric"] = all(
        np.isfinite(ent[k]).all()
        and np.abs(ent[k] - ent[k].T).max() <= 1e-10 * np.abs(ent[k]).max()
        for k in ("dDelta_f", "dDelta_u", "dDelta_s"))
    checks["f_peak_above_resident"] = ent_peak
    # (g): bootstrap of the expectations on phase 5's replicates
    boot, _ = run("g_bootstrap", lambda: boot_mbar.compute_expectations(
        x_n, uncertainty_method="bootstrap"), "AUG_B_LOGROW_PASSES")
    checks["g_mu_vs_a"] = float(np.abs(boot["mu"] - ex1["mu"]).max())
    checks["g_sigma_boot_over_asym_median"] = float(np.median(boot["sigma"] / ex1["sigma"]))
    # (h): the checkpoint of phase 2's object
    same, _ = run("h_resume_skip_solve", lambda: checkpoint.resume_mbar(ck_path, u_kn,
                                                                        skip_solve=True))
    wsum.WSUM_LAUNCHES = 0
    again, _ = run("h_resume_solve", lambda: checkpoint.resume_mbar(ck_path, u_kn))
    resume_k1 = wsum.WSUM_LAUNCHES
    info = again.solver_results[0]["info"]
    checks["h_skip_solve_f_k_equal"] = bool(np.array_equal(same.f_k, f_flag))
    checks["h_skip_solve_same_storage"] = same.u_kn.data_ptr() == u_kn.data_ptr()
    checks["h_resume_f_k_vs_phase2"] = float(np.abs(again.f_k - f_flag).max())
    checks["h_resume_polish_iterations"] = [info.get("polish_iterations"), flag_polish]
    checks["h_resume_wsum_launches"] = resume_k1
    emit("7_checks", **checks)

    bad = [
        name for name, ok in (
            ("a |z| < 6", checks["a_max_z"] < 6),
            ("b |z| < 6", checks["b_max_z"] < 6),
            ("c mu", checks["c_mu_vs_a"] <= 1e-12),
            ("c sigma symmetric, zero diagonal",
             checks["c_sigma_asymmetry"] <= 1e-10 and checks["c_sigma_diagonal"] == 0.0),
            ("d mu", checks["d_mu_vs_ab"] <= 1e-10),
            ("d sigma", checks["d_sigma_rel_vs_ab"] <= 1e-6),
            ("d |z| < 6", checks["d_max_z"] < 6),
            ("e |z| < 6", checks["e_max_z"] < 6),
            ("e Delta_f", checks["e_delta_f_vs_phase2"] <= 1e-10),
            ("e dDelta_f", checks["e_ddelta_f_rel_vs_phase2"] <= 1e-6),
            ("f Delta_f", checks["f_delta_f_vs_phase2"] <= 1e-10),
            ("f Delta_s |z| < 6", checks["f_delta_s_max_z"] < 6),
            ("f Delta_u |z| < 6", checks["f_delta_u_max_z"] < 6),
            ("f sigmas", checks["f_sigmas_finite_symmetric"]),
            ("f no copy of u_kn", ent_peak < u_kn.nbytes // 2),
            ("g mu", checks["g_mu_vs_a"] <= 1e-9),
            ("g sigma finite", bool(np.isfinite(boot["sigma"]).all())),
            ("g median ratio", 0.8 <= checks["g_sigma_boot_over_asym_median"] <= 1.25),
            ("h skip_solve",
             checks["h_skip_solve_f_k_equal"] and checks["h_skip_solve_same_storage"]),
            ("h resume f_k", checks["h_resume_f_k_vs_phase2"] <= 1e-10),
            ("h resume polish", info.get("polish_iterations", np.inf) <= flag_polish
             and resume_k1 == info.get("polish_iterations")),
        ) if not ok
    ]
    if bad:
        fail(f"phase 7 failed: {bad} ({checks})")
    return ex1


def umbrella_x(np):
    """Phase 8's umbrella samples: 64 windows (Ku = 100, centres 0.2
    linspace(-3, 3)) on the quadratic base (K0 = 20), 16,384 each.
    Returns (x_n, centres, K0, Ku)."""
    K0, Ku = 20.0, 100.0
    rng = np.random.RandomState(23)
    centers = np.linspace(-3.0, 3.0, FES_KW) * 0.2
    sigma = 1.0 / (K0 + Ku)
    x_n = (sigma * Ku * centers[:, None]
           + np.sqrt(sigma) * rng.standard_normal((FES_KW, FES_NPW))).reshape(-1)
    return x_n, centers, K0, Ku


def phase8(torch, np, u_flag, N_k_flag, x_flag):
    """FES: (a) the umbrella configuration at full size, made on the card;
    (b) the analytical histogram on the flagship u_flag (phase 7's, with its
    samples x_flag), through the streamed augmented Gram.  Returns the
    resident values phase 13 holds its host-resident runs to: (a)'s
    histogram, bootstrap replicates and KDE, (b)'s histogram and peaks."""
    from pymbar_tpu_torch import FES
    from pymbar_tpu_torch import kde as tkde
    from pymbar_tpu_torch import mbar as tmbar
    from pymbar_tpu_torch.ops import wsum

    dev = u_flag.device

    def run(label, fn, **fields):
        """fn's result and its wall (synchronize-fenced); one line with the
        wall, the peak device memory above what was resident before it and
        K1's launches in it."""
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        wsum.WSUM_LAUNCHES = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - resident
        emit(f"8_{label}", s=wall, peak_above_resident=peak, wsum_launches=wsum.WSUM_LAUNCHES,
             **fields)
        return out, wall, peak, wsum.WSUM_LAUNCHES

    def nan_equal_max_diff(a, b):
        a, b = np.asarray(a), np.asarray(b)
        if not np.array_equal(np.isnan(a), np.isnan(b)):
            return float("inf")
        return float(np.nanmax(np.abs(a - b)))

    # (a) bench.py's fes_slice, after pymbar's umbrella-sampling-fes example:
    # 64 harmonic windows (Ku = 100) on a quadratic base (K0 = 20), 16,384
    # samples each; u_kn built on the card from the seed's x_n
    x_n, centers, K0, Ku = umbrella_x(np)
    u_n = (K0 / 2.0) * x_n**2
    N_k = np.full(FES_KW, FES_NPW, dtype=np.int64)
    x_dev = torch.as_tensor(x_n, device=dev)
    u_kn = (K0 / 2.0) * x_dev[None, :] ** 2 + (Ku / 2.0) * (
        x_dev[None, :] - torch.as_tensor(centers, device=dev)[:, None]) ** 2
    del x_dev
    edges = np.linspace(x_n.min() - 1e-6, x_n.max() + 1e-6, FES_NBINS + 1)
    cent = 0.5 * (edges[1:] + edges[:-1])
    pop = np.histogram(x_n, edges)[0] > 0
    ref = (K0 / 2.0) * cent**2
    inner = (np.abs(cent) < 0.5) & pop

    def rmse(f_i):
        f_c = f_i - f_i[inner].min()
        return float(np.sqrt(np.mean((f_c[inner] - (ref[inner] - ref[inner].min())) ** 2)))

    fes, init_s, init_peak, init_k1 = run("a_init", lambda: FES(u_kn, N_k),
                                         u_kn_bytes=u_kn.nbytes, shape=list(u_kn.shape))
    route, _ = mesh_route(fes.mbar)
    info = fes.mbar.solver_results[0].get("info", {})
    if fes.u_kn.data_ptr() != u_kn.data_ptr():
        fail("FES copied u_kn instead of sharing it")
    if route not in ("dd", "mesh") or init_k1 <= 0:
        fail(f"the FES's MBAR took the {route} route with {init_k1} K1 launches")
    if route == "dd" and init_k1 != info.get("polish_iterations"):
        fail(f"K1 launched {init_k1} times in {info.get('polish_iterations')} polish iterations")
    hist = dict(bin_edges=edges)

    def histogram(reference_point):
        fes.generate_fes(u_n, x_n, histogram_parameters=hist)
        return fes.get_fes(cent, reference_point=reference_point, uncertainty_method="analytical")

    # the streamed augmented Gram (u_kn is far above _AUG_STREAM_BYTES)
    r, hist_s, hist_peak, _ = run("a_histogram", lambda: histogram("from-lowest"))
    r_all, _, _, _ = run("a_histogram_all_differences", lambda: histogram("all-differences"))
    gate = tmbar._AUG_STREAM_BYTES
    tmbar._AUG_STREAM_BYTES = 2**62
    try:
        r_mat, _, mat_peak, _ = run("a_histogram_materialized", lambda: histogram("from-lowest"))
        r_mat_all, _, _, _ = run("a_histogram_materialized_all_differences",
                                 lambda: histogram("all-differences"))
    finally:
        tmbar._AUG_STREAM_BYTES = gate
    checks = dict(
        route=route, init_k1=init_k1, polish_iterations=info.get("polish_iterations"),
        populated_bins=int(pop.sum()),
        f_i_finite=bool(np.isfinite(r["f_i"][pop]).all()),
        df_i_finite=bool(np.isfinite(r["df_i"][pop]).all()),
        histogram_rmse=rmse(r["f_i"]),
        df_i_streamed_vs_materialized=nan_equal_max_diff(r["df_i"], r_mat["df_i"]),
        f_i_streamed_vs_materialized=nan_equal_max_diff(r["f_i"], r_mat["f_i"]),
        df_ij_streamed_vs_materialized=nan_equal_max_diff(r_all["df_ij"], r_mat_all["df_ij"]),
        materialized_peak_above_resident=mat_peak,
    )

    # bootstrap, B = FES_BOOT: the counts route, then 2 replicates again by
    # the per-replicate route
    def bootstrap():
        fes.generate_fes(u_n, x_n, histogram_parameters=hist, n_bootstraps=FES_BOOT,
                         seed=SEED % 2**31)
        return fes.get_fes(cent, reference_point="from-lowest", uncertainty_method="bootstrap")

    rb, _, _, _ = run("a_histogram_bootstrap", bootstrap, n_bootstraps=FES_BOOT)
    f_k_boots = fes.f_k_boots.copy()
    expected_route = "counts" if route == "dd" else "replicate"
    (f_rep, n_fail), _, _, _ = run("a_bootstrap_replicate_route_2", lambda: fes._replicate_free_energies(
        fes.bootstrap_indices[:2], "replicate"))
    live = pop & (r["df_i"] > 0)
    checks.update(
        bootstrap_route=fes.bootstrap_route,
        df_boot_over_analytical_median=float(np.median(rb["df_i"][live] / r["df_i"][live])),
        counts_vs_replicate_route=float(np.abs(f_rep - fes.f_k_boots[:2]).max()),
        replicate_route_n_fail=n_fail,
    )

    # KDE at half a bin's bandwidth; then the chunked KDE against the plain
    # evaluation on the card (pairwise differences, no chunks) on a
    # 4096-sample subset, in 16-query chunks
    bw = 0.5 * (edges[1] - edges[0])

    def kde():
        fes.generate_fes(u_n, x_n, fes_type="kde", kde_parameters={"bandwidth": bw})
        return fes.get_fes(cent, reference_point="from-lowest")

    rk, _, _, _ = run("a_kde", kde, bandwidth=bw)
    resident = dict(umbrella=dict(f_i=r["f_i"], df_i=r["df_i"], f_k=fes.mbar.f_k.copy(),
                                  f_k_boots=f_k_boots, kde_f_i=rk["f_i"],
                                  init_s=init_s, histogram_s=hist_s))
    sub = np.random.RandomState(SEED % 2**31).choice(x_n.size, 4096, replace=False)
    w_sub = fes.w_n[sub]
    budget = tkde._PAIRWISE_BUDGET_BYTES
    tkde._PAIRWISE_BUDGET_BYTES = 16 * 16 * sub.size
    try:
        got = tkde.GaussianKDE(bandwidth=bw, device=dev).fit(
            x_n[sub], sample_weight=w_sub).score_samples(cent)
    finally:
        tkde._PAIRWISE_BUDGET_BYTES = budget
    xq = torch.as_tensor(cent, device=dev)[:, None]
    xs = torch.as_tensor(x_n[sub], device=dev)[None, :]
    lw = torch.log(torch.as_tensor(w_sub / w_sub.sum(), device=dev))[None, :]
    plain = (torch.logsumexp(lw - 0.5 * (xq - xs) ** 2 / bw**2, dim=1)
             - np.log(bw * np.sqrt(2.0 * np.pi))).cpu().numpy()
    checks.update(kde_f_i_finite=bool(np.isfinite(rk["f_i"]).all()), kde_rmse=rmse(rk["f_i"]),
                  kde_vs_plain_4096=float(np.abs(got - plain).max()))

    # the ML spline of bench.py's fes_slice, then a short MC chain
    def bias(k):
        return lambda x: (Ku / 2.0) * float(np.dot(x - centers[k], x - centers[k]))

    spline = dict(
        spline_weights="unbiasedstate", nspline=6, spline_initialize="explicit", xinit=cent,
        yinit=ref - ref.min(), xrange=[edges[0], edges[-1]],
        fkbias=[bias(k) for k in range(FES_KW)], kdegree=3,
        optimization_algorithm="Newton-CG", optimize_options={"disp": False, "tol": 1e-6},
        objective="ml", map_data=None,
    )

    def fit_spline():
        fes.generate_fes(u_n, x_n, fes_type="spline", spline_parameters=spline)
        return fes.get_fes(cent, reference_point="from-lowest")

    rs, _, _, _ = run("a_spline", fit_spline)

    def mc():
        np.random.seed(SEED % 2**31)
        fes.sample_parameter_distribution(
            x_n, mc_parameters=dict(niterations=FES_MC_STEPS, sample_every=10, print_every=10**9),
            decorrelate=False, verbose=False)
        return fes.get_confidence_intervals(cent, 2.5, 97.5)

    ci, _, _, _ = run("a_mc", mc, niterations=FES_MC_STEPS)
    checks.update(
        spline_f_i_finite=bool(np.isfinite(rs["f_i"]).all()), spline_rmse=rmse(rs["f_i"]),
        spline_aic=float(fes.get_information_criteria("aic")),
        mc_acceptance=float(fes.get_mc_data()["acceptance_ratio"]),
        mc_ci_finite=bool(all(np.isfinite(ci[k]).all() for k in ("plow", "phigh", "median"))),
        mc_ci_ordered=bool(np.all(ci["phigh"] >= ci["plow"] - 1e-12)),
    )
    emit("8a_checks", **checks)
    bad = [
        name for name, ok in (
            ("finite f_i, df_i on populated bins", checks["f_i_finite"] and checks["df_i_finite"]),
            ("histogram RMSE < 0.05", checks["histogram_rmse"] < 0.05),
            ("streamed vs materialized df_i, df_ij",
             checks["df_i_streamed_vs_materialized"] <= 1e-8
             and checks["df_ij_streamed_vs_materialized"] <= 1e-8
             and checks["f_i_streamed_vs_materialized"] <= 1e-9),
            ("bootstrap route", checks["bootstrap_route"] == expected_route),
            ("median df_boot / df_analytical in [0.8, 1.25]",
             0.8 <= checks["df_boot_over_analytical_median"] <= 1.25),
            ("counts vs per-replicate route", checks["counts_vs_replicate_route"] <= 1e-8),
            ("KDE finite", checks["kde_f_i_finite"]),
            # the Gram expansion's cancellation, ~eps x^2 / h^2, against
            # direct differences: tests/test_kde.py:31's bar
            ("KDE vs plain", checks["kde_vs_plain_4096"] <= 1e-9),
            ("spline finite", checks["spline_f_i_finite"]),
            ("spline RMSE < 0.05", checks["spline_rmse"] < 0.05),
            ("MC confidence intervals", checks["mc_ci_finite"] and checks["mc_ci_ordered"]),
        ) if not ok
    ]
    if bad:
        fail(f"phase 8a failed: {bad} ({checks})")
    del fes, u_kn, r_mat, r_mat_all
    torch.cuda.empty_cache()

    # (b) the flagship histogram: phase 7's resident u_kn, its samples, the
    # target state K/2, 100 bins, the streamed branch; the peak above the
    # resident u_kn must stay below half of it (no N x (K + nbins) matrix)
    mid = u_flag.shape[0] // 2
    fes, b_init_s, b_init_peak, b_k1 = run("b_init", lambda: FES(u_flag, N_k_flag),
                                           u_kn_bytes=u_flag.nbytes, shape=list(u_flag.shape))
    xb = x_flag.cpu().numpy()
    edges_b = np.linspace(xb.min() - 1e-6, xb.max() + 1e-6, FES_NBINS + 1)
    cent_b = 0.5 * (edges_b[1:] + edges_b[:-1])
    pop_b = np.histogram(xb, edges_b)[0] > 0

    def flagship_histogram():
        fes.generate_fes(u_flag[mid], x_flag, histogram_parameters=dict(bin_edges=edges_b))
        return fes.get_fes(cent_b, reference_point="from-lowest", uncertainty_method="analytical")

    rb, b_s, b_peak, _ = run("b_histogram", flagship_histogram, nbins=FES_NBINS)
    checks_b = dict(
        init_k1=b_k1, populated_bins=int(pop_b.sum()),
        df_i_finite=bool(np.isfinite(rb["df_i"][pop_b]).all()),
        f_i_finite=bool(np.isfinite(rb["f_i"][pop_b]).all()), peak_above_resident=b_peak,
        half_u_kn=u_flag.nbytes // 2,
        aug_w_bytes=u_flag.shape[1] * (u_flag.shape[0] + FES_NBINS) * 8,
    )
    emit("8b_checks", **checks_b)
    if not (checks_b["df_i_finite"] and checks_b["f_i_finite"] and b_k1 > 0
            and b_peak < u_flag.nbytes // 2):
        fail(f"phase 8b failed: {checks_b}")
    resident["flagship"] = dict(f_i=rb["f_i"], df_i=rb["df_i"], init_s=b_init_s, histogram_s=b_s,
                                peak=u_flag.nbytes + max(b_init_peak, b_peak))
    del fes
    torch.cuda.empty_cache()
    return resident


def phase9(torch, np, u_flag, N_k_flag, fa_flag, f_flag, sigma_asym, single5):
    """(a) The mesh bootstrap at the flagship, (b) the small-problem batched
    bootstrap, (c) the umbrella configuration with its unbiased state added
    unsampled, (d) anderson and BFGS.  ``single5``: phase 5's single-card
    base solution, factor, replicates and their stops at tol 1e-12.
    Returns K1's launches in (a)'s MBAR, the main path's run of this
    phase, and (c)'s replicates, n_fail, chunk width and peak above what
    was resident, which phase 13 holds its host-resident run to."""
    from pymbar_tpu_torch import MBAR
    from pymbar_tpu_torch import solvers as tsolvers
    from pymbar_tpu_torch.mbar import bootstrap_counts
    from pymbar_tpu_torch.ops import wsum
    from pymbar_tpu_torch.parallel import sharding
    from pymbar_tpu_torch.solvers import BOOTSTRAP_SOLVER_PROTOCOL, solve_mbar_for_all_states
    from pymbar_tpu_torch import solvers_large
    from pymbar_tpu_torch.solvers_large import bootstrap_polish_dd, dev_split_planes

    dev = u_flag.device
    n_cards = torch.cuda.device_count()
    mesh = (sharding.default_mesh() if n_cards >= 2
            else sharding.default_mesh(4, device="cuda:0"))
    P = len(mesh.devices)
    cards = sorted({dev.index} | {d.index for d in mesh.devices})

    def run(label, fn, **fields):
        """fn's result and wall (synchronize-fenced); one line with the wall,
        the peak device memory of each card and K1's launches in it."""
        sync_all(torch)
        for i in cards:
            torch.cuda.reset_peak_memory_stats(i)
        wsum.WSUM_LAUNCHES = 0
        t0 = time.perf_counter()
        out = fn()
        sync_all(torch)
        wall = time.perf_counter() - t0
        k1 = wsum.WSUM_LAUNCHES
        peak = {f"cuda:{i}": torch.cuda.max_memory_allocated(i) for i in cards}
        emit(f"9{label}", s=wall, max_memory_allocated=peak, wsum_launches=k1, **fields)
        return out, wall, k1

    def wrapped(module, name, record):
        """Replace module.name by a wrapper that records each call's wall and
        result through record(wall, out); returns the original."""
        fn = getattr(module, name)

        def wrapper(*a, **k):
            sync_all(torch)
            t0 = time.perf_counter()
            out = fn(*a, **k)
            sync_all(torch)
            record(time.perf_counter() - t0, out)
            return out

        setattr(module, name, wrapper)
        return fn

    # (a) the flagship through MBAR(mesh=, n_bootstraps=64): the base solve
    # and every replicate on the mesh's planes (K1 once per shard per polish
    # iteration of the base solve and of any retry)
    boot = {}
    polish = wrapped(sharding, "sharded_bootstrap_polish_dd",
                     lambda wall, out: boot.update(wall=wall, n_fail=out[1], info=out[2]))
    try:
        mbar, init_s, mesh_k1 = run(
            "a_mesh_bootstrap_mbar",
            lambda: MBAR(u_flag, N_k_flag, mesh=mesh, n_bootstraps=N_BOOT, rseed=SEED),
            shards=P, mesh=[str(d) for d in mesh.devices])
    finally:
        sharding.sharded_bootstrap_polish_dd = polish
    info = mbar.solver_results[0]["info"]
    iters = info["polish_iterations"]
    res, fe_s, _ = run("a_mesh_bootstrap_free_energies",
                       lambda: mbar.compute_free_energy_differences(uncertainty_method="bootstrap"))
    sigma_boot = res["dDelta_f"][0, 1:]
    ratio = float(np.median(sigma_boot / sigma_asym))
    summary = dict(
        route=mesh_route(mbar)[0], shards=P, n_bootstraps=N_BOOT, init_s=init_s,
        base_phase1_s=info["phase1_s"], base_phase2_s=info["phase2_s"],
        base_polish_iterations=iters, bootstrap_s=boot.get("wall"),
        reps_per_s=N_BOOT / boot["wall"] if boot else None, n_fail=boot.get("n_fail"),
        n_at_floor=boot["info"]["n_at_floor"] if boot else None,
        n_tol_converged=boot["info"]["n_tol_converged"] if boot else None,
        free_energies_s=fe_s, wsum_launches=mesh_k1,
        f_k_max_err_vs_phase2=float(np.abs(mbar.f_k - f_flag).max()),
        f_k_boots_max_err_vs_phase5=float(np.abs(mbar.f_k_boots - single5["f_boots"]).max()),
        sigma_boot_over_asym_median=ratio, max_abs_z=max_abs_z(res, fa_flag),
    )
    emit("9a_mesh_bootstrap", **summary)
    if mbar.mesh is not mesh or mbar.bootstrap_at_floor is None or not boot:
        fail(f"MBAR(mesh=, n_bootstraps=) did not take the mesh bootstrap ({summary})")
    if summary["n_fail"] != 0 or not info["converged"] or mesh_k1 < P * iters:
        fail(f"mesh bootstrap: n_fail, convergence or K1 launches off ({summary})")
    if not (summary["f_k_max_err_vs_phase2"] <= MESH_DF_TOL
            and summary["f_k_boots_max_err_vs_phase5"] <= MESH_DF_TOL):
        fail(f"mesh bootstrap differs from the single card: {summary}")
    if not 0.8 <= ratio <= 1.25:
        fail(f"mesh bootstrap: median sigma_boot / sigma_asym = {ratio:.3f}")
    check_free_energies(res, summary["max_abs_z"], "mesh bootstrap")

    uh, ul = dev_split_planes(u_flag)
    uh_s, ul_s, n_pad = sharding.shard_dd_planes(uh, ul, mesh)
    counts4 = bootstrap_counts(mbar.bootstrap_rints[:4], mbar.N)
    (fs, nfs, bis), serial_s, serial_k1 = run(
        "a_mesh_bootstrap_serial_first4",
        lambda: sharding.sharded_bootstrap_polish_dd(
            uh_s, ul_s, N_k_flag, mbar.f_k, info["hinv"], counts4, mesh, mode="serial"))
    serial_dev = float(np.abs(fs - mbar.f_k_boots[:4]).max())
    emit("9a_mesh_bootstrap_serial", n_fail=nfs, polish_iterations=bis["polish_iterations"].tolist(),
         wsum_launches=serial_k1, max_dev_vs_batched=serial_dev)
    if not (nfs == 0 and serial_dev <= 5.0e-11):
        fail(f"mesh serial replicates differ from batched by {serial_dev:.3e} (n_fail {nfs})")
    if serial_k1 != P * int(bis["polish_iterations"].sum()):
        fail(f"mesh serial mode launched K1 {serial_k1} times for {P} shards x "
             f"{bis['polish_iterations'].tolist()} polish iterations")

    # the stop rule across routes: each engine from the other's base
    # solution and factor, then the exact phase from one start on both
    counts = bootstrap_counts(mbar.bootstrap_rints, mbar.N)
    (fx, nfx, bix), _s, _k = run(
        "a_mesh_engine_from_phase5_base",
        lambda: sharding.sharded_bootstrap_polish_dd(uh_s, ul_s, N_k_flag, single5["f_k"],
                                                     single5["hinv"], counts, mesh))
    (fy, nfy, biy), _s, _k = run(
        "a_single_engine_from_mesh_base",
        lambda: bootstrap_polish_dd(uh, ul, N_k_flag, mbar.f_k, info["hinv"], counts))
    K, N = uh.shape
    N_k64 = torch.as_tensor(np.asarray(N_k_flag, dtype=np.float64), device=dev)
    f0 = torch.as_tensor(single5["f_k"] - single5["f_k"][0], device=dev)
    hinv5 = torch.as_tensor(single5["hinv"], dtype=torch.float64, device=dev)
    C = torch.as_tensor(counts.astype(solvers_large._counts_upload_dtype(counts)), device=dev)
    n_chunk = solvers_large._batch_chunk_width(K, N)
    F, _it = solvers_large._polish_while_dd_batch_fast(uh, ul, C, N_k64, f0, hinv5, 1.0, n_chunk)
    one = solvers_large._polish_while_dd_batch_exact(uh, ul, C, N_k64, F, f0, hinv5, 1.0e-12,
                                                     1.0, 16, n_chunk)
    S_fn = sharding._sharded_batch_S_fn(
        uh_s, ul_s, sharding._split_columns(C, mesh, 0)[0], mesh,
        solvers_large._batch_chunk_width(K, uh_s[0].shape[1]))
    on_mesh = solvers_large._batch_exact_from_S_fn(S_fn, F, N_k64, f0, hinv5, 1.0e-12, 1.0, 16)
    one_floor, mesh_floor = one[4].cpu().numpy(), on_mesh[4].cpu().numpy()
    one_iters, mesh_iters = one[1].cpu().numpy(), on_mesh[1].cpu().numpy()
    mesh_at_floor = boot["info"]["at_floor"]
    cross = dict(
        phase5={"n_at_floor": int(single5["at_floor"].sum()),
                "exact_iters": np.bincount(single5["exact_iters"]).tolist()},
        mesh={"n_at_floor": int(mesh_at_floor.sum()),
              "exact_iters": np.bincount(boot["info"]["exact_iters"]).tolist()},
        mesh_engine_from_phase5_base={
            "n_at_floor": bix["n_at_floor"], "n_fail": nfx,
            "exact_iters": np.bincount(bix["exact_iters"]).tolist(),
            "stops_unlike_phase5": int((bix["at_floor"] != single5["at_floor"]).sum()),
            "max_dev_vs_phase5": float(np.abs((fx - fx[:, :1]) - single5["f_boots"]).max())},
        single_engine_from_mesh_base={
            "n_at_floor": biy["n_at_floor"], "n_fail": nfy,
            "exact_iters": np.bincount(biy["exact_iters"]).tolist(),
            "stops_unlike_mesh": int((biy["at_floor"] != mesh_at_floor).sum()),
            "max_dev_vs_mesh": float(np.abs((fy - fy[:, :1]) - mbar.f_k_boots).max())},
        exact_from_one_start={
            "n_at_floor": [int(one_floor.sum()), int(mesh_floor.sum())],
            "exact_iters": [np.bincount(one_iters).tolist(), np.bincount(mesh_iters).tolist()],
            "stops_unlike": int((one_floor != mesh_floor).sum()),
            "iters_unlike": int((one_iters != mesh_iters).sum()),
            "max_dev": float((one[0] - on_mesh[0].to(one[0].device)).abs().max())},
    )
    emit("9a_stop_rule_across_routes", **cross)
    if nfx or nfy or cross["exact_from_one_start"]["stops_unlike"] or \
            cross["exact_from_one_start"]["iters_unlike"]:
        fail(f"the mesh and the single card stop replicates unlike from one start: {cross}")
    if (bix["n_at_floor"] != cross["phase5"]["n_at_floor"]
            or biy["n_at_floor"] != cross["mesh"]["n_at_floor"]):
        fail(f"from one base solution and factor the routes count other floor stops: {cross}")
    del uh, ul, uh_s, ul_s, mbar, res, counts, C, F, one, on_mesh
    torch.cuda.empty_cache()

    batched = []
    chunks = []
    prot = MBAR._resolve_protocol(None, BOOTSTRAP_SOLVER_PROTOCOL, 10000)

    def sequential(m, n):
        """The first n replicates of m, one by one on their gathered columns."""
        out = np.zeros((n, m.K))
        for b in range(n):
            idx = torch.as_tensor(m.bootstrap_rints[b], device=dev)
            out[b] = solve_mbar_for_all_states(m.u_kn.index_select(1, idx), m.N_k, m.f_k,
                                               m.states_with_samples, prot)
        return out

    solve = wrapped(tsolvers, "batched_bootstrap_solve",
                    lambda wall, out: batched.append(dict(wall=wall, n_fail=out[1])))
    chunk_fn = tsolvers._boot_chunk
    tsolvers._boot_chunk = lambda *a: chunks.append(chunk_fn(*a)) or chunks[-1]
    try:
        # (b) an alchemical-ladder-sized problem below the dd gate: 16
        # oscillators x 3,000 samples, B = 100, on the batched route
        gen = torch.Generator(device=dev).manual_seed(SEED + 9)
        u_b, N_k_b, fa_b, _x = oscillators(torch, SMALL_K, SMALL_NPK, gen, dev)
        m_b, init_s, _ = run("b_small_batched_mbar",
                             lambda: MBAR(u_b, N_k_b, n_bootstraps=SMALL_BOOT, rseed=SEED),
                             u_kn_bytes=u_b.nbytes)
        f_seq, seq_s, _ = run("b_small_sequential", lambda: sequential(m_b, SMALL_BOOT))
        seq_dev8 = float(np.abs(f_seq[:8] - m_b.f_k_boots[:8]).max())
        b_line = dict(
            K=SMALL_K, N=int(sum(N_k_b)), u_kn_bytes=u_b.nbytes, n_bootstraps=SMALL_BOOT,
            route=m_b.solver_protocol[0]["method"], batched_calls=len(batched),
            batched_s=batched[0]["wall"] if batched else None, chunk=chunks[:1],
            n_fail=batched[0]["n_fail"] if batched else None, mbar_init_s=init_s,
            sequential_s=seq_s, max_dev_first8=seq_dev8,
            max_dev_all=float(np.abs(f_seq - m_b.f_k_boots).max()),
        )
        emit("9b_small_batched_bootstrap", **b_line)
        if len(batched) != 1 or b_line["route"] != "adaptive" or u_b.nbytes >= 8 * 2**20:
            fail(f"the small problem's bootstrap did not take the batched route ({b_line})")
        if not (seq_dev8 <= 1.0e-9 and b_line["n_fail"] == 0):
            fail(f"batched replicates differ from the sequential route by {seq_dev8:.3e}")

        # (c) the umbrella configuration of phase 8 plus its unbiased state
        # (K0/2) x^2 as an unsampled state (N_k = 0), B = 16: the dd base
        # solve, then the batched replicates (no counts route: a state is empty)
        x_n, centers, K0, Ku = umbrella_x(np)
        x_dev = torch.as_tensor(x_n, device=dev)
        u_c = torch.cat([
            (K0 / 2.0) * x_dev[None, :] ** 2 + (Ku / 2.0) * (
                x_dev[None, :] - torch.as_tensor(centers, device=dev)[:, None]) ** 2,
            (K0 / 2.0) * x_dev[None, :] ** 2,
        ])
        del x_dev
        N_k_c = np.append(np.full(FES_KW, FES_NPW), 0)
        n_before = len(batched)
        resident_c = torch.cuda.memory_allocated(dev)
        m_c, init_s, _ = run("c_umbrella_unbiased_mbar",
                             lambda: MBAR(u_c, N_k_c, n_bootstraps=FES_BOOT, rseed=SEED),
                             u_kn_bytes=u_c.nbytes, shape=list(u_c.shape))
        peak_c = torch.cuda.max_memory_allocated(dev) - resident_c
        f_seq, seq_s, _ = run("c_umbrella_sequential_2", lambda: sequential(m_c, 2))
        seq_dev = float(np.abs(f_seq - m_c.f_k_boots[:2]).max())
        c_line = dict(
            u_kn_bytes=u_c.nbytes, n_bootstraps=FES_BOOT, route=mesh_route(m_c)[0],
            batched_calls=len(batched) - n_before,
            batched_s=batched[-1]["wall"] if len(batched) > n_before else None,
            chunk_from_free_memory=chunks[-1] if chunks else None,
            n_fail=batched[-1]["n_fail"] if len(batched) > n_before else None,
            mbar_init_s=init_s, sequential_2_s=seq_s, max_dev_vs_sequential_2=seq_dev,
            f_unbiased_minus_f0=float(m_c.f_k[-1]),
        )
        emit("9c_umbrella_unbiased_bootstrap", **c_line)
        if c_line["batched_calls"] != 1 or m_c.bootstrap_at_floor is not None:
            fail(f"the umbrella bootstrap did not take the batched route ({c_line})")
        if not (seq_dev <= 1.0e-9 and c_line["n_fail"] == 0 and np.isfinite(m_c.f_k_boots).all()):
            fail(f"umbrella replicates differ from the sequential route by {seq_dev:.3e}")
        umbrella_boot = dict(f_k_boots=m_c.f_k_boots.copy(), n_fail=c_line["n_fail"],
                             chunk=c_line["chunk_from_free_memory"], init_s=init_s,
                             peak_above_resident=peak_c, u_kn_bytes=u_c.nbytes)
        del u_c, m_c
    finally:
        tsolvers.batched_bootstrap_solve = solve
        tsolvers._boot_chunk = chunk_fn
    torch.cuda.empty_cache()

    # (d) anderson and BFGS on (b)'s problem, against its adaptive solve
    # anderson's iterations are its core_stats passes, BFGS's its line
    # searches, each of which evaluates the objective and gradient
    counted = ("core_stats", "mbar_objective_and_gradient", "_line_search")
    for method in ("anderson", "BFGS"):
        calls = dict.fromkeys(counted, 0)
        originals = {name: getattr(tsolvers, name) for name in counted}

        def counter(name, fn):
            def counted(*a, **k):
                calls[name] += 1
                return fn(*a, **k)
            return counted

        for name, fn in originals.items():
            setattr(tsolvers, name, counter(name, fn))
        try:
            m_d, wall, _ = run(f"d_{method.lower()}_mbar", lambda: MBAR(
                u_b, N_k_b, solver_protocol=({"method": method},)))
        finally:
            for name, fn in originals.items():
                setattr(tsolvers, name, fn)
        dev_d = float(np.abs(m_d.f_k - m_b.f_k).max())
        emit(f"9d_{method.lower()}", s=wall, success=bool(m_d.solver_results[0]["success"]),
             anderson_iterations=calls["core_stats"], bfgs_iterations=calls["_line_search"],
             bfgs_objective_evaluations=calls["mbar_objective_and_gradient"],
             f_k_max_err_vs_adaptive=dev_d)
        if not (m_d.solver_results[0]["success"] and dev_d <= 1.0e-8):
            fail(f"{method}: f_k differs from the adaptive solve by {dev_d:.3e}")
    return mesh_k1, umbrella_boot


def phase10(torch, np, slice_state, f_slice, route_ms_1b):
    """The 2-D k x n mesh on blocks of cuda:0.  ``slice_state``: the
    generator state phase 3 made its u_kn from (so the slice is remade bit
    for bit); ``f_slice``: phase 3's free energies; ``route_ms_1b``: phase
    1b's split-route median at the slice's shape.  Returns the shift's,
    K3's and K4's launches in (b)'s solve, the main path's run of this
    phase, each kernel's largest absolute error against its plain version
    on the blocks of (a), and (b)'s solution with its wall and peak."""
    from pymbar_tpu_torch import MBAR
    from pymbar_tpu_torch.ops import wsum, wsum_split
    from pymbar_tpu_torch.ops.doubledouble import dd_from_f64, dd_to_f64
    from pymbar_tpu_torch.ops.mbar_core import mbar_gradient
    from pymbar_tpu_torch.parallel import sharding
    from pymbar_tpu_torch.solvers_large import dev_split_planes

    dev = torch.device("cuda", 0)
    counters = ("SHIFT_LAUNCHES", "DENOM_SUMS_LAUNCHES", "WSUM_DENOM_LAUNCHES")
    N_slice = SLICE_K * SLICE_NPK
    t_phase = time.perf_counter()

    block_err = {"column_shift": 0.0, "denom_sums_dd": 0.0, "wsum_denom_dd": 0.0}

    def launches():
        return [getattr(wsum_split, n) for n in counters]

    def slice_u():
        gen = torch.Generator(device=dev)
        gen.set_state(slice_state)
        return oscillators(torch, SLICE_K, SLICE_NPK, gen, dev)

    def start():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return time.perf_counter()

    def wsum_2d(planes, shape, label, timed=False):
        """(a): sharded2d_wsum_dd on a shape mesh of cuda:0 against the
        split route on the same whole planes; two calls, the same bits;
        kd x nd launches of each kernel per call; pad states S = 0."""
        t0 = start()
        uh, ul, gh, gl = planes
        K = uh.shape[0]
        mesh = sharding.mesh_2d(*shape, device=dev)
        hi, lo, N_pad, _, pads = sharding.shard_dd_planes_2d(uh, ul, np.ones(K), np.zeros(K), mesh)
        g2 = [torch.nn.functional.pad(g, (0, len(N_pad) - K)) for g in (gh, gl)]
        before = launches()
        S = dd_to_f64(*sharding.sharded2d_wsum_dd(hi, lo, *g2, mesh))
        torch.cuda.synchronize()
        rose = [a - b for a, b in zip(launches(), before)]
        S_again = dd_to_f64(*sharding.sharded2d_wsum_dd(hi, lo, *g2, mesh))
        S_route = dd_to_f64(*wsum.split_route(uh, ul, gh, gl))
        torch.cuda.synchronize()
        e = rel_err(S[:K], S_route)
        line = dict(case=label, mesh=list(shape), K=K, N=uh.shape[1], pads=list(pads),
                    rel_err_vs_split_route=e, same_bits=bool(torch.equal(S, S_again)),
                    launches_per_call=rose, pad_states_zero=bool((S[K:] == 0).all()))
        # each kernel against its plain version on block (0, 0), at the block
        # shape and with the inputs the 2-D path gives it: column 0's shared
        # shift and its denominators summed over the k-blocks, pad-masked
        kb = hi[0][0].shape[0]
        col0 = [(hi[i][0], lo[i][0], g2[0][i * kb:(i + 1) * kb], g2[1][i * kb:(i + 1) * kb])
                for i in range(shape[0])]
        b = col0[0]
        m_own = wsum_split.column_shift(b[0], b[2])
        m = m_own
        for blk in col0[1:]:
            m = torch.maximum(m, wsum_split.column_shift(blk[0], blk[2]))
        d_own = dd_to_f64(*wsum_split.denom_sums_dd(*b, m))
        d = d_own.clone()
        for blk in col0[1:]:
            d += dd_to_f64(*wsum_split.denom_sums_dd(*blk, m))
        d = dd_from_f64(d.masked_fill_(m < wsum._PAD_M, 0.0))
        S_blk = dd_to_f64(*wsum_split.wsum_denom_dd(*b, m, *d))
        d_ref = dd_to_f64(*wsum_split.denom_sums_dd_plain(*b, m))
        S_ref = dd_to_f64(*wsum_split.wsum_denom_dd_plain(*b, m, *d))
        blk_err = dict(column_shift=float((m_own - wsum_split.column_shift_plain(b[0], b[2])).abs().max()),
                       denom_sums_dd=float((d_own - d_ref).abs().max()),
                       wsum_denom_dd=float((S_blk - S_ref).abs().max()))
        blk_rel = dict(denom_sums_dd=rel_err(d_own, d_ref), wsum_denom_dd=rel_err(S_blk, S_ref))
        for name, v in blk_err.items():
            block_err[name] = max(block_err[name], v)
        line.update(block_shape=list(b[0].shape), block_max_abs_err=blk_err, block_rel_err=blk_rel)
        if not (blk_err["column_shift"] == 0.0 and max(blk_rel.values()) <= S_REL_TOL):
            fail(f"{label}: a split kernel on block (0, 0) differs from its plain version: "
                 f"{blk_err} {blk_rel}")
        if timed:
            block_ms = dict(
                column_shift=median_ms(torch, lambda: wsum_split.column_shift(b[0], b[2])),
                denom_sums_dd=median_ms(torch, lambda: wsum_split.denom_sums_dd(*b, m)),
                wsum_denom_dd=median_ms(torch, lambda: wsum_split.wsum_denom_dd(*b, m, *d)))
            block_plain_ms = dict(
                column_shift=median_ms(torch, lambda: wsum_split.column_shift_plain(b[0], b[2])),
                denom_sums_dd=median_ms(torch, lambda: wsum_split.denom_sums_dd_plain(*b, m)),
                wsum_denom_dd=median_ms(torch,
                                        lambda: wsum_split.wsum_denom_dd_plain(*b, m, *d)))
            line.update(block_plain_ms=block_plain_ms)
            line.update(ms=median_ms(torch, lambda: sharding.sharded2d_wsum_dd(hi, lo, *g2, mesh)),
                        split_route_ms=median_ms(torch, lambda: wsum.split_route(uh, ul, gh, gl)),
                        split_route_ms_phase1b=route_ms_1b, block_ms=block_ms)
        line.update(s=time.perf_counter() - t0, max_memory_allocated=torch.cuda.max_memory_allocated())
        emit("10a_wsum_2d", **line)
        if not (e <= 1.0e-12 and line["same_bits"] and line["pad_states_zero"]
                and rose == [shape[0] * shape[1]] * 3):
            fail(f"sharded2d_wsum_dd on {label}: {line}")

    # (a) at the slice's shape on phase 3's planes, g at phase 3's solution
    u_kn, N_k, _fa, _x = slice_u()
    uh, ul = dev_split_planes(u_kn)
    del u_kn
    torch.cuda.empty_cache()
    logN = torch.log(torch.as_tensor(N_k, dtype=torch.float64, device=dev))
    gh, gl = dd_from_f64(torch.as_tensor(f_slice, device=dev) + logN)
    wsum_2d((uh, ul, gh, gl), (2, 2), f"{SLICE_K}x{N_slice} slice", timed=True)
    torch.cuda.empty_cache()

    # (b) the production path: the 2-D dd solve of the same planes, which it
    # drops once the blocks exist (the solve holds their only references)
    wsum.WSUM_LAUNCHES = 0
    for n in counters:
        setattr(wsum_split, n, 0)
    planes = [uh, ul]
    del uh, ul, gh, gl
    # the solve's first core-stats call reads what is resident once the
    # blocks exist and restarts the peak; the Gram is timed on its own
    seen = {}
    core_stats, gram = sharding.sharded2d_core_stats, sharding.sharded2d_gram

    def first_core_stats(*a, **k):
        if "resident" not in seen:
            torch.cuda.synchronize()
            seen["resident"] = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        return core_stats(*a, **k)

    def timed_gram(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = gram(*a, **k)
        torch.cuda.synchronize()
        seen["gram_s"] = time.perf_counter() - t
        return out

    t0 = start()
    sharding.sharded2d_core_stats, sharding.sharded2d_gram = first_core_stats, timed_gram
    try:
        f2d, info = sharding.sharded2d_solve_mbar_dd(planes.pop(0), planes.pop(0), N_k,
                                                     mesh=sharding.mesh_2d(2, 2, device=dev))
    finally:
        sharding.sharded2d_core_stats, sharding.sharded2d_gram = core_stats, gram
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    solve10 = dict(s=solve_s, peak_once_sharded=peak, resident_once_sharded=seen["resident"])
    k1, split = wsum.WSUM_LAUNCHES, launches()
    block_bytes = 8 * SLICE_K * N_slice
    torch.cuda.empty_cache()
    u_kn = slice_u()[0]
    g64 = float(torch.linalg.norm(mbar_gradient(u_kn, np.asarray(N_k, np.float64), f2d))) / N_slice
    del u_kn
    torch.cuda.empty_cache()
    # the polish's weight-sum passes; a dd Anderson fallback adds its
    # iterations beyond the chord polish's deltas and one certificate pass
    passes = info["polish_iterations"] + (info["polish_iterations"] > len(info["deltas"]))
    df = float(np.abs(f2d - f_slice).max())
    emit("10b_solve_2d", mesh=[2, 2], K=SLICE_K, N=N_slice, s=solve_s, phase1_s=info["phase1_s"],
         phase2_s=info["phase2_s"], f32_iterations=info["f32_iterations"],
         polish_iterations=info["polish_iterations"], deltas=info["deltas"],
         converged=info["converged"], at_noise_floor=info["at_noise_floor"],
         wsum_passes=passes, wsum_launches=k1, split_launches=split,
         delta_f_max_err_vs_phase3=df, gradient_norm_per_sample=info["gnorm"] / N_slice,
         f64_gradient_norm_per_sample=g64, gram_s=seen["gram_s"], block_bytes=block_bytes,
         resident_once_sharded=seen["resident"], peak_once_sharded=peak)
    if not seen["resident"] <= 1.05 * block_bytes:
        fail(f"the planes outlived the sharding: {seen['resident']} bytes resident")
    if not info["converged"] or not df <= MESH_DF_TOL or not g64 <= 1.0e-11:
        fail(f"the 2-D dd solve: converged {info['converged']}, Delta_f {df:.3e} from phase 3, "
             f"f64 gradient / N {g64:.3e}")
    if k1 != 0 or passes <= 0 or split != [4 * passes] * 3:
        fail(f"the 2-D dd solve launched K1 {k1} times and the split kernels {split} "
             f"over {passes} weight-sum passes (4 blocks)")

    # (a) on the smaller meshes and shapes, then an all-pad matrix
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    for shape, K, N in (((4, 1), SLICE_K, 65536), ((1, 4), SLICE_K, 65536),
                        ((3, 2), SLICE_K + 1, 4099)):
        wsum_2d(make_planes(torch, K, N, gen, dev), shape, f"{K}x{N}")
        torch.cuda.empty_cache()
    uh = torch.full((300, 1000), 1.0e10, dtype=torch.float32, device=dev)
    mesh = sharding.mesh_2d(2, 2, device=dev)
    hi, lo, _, _, _ = sharding.shard_dd_planes_2d(uh, torch.zeros_like(uh), np.ones(300),
                                                  np.zeros(300), mesh)
    gh, gl = make_planes(torch, 300, 8, gen, dev)[2:]
    S = dd_to_f64(*sharding.sharded2d_wsum_dd(hi, lo, gh, gl, mesh))
    emit("10a_all_pad", mesh=[2, 2], K=300, N=1000, S_zero=bool((S == 0).all()))
    if not bool((S == 0).all()):
        fail("sharded2d_wsum_dd: an all-pad matrix gave S != 0")
    del uh, hi, lo, S

    # (c) the float64 Anderson solve (no kernel), under 1 GB of u_kn
    u_kn, N_k, _fa, _x = oscillators(torch, FLAGSHIP_K, 96,
                                     torch.Generator(device=dev).manual_seed(SEED + 11), dev)
    t0 = start()
    f_c, info_c = sharding.sharded2d_solve_mbar(u_kn, N_k, mesh=sharding.mesh_2d(2, 2, device=dev))
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    f_one = MBAR(u_kn, N_k).f_k
    df = float(np.abs(f_c - f_one).max())
    emit("10c_solve_2d_f64", mesh=[2, 2], K=FLAGSHIP_K, N=u_kn.shape[1], u_kn_bytes=u_kn.nbytes,
         s=solve_s, success=info_c["success"], iterations=info_c["iterations"],
         gnorm=info_c["gnorm"], f_max_err_vs_mbar=df, max_memory_allocated=peak)
    if not (info_c["success"] and df <= 1.0e-9):
        fail(f"sharded2d_solve_mbar: success {info_c['success']}, f {df:.3e} from MBAR")
    del u_kn
    torch.cuda.empty_cache()
    emit("10_mesh_2d", s=time.perf_counter() - t_phase)
    return split, block_err, dict(f=f2d, **solve10)

def phase11(torch, np, flag_seed, flag, mesh4, single5, ex7):
    """A host-resident u_kn: MBAR(cpu_tensor, N_k, device="cuda") keeps
    u_kn in host memory and streams its column chunks to the card.  (a)
    The flagship remade from phase 2's seed and moved to host memory, held
    to phase 2's resident route (``flag``) and phase 7's expectations
    (``ex7``); the link's rates beside it.  (c) The 1-D mesh from the host
    against phase 4's f_k (``mesh4``); (d) the B = 64 counts route against
    phase 5's replicates (``single5``).  (b) The 6x problem, 1024 x 5,856
    per state (49.1 GB of f64), which the resident route cannot hold on
    one card, then its 'svd' from host memory.  Returns K1's launches over
    the phase's runs, each counted from zero, and the 'svd' wall."""
    from pymbar_tpu_torch import MBAR
    from pymbar_tpu_torch.ops import wsum, wsum_split
    from pymbar_tpu_torch.ops.mbar_core import mbar_gradient, stream_columns
    from pymbar_tpu_torch.parallel import sharding

    dev = torch.device("cuda", 0)
    split_names = ("SHIFT_LAUNCHES", "DENOM_SUMS_LAUNCHES", "WSUM_DENOM_LAUNCHES")
    t_phase = time.perf_counter()
    k1_total = 0

    def run(fn):
        """(fn's result, wall, peak device bytes, K1 launches, split-route
        launches), every count set to 0 just before fn."""
        nonlocal k1_total
        sync_all(torch)
        torch.cuda.reset_peak_memory_stats()
        wsum.WSUM_LAUNCHES = 0
        for n in split_names:
            setattr(wsum_split, n, 0)
        t0 = time.perf_counter()
        out = fn()
        sync_all(torch)
        k1 = wsum.WSUM_LAUNCHES
        k1_total += k1
        return (out, time.perf_counter() - t0, torch.cuda.max_memory_allocated(), k1,
                [getattr(wsum_split, n) for n in split_names])

    # ---- (a) the flagship, made on the card as in phase 2, moved to host
    # memory (pageable, as torch.from_numpy gives it); the card copy freed
    u_kn, N_k, fa, x_n = oscillators(torch, FLAGSHIP_K, FLAGSHIP_NPK,
                                     torch.Generator(device=dev).manual_seed(flag_seed), dev)
    u_host = u_kn.cpu()
    del u_kn
    torch.cuda.empty_cache()
    u_bytes = u_host.nbytes

    # the link: one pinned 512 MB upload (median of 5), and a streamed pass
    # over u_host (host cast-copy into pinned staging + upload, nothing done
    # with the chunks), twice
    pinned = torch.empty(2**26, dtype=torch.float64, pin_memory=True)
    on_card = torch.empty(2**26, dtype=torch.float64, device=dev)
    h2d_ms = median_ms(torch, lambda: on_card.copy_(pinned, non_blocking=True))
    del pinned, on_card

    def one_pass():
        for _s, _e, _c in stream_columns(u_host, dev):
            pass

    pass_s = []
    for _ in range(2):
        _o, wall, _p, _k, _sp = run(one_pass)
        pass_s.append(wall)
    pass_time = min(pass_s)

    m, init_s, peak_init, k1_init, split_init = run(lambda: MBAR(u_host, N_k, device="cuda"))
    res, fe_s, peak_fe, _k, _sp = run(m.compute_free_energy_differences)
    ex, ex_s, peak_ex, _k, _sp = run(lambda: m.compute_expectations(x_n))
    info = m.solver_results[0]["info"] if m.solver_results else {}
    off = ~np.eye(FLAGSHIP_K, dtype=bool)
    a = dict(
        route=mesh_route(m)[0], host_resident=m.u_kn is u_host and m.device.type == "cuda",
        u_kn_bytes=u_bytes, init_s=init_s, free_energies_s=fe_s, expectations_s=ex_s,
        resident_init_s=flag["init_s"], resident_free_energies_s=flag["theta_s"],
        pinned_h2d_gb_per_s=2**29 / (h2d_ms * 1e-3) / 1e9,
        streamed_pass_s=pass_s, streamed_pass_gb_per_s=u_bytes / pass_time / 1e9,
        pass_share_of_init=pass_time / init_s, pass_share_of_free_energies=pass_time / fe_s,
        peak_init=peak_init, peak_free_energies=peak_fe, peak_expectations=peak_ex,
        resident_peak=flag["peak"], wsum_launches=k1_init, resident_wsum_launches=flag["launches"],
        split_launches=split_init, polish_iterations=info.get("polish_iterations"),
        f_k_bit_identical=bool(np.array_equal(m.f_k, flag["f_k"])),
        f_k_max_err=float(np.abs(m.f_k - flag["f_k"]).max()),
        delta_f_max_err=float(np.abs(res["Delta_f"] - flag["Delta_f"]).max()),
        ddelta_f_max_rel_err=float(np.max(np.abs(res["dDelta_f"] - flag["dDelta_f"])[off]
                                          / flag["dDelta_f"][off])),
        expectations_mu_max_err=float(np.abs(ex["mu"] - ex7["mu"]).max()),
        expectations_sigma_max_rel_err=float(np.max(np.abs(ex["sigma"] - ex7["sigma"])
                                                    / ex7["sigma"])),
    )
    emit("11a_host_flagship", **a)
    peak_a = max(peak_init, peak_fe)
    if not (a["host_resident"] and a["route"] in ("dd", "mesh") and k1_init == flag["launches"]
            and not any(split_init)):
        fail(f"the host-resident flagship left the resident route's path: {a}")
    if not (a["f_k_max_err"] <= 1e-12 and a["delta_f_max_err"] <= 1e-12
            and a["ddelta_f_max_rel_err"] <= 1e-10):
        fail(f"the host-resident flagship differs from phase 2: {a}")
    if not (a["expectations_mu_max_err"] <= 1e-10 and a["expectations_sigma_max_rel_err"] <= 1e-10):
        fail(f"the host-resident expectations differ from phase 7's: {a}")
    if not peak_a <= 0.6 * flag["peak"]:
        fail(f"host-mode peak {peak_a} above 0.6 x the resident route's {flag['peak']}")
    del m, res, ex

    # ---- (c) the 1-D mesh from the host, (d) the counts-route bootstrap
    n_cards = torch.cuda.device_count()
    mesh = sharding.default_mesh() if n_cards >= 2 else sharding.default_mesh(4, device="cuda:0")
    mm, mesh_s, peak_mesh, k1_mesh, _sp = run(lambda: MBAR(u_host, N_k, mesh=mesh, device="cuda"))
    c = dict(shards=len(mesh.devices), init_s=mesh_s, resident_init_s=mesh4["init_s"],
             peak=peak_mesh, wsum_launches=k1_mesh,
             f_k_max_err_vs_phase4=float(np.abs(mm.f_k - mesh4["f_k"]).max()))
    emit("11c_host_mesh", **c)
    if mm.mesh is not mesh or k1_mesh <= 0 or not c["f_k_max_err_vs_phase4"] <= MESH_DF_TOL:
        fail(f"the mesh from the host: {c}")
    del mm
    mb, boot_s, peak_boot, k1_boot, _sp = run(
        lambda: MBAR(u_host, N_k, n_bootstraps=N_BOOT, rseed=SEED, device="cuda"))
    d = dict(init_s=boot_s, resident_init_s=single5["init_s"], peak=peak_boot,
             wsum_launches=k1_boot, counts_route=mb.bootstrap_at_floor is not None,
             f_k_boots_max_err_vs_phase5=float(np.abs(mb.f_k_boots - single5["f_boots"]).max()))
    emit("11d_host_bootstrap", **d)
    if not (d["counts_route"] and d["f_k_boots_max_err_vs_phase5"] <= 1e-12):
        fail(f"the counts route from the host: {d}")
    del mb, u_host, x_n
    torch.cuda.empty_cache()

    # ---- (b) 1024 x 5,856 per state: made on the card row block by row
    # block into host memory (the card cannot hold it beside its planes)
    K, npk = FLAGSHIP_K, 6 * FLAGSHIP_NPK
    N = K * npk
    gen = torch.Generator(device=dev).manual_seed(flag_seed + 11)
    O = torch.linspace(0.0, 5.0, K, dtype=torch.float64, device=dev)
    Kf = torch.linspace(1.0, 3.0, K, dtype=torch.float64, device=dev)
    x = (O[:, None] + torch.randn((K, npk), generator=gen, dtype=torch.float64, device=dev)
         / torch.sqrt(Kf)[:, None]).reshape(-1)
    t0 = time.perf_counter()
    u_big = torch.empty((K, N), dtype=torch.float64)
    for k0 in range(0, K, 16):
        rows = slice(k0, k0 + 16)
        u_big[rows].copy_(0.5 * Kf[rows, None] * (x[None, :] - O[rows, None]) ** 2)
    make_s = time.perf_counter() - t0
    del x
    fa_big = (-0.5 * torch.log(2 * torch.pi / Kf)).cpu().numpy()
    fa_big -= fa_big[0]
    total = torch.cuda.get_device_properties(0).total_memory
    need = 2 * u_big.nbytes  # u_kn and its dd planes, 8 B/element each
    N_k_big = [npk] * K
    mg, big_s, peak_big, k1_big, split_big = run(lambda: MBAR(u_big, N_k_big, device="cuda"))
    resg, big_fe_s, peak_big_fe, _k, _sp = run(mg.compute_free_energy_differences)
    g64, g_s, _p, _k, _sp = run(lambda: mbar_gradient(u_big, np.asarray(N_k_big, np.float64),
                                                       mg.f_k, device=dev))
    info = mg.solver_results[0]["info"] if mg.solver_results else {}
    iters = info.get("polish_iterations", 0)
    b = dict(
        K=K, N=N, u_kn_bytes=u_big.nbytes, made_in_s=make_s,
        resident_route_need_bytes=need, card_total_memory=total,
        resident_route_arithmetic=f"2 x 8 B x {K} x {N} = {need} B > {total} B: {need > total}",
        route=mesh_route(mg)[0], init_s=big_s, free_energies_s=big_fe_s, f64_gradient_s=g_s,
        phase1_s=info.get("phase1_s"), phase2_s=info.get("phase2_s"), polish_iterations=iters,
        polish_s_per_iteration=info.get("phase2_s", float("nan")) / max(iters, 1),
        wsum_launches=k1_big, split_launches=split_big, peak_init=peak_big,
        peak_free_energies=peak_big_fe, converged=info.get("converged"),
        gradient_norm_per_sample=info.get("gnorm", float("nan")) / N,
        f64_gradient_norm_per_sample=float(torch.linalg.norm(g64)) / N,
        max_abs_z=max_abs_z(resg, fa_big),
    )
    emit("11b_host_6x", **b)
    if not (b["route"] in ("dd", "mesh") and k1_big > 0 and info.get("converged")
            and b["gradient_norm_per_sample"] <= 1e-11
            and b["f64_gradient_norm_per_sample"] <= 1e-11):
        fail(f"the 6x problem did not solve from the host: {b}")
    if not max(peak_big, peak_big_fe) < total:
        fail(f"the 6x problem's peak {max(peak_big, peak_big_fe)} reached the card's {total}")
    check_free_energies(resg, b["max_abs_z"], "6x host-resident")
    # 'svd' from host memory: W's R factor folded chunk by chunk (the whole
    # W alone would be 49.1 GB on the card, and its QR's copy as much again)
    res_svd, svd_s, peak_svd, _k, _sp = run(
        lambda: mg.compute_free_energy_differences(uncertainty_method="svd"))
    svd = dict(s=svd_s, peak=peak_svd, w_bytes=u_big.nbytes, card_total_memory=total,
               ddelta_f_max_abs_diff_vs_svd_ew=float(
                   np.abs(res_svd["dDelta_f"] - resg["dDelta_f"]).max()))
    emit("11b_host_6x_svd", **svd)
    np.testing.assert_almost_equal(res_svd["Delta_f"], resg["Delta_f"], decimal=8)
    np.testing.assert_almost_equal(res_svd["dDelta_f"], resg["dDelta_f"], decimal=8)
    if not peak_svd < total:
        fail(f"'svd' of the 6x problem peaked at {peak_svd} B, the card's {total}")
    del mg, resg, res_svd, u_big
    emit("11_wall", s=time.perf_counter() - t_phase, wsum_launches=k1_total)
    return k1_total, svd_s


def last_digit_unit(token):
    """One unit of the last printed digit of a number token."""
    mantissa, _, exponent = token.lower().partition("e")
    return 10.0 ** (int(exponent or 0) - len(mantissa.partition(".")[2]))


def printed_mismatches(out, ref):
    """Where ``out`` does not print what ``ref`` prints: ["text"] when the
    text around the numbers differs, else the (out, ref) number pairs
    more than one unit of the last digit either printed apart (NaN must
    meet NaN)."""
    import math

    if NUMBER.sub("#", out) != NUMBER.sub("#", ref):
        return ["text"]
    bad = []
    for a, b in zip(NUMBER.findall(out), NUMBER.findall(ref)):
        x, y = float(a), float(b)
        if math.isnan(x) or math.isnan(y) or math.isinf(x) or math.isinf(y):
            ok = (math.isnan(x) and math.isnan(y)) or x == y
        else:
            ok = abs(x - y) <= max(last_digit_unit(a), last_digit_unit(b)) * (1 + 1e-9)
        if not ok:
            bad.append((a, b))
    return bad


def python_blocks(path):
    with open(os.path.join(REPO, path)) as fh:
        return re.findall(r"```python\n(.*?)```", fh.read(), flags=re.DOTALL)


def phase12(torch, np):
    """The public surface as users meet it, the variable unset: (a) the six
    examples on the card, each against its CPU rerun; (b) the doctests of
    mbar, fes and the testsystems; (c) the README's port quickstart and
    docs/torch_port.md's blocks.  Returns K1's launches over the phase's
    card runs, each counted from zero."""
    import pymbar_tpu_torch
    from pymbar_tpu_torch.ops import wsum
    from pymbar_tpu_torch.ops.mbar_core import mbar_gradient

    if DEVICE_VAR in os.environ:
        fail(f"{DEVICE_VAR} is set ({os.environ[DEVICE_VAR]!r}): phase 12 runs with it unset")
    t_phase = time.perf_counter()
    k1_total = 0

    def run(fn):
        """(fn's result, its stdout, wall, CUDA allocations made, K1
        launches), the count set to 0 just before fn."""
        nonlocal k1_total
        sync_all(torch)
        allocs = torch.cuda.memory_stats().get("allocation.all.allocated", 0)
        wsum.WSUM_LAUNCHES = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out = fn()
        sync_all(torch)
        wall = time.perf_counter() - t0
        k1 = wsum.WSUM_LAUNCHES
        k1_total += k1
        grown = torch.cuda.memory_stats().get("allocation.all.allocated", 0) - allocs
        return out, buf.getvalue(), wall, grown, k1

    def exec_block(code, label):
        ns = {}
        exec(compile(code, label, "exec"), ns)
        return ns

    def example(name):
        path = os.path.join(REPO, "examples", name)
        spec = importlib.util.spec_from_file_location(f"example_{name[:-3]}", path)
        module = importlib.util.module_from_spec(spec)
        with mock.patch.dict(sys.modules, {"pymbar_tpu": pymbar_tpu_torch}):
            spec.loader.exec_module(module)
            module.main()

    # (a) the six examples on the card, each against its CPU rerun
    scripts = {}
    for name in EXAMPLES:
        _, card_out, card_s, allocs, k1 = run(lambda: example(name))
        with mock.patch.dict(os.environ, {DEVICE_VAR: "cpu"}):
            _, cpu_out, cpu_s, _, _ = run(lambda: example(name))
        bad = printed_mismatches(card_out, cpu_out)
        scripts[name] = dict(card_s=card_s, cpu_s=cpu_s, cuda_allocations=allocs, wsum_launches=k1,
                             numbers=len(NUMBER.findall(card_out)), mismatches=bad[:5])
        if not card_out.strip() or allocs <= 0 or bad:
            emit("12a_examples", scripts=scripts)
            fail(f"{name}: on the card {allocs} allocations, {len(bad)} printed numbers off "
                 f"the CPU run ({bad[:5]})")
    emit("12a_examples", scripts=scripts)

    # (b) the doctests on the card
    names = ["pymbar_tpu_torch.mbar", "pymbar_tpu_torch.fes"] + [
        f"pymbar_tpu_torch.testsystems.{m}" for m in
        ("harmonic_oscillators", "exponential_distributions", "gaussian_work", "timeseries")]
    doc = {}
    for name in names:
        res, report, s, allocs, k1 = run(lambda: doctest.testmod(importlib.import_module(name)))
        doc[name] = dict(attempted=res.attempted, failed=res.failed, s=s, cuda_allocations=allocs,
                         wsum_launches=k1)
        if res.failed:
            emit("12b_doctests", modules=doc)
            fail(f"{name}: {res.failed} of {res.attempted} doctests failed:\n{report[-3000:]}")
    emit("12b_doctests", modules=doc)
    if sum(d["attempted"] for d in doc.values()) < 54 + 19:
        fail(f"phase 12 (b) ran too few doctests: {doc}")

    # (c) the README's port quickstart and the docs page's blocks
    quick = next(b for b in python_blocks("README.md") if "pymbar_tpu_torch" in b)
    ns, _, quick_s, allocs, k1 = run(lambda: exec_block(quick, "README port quickstart"))
    fa = ns["tc"].analytical_free_energies()
    res = ns["results"]
    z = max_abs_z(res, fa - fa[0])
    ex = ns["ex"]
    z_mean = float(np.max(np.abs(ex["mu"] - ns["tc"].analytical_means())
                          / np.maximum(ex["sigma"], 1e-3)))
    emit("12c_readme_quickstart", s=quick_s, device=str(ns["mbar"].device), max_abs_z=z,
         max_abs_z_means=z_mean, cuda_allocations=allocs, wsum_launches=k1)
    if not (ns["mbar"].device.type == "cuda" and z < 6 and z_mean < 6):
        fail(f"the README's port quickstart: device {ns['mbar'].device}, |z| {z}, {z_mean}")

    blocks = python_blocks("docs/torch_port.md")
    page = []
    for i, block in enumerate(blocks):
        ns, printed, s, allocs, k1 = run(lambda: exec_block(block, f"docs/torch_port.md block {i}"))
        entry = dict(block=i, needs_card=block.startswith(CARD_MARK), s=s, cuda_allocations=allocs,
                     wsum_launches=k1, printed=printed.strip().splitlines())
        if block.startswith(CARD_MARK):
            mbar, host, tc, res = ns["mbar"], ns["host"], ns["tc"], ns["results"]
            fa = tc.analytical_free_energies()
            N = mbar.u_kn.shape[1]
            info = mbar.solver_results[0]["info"]
            g = mbar_gradient(mbar.u_kn, mbar.N_k, mbar.f_k)
            entry.update(
                u_kn_bytes=int(ns["u_kn"].nbytes), route=mesh_route(mbar)[0],
                max_abs_z=max_abs_z(res, fa - fa[0]),
                gradient_norm_per_sample=float(info["gnorm"]) / N,
                f64_gradient_norm_per_sample=float(torch.linalg.norm(g)) / N,
                host_resident=bool(host.u_kn.device.type == "cpu" and host.device.type == "cuda"),
                host_f_k_max_diff=float(np.abs(host.f_k - mbar.f_k).max()))
            del g
            if not (entry["u_kn_bytes"] == 64 * 1048576 * 8 and entry["route"] == "dd" and k1 > 0
                    and entry["max_abs_z"] < 6 and entry["gradient_norm_per_sample"] <= 1e-11
                    and entry["f64_gradient_norm_per_sample"] <= 1e-11 and entry["host_resident"]
                    and entry["host_f_k_max_diff"] <= 1e-12):
                emit("12c_docs", blocks=page + [entry])
                fail(f"docs/torch_port.md's card block: {entry}")
            del mbar, host, tc, res
        page.append(entry)
        del ns
        torch.cuda.empty_cache()
    emit("12c_docs", blocks=page)
    if not any(e["needs_card"] for e in page):
        fail("docs/torch_port.md has no block marked for the card")
    emit("12_wall", s=time.perf_counter() - t_phase, wsum_launches=k1_total)
    return k1_total


def phase13(torch, np, flag_seed, fes8, boot9, svd6, slice_state, solve10, split10):
    """The paths a host-resident u_kn took last: FES, the batched bootstrap,
    'svd' and the 2-D mesh, each from a CPU tensor with device="cuda", held
    to the resident route's results of phases 6, 8, 9 and 10 (``svd6``,
    ``fes8``, ``boot9``, ``solve10`` with ``split10``, its split-kernel
    launches).  (a) The umbrella cell, then the flagship histogram with its
    peak; (b) the umbrella cell with its unbiased state unsampled, on the
    batched route; (c) 'svd' at the flagship; (d) the slice streamed into
    (2, 2) blocks of cuda:0 and solved.  Each run on its own line with its
    wall, its peak above what was resident and its launches, every count
    set to 0 just before it.  Returns (K1's launches over the phase's runs,
    the shift's, K3's and K4's in (d)'s solve)."""
    from pymbar_tpu_torch import FES, MBAR
    from pymbar_tpu_torch import solvers as tsolvers
    from pymbar_tpu_torch.ops import mbar_core, wsum, wsum_split
    from pymbar_tpu_torch.parallel import sharding

    dev = torch.device("cuda", 0)
    split_names = ("SHIFT_LAUNCHES", "DENOM_SUMS_LAUNCHES", "WSUM_DENOM_LAUNCHES")
    t_phase = time.perf_counter()
    k1_total = 0

    def nan_max_diff(a, b, rel=False):
        """max |a - b| (relative to |b| with ``rel``) where both are numbers;
        inf if a and b are NaN in other places."""
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if not np.array_equal(np.isnan(a), np.isnan(b)):
            return float("inf")
        d = np.abs(a - b)[~np.isnan(a)]
        if rel:
            d = d / np.maximum(np.abs(b[~np.isnan(b)]), np.finfo(np.float64).tiny)
        return float(d.max()) if d.size else 0.0

    def run(label, fn, **fields):
        """(fn's result, wall, peak above resident, K1 launches, split
        launches), every count set to 0 just before fn; one line each."""
        nonlocal k1_total
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        wsum.WSUM_LAUNCHES = 0
        for n in split_names:
            setattr(wsum_split, n, 0)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - resident
        k1, split = wsum.WSUM_LAUNCHES, [getattr(wsum_split, n) for n in split_names]
        k1_total += k1
        emit(f"13{label}", s=wall, peak_above_resident=peak, wsum_launches=k1,
             split_launches=split, **fields)
        return out, wall, peak, k1, split

    def to_host(u_dev):
        """A card tensor moved to host memory (pageable, as torch.from_numpy
        gives it), the card copy freed by the caller's del."""
        out = u_dev.cpu()
        torch.cuda.synchronize()
        return out

    # ---- (a) phase 8's umbrella cell, u_kn made on the card as phase 8
    # makes it (the same bits), then kept in host memory
    x_n, centers, K0, Ku = umbrella_x(np)
    u_n = (K0 / 2.0) * x_n**2
    N_k = np.full(FES_KW, FES_NPW, dtype=np.int64)
    x_dev = torch.as_tensor(x_n, device=dev)
    c_dev = torch.as_tensor(centers, device=dev)[:, None]
    u_host = to_host((K0 / 2.0) * x_dev[None, :] ** 2 + (Ku / 2.0) * (x_dev[None, :] - c_dev) ** 2)
    torch.cuda.empty_cache()
    edges = np.linspace(x_n.min() - 1e-6, x_n.max() + 1e-6, FES_NBINS + 1)
    cent = 0.5 * (edges[1:] + edges[:-1])
    hist = dict(bin_edges=edges)
    ref = fes8["umbrella"]

    fes, init_s, init_peak, _k, _sp = run("a_umbrella_init",
                                          lambda: FES(u_host, N_k, device="cuda"),
                                          u_kn_bytes=u_host.nbytes)

    def histogram():
        fes.generate_fes(u_n, x_n, histogram_parameters=hist)
        return fes.get_fes(cent, reference_point="from-lowest", uncertainty_method="analytical")

    def bootstrap():
        fes.generate_fes(u_n, x_n, histogram_parameters=hist, n_bootstraps=FES_BOOT,
                         seed=SEED % 2**31)
        return fes.bootstrap_route, fes.f_k_boots.copy()

    def kde():
        fes.generate_fes(u_n, x_n, fes_type="kde",
                         kde_parameters={"bandwidth": 0.5 * (edges[1] - edges[0])})
        return fes.get_fes(cent, reference_point="from-lowest")["f_i"]

    r, hist_s, hist_peak, _k, _sp = run("a_umbrella_histogram", histogram)
    (boot_route, f_boots), boot_s, boot_peak, _k, _sp = run("a_umbrella_bootstrap", bootstrap,
                                                            n_bootstraps=FES_BOOT)
    f_kde, kde_s, _p, _k, _sp = run("a_umbrella_kde", kde)
    a = dict(
        host_resident=fes.u_kn is u_host and fes.mbar.device.type == "cuda",
        route=mesh_route(fes.mbar)[0], bootstrap_route=boot_route,
        resident_init_s=ref["init_s"], resident_histogram_s=ref["histogram_s"],
        f_k_bit_identical=bool(np.array_equal(fes.mbar.f_k, ref["f_k"])),
        f_i_max_err=nan_max_diff(r["f_i"], ref["f_i"]),
        df_i_max_rel_err=nan_max_diff(r["df_i"], ref["df_i"], rel=True),
        f_k_boots_max_err=float(np.abs(f_boots - ref["f_k_boots"]).max()),
        kde_f_i_max_err=nan_max_diff(f_kde, ref["kde_f_i"]),
    )
    emit("13a_umbrella_checks", **a)
    if not (a["host_resident"] and a["route"] in ("dd", "mesh")
            and a["bootstrap_route"] == ("counts" if a["route"] == "dd" else "replicate")):
        fail(f"the host-resident umbrella FES left the resident route's path: {a}")
    if not (a["f_i_max_err"] <= 1e-12 and a["df_i_max_rel_err"] <= 1e-10
            and a["f_k_boots_max_err"] <= 1e-12 and a["kde_f_i_max_err"] <= 1e-12):
        fail(f"the host-resident umbrella FES differs from phase 8's: {a}")
    del fes, u_host

    # the flagship histogram (phase 8b) from host memory: u_kn remade from
    # phase 2's seed on the card, moved to the host and freed there
    u_kn, N_k_f, _fa, x_f = oscillators(torch, FLAGSHIP_K, FLAGSHIP_NPK,
                                        torch.Generator(device=dev).manual_seed(flag_seed), dev)
    u_flag = to_host(u_kn)
    del u_kn
    torch.cuda.empty_cache()
    mid = FLAGSHIP_K // 2
    xb = x_f.cpu().numpy()
    edges_b = np.linspace(xb.min() - 1e-6, xb.max() + 1e-6, FES_NBINS + 1)
    cent_b = 0.5 * (edges_b[1:] + edges_b[:-1])
    ref_f = fes8["flagship"]
    fes, fi_s, fi_peak, _k, _sp = run("a_flagship_init",
                                      lambda: FES(u_flag, N_k_f, device="cuda"),
                                      u_kn_bytes=u_flag.nbytes)

    def flagship_histogram():
        fes.generate_fes(u_flag[mid], x_f, histogram_parameters=dict(bin_edges=edges_b))
        return fes.get_fes(cent_b, reference_point="from-lowest", uncertainty_method="analytical")

    rf, fh_s, fh_peak, _k, _sp = run("a_flagship_histogram", flagship_histogram, nbins=FES_NBINS)
    host_peak = max(fi_peak, fh_peak)
    af = dict(
        host_resident=fes.u_kn is u_flag, init_s=fi_s, histogram_s=fh_s,
        resident_init_s=ref_f["init_s"], resident_histogram_s=ref_f["histogram_s"],
        peak=host_peak, resident_peak_with_u_kn=ref_f["peak"],
        peak_ratio=host_peak / ref_f["peak"],
        f_i_max_err=nan_max_diff(rf["f_i"], ref_f["f_i"]),
        df_i_max_rel_err=nan_max_diff(rf["df_i"], ref_f["df_i"], rel=True),
    )
    emit("13a_flagship_checks", **af)
    if not (af["host_resident"] and af["f_i_max_err"] <= 1e-12 and af["df_i_max_rel_err"] <= 1e-10):
        fail(f"the host-resident flagship histogram differs from phase 8b's: {af}")
    if not host_peak <= 0.6 * ref_f["peak"]:
        fail(f"the flagship histogram from the host peaked at {host_peak} B, above 0.6 x the "
             f"resident route's {ref_f['peak']} B")

    # ---- (c) 'svd' at the flagship from host memory (the FES's MBAR)
    res_svd, svd_s, svd_peak, _k, _sp = run(
        "c_flagship_svd", lambda: fes.mbar.compute_free_energy_differences(
            uncertainty_method="svd"),
        phase6_s=svd6["s"], phase6_peak=svd6["peak"], pr6_whole_w_peak=SVD_WHOLE_W_PEAK)
    res_ew, _s, _p, _k, _sp = run("c_flagship_svd_ew",
                                  lambda: fes.mbar.compute_free_energy_differences())
    svd_dev = float(np.abs(res_svd["dDelta_f"] - res_ew["dDelta_f"]).max())
    emit("13c_svd_checks", ddelta_f_max_abs_diff_vs_svd_ew=svd_dev, peak=svd_peak,
         half_whole_w_peak=SVD_WHOLE_W_PEAK / 2)
    np.testing.assert_almost_equal(res_svd["Delta_f"], res_ew["Delta_f"], decimal=8)
    np.testing.assert_almost_equal(res_svd["dDelta_f"], res_ew["dDelta_f"], decimal=8)
    if not svd_peak < SVD_WHOLE_W_PEAK / 2:
        fail(f"'svd' from the host peaked at {svd_peak} B")
    del fes, u_flag, x_f, res_svd, res_ew
    torch.cuda.empty_cache()

    # ---- (b) the umbrella cell with its unbiased state unsampled (phase
    # 9c's 545 MB, made as there), B = 16 on the batched route from host
    # memory, at phase 9c's chunk width (the same working set)
    u_c = to_host(torch.cat([(K0 / 2.0) * x_dev[None, :] ** 2 + (Ku / 2.0) * (
        x_dev[None, :] - c_dev) ** 2, (K0 / 2.0) * x_dev[None, :] ** 2]))
    del x_dev, c_dev
    torch.cuda.empty_cache()
    N_k_c = np.append(N_k, 0)
    gathered, solved = [], []
    solve_fn, chunk_fn, gather_fn = (tsolvers.batched_bootstrap_solve, tsolvers._boot_chunk,
                                     tsolvers._gather_replicates)

    def solve(*args, **kw):
        out = solve_fn(*args, **kw)
        solved.append(out[1])
        return out

    def gather(u, *args):
        gathered.append(u.device.type)
        return gather_fn(u, *args)

    tsolvers.batched_bootstrap_solve, tsolvers._gather_replicates = solve, gather
    tsolvers._boot_chunk = lambda *args: boot9["chunk"]
    try:
        m_c, b_s, b_peak, _k, _sp = run(
            "b_umbrella_unbiased_batched",
            lambda: MBAR(u_c, N_k_c, n_bootstraps=FES_BOOT, rseed=SEED, device="cuda"),
            u_kn_bytes=u_c.nbytes, chunk=boot9["chunk"])
    finally:
        tsolvers.batched_bootstrap_solve, tsolvers._boot_chunk = solve_fn, chunk_fn
        tsolvers._gather_replicates = gather_fn
    # the two staging buffers of stream_columns, one column chunk each
    K_c, N_c = u_c.shape
    staging = 2 * 8 * K_c * min(N_c, mbar_core._CHUNK_BYTES // (8 * K_c))
    bb = dict(
        host_resident=m_c.u_kn is u_c, batched_calls=len(solved), gathered_from=sorted(set(gathered)),
        n_fail=solved[0] if solved else None, resident_n_fail=boot9["n_fail"],
        resident_init_s=boot9["init_s"], peak=b_peak, staging_bytes=staging,
        resident_peak_above_u_kn=boot9["peak_above_resident"],
        resident_peak_with_u_kn=boot9["peak_above_resident"] + boot9["u_kn_bytes"],
        f_k_boots_max_err=float(np.abs(m_c.f_k_boots - boot9["f_k_boots"]).max()),
    )
    emit("13b_batched_checks", **bb)
    if not (bb["host_resident"] and bb["batched_calls"] == 1 and bb["gathered_from"] == ["cpu"]
            and bb["n_fail"] == bb["resident_n_fail"] and bb["f_k_boots_max_err"] <= 1e-12):
        fail(f"the batched bootstrap from the host differs from phase 9c's: {bb}")
    if not b_peak <= boot9["peak_above_resident"] + staging:
        fail(f"the batched bootstrap from the host held more than phase 9c's working set and "
             f"the staging buffers: {bb}")
    del m_c, u_c

    # ---- (d) the slice (phase 3's u_kn, remade bit for bit) in host
    # memory, streamed into (2, 2) blocks of cuda:0 and solved as phase 10b
    gen = torch.Generator(device=dev)
    gen.set_state(slice_state)
    u_kn, N_k_s, _fa, _x = oscillators(torch, SLICE_K, SLICE_NPK, gen, dev)
    del _x
    u_slice = to_host(u_kn)
    del u_kn
    torch.cuda.empty_cache()
    mesh = sharding.mesh_2d(2, 2, device=dev)
    block_bytes = 8 * u_slice.shape[0] * u_slice.shape[1]
    blocks, split_s, split_peak, _k, _sp = run(
        "d_slice_stream_2d", lambda: sharding.stream_shard_planes_2d(
            u_slice, N_k_s, np.zeros(SLICE_K), mesh),
        mesh=[2, 2], u_kn_bytes=u_slice.nbytes, block_bytes=block_bytes)
    hi, lo = blocks[0], blocks[1]
    del blocks
    (f2d, info), solve_s, solve_peak, k1_d, split_d = run(
        "d_slice_solve_2d", lambda: sharding.sharded2d_solve_mbar_dd(hi, lo, N_k_s, mesh=mesh))
    d = dict(
        split_s=split_s, split_gb_per_s=u_slice.nbytes / split_s / 1e9, split_peak=split_peak,
        resident_route_holds=3 * block_bytes, solve_s=solve_s, resident_solve_s=solve10["s"],
        converged=info["converged"], f_max_err_vs_phase10b=float(np.abs(f2d - solve10["f"]).max()),
        split_launches=split_d, phase10b_split_launches=list(split10), wsum_launches=k1_d,
    )
    emit("13d_mesh_2d_checks", **d)
    if not (info["converged"] and d["f_max_err_vs_phase10b"] <= 1e-12):
        fail(f"the 2-D solve from host memory differs from phase 10b's: {d}")
    if k1_d != 0 or split_d != list(split10):
        fail(f"the 2-D solve from host memory launched K1 {k1_d} times and the split kernels "
             f"{split_d} (phase 10b: {list(split10)})")
    if not split_peak < 1.5 * block_bytes:
        fail(f"the streamed 2-D split peaked at {split_peak} B for {block_bytes} B of blocks")
    del hi, lo, u_slice
    torch.cuda.empty_cache()
    emit("13_wall", s=time.perf_counter() - t_phase, wsum_launches=k1_total)
    return k1_total, split_d


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA card")
    if not os.path.isdir(os.path.join(REPO, "pymbar_tpu_torch")):
        fail(f"pymbar_tpu_torch/ not found beside {__file__}")
    sys.path.insert(0, REPO)
    import numpy as np

    from pymbar_tpu_torch import MBAR, bar, checkpoint, config, exp, testsystems, timeseries
    from pymbar_tpu_torch.mbar import bootstrap_counts
    from pymbar_tpu_torch.ops import _build, gram_weights, lognum, mbar_core, roofline, wsum, wsum_split
    from pymbar_tpu_torch.ops.doubledouble import dd_from_f64, dd_to_f64
    from pymbar_tpu_torch.parallel import sharding
    from pymbar_tpu_torch.ops.mbar_core import mbar_gradient, mbar_gram_normalization
    from pymbar_tpu_torch.utils import check_w_normalized
    from pymbar_tpu_torch.solvers_large import (
        bootstrap_polish_dd,
        dev_split_planes,
        solve_mbar_dd,
    )

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
        name: [line.strip() for line in (config.build_dir() / f"{name}.log").read_text().splitlines()
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

    def rand_counts(N):
        return torch.randint(0, 4, (N,), generator=gen, device=dev).to(torch.float32)

    def same_bits(label, fn):
        a, b = fn(), fn()
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            fail(f"{label}: two calls on the same inputs gave different bits")
        checks.append(dict(kernel="wsum_dd", case=f"{label}: two calls", same_bits=True))

    uh, ul, gh, gl = make_planes(torch, 1024, 65536, gen, dev)
    compare("1024x65536", uh, ul, gh, gl)
    c = rand_counts(65536)
    compare("1024x65536 counts", uh, ul, gh, gl, c)
    same_bits("1024x65536 counts (fused)", lambda: wsum.wsum_dd(uh, ul, gh, gl, c))
    compare("3x1000 ragged", *make_planes(torch, 3, 1000, gen, dev))
    compare("4096x8192", *make_planes(torch, 4096, 8192, gen, dev))
    # K = 1; K not a multiple of the cluster's blocks or of their rows; N
    # below one column tile and not a multiple of it (nor of 4: the 4-byte
    # copies); K at the split-route gate (clusters of 8) and one above (the
    # split route); K1's limit, 8192 states (clusters of 16, the
    # non-portable size) and one above, which must raise
    compare("1x1", *make_planes(torch, 1, 1, gen, dev))
    compare("1x5000 counts", *make_planes(torch, 1, 5000, gen, dev), rand_counts(5000))
    compare("1000x4099 counts", *make_planes(torch, 1000, 4099, gen, dev), rand_counts(4099))
    compare("257x70", *make_planes(torch, 257, 70, gen, dev))
    compare("1024x15 (below one column tile)", *make_planes(torch, 1024, 15, gen, dev))
    gate = wsum._SPLIT_ROUTE_K
    at_gate = make_planes(torch, gate, 5000, gen, dev)
    c = rand_counts(5000)
    compare(f"{gate}x5000 counts (split-route gate)", *at_gate, c)
    same_bits(f"{gate}x5000 counts (clusters of 8)", lambda: wsum.wsum_dd(*at_gate, c))
    S_pad = dd_to_f64(*wsum.wsum_dd(
        torch.full((gate, 33), 1.0e10, dtype=torch.float32, device=dev),
        torch.zeros((gate, 33), dtype=torch.float32, device=dev), *at_gate[2:]))
    if not bool((S_pad == 0).all()):
        fail("an all-pad matrix gave S != 0 with clusters of 8")
    del at_gate
    above = make_planes(torch, gate + 1, 5000, gen, dev)
    before = wsum.WSUM_LAUNCHES
    e = rel_err(dd_to_f64(*wsum.wsum_dd(*above)), dd_to_f64(*wsum.wsum_dd_plain(*above)))
    checks.append(dict(kernel="wsum_dd", case=f"{gate + 1}x5000 (split route)", rel_err=e))
    if wsum.WSUM_LAUNCHES != before or not e <= S_REL_TOL:
        fail(f"{gate + 1} states: K1 launched or the split route is off by {e:.3e}")
    del above
    wsum._SPLIT_ROUTE_K = 2**31
    try:
        top = make_planes(torch, 8192, 5000, gen, dev)
        compare("8192x5000 counts (clusters of 16)", *top, rand_counts(5000))
        del top
        over = make_planes(torch, 8193, 64, gen, dev)
        try:
            wsum.wsum_dd(*over)
        except RuntimeError:
            checks.append(dict(kernel="wsum_dd", case="8193x64 raises", raised=True))
        else:
            fail("K1 took 8193 states, beyond its largest cluster")
        del over
    finally:
        wsum._SPLIT_ROUTE_K = gate
    # the flagship's mesh shard (4 shards of 999,424 samples), with and
    # without counts
    shard = make_planes(torch, FLAGSHIP_K, FLAGSHIP_K * FLAGSHIP_NPK // 4, gen, dev)
    compare(f"{FLAGSHIP_K}x{FLAGSHIP_K * FLAGSHIP_NPK // 4} mesh shard", *shard)
    compare(f"{FLAGSHIP_K}x{FLAGSHIP_K * FLAGSHIP_NPK // 4} mesh shard counts", *shard,
            rand_counts(shard[0].shape[1]))
    del shard
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
    # rows not a multiple of the row block; N not a multiple of the column
    # tile nor of 4 (the row pass's 4-byte copies); N below one tile
    compare_split(f"{SLICE_K + 8}x4099 counts", *make_planes(torch, SLICE_K + 8, 4099, gen, dev),
                  rand_counts(4099))
    compare_split("33x127", *make_planes(torch, 33, 127, gen, dev))
    # two calls give the same bits; a masked column (d = 0) whose exp
    # overflows (m_n far below a_kn) adds exactly 0 and no NaN
    uh, ul, gh, gl = make_planes(torch, SLICE_K, 4096, gen, dev)
    c = rand_counts(4096)
    m, _, (dh, dl), _ = split_steps(uh, ul, gh, gl, c)
    k4 = lambda *a: wsum_split.wsum_denom_dd(uh, ul, gh, gl, *a, c)  # noqa: E731
    a, b = k4(m, dh, dl), k4(m, dh, dl)
    if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
        fail("wsum_denom_dd: two calls on the same inputs gave different bits")
    cols = [5, 4000]
    m2, dh2, dl2 = m.clone(), dh.clone(), dl.clone()
    m2[cols], dh2[cols], dl2[cols] = -2000.0, 0.0, 0.0
    S_masked = dd_to_f64(*k4(m2, dh2, dl2))
    keep = torch.ones(4096, dtype=torch.bool, device=dev)
    keep[cols] = False
    S_drop = dd_to_f64(*wsum_split.wsum_denom_dd(
        uh[:, keep].contiguous(), ul[:, keep].contiguous(), gh, gl,
        *(t[keep].contiguous() for t in (m, dh, dl, c))))
    e_mask = rel_err(S_masked, S_drop)
    split_checks.append(dict(case=f"{SLICE_K}x4096 masked overflowing columns", rel_err=e_mask,
                             finite=bool(torch.isfinite(S_masked).all()), same_bits=True))
    if not (bool(torch.isfinite(S_masked).all()) and e_mask <= S_REL_TOL):
        fail(f"a masked column with an overflowing exp changed S ({e_mask:.3e}) or gave NaN")
    del uh, ul, m, dh, dl, m2, dh2, dl2, keep, a, b
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
    # One PyTorch call computes each function: the shift is torch.amax over
    # k of g_hi - u_hi; K3's log s_n + m_n is torch.logsumexp over k of
    # g - u; K4's log S_k is torch.logsumexp over n of g - u - L_n with the
    # (N,) L_n = m_n + log s_n.  Timed from the planes (the combine in
    # place, so the slice's 21.5 GB input and the call's own temporary fit
    # beside the planes: library_ms), then on an f64 u built once, with the
    # planes freed.
    g64 = dd_to_f64(gh, gl)
    s64 = dd_to_f64(dh, dl)
    L = m.to(torch.float64) + torch.log(s64)

    def minus_u(pre=None):
        """g - u (- L) from the planes, in one float64 temporary."""
        a = uh.to(torch.float64).neg_().add_(g64[:, None]).sub_(ul)
        return a if pre is None else a.sub_(pre[None, :])

    split_lib = dict(
        column_shift=lambda: torch.amax(gh[:, None] - uh, dim=0),
        denom_sums_dd=lambda: torch.logsumexp(minus_u(), dim=0),
        wsum_denom_dd=lambda: torch.logsumexp(minus_u(L), dim=1),
    )
    split_names = ("column_shift", "denom_sums_dd", "wsum_denom_dd")
    S_k4 = dd_to_f64(*wsum_split.wsum_denom_dd(uh, ul, gh, gl, m, dh, dl))
    lib_vals = {k: split_lib[k]() for k in split_names}
    split_lib_err = dict(
        column_shift=float((lib_vals["column_shift"] - m).abs().max()),
        denom_sums_dd=float((lib_vals["denom_sums_dd"] - L).abs().max()),
        wsum_denom_dd=float((lib_vals["wsum_denom_dd"] - torch.log(S_k4)).abs().max()),
    )
    del lib_vals, S_k4
    torch.cuda.empty_cache()
    split_lib_planes = {k: median_ms(torch, split_lib[k]) for k in split_names}
    u64 = uh.to(torch.float64).add_(ul)  # dd_to_f64 without its two temporaries
    del planes, uh, ul
    torch.cuda.empty_cache()
    split_lib_f64 = dict(
        column_shift=median_ms(torch, lambda: torch.amax(gh.to(torch.float64)[:, None] - u64,
                                                         dim=0)),
        denom_sums_dd=median_ms(torch, lambda: torch.logsumexp(g64[:, None] - u64, dim=0)),
        wsum_denom_dd=median_ms(torch, lambda: torch.logsumexp(
            (g64[:, None] - u64).sub_(L[None, :]), dim=1)),
    )
    for k in split_names:
        times[k] = (*times[k], split_lib_planes[k])
    del u64, gh, gl, m, dh, dl, g64, s64, L
    torch.cuda.empty_cache()
    emit("1_split_kernels", checks=split_checks,
         max_abs_err={k: err[k] for k in split_names},
         shape=[SLICE_K, N_slice],
         ms={k: times[k][0] for k in split_names},
         plain_ms={k: times[k][1] for k in split_names},
         split_route_ms=route_ms, k1_ms=k1_slice_ms,
         library_ms_from_planes=split_lib_planes, library_ms_f64_u=split_lib_f64,
         library_max_abs_diff_vs_kernel=split_lib_err)

    # ---- phase 1c: the lognum family against its plain versions
    ln_names = ("logden_dd", "lognum_dd", "lognum_fused_dd")
    ln_counters = ("LOGDEN_LAUNCHES", "LOGNUM_LAUNCHES", "LOGNUM_FUSED_LAUNCHES")
    err.update({k: 0.0 for k in ln_names})
    lognum_checks = []

    def compare_lognum(label, uh, ul, gh, gl):
        """K6, K7 (on K6's ld) and K5 by the kernels and by their plain
        versions on the kernels' own inputs.  Returns (K5's sums, m_k)."""
        before = [getattr(lognum, n) for n in ln_counters]
        ld = lognum.logden_dd(uh, ul, gh, gl)
        m_k = lognum_shift(torch, uh, ld[0])
        ln = dd_to_f64(*lognum.lognum_dd(uh, ul, *ld, m_k))
        s5 = dd_to_f64(*lognum.lognum_fused_dd(uh, ul, gh, gl, m_k, return_sums=True))
        ln5 = dd_to_f64(*lognum.lognum_fused_dd(uh, ul, gh, gl, m_k))
        torch.cuda.synchronize()
        if [getattr(lognum, n) for n in ln_counters] != [before[0] + 1, before[1] + 1, before[2] + 2]:
            fail(f"{label}: a lognum launch count did not rise")
        ld64 = dd_to_f64(*ld)
        ld_ref = dd_to_f64(*lognum.logden_dd_plain(uh, ul, gh, gl))
        ln_ref = dd_to_f64(*lognum.lognum_dd_plain(uh, ul, *ld, m_k))
        s_ref = dd_to_f64(*lognum.lognum_fused_dd_plain(uh, ul, gh, gl, m_k, return_sums=True))
        ln5_ref = torch.log(s_ref) + m_k.to(torch.float64)
        # K6 then K7 on K5's masked ld, and the identity with K1
        pad = wsum_split.column_shift(uh, gh) < wsum._PAD_M
        ln67 = dd_to_f64(*lognum.lognum_dd(
            uh, ul, ld[0].masked_fill(pad, 1.0e10), ld[1].masked_fill(pad, 0.0), m_k))
        S1 = dd_to_f64(*wsum.wsum_dd(uh, ul, gh, gl))
        real = ld_ref.abs() < 1.0e8
        e = dict(
            logden_dd=log_err(ld64, ld_ref), lognum_dd=log_err(ln, ln_ref),
            lognum_fused_dd_sums=rel_err(s5, s_ref), lognum_fused_dd=log_err(ln5, ln5_ref),
            k6_k7_masked_vs_k5=log_err(ln67, ln5),
            k1_identity=float((ln5 + dd_to_f64(gh, gl) - torch.log(S1)).abs().max()),
        )
        err["logden_dd"] = max(err["logden_dd"], float((ld64 - ld_ref)[real].abs().max()))
        err["lognum_dd"] = max(err["lognum_dd"], float((ln - ln_ref).abs().max()))
        err["lognum_fused_dd"] = max(err["lognum_fused_dd"], float((ln5 - ln5_ref).abs().max()))
        lognum_checks.append(dict(case=label, K=uh.shape[0], N=uh.shape[1], **e))
        if not (e["logden_dd"] <= LOG_ABS_TOL and e["lognum_dd"] <= LOG_ABS_TOL
                and e["lognum_fused_dd"] <= LOG_ABS_TOL and e["lognum_fused_dd_sums"] <= S_REL_TOL):
            fail(f"{label}: lognum kernels vs plain {e}")
        if not e["k6_k7_masked_vs_k5"] <= S_REL_TOL:
            fail(f"{label}: K6 then K7 on K5's mask differs from K5 by {e['k6_k7_masked_vs_k5']:.3e}")
        if not e["k1_identity"] <= LOG_ABS_TOL:
            fail(f"{label}: lognum_k + g_k differs from log S_k of K1 by {e['k1_identity']:.3e}")
        return s5, m_k, ln

    compare_lognum("1024x65536", *make_planes(torch, 1024, 65536, gen, dev))
    compare_lognum("5x1003 ragged", *make_planes(torch, 5, 1003, gen, dev))
    compare_lognum("1x1", *make_planes(torch, 1, 1, gen, dev))
    compare_lognum("3000x4096 (K above the TPU kernel's 2048 cap)",
                   *make_planes(torch, 3000, 4096, gen, dev))
    uh, ul, gh, gl = make_planes(torch, 4096, 8192, gen, dev)
    s0, m_k, ln0 = compare_lognum("4096x8192", uh, ul, gh, gl)
    uhp = torch.cat([uh, torch.full((4096, 77), 1.0e10, dtype=torch.float32, device=dev)], 1)
    ulp = torch.cat([ul, torch.zeros((4096, 77), dtype=torch.float32, device=dev)], 1)
    compare_lognum("4096x8192 + 77 pad columns", uhp, ulp, gh, gl)
    s1 = dd_to_f64(*lognum.lognum_fused_dd(uhp, ulp, gh, gl, m_k, return_sums=True))
    if rel_err(s1, s0) > S_REL_TOL:
        fail("pad columns changed K5's sums")
    ln1 = dd_to_f64(*lognum.lognum_dd(uhp, ulp, *lognum.logden_dd(uhp, ulp, gh, gl), m_k))
    phantom = float((ln1 - ln0).min())
    if not phantom > 1.0e-4:
        fail(f"K7 lost its phantom terms on pad columns (min shift {phantom:.3e})")
    pad_only = torch.full((4096, 300), 1.0e10, dtype=torch.float32, device=dev)
    s_pad = dd_to_f64(*lognum.lognum_fused_dd(pad_only, torch.zeros_like(pad_only), gh, gl, m_k,
                                              return_sums=True))
    if not bool((s_pad == 0).all()):
        fail("an all-pad matrix gave K5 sums != 0")
    del uh, ul, uhp, ulp, pad_only
    compare_lognum(f"{FLAGSHIP_K}x{N_flag // 4} flagship shard",
                   *make_planes(torch, FLAGSHIP_K, N_flag // 4, gen, dev))
    torch.cuda.empty_cache()
    # K5 runs K1's cluster kernel (its kLognum instantiation): at its
    # limit, 8192 states (clusters of 16; wsum_dd takes its split route
    # there for the identity), above it (raises, launches nothing), bit for
    # bit twice at clusters of 2 and 8, and no K1 launch of its own
    compare_lognum(f"{SLICE_K}x65536 (clusters of 16)", *make_planes(torch, SLICE_K, 65536, gen, dev))
    torch.cuda.empty_cache()
    over = make_planes(torch, SLICE_K + 1, 64, gen, dev)
    before = (lognum.LOGNUM_FUSED_LAUNCHES, wsum.WSUM_LAUNCHES)
    try:
        lognum.lognum_fused_dd(*over, torch.zeros(SLICE_K + 1, dtype=torch.float32, device=dev))
    except RuntimeError:
        lognum_checks.append(dict(case=f"{SLICE_K + 1}x64 raises", raised=True))
    else:
        fail("K5 took 8193 states, beyond the cluster kernel's limit")
    if (lognum.LOGNUM_FUSED_LAUNCHES, wsum.WSUM_LAUNCHES) != before:
        fail("K5 launched on 8193 states")
    del over
    for K_b in (1024, 4096):
        uh, ul, gh, gl = make_planes(torch, K_b, 20000, gen, dev)
        m_k = lognum_shift(torch, uh, lognum.logden_dd(uh, ul, gh, gl)[0])
        before = wsum.WSUM_LAUNCHES
        a, b = (lognum.lognum_fused_dd(uh, ul, gh, gl, m_k, return_sums=True) for _ in range(2))
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            fail(f"K5: two calls at K = {K_b} gave different bits")
        if wsum.WSUM_LAUNCHES != before:
            fail("a K5 call raised WSUM_LAUNCHES")
        lognum_checks.append(dict(case=f"{K_b}x20000 two calls (clusters of {K_b // 512})",
                                  same_bits=True))
    # The rows K5 takes in its direct form: row 3's g lowered by 750 below
    # the others, row 5's the -1e10 sentinel over real u (a clash-level
    # row), each with m_k its own lognum from the plain twin, so s_k ~ 1
    # while every T_kn = exp(a_kn - m_n) of the row underflows
    uh, ul, gh, gl = make_planes(torch, FLAGSHIP_K, 65536, gen, dev)
    g = dd_to_f64(gh, gl)
    g[3] -= 750.0
    g[5] = -1.0e10
    gh, gl = dd_from_f64(g)
    m_k = lognum_shift(torch, uh, lognum.logden_dd(uh, ul, gh, gl)[0])
    m_n = wsum_split.column_shift(uh, gh).to(torch.float64)
    ln_ref = dd_to_f64(*lognum.lognum_fused_dd_plain(uh, ul, gh, gl, m_k))
    far = [3, 5]
    m_k[far] = ln_ref[far].to(torch.float32)
    T_far = max(float((dd_to_f64(gh, gl)[k] - dd_to_f64(uh[k], ul[k]) - m_n).max()) for k in far)
    s5 = dd_to_f64(*lognum.lognum_fused_dd(uh, ul, gh, gl, m_k, return_sums=True))
    ln5 = dd_to_f64(*lognum.lognum_fused_dd(uh, ul, gh, gl, m_k))
    s_ref = dd_to_f64(*lognum.lognum_fused_dd_plain(uh, ul, gh, gl, m_k, return_sums=True))
    e = dict(lognum_fused_dd_sums=rel_err(s5, s_ref),
             lognum_fused_dd=log_err(ln5, torch.log(s_ref) + m_k.to(torch.float64)),
             far_rows_s=[float(s_ref[k]) for k in far], far_rows_max_a_minus_m=T_far)
    lognum_checks.append(dict(case=f"{FLAGSHIP_K}x65536 direct-form rows (g - 750, g = -1e10)", **e))
    if not (e["lognum_fused_dd_sums"] <= S_REL_TOL and e["lognum_fused_dd"] <= LOG_ABS_TOL):
        fail(f"K5's direct-form rows vs plain {e}")
    if not (T_far < -745.0 and all(abs(v - 1.0) < 1e-5 for v in e["far_rows_s"])):
        fail(f"the direct-form rows are not the ones intended: {e}")
    del uh, ul, gh, gl, g, m_k, m_n
    torch.cuda.empty_cache()
    planes = make_planes(torch, FLAGSHIP_K, N_flag, gen, dev)
    compare_lognum(f"{FLAGSHIP_K}x{N_flag} flagship shape", *planes)
    uh, ul, gh, gl = planes
    ld = lognum.logden_dd(uh, ul, gh, gl)
    m_k = lognum_shift(torch, uh, ld[0])
    ln_flag = dd_to_f64(*lognum.lognum_dd(uh, ul, *ld, m_k))
    times["logden_dd"] = (median_ms(torch, lambda: lognum.logden_dd(*planes)),
                          median_ms(torch, lambda: lognum.logden_dd_plain(*planes)))
    times["lognum_dd"] = (median_ms(torch, lambda: lognum.lognum_dd(uh, ul, *ld, m_k)),
                          median_ms(torch, lambda: lognum.lognum_dd_plain(uh, ul, *ld, m_k)))
    times["lognum_fused_dd"] = (
        median_ms(torch, lambda: lognum.lognum_fused_dd(*planes, m_k, return_sums=True)),
        median_ms(torch, lambda: lognum.lognum_fused_dd_plain(*planes, m_k, return_sums=True)))
    # K5 and K1 share one kernel: their medians in turns (K1, K5, K5, K1)
    calls = {"wsum_dd": lambda: wsum.wsum_dd(*planes),
             "lognum_fused_dd": lambda: lognum.lognum_fused_dd(*planes, m_k, return_sums=True)}
    k5_vs_k1 = {name: [] for name in calls}
    for name in ("wsum_dd", "lognum_fused_dd", "lognum_fused_dd", "wsum_dd"):
        k5_vs_k1[name].append(median_ms(torch, calls[name]))
    emit("1_k5_vs_k1", card=smi, shape=[FLAGSHIP_K, N_flag], ms=k5_vs_k1,
         k5_over_k1=statistics.median(k5_vs_k1["lognum_fused_dd"])
         / statistics.median(k5_vs_k1["wsum_dd"]))
    # One PyTorch call computes K6's function (logsumexp over k) and one K7's
    # (over n); K5's is the two in turn.  Timed on an f64 u built once from
    # the same planes, then with the plane combine, which makes them take
    # the kernels' own inputs (library_ms).
    g64, ld64 = dd_to_f64(gh, gl), dd_to_f64(*ld)

    def k6_lib(u):
        return torch.logsumexp(g64[:, None] - u, dim=0)

    def k7_lib(u, logden):
        return torch.logsumexp(-logden[None, :] - u, dim=1)

    def k5_lib(u):
        return k7_lib(u, k6_lib(u))

    u64 = dd_to_f64(uh, ul)
    lib_err = dict(logden_dd=float((k6_lib(u64) - ld64).abs().max()),
                   lognum_dd=float((k7_lib(u64, ld64) - ln_flag).abs().max()))
    lib_ms = dict(logden_dd=median_ms(torch, lambda: k6_lib(u64)),
                  lognum_dd=median_ms(torch, lambda: k7_lib(u64, ld64)),
                  lognum_fused_dd=median_ms(torch, lambda: k5_lib(u64)))
    del u64
    torch.cuda.empty_cache()
    lib_ms_combined = dict(
        logden_dd=median_ms(torch, lambda: k6_lib(dd_to_f64(uh, ul))),
        lognum_dd=median_ms(torch, lambda: k7_lib(dd_to_f64(uh, ul), dd_to_f64(*ld))),
        lognum_fused_dd=median_ms(torch, lambda: k5_lib(dd_to_f64(uh, ul))),
    )
    for k in ln_names:
        times[k] = (*times[k], lib_ms_combined[k])
    del planes, uh, ul, gh, gl, ld, m_k, g64, ld64, ln_flag
    torch.cuda.empty_cache()
    emit("1_lognum_kernels", checks=lognum_checks, phantom_min_log_shift=phantom,
         max_abs_err={k: err[k] for k in ln_names}, shape=[FLAGSHIP_K, N_flag],
         ms={k: times[k][0] for k in ln_names}, plain_ms={k: times[k][1] for k in ln_names},
         library_ms_f64_u=lib_ms, library_ms_with_plane_combine=lib_ms_combined,
         library_max_abs_diff_vs_kernel=lib_err)

    # ---- phase 1d: the roofline probes K8a-c against their plain versions,
    # then the probe path
    probe_checks = []
    n_chain = roofline.chain_width(dev)

    def chain_start(dtype, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.rand(n_chain, generator=g, dtype=torch.float64, device=dev).mul_(0.4).add_(
            0.5).to(dtype)

    def check_chain(name, out, ref, dtype):
        e = rel_err(out.double(), ref.double())
        err[name] = max(err.get(name, 0.0), float((out - ref).abs().max()))
        probe_checks.append(dict(kernel=name, rel_err=e))
        if not e <= CHAIN_ULPS * torch.finfo(dtype).eps:
            fail(f"{name}: kernel vs plain relative error {e:.3e} > {CHAIN_ULPS} ulp")

    for name, dtype in (("fma_chain_f32", torch.float32), ("fma_chain_f64", torch.float64)):
        x0 = chain_start(dtype, 1)
        check_chain(name, roofline.fma_chain(x0, roofline.FMA_C, 2),
                    roofline.fma_chain_plain(x0, roofline.FMA_C, 2), dtype)
    x0 = chain_start(torch.float64, 2)
    check_chain("exp_chain_f64", roofline.exp_chain(x0, 6), roofline.exp_chain_plain(x0, 6),
                torch.float64)
    err["wsum_pinned"] = 0.0
    for K_p, tile, steps in ((1024, 512, 64), (4096, 128, 32), (5, 16, 3)):
        tp = roofline.pinned_tile(K_p, tile, dev, seed=K_p)
        S = dd_to_f64(*roofline.wsum_pinned(*tp, steps))
        S_ref = dd_to_f64(*roofline.wsum_pinned_plain(*tp, steps))
        e = rel_err(S, S_ref)
        err["wsum_pinned"] = max(err["wsum_pinned"], float((S - S_ref).abs().max()))
        probe_checks.append(dict(kernel="wsum_pinned", K=K_p, tile=tile, steps=steps, rel_err=e))
        if not e <= S_REL_TOL:
            fail(f"wsum_pinned ({K_p}, {tile}, {steps}): vs plain {e:.3e} > {S_REL_TOL:g}")
        if K_p in (1024, 4096):  # K8b (clusters of 2) and K8c (clusters of 8)
            one, k1 = roofline.wsum_pinned(*tp, 1), wsum.wsum_dd(*tp)
            same = torch.equal(one[0], k1[0]) and torch.equal(one[1], k1[1])
            probe_checks.append(dict(kernel="wsum_pinned", K=K_p, case="one step vs K1",
                                     same_bits=same))
            if not same:
                fail(f"wsum_pinned at one step differs from K1 at K = {K_p}")
    torch.cuda.synchronize()

    # K1 streaming at K = 4096, the K of K8c's ceiling
    N_4k = 2**18
    planes = make_planes(torch, 4096, N_4k, gen, dev)
    k1_4k_ms = median_ms(torch, lambda: wsum.wsum_dd(*planes))
    del planes
    torch.cuda.empty_cache()

    # the probe path: each probe with its launch counts set to 0 just before it
    probe_runs = {}

    def run_probe(name, counter, fn):
        for c in ("FMA_LAUNCHES", "EXP_LAUNCHES", "PINNED_LAUNCHES"):
            setattr(roofline, c, 0)
        rate = fn()
        torch.cuda.synchronize()
        probe_runs[name] = dict(rate=rate, launches=getattr(roofline, counter))

    run_probe("fma_chain_f32", "FMA_LAUNCHES",
              lambda: roofline.measure_fma_peak(torch.float32, steps=FMA_STEPS))
    run_probe("fma_chain_f64", "FMA_LAUNCHES",
              lambda: roofline.measure_fma_peak(torch.float64, steps=FMA_STEPS))
    run_probe("exp_chain_f64", "EXP_LAUNCHES", lambda: roofline.measure_exp_rate(steps=EXP_STEPS))
    run_probe("wsum_pinned_1024x512", "PINNED_LAUNCHES", roofline.measure_wsum_ceiling)
    run_probe("wsum_pinned_4096x128", "PINNED_LAUNCHES", roofline.measure_wsum_big_ceiling)

    # one call's time at the probe path's shapes (its work over the best
    # rate), and the plain version's on the same shapes (one timed call)
    x32, x64 = chain_start(torch.float32, 3), chain_start(torch.float64, 3)
    plain = {
        "fma_chain_f32": (2.0 * n_chain * FMA_STEPS,
                          lambda: roofline.fma_chain_plain(x32, roofline.FMA_C, FMA_STEPS)),
        "fma_chain_f64": (2.0 * n_chain * FMA_STEPS,
                          lambda: roofline.fma_chain_plain(x64, roofline.FMA_C, FMA_STEPS)),
        "exp_chain_f64": (float(n_chain) * EXP_STEPS,
                          lambda: roofline.exp_chain_plain(x64, EXP_STEPS)),
    }
    for name, (work, fn) in plain.items():
        times[name] = (work / probe_runs[name]["rate"] * 1e3, median_ms(torch, fn, reps=1))
    del x32, x64, plain
    for name, (K_p, tile, steps) in PINNED.items():
        tp = roofline.pinned_tile(K_p, tile, dev)
        times[name] = (K_p * tile * steps / probe_runs[name]["rate"] * 1e3,
                       median_ms(torch, lambda: roofline.wsum_pinned_plain(*tp, steps)))
        err[name] = err["wsum_pinned"]

    k1_rate = FLAGSHIP_K * N_flag / (times["wsum_dd"][0] * 1e-3)
    k1_4k_rate = 4096 * N_4k / (k1_4k_ms * 1e-3)
    ceiling = probe_runs["wsum_pinned_1024x512"]["rate"]
    ceiling_4k = probe_runs["wsum_pinned_4096x128"]["rate"]
    rates = dict(
        fma_f32_flops=probe_runs["fma_chain_f32"]["rate"],
        fma_f64_flops=probe_runs["fma_chain_f64"]["rate"],
        exp_f64_per_s=probe_runs["exp_chain_f64"]["rate"],
        k8b_elements_per_s=ceiling, k8c_elements_per_s=ceiling_4k,
        k1_flagship_elements_per_s=k1_rate, k1_4096_elements_per_s=k1_4k_rate,
        k1_4096_ms=k1_4k_ms, k1_roofline_fraction=k1_rate / ceiling,
        k1_4096_roofline_fraction=k1_4k_rate / ceiling_4k,
    )
    emit("1_roofline_probes", checks=probe_checks, chain_width=n_chain, fma_steps=FMA_STEPS,
         exp_steps=EXP_STEPS, launches={k: v["launches"] for k, v in probe_runs.items()},
         ms={k: times[k][0] for k in probe_runs}, plain_ms={k: times[k][1] for k in probe_runs},
         **rates)
    if not rates["fma_f64_flops"] <= 1.05 * F64_OPS_PER_S:
        fail(f"FP64 FMA rate {rates['fma_f64_flops']:.3e} exceeds 105% of the data sheet's")
    if not rates["fma_f32_flops"] <= 1.05 * F32_OPS_PER_S:
        fail(f"FP32 FMA rate {rates['fma_f32_flops']:.3e} exceeds 105% of the data sheet's")
    if not (ceiling >= k1_rate and ceiling_4k >= k1_4k_rate):
        fail(f"a pinned ceiling lies below K1's streaming rate: {rates}")
    if any(v["launches"] <= 0 for v in probe_runs.values()):
        fail(f"a probe launched no kernel: {probe_runs}")

    # ---- phase 1e: Theta's weight build against its plain version
    gram_checks, gram_ms = [], {}
    gen_g = torch.Generator(device=dev).manual_seed(SEED)
    for K_g, nc_g in GRAM_SHAPES:
        u_g = torch.rand((K_g, nc_g), generator=gen_g, dtype=torch.float64, device=dev) * 10.0
        N_g = torch.randint(1, 50, (K_g,), generator=gen_g, device=dev).to(torch.float64)
        f_g = torch.randn(K_g, generator=gen_g, dtype=torch.float64, device=dev)
        before = gram_weights.GRAM_WEIGHTS_LAUNCHES
        w, ld, rs, cs = gram_weights.gram_weights(u_g, N_g, f_g)
        torch.cuda.synchronize()
        if gram_weights.GRAM_WEIGHTS_LAUNCHES != before + 1:
            fail(f"gram_weights {K_g}x{nc_g}: GRAM_WEIGHTS_LAUNCHES did not rise by one")
        w_r, ld_r, rs_r, cs_r = gram_weights.gram_weights_plain(u_g, N_g, f_g)
        big = w_r > 1e-290
        e = dict(w=rel_err(w[big], w_r[big]),
                 logden=float(((ld - ld_r).abs() / ld_r.abs().clamp_min(1.0)).max()),
                 rowsum=rel_err(rs, rs_r), colsum=rel_err(cs, cs_r),
                 same_bits=torch.equal(gram_weights.gram_weights(u_g, N_g, f_g)[3], cs))
        err["gram_weights"] = max(err.get("gram_weights", 0.0), float((w - w_r).abs().max()))
        gram_checks.append(dict(K=K_g, N=nc_g, **e))
        if not (e["w"] <= 1e-12 and e["logden"] <= 1e-13 and e["rowsum"] <= 1e-12
                and e["colsum"] <= 1e-12 and e["same_bits"]):
            fail(f"gram_weights {K_g}x{nc_g} vs plain: {e}")
        del w, ld, rs, cs, w_r, ld_r, rs_r, cs_r, big
        gram_ms[(K_g, nc_g)] = (median_ms(torch, lambda: gram_weights.gram_weights(u_g, N_g, f_g)),
                                median_ms(torch, lambda: gram_weights.gram_weights_plain(
                                    u_g, N_g, f_g)))
        del u_g
        torch.cuda.empty_cache()
    times["gram_weights"] = gram_ms[GRAM_SHAPES[0]]
    emit("1_gram_weights", checks=gram_checks, shapes=[list(sh) for sh in GRAM_SHAPES],
         ms=[gram_ms[sh][0] for sh in GRAM_SHAPES], plain_ms=[gram_ms[sh][1] for sh in GRAM_SHAPES],
         bound_ms=[bound(8 * K_g * nc_g + 16 * K_g, 8 * K_g * nc_g + 16 * nc_g, 0, F64_OPS_PER_S)[0]
                   for K_g, nc_g in GRAM_SHAPES])

    # ---- phase 2: the main path at full size (K1 route, Theta on the card)
    flag_seed = SEED + 1  # phase 4 rebuilds the same u_kn
    u_kn, N_k, fa, _x = oscillators(torch, FLAGSHIP_K, FLAGSHIP_NPK,
                                    torch.Generator(device=dev).manual_seed(flag_seed), dev)
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
    gram_weights.GRAM_WEIGHTS_LAUNCHES = 0
    t0 = time.perf_counter()
    res = mbar.compute_free_energy_differences()
    torch.cuda.synchronize()
    theta_s = time.perf_counter() - t0
    flag_gram_launches = gram_weights.GRAM_WEIGHTS_LAUNCHES
    flag_chunks = len(mbar_core._col_ranges(FLAGSHIP_K, 8, 0, N_flag))
    peak_bytes = flag_peak = torch.cuda.max_memory_allocated()

    route, shards = mesh_route(mbar)
    info = mbar.solver_results[0]["info"] if route in ("dd", "mesh") else {}
    gnorm_per_n = info.get("gnorm", float("nan")) / N_flag
    summary = dict(
        route=route, shards=shards, wsum_launches=flag_launches, split_launches=flag_split,
        gram_weights_launches=flag_gram_launches, theta_chunks=flag_chunks, init_s=init_s,
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
    iters = info.get("polish_iterations", 0)
    if route not in ("dd", "mesh") or iters <= 0 or flag_launches != shards * iters or any(flag_split):
        fail(f"the flagship did not take the dd route through K1 alone ({summary})")
    if not info["converged"] or not gnorm_per_n <= 1.0e-11:
        fail(f"dd solve not converged: gnorm/N = {gnorm_per_n:.3e}")
    if flag_gram_launches != flag_chunks:
        fail(f"the flagship's Theta launched gram_weights {flag_gram_launches} times, "
             f"not once for each of its {flag_chunks} column chunks")
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
    f_flag, f_adaptive = mbar.f_k.copy(), ref.f_k.copy()
    # phase 11 holds the host-resident route to phase 2's
    flag11 = dict(f_k=f_flag, Delta_f=res["Delta_f"].copy(), dDelta_f=res["dDelta_f"].copy(),
                  launches=flag_launches, peak=flag_peak, init_s=init_s, theta_s=theta_s)
    sigma_asym = res["dDelta_f"][0, 1:].copy()
    flag_walls = dict(init_s=init_s, theta_s=theta_s)
    # phase 7 reads phase 2's free energies on three states and its
    # checkpoint
    sub3 = np.ix_(*[[0, FLAGSHIP_K // 2, FLAGSHIP_K - 1]] * 2)
    flag_df3, flag_ddf3 = res["Delta_f"][sub3], res["dDelta_f"][sub3]
    flag_polish = iters
    ck_dir = tempfile.TemporaryDirectory()
    ck_path = os.path.join(ck_dir.name, "flagship.npz")
    checkpoint.save_mbar(mbar, ck_path)
    del u_kn, mbar, ref, res
    torch.cuda.empty_cache()

    # ---- phase 3: the many-state slice (split route, Theta on the card)
    slice_state = gen.get_state()  # phase 10 remakes the slice from it
    u_kn, N_k, fa, _x = oscillators(torch, SLICE_K, SLICE_NPK, gen, dev)
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

    route, shards = mesh_route(mbar)
    info = mbar.solver_results[0]["info"] if route in ("dd", "mesh") else {}
    iters = info.get("polish_iterations", 0)
    gnorm_per_n = info.get("gnorm", float("nan")) / N_slice
    g64 = mbar_gradient(u_kn, mbar.N_k.astype(np.float64), mbar.f_k)
    g64_per_n = float(torch.linalg.norm(g64)) / N_slice
    summary = dict(
        route=route, shards=shards, K=SLICE_K, N=N_slice, wsum_launches=slice_k1,
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
    if route not in ("dd", "mesh") or slice_k1 != 0 or iters <= 0 or slice_split != [shards * iters] * 3:
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
    f_slice = mbar.f_k.copy()
    del uh, ul, u_kn, mbar
    torch.cuda.empty_cache()

    # ---- phase 4: the sample-sharded path at full width
    n_cards = torch.cuda.device_count()
    mesh = sharding.default_mesh() if n_cards >= 2 else sharding.default_mesh(4, device="cuda:0")
    P = len(mesh.devices)
    mesh_devs = sorted({d.index for d in mesh.devices})
    u_kn, N_k, fa, _x = oscillators(torch, FLAGSHIP_K, FLAGSHIP_NPK,
                                    torch.Generator(device=dev).manual_seed(flag_seed), dev)
    sync_all(torch)
    for i in mesh_devs:
        torch.cuda.reset_peak_memory_stats(i)
    all_counters = [(wsum, "WSUM_LAUNCHES")] + [(wsum_split, n) for n in counters] + [
        (lognum, n) for n in ln_counters]
    for mod, n in all_counters:
        setattr(mod, n, 0)
    t0 = time.perf_counter()
    mbar = MBAR(u_kn, N_k, mesh=mesh)
    sync_all(torch)
    init_s = time.perf_counter() - t0
    mbar_k1 = wsum.WSUM_LAUNCHES
    t0 = time.perf_counter()
    res = mbar.compute_free_energy_differences()
    sync_all(torch)
    theta_s = time.perf_counter() - t0
    info = mbar.solver_results[0]["info"] if mbar.solver_results else {}
    iters = info.get("polish_iterations", 0)

    uh, ul = dev_split_planes(u_kn)
    t0 = time.perf_counter()
    f_dd, info_dd = sharding.sharded_solve_mbar_dd(uh, ul, N_k, mesh=mesh)
    sync_all(torch)
    direct_s = time.perf_counter() - t0
    # K5 on the mesh at the converged f: its self-consistent fixed point
    # f_k = -lognum_k checks the solve independently of its gradient
    logN = torch.log(torch.as_tensor(N_k, dtype=torch.float64, device=dev))
    gh, gl = dd_from_f64(torch.as_tensor(f_dd, device=dev) + logN)
    m_k = torch.as_tensor(-f_dd, dtype=torch.float32, device=dev)
    uh_s, ul_s, n_pad = sharding.shard_dd_planes(uh, ul, mesh)
    k5_before = lognum.LOGNUM_FUSED_LAUNCHES
    t0 = time.perf_counter()
    ln_mesh = dd_to_f64(*sharding.sharded_fused_lognum_dd(uh_s, ul_s, gh, gl, m_k, mesh))
    sync_all(torch)
    k5_mesh_s = time.perf_counter() - t0
    k5_per_call = lognum.LOGNUM_FUSED_LAUNCHES - k5_before
    mesh_launches = {n: getattr(mod, n) for mod, n in all_counters}
    peak = {f"cuda:{i}": torch.cuda.max_memory_allocated(i) for i in mesh_devs}
    del uh_s, ul_s

    ln_one = dd_to_f64(*lognum.lognum_fused_dd(uh, ul, gh, gl, m_k))
    f_sci = (-ln_mesh + ln_mesh[0]).cpu().numpy()
    stationarity = float(np.abs(f_sci - (f_dd - f_dd[0])).max())
    k5_vs_one = float((ln_mesh - ln_one).abs().max())
    df_vs_flag = float(np.abs(mbar.f_k - f_flag).max())
    mesh11 = dict(f_k=mbar.f_k.copy(), init_s=init_s)
    df_vs_f64 = float(np.abs(mbar.f_k - f_adaptive).max())
    # a 3-shard pass on cuda:0: 999,424 samples leave pad columns
    mesh3 = sharding.default_mesh(3, device="cuda:0")
    f3, info3 = sharding.sharded_solve_mbar_dd(uh, ul, N_k, mesh=mesh3)
    uh_s, ul_s, n_pad3 = sharding.shard_dd_planes(uh, ul, mesh3)
    ln3 = dd_to_f64(*sharding.sharded_fused_lognum_dd(uh_s, ul_s, gh, gl, m_k, mesh3))
    sync_all(torch)
    del uh_s, ul_s
    summary = dict(
        shards=P, cards=n_cards, mesh=[str(d) for d in mesh.devices], route=mesh_route(mbar)[0],
        init_s=init_s, theta_s=theta_s, phase2_walls=flag_walls,
        phase1_s=info.get("phase1_s"), phase2_s=info.get("phase2_s"),
        f32_coarse_iterations=info.get("f32_coarse_iterations"), polish_iterations=iters,
        deltas=info.get("deltas"), converged=info.get("converged"),
        gradient_norm_per_sample=info.get("gnorm", float("nan")) / N_flag,
        wsum_launches_in_mbar=mbar_k1, max_abs_z=max_abs_z(res, fa),
        delta_f_max_err_vs_phase2=df_vs_flag, delta_f_max_err_vs_f64=df_vs_f64,
        direct=dict(
            s=direct_s, converged=info_dd["converged"],
            gradient_norm_per_sample=info_dd["gnorm"] / N_flag,
            polish_iterations=info_dd["polish_iterations"], phase1_s=info_dd["phase1_s"],
            phase2_s=info_dd["phase2_s"], f32_coarse_iterations=info_dd["f32_coarse_iterations"],
            fallback_ran=bool(info_dd["f32_coarse_iterations"] and info_dd["f32_iterations"]),
        ),
        k5_on_mesh=dict(s=k5_mesh_s, launches_per_call=k5_per_call, n_pad=n_pad,
                        stationarity_vs_f=stationarity, max_abs_diff_vs_one_call=k5_vs_one),
        three_shards=dict(n_pad=n_pad3, converged=info3["converged"],
                          polish_iterations=info3["polish_iterations"],
                          f_max_diff_vs_mesh=float(np.abs(f3 - f_dd).max()),
                          k5_max_abs_diff_vs_one_call=float((ln3 - ln_one).abs().max())),
        launches=mesh_launches, max_memory_allocated=peak,
    )
    emit("4_mesh", **summary)
    if mbar.mesh is not mesh or iters <= 0 or mbar_k1 != P * iters:
        fail(f"MBAR(mesh=) did not run K1 once per shard per polish iteration ({summary})")
    if not info["converged"] or not summary["gradient_norm_per_sample"] <= 1.0e-11:
        fail("MBAR(mesh=) solve not converged")
    if not (df_vs_flag <= MESH_DF_TOL and df_vs_f64 <= 1.0e-8):
        fail(f"mesh Delta_f off: {df_vs_flag:.3e} vs phase 2, {df_vs_f64:.3e} vs f64")
    check_free_energies(res, summary["max_abs_z"], "mesh")
    if not info_dd["converged"] or not info_dd["gnorm"] / N_flag <= 1.0e-11:
        fail("sharded_solve_mbar_dd not converged")
    if k5_per_call != P or mesh_launches["LOGNUM_FUSED_LAUNCHES"] != P:
        fail(f"sharded_fused_lognum_dd launched K5 {k5_per_call} times on {P} shards")
    if not (stationarity <= 1.0e-10 and k5_vs_one <= LOG_ABS_TOL):
        fail(f"K5 on the mesh: stationarity {stationarity:.3e}, vs one call {k5_vs_one:.3e}")
    three = summary["three_shards"]
    if not (n_pad3 > 0 and info3["converged"] and three["f_max_diff_vs_mesh"] <= MESH_DF_TOL
            and three["k5_max_abs_diff_vs_one_call"] <= LOG_ABS_TOL):
        fail(f"the 3-shard pass failed: {three}")
    del uh, ul, u_kn, mbar, res
    torch.cuda.empty_cache()

    # ---- phase 5: the bootstrap at the flagship (dd counts route)
    u_kn, N_k, fa, x_n = oscillators(torch, FLAGSHIP_K, FLAGSHIP_NPK,
                                     torch.Generator(device=dev).manual_seed(flag_seed), dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wsum.WSUM_LAUNCHES = 0
    t0 = time.perf_counter()
    mbar = MBAR(u_kn, N_k, n_bootstraps=N_BOOT, rseed=SEED)
    torch.cuda.synchronize()
    boot_init_s = time.perf_counter() - t0
    boot_k1 = wsum.WSUM_LAUNCHES
    t0 = time.perf_counter()
    res = mbar.compute_free_energy_differences(uncertainty_method="bootstrap")
    boot_fe_s = time.perf_counter() - t0
    boot_peak = torch.cuda.max_memory_allocated()
    info = mbar.solver_results[0]["info"]
    sigma_boot = res["dDelta_f"][0, 1:]
    ratio = float(np.median(sigma_boot / sigma_asym))
    df_boot = float(np.abs(mbar.f_k - f_flag).max())
    z_boot = max_abs_z(res, fa)
    summary = dict(
        route=mesh_route(mbar)[0], n_bootstraps=N_BOOT, init_s=boot_init_s,
        free_energies_s=boot_fe_s, wsum_launches=boot_k1,
        polish_iterations=info.get("polish_iterations"),
        n_at_floor=info.get("bootstrap_n_at_floor"),
        n_tol_converged=info.get("bootstrap_n_tol_converged"),
        delta_f_max_err_vs_phase2=df_boot, sigma_boot_over_asym_median=ratio,
        sigma_boot_min=float(sigma_boot.min()), max_abs_z=z_boot, max_memory_allocated=boot_peak,
    )
    emit("5_bootstrap_mbar", **summary)
    if mbar.bootstrap_at_floor is None or summary["route"] != "dd" or boot_k1 <= 0:
        fail(f"the flagship bootstrap did not take the dd counts route ({summary})")
    if not df_boot <= 1.0e-10:
        fail(f"bootstrap MBAR f_k differs from phase 2's by {df_boot:.3e}")
    if not 0.8 <= ratio <= 1.25:
        fail(f"median sigma_boot / sigma_asym = {ratio:.3f} outside [0.8, 1.25]")
    check_free_energies(res, z_boot, "bootstrap")

    uh, ul = dev_split_planes(u_kn)
    counts = bootstrap_counts(mbar.bootstrap_rints, mbar.N)
    direct = {}
    for tol in (1.0e-12, 1.0e-7):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fb, nf, bi = bootstrap_polish_dd(uh, ul, N_k, mbar.f_k, info["hinv"], counts, tol=tol)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        direct[tol] = (fb, nf, bi, wall, torch.cuda.max_memory_allocated())
    (fb12, nf12, bi12, s12, peak12), (fb7, nf7, bi7, s7, _) = direct[1.0e-12], direct[1.0e-7]
    reftol_dev = float(np.abs(fb7 - fb12).max())
    before = wsum.WSUM_LAUNCHES
    fs, nfs, bis = bootstrap_polish_dd(uh, ul, N_k, mbar.f_k, info["hinv"], counts[:4],
                                       mode="serial")
    torch.cuda.synchronize()
    serial_launches = wsum.WSUM_LAUNCHES - before
    serial_dev = float(np.abs(fs - fb12[:4]).max())
    vs_mbar = float(np.abs((fb12 - fb12[:, :1]) - mbar.f_k_boots).max())
    summary = dict(
        reps_per_s={"1e-12": N_BOOT / s12, "1e-7": N_BOOT / s7}, walls_s={"1e-12": s12, "1e-7": s7},
        phase_walls={"1e-12": bi12["phase_walls"], "1e-7": bi7["phase_walls"]},
        fast_iters={"1e-12": bi12["fast_iters"], "1e-7": bi7["fast_iters"]},
        exact_iters={"1e-12": bi12["exact_iters"].tolist(), "1e-7": bi7["exact_iters"].tolist()},
        n_fail={"1e-12": nf12, "1e-7": nf7},
        n_at_floor={"1e-12": bi12["n_at_floor"], "1e-7": bi7["n_at_floor"]},
        n_tol_converged={"1e-12": bi12["n_tol_converged"], "1e-7": bi7["n_tol_converged"]},
        reftol_max_dev=reftol_dev, reftol_limit=0.01 * float(sigma_boot.min()),
        vs_mbar_f_k_boots=vs_mbar, serial_max_dev_first4=serial_dev,
        serial_polish_iterations=bis["polish_iterations"].tolist(),
        serial_wsum_launches=serial_launches, max_memory_allocated_1e12=peak12,
    )
    emit("5_bootstrap_polish", **summary)
    for tol, (_fb, nf, bi, _s, _p) in direct.items():
        if nf != 0 or nf + bi["n_at_floor"] + bi["n_tol_converged"] != N_BOOT:
            fail(f"bootstrap accounting at tol {tol:g}: {summary}")
    if not reftol_dev < 0.01 * float(sigma_boot.min()):
        fail(f"tol 1e-7 replicates stray {reftol_dev:.3e} from tol 1e-12 ones")
    if not (nfs == 0 and serial_dev <= 5.0e-11):
        fail(f"serial replicates differ from batched by {serial_dev:.3e} (n_fail {nfs})")
    if serial_launches != int(bis["polish_iterations"].sum()) or serial_launches <= 0:
        fail(f"serial mode launched K1 {serial_launches} times for "
             f"{bis['polish_iterations'].tolist()} polish iterations")
    boot_mbar = mbar  # phase 7 reuses its replicates, phase 9 compares with them
    single5 = dict(f_k=mbar.f_k.copy(), hinv=info["hinv"], f_boots=mbar.f_k_boots.copy(),
                   at_floor=bi12["at_floor"].copy(), exact_iters=bi12["exact_iters"].copy(),
                   init_s=boot_init_s)
    del uh, ul, mbar, res, counts, direct, fb12, fb7, fs
    torch.cuda.empty_cache()

    # ---- phase 6: the diagnostics and the host estimators at the flagship
    def timed(fn):
        """(result, wall, peak device bytes) of fn, fenced by synchronize."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated()

    mbar, init_s, peak = timed(lambda: MBAR(u_kn, N_k, initialize="BAR"))
    f_bar, chain_s, _ = timed(lambda: mbar._initialize_with_bar(mbar.u_kn))
    df_bar = float(np.abs(mbar.f_k - f_flag).max())

    def per_pair_chain():
        """The chain in the JAX package's per-pair form: each pair's work
        values from rows of the same card tensor indexed by x_kindices
        masks, held bit for bit against the chain's one gather, and BAR on
        them with its uncertainty (f_ref, the accumulated variance)."""
        pairs, works = mbar._bar_pair_work(mbar.u_kn)
        xk = torch.as_tensor(mbar.x_kindices, device=dev)
        u = mbar.u_kn
        f_ref, var, mismatched = np.zeros(FLAGSHIP_K), np.zeros(FLAGSHIP_K), 0
        for (k, l), (w_F, w_R) in zip(pairs, works):
            mk, ml = xk == k, xk == l
            ref_F = (u[l, mk] - u[k, mk]).cpu().numpy()
            ref_R = (u[k, ml] - u[l, ml]).cpu().numpy()
            mismatched += not (np.array_equal(w_F, ref_F) and np.array_equal(w_R, ref_R))
            r = bar(ref_F, ref_R, method="bisection", relative_tolerance=0.00001,
                    verbose=False, maximum_iterations=100)
            f_ref[l] = f_ref[k] + r["Delta_f"]
            var[l] = var[k] + r["dDelta_f"] ** 2
        return len(pairs), mismatched, f_ref, var

    (n_pairs, mismatched, f_ref, var), ref_s, _ = timed(per_pair_chain)
    chain_vs_ref = float(np.abs(f_bar - f_ref).max())
    # The chain adds one pairwise BAR estimate per step, so its distance
    # from the solved f_k is held to 6 of the sigmas accumulated so far.
    chain_z = np.abs((f_bar - f_bar[0]) - mbar.f_k)[1:] / np.sqrt(var[1:])
    emit("6_bar_init", s=init_s, bar_chain_s=chain_s, max_memory_allocated=peak,
         route=mesh_route(mbar)[0], delta_f_max_err_vs_phase2=df_bar,
         per_pair_reference_s=ref_s, pairs=n_pairs, pairs_with_other_work_values=mismatched,
         chain_max_abs_dev_vs_per_pair=chain_vs_ref,
         chain_max_abs_dev_from_solution=float(np.abs((f_bar - f_bar[0]) - mbar.f_k).max()),
         chain_max_z_from_solution=float(chain_z.max()))
    if not df_bar <= 1.0e-10:
        fail(f"MBAR(initialize='BAR') f_k differs from phase 2's by {df_bar:.3e}")
    if n_pairs != FLAGSHIP_K - 1 or mismatched:
        fail(f"BAR chain: {mismatched} of {n_pairs} pairs gathered other work values "
             "than the per-pair form")
    if not chain_vs_ref <= 1.0e-12:
        fail(f"BAR chain differs from the per-pair chain by {chain_vs_ref:.3e}")
    if not chain_z.max() < 6:
        fail(f"BAR chain strays {chain_z.max():.3g} accumulated sigmas from the solved f_k")

    log_w, s, peak = timed(lambda: mbar.Log_W_nk)
    W = torch.as_tensor(log_w, device=dev).exp_()
    _, check_s, _ = timed(lambda: check_w_normalized(W, N_k))
    col_dev = float((W.sum(dim=0) - 1.0).abs().max())
    row_dev = float((W @ torch.as_tensor(N_k, dtype=W.dtype, device=dev) - 1.0).abs().max())
    emit("6_log_w_nk", s=s, check_w_normalized_s=check_s, max_memory_allocated=peak,
         shape=list(log_w.shape), colsum_max_dev=col_dev, rowsum_max_dev=row_dev)
    if log_w.shape != (N_flag, FLAGSHIP_K) or not np.isfinite(log_w).all():
        fail(f"Log_W_nk has shape {log_w.shape} or a value that is not finite")

    n_eff, s, peak = timed(mbar.compute_effective_sample_number)
    n_eff_w = 1.0 / (torch.linalg.vector_norm(W, dim=0) ** 2).cpu().numpy()
    del W
    torch.cuda.empty_cache()
    Nk = np.asarray(N_k, dtype=np.float64)
    eff_dev = float(np.abs(n_eff / n_eff_w - 1.0).max())
    emit("6_n_eff", s=s, max_memory_allocated=peak, min=float(n_eff.min()),
         max=float(n_eff.max()), rel_dev_vs_log_w_nk=eff_dev)
    if not (np.all(n_eff >= Nk * (1 - 1e-9)) and np.all(n_eff <= N_flag * (1 + 1e-9))):
        fail(f"N_eff outside [N_k, N]: min {n_eff.min():.6g}, max {n_eff.max():.6g}")
    if not eff_dev <= 1.0e-10:
        fail(f"N_eff differs from 1 / sum_n W_nk^2 by {eff_dev:.3e} relative")

    ov, s, peak = timed(mbar.compute_overlap)
    row_err = float(np.abs(ov["matrix"].sum(axis=1) - 1.0).max())
    top_err = abs(float(ov["eigenvalues"][0]) - 1.0)
    emit("6_overlap", s=s, max_memory_allocated=peak, scalar=float(ov["scalar"]),
         rowsum_max_dev=row_err, top_eigenvalue_dev=top_err)
    if not (row_err <= 1.0e-10 and top_err <= 1.0e-10 and 0.0 <= ov["scalar"] <= 1.0):
        fail(f"overlap: row sums off by {row_err:.3e}, top eigenvalue by {top_err:.3e}, "
             f"scalar {ov['scalar']}")

    res_svd, svd_s, svd_peak = timed(
        lambda: mbar.compute_free_energy_differences(uncertainty_method="svd"))
    res_ew, ew_s, _ = timed(
        lambda: mbar.compute_free_energy_differences(uncertainty_method="svd-ew"))
    svd_dev = float(np.abs(res_svd["dDelta_f"] - res_ew["dDelta_f"]).max())
    emit("6_svd", s=svd_s, svd_ew_s=ew_s, max_memory_allocated=svd_peak,
         pr6_whole_w_peak=SVD_WHOLE_W_PEAK, ddelta_f_max_abs_diff_vs_svd_ew=svd_dev,
         max_abs_z=max_abs_z(res_svd, fa))
    np.testing.assert_almost_equal(res_svd["Delta_f"], res_ew["Delta_f"], decimal=8)
    np.testing.assert_almost_equal(res_svd["dDelta_f"], res_ew["dDelta_f"], decimal=8)
    if not svd_peak < SVD_WHOLE_W_PEAK / 2:
        fail(f"'svd' peaked at {svd_peak} B, not under half of the whole-W route's "
             f"{SVD_WHOLE_W_PEAK:g} B")
    svd6 = dict(s=svd_s, peak=svd_peak)

    def estimators():
        n0, n1 = N_k[0], N_k[0] + N_k[1]
        w_F = (u_kn[1, :n0] - u_kn[0, :n0]).cpu().numpy()
        w_R = (u_kn[0, n0:n1] - u_kn[1, n0:n1]).cpu().numpy()
        return bar(w_F, w_R), exp(w_F)

    (r_bar, r_exp), s, peak = timed(estimators)
    df_mbar = float(mbar.f_k[1] - mbar.f_k[0])
    est = {name: dict(delta_f=float(r["Delta_f"]), sigma=float(r["dDelta_f"]),
                      z_vs_mbar=(float(r["Delta_f"]) - df_mbar) / float(r["dDelta_f"]),
                      z_vs_analytic=(float(r["Delta_f"]) - float(fa[1])) / float(r["dDelta_f"]))
           for name, r in (("bar", r_bar), ("exp", r_exp))}
    emit("6_bar_exp", s=s, max_memory_allocated=peak, mbar_delta_f_01=df_mbar,
         analytic_delta_f_01=float(fa[1]), **est)
    for name, e in est.items():
        if not (abs(e["z_vs_mbar"]) < 6 and abs(e["z_vs_analytic"]) < 6):
            fail(f"{name}: Delta_f off by more than 6 sigma: {e}")

    def decorrelate():
        A_t = testsystems.correlated_timeseries_example(seed=SEED)
        return A_t, timeseries.statistical_inefficiency(A_t), timeseries.subsample_correlated_data(A_t)

    (A_t, g, idx), s, peak = timed(decorrelate)
    rho = np.exp(-1.0 / 5.0)  # the example's published tau = 5
    g_true = (1.0 + rho) / (1.0 - rho)
    emit("6_timeseries", s=s, max_memory_allocated=peak, N=int(A_t.size), g=g, g_analytic=g_true,
         n_subsampled=len(idx))
    if not (A_t.size == 10000 and abs(g / g_true - 1.0) < 0.5):
        fail(f"statistical inefficiency {g:.4g} against the analytic {g_true:.4g}")
    if not (idx[0] == 0 and np.all(np.diff(idx) > 0) and idx[-1] < A_t.size
            and abs(len(idx) - A_t.size / g) <= 1.0):
        fail(f"subsample_correlated_data gave {len(idx)} indices for g = {g:.4g}")
    del mbar, log_w, res_svd, res_ew
    torch.cuda.empty_cache()

    ex7 = phase7(torch, np, u_kn, N_k, x_n, f_flag, flag_df3, flag_ddf3, flag_polish, boot_mbar,
                 ck_path)
    ck_dir.cleanup()
    del boot_mbar
    torch.cuda.empty_cache()
    fes8 = phase8(torch, np, u_kn, N_k, x_n)
    mesh_boot_k1, boot9 = phase9(torch, np, u_kn, N_k, fa, f_flag, sigma_asym, single5)
    del u_kn, x_n
    torch.cuda.empty_cache()
    mesh2d_split, mesh2d_err, solve10 = phase10(torch, np, slice_state, f_slice, route_ms)
    for name, e in mesh2d_err.items():
        err[name] = max(err[name], e)
    host_k1, svd11_s = phase11(torch, np, flag_seed, flag11, mesh11, single5, ex7)
    surface_k1 = phase12(torch, np)
    t13 = time.perf_counter()
    host13_k1, split13 = phase13(torch, np, flag_seed, fes8, boot9, svd6, slice_state, solve10,
                                 mesh2d_split)
    t13 = time.perf_counter() - t13
    emit("13_added_wall", s=t13 + svd11_s, phase13_s=t13, phase11b_svd_s=svd11_s)

    # ---- the kernels line: launches from each one's main-path run
    K, Nf, Ns = FLAGSHIP_K, N_flag, N_slice
    KS = SLICE_K
    rows = [
        ("wsum_dd", "pymbar_tpu_torch/csrc/wsum.cu", "pymbar_tpu/ops/pallas_kernels.py:584",
         flag_launches + mesh_boot_k1 + host_k1 + surface_k1 + host13_k1,
         bound(8 * K * Nf + 8 * K, 8 * K, 6 * K * Nf, F64_OPS_PER_S)),
        ("column_shift", "pymbar_tpu_torch/csrc/wsum_split.cu",
         "pymbar_tpu/ops/pallas_kernels.py:692", slice_split[0] + mesh2d_split[0] + split13[0],
         bound(4 * KS * Ns + 4 * KS, 4 * Ns, 2 * KS * Ns, F32_OPS_PER_S)),
        ("denom_sums_dd", "pymbar_tpu_torch/csrc/wsum_split.cu",
         "pymbar_tpu/ops/pallas_kernels.py:785", slice_split[1] + mesh2d_split[1] + split13[1],
         bound(8 * KS * Ns + 8 * KS + 4 * Ns, 8 * Ns, 5 * KS * Ns, F64_OPS_PER_S)),
        ("wsum_denom_dd", "pymbar_tpu_torch/csrc/wsum_split.cu",
         "pymbar_tpu/ops/pallas_kernels.py:890", slice_split[2] + mesh2d_split[2] + split13[2],
         bound(8 * KS * Ns + 8 * KS + 12 * Ns, 8 * KS, 6 * KS * Ns, F64_OPS_PER_S)),
        ("logden_dd", "pymbar_tpu_torch/csrc/lognum.cu", "pymbar_tpu/ops/pallas_kernels.py:189",
         mesh_launches["LOGDEN_LAUNCHES"], bound(8 * K * Nf + 8 * K, 8 * Nf, 5 * K * Nf, F64_OPS_PER_S)),
        ("lognum_dd", "pymbar_tpu_torch/csrc/lognum.cu", "pymbar_tpu/ops/pallas_kernels.py:261",
         mesh_launches["LOGNUM_LAUNCHES"],
         bound(8 * K * Nf + 8 * Nf + 4 * K, 8 * K, 5 * K * Nf, F64_OPS_PER_S)),
        ("lognum_fused_dd", "pymbar_tpu_torch/csrc/wsum_fused.cuh",
         "pymbar_tpu/ops/pallas_kernels.py:331", mesh_launches["LOGNUM_FUSED_LAUNCHES"],
         bound(8 * K * Nf + 12 * K, 8 * K, 10 * K * Nf, F64_OPS_PER_S)),
        ("fma_chain_f32", "pymbar_tpu_torch/csrc/roofline.cu", "bench.py:253",
         probe_runs["fma_chain_f32"]["launches"],
         bound(4 * n_chain, 4 * n_chain, 2 * n_chain * FMA_STEPS, F32_OPS_PER_S)),
        ("fma_chain_f64", "pymbar_tpu_torch/csrc/roofline.cu", "bench.py:253",
         probe_runs["fma_chain_f64"]["launches"],
         bound(8 * n_chain, 8 * n_chain, 2 * n_chain * FMA_STEPS, F64_OPS_PER_S)),
        ("exp_chain_f64", "pymbar_tpu_torch/csrc/roofline.cu", "bench.py:253",
         probe_runs["exp_chain_f64"]["launches"],
         bound(8 * n_chain, 8 * n_chain, 2 * n_chain * EXP_STEPS, F64_OPS_PER_S)),
    ] + [
        (name, "pymbar_tpu_torch/csrc/roofline.cu", replaces, probe_runs[name]["launches"],
         bound(8 * Kp * tile + 8 * Kp, 8 * Kp, 6 * Kp * tile * steps, F64_OPS_PER_S))
        for (name, (Kp, tile, steps)), replaces in zip(PINNED.items(), ("bench.py:308", "bench.py:373"))
    ] + [
        ("gram_weights", "pymbar_tpu_torch/csrc/gram_weights.cu",
         "none: XLA's fusion in pymbar_tpu/ops/mbar_core.py:476",
         flag_gram_launches,
         bound(8 * Kg * ncg + 16 * Kg, 8 * Kg * ncg + 16 * ncg, 0, F64_OPS_PER_S))
        for Kg, ncg in GRAM_SHAPES[:1]
    ]
    print(smi)
    print(json.dumps({"kernels": [dict(
        name=name, route="cuda", source=source, replaces=replaces, launches=launches,
        max_abs_err=err[name], ms=times[name][0], plain_ms=times[name][1],
        bound_ms=b[0], bound_by=b[1], library_ms=times[name][2] if len(times[name]) > 2 else None,
    ) for name, source, replaces, launches, b in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
