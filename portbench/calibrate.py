"""Readings that a cell's limits are set from, in one process on the card.

    python3 portbench/calibrate.py --workload <cell> --first-seed <n> --seeds 12 --controls 3

For each of ``--seeds`` seeds it runs the cell's job once through the
program, on the data of the seed's job 1 (after one warm-up job on the
first seed), and compares its answer with the float64 reference on the
same data: one JSON line a seed.  On the first ``--controls`` of those
seeds it also puts the reference computed in float32 (the nearest precision below the configuration's float64) in
the program's place and compares that the same way.  The last line gives,
for each number, the largest reading of the program (the lower reading)
and the smallest of the control (the upper reading).  The benchmark's own
runs never run this.
"""

import argparse
import json
import sys
import time

from run import ROOT, _environment


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--first-seed", type=int, required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    args = p.parse_args(argv)
    _environment()
    import torch

    from portbench import cells, data, harness
    from pymbar_tpu_torch import MBAR

    bench = cells.load_benchmark(ROOT)
    cell = cells.load_cell(bench, args.workload, ROOT)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    traffic = cell.traffic
    lower, upper = {}, {}
    for i in range(args.seeds):
        seed = args.first_seed + i
        inputs = harness.Inputs(cell.config, traffic["placement"], seed, device)
        job = harness.Job(MBAR, traffic, seed, device)
        if i == 0:
            job(0, *inputs(0))
        out = job(1, *inputs(1))
        inputs = None
        u, N_k = data.oscillators(cell.config, harness.job_seed(seed, 1), device)
        outs = [out]
        t = time.perf_counter()
        if i < args.controls:
            outs.append(harness.control_output(u, N_k, traffic, seed, 1))
        t_control = time.perf_counter() - t
        t = time.perf_counter()
        numbers = harness.compare(u, N_k, traffic, outs)
        line = {"seed": seed, "job_s": out["wall_s"], "program": numbers[0],
                "control_s": t_control, "compare_s": time.perf_counter() - t}
        for k, v in numbers[0].items():
            lower[k] = max(lower.get(k, v), v)
        if len(numbers) > 1:
            line["control"] = numbers[1]
            for k, v in numbers[1].items():
                upper[k] = min(upper.get(k, v), v)
        print(json.dumps(line), flush=True)
        del job, out, outs, u, inputs
        torch.cuda.empty_cache()
    print(json.dumps({"workload": cell.name, "lower": lower, "upper": upper,
                      "kind": torch.cuda.get_device_name(device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
