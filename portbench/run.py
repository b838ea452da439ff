"""Run one cell of the pymbar_tpu_torch benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json`` at the root of
the checkout.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number that decided
``correct`` beside its limit.  The same numbers are the last lines of
standard error.  Without a CUDA card holding the cell's chips, or when a
module of JAX or of the JAX package was loaded, it prints no result and
exits with a code other than 0.

The kernels are built into ``portbench/_cache/kernels`` of the checkout
(``PYMBAR_TPU_TORCH_CACHE_DIR``), so only the first run in a checkout pays
nvcc.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "portbench" / "_cache"


def _environment():
    """Fixed cache directories inside the checkout, and numpy placed on the
    card as a user's default session places it."""
    os.environ["PYMBAR_TPU_TORCH_CACHE_DIR"] = str(CACHE / "kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ.pop("PYMBAR_TPU_TORCH_DEVICE", None)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _number(x):
    """A number as JSON holds it: a non-finite one as its name."""
    return x if math.isfinite(x) else repr(float(x))


def result_line(result, rows):
    """The last line of standard output: the result with ``checks`` last."""
    result = dict(result)
    result["checks"] = {name: {"value": _number(value), "limit": _number(limit)}
                        for name, value, limit in rows}
    return json.dumps(result, allow_nan=False)


def main(argv=None):
    args = _args(argv)
    _environment()
    import torch

    from portbench import cells, harness

    bench = cells.load_benchmark(ROOT)
    cell = cells.load_cell(bench, args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    result, rows = harness.run(cell, bench, args.seed, args.seconds, args.trace,
                               torch.device("cuda", 0), T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules were loaded: {bad}", file=sys.stderr)
        return 3
    for name, value, limit in rows:
        print(f"{name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(result_line(result, rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
