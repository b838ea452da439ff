"""k1_roofline_pct: K1's share of its roofline over the traced jobs.

The least time of one K1 launch on the configuration's (K, N) planes
(``portbench.roofline.k1_least_s``: the two float32 planes read once, 8 K N
bytes, plus the g pair and the outputs, over 3.35 TB/s, or its operations
over peak if larger), times the launches the program counts
(``ops.wsum.WSUM_LAUNCHES``), over the device time of K1's kernels in the
trace.  Every K1 launch of the dd solve runs on the whole planes.  Layer:
``ops/wsum.py`` + ``csrc/wsum.cu`` (K1).  Moves ``job_s``."""

from portbench import roofline

COUNTERS = ("pymbar_tpu_torch.ops.wsum:WSUM_LAUNCHES",)
KERNELS = ("wsum_fused", "wsum_finish")


def read(run):
    launches = run.counters.get(COUNTERS[0], 0)
    device_ns = sum(e - s for _n, s, e in run.trace.device_in_jobs(KERNELS))
    if not launches or not device_ns:
        return None
    K = int(run.config["K"])
    N = K * int(run.config["samples_per_state"])
    return 100.0 * launches * roofline.k1_least_s(K, N) / (device_ns * 1e-9)
