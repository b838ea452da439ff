"""The yardstick of the kernel metrics: the card's peaks and each kernel's
least time from its operations and bytes.

A kernel's least time is the larger of its bytes over the card's memory
rate and its operations over the peak rate of the precision it computes
in (the form of ``chip_smoke.bound``).  Each input byte is counted once
and each output byte once, whatever the kernel reads again.  Operations
count the float arithmetic per element of the (K, N) planes, an exp as one.
"""

__all__ = ["PEAKS", "least_time_s", "k1_least_s"]

# Published peaks of one NVIDIA H100 SXM5 80GB at its 700 W limit (NVIDIA's
# data sheet; dense, outside the tensor cores for float32 and float64).
PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "f32_ops_per_s": 67e12,
    "f64_ops_per_s": 34e12,
}


def least_time_s(read_bytes, write_bytes, ops, ops_per_s, peaks=PEAKS):
    """(seconds, "bytes" or "operations"): the larger of the two bounds."""
    t_bytes = (read_bytes + write_bytes) / peaks["hbm_bytes_per_s"]
    t_ops = ops / ops_per_s
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_least_s(K, N, counts=False, peaks=PEAKS):
    """K1 ``wsum_dd`` (``wsum_fused`` + ``wsum_finish``) on (K, N) double-word
    planes: reads the two float32 planes (8 K N bytes), the (K,) g pair and,
    with counts, the (N,) float32 counts; writes the (K,) S pair.  Six
    float64 operations an element (the dd difference, its shift, the exp,
    the weight and its sum)."""
    read = 8 * K * N + 8 * K + (4 * N if counts else 0)
    return least_time_s(read, 8 * K, 6 * K * N, peaks["f64_ops_per_s"], peaks)[0]

