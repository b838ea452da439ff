"""device_idle_pct.boot: the share of the traced jobs' time of a bootstrap cell in which
the card ran nothing (no kernel, copy or set), from the union of the
device's intervals in the profiler's trace of the run, each instant once.
Layer: the device.  Moves ``peak_mem_gb``, the cell's one end-to-end metric
besides ``setup_s``."""


def read(run):
    window = run.trace.window_s()
    return 100.0 * (1.0 - run.trace.busy_s() / window) if window > 0 else None
