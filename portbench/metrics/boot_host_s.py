"""boot_host_s: the mean over the traced jobs of what a bootstrap job spends
outside the engine and the base solve: the job's wall less the engine's
``phase_walls["total_s"]`` and the base dd solve's ``phase1_s`` and
``phase2_s``.  That is the host draws of the resample indices, the counts,
the double-word split and the host standard deviation of sigma, until the
program gives them spans of their own.  Layer: the bootstrap
(``solvers_large.py``'s engine, ``mbar.py``'s draws and sigma).  Moves
``peak_mem_gb``, the cell's one end-to-end metric besides ``setup_s``."""

from portbench.metrics.boot_engine_s import CAPTURE, engine_s  # noqa: F401  (CAPTURE: the harness wraps it)


def read(run):
    values = []
    for job in run.jobs:
        engine, info = engine_s(job), job["info"]
        if engine is not None and "phase1_s" in info and "phase2_s" in info:
            values.append(job["wall_s"] - engine - info["phase1_s"] - info["phase2_s"])
    return sum(values) / len(values) if values else None
