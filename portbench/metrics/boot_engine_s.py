"""boot_engine_s: the mean over the traced jobs of the bootstrap engine's own
wall, ``phase_walls["total_s"]`` of the info that
``solvers_large.bootstrap_polish_dd`` returns (materialize, float32 fast
phase, float64 exact phase, retries), summed over its calls in the job.
Layer: the bootstrap (``solvers_large.py``'s engine, ``mbar.py``'s draws and
sigma).  Moves ``peak_mem_gb``, the cell's one end-to-end metric besides
``setup_s``."""

CAPTURE = ("pymbar_tpu_torch.solvers_large:bootstrap_polish_dd",)


def engine_s(job):
    """The engine's wall in one job, or None when it did not run."""
    calls = job["captured"].get(CAPTURE[0]) or []
    walls = [out[2]["phase_walls"]["total_s"] for _wall, out in calls
             if "phase_walls" in out[2]]
    return sum(walls) if walls else None


def read(run):
    values = [v for v in map(engine_s, run.jobs) if v is not None]
    return sum(values) / len(values) if values else None
