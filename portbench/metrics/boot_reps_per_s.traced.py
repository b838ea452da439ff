"""boot_reps_per_s.traced: the bootstrap replicates a user gets per second
over the traced jobs of a bootstrap cell, sigma included: n_bootstraps times
the jobs over the sum of their walls (host clock, each fenced by
``torch.cuda.synchronize()``).  Most of a job is the program's host work
(the draws, the counts, the host standard deviation), whose speed follows
the host's load from run to run, so the rate stands here and not among the
end-to-end metrics.  Layer: the bootstrap (``solvers_large.py``'s engine,
``mbar.py``'s draws and sigma).  Moves ``peak_mem_gb``, the cell's one
end-to-end metric besides ``setup_s``."""


def read(run):
    B = int((run.traffic.get("mbar") or {}).get("n_bootstraps", 0))
    walls = [j["wall_s"] for j in run.jobs]
    return B * len(walls) / sum(walls) if B and walls and sum(walls) > 0 else None
