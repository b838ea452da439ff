"""dd_phase1_s: the mean of the dd solve's ``info["phase1_s"]`` (its float32
warm start and chord factor) over the traced jobs, as
``mbar.solver_results[0]["info"]`` holds it.  Layer: ``solvers_large.py``'s
dd solve.  Moves ``job_s``."""


def read(run):
    values = [j["info"]["phase1_s"] for j in run.jobs if "phase1_s" in j["info"]]
    return sum(values) / len(values) if values else None
