"""dd_phase2_s: the mean of the dd solve's ``info["phase2_s"]`` (its
double-word chord-Newton polish on the weight-sum kernels) over the traced
jobs, as ``mbar.solver_results[0]["info"]`` holds it.  Layer:
``solvers_large.py``'s dd solve.  Moves ``job_s``."""


def read(run):
    values = [j["info"]["phase2_s"] for j in run.jobs if "phase2_s" in j["info"]]
    return sum(values) / len(values) if values else None
