"""theta_cov_s: the mean over the traced jobs of the program's span
``theta.cov``: Theta from the Gram (``MBAR._theta_from_gram``, or
``_theta_svd`` from W's R factor) through its copy to the host.  Layer:
``mbar.py``'s Theta and free energies.  Moves ``job_s``."""

from portbench.program_spans import mean_s


def read(run):
    return mean_s(run.trace, "theta.cov")
