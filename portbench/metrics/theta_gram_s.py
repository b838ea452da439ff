"""theta_gram_s: the mean over the traced jobs of the program's span
``theta.gram``: Theta's streamed float64 Gram pass over u_kn
(``mbar_gram_normalization``) and the check of its column and row sums,
which ends at the column sums' copy to the host.  Layer: ``mbar.py``'s
Theta and free energies.  Moves ``job_s``."""

from portbench.program_spans import mean_s


def read(run):
    return mean_s(run.trace, "theta.gram")
