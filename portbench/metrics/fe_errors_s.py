"""fe_errors_s: the mean over the traced jobs of the program's span
``fe.errors``: ``MBAR._ErrorOfDifferences``, the K x K uncertainties of the
differences from Theta on the host (the squared differences, the scans for
negatives, the square root).  Layer: ``mbar.py``'s Theta and free
energies.  Moves ``job_s``."""

from portbench.program_spans import mean_s


def read(run):
    return mean_s(run.trace, "fe.errors")
