"""boot_sigma_s: the mean over the traced jobs of the program's span
``boot.sigma``: the free energies' bootstrap uncertainty, the host standard
deviation over the replicates' differences.  Layer: the bootstrap
(``solvers_large.py``'s engine, ``mbar.py``'s draws and sigma).  Moves
``peak_mem_gb``, the cell's one end-to-end metric besides ``setup_s``."""

from portbench.program_spans import mean_s


def read(run):
    return mean_s(run.trace, "boot.sigma")
