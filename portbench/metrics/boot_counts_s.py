"""boot_counts_s: the mean over the traced jobs of the program's span
``boot.counts``: ``mbar.bootstrap_counts`` in ``MBAR.__init__``, the host
per-sample counts of the resample indices.  Layer: the bootstrap
(``solvers_large.py``'s engine, ``mbar.py``'s draws and sigma).  Moves
``peak_mem_gb``, the cell's one end-to-end metric besides ``setup_s``."""

from portbench.program_spans import mean_s


def read(run):
    return mean_s(run.trace, "boot.counts")
