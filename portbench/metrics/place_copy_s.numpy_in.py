"""place_copy_s.numpy_in: the mean over the traced jobs of the program's span
``place.host_copy``: ``mbar._u_tensor`` copying a numpy u_kn to a float64
array in host memory (``np.array(u_kn, dtype=np.float64)``, after
``kln_to_kn`` for a u_kln).  Layer: the front door (``config.target_device``,
``mbar._place`` and ``_u_tensor``).  Moves ``job_s``."""

from portbench.program_spans import mean_s


def read(run):
    return mean_s(run.trace, "place.host_copy")
