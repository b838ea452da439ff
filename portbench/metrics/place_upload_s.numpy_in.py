"""place_upload_s.numpy_in: the mean over the traced jobs of the program's span
``place.upload``: ``mbar._u_tensor`` putting the float64 host copy of a
numpy u_kn on the card (``torch.as_tensor(..., device=...)``, a copy from
pageable memory that the host waits for).  Layer: the front door
(``config.target_device``, ``mbar._place`` and ``_u_tensor``).  Moves
``job_s``."""

from portbench.program_spans import mean_s


def read(run):
    return mean_s(run.trace, "place.upload")
