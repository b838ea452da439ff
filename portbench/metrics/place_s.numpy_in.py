"""place_s.numpy_in: the mean over the traced jobs of the time from a job's
start to the end of the host-to-device copy of u_kn's bytes (the longest
such copy in the job), read from the run's profiler timeline: the host copy
of the numpy array and its upload that ``mbar._place`` / ``_u_tensor``
make.  Layer: the front door (``config.target_device``, ``mbar._place``).
Moves ``job_s``."""

COPIES = ("Memcpy HtoD",)


def read(run):
    values = []
    for name, start, end in run.trace.spans:
        if name != "job":
            continue
        copies = run.trace.device_in(start, end, names=COPIES)
        if copies:
            longest = max(copies, key=lambda c: c[2] - c[1])
            values.append((longest[2] - start) * 1e-9)
    return sum(values) / len(values) if values else None
