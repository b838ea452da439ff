"""Spans of the program's own work, for ``torch.profiler`` and for walls.

Run a call under ``torch.profiler.profile(...)`` and every :func:`span`
that the call passes through becomes a user annotation named
``pymbar_tpu_torch.<name>``.  The profiler stamps it on the same clock as
the kernels and copies it records, so the trace shows what the host was
doing while the card waited.  Without a profiler a span costs one flag
check; there is no setting to turn it on or off.

A span adds no synchronize.  A span that covers device work ends at a
host read that the code waits on anyway, so its wall covers that work.
Spans sit directly under the public calls (``MBAR(...)``, the free
energies, the expectations, ``FES``): no span is opened inside another.

The spans:

========================  ==========================================================
``place.host_copy``       ``mbar_core._upload_whole``: one block of ``u_kn`` cast into pinned
                          memory; ``mbar._u_tensor``: a u_kln laid out, or the float64 copy
                          of numpy placed on the CPU
``place.upload``          ``mbar_core._upload_whole``: a wait for a block's copy to the card
                          to leave its pinned buffer; ``mbar._u_tensor``: the CPU copy placed
``boot.draws``            ``MBAR._draw_bootstrap_rints``: the resample indices
``boot.counts``           ``MBAR.__init__``: their per-sample counts
``boot.sigma``            the free energies' bootstrap standard deviation
``theta.gram``            Theta's streamed Gram pass and its normalization check
``theta.cov``             Theta from the Gram (or W's R factor), to the host
``fe.errors``             ``MBAR._ErrorOfDifferences``: the K x K uncertainties
``dd.split``              ``solvers_large.stream_split_planes``: the (hi, lo) planes
``dd.phase1``             the dd solve's float32 warm start and chord factor
``dd.phase2``             the dd solve's double-word polish
``boot.materialize``      the batched bootstrap's resident float32 plane
``boot.prep``             the batched bootstrap's counts on the host
``boot.upload``           the counts of a group to the device
``boot.fast``             a group's float32 fast phase
``boot.exact``            a group's float64 exact phase, to the host
``boot.retry``            the replicates that retry with a fresh factor
========================  ==========================================================
"""

import contextlib
import time

import torch

__all__ = ["PREFIX", "span"]

PREFIX = "pymbar_tpu_torch."

_OFF = contextlib.nullcontext()


class _Span:
    """A user annotation while a profiler records, and a wall added to
    ``walls[key]`` when ``walls`` is given."""

    __slots__ = ("name", "walls", "key", "_annotation", "_t0")

    def __init__(self, name, walls, key):
        self.name, self.walls, self.key = name, walls, key

    def __enter__(self):
        self._annotation = None
        if torch.autograd._profiler_enabled():
            self._annotation = torch.profiler.record_function(PREFIX + self.name)
            self._annotation.__enter__()
        self._t0 = time.perf_counter()

    def __exit__(self, *exc):
        if self.walls is not None:
            self.walls[self.key] = self.walls.get(self.key, 0.0) + time.perf_counter() - self._t0
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        return False


def span(name, walls=None, key=None):
    """A context manager around one piece of the program's work.

    While a ``torch.profiler`` records, it is the user annotation
    ``pymbar_tpu_torch.<name>``.  With ``walls`` (a dict) it adds its
    ``time.perf_counter()`` wall to ``walls[key]``, profiler or not.
    Otherwise it is a shared no-op."""
    if walls is None and not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, walls, key)
