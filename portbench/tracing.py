"""Reading one traced run: the device's activity from ``torch.profiler``, the
harness's spans, the union of the device's busy intervals and its idle gaps.

The profiler keeps its events in memory over the traced jobs; this module
reads them once the profiler has stopped and keeps only plain tuples of
(name, start_ns, end_ns).  Nothing is written to disk.  A device interval is
a kernel, a memory copy or a memory set; copies that overlap kernels are
merged into one busy interval, so no time is counted twice.
"""

import torch

__all__ = [
    "SPAN_PREFIX",
    "Trace",
    "from_profiler",
    "union",
    "idle_gaps",
    "breakdown",
]

# The harness's spans are recorded as user annotations named "portbench.<span>".
SPAN_PREFIX = "portbench."
_DEVICE_ACTIVITIES = ("kernel", "memcpy", "memset")
_NAME_CHARS = 120
_TOP = 10


class Trace:
    """What one traced run left: ``device`` (kernels, copies, sets), ``spans``
    (the harness's, named without the prefix) and ``host_ops`` (the
    program's host-side operations), each a list of (name, start_ns,
    end_ns).  The window is the jobs' spans, ``jobs`` ([start_ns, end_ns]
    each): what the harness does between jobs lies outside it."""

    def __init__(self, device, spans, host_ops):
        self.device = sorted(device, key=lambda t: t[1])
        self.spans = sorted(spans, key=lambda t: t[1])
        self.host_ops = host_ops
        self.jobs = [(s, e) for name, s, e in self.spans if name == "job"]

    def window_s(self):
        return sum(e - s for s, e in self.jobs) * 1e-9

    def busy_s(self):
        return sum(union(self.device, s, e)[0] for s, e in self.jobs) * 1e-9

    def device_in(self, lo, hi, names=None):
        """Device intervals that start within [lo, hi), those whose name holds
        one of ``names`` when given."""
        return [d for d in self.device if lo <= d[1] < hi
                and (names is None or any(n in d[0] for n in names))]

    def device_in_jobs(self, names=None):
        """Device intervals that start within a job, as :meth:`device_in`."""
        return [d for s, e in self.jobs for d in self.device_in(s, e, names)]


def _is_device_work(e, name):
    """A kernel, copy or set on the card: a CUDA event that is no annotation
    (the harness's spans appear on the card's timeline too).  Where the
    event names its activity, only kernels, copies and sets count."""
    if e.device_type() != torch.autograd.DeviceType.CUDA or name.startswith(SPAN_PREFIX):
        return False
    annotation = getattr(e, "is_user_annotation", None)
    if callable(annotation) and annotation():
        return False
    kind = getattr(e, "activity_type", None)
    return not callable(kind) or any(a in kind().lower() for a in _DEVICE_ACTIVITIES)


def _times(e):
    if hasattr(e, "start_ns"):
        return e.start_ns(), e.end_ns() if hasattr(e, "end_ns") else e.start_ns() + e.duration_ns()
    return int(e.start_us() * 1000), int((e.start_us() + e.duration_us()) * 1000)


def from_profiler(prof):
    """A :class:`Trace` from a stopped ``torch.profiler.profile``."""
    device, spans, host_ops = [], [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start, end = _times(e)
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if _is_device_work(e, name) and end > start:
                device.append((name, start, end))
        elif name.startswith(SPAN_PREFIX):
            spans.append((name[len(SPAN_PREFIX):], start, end))
        elif end > start:
            host_ops.append((name, start, end))
    return Trace(device, spans, host_ops)


def union(intervals, lo, hi):
    """(busy, merged): the length covered by ``intervals`` ((name, start,
    end) tuples) inside [lo, hi], each instant once, and the merged
    [start, end] list in order."""
    merged = []
    for _name, s, e in sorted(intervals, key=lambda t: t[1]):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def idle_gaps(intervals, lo, hi):
    """The [start, end] gaps of [lo, hi] that no interval covers, in order."""
    gaps, at = [], lo
    for s, e in union(intervals, lo, hi)[1]:
        if s > at:
            gaps.append([at, s])
        at = max(at, e)
    if hi > at:
        gaps.append([at, hi])
    return gaps


def _within(items, t):
    return [x for x in items if x[1] <= t < x[2]]


def gap_name(trace, start, end):
    """What the host was doing in a gap: the innermost harness span around
    its middle, and the outermost host operation of the program there."""
    mid = (start + end) // 2
    spans = _within(trace.spans, mid)
    name = min(spans, key=lambda s: s[2] - s[1])[0] if spans else "between jobs"
    ops = _within(trace.host_ops, mid)
    if ops:
        name += "/" + min(ops, key=lambda o: o[1])[0]
    return name[:_NAME_CHARS]


def breakdown(trace):
    """{"device_ops": the (at most 10) device operations that took most time in
    the jobs, by name; "idle_gaps": the (at most 10) longest idle gaps in
    the jobs, each named by :func:`gap_name`}, seconds as measured."""
    by_name, gaps = {}, []
    for lo, hi in trace.jobs:
        for name, s, e in trace.device_in(lo, hi):
            e = min(e, hi)
            key = name[:_NAME_CHARS]
            by_name[key] = by_name.get(key, 0) + (e - s)
        gaps += idle_gaps(trace.device, lo, hi)
    ops = sorted(by_name.items(), key=lambda t: -t[1])[:_TOP]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:_TOP]
    return {
        "device_ops": [[name, ns * 1e-9] for name, ns in ops],
        "idle_gaps": [[gap_name(trace, s, e), (e - s) * 1e-9] for s, e in gaps],
    }
