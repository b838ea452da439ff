"""One run of one cell: set-up, the closed-loop window, the comparison with
the plain reference, and the result.

A job is what one analyst does and waits for: ``MBAR(u_kn, N_k, ...)`` and
then ``compute_free_energy_differences(...)``, with the keywords of the
cell's traffic file, ending in ``torch.cuda.synchronize()``.  Each job
solves its own data set, made from the run's seed and the job's index, so
a run averages over many data sets and every run does the same amount of
work of the same shapes.  The window is the jobs' walls end to end (the
harness makes the next job's data between them, outside the window); it
runs until ``seconds`` have passed in it and the current job has ended
(with ``trace``: until the traffic's ``trace_jobs`` have ended, under the
profiler).
"""

import importlib
import random
import statistics
import sys
import time
import traceback

import numpy as np
import torch

from portbench import cells, checks, data, reference, tracing

__all__ = ["FORBIDDEN", "forbidden_modules", "job_seed", "Inputs", "Job", "run", "compare",
           "control_output"]

# Top-level module names that no run may load, compared whole: the JAX
# package's name is a prefix of the port's.
FORBIDDEN = ("jax", "jaxlib", "flax", "pymbar_tpu")

# What this harness runs.  A traffic mix that names another placement or
# another key is refused, as data.py refuses another system, so that no cell
# measures something else under its name (README.md).
PLACEMENTS = ("card", "host_numpy")
TRAFFIC_KEYS = frozenset({"why", "placement", "mbar", "free_energies", "check_jobs", "trace_jobs"})


def forbidden_modules(modules=None):
    """The forbidden top-level names among ``modules`` (default: sys.modules)."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def job_seed(seed, index):
    """The seed of job ``index`` (0 is the warm-up) of a run's seed: of its
    data, and of its bootstrap draws (``rseed``)."""
    return int(seed) * 65536 + int(index)


def _scalars(info):
    return {k: v for k, v in (info or {}).items() if isinstance(v, (bool, int, float))}


class _Span:
    """Host-clock span of the harness, fenced by a synchronize; under the
    profiler also a user annotation ``portbench.<name>``."""

    def __init__(self, name, record, device, trace):
        self.name, self.record, self.device, self.trace = name, record, device, trace

    def __enter__(self):
        _sync(self.device)
        self.fn = torch.profiler.record_function(tracing.SPAN_PREFIX + self.name) if self.trace else None
        if self.fn is not None:
            self.fn.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        _sync(self.device)
        self.record[self.name] = time.perf_counter() - self.t0
        if self.fn is not None:
            self.fn.__exit__(*exc)


class Inputs:
    """Each job's u_kn, made from the run's seed and the job's index
    (:func:`job_seed`) and placed as the traffic says: a tensor on the card,
    or a numpy array in host memory (one buffer, refilled for each job).
    Making it is the harness's work: it falls between jobs, outside the
    window."""

    def __init__(self, config, placement, seed, device):
        if placement not in PLACEMENTS:
            raise ValueError(f"placement {placement!r}: this harness places u_kn as one of {PLACEMENTS}")
        self.config, self.placement, self.seed, self.device = config, placement, seed, device
        self.host = None
        self.u = None

    def __call__(self, index):
        """(u_in, N_k) of job ``index``; the previous job's card tensor is
        released first."""
        self.u = None
        u, N_k = data.oscillators(self.config, job_seed(self.seed, index), self.device)
        if self.placement != "host_numpy":
            self.u = u
            return u, N_k
        if self.host is None:
            self.host = np.empty(tuple(u.shape), dtype=np.float64)
        torch.from_numpy(self.host).copy_(u)
        return self.host, N_k


class Job:
    """The cell's job: ``MBAR`` then ``compute_free_energy_differences`` with
    the traffic's keywords, on the inputs it is given."""

    def __init__(self, MBAR, traffic, seed, device):
        unknown = sorted(set(traffic) - TRAFFIC_KEYS)
        if unknown:
            raise ValueError(f"traffic keys {unknown}: this harness reads only {sorted(TRAFFIC_KEYS)}")
        self.MBAR = MBAR
        self.mbar_kw = dict(traffic.get("mbar") or {})
        self.fe_kw = dict(traffic.get("free_energies") or {})
        self.seed, self.device = seed, device
        self.trace = False
        self.captured = {}

    def __call__(self, index, u_in, N_k):
        spans = {}
        kw = dict(self.mbar_kw)
        if kw.get("n_bootstraps"):
            kw["rseed"] = job_seed(self.seed, index)
        for calls in self.captured.values():
            calls.clear()
        with _Span("job", spans, self.device, self.trace):
            with _Span("mbar", spans, self.device, self.trace):
                m = self.MBAR(u_in, N_k, **kw)
            with _Span("free_energies", spans, self.device, self.trace):
                res = m.compute_free_energy_differences(**self.fe_kw)
        results = getattr(m, "solver_results", None) or [{}]
        out = {
            "index": index,
            "Delta_f": res["Delta_f"],
            "dDelta_f": res.get("dDelta_f"),
            "rints": getattr(m, "bootstrap_rints", None) if kw.get("n_bootstraps") else None,
            "wall_s": spans["job"],
            "spans": spans,
            "info": _scalars(results[0].get("info")),
            "captured": {k: list(v) for k, v in self.captured.items()},
        }
        del m
        return out


def _resolve(path):
    module, attr = path.split(":")
    return importlib.import_module(module), attr


class _Capture:
    """Wraps the program functions that the cell's readers name (``CAPTURE``),
    recording (wall, returned value) per call; undone by :meth:`close`."""

    def __init__(self, paths, job):
        self.saved = []
        for path in paths:
            module, attr = _resolve(path)
            fn = getattr(module, attr)
            calls = job.captured.setdefault(path, [])

            def wrapped(*a, _fn=fn, _calls=calls, **k):
                t0 = time.perf_counter()
                out = _fn(*a, **k)
                _calls.append((time.perf_counter() - t0, out))
                return out

            setattr(module, attr, wrapped)
            self.saved.append((module, attr, fn))

    def close(self):
        for module, attr, fn in reversed(self.saved):
            setattr(module, attr, fn)


def _counters(paths):
    out = {}
    for path in paths:
        module, attr = _resolve(path)
        out[path] = getattr(module, attr)
    return out


class RunView:
    """What a per-layer reader reads: the cell's ``config`` and ``traffic``,
    the traced ``jobs`` (each a dict of ``wall_s``, ``spans``, ``info``,
    ``captured``), the program's ``counters`` over them (deltas by
    "module:NAME"), and the ``trace`` (:class:`tracing.Trace`)."""

    def __init__(self, config, traffic, jobs, counters, trace):
        self.config, self.traffic, self.jobs = config, traffic, jobs
        self.counters, self.trace = counters, trace


def _attempt(job, index, inputs, errors, device):
    """(answer, wall): job ``index``'s answer, or None when it raised (a
    failed answer: the run goes on, the first traceback goes to standard
    error), and its wall, fenced by synchronizes."""
    u_in, N_k = inputs(index)
    _sync(device)
    t0 = time.perf_counter()
    try:
        out = job(index, u_in, N_k)
    except Exception:  # noqa: BLE001 - any error of the program is a failed job
        if not errors:
            traceback.print_exc(file=sys.stderr)
        errors.append(index)
        _sync(device)
        return None, time.perf_counter() - t0
    return out, time.perf_counter() - t0


def _activities(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _warm_profiler(device):
    """Start and stop the profiler once around a small operation, so that its
    own start-up (CUPTI's) falls into set-up and not into the traced jobs."""
    with torch.profiler.profile(activities=_activities(device)):
        torch.ones(1024, device=device).sum().item()


def _slim(out):
    return {k: out[k] for k in ("index", "wall_s", "spans", "info", "captured")}


def control_output(u_kn, N_k, traffic, seed, index, dtype=torch.float32):
    """The reference put in the program's place, computed in ``dtype``: a
    job's answer (Delta_f, dDelta_f and, for a bootstrap, its resample
    indices, drawn by state from ``rseed``)."""
    f, _ = reference.solve(u_kn, N_k, dtype=dtype)
    out = {"Delta_f": reference.differences(f)}
    B = int((traffic.get("mbar") or {}).get("n_bootstraps", 0))
    if B:
        rng = np.random.default_rng(job_seed(seed, index))
        N_k = np.asarray(N_k, dtype=np.int64)
        starts = np.concatenate([[0], np.cumsum(N_k)])
        state = np.repeat(np.arange(N_k.size), N_k)
        rints = starts[state][None, :] + rng.integers(0, N_k[state], size=(B, state.size))
        counts = checks.stratified_counts(rints, N_k)[0]
        out["dDelta_f"] = reference.sigma_bootstrap(u_kn, N_k, f, counts, dtype=dtype)[0]
        out["rints"] = rints
    else:
        out["dDelta_f"] = reference.sigma_svd_ew(u_kn, N_k, f, dtype=dtype)
    return out


def compare(u_kn, N_k, traffic, outs):
    """The numbers of each answer in ``outs`` (answers on this one ``u_kn``)
    against the float64 reference on it: a list of dicts."""
    f_ref, _ = reference.solve(u_kn, N_k)
    df_ref = reference.differences(f_ref)
    bootstrap = (traffic.get("free_energies") or {}).get("uncertainty_method") == "bootstrap"
    sigma_ref = None if bootstrap else reference.sigma_svd_ew(u_kn, N_k, f_ref)
    numbers = []
    for out in outs:
        extra = {}
        if bootstrap:
            counts, extra["draws_bad"] = checks.stratified_counts(out["rints"], N_k)
            sigma_ref = reference.sigma_bootstrap(u_kn, N_k, f_ref, counts)[0]
        numbers.append({**extra, **checks.job_numbers(out, df_ref, sigma_ref)})
    return numbers


def run(cell, bench, seed, seconds, trace, device, t0):
    """One run of ``cell``; ``t0`` is the process's start (perf_counter).
    Returns (result dict without "checks", [(name, value, limit)])."""
    from pymbar_tpu_torch import MBAR

    device = torch.device(device)
    on_card = device.type == "cuda"
    traffic = cell.traffic
    per_layer = cells.metric_entries(bench, "per_layer", cell.name) if trace else []
    readers = {m["name"]: cells.load_reader(m["name"]) for m in per_layer}

    # ---- set-up: one warm-up job (index 0), on its own data
    inputs = Inputs(cell.config, traffic["placement"], seed, device)
    job = Job(MBAR, traffic, seed, device)
    errors = []
    _attempt(job, 0, inputs, errors, device)
    index = 1
    capture = _Capture(sorted({p for r in readers.values() for p in getattr(r, "CAPTURE", ())}), job)
    counter_paths = sorted({p for r in readers.values() for p in getattr(r, "COUNTERS", ())})
    if trace:
        _warm_profiler(device)
    _sync(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0
    print(f"set-up {setup_s:.3f} s", file=sys.stderr, flush=True)

    # ---- the window: jobs back to back, each on its own data
    keep = int(traffic.get("check_jobs", 1))
    rng = random.Random(seed)
    kept, walls, records = [], [], []
    attempted = failed = 0
    window_s = 0.0
    job.trace = bool(trace)
    prof = None
    if trace:
        prof = torch.profiler.profile(activities=_activities(device))
        prof.__enter__()
    before = _counters(counter_paths)
    while True:
        attempted += 1
        out, wall = _attempt(job, index, inputs, errors, device)
        window_s += wall
        failed += out is None
        index += 1
        if out is not None:
            walls.append(out["wall_s"])
            records.append(_slim(out))
            slot = rng.randrange(len(walls))  # a uniform sample of the answers
            if len(kept) < keep:
                kept.append(out)
            elif slot < keep:
                kept[slot] = out
            del out
        if trace and len(walls) >= int(traffic.get("trace_jobs", 1)):
            break
        if window_s >= seconds and (walls or failed >= 3):
            break
    after = _counters(counter_paths)
    capture.close()
    if prof is not None:
        prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    # ---- the result's metrics
    metrics = {}
    jobs = len(walls)
    values = {
        "setup_s": setup_s,
        "job_s": window_s / jobs if jobs else None,
        "job_p90_s": statistics.quantiles(walls, n=10, method="inclusive")[-1] if jobs > 1 else None,
        "peak_mem_gb": peak / 1e9,
    }
    device_info = {
        "platform": "gpu" if on_card else device.type,
        "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": int(peak),
    }
    breakdown = None
    if trace:
        tr = tracing.from_profiler(prof)
        del prof
        view = RunView(cell.config, traffic, records,
                       {p: after[p] - before[p] for p in counter_paths}, tr)
        for entry in per_layer:
            value = readers[entry["name"]].read(view)
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.window_s()
        breakdown = tracing.breakdown(tr)
    else:
        for entry in cells.metric_entries(bench, "end_to_end", cell.name):
            value = values.get(entry["name"])
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    print(f"window {window_s:.3f} s, {jobs} jobs, {failed} failed", file=sys.stderr, flush=True)

    # ---- the comparison, once the program's state is freed: each answer
    # against the reference on its job's data, made again from the seed
    del job, records, inputs
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = {"failed_jobs": failed}
    for out in kept:
        u, N_k = data.oscillators(cell.config, job_seed(seed, out["index"]), device)
        checks.merge(numbers, compare(u, N_k, traffic, [out])[0])
        del u
    print(f"reference {time.perf_counter() - t_ref:.3f} s over {len(kept)} jobs",
          file=sys.stderr, flush=True)
    correct, rows = checks.judge(numbers, cell.limits)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    return result, rows
