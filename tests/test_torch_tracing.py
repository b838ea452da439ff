"""The program's spans (``pymbar_tpu_torch.tracing``) on the CPU.

Without a profiler a span builds no annotation and still fills its walls.
Under ``torch.profiler`` a numpy ``MBAR`` with bootstrap replicates on the
dd route (its planes, the base solve and the batched engine run on the CPU
with the plain weight sums) and its free energies leave one host event per
span, named ``pymbar_tpu_torch.<span>``, none inside another; the engine's
``phase_walls`` reach ``solver_results``.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pymbar_tpu_torch import MBAR, tracing
from pymbar_tpu_torch.testsystems import HarmonicOscillatorsTestCase

# one intra-op thread per test process: the suite's workers share the CPUs
torch.set_num_threads(1)

B = 4
PHASE_WALLS = {"prep_s", "upload_s", "materialize_s", "fast_s", "exact_s", "total_s"}


def _events(prof):
    """(name without the prefix, start_ns, end_ns) of the program's spans, in order."""
    out = [(e.name()[len(tracing.PREFIX):], e.start_ns(), e.end_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith(tracing.PREFIX)
           and e.device_type() == torch.autograd.DeviceType.CPU]
    return sorted(out, key=lambda t: t[1])


@pytest.fixture(scope="module")
def traced():
    """The program's spans of ``MBAR(numpy u_kn, n_bootstraps=B)`` on the dd
    route, then of the free energies by Theta and by the bootstrap, each
    call profiled on its own."""
    tc = HarmonicOscillatorsTestCase(O_k=[0.0, 1.0, 2.0, 3.0], K_k=[1.0, 2.0, 4.0, 8.0])
    _x, u_kn, N_k, _s = tc.sample(N_k=[60, 60, 60, 60], mode="u_kn", seed=3)
    acts = [ProfilerActivity.CPU]
    with profile(activities=acts) as p_init:
        m = MBAR(u_kn, N_k, solver_protocol=(dict(method="dd"),), n_bootstraps=B, rseed=7,
                 device="cpu")
    with profile(activities=acts) as p_theta:
        m.compute_free_energy_differences()
    with profile(activities=acts) as p_boot:
        m.compute_free_energy_differences(uncertainty_method="bootstrap")
    return m, {"init": _events(p_init), "theta": _events(p_theta), "boot": _events(p_boot)}


def test_span_off_builds_no_annotation_and_fills_walls(monkeypatch):
    def refuse(name):
        raise AssertionError(f"an annotation was built for {name}")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert tracing.span("a") is tracing.span("b")  # the shared no-op
    walls = {"x_s": 1.0}
    for _ in range(2):
        with tracing.span("x", walls, "x_s"):
            pass
        with tracing.span("y", walls, "y_s"):
            pass
    assert walls["x_s"] > 1.0 and walls["y_s"] > 0.0


@pytest.mark.parametrize("call, names", [
    ("init", {"place.host_copy", "place.upload", "boot.draws", "boot.counts", "dd.split",
              "dd.phase1", "dd.phase2", "boot.materialize", "boot.prep", "boot.upload",
              "boot.fast", "boot.exact", "boot.retry"}),
    ("theta", {"theta.gram", "theta.cov", "fe.errors"}),
    ("boot", {"boot.sigma"}),
])
def test_each_call_leaves_its_spans(traced, call, names):
    _m, events = traced
    assert {name for name, _s, _e in events[call]} == names


def test_no_span_lies_inside_another(traced):
    _m, events = traced
    for spans in events.values():
        for (_a, _s, end), (b, start, _e) in zip(spans, spans[1:]):
            assert start >= end, b


def test_walls_come_from_the_spans(traced):
    m, events = traced
    info = m.solver_results[0]["info"]
    spans = {}
    for name, start, end in events["init"]:
        spans[name] = spans.get(name, 0) + (end - start) * 1e-9
    for key, name in (("phase1_s", "dd.phase1"), ("phase2_s", "dd.phase2")):
        assert 0.0 < info[key] <= spans[name]
    walls = info["bootstrap_phase_walls"]
    assert set(walls) == PHASE_WALLS
    for key in ("prep_s", "upload_s", "materialize_s", "fast_s", "exact_s"):
        assert 0.0 < walls[key] <= spans["boot." + key[:-2]]
    assert walls["total_s"] >= sum(walls[k] for k in PHASE_WALLS - {"total_s"})
    assert np.all(np.isfinite(m.f_k_boots))
