"""The readers of the program's spans on synthetic traces, the idle gaps
they name, and a traced tiny run on the CPU that reads every one of them."""

from types import SimpleNamespace

import pytest

from portbench import cells, tracing
from portbench.tests import tiny

# reader: the program's span it reads
READERS = {
    "place_copy_s.numpy_in": "place.host_copy",
    "place_upload_s.numpy_in": "place.upload",
    "theta_gram_s": "theta.gram",
    "theta_cov_s": "theta.cov",
    "fe_errors_s": "fe.errors",
    "boot_draws_s": "boot.draws",
    "boot_counts_s": "boot.counts",
    "boot_sigma_s": "boot.sigma",
}


def _trace(span):
    """Two jobs: the span twice in the first (with a longer host op of the
    program around and inside), once more just before the second, which
    has none of its own; a span of another name and a harness span."""
    name = "pymbar_tpu_torch." + span
    host = [(name, 10, 40), ("aten::sub", 12, 30), (name, 50, 60),
            ("pymbar_tpu_torch.other", 60, 90), (name, 195, 205)]
    spans = [("job", 0, 100), ("mbar", 1, 99), ("job", 200, 300), ("mbar", 201, 299)]
    return tracing.Trace([("wsum_fused", 40, 50), ("wsum_fused", 210, 300)], spans, host)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_sums_each_job_and_means_over_jobs(metric):
    reader = cells.load_reader(metric)
    # (30 + 10) ns in the first job, 0 in the second: the one that starts
    # before the second job is in neither
    assert reader.read(SimpleNamespace(trace=_trace(READERS[metric]))) == pytest.approx(20e-9)
    assert reader.read(SimpleNamespace(trace=_trace("absent"))) is None


def test_every_reader_is_in_the_benchmark():
    bench = cells.load_benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for metric in READERS:
        assert entries[metric]["source"] == "program_span" and entries[metric]["workloads"]


def test_gap_inside_a_program_span_is_named_by_it():
    gaps = tracing.breakdown(_trace("boot.draws"))["idle_gaps"]
    names = {name for name, _s in gaps}
    assert "mbar/pymbar_tpu_torch.boot.draws" in names  # [0, 40): not the aten::sub inside
    assert "mbar/pymbar_tpu_torch.other" in names  # [50, 100)


@pytest.mark.parametrize("name", ["osc1024.numpy_in", "osc1024.bootstrap64"])
def test_traced_tiny_run_reads_the_cell_s_span_metrics(monkeypatch, name):
    bench = cells.load_benchmark()
    wanted = {m for m in READERS
              if name in next(e for e in bench["per_layer"] if e["name"] == m)["workloads"]}
    result, _ = tiny.run(monkeypatch, name, trace=1)
    assert wanted and wanted <= set(result["metrics"])
    assert all(result["metrics"][m]["value"] > 0 for m in wanted)
    gaps = [g for g, _s in result["breakdown"]["idle_gaps"]]
    assert any("pymbar_tpu_torch." in g for g in gaps)
