"""The run's last line, on the CPU at a tiny size, and its refusal without
a card."""

import json

import pytest

from portbench import run as run_script
from portbench.tests import tiny


@pytest.mark.parametrize("name", tiny.CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_shape(monkeypatch, name, trace):
    result, rows = tiny.run(monkeypatch, name, trace=trace)
    line = json.loads(run_script.result_line(result, rows))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name_, check in line["checks"].items():
        assert set(check) == {"value", "limit"} and check["value"] <= check["limit"], name_
    for metric in line["metrics"].values():
        assert set(metric) == {"value", "unit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())
    else:
        assert "setup_s" in line["metrics"] and "breakdown" not in line


def test_end_to_end_metrics_of_the_cells(monkeypatch):
    result, _ = tiny.run(monkeypatch, "osc1024.free_energies")
    assert set(result["metrics"]) == {"setup_s", "job_s", "job_p90_s", "peak_mem_gb"}
    result, _ = tiny.run(monkeypatch, "osc1024.bootstrap64")
    assert set(result["metrics"]) == {"setup_s", "peak_mem_gb"}


def test_traced_run_reads_the_program_spans(monkeypatch):
    result, _ = tiny.run(monkeypatch, "osc1024.bootstrap64", trace=1)
    assert {"boot_reps_per_s.traced", "boot_engine_s", "boot_host_s"} <= set(result["metrics"])
    result, _ = tiny.run(monkeypatch, "osc1024.free_energies", trace=1)
    assert {"free_energies_s", "dd_phase1_s", "dd_phase2_s"} <= set(result["metrics"])


def test_non_finite_numbers_are_named():
    line = json.loads(run_script.result_line({"correct": False}, [("df_err", float("nan"), 1e-8)]))
    assert line["checks"]["df_err"] == {"value": "nan", "limit": 1e-8}


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    rc = run_script.main(["--workload", "osc1024.free_energies", "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""
