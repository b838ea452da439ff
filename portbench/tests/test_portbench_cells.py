"""BENCHMARK.json and the files the harness finds by name."""

import json
import re
import time

import pytest

from portbench import cells, harness
from portbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return cells.load_benchmark()


def test_every_cell_finds_its_files(bench):
    for w in bench["workloads"]:
        cell = cells.load_cell(bench, w["name"])
        assert cell.config["K"] > 0 and cell.config["samples_per_state"] > 0
        assert cell.traffic["placement"] in ("card", "host_numpy")
        assert cell.limits["failed_jobs"]["limit"] == 0
        assert cell.chips == 1


def test_unknown_cell_names_the_known_ones(bench):
    with pytest.raises(KeyError, match="osc1024.free_energies"):
        cells.load_cell(bench, "no.such.cell")


def test_every_per_layer_metric_has_a_reader(bench):
    for m in bench["per_layer"]:
        assert callable(cells.load_reader(m["name"]).read)


def test_names_units_and_keys_keep_the_contract(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]]
    names += [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        for key in c["reduced"]:
            assert NAME.match(key) and key in json.loads(open(c["file"]).read())["reduced"]
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert e2e[m["moves"]] in cells.metric_entries(bench, "end_to_end", w)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer(bench):
    for w in bench["workloads"]:
        e2e = {m["name"] for m in cells.metric_entries(bench, "end_to_end", w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cells.metric_entries(bench, "per_layer", w["name"])


def test_metric_entries_take_the_cells_a_metric_lists(bench):
    names = {m["name"] for m in cells.metric_entries(bench, "end_to_end", "osc1024.bootstrap64")}
    assert names == {"setup_s", "peak_mem_gb"}
    names = {m["name"] for m in cells.metric_entries(bench, "per_layer", "states4096.free_energies")}
    assert "k1_roofline_pct" in names and "place_s.numpy_in" not in names


@pytest.mark.parametrize("part, change", [
    ("config", {"system": "umbrella"}),
    ("config", {"dtype": "float32"}),
    ("traffic", {"placement": "host_tensor"}),
    ("traffic", {"expectations": {}}),
])
def test_a_cell_this_harness_cannot_run_is_refused(monkeypatch, part, change):
    bench, cell = tiny.cell("osc1024.free_energies")
    setattr(cell, part, dict(getattr(cell, part), **change))
    tiny.steer(monkeypatch)
    with pytest.raises(ValueError, match="this (harness|generator)"):
        harness.run(cell, bench, 2**31 + 7, 0.1, 0, "cpu", time.perf_counter())
