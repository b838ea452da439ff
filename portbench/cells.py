"""Finding a cell's files by name.

``BENCHMARK.json`` at the root of the checkout names every cell (an entry
of ``workloads``), its configuration and its traffic mix, and every metric.
Each lives in a file of its own under ``portbench/``, found by its name:

* a configuration: the ``file`` of its entry in ``configs``
  (``portbench/configs/<name>.json``);
* a traffic mix: ``portbench/traffic/<name>.json``;
* a cell's limits on the numbers that decide ``correct``:
  ``portbench/limits/<cell name>.json``;
* a per-layer metric's reader: ``portbench/metrics/<metric name>.py``,
  a module with one function ``read(run)``.

So a cell or a metric is added by adding files and entries; no file that
is there changes.
"""

import importlib.util
import json
from pathlib import Path

__all__ = ["ROOT", "Cell", "load_benchmark", "load_cell", "metric_entries", "load_reader"]

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent


def load_benchmark(root=ROOT):
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _load_json(path):
    return json.loads(Path(path).read_text())


class Cell:
    """One entry of ``workloads`` with its configuration, traffic and limits."""

    def __init__(self, entry, config, traffic, limits):
        self.name = entry["name"]
        self.chips = int(entry["chips"])
        self.entry = entry
        self.config = config
        self.traffic = traffic
        self.limits = limits


def load_cell(bench, name, root=ROOT):
    """The :class:`Cell` named ``name``; KeyError naming the known cells."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r}; the cells are {sorted(cells)}")
    entry = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(Path(root) / configs[entry["config"]]["file"])
    traffic = _load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    limits = _load_json(HERE / "limits" / f"{name}.json")
    return Cell(entry, config, traffic, limits)


def metric_entries(bench, section, cell_name):
    """The entries of ``section`` ("end_to_end" or "per_layer") that the cell
    reports: those that list it under ``workloads``, and those with none."""
    return [m for m in bench[section]
            if "workloads" not in m or cell_name in m["workloads"]]


def load_reader(name):
    """The module of ``portbench/metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
