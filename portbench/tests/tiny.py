"""Tiny CPU versions of the benchmark's cells for the tests.

A cell keeps its traffic and limits; its configuration keeps every key but
its sizes (K = 8 states x 200 samples).  The program is steered onto the
route every cell takes on the card: the dd solve (``MBAR._dd_sized``).
"""

import time

import torch

from portbench import cells, harness

CELLS = ("osc1024.free_energies", "states4096.free_energies", "osc1024.bootstrap64",
         "osc1024.numpy_in")


def cell(name, K=8, samples_per_state=200):
    bench = cells.load_benchmark()
    c = cells.load_cell(bench, name)
    c.config = dict(c.config, K=K, samples_per_state=samples_per_state)
    return bench, c


def steer(monkeypatch):
    """Put the program on the cell's card route, on the CPU."""
    from pymbar_tpu_torch import MBAR

    monkeypatch.setattr(MBAR, "_dd_sized", lambda self: True)
    monkeypatch.setenv("PYMBAR_TPU_TORCH_DEVICE", "cpu")
    torch.set_num_threads(1)


def run(monkeypatch, name, seed=2**31 + 5, seconds=0.2, trace=0):
    """(result, rows) of one tiny run of the cell on the CPU."""
    bench, c = cell(name)
    steer(monkeypatch)
    return harness.run(c, bench, seed, seconds, trace, "cpu", time.perf_counter())
