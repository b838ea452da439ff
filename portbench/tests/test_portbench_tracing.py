"""The idle-share arithmetic of a traced run on synthetic intervals."""

import pytest

from portbench import tracing


def test_union_counts_overlaps_once():
    iv = [("k1", 0, 10), ("copy", 5, 15), ("k2", 20, 30), ("k3", 22, 25)]
    busy, merged = tracing.union(iv, 0, 40)
    assert busy == 25 and merged == [[0, 15], [20, 30]]


def test_union_clips_to_the_window():
    busy, merged = tracing.union([("a", -5, 5), ("b", 8, 50)], 0, 10)
    assert busy == 7 and merged == [[0, 5], [8, 10]]


def test_idle_gaps_cover_the_rest_of_the_window():
    iv = [("k1", 2, 4), ("k2", 3, 6), ("k3", 9, 10)]
    assert tracing.idle_gaps(iv, 0, 12) == [[0, 2], [6, 9], [10, 12]]
    assert tracing.idle_gaps([], 0, 5) == [[0, 5]]


def _trace():
    device = [("wsum_fused", 100, 200), ("Memcpy HtoD (Pageable -> Device)", 150, 400),
              ("gemm", 500, 550), ("harness fill", 620, 680), ("wsum_fused", 720, 760)]
    spans = [("job", 0, 600), ("mbar", 0, 420), ("free_energies", 420, 600),
             ("job", 700, 800), ("mbar", 700, 800)]
    host = [("aten::copy_", 120, 410), ("aten::linalg_eigh", 430, 560)]
    return tracing.Trace(device, spans, host)


def test_trace_window_is_the_jobs():
    tr = _trace()
    assert tr.jobs == [(0, 600), (700, 800)]
    assert tr.window_s() == pytest.approx(700e-9)
    assert tr.busy_s() == pytest.approx(390e-9)  # the fill between jobs is not counted


def test_breakdown_of_the_jobs():
    b = tracing.breakdown(_trace())
    assert b["device_ops"][0] == ["Memcpy HtoD (Pageable -> Device)", pytest.approx(250e-9)]
    assert b["device_ops"][1] == ["wsum_fused", pytest.approx(140e-9)]
    assert all(name != "harness fill" for name, _ in b["device_ops"])
    gaps = b["idle_gaps"]
    assert gaps[0] == ["mbar", pytest.approx(100e-9)]
    assert gaps[1] == ["free_energies/aten::linalg_eigh", pytest.approx(100e-9)]
    assert sum(g[1] for g in gaps) == pytest.approx(310e-9)


def test_device_in_filters_by_start_and_name():
    tr = _trace()
    assert [d[0] for d in tr.device_in(0, 300, names=("wsum",))] == ["wsum_fused"]
    assert len(tr.device_in(140, 600)) == 2
    assert [d[1] for d in tr.device_in_jobs(("wsum",))] == [100, 720]
