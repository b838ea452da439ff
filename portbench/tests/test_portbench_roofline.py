"""The roofline's byte and operation counts against sums by hand."""

import pytest

from portbench import roofline

HBM = 3.35e12


def test_least_time_takes_the_larger_bound():
    assert roofline.least_time_s(3.35e12, 0, 1, 1e12) == (1.0, "bytes")
    assert roofline.least_time_s(1, 0, 2e12, 1e12) == (2.0, "operations")


def test_k1_at_the_flagship_is_bound_by_bytes():
    K, N = 1024, 1024 * 976
    # two float32 planes, the g pair in, the S pair out
    by_hand = (4 * K * N + 4 * K * N + 4 * K + 4 * K + 4 * K + 4 * K) / HBM
    assert roofline.k1_least_s(K, N) == pytest.approx(by_hand, rel=1e-12)
    assert roofline.k1_least_s(K, N) == pytest.approx(2.44e-3, rel=0.01)
    assert roofline.k1_least_s(K, N, counts=True) - roofline.k1_least_s(K, N) == pytest.approx(
        4 * N / HBM, rel=1e-9)


def test_k1_at_the_stress_states_is_bound_by_bytes():
    K, N = 4096, 4096 * 244
    by_hand = (8 * K * N + 8 * K + 8 * K) / HBM
    assert roofline.k1_least_s(K, N) == pytest.approx(by_hand, rel=1e-12)
    assert roofline.k1_least_s(K, N) == pytest.approx(9.77e-3, rel=0.01)


def test_a_kernel_with_few_columns_is_bound_by_operations():
    K, N = 1, 1
    t, bound = roofline.least_time_s(8, 8, 1e12, roofline.PEAKS["f64_ops_per_s"])
    assert bound == "operations" and t == pytest.approx(1e12 / 34e12)
    assert roofline.k1_least_s(K, N) > 0
