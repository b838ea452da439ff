"""Analytically solvable test systems (numpy carry-over of
:mod:`pymbar_tpu.testsystems`; reference pymbar 4.x testsystems/).  The same
seed gives the same samples as the JAX package's."""

__all__ = [
    "timeseries",
    "exponential_distributions",
    "harmonic_oscillators",
    "gaussian_work",
    "HarmonicOscillatorsTestCase",
    "ExponentialTestCase",
    "correlated_timeseries_example",
    "gaussian_work_example",
]

from pymbar_tpu_torch.testsystems import (  # noqa: F401
    exponential_distributions,
    gaussian_work,
    harmonic_oscillators,
    timeseries,
)
from pymbar_tpu_torch.testsystems.exponential_distributions import ExponentialTestCase
from pymbar_tpu_torch.testsystems.gaussian_work import gaussian_work_example
from pymbar_tpu_torch.testsystems.harmonic_oscillators import HarmonicOscillatorsTestCase
from pymbar_tpu_torch.testsystems.timeseries import correlated_timeseries_example
