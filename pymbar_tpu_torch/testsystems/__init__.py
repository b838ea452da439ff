"""Analytically solvable test systems (numpy; reference pymbar 4.x testsystems/).

Only the harmonic oscillators are carried over so far; the other systems of
:mod:`pymbar_tpu.testsystems` are still to be ported.
"""

__all__ = ["harmonic_oscillators", "HarmonicOscillatorsTestCase"]

from pymbar_tpu_torch.testsystems import harmonic_oscillators  # noqa: F401
from pymbar_tpu_torch.testsystems.harmonic_oscillators import HarmonicOscillatorsTestCase
