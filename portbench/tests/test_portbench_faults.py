"""A run drives the program with its timed path broken underneath, on the
CPU at a tiny size, and ``correct`` comes out false, once for each fault
these one-card cells can have:

* a step that returns its state unchanged (the dd polish's chord-Newton
  step, and so the solve stops at its float32 warm start);
* half of the batch left out, the mean taken over the rest (the weight
  sums over every other sample, doubled);
* an answer altered where it is produced (one free energy of the solve
  moved by 1e-6).

No cell spans cards, so no exchange between chips can be left out.
"""

import pytest

from pymbar_tpu_torch import MBAR, solvers_large
from portbench.tests import tiny


def _unchanged_step(monkeypatch):
    monkeypatch.setattr(solvers_large, "_newton_step_g", lambda f, g, hinv, gamma: f)


def _half_the_samples(monkeypatch):
    wsum_dd = solvers_large.wsum_dd

    def half(u_hi, u_lo, g_hi, g_lo, c=None):
        c_half = None if c is None else c[::2].contiguous()
        s_hi, s_lo = wsum_dd(u_hi[:, ::2].contiguous(), u_lo[:, ::2].contiguous(), g_hi, g_lo,
                             c_half)
        return 2 * s_hi, 2 * s_lo

    monkeypatch.setattr(solvers_large, "wsum_dd", half)


def _altered_answer(monkeypatch):
    init = MBAR.__init__

    def altered(self, *a, **k):
        init(self, *a, **k)
        self.f_k = self.f_k.copy()
        self.f_k[-1] += 1e-6

    monkeypatch.setattr(MBAR, "__init__", altered)


FAULTS = {"unchanged_step": _unchanged_step, "half_the_samples": _half_the_samples,
          "altered_answer": _altered_answer}


@pytest.mark.parametrize("name", tiny.CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(monkeypatch, name, fault):
    FAULTS[fault](monkeypatch)
    result, rows = tiny.run(monkeypatch, name)
    assert result["correct"] is False, rows


@pytest.mark.parametrize("name", tiny.CELLS)
def test_sound_run_is_correct(monkeypatch, name):
    result, rows = tiny.run(monkeypatch, name)
    assert result["correct"] is True, rows
