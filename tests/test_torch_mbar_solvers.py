"""pymbar_tpu_torch.mbar_solvers, the alias of the reference's
``pymbar.mbar_solvers`` surface, against pymbar_tpu.mbar_solvers
(tests/test_checkpoint.py:45-63)."""

import numpy as np
import torch

import pymbar_tpu_torch
from pymbar_tpu import mbar_solvers as jms
from pymbar_tpu_torch import mbar_solvers
from pymbar_tpu_torch import solvers as ts
from pymbar_tpu_torch.ops import mbar_core

# one intra-op thread per test process: the suite's workers share the CPUs
torch.set_num_threads(1)


def test_names_match_jax():
    assert mbar_solvers.__all__ == jms.__all__
    for name in mbar_solvers.__all__:
        assert hasattr(mbar_solvers, name), name
        home = ts if hasattr(ts, name) else mbar_core
        assert getattr(mbar_solvers, name) is getattr(home, name)
    assert mbar_solvers.DEFAULT_SOLVER_PROTOCOL == jms.DEFAULT_SOLVER_PROTOCOL
    assert mbar_solvers.scipy_minimize_options == jms.scipy_minimize_options


def test_gradient_vanishes_at_the_solution():
    tc = pymbar_tpu_torch.testsystems.HarmonicOscillatorsTestCase(
        O_k=[0, 1, 2, 3, 4], K_k=[1, 2, 4, 8, 16]
    )
    _x, u_kn, N_k, _s = tc.sample(N_k=[100, 100, 0, 100, 100], mode="u_kn", seed=1)
    m = pymbar_tpu_torch.MBAR(u_kn, N_k, device="cpu")
    g = mbar_solvers.mbar_gradient(torch.from_numpy(u_kn), np.asarray(N_k, float), m.f_k)
    assert float(torch.linalg.norm(g)) < 1e-6
