"""The benchmark's input generator: harmonic oscillators made from a seed.

pymbar's harmonic-oscillator test system (``pymbar/testsystems/
harmonic_oscillators.py``, ``HarmonicOscillatorsTestCase``): state k is the
reduced potential u_k(x) = K_f[k] / 2 (x - O[k])**2, and ``samples_per_state``
samples are drawn from each state's Boltzmann distribution, a normal of
mean O[k] and variance 1 / K_f[k].  u_kn holds every state's potential at
every sample, in float64, samples ordered state by state.

The generator is the benchmark's own copy (of ``chip_smoke.oscillators``):
nothing of the program makes or shapes the inputs.  It draws one normal
block from a ``torch.Generator`` on the target device and fills u_kn there
in column chunks, so no full-size temporary exists besides u_kn.
"""

import math

import numpy as np
import torch

__all__ = ["oscillators", "analytic_free_energies"]

# Columns per fill step: chunks of 2**26 float64 elements (512 MB).
_CHUNK_ELEMS = 2**26


def _ladder(config, dtype, device):
    K = int(config["K"])
    O = torch.linspace(*map(float, config["O"]), K, dtype=dtype, device=device)
    Kf = torch.linspace(*map(float, config["K_f"]), K, dtype=dtype, device=device)
    return O, Kf


def oscillators(config, seed, device):
    """(u_kn, N_k) of the configuration, u_kn a (K, N) float64 tensor on
    ``device`` and N_k a list, made from ``seed`` alone.  A configuration of
    another system or dtype raises ValueError."""
    if config.get("system") != "harmonic_oscillators" or config.get("dtype") != "float64":
        raise ValueError(f"configuration {config.get('name')!r}: this generator makes "
                         "float64 harmonic_oscillators only")
    K, npk = int(config["K"]), int(config["samples_per_state"])
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    O, Kf = _ladder(config, torch.float64, device)
    z = torch.randn((K, npk), generator=gen, dtype=torch.float64, device=device)
    x = (O[:, None] + z / torch.sqrt(Kf)[:, None]).reshape(-1)
    del z
    N = K * npk
    u_kn = torch.empty((K, N), dtype=torch.float64, device=device)
    step = max(1, _CHUNK_ELEMS // K)
    for s in range(0, N, step):
        xs = x[None, s : s + step]
        u_kn[:, s : s + step] = 0.5 * Kf[:, None] * (xs - O[:, None]) ** 2
    return u_kn, [npk] * K


def analytic_free_energies(config):
    """f_k - f_0 of the configuration's states: f_k = -ln sqrt(2 pi / K_f[k])."""
    _O, Kf = _ladder(config, torch.float64, "cpu")
    f = np.array([-0.5 * math.log(2.0 * math.pi / float(k)) for k in Kf])
    return f - f[0]
