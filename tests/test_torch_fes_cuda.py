"""FES on the card against the same calls on the CPU.

Needs an NVIDIA card (marker ``cuda``); skips without one.  Imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_fes_cuda.py

Umbrella sampling (7 windows x 2000 samples, made from a seed with numpy)
through ``FES(..., device="cuda")`` and ``FES(..., device="cpu")``: the
analytical histogram on both Theta branches (``_AUG_STREAM_BYTES`` = 0:
the streamed augmented Gram, on the card by the rank-nnz form; 2**62: the
materialized weights) with f_i within 1e-9 and df_i, df_ij within 1e-8;
the KDE within 1e-9; and the bootstrap replicates of an FES whose MBAR
took the dd route, on the card: the counts route's f_k against the
per-replicate route's within 1e-8.
"""

import numpy as np
import pytest
import torch

import pymbar_tpu_torch
import pymbar_tpu_torch.mbar as tmbar

pytestmark = pytest.mark.cuda

K0, KU = 20.0, 100.0
CENTERS = 0.2 * np.arange(-3, 4)
EDGES = np.linspace(-0.7, 0.7, 21)
CENT = 0.5 * (EDGES[1:] + EDGES[:-1])


def _close(ours, ref, tol):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=tol)


@pytest.fixture(scope="module")
def pair():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(5)
    sigma = 1.0 / (K0 + KU)
    x = (sigma * KU * CENTERS[:, None]
         + np.sqrt(sigma) * rng.standard_normal((CENTERS.size, 2000))).reshape(-1)
    u_n = K0 / 2 * x**2
    u_kn = u_n[None, :] + KU / 2 * (x[None, :] - CENTERS[:, None]) ** 2
    N_k = np.full(CENTERS.size, 2000)
    card = pymbar_tpu_torch.FES(u_kn, N_k, device="cuda")
    cpu = pymbar_tpu_torch.FES(u_kn, N_k, device="cpu")
    assert card.u_kn.is_cuda and card.mbar.u_kn.data_ptr() == card.u_kn.data_ptr()
    np.testing.assert_allclose(card.mbar.f_k, cpu.mbar.f_k, rtol=0, atol=1e-10)
    return u_kn, u_n, x, N_k, card, cpu


@pytest.mark.parametrize("gate", [0, 2**62], ids=["streamed", "materialized"])
@pytest.mark.parametrize("reference_point", ["from-lowest", "all-differences"])
def test_histogram_on_the_card_matches_cpu(pair, monkeypatch, gate, reference_point):
    _u_kn, u_n, x, _N_k, card, cpu = pair
    monkeypatch.setattr(tmbar, "_AUG_STREAM_BYTES", gate)
    out = []
    for fes in (card, cpu):
        fes.generate_fes(u_n, x, histogram_parameters={"bin_edges": EDGES})
        out.append(fes.get_fes(CENT, reference_point=reference_point,
                               uncertainty_method="analytical"))
    _close(out[0]["f_i"], out[1]["f_i"], 1e-9)
    for key in ("df_i", "df_ij"):
        if key in out[1]:
            _close(out[0][key], out[1][key], 1e-8)


def test_kde_on_the_card_matches_cpu(pair):
    _u_kn, u_n, x, _N_k, card, cpu = pair
    out = []
    for fes in (card, cpu):
        fes.generate_fes(u_n, x, fes_type="kde", kde_parameters={"bandwidth": 0.03})
        out.append(fes.get_fes(CENT, reference_point="from-lowest")["f_i"])
    assert card.get_kde()._X.is_cuda
    _close(out[0], out[1], 1e-9)


def test_counts_route_matches_replicate_route_on_the_card(pair):
    u_kn, u_n, x, N_k, _card, _cpu = pair
    fes = pymbar_tpu_torch.FES(u_kn, N_k, device="cuda",
                               mbar_options=dict(solver_protocol=(dict(method="dd"),)))
    fes.generate_fes(u_n, x, histogram_parameters={"bin_edges": EDGES}, n_bootstraps=4, seed=3)
    assert fes.bootstrap_route == "counts"
    f_replicate, n_fail = fes._replicate_free_energies(fes.bootstrap_indices, "replicate")
    assert n_fail == 0
    _close(fes.f_k_boots, f_replicate, 1e-8)
    res = fes.get_fes(CENT, reference_point="from-lowest", uncertainty_method="bootstrap")
    assert np.all(np.isfinite(res["df_i"][np.isfinite(res["f_i"])]))
