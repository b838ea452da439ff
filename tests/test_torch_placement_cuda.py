"""A numpy u_kn placed on the card through pinned staging, against the same
matrix given as a card tensor.

Needs an NVIDIA card (marker ``cuda``); skips without one.  Imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_placement_cuda.py

``MBAR(u, N_k)`` with a numpy ``u`` of ``mbar._STAGED_UPLOAD_BYTES`` or more
uploads it block by block through two pinned buffers
(``mbar_core._upload_whole``); below that gate it goes in one copy.  Whatever the input's dtype,
order or strides, the card tensor is bit-identical to
``torch.as_tensor(np.array(u, np.float64), device="cuda")``, so f_k is the
card tensor's f_k bit for bit.  The caller's array may change as soon as
the placement returns; the card holds the destination alone; and the host
makes no full-size temporary (``tracemalloc`` sees numpy's allocations).
"""

import tracemalloc
import warnings

import numpy as np
import pytest
import torch

import pymbar_tpu_torch
import pymbar_tpu_torch.mbar as tmbar
from pymbar_tpu_torch.ops import mbar_core as tcore
from pymbar_tpu_torch.utils import kln_to_kn

pytestmark = pytest.mark.cuda

K, NPK = 16, 2000
N = K * NPK


@pytest.fixture(scope="module")
def problem():
    """16 oscillators x 2,000 samples (N = 32,000; 4.1 MB), in both layouts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tc = pymbar_tpu_torch.testsystems.HarmonicOscillatorsTestCase(
        O_k=np.linspace(0, 4, K), K_k=np.linspace(1, 3, K))
    _x, u, N_k, _s = tc.sample(N_k=[NPK] * K, mode="u_kn", seed=11)
    _x, u_kln, _N = tc.sample(N_k=[NPK] * K, mode="u_kln", seed=11)
    return u, u_kln, np.asarray(N_k)


def _read_only(u):
    u = u.copy()
    u.flags.writeable = False
    return u


def _strided(u):
    big = np.zeros((u.shape[0], 2 * u.shape[1]))
    big[:, ::2] = u
    return big[:, ::2]


# name -> (the input from (u_kn, u_kln), _CHUNK_BYTES or None for the default)
CASES = {
    "float64": (lambda u, kln: u.copy(), None),
    "float32": (lambda u, kln: u.astype(np.float32), None),
    "fortran": (lambda u, kln: np.asfortranarray(u), None),
    "strided": (lambda u, kln: _strided(u), None),
    "read_only": (lambda u, kln: _read_only(u), None),
    "u_kln": (lambda u, kln: kln.copy(), None),
    "row_longer_than_a_chunk": (lambda u, kln: u.copy(), 8 * 3000),
    "ragged_chunks": (lambda u, kln: u.copy(), 8 * (3 * N + 5)),
    "below_the_staging_gate": (lambda u, kln: u.copy(), None),
}


@pytest.fixture(autouse=True)
def _default_card(monkeypatch):
    monkeypatch.delenv("PYMBAR_TPU_TORCH_DEVICE", raising=False)


def _bits(t):
    return t.contiguous().view(torch.int64)


@pytest.mark.parametrize("case", sorted(CASES))
def test_numpy_placement_is_the_card_tensor_bit_for_bit(case, problem, monkeypatch):
    make, chunk = CASES[case]
    u_kn, u_kln, N_k = problem
    if chunk is not None:
        monkeypatch.setattr(tcore, "_CHUNK_BYTES", chunk)
    staged = case != "below_the_staging_gate"
    if not staged:
        monkeypatch.setattr(tmbar, "_STAGED_UPLOAD_BYTES", 8 * N * K + 8)
    u = make(u_kn, u_kln)
    layout, layout_peak = u, 0
    if u.ndim == 3:
        tracemalloc.start()
        try:
            layout = kln_to_kn(u, N_k=N_k)
            layout_peak = tracemalloc.get_traced_memory()[1]
        finally:
            tracemalloc.stop()
    ref = torch.as_tensor(np.array(layout, np.float64), device="cuda")
    f_ref = pymbar_tpu_torch.MBAR(ref, N_k).f_k

    n0 = tcore.STAGED_UPLOADS
    tracemalloc.start()
    try:
        m = pymbar_tpu_torch.MBAR(u, N_k)
        host_peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert tcore.STAGED_UPLOADS == n0 + staged
    assert m.u_kn.device.type == "cuda" and m.u_kn.dtype == torch.float64
    assert torch.equal(_bits(m.u_kn), _bits(ref))
    assert np.array_equal(m.f_k, f_ref)
    if staged:
        # beyond a u_kln's layout (its own function's peak), no full-size host copy
        assert host_peak < layout_peak + 0.5 * ref.numel() * 8

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a read-only array is read without a warning
        placed = tmbar._u_tensor(u, N_k, None)
    if u.flags.writeable:
        u[...] = 7.0  # the caller's array changes while the last copy may be in flight
    torch.cuda.synchronize()
    # the destination alone, in the allocator's 512-byte blocks
    assert torch.cuda.max_memory_allocated() - base <= -(-ref.numel() * 8 // 512) * 512
    assert tcore.STAGED_UPLOADS == n0 + 2 * staged
    assert torch.equal(_bits(placed), _bits(ref))
