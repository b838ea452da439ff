"""Where pymbar_tpu_torch's public entry points put numpy input, against
pymbar_tpu's placement: the process default device
(``PYMBAR_TPU_TORCH_DEVICE``, :func:`pymbar_tpu_torch.config.target_device`)
and numpy into the solver surface (``mbar_solvers``, ``ops.mbar_core``,
``ops.logsumexp``).

The JAX package puts numpy on its default device (``jnp.asarray``); the
port puts it on the card unless ``device=`` or the variable names another
device, and raises without a card.  Tests here hide any card
(``torch.cuda.is_available`` patched to False), so they run alike with and
without one.
"""

import numpy as np
import pytest
import torch

import pymbar_tpu.mbar_solvers as jms
import pymbar_tpu.ops.mbar_core as jcore
import pymbar_tpu_torch
from pymbar_tpu.ops.logsumexp import logsumexp as jlogsumexp
from pymbar_tpu_torch import config
from pymbar_tpu_torch import mbar_solvers as tms
from pymbar_tpu_torch.ops import mbar_core as tcore
from pymbar_tpu_torch.ops.logsumexp import logsumexp as tlogsumexp
from pymbar_tpu_torch.parallel import sharding
from pymbar_tpu_torch.solvers_large import split_u_kn_streamed
from pymbar_tpu_torch.utils import ParameterError

# one intra-op thread per test process: the suite's workers share the CPUs
torch.set_num_threads(1)

VAR = "PYMBAR_TPU_TORCH_DEVICE"

_rng = np.random.default_rng(13)
U = _rng.normal(size=(4, 120)) ** 2
N_K = np.array([40.0, 30.0, 0.0, 50.0])
F_K = np.array([0.0, 0.2, -0.1, 0.3])
SWS = np.array([0, 1, 3])
U_S = np.ascontiguousarray(U[SWS])
N_S = N_K[SWS]
F_S = F_K[SWS]
PROTOCOL = (dict(method="adaptive", options=dict(min_sc_iter=0)),)


def _calls(mod_solvers, mod_core, logsumexp):
    """name -> (function, args, kwargs) of every entry point that takes a
    numpy u_kn, for one package."""
    return {
        "self_consistent_update": (mod_solvers.self_consistent_update, (U, N_K, F_K), {}),
        "mbar_gradient": (mod_solvers.mbar_gradient, (U_S, N_S, F_S), {}),
        "mbar_objective": (mod_solvers.mbar_objective, (U_S, N_S, F_S), {}),
        "mbar_objective_and_gradient": (mod_solvers.mbar_objective_and_gradient,
                                        (U_S, N_S, F_S), {}),
        "mbar_hessian": (mod_solvers.mbar_hessian, (U_S, N_S, F_S), {}),
        "mbar_log_W_nk": (mod_solvers.mbar_log_W_nk, (U, N_K, F_K), {}),
        "mbar_W_nk": (mod_solvers.mbar_W_nk, (U, N_K, F_K), {}),
        "precondition_u_kn": (mod_solvers.precondition_u_kn, (U_S, N_S, F_S), {}),
        "log_denominator_n": (mod_core.log_denominator_n, (U, N_K, F_K), {}),
        "core_stats": (mod_core.core_stats, (U_S, N_S, F_S), {}),
        "mbar_w_nk_gram": (mod_core.mbar_w_nk_gram, (U, N_K, F_K), {}),
        "mbar_gram_normalization": (mod_core.mbar_gram_normalization, (U, N_K, F_K), {}),
        "adaptive": (mod_solvers.adaptive, (U_S, N_S, F_S), {"tol": 1e-12}),
        "anderson": (mod_solvers.anderson, (U_S, N_S, F_S), {"tol": 1e-12}),
        "solve_mbar_once": (mod_solvers.solve_mbar_once, (U_S, N_S, F_S), {}),
        "solve_mbar": (mod_solvers.solve_mbar, (U_S, N_S, F_S), {"solver_protocol": PROTOCOL}),
        "solve_mbar_for_all_states": (mod_solvers.solve_mbar_for_all_states,
                                      (U, N_K, F_K, SWS, PROTOCOL), {}),
        "logsumexp": (logsumexp, (-U,), {"axis": 0, "b": N_K[:, None]}),
    }


PORT = _calls(tms, tcore, tlogsumexp)
JAX = _calls(jms, jcore, jlogsumexp)
# the port's entry points that also take ``device=``
WITH_DEVICE = ("self_consistent_update", "mbar_gradient", "mbar_log_W_nk", "core_stats",
               "mbar_gram_normalization", "solve_mbar_once", "solve_mbar")
_JAX_CACHE = {}


@pytest.fixture(autouse=True)
def _no_card(monkeypatch):
    """No card visible and the variable unset, whatever the machine."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv(VAR, raising=False)


def _values(out):
    """The arrays of a result, in order: a dict gives its "x", a tuple or
    list each item's (a solver's result dicts are skipped)."""
    if isinstance(out, dict):
        return _values(out["x"])
    if isinstance(out, (tuple, list)):
        return [v for item in out if not isinstance(item, (dict, list)) for v in _values(item)]
    if torch.is_tensor(out):
        return [out.detach().cpu().numpy()]
    return [np.asarray(out)]


def _jax(name):
    if name not in _JAX_CACHE:
        fn, args, kw = JAX[name]
        _JAX_CACHE[name] = _values(fn(*args, **kw))
    return _JAX_CACHE[name]


def _assert_matches_jax(name, out):
    ours, ref = _values(out), _jax(name)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
        assert a.shape == b.shape
        scale = np.maximum(np.abs(b), 1.0)
        assert np.all(np.isnan(a) == np.isnan(b))
        assert np.nanmax(np.abs(a - b) / scale, initial=0.0) <= 1e-10, name


def _devices(out):
    return {v.device.type for v in (out if isinstance(out, tuple) else (out,))
            if torch.is_tensor(v)}


@pytest.mark.parametrize("name", sorted(PORT))
def test_numpy_without_a_card_raises(name):
    """Numpy into a public entry point with no device named and no card:
    ParameterError, as ``MBAR(u_np, N_k)`` gives, never a CPU run."""
    fn, args, kw = PORT[name]
    with pytest.raises(ParameterError, match="no CUDA device"):
        fn(*args, **kw)


@pytest.mark.parametrize("name", sorted(PORT))
def test_numpy_under_default_cpu_matches_jax(name, monkeypatch):
    """With PYMBAR_TPU_TORCH_DEVICE=cpu the same call runs on the CPU and
    returns pymbar_tpu's numbers (1e-10, relative above 1)."""
    monkeypatch.setenv(VAR, "cpu")
    fn, args, kw = PORT[name]
    out = fn(*args, **kw)
    assert _devices(out) <= {"cpu"}
    _assert_matches_jax(name, out)


@pytest.mark.parametrize("name", WITH_DEVICE)
def test_numpy_with_device_cpu_matches_jax(name):
    """``device="cpu"`` asks for the CPU without the variable."""
    fn, args, kw = PORT[name]
    _assert_matches_jax(name, fn(*args, **kw, device="cpu"))


@pytest.mark.parametrize("name", WITH_DEVICE)
def test_explicit_device_beats_the_variable(name, monkeypatch):
    """``device=`` wins over the variable both ways: "cpu" runs under a
    CUDA default, "cuda" raises under a CPU default (no card)."""
    fn, args, kw = PORT[name]
    monkeypatch.setenv(VAR, "cuda")
    _assert_matches_jax(name, fn(*args, **kw, device="cpu"))
    monkeypatch.setenv(VAR, "cpu")
    with pytest.raises(ParameterError, match="no CUDA device"):
        fn(*args, **kw, device="cuda")


@pytest.mark.parametrize("name", ["mbar_gradient", "solve_mbar", "logsumexp"])
def test_a_tensor_keeps_its_device(name, monkeypatch):
    """A CPU tensor runs where it lies, with no device named and no card,
    under any value of the variable."""
    fn, args, kw = PORT[name]
    targs = (torch.from_numpy(args[0]),) + args[1:]
    for value in (None, "cuda", "cpu"):
        if value is None:
            monkeypatch.delenv(VAR, raising=False)
        else:
            monkeypatch.setenv(VAR, value)
        _assert_matches_jax(name, fn(*targs, **kw))


@pytest.mark.parametrize("value", ["gpu0", "cuda:x", "not a device"])
def test_unparsable_value_raises_naming_the_variable(value, monkeypatch):
    monkeypatch.setenv(VAR, value)
    with pytest.raises(ParameterError, match=VAR):
        config.target_device()
    with pytest.raises(ParameterError, match=VAR):
        tms.mbar_gradient(U_S, N_S, F_S)


@pytest.mark.parametrize("value", ["cuda", "cuda:1"])
def test_a_cuda_default_without_a_card_raises(value, monkeypatch):
    monkeypatch.setenv(VAR, value)
    with pytest.raises(ParameterError, match="no CUDA device"):
        pymbar_tpu_torch.MBAR(U, N_K)


@pytest.mark.parametrize("value, expected", [("", None), ("  ", None), ("cpu", "cpu"),
                                             ("cuda:1", "cuda:1"), ("meta", "meta")])
def test_default_device_is_read_at_each_call(value, expected, monkeypatch):
    monkeypatch.setenv(VAR, value)
    got = config.default_device()
    assert (got if got is None else str(got)) == expected


def test_default_cpu_places_mbar_and_fes(monkeypatch):
    """Under "cpu", ``MBAR`` and ``FES`` take numpy onto the CPU with no
    ``device=`` and give ``device="cpu"``'s f_k bit for bit."""
    monkeypatch.setenv(VAR, "cpu")
    N_all = np.array([40, 30, 0, 50])
    m = pymbar_tpu_torch.MBAR(U, N_all)
    assert m.device.type == "cpu" and m.u_kn.device.type == "cpu"
    np.testing.assert_array_equal(m.f_k, pymbar_tpu_torch.MBAR(U, N_all, device="cpu").f_k)
    fes = pymbar_tpu_torch.FES(U, N_all)
    assert fes.u_kn.device.type == "cpu"
    np.testing.assert_array_equal(fes.mbar.f_k, m.f_k)


def test_default_mesh_follows_the_default(monkeypatch):
    """``default_mesh()`` under "cpu" is one CPU shard, as
    ``default_mesh(device="cpu")``; ``mesh_2d`` puts every block there."""
    monkeypatch.setenv(VAR, "cpu")
    assert sharding.default_mesh() == sharding.default_mesh(device="cpu")
    assert sharding.default_mesh().devices == (torch.device("cpu"),)
    assert sharding.default_mesh(3).devices == (torch.device("cpu"),) * 3
    assert sharding.mesh_2d(2, 2).devices == ((torch.device("cpu"),) * 2,) * 2
    monkeypatch.setenv(VAR, "cuda")
    with pytest.raises(ParameterError, match="no CUDA device"):
        sharding.default_mesh()
    monkeypatch.delenv(VAR)
    with pytest.raises(ParameterError, match="no CUDA device"):
        sharding.default_mesh()


def test_host_side_functions_keep_numpy_on_the_host():
    """Where the JAX package keeps numpy on the host, so does the port, with
    no card and no device named: ``validate_inputs`` and the streamed
    split."""
    u, N_k, f_k = tms.validate_inputs(U, N_K, F_K)
    ju, jN, jf = jms.validate_inputs(U, N_K, F_K)
    assert u.device.type == "cpu" and isinstance(ju, np.ndarray)
    np.testing.assert_array_equal(u.numpy(), ju)
    np.testing.assert_array_equal(N_k, jN)
    hi, lo = split_u_kn_streamed(U)
    assert hi.device.type == lo.device.type == "cpu"
    # two float32 words hold 48 of the 53 bits
    np.testing.assert_allclose(hi.numpy().astype(np.float64) + lo.numpy(), U, rtol=1e-13)
