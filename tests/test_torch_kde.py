"""The port's logsumexp and weighted Gaussian KDE against pymbar_tpu on the CPU.

``pymbar_tpu_torch.ops.logsumexp`` against ``pymbar_tpu.ops.logsumexp`` on
the same numpy inputs (with all-(-inf), +inf and zero-weight columns) to
1e-14 relative; ``pymbar_tpu_torch.kde.GaussianKDE`` against
``pymbar_tpu.kde.GaussianKDE``: ``score_samples`` at D = 1 and 2 (data far
from the origin, weighted, with the port's query chunks forced down to 16
queries) to 1e-12, ``sample(random_state=s)`` to 1e-14, and the parameter
errors.  The port runs with ``device="cpu"``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pymbar_tpu.kde as jkde
from pymbar_tpu.ops.logsumexp import logsumexp as jax_logsumexp
from pymbar_tpu_torch import kde as tkde
from pymbar_tpu_torch.ops.logsumexp import logsumexp
from pymbar_tpu_torch.utils import ParameterError

# one intra-op thread per test process: the suite's workers share the CPUs
torch.set_num_threads(1)


def _same(ours, ref, rtol):
    """Equal non-finite entries (nan, +-inf) and finite ones within rtol."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(ours[~fin & ~np.isnan(ref)], ref[~fin & ~np.isnan(ref)])
    np.testing.assert_allclose(ours[fin], ref[fin], rtol=rtol, atol=0)


def _lse_inputs():
    rng = np.random.default_rng(11)
    a = rng.normal(scale=30.0, size=(6, 9))
    a[:, 1] = -np.inf  # an all-(-inf) column
    a[2, 3] = np.inf  # a +inf entry
    a[4, 5] = -np.inf
    b = rng.random((6, 9))
    b[:, 6] = 0.0  # a zero-weight column
    b[1, 7] = 0.0
    return a, b


@pytest.mark.parametrize("axis", [0, 1, None, (0, 1)])
@pytest.mark.parametrize("keepdims", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_logsumexp_matches_jax(axis, keepdims, weighted):
    a, b = _lse_inputs()
    bb = b if weighted else None
    ref = np.asarray(jax_logsumexp(jnp.asarray(a), axis=axis, b=bb, keepdims=keepdims))
    ours = logsumexp(torch.as_tensor(a), axis=axis, b=bb, keepdims=keepdims)
    assert isinstance(ours, torch.Tensor)
    _same(ours.numpy(), ref, rtol=1e-14)


def test_logsumexp_broadcast_weights_and_zero_terms():
    """A (K, 1) weight broadcast over columns, as the FES log weights use it;
    a zero weight drops its term exactly."""
    a, _ = _lse_inputs()
    a = np.where(np.isfinite(a), a, 0.0)
    b = np.array([1.0, 0.0, 2.0, 3.0, 0.0, 5.0])[:, None]
    ref = np.asarray(jax_logsumexp(jnp.asarray(a), axis=0, b=b))
    _same(logsumexp(torch.as_tensor(a), axis=0, b=b).numpy(), ref, rtol=1e-14)
    keep = b[:, 0] > 0
    direct = logsumexp(torch.as_tensor(a[keep]), axis=0, b=b[keep]).numpy()
    np.testing.assert_allclose(logsumexp(torch.as_tensor(a), axis=0, b=b).numpy(), direct,
                               rtol=1e-15, atol=0)


def _kde_data(D):
    rng = np.random.default_rng(5 + D)
    xs = 1.0e3 + rng.normal(size=(700, D))  # far from the origin: the centring matters
    w = rng.random(700)
    xq = 1.0e3 + rng.normal(size=(150, D)) * 2.0
    return xs, w, xq


@pytest.mark.parametrize("D", [1, 2])
def test_score_samples_matches_jax(D, monkeypatch):
    xs, w, xq = _kde_data(D)
    ref = jkde.GaussianKDE(bandwidth=0.3).fit(xs, sample_weight=w)
    want = ref.score_samples(xq)
    ours = tkde.GaussianKDE(bandwidth=0.3, device="cpu").fit(xs, sample_weight=w)
    assert ours._X.dtype == torch.float64 and ours._X.device.type == "cpu"
    # the port in 10 query chunks of 16; the JAX package in one
    monkeypatch.setattr(tkde, "_PAIRWISE_BUDGET_BYTES", 16 * 16 * xs.shape[0])
    assert tkde._query_chunk(xq.shape[0], xs.shape[0]) == 16
    got = ours.score_samples(xq)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert ours.score(xq) == pytest.approx(ref.score(xq), rel=1e-12)
    assert ours.n_features_in_ == D


@pytest.mark.parametrize("seed", [0, 17])
def test_sample_matches_jax(seed):
    xs, w, _ = _kde_data(2)
    ref = jkde.GaussianKDE(bandwidth=0.5).fit(xs, sample_weight=w).sample(40, random_state=seed)
    ours = tkde.GaussianKDE(bandwidth=0.5, device="cpu").fit(xs, sample_weight=w)
    np.testing.assert_allclose(ours.sample(40, random_state=seed), ref, rtol=1e-14, atol=0)


def test_unweighted_fit_and_params_match_jax():
    xs, _, xq = _kde_data(1)
    ref = jkde.GaussianKDE(bandwidth=0.2).fit(xs[:, 0])
    ours = tkde.GaussianKDE(bandwidth=0.2, device="cpu").fit(xs[:, 0])
    np.testing.assert_allclose(ours.score_samples(xq[:, 0]), ref.score_samples(xq[:, 0]),
                               rtol=1e-12, atol=1e-12)
    assert ours.get_params() == ref.get_params()
    assert "device" not in ours.get_params()


@pytest.mark.parametrize("case", ["unknown_param", "kernel", "negative_weight", "not_fitted"])
def test_errors_match_jax(case):
    def run(mod, **kw):
        if case == "unknown_param":
            mod.GaussianKDE(**kw).set_params(leafsize=3)
        elif case == "kernel":
            mod.GaussianKDE(kernel="tophat", **kw)
        elif case == "negative_weight":
            mod.GaussianKDE(**kw).fit(np.zeros((3, 1)), sample_weight=[1.0, -1.0, 1.0])
        else:
            mod.GaussianKDE(**kw).score_samples(np.zeros((3, 1)))

    with pytest.raises(ValueError) as ref:
        run(jkde)
    with pytest.raises(ValueError) as ours:
        run(tkde, device="cpu")
    assert type(ours.value) is type(ref.value)


def test_fit_places_samples_on_the_card_by_default():
    """No device asked for: the samples go to the CUDA card, and without one
    ``fit`` raises instead of falling back to the CPU."""
    kde = tkde.GaussianKDE(bandwidth=0.3)
    if torch.cuda.is_available():
        assert kde.fit(np.zeros((4, 1)))._X.is_cuda
    else:
        with pytest.raises(ParameterError):
            kde.fit(np.zeros((4, 1)))
