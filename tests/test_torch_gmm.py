"""The port's batch GMM against the JAX package's: EM from the same
``params0``, Definition-1 scoring, the reg escalation on degenerate data and
the detector's flags when both carry the same fitted state. Everything runs
on the CPU, where the port takes the plain versions of its kernels.

EM is compared at rtol 1e-4 / atol 1e-4: both run float32 EM, but sums over
rows and the Cholesky factorisations are taken in a different order, and
ten iterations compound the rounding.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import detector as jdet  # noqa: E402
from repro.core import gmm as jgmm  # noqa: E402
from repro_torch.core import detector as tdet  # noqa: E402
from repro_torch.core import gmm as tgmm  # noqa: E402
from repro_torch.models.convert import gmm_params_from_numpy  # noqa: E402

CPU = "cpu"


def mixture(N, D, K, seed=0):
    """Well-separated Gaussian clusters: EM on them is well conditioned."""
    rng = np.random.default_rng(seed)
    centers = 6.0 * rng.standard_normal((K, D))
    comp = rng.integers(0, K, N)
    X = centers[comp] + 0.5 * rng.standard_normal((N, D))
    return X.astype(np.float32)


def as_np(params):
    return [np.asarray(p) for p in params]


def jax_params0(X, K, reg):
    return jgmm._init_params(jnp.asarray(X), jax.random.PRNGKey(0), K, reg,
                             None)


@pytest.mark.parametrize("D", [3, 4])
@pytest.mark.parametrize("K", [1, 3, 4])
def test_fit_gmm_matches_jax_from_same_params0(K, D):
    X = mixture(800, D, K, seed=K * 10 + D)
    reg = 1e-2
    p0 = jax_params0(X, K, reg)
    jp, jll = jgmm.fit_gmm(jnp.asarray(X), jax.random.PRNGKey(0),
                           n_components=K, n_iters=10, reg=reg, params0=p0)
    tp, tll = tgmm.fit_gmm(torch.as_tensor(X), 0, n_components=K,
                           n_iters=10, reg=reg,
                           params0=gmm_params_from_numpy(as_np(p0), CPU))
    for name, g, w in zip(tgmm.GMMParams._fields, tp, jp):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    np.testing.assert_allclose(tll.numpy(), np.asarray(jll), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("K", [2, 4])
def test_score_samples_and_total_ll_match_jax(K):
    X = mixture(500, 4, K, seed=K)
    jp, _ = jgmm.fit_gmm(jnp.asarray(X), jax.random.PRNGKey(1),
                         n_components=K, n_iters=20, reg=1e-3)
    tp = gmm_params_from_numpy(as_np(jp), CPU)
    Xq = mixture(300, 4, K, seed=100 + K) * 1.3  # includes outliers
    jb, ja = jgmm.score_samples(jnp.asarray(Xq), jp)
    tb, ta = tgmm.score_samples(torch.as_tensor(Xq), tp)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(
        float(tgmm.total_log_likelihood(torch.as_tensor(Xq), tp)),
        float(jgmm.total_log_likelihood(jnp.asarray(Xq), jp)),
        rtol=1e-5, atol=1e-5)


def test_prec_chol_of_non_pd_cov_is_nan_like_jax():
    """A non-PD covariance gives an all-NaN factor (the reg escalation's
    signal); a PD one gives the reference's factor."""
    cov = np.stack([np.array([[2.0, 0.3], [0.3, 1.0]]),
                    np.array([[1.0, 2.0], [2.0, 1.0]])]).astype(np.float32)
    got = tgmm._prec_chol_from_cov(torch.as_tensor(cov), 0.0).numpy()
    want = np.asarray(jgmm._prec_chol_from_cov(jnp.asarray(cov), 0.0))
    assert np.isnan(got[1]).all() and np.isnan(want[1]).all()
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6)


def test_degenerate_window_escalates_to_finite_ll_in_both():
    """Duplicated rows make the covariance singular: both GMM.fit must
    reach a finite log-likelihood through the reg escalation."""
    rng = np.random.default_rng(3)
    X = np.repeat(rng.standard_normal((3, 3)), 80, axis=0).astype(np.float32)
    j = jgmm.GMM(n_components=3, n_iters=20, seed=0).fit(X)
    t = tgmm.GMM(n_components=3, n_iters=20, seed=0, device=CPU).fit(X)
    assert np.isfinite(j.ll) and np.isfinite(t.ll)
    assert np.isfinite(t.score(X)).all()


def test_cold_fit_recovers_the_clusters():
    """The port's own cold init (numpy-drawn rows, not jax.random) reaches a
    likelihood close to the reference's cold fit on the same data."""
    X = mixture(800, 3, 3, seed=5)
    t = tgmm.GMM(n_components=3, n_iters=60, seed=0, device=CPU).fit(X)
    j = jgmm.GMM(n_components=3, n_iters=60, seed=0).fit(X)
    assert t.params.means.shape == (3, 3)
    assert abs(t.ll - j.ll) < 0.05 * abs(j.ll)


def test_gmm_detector_flags_match_jax_with_same_fitted_state():
    rng = np.random.default_rng(7)
    X = np.concatenate([mixture(900, 3, 3, seed=8),
                        rng.uniform(-8, 8, (60, 3)).astype(np.float32)])
    jd = jdet.GMMDetector(n_components=3).fit(X)
    td = tdet.GMMDetector(n_components=3, device=CPU)
    td.gmm.params = gmm_params_from_numpy(as_np(jd.gmm.params), CPU)
    td.std.mean, td.std.std = jd.std.mean, jd.std.std
    td.log_delta = jd.log_delta
    Xq = np.concatenate([mixture(400, 3, 3, seed=9),
                         rng.uniform(-8, 8, (40, 3)).astype(np.float32)])
    np.testing.assert_allclose(td.score(Xq), jd.score(Xq), rtol=1e-4,
                               atol=1e-3)
    agree = np.mean(td.predict(Xq) == jd.predict(Xq))
    assert agree >= 0.99, agree


def test_gmm_without_a_card_needs_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgmm.GMM()
