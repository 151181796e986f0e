"""The port's GMM kernels against the JAX package's: the plain PyTorch
versions against `repro.kernels.ref` and the Pallas kernels in interpret
mode, on the same numpy inputs and the kernel tests' shape grid; the
dispatch. The CUDA kernels against the plain versions are in
tests/test_torch_cuda.py, which needs a card and no JAX.

Tolerances are those of tests/test_kernels.py: float32 rtol 1e-5 / atol
1e-4 (float32 arithmetic in a different summation order), bf16 X rtol 5e-2
/ atol 5e-1; argmax may differ only at near-ties.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.gmm_score import gmm_best_pallas, gmm_score_pallas  # noqa: E402
from repro_torch.kernels import gmm_score as kmod  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

SHAPES = [(128, 2, 2), (1000, 4, 3), (4096, 8, 8), (777, 3, 5),
          (2048, 16, 4), (513, 8, 16), (64, 32, 2)]


def make_params(N, D, K, seed=0):
    """numpy inputs shaped like tests/test_kernels.py's make_params."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, D)).astype(np.float32)
    means = rng.standard_normal((K, D)).astype(np.float32)
    A = 0.3 * rng.standard_normal((K, D, D))
    cov = A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(D)
    L = np.linalg.cholesky(cov)
    U = np.swapaxes(np.linalg.inv(L), -1, -2).astype(np.float32)
    return X, means, U


def jax_score(X, means, U, oracle):
    if oracle == "jnp":
        return np.asarray(jref.gmm_score_ref(jnp.asarray(X), means, U))
    return np.asarray(gmm_score_pallas(jnp.asarray(X), means, U, block_n=128,
                                       interpret=True))


def jax_best(X, means, U, oracle):
    if oracle == "jnp":
        b, a = jref.gmm_best_ref(jnp.asarray(X), means, U)
    else:
        b, a = gmm_best_pallas(jnp.asarray(X), means, U, block_n=128,
                               interpret=True)
    return np.asarray(b), np.asarray(a)


def t(a):
    return torch.as_tensor(a)


def assert_arg_close(got, want, log_p):
    """argmax may differ only where the top two densities nearly tie."""
    mism = got != want
    if mism.any():
        top2 = np.sort(log_p[mism], axis=1)[:, -2:]
        assert np.allclose(top2[:, 0], top2[:, 1], atol=1e-3)


@pytest.mark.parametrize("oracle", ["jnp", "pallas"])
@pytest.mark.parametrize("N,D,K", SHAPES)
def test_gmm_score_ref_matches_jax(N, D, K, oracle):
    X, means, U = make_params(N, D, K)
    got = ref.gmm_score_ref(t(X), t(means), t(U)).numpy()
    np.testing.assert_allclose(got, jax_score(X, means, U, oracle),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("oracle", ["jnp", "pallas"])
@pytest.mark.parametrize("N,D,K", SHAPES)
def test_gmm_best_ref_matches_jax(N, D, K, oracle):
    X, means, U = make_params(N, D, K, seed=1)
    gb, ga = ref.gmm_best_ref(t(X), t(means), t(U))
    wb, wa = jax_best(X, means, U, oracle)
    np.testing.assert_allclose(gb.numpy(), wb, rtol=1e-5, atol=1e-4)
    assert ga.dtype == torch.int32
    assert_arg_close(ga.numpy(), wa, jax_score(X, means, U, "jnp"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_score_dtypes_match_pallas(dtype):
    X, means, U = make_params(512, 6, 4)
    Xj = jnp.asarray(X).astype(dtype)
    Xt = t(X).to(getattr(torch, dtype))
    want = np.asarray(gmm_score_pallas(Xj, means, U, block_n=256,
                                       interpret=True))
    got = ref.gmm_score_ref(Xt, t(means), t(U)).numpy()
    tol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * 10)


@pytest.mark.parametrize("fn", ["gmm_score", "gmm_best"])
def test_empty_rows_give_empty_outputs(fn):
    """N = 0 (a layer's empty window): empty outputs of the right shape."""
    _, means, U = make_params(8, 4, 3)
    X = torch.zeros((0, 4))
    out = getattr(ops, fn)(X, t(means), t(U))
    if fn == "gmm_score":
        assert out.shape == (0, 3) and out.dtype == torch.float32
    else:
        assert out[0].shape == (0,) and out[1].shape == (0,)
        assert out[1].dtype == torch.int32


def test_ties_take_first_index_and_nan_wins_like_jnp():
    """Definition-1 argmax semantics that GMM.fit relies on: exact ties go
    to the first component, a NaN density wins (jnp.max / jnp.argmax)."""
    X, means, U = make_params(300, 4, 3, seed=3)
    means[1], U[1] = means[0], U[0]
    gb, ga = ref.gmm_best_ref(t(X), t(means), t(U))
    wb, wa = jax_best(X, means, U, "jnp")
    assert not (ga.numpy() == 1).any()
    np.testing.assert_array_equal(ga.numpy(), wa)
    U[2, 0, 0] = np.nan
    gb, ga = ref.gmm_best_ref(t(X), t(means), t(U))
    wb, wa = jax_best(X, means, U, "jnp")
    assert np.isnan(gb.numpy()).all() and np.isnan(wb).all()
    np.testing.assert_array_equal(ga.numpy(), wa)


def test_cpu_tensors_take_the_plain_versions():
    X, means, U = make_params(64, 4, 2)
    before_ref, before_k = dict(ref.CALLS), dict(kmod.LAUNCHES)
    ops.gmm_score(t(X), t(means), t(U))
    ops.gmm_best(t(X), t(means), t(U))
    assert ref.CALLS["gmm_score_ref"] == before_ref["gmm_score_ref"] + 1
    assert ref.CALLS["gmm_best_ref"] == before_ref["gmm_best_ref"] + 1
    assert kmod.LAUNCHES == before_k


def test_dispatch_rejects_unknown_backend():
    X, means, U = make_params(16, 2, 2)
    with pytest.raises(ValueError, match="unknown backend"):
        ops.gmm_score(t(X), t(means), t(U), backend="pallas")


@pytest.mark.parametrize("fn", [kmod.gmm_score_cuda, kmod.gmm_best_cuda])
def test_cuda_wrappers_refuse_cpu_tensors(fn):
    """A kernel wrapper launches or raises; it never computes on the CPU."""
    X, means, U = make_params(16, 2, 2)
    with pytest.raises(ValueError, match="CUDA kernel"):
        fn(t(X), t(means), t(U))
