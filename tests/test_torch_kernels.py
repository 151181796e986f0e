"""The port's GMM kernels against the JAX package's: the plain PyTorch
versions against `repro.kernels.ref` and the Pallas kernels in interpret
mode, on the same numpy inputs and the kernel tests' shape grids; the
dispatch. The CUDA kernels against the plain versions are in
tests/test_torch_cuda.py, which needs a card and no JAX.

Tolerances are those of tests/test_kernels.py: float32 rtol 1e-5 / atol
1e-4 (float32 arithmetic in a different summation order), bf16 X rtol 5e-2
/ atol 5e-1; argmax may differ only at near-ties. The E-step statistics
(sums over all rows) are held at rtol 1e-4 / atol 1e-4 x max(|want|, 1),
that file's `_assert_tuple_close`.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.gmm_score import gmm_best_pallas, gmm_score_pallas  # noqa: E402
from repro.kernels.gmm_stats import gmm_stats_pallas, gmm_update_pallas  # noqa: E402
from repro_torch.kernels import gmm_score as kmod  # noqa: E402
from repro_torch.kernels import gmm_stats as smod  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch import quickstart  # noqa: E402
from repro_torch.core.features import (COLLECTIVE_FEATURES,  # noqa: E402
                                       DEVICE_FEATURES, LATENCY_FEATURES)

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


# -- E-step statistics and the fused EM iteration ---------------------------

# tests/test_kernels.py's grids: K=1 and non-power-of-two N included
UPDATE_SHAPES = [(256, 2, 2), (1000, 4, 3), (777, 3, 5), (512, 8, 1),
                 (64, 5, 1)]
# the bucket shapes the detection plane launches, with nvalid fractions
BUCKETS = [(256, 4, 3), (512, 8, 1), (1024, 2, 4)]
STATS_NAMES = {"stats": ["nk", "sx", "sxx", "ll"],
               "update": ["nk", "means", "cov", "ll"]}


def log_w(K):
    return np.log(np.full((K,), 1.0 / K, dtype=np.float32))


def assert_tuple_close(got, want, names, rtol=1e-4, atol=1e-4):
    for g, w, name in zip(got, want, names):
        w = np.asarray(w)
        scale = max(float(np.max(np.abs(w))) if w.size else 0.0, 1.0)
        np.testing.assert_allclose(np.asarray(g), w, rtol=rtol,
                                   atol=atol * scale, err_msg=name)


def jax_stats(op, X, lw, means, U, nvalid, oracle):
    Xj = jnp.asarray(X)
    if oracle == "jnp":
        fn = jref.gmm_stats_ref if op == "stats" else jref.gmm_update_ref
        return fn(Xj, jnp.asarray(lw), means, U, nvalid)
    fn = gmm_stats_pallas if op == "stats" else gmm_update_pallas
    return fn(Xj, jnp.asarray(lw), means, U, nvalid=nvalid, block_n=128,
              interpret=True)


def torch_stats(op, X, lw, means, U, nvalid=None):
    fn = ref.gmm_stats_ref if op == "stats" else ref.gmm_update_ref
    return [o.numpy() for o in fn(t(X), t(lw), t(means), t(U), nvalid)]


@pytest.mark.parametrize("oracle", ["jnp", "pallas"])
@pytest.mark.parametrize("N,D,K", SHAPES[:5])
def test_gmm_stats_ref_matches_jax(N, D, K, oracle):
    X, means, U = make_params(N, D, K, seed=2)
    got = torch_stats("stats", X, log_w(K), means, U)
    assert_tuple_close(got, jax_stats("stats", X, log_w(K), means, U, None,
                                      oracle), STATS_NAMES["stats"])


@pytest.mark.parametrize("oracle", ["jnp", "pallas"])
@pytest.mark.parametrize("N,D,K", UPDATE_SHAPES)
def test_gmm_update_ref_matches_jax(N, D, K, oracle):
    """One EM iteration in one pass: (nk, means', cov', ll)."""
    X, means, U = make_params(N, D, K, seed=4)
    got = torch_stats("update", X, log_w(K), means, U)
    assert_tuple_close(got, jax_stats("update", X, log_w(K), means, U, None,
                                      oracle), STATS_NAMES["update"])


@pytest.mark.parametrize("op", ["stats", "update"])
@pytest.mark.parametrize("frac", [1.0, 0.61, 0.25])
@pytest.mark.parametrize("N,D,K", BUCKETS)
def test_nvalid_masks_poisoned_padding_like_pallas(N, D, K, frac, op):
    """A padded call with the true row count as nvalid equals the Pallas
    kernel's padded call and the oracle on the true rows alone; the padding
    rows are poisoned to 1e6, so any leak through the mask shows."""
    nvalid = max(int(N * frac), 1)
    X, means, U = make_params(N, D, K, seed=5)
    X[nvalid:] = 1e6
    got = torch_stats(op, X, log_w(K), means, U, nvalid)
    names = STATS_NAMES[op]
    assert_tuple_close(got, jax_stats(op, X, log_w(K), means, U, nvalid,
                                      "pallas"), names)
    assert_tuple_close(got, jax_stats(op, X[:nvalid], log_w(K), means, U,
                                      None, "jnp"), names)


@pytest.mark.parametrize("op", ["stats", "update"])
def test_nvalid_zero_and_empty_give_zeros(op):
    """nvalid=0 (an empty window padded to a bucket) and N=0 contribute
    nothing; update's regularised M-step keeps means and cov finite (0)."""
    X, means, U = make_params(256, 4, 3, seed=6)
    for Xi, nvalid in ((X, 0), (X[:0], None)):
        got = torch_stats(op, Xi, log_w(3), means, U, nvalid)
        for o in got:
            np.testing.assert_array_equal(o, 0.0)
    want = jax_stats(op, X, log_w(3), means, U, 0, "pallas")
    assert_tuple_close(torch_stats(op, X, log_w(3), means, U, 0), want,
                       STATS_NAMES[op])


@pytest.mark.parametrize("poison", ["nan_u", "nan_rows"])
@pytest.mark.parametrize("op", ["stats", "update"])
@pytest.mark.parametrize("N,D,K", [(256, 4, 3), (300, 6, 5)])
def test_nvalid_zero_with_non_finite_input_is_nan_like_pallas(N, D, K, op,
                                                              poison):
    """nvalid=0 with an all-NaN U, or NaN padding rows: the reference
    kernel masks responsibilities by multiplying by 0, so nk, sx and sxx are
    NaN, and selects its norms away, so ll is 0. The plain version (and the
    CUDA kernels, which read every row at nvalid=0) give NaN in exactly the
    same entries and the same ll. Exact: NaN masks equal, no tolerance."""
    X, means, U = make_params(N, D, K, seed=9)
    if poison == "nan_u":
        U[:] = np.nan
    else:
        X[:] = np.nan
    got = torch_stats(op, X, log_w(K), means, U, 0)
    want = jax_stats(op, X, log_w(K), means, U, 0, "pallas")
    for g, w, name in zip(got, want, STATS_NAMES[op]):
        w = np.asarray(w)
        if name == "ll":
            np.testing.assert_array_equal(g, w, err_msg=name)
            continue
        assert np.isnan(w).all(), name
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w),
                                      err_msg=name)


def test_gmm_stats_bf16_x_matches_pallas():
    X, means, U = make_params(512, 6, 4, seed=8)
    Xj = jnp.asarray(X).astype("bfloat16")
    want = gmm_stats_pallas(Xj, jnp.asarray(log_w(4)), means, U,
                            block_n=128, interpret=True)
    got = ref.gmm_stats_ref(t(X).to(torch.bfloat16), t(log_w(4)), t(means),
                            t(U))
    assert_tuple_close([g.numpy() for g in got], want, STATS_NAMES["stats"])


def test_ops_stats_dispatch_matches_plain_on_cpu():
    """CPU tensors take the plain versions through ops, with nvalid."""
    X, means, U = make_params(512, 6, 4, seed=7)
    args = (t(X), t(log_w(4)), t(means), t(U))
    before_ref, before_k = dict(ref.CALLS), dict(smod.LAUNCHES)
    got = ops.gmm_update(*args, nvalid=300)
    want = ref.gmm_update_ref(*args, 300)
    ops.gmm_stats(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert ref.CALLS["gmm_update_ref"] == before_ref["gmm_update_ref"] + 2
    assert ref.CALLS["gmm_stats_ref"] == before_ref["gmm_stats_ref"] + 1
    assert smod.LAUNCHES == before_k


@pytest.mark.parametrize("fn", [smod.gmm_stats_cuda, smod.gmm_update_cuda])
def test_stats_cuda_wrappers_refuse_cpu_tensors(fn):
    X, means, U = make_params(16, 2, 2)
    with pytest.raises(ValueError, match="CUDA kernel"):
        fn(t(X), t(log_w(2)), t(means), t(U))


def test_stats_grid_depends_on_the_shape_alone():
    """The grid (hence the order of every sum) is fixed by (N, D, K): one
    block per 256-row tile, at most 264 (two on each of the H100's 132
    SMs), and few enough that the partials stay under the workspace limit;
    an empty input still gets one block."""
    assert smod.MAX_BLOCKS == 264
    assert smod.grid_blocks(0, 4, 3) == 1
    assert smod.grid_blocks(2048, 4, 3) == 8
    assert smod.grid_blocks(65536, 4, 3) == 256
    assert smod.grid_blocks(1 << 20, 4, 3) == 264
    e = smod.n_entries(32, 16)
    assert e == 16 + 16 * 32 + 16 * 32 * 32 + 1
    assert smod.grid_blocks(1 << 20, 32, 16) == smod.WORK_FLOATS // e == 247


# the feature widths the two paths fit (latency 3, device and collective 4)
# and every component count their detectors can pick (min(3, rows // 32))
PATH_SHAPES = [(D, K) for D in sorted({len(LATENCY_FEATURES),
                                       len(COLLECTIVE_FEATURES),
                                       len(DEVICE_FEATURES)})
               for K in range(1, quickstart.N_COMPONENTS + 1)]


@pytest.mark.parametrize("D,K", PATH_SHAPES)
def test_specialised_shapes_cover_the_paths(D, K):
    """Every (D, K) that the main path and the stream path fit and score
    launches the kernels specialised on it, never the general ones."""
    assert (D, K) in kmod.SPECIALISED
    assert kmod.variant(D, K) == "specialised"


def test_specialised_list_matches_the_cuda_sources():
    """The wrappers' list is the sources' GMM_FIXED_SHAPES, and both sources
    dispatch through it: a specialised call the launcher has no kernel for
    would be refused (cudaErrorInvalidValue), never rerouted."""
    csrc = Path(kmod.__file__).parent / "csrc"
    header = (csrc / "gmm_common.cuh").read_text()
    body = header[header.index("#define GMM_FIXED_SHAPES(S)"):]
    body = body[:body.index("\n\n")]
    pairs = {(int(d), int(k))
             for d, k in re.findall(r"S\((\d+),\s*(\d+)\)", body)}
    assert pairs == set(kmod.SPECIALISED)
    for source in (kmod.SOURCE, smod.SOURCE):
        text = (csrc / source).read_text()
        assert '#include "gmm_common.cuh"' in text
        assert "GMM_FIXED_SHAPES(GMM_CASE)" in text


@pytest.mark.parametrize("D,K,want", [
    (2, 1, "specialised"), (4, 4, "specialised"), (3, 3, "specialised"),
    (1, 3, "general"), (5, 4, "general"), (4, 5, "general"),
    (32, 16, "general")])
def test_variant_boundary(D, K, want):
    assert kmod.variant(D, K) == want


@pytest.mark.parametrize("N,D,K", [(0, 4, 3), (1, 2, 1), (227, 4, 3),
                                   (2048, 3, 3), (67584, 4, 4),
                                   (1 << 20, 4, 3), (3000, 32, 16),
                                   (1 << 20, 32, 16)])
def test_grid_is_a_function_of_the_shape_alone(N, D, K, monkeypatch):
    """grid_blocks under the new cap: the same formula at every shape, at
    most MAX_BLOCKS blocks, partials within WORK_FLOATS, and no question
    to the device (a card of another size gets the same grid)."""
    def no_device(*args, **kwargs):
        raise AssertionError("grid_blocks asked the device")

    for name in ("get_device_properties", "device_count",
                 "get_device_capability"):
        monkeypatch.setattr(torch.cuda, name, no_device)
    nb = smod.grid_blocks(N, D, K)
    e = smod.n_entries(D, K)
    assert nb == max(1, min(-(-N // 256), 264, smod.WORK_FLOATS // e))
    assert 1 <= nb <= smod.MAX_BLOCKS and nb * e <= smod.WORK_FLOATS
    assert nb == smod.grid_blocks(N, D, K)


def test_param_views_keep_the_callers_layout():
    """The EM loop's U may be a transposed view (`_prec_chol_from_cov`
    returns L^-T): the wrappers hand it to the kernel as it is, strides and
    all, where the old wrapper copied it on every call."""
    g = torch.Generator().manual_seed(0)
    U = torch.randn((3, 4, 4), generator=g).transpose(-1, -2)
    means = torch.randn((3, 4), generator=g)
    assert not U.is_contiguous()
    mv, Uv = kmod.param_views(means, U)
    assert Uv.data_ptr() == U.data_ptr() and Uv.stride() == U.stride()
    assert mv.data_ptr() == means.data_ptr()
    assert kmod.param_args(mv, Uv) == [means.data_ptr(), 4, 1,
                                       U.data_ptr(), 16, 1, 4]
    _, U32 = kmod.param_views(means, U.double())
    assert U32.dtype == torch.float32 and torch.equal(U32, U)


def test_library_name_follows_the_shared_header(tmp_path, monkeypatch):
    """Both sources include csrc/gmm_common.cuh: an edited header must give
    a new library name, so a stale build is never loaded."""
    from repro_torch.kernels import build

    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = build.library_path("k.cu")
    (tmp_path / "common.cuh").write_text("// two\n")
    after = build.library_path("k.cu")
    assert before != after and after.name.startswith("libk-")
    assert build.library_path("k.cu") == after
