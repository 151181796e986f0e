"""The port on the card: the CUDA kernels against their plain versions
(the EM kernels with poisoned padding rows, and bitwise repeatable), the
wrappers' input checks, the CUDA-graphed train step against the eager one, a
GMM fit and a streaming detector's warmup and tick on the card against the
same on the CPU.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither JAX nor the JAX package, so it also runs where JAX is not
installed; on the machine with the card, from the repository root:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py

Tolerances: the kernels' are those of tests/test_kernels.py (float32 rtol
1e-5 / atol 1e-4, bf16 X rtol 5e-2 / atol 5e-1); the graphed step runs the
eager step's kernels, so its loss and gradients agree within float32
rounding; the GMM fit compounds 60 EM iterations of float32 sums taken in
another order on each device, so it is held at rtol 1e-3. The EM kernels'
are tests/test_kernels.py's `_assert_tuple_close`: rtol 1e-4 / atol 1e-4 x
max(|want|, 1).
"""
import numpy as np
import pytest
import torch

from repro_torch.config import get_arch, reduced
from repro_torch.core.gmm import GMM
from repro_torch.data import SyntheticLMData
from repro_torch.core.events import Event, Layer
from repro_torch.kernels import gmm_score as kmod
from repro_torch.kernels import gmm_stats as smod
from repro_torch.kernels import ops
from repro_torch.models.model import Runtime, batch_to_device, init_params
from repro_torch.stream import FleetAggregator, OnlineGMMDetector, wire
from repro_torch.train.step import CudaGraphed, make_loss_and_grads

pytestmark = pytest.mark.gpu

SHAPES = [(128, 2, 2), (1000, 4, 3), (4096, 8, 8), (777, 3, 5),
          (2048, 16, 4), (513, 8, 16), (64, 32, 2), (1000, 32, 16),
          (0, 4, 3)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain(cuda, dtype):
    tol = (1e-5, 1e-4) if dtype == "float32" else (5e-2, 5e-1)
    for N, D, K in SHAPES:
        X, means, U = (torch.as_tensor(a, device=cuda)
                       for a in make_params(N, D, K))
        X = X.to(getattr(torch, dtype))
        want = ops.gmm_score(X, means, U, backend="plain")
        torch.testing.assert_close(ops.gmm_score(X, means, U), want,
                                   rtol=tol[0], atol=tol[1])
        wb, wa = ops.gmm_best(X, means, U, backend="plain")
        gb, ga = ops.gmm_best(X, means, U)
        torch.testing.assert_close(gb, wb, rtol=tol[0], atol=tol[1])
        mism = (ga != wa).cpu().numpy()
        if mism.any():  # argmax may differ only at near-ties
            top2 = np.sort(want.cpu().numpy()[mism], axis=1)[:, -2:]
            assert np.allclose(top2[:, 0], top2[:, 1], atol=1e-3)


def test_cuda_wrappers_check_their_inputs(cuda):
    X, means, U = (torch.as_tensor(a, device=cuda)
                   for a in make_params(64, 4, 2))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kmod.gmm_score_cuda(X.double(), means, U)
    with pytest.raises(ValueError, match="contiguous"):
        kmod.gmm_best_cuda(X.T.contiguous().T, means, U)
    Xw, mw, Uw = (torch.as_tensor(a, device=cuda)
                  for a in make_params(64, 33, 2))
    with pytest.raises(ValueError, match="D <= 32"):
        kmod.gmm_score_cuda(Xw, mw, Uw)


def test_graphed_loss_and_grads_match_eager(cuda):
    """New batches and perturbed weights at every call: a graph that read a
    stale batch or stale weights would disagree with the eager step."""
    cfg = reduced(get_arch("gpt2"))
    params = init_params(cfg, seed=0, device=cuda)
    eager = make_loss_and_grads(cfg, Runtime(torch.float32))
    graphed = CudaGraphed(eager)
    data = SyntheticLMData(cfg, seq_len=32, global_batch=4, seed=0)
    gen = torch.Generator(device=cuda).manual_seed(0)
    for s in range(5):
        batch = batch_to_device(data.batch(s), cuda)
        lg, _, gg = graphed(params, batch)
        le, _, ge = eager(params, batch)
        torch.testing.assert_close(lg, le, rtol=1e-5, atol=1e-6)
        for a, b in zip(gg, ge):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
        with torch.no_grad():
            for p in params.values():
                p.add_(torch.randn(p.shape, generator=gen, device=cuda),
                       alpha=0.01)
    assert graphed.graph is not None


def test_gmm_fit_on_the_card_matches_the_cpu(cuda):
    rng = np.random.default_rng(0)
    centers = 6.0 * rng.standard_normal((3, 4))
    X = (centers[rng.integers(0, 3, 2000)]
         + rng.standard_normal((2000, 4))).astype(np.float32)
    before = dict(kmod.LAUNCHES)
    on_card = GMM(n_components=3, seed=0, device=cuda).fit(X)
    on_cpu = GMM(n_components=3, seed=0, device="cpu").fit(X)
    assert kmod.LAUNCHES["gmm_score"] > before["gmm_score"]
    np.testing.assert_allclose(on_card.ll, on_cpu.ll, rtol=1e-3)
    np.testing.assert_allclose(on_card.score(X), on_cpu.score(X), rtol=1e-3,
                               atol=1e-3)


EM_CASES = [  # (N, D, K, nvalid): the kernel tests' grids and edge cases
    (128, 2, 2, None), (1000, 4, 3, None), (4096, 8, 8, None),
    (777, 3, 5, None), (2048, 16, 4, None), (512, 8, 1, None),
    (64, 5, 1, None), (256, 4, 3, 156), (512, 8, 1, 128), (1024, 2, 4, 624),
    (256, 4, 3, 0), (0, 4, 3, None), (1000, 32, 16, None),
    (3000, 32, 16, 1777)]


def _assert_tuple_close(got, want):
    for g, w in zip(got, want):
        scale = max(float(w.abs().max()) if w.numel() else 0.0, 1.0)
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("op", ["gmm_stats", "gmm_update"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_em_kernels_match_plain_and_repeat_bitwise(cuda, op, dtype):
    fn = getattr(ops, op)
    before = smod.LAUNCHES[op]
    for N, D, K, nvalid in EM_CASES:
        X, means, U = (torch.as_tensor(a, device=cuda)
                       for a in make_params(N, D, K, seed=N + D))
        X = X.to(getattr(torch, dtype))
        if nvalid is not None:
            X[nvalid:] = 1e6  # a leak through the mask is unmissable
        log_w = torch.log(torch.full((K,), 1.0 / K, device=cuda))
        want = fn(X, log_w, means, U, nvalid=nvalid, backend="plain")
        got = fn(X, log_w, means, U, nvalid=nvalid)
        again = fn(X, log_w, means, U, nvalid=nvalid)
        _assert_tuple_close(got, want)
        for g, g2 in zip(got, again):
            assert torch.equal(g, g2)
            assert torch.isfinite(g).all()
    assert smod.LAUNCHES[op] == before + 2 * len(EM_CASES)


def test_em_wrappers_check_their_inputs(cuda):
    X, means, U = (torch.as_tensor(a, device=cuda)
                   for a in make_params(64, 4, 2))
    log_w = torch.zeros(2, device=cuda)
    with pytest.raises(ValueError, match="nvalid"):
        smod.gmm_stats_cuda(X, log_w, means, U, nvalid=-1)
    with pytest.raises(ValueError, match="log_weights"):
        smod.gmm_update_cuda(X, torch.zeros(3, device=cuda), means, U)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        smod.gmm_stats_cuda(X.double(), log_w, means, U)


def _trace(rng, lo, hi, fault=()):
    return [Event(layer=layer, name=name, ts=0.05 * s, step=s,
                  dur=base * (8.0 if s in fault else 1.0)
                  * float(rng.lognormal(0.0, 0.05)))
            for s in range(lo, hi)
            for layer, name, base in ((Layer.STEP, "train_step", 3e-3),
                                      (Layer.XLA, "executable_run", 2e-3))]


def test_online_detector_on_the_card_matches_the_cpu(cuda):
    """Warmup (cold fits through gmm_update, statistics through gmm_stats)
    and one tick on the card against the same on the CPU; both detectors
    draw the same seeds and bootstrap rows, so they differ only by float32
    sums taken in another order."""
    rng = np.random.default_rng(0)
    bufs = [wire.encode_events(_trace(rng, 0, 100), node_id=0, seq=0),
            wire.encode_events(_trace(rng, 100, 130, range(110, 120)),
                               node_id=0, seq=1)]
    before = dict(smod.LAUNCHES)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        agg = FleetAggregator(horizon_s=1000.0)
        agg.ingest(bufs[0])
        det = OnlineGMMDetector(n_components=3, min_events=32, seed=0,
                                device=dev)
        det.warmup(agg)
        agg.ingest(bufs[1])
        deltas = {layer: s.log_delta for layer, s in det.states.items()}
        out[dev.type] = (deltas, det.detect(agg))
    assert smod.LAUNCHES["gmm_update"] > before["gmm_update"]
    assert smod.LAUNCHES["gmm_stats"] > before["gmm_stats"]
    (_, gdet), (deltas, cdet) = out["cuda"], out["cpu"]
    for layer, c in cdet.items():
        g = gdet[layer]
        assert g.refit == c.refit
        np.testing.assert_allclose(g.log_delta, c.log_delta, atol=1e-3)
        np.testing.assert_allclose(g.scores, c.scores, rtol=1e-3, atol=1e-3)
        near = np.abs(c.scores - deltas[layer]) < 1e-3
        assert not ((g.flags != c.flags) & ~near).any()
    assert set(range(110, 120)) <= set(
        gdet[Layer.STEP].anomalous_steps().tolist())
