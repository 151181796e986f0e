"""The port on the card: the CUDA kernels against their plain versions
(the EM kernels with poisoned padding rows, and bitwise repeatable), the
wrappers' input checks, the CUDA-graphed train step (its forward and
backward, and the whole step with the update) against the eager one, for
GPT-2 and for every registered family with AdamW, Adafactor and two
microbatches, a
GMM fit and a streaming detector's warmup and tick on the card against the
same on the CPU, the eval runner's graphed synthetic step against the eager
one and one scenario-matrix cell on the card, the serve plane's graphed
slot step against the eager one (GPT-2 and every other token decoder, the
device index read by RoPE and the ring slot) and its launcher,
attention's float32-result product on bf16 operands against the CPU's,
and the device probe's NVML source (the handle is torch's card by UUID,
``mem_gb`` follows an allocation, ``util`` rises under load, a hidden
library fails the session's attach).

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
max(|want|, 1). NVML's ``mem_gb`` is held within 1 GiB of
``mem_get_info``'s used bytes (what the GPU driver reserves beside CUDA's
view) and a 4 GiB allocation's step within 0.25 GiB.
"""
import time

import numpy as np
import pytest
import torch

from repro_torch.config import get_arch, reduced
from repro_torch.configs import ASSIGNED
from repro_torch.core.gmm import GMM
from repro_torch.data import SyntheticLMData
from repro_torch.core.events import Event, Layer
from repro_torch.kernels import gmm_score as kmod
from repro_torch.kernels import gmm_stats as smod
from repro_torch.kernels import ops, ref
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


def test_graphed_train_step_matches_the_eager_step(cuda):
    """Forward, backward and the AdamW update in one CUDA graph (the step's
    scalars in device tensors filled before each replay) against the eager
    step with host floats, over steps through the warm-up and the
    schedule's turn: losses and gradient norms within float32 rounding of
    each other, and the parameters and moments after them; a state whose
    moments moved is refused."""
    from repro_torch.config import TrainConfig
    from repro_torch.train.step import (init_train_state, make_optimizer_for,
                                        make_train_step)

    cfg = reduced(get_arch("gpt2"))
    opt = make_optimizer_for(TrainConfig(learning_rate=1e-3, total_steps=8,
                                         warmup_steps=2), cfg)
    data = SyntheticLMData(cfg, seq_len=32, global_batch=4, seed=0)
    runs = []
    for graph in (True, False):
        state = init_train_state(cfg, opt, seed=0, device=cuda)
        fn = make_train_step(cfg, Runtime(torch.float32), opt,
                             cuda_graph=graph)
        ms = []
        for s in range(8):
            state, m = fn(state, data.batch(s))
            ms.append((m["loss"], m["grad_norm"], m["lr"]))
        runs.append((state, ms, fn))
    (sg, mg, fg), (se, me, _) = runs
    for (lg, gg, rg), (le, ge, re_) in zip(mg, me):
        torch.testing.assert_close(lg, le, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(gg, ge, rtol=1e-4, atol=1e-6)
        assert rg == re_
    assert sg.opt_state["step"] == se.opt_state["step"] == 8
    init = init_train_state(cfg, opt, seed=0, device=cuda).params

    def norm(ts):
        return float(torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(ts))))

    keys = list(sg.params)
    moved = norm([se.params[k] - init[k] for k in keys])
    # Adam's update is scale-free, so a gradient at the noise floor may
    # flip an entry's step: held over the whole model, not entry by entry
    assert norm([sg.params[k] - se.params[k] for k in keys]) <= 1e-3 * moved
    for m in ("mu", "nu"):
        want = [se.opt_state[m][k] for k in keys]
        assert norm([sg.opt_state[m][k] - w for k, w in zip(keys, want)]) \
            <= 1e-4 * norm(want)
    with pytest.raises(ValueError, match="moments moved"):
        fg(init_train_state(cfg, opt, seed=0, device=cuda), data.batch(0))


@pytest.mark.parametrize("optimizer,microbatches",
                         [("adamw", 1), ("adafactor", 1), ("adamw", 2)])
@pytest.mark.parametrize("arch", ASSIGNED)
def test_graphed_step_of_every_family_matches_eager(cuda, arch, optimizer,
                                                    microbatches):
    """Each registered family at reduced size (float32, four SSD chunks,
    the sliding window inside the sequence): the graphed forward and
    backward against eager on the same weights, and the whole train step
    (forward, backward and the update in one graph) against the eager step
    from the same seed, with AdamW, Adafactor and two microbatches."""
    from repro_torch.config import TrainConfig
    from repro_torch.train.step import (init_train_state, make_optimizer_for,
                                        make_train_step)

    cfg = reduced(get_arch(arch))
    rt = Runtime(torch.float32)
    data = SyntheticLMData(cfg, seq_len=64, global_batch=4, seed=0)
    params = init_params(cfg, seed=0, device=cuda)
    eager = make_loss_and_grads(cfg, rt, microbatches)
    graphed = CudaGraphed(eager)
    for s in range(4):
        batch = batch_to_device(data.batch(s), cuda)
        lg, _, gg = graphed(params, batch)
        le, _, ge = eager(params, batch)
        torch.testing.assert_close(lg, le, rtol=1e-5, atol=1e-6)
        for a, b in zip(gg, ge):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    assert graphed.graph is not None
    opt = make_optimizer_for(TrainConfig(learning_rate=1e-3, total_steps=4,
                                         warmup_steps=1,
                                         optimizer=optimizer), cfg)
    runs = []
    for graph in (True, False):
        state = init_train_state(cfg, opt, seed=0, device=cuda)
        fn = make_train_step(cfg, rt, opt, microbatches=microbatches,
                             cuda_graph=graph)
        losses = []
        for s in range(4):
            state, m = fn(state, data.batch(s))
            losses.append(m["loss"])
        runs.append((state.params, losses))
    (pg, lg), (pe, le) = runs
    for a, b in zip(lg, le):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    init = init_params(cfg, seed=0, device=cuda)

    def norm(ts):
        return float(torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(ts))))

    moved = norm([pe[k] - init[k] for k in pe])
    assert norm([pg[k] - pe[k] for k in pe]) <= 1e-3 * moved


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


def _path_layout(U):
    """U as the EM loop hands it over: a transposed view, the same values."""
    return U.transpose(-1, -2).contiguous().transpose(-1, -2)


def _call(op, X, log_w, means, U, plain=False):
    """The wrapper's (or, with plain=True, the plain version's) outputs as a
    tuple."""
    fn = getattr(ref, f"{op}_ref") if plain else getattr(ops, op)
    out = (fn(X, log_w, means, U) if op in ("gmm_stats", "gmm_update")
           else fn(X, means, U))
    return (out,) if torch.is_tensor(out) else tuple(out)


WRAPPERS = ["gmm_score", "gmm_best", "gmm_stats", "gmm_update"]
# both sides of the specialised / general boundary
LAYOUT_SHAPES = [(227, 4, 3), (2048, 3, 3), (777, 5, 3), (500, 4, 6)]


def _inputs(N, D, K, cuda, seed=0):
    X, means, U = (torch.as_tensor(a, device=cuda)
                   for a in make_params(N, D, K, seed))
    return X, torch.log(torch.full((K,), 1.0 / K, device=cuda)), means, U


@pytest.mark.parametrize("op", WRAPPERS)
def test_one_kernel_per_wrapper_call(cuda, op):
    """A wrapper call puts one kernel on the stream (and, for the EM
    kernels, the 4-byte memset of their counter), with U in the EM loop's
    layout: no torch op forms mu U or log|det U| or copies U any more."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    X, log_w, means, U = _inputs(227, 4, 3, cuda)
    U = _path_layout(U)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def device_events(prof):
        out = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                out[e.key] = out.get(e.key, 0) + e.count
        return out

    # the profiler now and then loses device events over short sessions:
    # each call is followed by a marker (an in-place add, its events learnt
    # alone first), and a trace short of 10 markers is taken again
    mark = torch.zeros(1, device=cuda)
    _call(op, X, log_w, means, U)
    mark.add_(1.0)
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=acts) as prof:
            mark.add_(1.0)
            torch.cuda.synchronize()
        marker = device_events(prof)
        if marker:
            break
    for _ in range(5):
        with profile(activities=acts) as prof:
            for _ in range(10):
                _call(op, X, log_w, means, U)
                mark.add_(1.0)
            torch.cuda.synchronize()
        events = device_events(prof)
        if all(events.get(k, 0) >= 10 * n for k, n in marker.items()):
            break
    assert marker
    kinds = {"kernel": 0, "memset": 0, "memcpy": 0}
    for key, n in events.items():
        n -= 10 * marker.get(key, 0)
        key = key.lower()
        kinds["memset" if "memset" in key else
              "memcpy" if "memcpy" in key else "kernel"] += n
    em = op in ("gmm_stats", "gmm_update")
    assert kinds == {"kernel": 10, "memset": 10 if em else 0, "memcpy": 0}


@pytest.mark.parametrize("op", ["gmm_stats", "gmm_update"])
@pytest.mark.parametrize("N,D,K", [(65536, 4, 3), (2048, 4, 3),
                                   (3000, 8, 8)])
def test_em_graph_replay_is_bitwise_equal_to_eager(cuda, op, N, D, K):
    """The counter's memset and the launch captured in one CUDA graph: each
    of several replays equals the eager call bit for bit, also after new
    rows are copied into the captured input (a stale counter or stale
    partials would show here and not in one eager call)."""
    X, log_w, means, U = _inputs(N, D, K, cuda, seed=N % 97)
    _call(op, X, log_w, means, U)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = _call(op, X, log_w, means, U)
    fresh = torch.as_tensor(make_params(N, D, K, seed=99)[0], device=cuda)
    for r in range(4):
        if r == 3:
            X.copy_(fresh)
        graph.replay()
        eager = _call(op, X, log_w, means, U)
        for g, e in zip(captured, eager):
            assert torch.equal(g, e)


@pytest.mark.parametrize("op", WRAPPERS)
@pytest.mark.parametrize("N,D,K", LAYOUT_SHAPES)
def test_transposed_u_needs_no_copy(cuda, op, N, D, K):
    """U as the EM loop hands it over gives bitwise the outputs of a
    contiguous U, and the plain version's within the kernel tolerances."""
    X, log_w, means, U = _inputs(N, D, K, cuda, seed=D + K)
    Ut = _path_layout(U)
    assert not Ut.is_contiguous()
    got = _call(op, X, log_w, means, Ut)
    for g, w in zip(got, _call(op, X, log_w, means, U)):
        assert torch.equal(g, w)
    want = _call(op, X, log_w, means, Ut, plain=True)
    if op in ("gmm_stats", "gmm_update"):
        _assert_tuple_close(got, want)
    else:
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("op", WRAPPERS)
@pytest.mark.parametrize("N,D,K", LAYOUT_SHAPES)
def test_nan_u_gives_the_plain_versions_nans(cuda, op, N, D, K):
    """A non-PD covariance gives an all-NaN factor (`_prec_chol_from_cov`):
    the kernels give NaN exactly where the plain versions do (GMM.fit's
    reg escalation reads it), gmm_best the same first NaN index."""
    X, log_w, means, U = _inputs(N, D, K, cuda, seed=D * K)
    U[1] = float("nan")
    got = _call(op, X, log_w, means, U)
    want = _call(op, X, log_w, means, U, plain=True)
    for g, w in zip(got, want):
        if g.dtype == torch.int32:
            assert torch.equal(g, w)
            continue
        nan = torch.isnan(w)
        assert nan.any() and torch.equal(torch.isnan(g), nan)
        torch.testing.assert_close(g[~nan], w[~nan], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("poison", ["nan_u", "nan_rows", "finite"])
@pytest.mark.parametrize("op", ["gmm_stats", "gmm_update"])
@pytest.mark.parametrize("N,D,K", [(256, 4, 3), (300, 6, 5)])
def test_nvalid_zero_reads_every_row_like_the_plain_version(cuda, op, N, D,
                                                            K, poison):
    """nvalid = 0, N > 0: the reference multiplies every row's resp by 0,
    so a NaN U or NaN rows make nk, sx and sxx NaN (ll stays 0); finite
    inputs give zeros. The kernel (specialised and general) gives NaN in
    exactly the plain version's entries and equals it elsewhere."""
    X, means, U = make_params(N, D, K, seed=12)
    if poison == "nan_u":
        U[:] = np.nan
    elif poison == "nan_rows":
        X[:] = np.nan
    X, means, U = (torch.as_tensor(a, device=cuda) for a in (X, means, U))
    log_w = torch.log(torch.full((K,), 1.0 / K, device=cuda))
    fn = getattr(ops, op)
    want = fn(X, log_w, means, U, nvalid=0, backend="plain")
    got = fn(X, log_w, means, U, nvalid=0)
    for g, w in zip(got, want):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        finite = ~torch.isnan(w)
        assert torch.equal(g[finite], w[finite])
    if poison != "finite":
        assert torch.isnan(got[0]).all() and float(got[3]) == 0.0


def test_runtime_probe_times_graph_launches(cuda):
    """The runtime probe on the card: a graph replay gives a cudaGraphLaunch
    row (its host time, and no device-time row); a stream synchronisation
    its own row; nothing inside a detection zone (counted) or inside
    `unobserved` (the monitor's own calls, not counted); the hooks gone
    after."""
    from repro_torch.core.events import EventTable
    from repro_torch.core.probes import CudaRuntimeProbe, runtime_probe
    from repro_torch.detect import detection_zone

    x = torch.ones(256, 256, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        y = x @ x
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = x @ x
    replay = torch.cuda.CUDAGraph.replay
    table = EventTable(100)
    probe = CudaRuntimeProbe()
    probe.attach(table)
    for _ in range(3):
        graph.replay()
        torch.cuda.current_stream().synchronize()
    with detection_zone():
        graph.replay()
        torch.cuda.synchronize()
    with runtime_probe.unobserved():
        torch.cuda.synchronize()
    probe.detach()
    rows = table.drain_columns()
    names = [str(n) for n in rows["name"]]
    assert sorted(set(names)) == ["cudaGraphLaunch", "cudaStreamSynchronize"]
    assert names.count("cudaGraphLaunch") == 3
    assert names.count("cudaStreamSynchronize") == 3
    assert probe.dropped_in_zone == 2
    launch_dur = rows["dur"][np.array(names) == "cudaGraphLaunch"]
    assert np.all(launch_dur > 0) and np.all(launch_dur < 1.0)
    assert torch.cuda.CUDAGraph.replay is replay
    assert float(y[0, 0]) == 256.0


def test_launcher_session_on_the_card(cuda):
    """The launcher's batch session on the card at the reduced size: the
    detection plane gets a CUDA stream of its own, its sweeps launch the
    scoring kernels and no plain version, the runtime probe writes rows,
    and the report carries the operator, runtime and step layers."""
    from repro_torch.launch import train

    launched, plain = dict(kmod.LAUNCHES), dict(ref.CALLS)
    args = train.parser().parse_args(
        ["--reduced", "--steps", "60", "--batch", "4", "--seq", "32",
         "--monitor-spec", '{"mode": "batch", "detector": {"sweep_every": '
         '20, "min_events": 16}}', "--inject-faults", "--log-every", "0"])
    out = train.train(args)
    session, report = out["session"], out["report"]
    assert isinstance(session._executor.stream, torch.cuda.Stream)
    assert {"operator", "xla", "step"} <= set(report.layers)
    assert kmod.LAUNCHES["gmm_score"] > launched["gmm_score"]
    assert kmod.LAUNCHES["gmm_best"] > launched["gmm_best"]
    assert dict(ref.CALLS) == plain
    assert session.collector["xla"].emitted > 0
    assert np.isfinite(out["losses"]).all()


def test_hierarchical_monitor_on_the_card_matches_the_cpu(cuda):
    """The fleet plane: 4 nodes in 2 groups, node 1 slowed 8x over steps
    110-119, the same wire batches into a HierarchicalMonitor on the card
    and one on the CPU. Every group's detector launches the GMM kernels on
    the card and no plain version; per group, the two monitors' flags
    differ only by float32 sums taken in another order (rows within 1e-3 of
    the threshold), and both find node 1's fault."""
    from repro_torch.core.events import EventTable
    from repro_torch.fleet import HierarchicalMonitor, TopologySpec

    class Table:
        def __init__(self):
            self.buffer = EventTable(1 << 14)

        def drain_columns(self):
            return self.buffer.drain_columns()

    rng = np.random.default_rng(0)
    warm = {n: _trace(rng, 0, 100) for n in range(4)}
    live = {n: _trace(rng, 100, 130, range(110, 120) if n == 1 else ())
            for n in range(4)}
    launched, plain = (dict(kmod.LAUNCHES), dict(smod.LAUNCHES)), \
        dict(ref.CALLS)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        mon = HierarchicalMonitor(TopologySpec(group_size=2, fan_in=8),
                                  min_events=32, horizon_s=1000.0,
                                  incident_gap_s=0.5,
                                  incident_close_after_s=0.5, min_flags=4,
                                  device=dev)
        tables = {n: Table() for n in range(4)}
        for n, t in tables.items():
            mon.register_node(n, t)
            for ev in warm[n]:
                t.buffer.push(ev)
        mon.warmup()
        for n, t in tables.items():
            for ev in live[n]:
                t.buffer.push(ev)
        before = {gid: {l: s.log_delta for l, s in g.detector.states.items()}
                  for gid, g in mon.groups.items()}
        sweep = mon.detect_snapshot(mon.snapshot())
        mon.admit(sweep)
        mon.finish()
        out[dev.type] = (before, sweep.per_group, mon.incidents)
        if dev.type == "cuda":
            assert dict(ref.CALLS) == plain
    assert kmod.LAUNCHES["gmm_best"] > launched[0]["gmm_best"]
    assert smod.LAUNCHES["gmm_update"] > launched[1]["gmm_update"]
    (_, gsweep, ginc), (deltas, csweep, cinc) = out["cuda"], out["cpu"]
    assert sorted(gsweep) == sorted(csweep) == [0, 1]
    for gid, dets in csweep.items():
        for layer, c in dets.items():
            g = gsweep[gid][layer]
            assert g.refit == c.refit
            np.testing.assert_allclose(g.log_delta, c.log_delta, atol=1e-3)
            near = np.abs(c.scores - deltas[gid][layer]) < 1e-3
            assert not ((g.flags != c.flags) & ~near).any()
    for incidents in (ginc, cinc):
        assert any(1 in i.suspect_nodes for i in incidents)


def test_graphed_synth_step_matches_eager(cuda):
    """The eval runner's synthetic step captured in a CUDA graph against
    the eager step, on new inputs at every call and when fed its own
    output (the runner's loop): float32 products, rtol 1e-5 / atol 1e-6 at
    the eager output's scale (max |eager|; the outputs are ~1e-24), and
    each of the four products of the eager step against the CPU's."""
    from repro_torch.eval.runner import (SYNTH_SHAPE, GraphedSynthStep,
                                         _synth_iter, _synth_step)

    def scaled_close(got, want):
        scale = want.abs().max()
        torch.testing.assert_close(got / scale, want / scale, rtol=1e-5,
                                   atol=1e-6)

    gen = torch.Generator(device=cuda).manual_seed(0)
    step = GraphedSynthStep()
    for i in range(4):
        x = torch.randn(SYNTH_SHAPE, generator=gen, device=cuda) * (1.0 + i)
        want = _synth_step(x)
        assert want.abs().max() > 0
        scaled_close(step(x).clone(), want)
        for _ in range(4):
            nxt = _synth_iter(x)
            scaled_close(nxt.cpu(), _synth_iter(x.cpu()))
            x = nxt
    assert step.graph is not None
    x = torch.ones(SYNTH_SHAPE, device=cuda)
    eager, graphed = x, x
    for _ in range(3):
        eager, graphed = _synth_step(eager), step(graphed)
        scale = eager.abs().max()
        torch.testing.assert_close(graphed, eager, rtol=1e-5,
                                   atol=1e-6 * float(scale))


def test_eval_cell_on_the_card(cuda):
    """One scenario-matrix cell on the card (comm_slowdown, batch, 80
    steps): the schedule fills the COLLECTIVE layer, one row per all-reduce
    message per step (and the registration's), the runtime probe records
    the graphed step, and the sweeps launch the scoring kernels with no
    plain call."""
    from repro_torch.core.chaos import get_scenario
    from repro_torch.core.probes.collective_probe import parse_hlo_collectives
    from repro_torch.eval.runner import _FAKE_HLO, run_scenario

    n_msgs = len(parse_hlo_collectives(_FAKE_HLO))
    launched, plain = dict(kmod.LAUNCHES), dict(ref.CALLS)
    run = run_scenario(get_scenario("comm_slowdown"), "batch", n_steps=80,
                       device=cuda)
    emitted = run.report.overhead[0]["emitted_per_probe"]
    assert emitted["collective"] == n_msgs * 81
    assert run.report.layers["collective"].events == n_msgs * 80
    assert emitted["xla"] > 0
    assert kmod.LAUNCHES["gmm_score"] > launched["gmm_score"]
    assert kmod.LAUNCHES["gmm_best"] > launched["gmm_best"]
    assert dict(ref.CALLS) == plain


def test_only_the_thread_executor_gets_a_stream_of_its_own(cuda):
    """On the card a threaded detection plane sweeps on a CUDA stream of its
    own; an inline one sweeps on the caller's stream, since kernels on a
    second stream move the job's later graph replays between two levels
    (scripts/step_levels.py), which the STEP layer then flags."""
    from repro_torch.session import DetectorSpec, MonitorSpec, Session

    for executor, own in (("thread", True), ("inline", False)):
        spec = MonitorSpec(mode="batch", probes=["step"],
                           detector=DetectorSpec(executor=executor))
        session = Session(spec, device=cuda)
        assert isinstance(session._executor.stream, torch.cuda.Stream) == own
        session._executor.close()


def test_graphed_slot_step_matches_eager(cuda):
    """The continuous engine's slot step replayed as a CUDA graph against
    the same step run eagerly: one request stream with mid-flight joins and
    an epoch reset (``max_len`` 40), every step's logits bitwise equal."""
    from repro_torch.serve import (ContinuousBatchingEngine, LoadGenerator,
                                   RequestQueue, VirtualClock)

    cfg = reduced(get_arch("gpt2"))
    rt = Runtime(compute_dtype=torch.bfloat16)
    params = init_params(cfg, seed=0, device=cuda)
    runs = []
    for graphed in (True, False):
        eng = ContinuousBatchingEngine(cfg, rt, params, slots=4, max_len=40,
                                       seed=0, clock=VirtualClock(0.02))
        step, logits = eng._step_fn, []
        if not graphed:
            step.WARMUP = 1 << 30

        def kept(*a, step=step, logits=logits):
            out = step(*a)
            logits.append(out[0][:, -1].float().clone())
            return out

        eng._step_fn = kept
        eng.run(LoadGenerator(rate=0.6, num_requests=16, seed=3,
                              prompt_len=(3, 8), max_new=(4, 10),
                              vocab_size=cfg.vocab_size),
                queue=RequestQueue())
        runs.append((eng, step, torch.stack(logits)))
    (g, gstep, lg), (e, _, le) = runs
    assert gstep.graph is not None and gstep.replays >= 40
    assert g.scheduler.epoch_resets >= 1
    assert sum(r.start_index > 0 for r in g.finished) >= 4
    assert torch.equal(lg, le)
    assert [r.tokens for r in g.finished] == [r.tokens for r in e.finished]


DECODERS = [a for a in ASSIGNED if get_arch(a).has_decode
            and get_arch(a).input_mode == "tokens"]


@pytest.mark.parametrize("arch", DECODERS)
def test_graphed_slot_step_of_every_family_matches_eager(cuda, arch):
    """Each token decoder at reduced size (RoPE, the rolling window, MLA,
    MoE, SSD, the hybrid): the continuous engine's slot step replayed as a
    CUDA graph against eager, one request stream with mid-flight joins
    (SSM state reset in the graph) and an epoch reset, every step's logits
    bitwise equal."""
    from repro_torch.serve import (ContinuousBatchingEngine, LoadGenerator,
                                   RequestQueue, VirtualClock)

    cfg = reduced(get_arch(arch))
    rt = Runtime(compute_dtype=torch.bfloat16)
    params = init_params(cfg, seed=0, device=cuda)
    runs = []
    for graphed in (True, False):
        eng = ContinuousBatchingEngine(cfg, rt, params, slots=4, max_len=40,
                                       seed=0, clock=VirtualClock(0.02))
        step, logits = eng._step_fn, []
        if not graphed:
            step.WARMUP = 1 << 30

        def kept(*a, step=step, logits=logits):
            out = step(*a)
            logits.append(out[0][:, -1].float().clone())
            return out

        eng._step_fn = kept
        eng.run(LoadGenerator(rate=0.6, num_requests=16, seed=3,
                              prompt_len=(3, 8), max_new=(4, 10),
                              vocab_size=cfg.vocab_size),
                queue=RequestQueue())
        runs.append((eng, step, torch.stack(logits)))
    (g, gstep, lg), (e, _, le) = runs
    assert gstep.graph is not None and gstep.replays >= 40
    assert g.scheduler.epoch_resets >= 1
    assert sum(r.start_index > 0 for r in g.finished) >= 4
    assert torch.isfinite(lg).all()
    assert torch.equal(lg, le)


def test_graph_replays_read_the_device_index(cuda):
    """RoPE and the sliding window's ring slot come from the step's device
    ``index``, not from a value frozen at capture. H2O-Danube (reduced:
    RoPE, a 32-slot ring): a first token at index 40, then one captured
    step replayed twice from that state, the second token at index 41 and
    at 44. Each replay equals the eager step at its index bit for bit
    (logits and the ring's positions), and the two differ as the eager
    ones do (RoPE sees the distance between the tokens)."""
    from repro_torch.models.model import init_decode_caches
    from repro_torch.serve.continuous import make_slot_step
    from repro_torch.serve.engine import GraphedStep, cache_leaves

    cfg = reduced(get_arch("h2o-danube-3-4b"))
    params = init_params(cfg, seed=0, device=cuda)
    slot = make_slot_step(cfg, Runtime(compute_dtype=torch.float32))
    zero, no = np.zeros(1, np.int32), np.zeros(1, bool)

    def run(graphed):
        caches = init_decode_caches(cfg, 1, 64, dtype=torch.float32,
                                    device=cuda)
        step = GraphedStep(lambda p, c, tok, index, start, join:
                           slot(p, {"tokens": tok}, c, index, start, join))
        step.WARMUP = 1 if graphed else 1 << 30
        step(params, caches, np.array([[3]]), 40, zero, no)
        first = [t.clone() for t in cache_leaves(caches)]
        out = []
        for at in (41, 44):
            for t, saved in zip(cache_leaves(caches), first):
                t.copy_(saved)
            logits, caches = step(params, caches, np.array([[5]]), at, zero,
                                  no)
            out.append((logits.clone(), caches["layers"][0]["pos"].tolist()))
        return out, step.replays

    (near, far), replays = run(True)
    (want_near, want_far), _ = run(False)
    assert replays == 2
    assert torch.equal(near[0], want_near[0]) and near[1] == want_near[1]
    assert torch.equal(far[0], want_far[0]) and far[1] == want_far[1]
    assert near[1][8:10] == [40, 41] and far[1][8] == 40 \
        and far[1][12] == 44 and far[1][9] == -1
    assert not torch.allclose(near[0], far[0])


def test_serve_launcher_on_the_card(cuda):
    """`repro_torch.launch.serve` on the card (reduced model): 16 requests
    served in batch mode with SLOs, the slot step graphed, the GMM kernels
    launched and no plain version run."""
    from repro_torch.launch import serve

    launched, plain = dict(kmod.LAUNCHES), dict(ref.CALLS)
    args = serve.parser().parse_args(
        ["--reduced", "--device", "cuda", "--num-requests", "16",
         "--monitor-spec", '{"mode": "batch", "slo": {"ttft_s": 0.4}}'])
    out = serve.serve(args)
    assert out["stats"]["requests"] == 16
    assert out["stats"]["nonfinite_steps"] == 0
    assert out["engine"]._step_fn.graph is not None
    assert kmod.LAUNCHES["gmm_score"] > launched["gmm_score"]
    assert dict(ref.CALLS) == plain


def test_matmul_f32_on_the_card_matches_the_cpu(cuda):
    """Attention's float32-result product on bf16 operands: on the card
    `aten::bmm.dtype` and the backward of its own, on the CPU the operands
    upcast; both sum the same bf16 values in float32, so the product
    agrees within float32 rounding at its scale and the bf16 gradients
    within one bf16 step (2^-7) at theirs."""
    from repro_torch.models.attention import matmul_f32

    rng = np.random.default_rng(0)
    a = rng.standard_normal((24, 128, 64)).astype(np.float32)
    b = rng.standard_normal((24, 64, 128)).astype(np.float32)
    g = rng.standard_normal((24, 128, 128)).astype(np.float32)
    got = {}
    for dev in (cuda, torch.device("cpu")):
        ta = torch.tensor(a, device=dev).bfloat16().requires_grad_()
        tb = torch.tensor(b, device=dev).bfloat16().requires_grad_()
        out = matmul_f32(ta, tb.transpose(1, 2).contiguous().transpose(1, 2),
                         torch.bfloat16)
        assert out.dtype == torch.float32
        out.backward(torch.tensor(g, device=dev))
        assert ta.grad.dtype == torch.bfloat16
        got[dev.type] = [t.detach().float().cpu().numpy()
                         for t in (out, ta.grad, tb.grad)]
    for card, cpu, tol in zip(got["cuda"], got["cpu"], (1e-5, 2**-7, 2**-7)):
        np.testing.assert_allclose(card, cpu, rtol=0,
                                   atol=tol * float(np.abs(cpu).max()))


def test_checkpoint_manager_on_the_card(cuda, tmp_path):
    """A save of CUDA tensors copies them into pinned host buffers on the
    caller's stream and writes in the background: an in-place update right
    after the save does not reach the checkpoint, which restores onto the
    card bit for bit; the buffers `reserve` made are the ones every save
    uses."""
    from repro_torch.train import checkpoint as ckpt

    g = torch.Generator(device="cuda").manual_seed(0)
    state = {"w": torch.randn(512, 768, device=cuda, generator=g,
                              dtype=torch.bfloat16).requires_grad_(),
             "mu": torch.randn(512, 768, device=cuda, generator=g),
             "step": 3}
    want = {k: v.detach().clone() for k, v in state.items()
            if isinstance(v, torch.Tensor)}
    mgr = ckpt.CheckpointManager(str(tmp_path))
    mgr.reserve(state)  # the buffers before the first save
    pinned = list(mgr._pinned)
    mgr.save(3, state)
    with torch.no_grad():
        state["w"].add_(1.0)
        state["mu"].mul_(2.0)
    mgr.save(4, state)
    assert [b.data_ptr() for b in mgr._pinned] == \
        [b.data_ptr() for b in pinned] and all(b.is_pinned()
                                               for b in pinned)
    mgr.close()
    got, _ = ckpt.restore_checkpoint(str(tmp_path), 3, state)
    assert got["w"].is_cuda and got["w"].dtype == torch.bfloat16
    assert got["w"].requires_grad and got["step"] == 3
    for k in want:
        assert torch.equal(got[k].detach(), want[k])
    assert [s["step"] for s in mgr.saves] == [3, 4]
    assert mgr.saves[0]["bytes"] == 512 * 768 * (2 + 4)


def test_launcher_resume_on_the_card(cuda, tmp_path, monkeypatch):
    """The launcher at the reduced size on the card (the step graphed):
    a run stopped by SIGINT at step 6 and resumed gives the uninterrupted
    run's losses bit for bit, although the resumed run's first two steps
    run eagerly where the uninterrupted run replays its graph."""
    import signal

    from repro_torch.launch import train

    def args(d):
        return train.parser().parse_args(
            ["--reduced", "--steps", "12", "--batch", "4", "--seq", "32",
             "--log-every", "0", "--checkpoint-dir", str(d),
             "--checkpoint-every", "4"])

    full = train.train(args(tmp_path / "full"))
    batch = SyntheticLMData.batch

    def batch_then_sigint(self, s):
        if s == 6:
            signal.raise_signal(signal.SIGINT)
        return batch(self, s)

    with monkeypatch.context() as m:
        m.setattr(SyntheticLMData, "batch", batch_then_sigint)
        cut = train.train(args(tmp_path / "cut"))
    resumed = train.train(args(tmp_path / "cut"))
    assert cut["interrupted"] and resumed["start_step"] == 7
    assert cut["losses"] + resumed["losses"] == full["losses"]


# -- the device probe's NVML source on the card --------------------------------

def _nvml_probe(interval=0.1, **kw):
    from repro_torch.core.probes.device_probe import DeviceProbe, cuda_uuids

    return DeviceProbe(interval=interval, source="nvml", sampler="process",
                       uuids=cuda_uuids(torch.cuda.current_device(), 1), **kw)


def _gpu_rows(table):
    cols = table.drain_columns()
    keep = cols["name"] == "gpu0"
    return {k: cols[k][keep] for k in ("ts", "util", "mem_gb", "power_w",
                                       "temp_c")}


def test_nvml_handle_is_torch_s_device(cuda):
    from repro_torch.core.probes.device_probe import cuda_uuids
    from repro_torch.core.probes.nvml import Nvml

    index = torch.cuda.current_device()
    (uuid,) = cuda_uuids(index, 1)
    lib = Nvml()
    try:
        h = lib.handle(uuid)
        assert lib.uuid(h) == uuid
        assert 100.0 <= lib.power_limit_w(h) <= 1000.0
        total = lib.memory(h)[0]
        # NVML's total and CUDA's may differ by what the GPU driver reserves
        assert abs(total - torch.cuda.mem_get_info(index)[1]) < 2**30
    finally:
        lib.shutdown()


def test_nvml_memory_tracks_a_4_gb_allocation(cuda):
    """``mem_gb`` against ``mem_get_info``'s used bytes: within 1 GiB (what
    the GPU driver reserves beside CUDA's view), and the 4 GiB allocation's
    step within 0.25 GiB."""
    from repro_torch.core.events import EventTable

    def used():
        free, total = torch.cuda.mem_get_info()
        return (total - free) / 2**30

    probe, table = _nvml_probe(), EventTable(4096)
    probe.attach(table)
    try:
        time.sleep(0.5)
        probe.drain()
        before, want_before = _gpu_rows(table)["mem_gb"][-1], used()
        block = torch.ones(4 * 2**30, dtype=torch.uint8, device=cuda)
        torch.cuda.synchronize()
        time.sleep(0.5)
        probe.drain()
        after, want_after = _gpu_rows(table)["mem_gb"][-1], used()
        del block
    finally:
        probe.detach()
    assert probe.failed_samples == 0, probe.last_error
    assert abs(before - want_before) < 1.0 and abs(after - want_after) < 1.0
    assert abs((after - before) - 4.0) < 0.25, (before, after)


def test_nvml_util_rises_under_bf16_matmuls(cuda):
    from repro_torch.core.events import EventTable

    probe, table = _nvml_probe(), EventTable(4096)
    a = torch.randn(8192, 8192, device=cuda, dtype=torch.bfloat16)
    probe.attach(table)
    try:
        time.sleep(1.5)
        probe.drain()
        idle = _gpu_rows(table)
        t_end = time.perf_counter() + 2.5
        while time.perf_counter() < t_end:
            for _ in range(20):
                a = (a @ a).clamp_(-1, 1)
            torch.cuda.synchronize()
        probe.drain()
        busy = _gpu_rows(table)
    finally:
        probe.detach()
    assert probe.failed_samples == 0, probe.last_error
    idle_util = float(np.median(idle["util"][-4:]))
    busy_util = float(np.median(busy["util"][-8:]))
    assert busy_util > 80.0 and busy_util > idle_util + 30.0, \
        (idle_util, busy_util)
    assert busy["power_w"].max() > idle["power_w"].min()


def test_cuda_session_with_nvml_hidden_fails_at_attach(cuda):
    import sys

    from repro_torch.session import MonitorSpec, Session

    spec = MonitorSpec(mode="batch", probe_options={
        "device": {"source": "nvml", "nvml_lib": "libnvidia-ml-hidden.so.1"}})
    session = Session(spec, device=cuda)
    with pytest.raises(RuntimeError, match="nvml sampler did not start"):
        with session.monitoring():
            pass
    assert sys.getprofile() is None  # the python probe went with it
