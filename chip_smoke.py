#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: build, check, run.

    python3 chip_smoke.py

Phases, each printing one JSON line of its own:

1. ``build``: compile every CUDA source of ``src/repro_torch/kernels/csrc``
   with nvcc for sm_90a (one nvcc per source, all started together) and
   report the seconds and each kernel instantiation's registers, stack
   and spill bytes from ptxas; every specialised instantiation must be
   there, with no stack frame and no spill.
2. ``kernel_check``: every kernel against its plain PyTorch version on the
   card. ``gmm_score`` / ``gmm_best``: the kernel tests' shape grid (up to
   D=32, K=16), N=0, the main path's D=4/K=4 shapes (N = 4096 and 2^20),
   bf16 X, exact ties and NaN components; float32 rtol 1e-5 / atol 1e-4 (the
   kernel tests' own), bf16 X rtol 5e-2 / atol 5e-1, argmax may differ only
   at near-ties (top two within 1e-3), ties and NaN must match exactly.
   ``gmm_stats`` / ``gmm_update``: the kernel tests' grids (``SHAPES[:5]``,
   ``UPDATE_SHAPES`` with K=1, ``BUCKETS`` x nvalid fractions {1, 0.61,
   0.25} with the padding rows poisoned to 1e6), nvalid=0 (also with an
   all-NaN U and with NaN rows: NaN exactly where the plain version has it),
   N=0, bf16 X, D=32/K=16 and N=2^20 at D=4/K=3; rtol 1e-4 / atol 1e-4 x
   max(|want|, 1)
   (tests/test_kernels.py's `_assert_tuple_close`), and every case called
   twice: the two outputs must be bitwise equal. Then, for all four
   kernels on both sides of the specialised / general boundary: U in the
   EM loop's layout (a transposed view) must give bitwise the outputs of a
   contiguous U, and a NaN component of U NaN exactly where the plain
   version gives it; shapes at the boundary must launch the variant the
   wrappers' list names; and the EM kernels captured in one CUDA graph
   must equal the eager call bit for bit over 4 replays, the last on new
   rows.
3. ``graph_check``: the train step's CUDA-graphed forward and backward
   against the eager one at full width, on new batches and perturbed weights
   (loss within 1e-3 relative, gradients within 1e-2 of their norm).
4. ``main_path``: `repro_torch.quickstart.run` on ``cuda`` — full-width GPT-2
   124M in bf16, batch 8, sequence 128, 120 steps, op_latency faults (seed 7,
   0.03 s), the reference quickstart's probes (runtime, operator,
   collective, device, step), per-layer GMM fit and detection on the card.
   The launch counts are set to 0 just before and read just after: both
   scoring kernels must have launched and no plain version may have run.
   The loss must be finite, the STEP layer's hit rate > 0.5 and > 2x its
   false rate, the governor must act, the operator layer and the runtime
   probe must have rows, and the device probe must have lost no sample.
5. ``stream_path``: `repro_torch.quickstart.run_stream` on ``cuda`` — the
   same model trains 240 steps with a StreamMonitor attached (the
   latency_spike scenario: 3 op_latency bursts of 14 steps after a 96-step
   clean prefix), warmup at step 96, a detection tick every 20 steps, then
   finish(). Counts reset just before, read just after: all four kernels
   must have launched and no plain version may have run; the loss must be
   finite, the incidents must match at least 2 of the 3 fault windows
   (recall >= 2/3) with precision >= 0.5, the top-severity incident's
   deficit must lie mostly on a layer op_latency perturbs (``operator`` or
   ``step``), the wire must have lost no batch and the device probe no
   sample. The engine's own suspect layer is printed beside it, and listed
   under ``unmet`` unless it is ``operator``, where the fault is injected.
6. ``session_path``: the training entry point, `repro_torch.launch.train`,
   in-process at full width with ``--inject-faults`` and its session
   (`session_phase`): 100 steps unmonitored, 200 in batch mode and 240 in
   stream mode with the full probe suite. Per mode: steps/s of the loop,
   steps/s after the graphed step's set-up calls, rows per layer and
   probe, the STEP and OPERATOR layers' hit and false
   rates (batch) or the incidents against the fault windows (stream),
   incidents with their suspect and heaviest layer, diagnoses, governor
   actions, kernel launches and plain calls, the runtime probe's rows; the
   monitoring overhead against the unmonitored rate, both after the set-up
   calls; runtime-probe rows
   written inside a detection zone or on the detection worker (must be
   0). The batch mode's STEP layer must pass the main path's rate gate;
   its governor action is reported under ``unmet`` when there is none.
7. ``kernel_scaling``: kernel and plain times at N = 4096 and 2^20 (D=4,
   K=4 for the scoring kernels; D=4, K=3 for the EM kernels).
8. ``profile``: torch.profiler over 5 full-width training steps, one
   GMMDetector fit at the main path's largest layer shape, and one
   streaming detection tick at the stream path's shapes: device time, the
   device's busy share of the wall time, and the costliest kernels.

Every path must launch only specialised kernels (the wrappers'
``VARIANTS``, set to 0 before each path and read after).
Then the ``kernels`` line (each kernel's launches on its path — the main
path for the scoring kernels, the stream path for the EM kernels — its
largest error against the plain version at that path's largest shape, its
device time per wrapper call, the plain version's, its bound, and beside
them the launch alone, the eager per-call time, the kernels and memsets a
wrapper call puts on the stream, counted with torch.profiler, which must be
one kernel and, for the EM kernels, one memset, and the variants each path
launched), the card's name and power limit as nvidia-smi prints them, and
as the last line ``{"ok": true, "device": {"platform": "gpu", ...}}``. Any
failure exits non-zero before that line. TF32 is off for matmuls
(PyTorch's default) and set off for cuDNN here, so float32 comparisons are
float32.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = "src/repro_torch/kernels/csrc/"
SOURCES = {"gmm_score": CSRC + "gmm_score.cu",
           "gmm_best": CSRC + "gmm_score.cu",
           "gmm_stats": CSRC + "gmm_stats.cu",
           "gmm_update": CSRC + "gmm_stats.cu"}
REPLACES = {"gmm_score": "src/repro/kernels/gmm_score.py:28",
            "gmm_best": "src/repro/kernels/gmm_score.py:45",
            "gmm_stats": "src/repro/kernels/gmm_stats.py:80",
            "gmm_update": "src/repro/kernels/gmm_stats.py:87"}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
SHAPES = [(128, 2, 2), (1000, 4, 3), (4096, 8, 8), (777, 3, 5),
          (2048, 16, 4), (513, 8, 16), (64, 32, 2), (1000, 32, 16),
          (0, 4, 3), (4096, 4, 4), (1 << 20, 4, 4)]
BF16_SHAPES = [(512, 6, 4), (4096, 4, 4), (1000, 32, 16)]
SCALING = [(4096, 4, 4), (1 << 20, 4, 4)]
# the EM kernels: tests/test_kernels.py's grids, then the edge cases
STATS_SHAPES = SHAPES[:5]
UPDATE_SHAPES = [(256, 2, 2), (1000, 4, 3), (777, 3, 5), (512, 8, 1),
                 (64, 5, 1)]
BUCKETS = [(256, 4, 3), (512, 8, 1), (1024, 2, 4)]
EM_SCALING = [(4096, 4, 3), (1 << 20, 4, 3)]
STREAM_FIT_SHAPE = (2048, 4, 3)  # OnlineGMMDetector.fit_rows, D=4, K=3


class SmokeFailure(Exception):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def make_params(N, D, K, seed, dtype):
    """The kernel tests' inputs: X ~ N(0, 1), means ~ N(0, 1), U from a
    random SPD covariance; made on the CPU from a seed, moved to the card."""
    import torch

    g = torch.Generator().manual_seed(seed)
    X = torch.randn((N, D), generator=g)
    means = torch.randn((K, D), generator=g)
    A = 0.3 * torch.randn((K, D, D), generator=g, dtype=torch.float64)
    cov = A @ A.transpose(-1, -2) + 0.5 * torch.eye(D, dtype=torch.float64)
    L = torch.linalg.cholesky(cov)
    U = torch.linalg.solve_triangular(
        L, torch.eye(D, dtype=torch.float64).expand(K, D, D),
        upper=False).transpose(-1, -2)
    return (X.to(dtype).cuda(), means.cuda(),
            U.to(torch.float32).contiguous().cuda())


def path_layout(U):
    """U as the EM loop hands it over: the transpose of a contiguous tensor
    (`_prec_chol_from_cov` returns L^-T as a view), the same values."""
    return U.transpose(-1, -2).contiguous().transpose(-1, -2)


def ptxas_summary(logs):
    """Registers, stack and spill bytes of every kernel instantiation from
    nvcc's -Xptxas=-v output, keyed by a short name such as
    ``em_fixed<f32,4,3>`` (``score_fixed<bf16,4,3,1>``: the last number of
    a scoring kernel is BEST)."""
    import re

    out, name = {}, None
    for log in logs.values():
        for ln in log.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?(_Z\w+)", ln)
            if m:
                mangled = m.group(1)
                base = re.search(r"(score_fixed|score_general|em_fixed|"
                                 r"em_general)", mangled)
                if base is None:
                    name = None
                    continue
                tail = mangled[base.end():]
                args = re.findall(r"L[ib](\d+)E", tail.split("EEv")[0])
                dtype = "bf16" if "bfloat16" in tail.split("EEv")[0] else "f32"
                name = f"{base.group(1)}<{','.join([dtype, *args])}>"
                out.setdefault(name, {})
                continue
            if name is None:
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", ln)
            if m:
                out[name].update(stack=int(m.group(1)),
                                 spill=int(m.group(2)) + int(m.group(3)))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                out[name]["registers"] = int(m.group(1))
    return out


def compare(name, got, want, rtol, atol, logp=None):
    """Largest |got - want| of one output pair; raises past tolerance."""
    import torch

    if name.endswith("arg"):
        mism = got != want
        if bool(mism.any()):
            top2 = torch.sort(logp[mism], dim=1).values[:, -2:]
            if not bool(torch.all(torch.abs(top2[:, 0] - top2[:, 1]) < 1e-3)):
                raise SmokeFailure(f"{name}: argmax differs away from a tie")
        return 0.0
    if got.shape != want.shape:
        raise SmokeFailure(f"{name}: shape {tuple(got.shape)} vs "
                           f"{tuple(want.shape)}")
    if not got.numel():
        return 0.0
    err = torch.abs(got - want)
    if bool(torch.any(err > atol + rtol * torch.abs(want))):
        raise SmokeFailure(f"{name}: max abs err {float(err.max())} "
                           f"beyond rtol {rtol} / atol {atol}")
    return float(err.max())


def check_case(ops, N, D, K, dtype, seed):
    """Both kernels against their plain versions on one input; returns the
    largest error of each kernel."""
    import torch

    X, means, U = make_params(N, D, K, seed, dtype)
    rtol, atol = (1e-5, 1e-4) if dtype == torch.float32 else (5e-2, 5e-1)
    want = ops.gmm_score(X, means, U, backend="plain")
    got = ops.gmm_score(X, means, U)
    wb, wa = ops.gmm_best(X, means, U, backend="plain")
    gb, ga = ops.gmm_best(X, means, U)
    torch.cuda.synchronize()
    tag = f"N={N} D={D} K={K} {str(dtype)[6:]}"
    return {
        "gmm_score": compare(f"gmm_score {tag}", got, want, rtol, atol),
        "gmm_best": max(
            compare(f"gmm_best {tag} best", gb, wb, rtol, atol),
            compare(f"gmm_best {tag} arg", ga, wa, 0, 0, logp=want)),
    }


def check_em_case(ops, N, D, K, dtype, seed, nvalid=None):
    """``gmm_stats`` and ``gmm_update`` against their plain versions on one
    input, rows at and past ``nvalid`` poisoned to 1e6; each kernel is
    called twice and must give bitwise equal outputs. Returns, per kernel,
    the largest absolute error and the largest error relative to
    max(|want|, 1) of its output."""
    import torch

    X, means, U = make_params(N, D, K, seed, dtype)
    if nvalid is not None:
        X[nvalid:] = 1e6
    log_w = torch.log(torch.full((K,), 1.0 / K, device=X.device))
    tag = f"N={N} D={D} K={K} nvalid={nvalid} {str(dtype)[6:]}"
    worst, worst_rel = {}, {}
    for name in ("gmm_stats", "gmm_update"):
        fn = getattr(ops, name)
        want = fn(X, log_w, means, U, nvalid=nvalid, backend="plain")
        got = fn(X, log_w, means, U, nvalid=nvalid)
        again = fn(X, log_w, means, U, nvalid=nvalid)
        torch.cuda.synchronize()
        worst[name] = worst_rel[name] = 0.0
        for i, (g, w, g2) in enumerate(zip(got, want, again)):
            scale = max(float(w.abs().max()) if w.numel() else 0.0, 1.0)
            err = compare(f"{name} {tag} output {i}", g, w, 1e-4,
                          1e-4 * scale)
            if not bool(torch.isfinite(g).all()):
                raise SmokeFailure(f"{name} {tag} output {i} not finite")
            if not torch.equal(g, g2):
                raise SmokeFailure(f"{name} {tag} output {i}: two calls "
                                   "differ (not deterministic)")
            worst[name] = max(worst[name], err)
            worst_rel[name] = max(worst_rel[name], err / scale)
    return worst, worst_rel


def em_cases():
    """(N, D, K, dtype, nvalid) of the EM kernels' check."""
    import torch

    f32 = torch.float32
    cases = [(N, D, K, f32, None) for N, D, K in STATS_SHAPES + UPDATE_SHAPES]
    cases += [(N, D, K, f32, max(int(N * frac), 1))
              for N, D, K in BUCKETS for frac in (1.0, 0.61, 0.25)]
    cases += [(256, 4, 3, f32, 0), (0, 4, 3, f32, None),
              (2048, 4, 3, torch.bfloat16, None),
              (512, 6, 4, torch.bfloat16, 300), (1000, 32, 16, f32, None),
              (3000, 32, 16, f32, 1777), (1 << 20, 4, 3, f32, None)]
    return cases


def check_ties_and_nan(ops):
    """Exact ties must give the first index and a NaN component must give
    the plain version's (NaN, first NaN index)."""
    import torch

    X, means, U = make_params(2048, 4, 3, 11, torch.float32)
    means[1], U[1] = means[0], U[0]  # component 1 ties component 0
    wb, wa = ops.gmm_best(X, means, U, backend="plain")
    gb, ga = ops.gmm_best(X, means, U)
    if bool(torch.any(ga == 1)) or not torch.equal(
            ga, torch.where(wa == 1, 0, wa)):
        raise SmokeFailure("gmm_best did not keep the first of tied "
                           "components")
    if not torch.allclose(gb, wb, rtol=1e-5, atol=1e-4):
        raise SmokeFailure("gmm_best density differs from plain on ties")
    U[2, 0, 0] = float("nan")  # component 2 is NaN on every row
    wb, wa = ops.gmm_best(X, means, U, backend="plain")
    gb, ga = ops.gmm_best(X, means, U)
    if not (torch.equal(ga, wa) and bool(torch.all(wa == 2))
            and bool(torch.all(torch.isnan(gb)))
            and bool(torch.all(torch.isnan(wb)))):
        raise SmokeFailure("gmm_best differs from plain on a NaN component")


def em_inputs(N, D, K, seed):
    import torch

    X, means, U = make_params(N, D, K, seed, torch.float32)
    return X, torch.log(torch.full((K,), 1.0 / K, device=X.device)), means, U


def check_layout_and_nan(ops):
    """On both sides of the specialised / general boundary: U as the EM
    loop hands it over (a transposed view) gives bitwise the outputs of a
    contiguous U, within tolerance of the plain version; a NaN U (the
    all-NaN factor of a non-PD covariance) gives NaN exactly where the
    plain version does, and elsewhere agrees with it. Returns the cases."""
    import torch

    cases = 0
    for N, D, K in ((227, 4, 3), (2048, 3, 3), (777, 5, 3), (500, 4, 6)):
        X, log_w, means, U = em_inputs(N, D, K, 31 + D + K)
        Ut = path_layout(U)
        assert not Ut.is_contiguous()
        for name in ("gmm_score", "gmm_best", "gmm_stats", "gmm_update"):
            fn = getattr(ops, name)
            args = (X, log_w, means) if name in ("gmm_stats",
                                                  "gmm_update") else (X, means)
            got, want = fn(*args, Ut), fn(*args, U)
            plain = fn(*args, Ut, backend="plain")
            got, want, plain = ((o,) if torch.is_tensor(o) else tuple(o)
                                for o in (got, want, plain))
            for i, (g, w, p) in enumerate(zip(got, want, plain)):
                if not torch.equal(g, w):
                    raise SmokeFailure(f"{name} N={N} D={D} K={K} output {i}:"
                                       " a transposed U differs from a "
                                       "contiguous one")
                if g.dtype == torch.float32:
                    scale = max(float(p.abs().max()), 1.0)
                    rtol, atol = ((1e-5, 1e-4) if name in ("gmm_score",
                                                           "gmm_best")
                                  else (1e-4, 1e-4 * scale))
                    compare(f"{name} transposed U N={N} D={D} K={K} "
                            f"output {i}", g, p, rtol, atol)
            Un = U.clone()
            Un[1] = float("nan")
            got = fn(*args, Un)
            plain = fn(*args, Un, backend="plain")
            got, plain = ((o,) if torch.is_tensor(o) else tuple(o)
                          for o in (got, plain))
            for i, (g, p) in enumerate(zip(got, plain)):
                if g.dtype != torch.float32:
                    if not torch.equal(g, p):
                        raise SmokeFailure(f"{name} NaN U N={N} D={D} K={K}:"
                                           " argmax differs from plain")
                    continue
                nan = torch.isnan(p)
                if not torch.equal(torch.isnan(g), nan) or not bool(
                        nan.any()):
                    raise SmokeFailure(f"{name} NaN U N={N} D={D} K={K} "
                                       f"output {i}: NaNs differ from plain")
                if not bool(nan.all()):
                    compare(f"{name} NaN U N={N} D={D} K={K} output {i}",
                            g[~nan], p[~nan], 1e-5, 1e-4)
            cases += 1
    torch.cuda.synchronize()
    return cases


def check_boundary(ops, kmod, smod):
    """Shapes on both sides of the specialised / general boundary launch
    the variant the wrappers' list says, and agree with the plain
    versions. Returns {shape: variant}."""
    import torch

    seen = {}
    for N, D, K in ((1000, 4, 4), (1000, 5, 4), (1000, 4, 5), (1000, 2, 1),
                    (1000, 1, 3), (1000, 3, 4)):
        want = kmod.variant(D, K)
        before = ({k: dict(v) for k, v in kmod.VARIANTS.items()},
                  {k: dict(v) for k, v in smod.VARIANTS.items()})
        check_case(ops, N, D, K, torch.float32, seed=70 + D + K)
        check_em_case(ops, N, D, K, torch.float32, seed=80 + D + K)
        for counts, old in ((kmod.VARIANTS, before[0]),
                            (smod.VARIANTS, before[1])):
            for name, v in counts.items():
                if v[want] - old[name][want] < 1 or sum(v.values()) - sum(
                        old[name].values()) != v[want] - old[name][want]:
                    raise SmokeFailure(f"{name} at D={D} K={K} did not "
                                       f"launch only the {want} kernel")
        seen[f"D={D} K={K}"] = want
    return seen


def check_em_graph_replay(ops):
    """The EM kernels captured in one CUDA graph (the counter's memset and
    the launch) and replayed: every replay bitwise equal to the eager call,
    also after new rows are copied into the captured input, so a stale
    counter or a last block reading stale partials would show. Returns the
    replays."""
    import torch

    replays = 0
    for N, D, K in ((65536, 4, 3), (2048, 4, 3), (3000, 8, 8)):
        for name in ("gmm_stats", "gmm_update"):
            fn = getattr(ops, name)
            X, log_w, means, U = em_inputs(N, D, K, 41 + N % 97)
            U = path_layout(U)
            fn(X, log_w, means, U)  # warm-up outside the capture
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                captured = fn(X, log_w, means, U)
            for r in range(4):
                if r == 3:  # new rows into the captured input
                    X.copy_(make_params(N, D, K, 99, torch.float32)[0])
                graph.replay()
                eager = fn(X, log_w, means, U)
                torch.cuda.synchronize()
                for i, (g, e) in enumerate(zip(captured, eager)):
                    if not torch.equal(g, e):
                        raise SmokeFailure(
                            f"{name} N={N} D={D} K={K} output {i}: graph "
                            f"replay {r} differs from the eager call")
                replays += 1
            del graph
    return replays


def nodes_per_call(fn, calls=20, attempts=3):
    """What one wrapper call puts on the stream, counted by torch.profiler
    over ``calls`` eager calls after a warm-up: kernels, memsets and
    copies per call. A trace that holds no device event at all is a trace
    the profiler lost (it happens now and then over many short sessions),
    not a count: it is taken again, up to ``attempts`` times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        counts = {"kernels": 0, "memsets": 0, "memcpys": 0}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            key = e.key.lower()
            kind = ("memsets" if "memset" in key else
                    "memcpys" if "memcpy" in key else "kernels")
            counts[kind] += e.count
        if any(counts.values()):
            break
    return {k: v / calls for k, v in counts.items()}


def check_graphed_step(steps=6):
    """The CUDA-graphed forward and backward against the eager one at full
    width (GPT-2 124M, bf16, batch 8, sequence 128), on a new batch and
    perturbed weights at every call, so a graph that read a stale batch or
    stale weights would disagree. Loss within 1e-3 relative; the gradients'
    difference within 1e-2 of their global norm (the same kernels, with
    cuBLAS free to pick another algorithm inside the capture). Returns the
    largest of each."""
    import torch

    from repro_torch.config import get_arch
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.model import Runtime, batch_to_device, init_params
    from repro_torch.train.step import CudaGraphed, make_loss_and_grads

    dev = torch.device("cuda")
    cfg = get_arch("gpt2")
    params = init_params(cfg, seed=0, device=dev)
    plist = list(params.values())
    eager = make_loss_and_grads(cfg, Runtime(torch.bfloat16))
    graphed = CudaGraphed(eager)
    data = SyntheticLMData(cfg, seq_len=128, global_batch=8, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    worst_loss = worst_grad = 0.0
    for s in range(steps):
        batch = batch_to_device(data.batch(s), dev)
        lg, _, gg = graphed(params, batch)
        le, _, ge = eager(params, batch)
        diff = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
            torch._foreach_sub(list(gg), list(ge)))))
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
            list(ge))))
        rel_loss = abs(float(lg) - float(le)) / abs(float(le))
        rel_grad = float(diff / norm)
        if not (rel_loss <= 1e-3 and rel_grad <= 1e-2):
            raise SmokeFailure(f"graphed step {s} differs from eager: loss "
                               f"{float(lg)} vs {float(le)}, grad diff "
                               f"{rel_grad} of the norm")
        worst_loss, worst_grad = max(worst_loss, rel_loss), max(worst_grad,
                                                                rel_grad)
        with torch.no_grad():
            for p in plist:
                p.add_(torch.randn(p.shape, generator=gen, device=dev),
                       alpha=0.01)
    if graphed.graph is None:
        raise SmokeFailure("the train step was never captured")
    del params, plist, graphed
    return worst_loss, worst_grad


def host_ms(fn, reps):
    """Per-call time of back-to-back eager calls: what a caller pays while
    the host enqueues launches (CUDA events, after warm-up)."""
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps):
    """Per-call device time: ``reps`` calls captured in one CUDA graph and
    replayed, so no host work sits between the kernels."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def bound_ms(kernel, N, D, K, x_bytes=4):
    """Least time for the work on an H100 SXM: each input read once, each
    output written once, over 3.35 TB/s; the float32 flops over 67 TFLOP/s;
    the larger of the two. Every kernel reads X, means and U, and forms
    mu U and log|det U| once a call (2 K D^2 + K D flops). Scoring kernels:
    (N, K) or 2 (N,) out; K (2 D^2 + 3 D + 3) flops a row (the density).
    EM kernels: log w in besides; nk, sx or means, sxx or cov and ll out;
    K (3 D^2 + 6 D + 10) + 1 flops a row: the density, the
    responsibilities' log-sum-exp (6 a component, exp counted as one), nk
    and sx (1 + 2 D), sxx as the symmetric product of r x with x (D^2 + D:
    half the entries at 2 flops, r x_d reused from sx) and ll (1).
    gmm_update adds its M-step once: K (3 D (D + 1) / 2 + D + 1) flops."""
    params = 4 * (K * D * D + K * D)
    ops = 2 * K * D * D + K * D
    if kernel in ("gmm_score", "gmm_best"):
        out = N * K * 4 if kernel == "gmm_score" else N * 8
        ops += N * K * (2 * D * D + 3 * D + 3)
    else:
        params += 4 * K
        out = 4 * (K * D * D + K * D + K + 1)
        ops += N * (K * (3 * D * D + 6 * D + 10) + 1)
        if kernel == "gmm_update":
            ops += K * (3 * D * (D + 1) // 2 + D + 1)
    bytes_ = N * D * x_bytes + params + out
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, ops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def measure(ops, kmod, N, D, K, reps):
    """Times of each kernel and its plain version on one float32 input, U
    in the EM loop's layout (a transposed view). ``ms`` / ``plain_ms``:
    device time of a wrapper call (its one launch) and of a plain call;
    ``kernel_only_ms``: the launch alone, through the C entry point;
    ``host_ms`` / ``plain_host_ms``: back-to-back eager calls, bound by the
    host at small N; ``nodes``: what a wrapper call puts on the stream."""
    import torch

    X, means, U = make_params(N, D, K, 5, torch.float32)
    U = path_layout(U)
    params = kmod.param_args(*kmod.param_views(means, U))
    spec = int((D, K) in kmod.SPECIALISED)
    outs = {"gmm_score": (torch.empty((N, K), device=X.device),),
            "gmm_best": (torch.empty((N,), device=X.device),
                         torch.empty((N,), dtype=torch.int32,
                                     device=X.device))}
    res = {}
    for name, fn in (("gmm_score", ops.gmm_score), ("gmm_best", ops.gmm_best)):
        launch = kmod._fn(f"{name}_launch")
        ptrs = [t.data_ptr() for t in outs[name]]

        def raw():
            launch(X.data_ptr(), 0, *params, *ptrs, N, D, K, spec,
                   torch.cuda.current_stream().cuda_stream)

        b, by = bound_ms(name, N, D, K)
        res[name] = {
            "ms": device_ms(lambda: fn(X, means, U), reps),
            "plain_ms": device_ms(lambda: fn(X, means, U, backend="plain"),
                                  reps),
            "kernel_only_ms": device_ms(raw, reps),
            "host_ms": host_ms(lambda: fn(X, means, U), reps),
            "plain_host_ms": host_ms(
                lambda: fn(X, means, U, backend="plain"), reps),
            "nodes": nodes_per_call(lambda: fn(X, means, U)),
            "bound_ms": b, "bound_by": by}
    return res


def measure_em(ops, smod, N, D, K, reps):
    """The EM kernels' times on one float32 input, as `measure` gives them
    for the scoring kernels: ``ms`` (a wrapper call: the outputs' and
    workspace's allocation, the counter's memset and the launch),
    ``plain_ms``, ``kernel_only_ms`` (the memset and the launch alone),
    ``host_ms`` / ``plain_host_ms`` (back-to-back eager calls), ``nodes``."""
    import torch

    from repro_torch.kernels import gmm_score as kmod

    X, log_w, means, U = em_inputs(N, D, K, 5)
    U = path_layout(U)
    params = kmod.param_args(*kmod.param_views(means, U))
    spec = int((D, K) in kmod.SPECIALISED)
    outs = [torch.empty(shape, device=X.device)
            for shape in ((K,), (K, D), (K, D, D), ())]
    nb, work = smod.workspace(N, D, K, X.device)
    res = {}
    for name in ("gmm_stats", "gmm_update"):
        fn = getattr(ops, name)
        launch = smod._fn(f"{name}_launch")

        def raw():
            launch(X.data_ptr(), 0, log_w.data_ptr(), log_w.stride(0),
                   *params, *(o.data_ptr() for o in outs), work.data_ptr(),
                   N, N, D, K, nb, spec,
                   torch.cuda.current_stream().cuda_stream)

        b, by = bound_ms(name, N, D, K)
        res[name] = {
            "ms": device_ms(lambda: fn(X, log_w, means, U), reps),
            "plain_ms": device_ms(
                lambda: fn(X, log_w, means, U, backend="plain"), reps),
            "kernel_only_ms": device_ms(raw, reps),
            "host_ms": host_ms(lambda: fn(X, log_w, means, U), reps),
            "plain_host_ms": host_ms(
                lambda: fn(X, log_w, means, U, backend="plain"), reps),
            "nodes": nodes_per_call(lambda: fn(X, log_w, means, U)),
            "bound_ms": b, "bound_by": by}
    return res


def profile_summary(prof, wall_s, n):
    """Device time per iteration, the device's busy share of the wall time,
    kernels per iteration and the costliest kernels, from a torch.profiler
    trace (null where the trace holds no device time). Only the device's
    own events count: an aten op's device time is its kernels' again."""
    from torch.autograd import DeviceType

    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    total_us = sum(r[1] for r in rows)
    return {
        "wall_ms": 1e3 * wall_s / n,
        "device_ms": total_us / 1e3 / n if total_us else None,
        "device_busy_share": total_us / 1e6 / wall_s if total_us else None,
        "device_kernels": sum(r[2] for r in rows) / n,
        "top_ms": [[k[:64], us / 1e3 / n]
                   for k, us, _ in sorted(rows, key=lambda r: -r[1])[:6]]}


def profile_phase(N, D, K):
    """Where the main path's time goes on the card. The full-width training
    step, CUDA-graphed (as the main path runs it) and eager: after 3 warm-up
    steps, the per-step wall time of 10 steps (host clock, synchronised
    each step) with the profiler off, then 5 steps under torch.profiler.
    Then one GMMDetector fit at the main path's largest layer shape, and
    the streaming detector's warmup (cold fits) and one detection tick
    (bootstrap warm refits) on the stream path's shapes, under
    torch.profiler."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.config import TrainConfig, get_arch
    from repro_torch.core.detector import GMMDetector
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.model import Runtime, batch_to_device
    from repro_torch.train.step import (init_train_state, make_optimizer_for,
                                        make_train_step)

    dev = torch.device("cuda")
    cfg = get_arch("gpt2")
    opt = make_optimizer_for(TrainConfig(learning_rate=1e-3, total_steps=18,
                                         warmup_steps=2))
    data = SyntheticLMData(cfg, seq_len=128, global_batch=8, seed=0)
    batches = [batch_to_device(data.batch(s), dev) for s in range(18)]
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = {}
    for name, graph in (("train_step", True), ("train_step_eager", False)):
        state = init_train_state(cfg, opt, device=dev)
        step = make_train_step(cfg, Runtime(torch.bfloat16), opt,
                               cuda_graph=graph)
        for b in batches[:3]:
            state, _ = step(state, b)
        torch.cuda.synchronize()
        step_ms = []
        for b in batches[3:13]:
            t0 = time.perf_counter()
            state, _ = step(state, b)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for b in batches[13:]:
                state, _ = step(state, b)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
        out[name] = {"step_ms_p10_p50_p90": np.percentile(
            step_ms, [10, 50, 90]).tolist(),
            **profile_summary(prof, train_s, 5)}
        del state, step
    del batches

    rng = np.random.default_rng(0)
    X = (6.0 * rng.standard_normal((K, D)))[rng.integers(0, K, N)] \
        + rng.standard_normal((N, D))
    GMMDetector(n_components=K, device=dev).fit(X)  # warm-up
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        GMMDetector(n_components=K, device=dev).fit(X)
        fit_s = time.perf_counter() - t0
    out["gmm_fit"] = profile_summary(prof, fit_s, 1)
    out["gmm_fit"]["shape"] = [N, D, K]
    out.update(profile_stream_tick(dev, acts))
    return out


def profile_stream_tick(dev, acts):
    """The streaming detector at the stream path's shapes: STEP and XLA
    rows of a 17.2 ms step for one node, warmup on 96 steps (a cold fit of
    40 EM iterations per layer), one tick at step 120 to settle, then the
    tick at step 140 (score, drift check, a 4-iteration bootstrap warm refit
    and its statistics per layer), each under torch.profiler."""
    import numpy as np
    import torch
    from torch.profiler import profile

    from repro_torch.core.events import Event, Layer
    from repro_torch.stream import FleetAggregator, OnlineGMMDetector, wire

    rng = np.random.default_rng(0)

    def batch(lo, hi, seq):
        evs = [Event(layer=layer, name=name, ts=0.0172 * s,
                     dur=0.0172 * float(rng.lognormal(0.0, 0.01)), step=s)
               for s in range(lo, hi)
               for layer, name in ((Layer.STEP, "train_step"),
                                   (Layer.XLA, "executable_run"))]
        return wire.encode_events(evs, node_id=0, seq=seq)

    agg = FleetAggregator(horizon_s=300.0)
    det = OnlineGMMDetector(n_components=3, contamination=0.02,
                            min_events=32, seed=0, device=dev)
    agg.ingest(batch(0, 96, 0))
    out = {}
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        det.warmup(agg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out["stream_warmup"] = profile_summary(prof, wall, 1)
    agg.ingest(batch(96, 120, 1))
    det.detect(agg)
    agg.ingest(batch(120, 140, 2))
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        modes = {l.value: d.refit for l, d in det.detect(agg).items()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out["stream_tick"] = profile_summary(prof, wall, 1)
    out["stream_tick"]["modes"] = modes
    return out


def stream_line(st, launches, plain_calls):
    """The stream_path phase's JSON line. Which refit branches ran is
    reckoned from the counts: a cold fit is cold_iters=40 gmm_update calls,
    a bootstrap warm refit refit_iters=4, and an incremental fold none."""
    losses = st["losses"]
    fits = len(st["refits"])  # warmup: one cold fit per modelled layer
    cold = sum(r["cold"] for r in st["refits"].values())
    warm = sum(r["warm"] for r in st["refits"].values())
    bootstrap = (launches["gmm_update"] - 40 * (fits + cold)) / 4
    m = st["match"]
    top = st["incidents"][0] if st["incidents"] else None
    top_suspect = top.suspect_layer.value if top else None
    return {
        "phase": "stream_path", "steps": st["steps"], "batch": st["batch"],
        "seq": st["seq"], "loss_first": float(losses[0]),
        "loss_last": float(losses[-1]), "steps_per_s": st["steps_per_s"],
        "setup_ms": st["setup_ms"], "ticks": st["ticks"], "detect_ms_per_tick": st["detect_ms_per_tick"],
        "refits": st["refits"], "tick_modes": st["tick_modes"],
        "branches": {"cold_fits": fits + cold, "bootstrap_warm": bootstrap,
                     "folds": warm - bootstrap},
        "events_ingested": st["events_ingested"],
        "wire_bytes_per_event": st["wire_bytes_per_event"],
        "lost_batches": st["lost_batches"],
        "window_sizes": st["window_sizes"],
        "failed_samples": st["failed_samples"],
        "windows": st["windows"], "recall": m.recall,
        "precision": m.precision, "window_hits": m.window_hits,
        "spurious": m.spurious,
        "incidents": [i.to_json() for i in st["incidents"]],
        "top_suspect": top_suspect,
        "top_heaviest_layer": (max(top.layer_deficit,
                                   key=top.layer_deficit.get)
                               if top else None),
        "unmet": ([] if top_suspect == "operator" else
                  [f"top incident's suspect layer is operator (the layer "
                   f"op_latency perturbs at its source): the engine names "
                   f"{top_suspect}"]),
        "runtime_probe": st["runtime_probe"],
        "launches": launches, "plain_calls": plain_calls}


def check_stream(st, launches, plain_calls):
    """The stream path's gates. One criterion is reported, not enforced:
    that the top incident's suspect layer is operator, where op_latency is
    injected (the incident engine treats STEP as a symptom and blames a
    cause layer flagged in the cluster); ``stream_line`` lists it under
    ``unmet``. The gate here is that the top incident's deficit lies mostly
    on a layer op_latency perturbs: operator or step."""
    if not all(math.isfinite(float(v)) for v in st["losses"]):
        raise SmokeFailure("non-finite training loss on the stream path")
    if not all(launches.values()):
        raise SmokeFailure(f"a kernel was not launched on the stream path: "
                           f"{launches}")
    if any(plain_calls.values()):
        raise SmokeFailure(f"plain versions ran on the stream path: "
                           f"{plain_calls}")
    m = st["match"]
    if not (m.windows_detected >= 2 and m.precision >= 0.5):
        raise SmokeFailure(f"stream detection too weak: recall {m.recall}, "
                           f"precision {m.precision}")
    top = st["incidents"][0]
    heaviest = max(top.layer_deficit, key=top.layer_deficit.get)
    if heaviest not in PERTURBS:
        raise SmokeFailure(f"top incident's deficit lies mostly on "
                           f"{heaviest}, not operator or step: "
                           f"{top.layer_deficit}")
    if st["lost_batches"] or st["failed_samples"]:
        raise SmokeFailure(f"lost {st['lost_batches']} wire batches, "
                           f"{st['failed_samples']} device samples")


def check_nvalid_zero(ops):
    """nvalid = 0 with N > 0, on both sides of the specialised / general
    boundary: the reference multiplies every row's responsibilities by 0,
    so an all-NaN U or NaN rows make nk, sx and sxx NaN (its ll is 0), and
    finite inputs give zeros. The kernels must give NaN exactly where the
    plain version does and equal it elsewhere. Returns the cases."""
    import torch

    cases = 0
    for N, D, K in ((256, 4, 3), (300, 6, 5)):
        for poison in ("nan_u", "nan_rows", "finite"):
            X, log_w, means, U = em_inputs(N, D, K, 51 + D)
            if poison == "nan_u":
                U.fill_(float("nan"))
            elif poison == "nan_rows":
                X.fill_(float("nan"))
            for name in ("gmm_stats", "gmm_update"):
                fn = getattr(ops, name)
                want = fn(X, log_w, means, U, nvalid=0, backend="plain")
                got = fn(X, log_w, means, U, nvalid=0)
                for i, (g, w) in enumerate(zip(got, want)):
                    nan = torch.isnan(w)
                    if not (torch.equal(torch.isnan(g), nan)
                            and torch.equal(g[~nan], w[~nan])):
                        raise SmokeFailure(
                            f"{name} nvalid=0 {poison} N={N} D={D} K={K} "
                            f"output {i} differs from plain")
                if poison != "finite" and not bool(
                        torch.isnan(got[0]).all()):
                    raise SmokeFailure(f"{name} nvalid=0 {poison}: nk is "
                                       "not NaN")
                cases += 1
    torch.cuda.synchronize()
    return cases


# which injected fault kinds perturb a layer's rows on one card (the
# collective schedule is empty, so net_latency perturbs nothing; device
# telemetry faults perturb only the DEVICE rows)
PERTURBS = {"step": ("op_latency", "python_latency", "xla_latency"),
            "operator": ("op_latency",)}
SESSION_RUNS = (("off", 100), ("batch", 200), ("stream", 240))
# steps before the steady state: the graphed step's eager warm-up calls and
# its capture (`train/step.py::CudaGraphed`), hundreds of ms each
SETUP_STEPS = 3


def steady_steps_per_s(step_end_s):
    """Steps/s after the first SETUP_STEPS steps, so that runs of other
    lengths compare."""
    return ((len(step_end_s) - SETUP_STEPS)
            / (step_end_s[-1] - step_end_s[SETUP_STEPS - 1]))


def layer_rates(report, injector, steps):
    """Per layer of PERTURBS: the share of the steps of the faults that
    perturb it that it flagged (hit), of the fault-free steps it flagged
    (false), and the hit share over every injected step (hit_all)."""
    import numpy as np
    from repro_torch.core import FaultInjector

    labels = injector.labels(steps)
    clean = set(np.flatnonzero(~labels).tolist())
    out = {}
    for layer, kinds in PERTURBS.items():
        ls = report.layers.get(layer)
        if ls is None:
            out[layer] = None
            continue
        flagged = set(ls.anomalous_steps)
        seen = set(np.flatnonzero(FaultInjector(
            [f for f in injector.faults if f.kind in kinds]).labels(
                steps)).tolist())
        every = set(np.flatnonzero(labels).tolist())
        out[layer] = {
            "hit": len(flagged & seen) / max(len(seen), 1),
            "false": len(flagged & clean) / max(len(clean), 1),
            "hit_all": len(flagged & every) / max(len(every), 1),
            "fault_steps": len(seen)}
    return out


def session_phase(train, reset_counts, read_counts, read_variants):
    """`repro_torch.launch.train` in-process at full width (GPT-2 124M,
    bf16, batch 8, sequence 128, --inject-faults), once per mode of
    SESSION_RUNS, with the launcher's legacy probe options (python 1-in-25,
    device every 0.05 s). The runtime probe's row writer is wrapped for the
    phase to count rows written inside a detection zone or on the detection
    plane's worker thread (both must be 0). Returns the phase's line; raises
    on a failed gate."""
    import threading

    import torch
    from repro_torch.core.probes import runtime_probe
    from repro_torch.detect import in_detection_zone

    leaks = {"in_zone": 0, "on_worker": 0}
    record = runtime_probe.CudaRuntimeProbe._record

    def counted(self, call, t0, t1):
        leaks["in_zone"] += in_detection_zone()
        leaks["on_worker"] += threading.current_thread().name \
            == "eacgm-detect"
        record(self, call, t0, t1)

    line = {"phase": "session_path", "modes": {}}
    runtime_probe.CudaRuntimeProbe._record = counted
    try:
        for mode, steps in SESSION_RUNS:
            spec = {"mode": mode,
                    "probe_options": train.LEGACY_PROBE_OPTIONS}
            args = train.parser().parse_args(
                ["--arch", "gpt2", "--device", "cuda", "--steps", str(steps),
                 "--batch", "8", "--seq", "128", "--inject-faults",
                 "--log-every", "0", "--monitor-spec", json.dumps(spec)])
            reset_counts()
            out = train.train(args)
            launches, plain = read_counts()
            losses = out["losses"]
            if not all(math.isfinite(v) for v in losses):
                raise SmokeFailure(f"session_path {mode}: non-finite loss")
            res = {"steps": steps, "steps_per_s": out["steps_per_s"],
                   "steady_steps_per_s": steady_steps_per_s(
                       out["step_end_s"]),
                   "train_s": out["seconds"], "setup_s": out["setup_s"],
                   "finalize_s": out["finalize_s"],
                   "loss_first": losses[0], "loss_last": losses[-1]}
            if mode != "off":
                res.update(session_summary(out, mode, steps, launches, plain,
                                           read_variants(
                                               f"session_path {mode}")))
            line["modes"][mode] = res
            del out
            torch.cuda.empty_cache()
    finally:
        runtime_probe.CudaRuntimeProbe._record = record
    # monitoring overhead in the steady state (the set-up steps apart)
    off = line["modes"]["off"]["steady_steps_per_s"]
    line["overhead"] = {
        mode: 1.0 - line["modes"][mode]["steady_steps_per_s"] / off
        for mode in ("batch", "stream")}
    line["runtime_rows_in_zone"] = leaks["in_zone"]
    line["runtime_rows_on_worker"] = leaks["on_worker"]
    try:
        line["unmet"] = check_session(line)
    finally:
        emit(line)
    return line


def session_summary(out, mode, steps, launches, plain, variants):
    """One monitored mode of the session phase, as printed. The batch
    mode's verdict is its final detections (hit and false rates per layer);
    the stream mode's is its incidents, matched against the windows of the
    faults that perturb the operator and step layers (its final detections
    cover the last tick only)."""
    from repro_torch.core import FaultInjector
    from repro_torch.stream import match_incidents

    report, session = out["report"], out["session"]
    emitted = report.overhead[0]["emitted_per_probe"]
    xla = session.collector["xla"]
    injector = out["injector"]
    if mode == "batch":
        verdict = {"rates": layer_rates(report, injector, steps)}
    else:
        windows = FaultInjector([f for f in injector.faults
                                 if f.kind in PERTURBS["step"]]).windows()
        m = match_incidents(report.incidents, windows,
                            grace_steps=session.spec.detector.flush_every)
        verdict = {"match": {"windows": windows, "recall": m.recall,
                             "precision": m.precision,
                             "window_hits": m.window_hits,
                             "spurious": m.spurious}}
    return {
        "rows_per_layer": {k: v.events for k, v in report.layers.items()},
        "rows_per_probe": emitted, **verdict,
        "faults": [f.to_json() for f in injector.faults],
        "incidents": [
            {"id": i.incident_id, "suspect": i.suspect_layer.value,
             "heaviest": max(i.layer_deficit, key=i.layer_deficit.get),
             "severity": i.severity, "n_flags": i.n_flags,
             "steps": [min(i.steps), max(i.steps)] if i.steps else []}
            for i in sorted(report.incidents, key=lambda i: -i.severity)],
        "diagnoses": [{"incident": d.incident_id, "fault_kind": d.fault_kind,
                       "confidence": d.confidence, "action": d.action.kind}
                      for d in report.diagnoses],
        "governor_actions": session.action_counts(),
        "detect_plane": report.overhead.get("detect_plane"),
        "runtime_probe": {"rows": xla.emitted,
                          "dropped_in_zone": xla.dropped_in_zone},
        "launches": launches, "plain_calls": plain, "variants": variants}


def check_session(line):
    """The session phase's gates: the batch mode's STEP layer as the main
    path's (hit > 0.5 and > 2x false, against the faults that perturb it);
    OPERATOR and XLA rows in every monitored mode; its kernels launched, no
    plain version; no runtime row inside a detection zone or on the worker
    thread. One criterion is reported, not enforced: a governor action in
    the batch mode. The batch session forms incidents only past its final
    fit's clean prefix (the reference's `_batch_incidents` floor), and the
    governor's rate path acts above a 0.25 anomaly rate; a fault inside the
    prefix gives neither (``unmet`` in the line)."""
    if line["runtime_rows_in_zone"] or line["runtime_rows_on_worker"]:
        raise SmokeFailure(f"runtime-probe rows inside a detection zone: "
                           f"{line['runtime_rows_in_zone']}, on the worker: "
                           f"{line['runtime_rows_on_worker']}")
    for mode, want in (("batch", ("gmm_score", "gmm_best")),
                       ("stream", ("gmm_score", "gmm_best", "gmm_stats",
                                   "gmm_update"))):
        m = line["modes"][mode]
        if not all(m["launches"][k] for k in want):
            raise SmokeFailure(f"session_path {mode}: a kernel was not "
                               f"launched: {m['launches']}")
        if any(m["plain_calls"].values()):
            raise SmokeFailure(f"session_path {mode}: plain versions ran: "
                               f"{m['plain_calls']}")
        rows = m["rows_per_probe"]
        if not (rows["operator"] and rows["xla"]
                and m["runtime_probe"]["rows"]):
            raise SmokeFailure(f"session_path {mode}: no operator or "
                               f"runtime rows: {rows}")
    b = line["modes"]["batch"]
    step = b["rates"]["step"]
    if step is None or not (step["hit"] > 0.5
                            and step["hit"] > 2 * step["false"]):
        raise SmokeFailure(f"session_path batch: STEP detection too weak: "
                           f"{step}")
    return [] if (b["governor_actions"] or b["diagnoses"]) else [
        "batch: a governor action (none: no incident past the final fit's "
        "prefix, layer anomaly rates under the governor's 0.25)"]


def build_phase(build, kmod, card):
    """Phase 1: every CUDA source built at once; fails unless ptxas
    reported every specialised kernel (both dtypes; score, best and EM for
    each (D, K)) with no stack frame and no spill bytes."""
    t0 = time.perf_counter()
    logs = build.build_all()
    seconds = time.perf_counter() - t0
    kernels = ptxas_summary(logs)
    fixed = {k: v for k, v in kernels.items() if "_fixed<" in k}
    spills = {k: v for k, v in fixed.items()
              if v.get("spill", 0) or v.get("stack", 0)}
    emit({"phase": "build", "seconds": seconds, "sources": sorted(logs),
          "card": card, "instantiations": len(kernels),
          "specialised": len(fixed),
          "max_registers": {base: max((v.get("registers", 0)
                                       for k, v in kernels.items()
                                       if k.startswith(base + "<")),
                                      default=None)
                            for base in ("score_fixed", "score_general",
                                         "em_fixed", "em_general")},
          "ptxas": {k: [v.get("registers"), v.get("stack"), v.get("spill")]
                    for k, v in sorted(kernels.items())}})
    if len(fixed) != 6 * len(kmod.SPECIALISED):
        raise SmokeFailure(f"ptxas reported {len(fixed)} specialised "
                           f"kernels, not 6 x {len(kmod.SPECIALISED)}")
    if spills:
        raise SmokeFailure(f"specialised kernels use local memory "
                           f"(registers, stack, spill bytes): {spills}")


def kernel_check_phase(ops, kmod, smod):
    """Phase 2: every kernel against its plain version; the EM kernels
    bitwise repeatable, eager and from a CUDA graph; U in the EM loop's
    layout and NaN; both sides of the specialised / general boundary."""
    import torch

    worst = {"gmm_score": 0.0, "gmm_best": 0.0}
    cases = 0
    for dtype, shapes in ((torch.float32, SHAPES), (torch.bfloat16,
                                                    BF16_SHAPES)):
        for i, (N, D, K) in enumerate(shapes):
            errs = check_case(ops, N, D, K, dtype, seed=i)
            worst = {k: max(worst[k], errs[k]) for k in worst}
            cases += 1
    check_ties_and_nan(ops)
    em_rel = {"gmm_stats": 0.0, "gmm_update": 0.0}
    for i, (N, D, K, dtype, nvalid) in enumerate(em_cases()):
        errs, rel = check_em_case(ops, N, D, K, dtype, seed=100 + i,
                                  nvalid=nvalid)
        worst.update({k: max(worst.get(k, 0.0), errs[k]) for k in errs})
        em_rel = {k: max(em_rel[k], rel[k]) for k in em_rel}
    layout_cases = check_layout_and_nan(ops)
    boundary = check_boundary(ops, kmod, smod)
    replays = check_em_graph_replay(ops)
    nvalid_zero = check_nvalid_zero(ops)
    emit({"phase": "kernel_check", "cases": cases + 2,
          "em_cases": len(em_cases()), "nvalid_zero_cases": nvalid_zero,
          "max_abs_err": worst,
          "em_max_rel_err": em_rel, "em_bitwise_repeatable": True,
          "transposed_and_nan_u_cases": layout_cases,
          "boundary": boundary, "em_graph_replays_bitwise": replays})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: no card")
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        raise SmokeFailure("src/repro_torch not found beside chip_smoke.py")
    sys.path.insert(0, src)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import quickstart
    from repro_torch.core.events import Layer
    from repro_torch.kernels import build, gmm_score as kmod, ops, ref
    from repro_torch.kernels import gmm_stats as smod

    card = nvidia_smi()
    power_limit_w = float(card.split(",")[1].strip().split()[0])

    build_phase(build, kmod, card)
    kernel_check_phase(ops, kmod, smod)

    # the train step's CUDA graph against the eager step
    rel_loss, rel_grad = check_graphed_step()
    emit({"phase": "graph_check", "max_rel_loss_err": rel_loss,
          "max_rel_grad_err": rel_grad})

    def reset_counts():
        for counts in (kmod.LAUNCHES, smod.LAUNCHES, ref.CALLS):
            for k in counts:
                counts[k] = 0
        for variants in (kmod.VARIANTS, smod.VARIANTS):
            for v in variants.values():
                v.update(specialised=0, general=0)

    def read_counts():
        return {**kmod.LAUNCHES, **smod.LAUNCHES}, dict(ref.CALLS)

    def read_variants(path):
        variants = {k: dict(v) for counts in (kmod.VARIANTS, smod.VARIANTS)
                    for k, v in counts.items()}
        if any(v["general"] for v in variants.values()):
            raise SmokeFailure(f"{path} launched a general kernel: "
                               f"{variants}")
        return variants

    # 3. the main path on the card
    reset_counts()
    out = quickstart.run(device="cuda", peak_w=power_limit_w)
    launches, plain_calls = read_counts()
    variants = read_variants("main_path")
    losses = out["losses"]
    hit, false = out["step_hit_rate"], out["step_false_rate"]
    emit({"phase": "main_path", "steps": out["steps"],
          "batch": out["batch"], "seq": out["seq"],
          "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
          "steps_per_s": out["steps_per_s"], "detect_s": out["detect_s"],
          "events": out["n_events"], "step_hit_rate": hit,
          "step_false_rate": false, "actions": len(out["actions"]),
          "step_ms_p10_p50_p90": out["step_ms_p10_p50_p90"],
          "layer_shapes": out["layer_shapes"],
          "rows_per_layer": out["rows_per_layer"],
          "runtime_probe": out["runtime_probe"], "launches": launches,
          "variants": variants, "plain_calls": plain_calls,
          "failed_samples": out["failed_samples"]})
    if not all(math.isfinite(float(v)) for v in losses):
        raise SmokeFailure("non-finite training loss")
    if Layer.STEP not in out["results"]:
        raise SmokeFailure("no STEP-layer detection result")
    if not (hit > 0.5 and hit > 2 * false):
        raise SmokeFailure(f"STEP detection too weak: hit {hit}, "
                           f"false {false}")
    if not out["actions"]:
        raise SmokeFailure("the governor returned no action")
    if not (launches["gmm_score"] and launches["gmm_best"]):
        raise SmokeFailure(f"a kernel was not launched: {launches}")
    if any(plain_calls.values()):
        raise SmokeFailure(f"plain versions ran on the main path: "
                           f"{plain_calls}")
    if out["failed_samples"]:
        raise SmokeFailure(f"device probe lost {out['failed_samples']} "
                           "samples")
    if not (out["rows_per_layer"]["operator"] and out["runtime_probe"]["rows"]
            and Layer.OPERATOR in out["results"]):
        raise SmokeFailure(f"main path: no operator or runtime-probe rows: "
                           f"{out['rows_per_layer']}, {out['runtime_probe']}")
    shape = max(out["layer_shapes"].values())
    del out

    # 4. the stream path on the card
    reset_counts()
    st = quickstart.run_stream(device="cuda", peak_w=power_limit_w)
    s_launches, s_plain = read_counts()
    s_variants = read_variants("stream_path")
    emit({**stream_line(st, s_launches, s_plain), "variants": s_variants})
    check_stream(st, s_launches, s_plain)
    del st

    # 5. the training entry point with the session, three modes
    from repro_torch.launch import train
    session_phase(train, reset_counts, read_counts, read_variants)

    # 6. times at each path's largest shape and at scale
    N, D, K = shape
    errs = check_case(ops, N, D, K, torch.float32, seed=99)
    errs.update(check_em_case(ops, *STREAM_FIT_SHAPE, torch.float32,
                              seed=98)[0])
    at_path = measure(ops, kmod, N, D, K, reps=200)
    at_path.update(measure_em(ops, smod, *STREAM_FIT_SHAPE, reps=200))
    shapes = {"gmm_score": shape, "gmm_best": shape,
              "gmm_stats": STREAM_FIT_SHAPE, "gmm_update": STREAM_FIT_SHAPE}
    paths = {"gmm_score": launches, "gmm_best": launches,
             "gmm_stats": s_launches, "gmm_update": s_launches}
    scaling = {f"N={n} D={d} K={k}": measure(ops, kmod, n, d, k, reps=50)
               for n, d, k in SCALING}
    scaling.update({f"N={n} D={d} K={k}": measure_em(ops, smod, n, d, k,
                                                     reps=50)
                    for n, d, k in EM_SCALING})
    emit({"phase": "kernel_scaling", "card": card, "shapes": scaling})
    for name, res in at_path.items():
        want = {"kernels": 1.0, "memsets": float(name in ("gmm_stats",
                                                          "gmm_update")),
                "memcpys": 0.0}
        if res["nodes"] != want:
            raise SmokeFailure(f"{name}: a wrapper call put {res['nodes']} "
                               f"on the stream, not {want}")

    emit({"phase": "profile", "card": card, **profile_phase(N, D, K)})

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": paths[name][name],
         "max_abs_err": errs[name], "ms": at_path[name]["ms"],
         "plain_ms": at_path[name]["plain_ms"],
         "bound_ms": at_path[name]["bound_ms"],
         "bound_by": at_path[name]["bound_by"], "library_ms": None,
         "kernel_only_ms": at_path[name]["kernel_only_ms"],
         "host_ms": at_path[name]["host_ms"], "shape": list(shapes[name]),
         "path": "main_path" if paths[name] is launches else "stream_path",
         "launches_by_path": {"main_path": launches[name],
                              "stream_path": s_launches[name]},
         "kernels_per_call": at_path[name]["nodes"]["kernels"],
         "memsets_per_call": at_path[name]["nodes"]["memsets"],
         "variants_by_path": {"main_path": variants[name],
                              "stream_path": s_variants[name]}}
        for name in ("gmm_score", "gmm_best", "gmm_stats", "gmm_update")]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
