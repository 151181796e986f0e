#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: build, check, run.

    python3 chip_smoke.py

Phases, each printing one JSON line of its own:

1. ``build``: compile every CUDA source of ``src/repro_torch/kernels/csrc``
   with nvcc for sm_90a (one nvcc per source, all started together) and
   report the seconds and the ptxas register / shared-memory lines.
2. ``kernel_check``: every kernel against its plain PyTorch version on the
   card, on the kernel tests' shape grid (up to D=32, K=16), N=0, the main
   path's D=4/K=4 shapes (N = 4096 and 2^20), bf16 X, exact ties and NaN
   components. Tolerances: float32 rtol 1e-5 / atol 1e-4 (the kernel tests'
   own); bf16 X rtol 5e-2 / atol 5e-1; argmax may differ only at near-ties
   (top two within 1e-3); ties and NaN must match exactly.
3. ``graph_check``: the train step's CUDA-graphed forward and backward
   against the eager one at full width, on new batches and perturbed weights
   (loss within 1e-3 relative, gradients within 1e-2 of their norm).
4. ``main_path``: `repro_torch.quickstart.run` on ``cuda`` — full-width GPT-2
   124M in bf16, batch 8, sequence 128, 120 steps, op_latency faults (seed 7,
   0.03 s), per-layer GMM fit and detection on the card. The launch counts
   are set to 0 just before and read just after: both kernels must have
   launched and neither plain version may have run. The loss must be finite,
   the STEP layer's hit rate > 0.5 and > 2x its false rate, the governor must
   act, and the device probe must have lost no sample.
5. ``kernel_scaling``: kernel and plain times at N = 4096 and 2^20 (D=4, K=4).
6. ``profile``: torch.profiler over 5 full-width training steps and one
   GMMDetector fit at the main path's largest layer shape: device time, the
   device's busy share of the wall time, and the costliest kernels.

Then the ``kernels`` line (each kernel's launches on the main path, its
largest error against the plain version at the main path's largest layer
shape, its device time per wrapper call, the plain version's, its bound, and
beside them the launch alone and the eager per-call time), the card's name
and power limit as nvidia-smi prints them, and as the last line
``{"ok": true, "device": {"platform": "gpu", ...}}``. Any failure exits
non-zero before that line. TF32 is off for matmuls (PyTorch's default) and
set off for cuDNN here, so float32 comparisons are float32.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = "src/repro_torch/kernels/csrc/gmm_score.cu"
REPLACES = {"gmm_score": "src/repro/kernels/gmm_score.py:28",
            "gmm_best": "src/repro/kernels/gmm_score.py:45"}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
SHAPES = [(128, 2, 2), (1000, 4, 3), (4096, 8, 8), (777, 3, 5),
          (2048, 16, 4), (513, 8, 16), (64, 32, 2), (1000, 32, 16),
          (0, 4, 3), (4096, 4, 4), (1 << 20, 4, 4)]
BF16_SHAPES = [(512, 6, 4), (4096, 4, 4), (1000, 32, 16)]
SCALING = [(4096, 4, 4), (1 << 20, 4, 4)]


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
    output written once, over 3.35 TB/s; K (2 D^2 + 3 D + 3) float32 flops
    a row over 67 TFLOP/s; the larger of the two."""
    params = 4 * (K * D * D + K * D + K)
    out = N * K * 4 if kernel == "gmm_score" else N * 8
    bytes_ = N * D * x_bytes + params + out
    ops = N * K * (2 * D * D + 3 * D + 3)
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, ops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def measure(ops, kmod, N, D, K, reps):
    """Times of each kernel and its plain version on one float32 input.
    ``ms`` / ``plain_ms``: device time of a wrapper call (the torch ops that
    form mu U and log|det U|, plus the launch) and of a plain call;
    ``kernel_only_ms``: the launch alone; ``host_ms`` / ``plain_host_ms``:
    back-to-back eager calls, bound by the host at small N."""
    import torch

    X, means, U = make_params(N, D, K, 5, torch.float32)
    Uf, mu_u, logdet, _, _, _ = kmod._prepare(X, means, U)
    outs = {"gmm_score": (torch.empty((N, K), device=X.device),),
            "gmm_best": (torch.empty((N,), device=X.device),
                         torch.empty((N,), dtype=torch.int32,
                                     device=X.device))}
    res = {}
    for name, fn in (("gmm_score", ops.gmm_score), ("gmm_best", ops.gmm_best)):
        launch = kmod._fn(f"{name}_launch")
        ptrs = [t.data_ptr() for t in outs[name]]

        def raw():
            launch(X.data_ptr(), 0, Uf.data_ptr(), mu_u.data_ptr(),
                   logdet.data_ptr(), *ptrs, N, D, K,
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
    Then one GMMDetector fit at the main path's largest layer shape under
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
    return out


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

    card = nvidia_smi()
    power_limit_w = float(card.split(",")[1].strip().split()[0])

    # 1. build
    t0 = time.perf_counter()
    logs = build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": sorted(logs), "card": card,
          "ptxas": [ln.strip() for log in logs.values()
                    for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]})

    # 2. kernels against plain on the grid
    worst = {"gmm_score": 0.0, "gmm_best": 0.0}
    cases = 0
    for dtype, shapes in ((torch.float32, SHAPES), (torch.bfloat16,
                                                    BF16_SHAPES)):
        for i, (N, D, K) in enumerate(shapes):
            errs = check_case(ops, N, D, K, dtype, seed=i)
            worst = {k: max(worst[k], errs[k]) for k in worst}
            cases += 1
    check_ties_and_nan(ops)
    emit({"phase": "kernel_check", "cases": cases + 2,
          "max_abs_err": worst})

    # the train step's CUDA graph against the eager step
    rel_loss, rel_grad = check_graphed_step()
    emit({"phase": "graph_check", "max_rel_loss_err": rel_loss,
          "max_rel_grad_err": rel_grad})

    # 3. the main path on the card
    for counts in (kmod.LAUNCHES, ref.CALLS):
        for k in counts:
            counts[k] = 0
    out = quickstart.run(device="cuda", peak_w=power_limit_w)
    launches, plain_calls = dict(kmod.LAUNCHES), dict(ref.CALLS)
    losses = out["losses"]
    hit, false = out["step_hit_rate"], out["step_false_rate"]
    emit({"phase": "main_path", "steps": out["steps"],
          "batch": out["batch"], "seq": out["seq"],
          "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
          "steps_per_s": out["steps_per_s"], "detect_s": out["detect_s"],
          "events": out["n_events"], "step_hit_rate": hit,
          "step_false_rate": false, "actions": len(out["actions"]),
          "step_ms_p10_p50_p90": out["step_ms_p10_p50_p90"],
          "layer_shapes": out["layer_shapes"], "launches": launches,
          "plain_calls": plain_calls,
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
    if not all(launches.values()):
        raise SmokeFailure(f"a kernel was not launched: {launches}")
    if any(plain_calls.values()):
        raise SmokeFailure(f"plain versions ran on the main path: "
                           f"{plain_calls}")
    if out["failed_samples"]:
        raise SmokeFailure(f"device probe lost {out['failed_samples']} "
                           "samples")

    # 4. times at the main path's shapes and at scale
    N, D, K = max(out["layer_shapes"].values())
    errs = check_case(ops, N, D, K, torch.float32, seed=99)
    at_path = measure(ops, kmod, N, D, K, reps=200)
    emit({"phase": "kernel_scaling", "card": card, "shapes": {
        f"N={n} D={d} K={k}": measure(ops, kmod, n, d, k, reps=50)
        for n, d, k in SCALING}})

    emit({"phase": "profile", "card": card, **profile_phase(N, D, K)})

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": errs[name], "ms": at_path[name]["ms"],
         "plain_ms": at_path[name]["plain_ms"],
         "bound_ms": at_path[name]["bound_ms"],
         "bound_by": at_path[name]["bound_by"], "library_ms": None,
         "kernel_only_ms": at_path[name]["kernel_only_ms"],
         "host_ms": at_path[name]["host_ms"], "shape": [N, D, K]}
        for name in ("gmm_score", "gmm_best")]})
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
