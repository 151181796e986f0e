#!/usr/bin/env python3
"""Where a full-width model's train step spends its time, on one NVIDIA GPU.

    PYTHONPATH=src python3 scripts/arch_profile.py --arch mamba2-2.7b \
        [--optimizer adamw|adafactor] [--microbatches 1] [--batch 8] \
        [--seq 128] [--layers N] [--top 20]

Builds the registered architecture at its published widths (``--layers``
cuts the depth; bf16 compute over float32 masters; the weights drawn on the
card from seed 0), then on one batch: the eager step's parts timed with CUDA
events (forward, backward, the optimizer's in-place update; forward and
backward together with microbatches), torch.profiler's costliest device
kernels over two eager steps (self device ms a step, calls a step), and the
CUDA-graphed train step's ms a replay (CUDA events over 10 replays after
its warm-up and capture), with the peak device memory. One JSON line,
beside the card's name and power limit. Needs a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def device_ms(fn) -> float:
    import torch

    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--optimizer", default="adamw",
                    choices=("adamw", "adafactor"))
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("arch_profile: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.config import TrainConfig, get_arch
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.model import (Runtime, batch_to_device,
                                          init_params, loss_fn)
    from repro_torch.train.step import (TrainState, make_loss_and_grads,
                                        make_optimizer_for, make_train_step)

    dev = torch.device("cuda")
    cfg = get_arch(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    rt = Runtime(torch.bfloat16)
    opt = make_optimizer_for(TrainConfig(
        learning_rate=1e-4, total_steps=100, warmup_steps=10,
        optimizer=args.optimizer), cfg)
    params = init_params(cfg, seed=0, device=dev, generator_device=dev)
    batch = batch_to_device(SyntheticLMData(
        cfg, seq_len=args.seq, global_batch=args.batch, seed=0).batch(0), dev)
    state = opt.init(params)
    lg = make_loss_and_grads(cfg, rt, args.microbatches)
    plist = list(params.values())
    parts = {}

    def eager_step(n, timed=False):
        sc = opt.scalars(n)
        if args.microbatches == 1 and timed:
            out = {}
            parts["forward_ms"] = device_ms(lambda: out.update(
                loss=loss_fn(params, cfg, rt, batch)[0]))
            parts["backward_ms"] = device_ms(lambda: out.update(
                grads=torch.autograd.grad(out["loss"], plist)))
            grads = out["grads"]
        elif timed:
            out = {}
            parts["forward_backward_ms"] = device_ms(
                lambda: out.update(grads=lg(params, batch)[2]))
            grads = out["grads"]
        else:
            grads = lg(params, batch)[2]
        with torch.no_grad():
            g = dict(zip(params, grads))
            if timed:
                parts["update_ms"] = device_ms(
                    lambda: opt.step_(g, state, params, sc))
            else:
                opt.step_(g, state, params, sc)

    torch.cuda.reset_peak_memory_stats()
    for n in (1, 2):
        eager_step(n)
    eager_step(3, timed=True)
    prof_steps = 2
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for n in range(4, 4 + prof_steps):
            eager_step(n)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():  # the device's own events: the kernels
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        ms = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0)) / 1e3
        if ms > 0:
            rows.append((ms / prof_steps, e.count / prof_steps, e.key))
    rows.sort(reverse=True)
    eager_peak = torch.cuda.max_memory_allocated() / 1e9
    del state, params, plist
    torch.cuda.empty_cache()

    # the graphed step, as the launcher runs it
    params = init_params(cfg, seed=0, device=dev, generator_device=dev)
    tstate = TrainState(params, opt.init(params), 0)
    fn = make_train_step(cfg, rt, opt, microbatches=args.microbatches)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):  # two eager warm-up calls, then the capture
        tstate, m = fn(tstate, batch)
    float(m["loss"])
    reps = 10

    def replays():
        nonlocal tstate
        for _ in range(reps):
            tstate, _ = fn(tstate, batch)

    graph_ms = device_ms(replays) / reps
    print(json.dumps({
        "arch": cfg.name, "layers": cfg.n_layers,
        "params": sum(p.numel() for p in params.values()),
        "optimizer": args.optimizer, "microbatches": args.microbatches,
        "batch": args.batch, "seq": args.seq, "eager_parts": parts,
        "eager_device_ms": sum(r[0] for r in rows),
        "top_kernels": [{"ms": round(ms, 4), "calls": calls, "name": name}
                        for ms, calls, name in rows[:args.top]],
        "graph_ms": graph_ms, "eager_peak_gb": eager_peak,
        "graph_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "card": card()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
