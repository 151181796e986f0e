#!/usr/bin/env python3
"""The forward's float32 attention scores on bf16 operands, on one NVIDIA GPU.

    PYTHONPATH=src python3 scripts/attention_ab.py --check
    PYTHONPATH=<tree>/src python3 scripts/attention_ab.py --time --label NAME
    PYTHONPATH=<tree>/src python3 scripts/attention_ab.py --session batch \
        --label NAME

``--check``: whether autograd has a formula for `aten::bmm.dtype`
(``torch.bmm(a, b, out_dtype=torch.float32)``), then the full-width GPT-2
124M loss (bf16, batch 8, sequence 128) and its gradients with the port's
`attention.matmul_f32` (bf16 operands, float32 result, its own backward)
against the same model with both attention products upcast to float32
(plain autograd): the loss within 2e-2 relative and every gradient within
2e-2 of its largest entry (the bf16 tolerance of
``tests/test_torch_model.py``). Exits 1 if a gradient is off.

``--time``: the unmonitored CUDA-graphed training step at the same size,
as `chip_smoke.py`'s ``profile`` phase times it (3 warm-up steps, then
each step on the host clock, synchronised), over ``--steps`` steps: p10,
p50 and p90 ms. It imports only what every tree of the port has, so the
package on ``PYTHONPATH`` is the condition: run parent and change
alternately in one call to compare them.

``--session MODE``: one monitored training session as `chip_smoke.py`'s
``session_path`` runs it (`repro_torch.launch.train`, full width, 200
steps, ``--inject-faults``, the legacy probe options) in ``MODE`` (off,
batch or stream): steady steps/s after the 3 set-up steps, as
``session_path`` counts them. Also only what every tree has.

One JSON line each, beside the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unknown ({e!r})"


def workload(dev, steps):
    from repro_torch.config import TrainConfig, get_arch
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.model import batch_to_device
    from repro_torch.train.step import init_train_state, make_optimizer_for

    cfg = get_arch("gpt2")
    opt = make_optimizer_for(TrainConfig(learning_rate=1e-3,
                                         total_steps=steps, warmup_steps=2),
                             cfg)
    data = SyntheticLMData(cfg, seq_len=128, global_batch=8, seed=0)
    batches = [batch_to_device(data.batch(s), dev) for s in range(steps)]
    return cfg, opt, batches, init_train_state(cfg, opt, device=dev)


def bmm_dtype_autograd(dev) -> str:
    """'yes', or the error autograd raises through `aten::bmm.dtype`."""
    import torch

    a = torch.randn(2, 4, 8, device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    b = torch.randn(2, 8, 4, device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    try:
        torch.bmm(a, b, out_dtype=torch.float32).sum().backward()
    except (RuntimeError, NotImplementedError) as e:
        return f"{type(e).__name__}: {str(e).splitlines()[0]}"
    return "yes"


def check(dev) -> int:
    import torch

    from repro_torch.models import attention
    from repro_torch.models.model import Runtime, loss_fn

    cfg, _, batches, state = workload(dev, 1)
    params = state.params
    rt = Runtime(torch.bfloat16)

    def upcast(a, b, dtype):
        return torch.bmm(a.to(dtype).float(), b.to(dtype).float())

    def grads(mm):
        kept = attention.matmul_f32
        attention.matmul_f32 = mm
        try:
            for p in params.values():
                p.grad = None
            loss, _ = loss_fn(params, cfg, rt, batches[0])
            loss.backward()
            torch.cuda.synchronize()
            return float(loss.detach()), {k: p.grad.detach().float().clone()
                                 for k, p in params.items()}
        finally:
            attention.matmul_f32 = kept

    loss_a, ga = grads(attention.matmul_f32)
    loss_b, gb = grads(upcast)
    worst = {k: float((ga[k] - gb[k]).abs().max()
                      / gb[k].abs().max().clamp_min(1e-30)) for k in ga}
    name = max(worst, key=worst.get)
    ok = abs(loss_a - loss_b) <= 2e-2 * abs(loss_b) and worst[name] <= 2e-2
    print(json.dumps({
        "check": "matmul_f32_grads", "card": card(),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "bmm_dtype_autograd": bmm_dtype_autograd(dev),
        "loss": loss_a, "loss_upcast": loss_b,
        "max_rel_grad_err": worst[name], "at": name,
        "grads_compared": len(worst), "tol": 2e-2, "ok": ok}), flush=True)
    return 0 if ok else 1


def time_step(dev, steps, label) -> int:
    import numpy as np
    import torch

    from repro_torch.models.model import Runtime
    from repro_torch.train.step import make_train_step

    cfg, opt, batches, state = workload(dev, steps + 3)
    step = make_train_step(cfg, Runtime(torch.bfloat16), opt,
                           cuda_graph=True)
    for b in batches[:3]:
        state, _ = step(state, b)
    torch.cuda.synchronize()
    ms = []
    for b in batches[3:]:
        t0 = time.perf_counter()
        state, _ = step(state, b)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    print(json.dumps({"time": "graphed_train_step", "label": label,
                      "card": card(), "steps": steps,
                      "step_ms_p10_p50_p90": np.percentile(
                          ms, [10, 50, 90]).tolist()}), flush=True)
    return 0


def time_session(dev, mode, label) -> int:
    from repro_torch.launch import train

    spec = {"mode": mode, "probe_options": train.LEGACY_PROBE_OPTIONS}
    out = train.train(train.parser().parse_args(
        ["--arch", "gpt2", "--device", dev.type, "--steps", "200",
         "--batch", "8", "--seq", "128", "--inject-faults", "--log-every",
         "0", "--monitor-spec", json.dumps(spec)]))
    ends = out["step_end_s"]
    print(json.dumps({"time": "session", "mode": mode, "label": label,
                      "card": card(), "steps": len(ends),
                      "steady_steps_per_s": (len(ends) - 3)
                      / (ends[-1] - ends[2])}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    what = ap.add_mutually_exclusive_group(required=True)
    what.add_argument("--check", action="store_true")
    what.add_argument("--time", action="store_true")
    what.add_argument("--session", choices=("off", "batch", "stream"))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--label", default="tree")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("attention_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    if args.check:
        return check(dev)
    if args.session:
        return time_session(dev, args.session, args.label)
    return time_step(dev, args.steps, args.label)


if __name__ == "__main__":
    sys.exit(main())
