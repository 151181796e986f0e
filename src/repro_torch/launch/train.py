"""Training driver with first-class eACGM monitoring (port of
`repro/launch/train.py`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2 \
        --steps 200 --batch 8 --seq 128 --monitor-spec '{"mode": "batch"}' \
        --inject-faults

Runs on ``cuda`` unless ``--device cpu`` is given (``--reduced`` is the
CPU-sized model in float32; without it, GPT-2 at full width in bf16 with the
forward and backward CUDA-graphed on the card). Monitoring is described by
one declarative `MonitorSpec` (inline JSON, a JSON file path, or the
REPRO_MONITOR_SPEC env var); the `Session` facade attaches the probe suite at
runtime, so the model/step code is IDENTICAL with and without monitoring
(the paper's zero-instrumentation contract). The old ``--monitor`` /
``--stream-monitor`` / ``--stream-flush-every`` flags still work as
deprecated shims onto the spec. The Governor turns detected anomalies into
actions, and the launcher prints them.

Flags whose modules are not ported yet exit with an error naming the slice
they wait for: ``--data-mesh`` (launch/mesh.py), ``--checkpoint-dir``
(train/checkpoint.py), ``--metrics-port`` and ``--board-out`` (obs/),
``--microbatches`` > 1 and ``--optimizer adafactor`` (train/step.py and
optim/).
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.config import ShapeConfig, TrainConfig, get_arch, reduced
from repro_torch.core import FaultInjector
from repro_torch.data import SyntheticLMData
from repro_torch.device import resolve_device
from repro_torch.models.model import Runtime, batch_to_device
from repro_torch.roofline import model_flops
from repro_torch.session import MonitorSpec, Session
from repro_torch.train.step import (init_train_state, make_optimizer_for,
                                    make_train_step)

# historical tuning of the train driver, applied only on the legacy-flag path
# (an explicit --monitor-spec keeps full control of these)
LEGACY_PROBE_OPTIONS = {"python": {"sample_every": 25},
                        "device": {"interval": 0.05}}
FAULT_KINDS = ["op_latency", "net_latency", "hw_contention"]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gpt2")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-runnable)")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="where the model trains and the GMMs run")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data-mesh", type=int, default=0,
                    help="data-axis size of a local mesh (0 = no mesh)")
    ap.add_argument("--model-mesh", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    MonitorSpec.add_cli_args(ap)
    ap.add_argument("--monitor", action="store_true",
                    help="[deprecated] = --monitor-spec '{\"mode\":\"batch\"}'")
    ap.add_argument("--stream-monitor", action="store_true",
                    help="[deprecated] = --monitor-spec "
                         "'{\"mode\":\"stream\"}'")
    ap.add_argument("--stream-flush-every", type=int, default=25,
                    help="[deprecated] = spec detector.flush_every")
    ap.add_argument("--inject-faults", action="store_true")
    ap.add_argument("--trace-out", default="",
                    help="perfetto trace path (= a \"perfetto\" sink)")
    ap.add_argument("--metrics-port", type=int, default=-1,
                    help="serve monitor self-metrics on this port "
                         "(= a \"prometheus\" sink; 0 = ephemeral)")
    ap.add_argument("--board-out", default="",
                    help="write a live HTML status board here "
                         "(= a \"board\" sink)")
    ap.add_argument("--log-every", type=int, default=10)
    return ap


def _refuse_later_slices(ap: argparse.ArgumentParser, args) -> None:
    later = [
        (args.data_mesh, "--data-mesh", "launch/mesh.py"),
        (args.checkpoint_dir, "--checkpoint-dir", "train/checkpoint.py"),
        (args.metrics_port >= 0, "--metrics-port", "obs/ (the prometheus "
         "sink)"),
        (args.board_out, "--board-out", "obs/ (the board sink)"),
        (args.microbatches > 1, "--microbatches > 1", "train/step.py "
         "(gradient accumulation)"),
        (args.optimizer != "adamw", f"--optimizer {args.optimizer}",
         "optim/ (adafactor)"),
    ]
    for given, flag, module in later:
        if given:
            ap.error(f"{flag} is not ported yet: it comes with the {module} "
                     "slice of the port")


def train(args) -> Dict[str, Any]:
    """The monitored training run the CLI drives. Returns the losses, each
    step's end (seconds from the loop's start), the
    seconds and steps/s of the training loop (monitoring included; the
    set-up before it — probes attached, the operator stream recorded — in
    ``setup_s``, the session's final sweep and sinks after it in
    ``finalize_s``), the session and its report (None when monitoring is
    off), the fault injector, and the actions the governor printed."""
    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    rt = Runtime(compute_dtype=torch.float32 if args.reduced
                 else torch.bfloat16)
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       optimizer=args.optimizer,
                       warmup_steps=args.steps // 10)
    opt = make_optimizer_for(tcfg)

    data = SyntheticLMData(cfg, seq_len=args.seq, global_batch=args.batch,
                           seed=args.seed)
    state = init_train_state(cfg, opt, seed=args.seed, device=dev)
    step_fn = make_train_step(cfg, rt, opt, microbatches=args.microbatches)

    # ---- monitoring session (runtime attachment; user code unchanged) ----
    # the batch sweep historically fitted with min_events=48; the stream
    # path always used the StreamMonitor default (64) — preserve both
    legacy_defaults = {"probe_options": LEGACY_PROBE_OPTIONS}
    if not args.stream_monitor:
        legacy_defaults["detector"] = {"min_events": 48}
    spec = MonitorSpec.from_args(args, legacy_defaults=legacy_defaults)
    session = Session(spec, device=dev)
    injector = None
    if args.inject_faults and not session.off:
        injector = FaultInjector.random_schedule(args.steps, FAULT_KINDS,
                                                 seed=args.seed)

    losses: List[float] = []
    step_end_s: List[float] = []  # each step's end, from the loop's start
    actions = []
    step = 0
    t0 = time.perf_counter()
    with session.monitoring():
        if not session.off:
            shp = ShapeConfig("run", args.seq, args.batch, "train")
            step_fn = session.observe_step_fn(
                step_fn, sample_args=(state, data.batch(0)),
                flops_per_step=model_flops(cfg, shp),
                mem_gb=sum(p.numel() * p.element_size()
                           for p in state.params.values()) / 2**30)
        t_loop = time.perf_counter()  # attach and the operator record before

        # ---- training loop ----
        # KeyboardInterrupt is caught INSIDE the monitoring context: the
        # session still finalises and closes its sinks, so a Ctrl-C'd run
        # leaves a valid report instead of nothing
        try:
            for step in range(args.steps):
                if injector is not None:
                    injector.apply(step, session.collector)
                state, metrics = step_fn(
                    state, batch_to_device(data.batch(step), dev))
                loss = float(metrics["loss"])  # waits for the step
                losses.append(loss)
                step_end_s.append(time.perf_counter() - t_loop)
                if args.log_every and (step % args.log_every == 0
                                       or step == args.steps - 1):
                    print(f"step {step:5d} loss {loss:8.4f} "
                          f"gnorm {float(metrics['grad_norm']):8.3f} "
                          f"lr {float(metrics['lr']):.2e} "
                          f"({(time.perf_counter() - t0):6.1f}s)",
                          flush=True)
                # periodic anomaly sweep: the session owns the cadence
                out = session.on_step(step)
                if out.warmed:
                    print(f"[monitor] warmed layers: "
                          f"{[l.value for l in out.warmed]}")
                for inc in out.incidents:
                    print("[monitor] " + inc.render())
                for action in out.actions:
                    print(f"[governor] {action.kind}: {action.reason}")
                actions.extend(out.actions)
        except KeyboardInterrupt:
            interrupted = True
            print(f"\n[monitor] interrupted at step {step}; "
                  "flushing monitor artifacts")
        else:
            interrupted = False
        if injector is not None:
            injector.clear(session.collector)
        t_end = time.perf_counter()
    train_s = t_end - t_loop
    return {"losses": losses, "step_end_s": step_end_s,
            "seconds": train_s, "setup_s": t_loop - t0,
            "finalize_s": time.perf_counter() - t_end,  # final sweep, sinks
            "steps_per_s": len(losses) / train_s if train_s else 0.0,
            "session": session,
            "report": None if session.off else session.result(),
            "injector": injector, "actions": actions,
            "interrupted": interrupted, "device": str(dev)}


def main(argv: Optional[List[str]] = None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    _refuse_later_slices(ap, args)
    out = train(args)
    report = out["report"]
    if report is not None:
        print(report.render())
        print("[monitor] overhead stats:", report.overhead)
    losses = out["losses"]
    if losses:
        print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f}); "
              f"{len(losses)} steps in {out['seconds']:.1f}s "
              f"(+{out['setup_s']:.1f}s set-up) on "
              f"{out['device']}")
    return 130 if out["interrupted"] else 0


if __name__ == "__main__":
    sys.exit(main())
