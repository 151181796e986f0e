"""Training driver with first-class eACGM monitoring (port of
`repro/launch/train.py`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2 \
        --steps 200 --batch 8 --seq 128 --monitor-spec '{"mode": "batch"}' \
        --inject-faults

Runs on ``cuda`` unless ``--device cpu`` is given. ``--arch`` is any
registered architecture (`repro_torch.configs`: GPT-2 by default, the
dense, MoE, SSM, hybrid, encoder and VLM-backbone families); ``--reduced``
is its CPU-sized config in float32, and without it the model trains at
full width in bf16 with the whole step — forward, backward and the
optimizer's update — CUDA-graphed on the card. ``--optimizer`` is
``adamw`` or ``adafactor``; ``--microbatches N`` accumulates the gradients
of N slices of each batch. Monitoring is described by
one declarative `MonitorSpec` (inline JSON, a JSON file path, or the
REPRO_MONITOR_SPEC env var); the `Session` facade attaches the probe suite at
runtime, so the model/step code is IDENTICAL with and without monitoring
(the paper's zero-instrumentation contract). The old ``--monitor`` /
``--stream-monitor`` / ``--stream-flush-every`` flags still work as
deprecated shims onto the spec. ``--metrics-port`` serves the monitor's
self-telemetry (a ``prometheus`` sink; 0 binds a free port) and
``--board-out`` writes a live HTML status board (a ``board`` sink).

Fault tolerance: deterministic data pipeline + async checkpoints
(``--checkpoint-dir``, every ``--checkpoint-every`` steps) + auto-resume
from the latest one; the Governor turns detected anomalies into actions,
and its checkpoint_now action triggers an immediate snapshot. Ctrl-C
(SIGINT) stops the loop at the end of the step in flight, raises
KeyboardInterrupt there, and the run saves a last checkpoint: the port
updates the parameters and moments in place, so a step cut in the middle
would leave a state that is neither the old one nor the new one (the
reference's functional step leaves the old one). A second Ctrl-C
interrupts at once and saves nothing: the last periodic checkpoint
stands. ``step_N`` holds the
state after N steps and a resumed loop starts at step N; the reference
names the state after step s by s and runs step s again on resume, so a
resumed run here equals the uninterrupted one.

``--data-mesh N --model-mesh M`` trains over an N x M mesh
(`launch/mesh.py`): on one process when N·M = 1, else under ``torchrun
--nproc-per-node N·M`` (``nccl`` on the card, ``gloo`` with ``--device
cpu``). The state is laid out by the reference's sharding rules, every rank
runs its own monitor session (eACGM's agent runs per process) and its
COLLECTIVE layer replays the collectives its step issues; rank 0 alone
writes the report, the sinks and the checkpoints (whole tensors: a run on
another mesh, or none, resumes them), and the other ranks print their
verdict with their rank. The process group is torn down on every exit.

    torchrun --nproc-per-node 2 -m repro_torch.launch.train --reduced \
        --device cpu --data-mesh 2 --steps 20 --batch 4 --seq 32
"""
from __future__ import annotations

import argparse
import contextlib
import signal
import sys
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.config import ShapeConfig, TrainConfig, get_arch, reduced
from repro_torch.core import FaultInjector
from repro_torch.data import SyntheticLMData
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.model import Runtime, batch_to_device
from repro_torch.roofline import model_flops
from repro_torch.session import MonitorSpec, Session, SinkSpec
from repro_torch.train.checkpoint import CheckpointManager, shardings_of
from repro_torch.train.step import (init_train_state, make_optimizer_for,
                                    make_train_step, state_specs)

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
    ap.add_argument("--optimizer", default="adamw",
                    choices=("adamw", "adafactor"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--init-on-device", action="store_true",
                    help="draw the initial weights with a generator on "
                         "--device (seconds instead of minutes for a "
                         "billion-parameter model; other numbers than the "
                         "CPU draw)")
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


def _check_args(ap: argparse.ArgumentParser, args) -> None:
    if args.data_mesh < 0 or args.model_mesh < 1:
        ap.error("--data-mesh and --model-mesh take sizes >= 1")
    n = args.data_mesh * args.model_mesh
    if n > 1 and not mesh_mod.under_torchrun():
        ap.error(f"a --data-mesh {args.data_mesh} x --model-mesh "
                 f"{args.model_mesh} mesh (launch/mesh.py) needs {n} "
                 f"ranks: run under torchrun --nproc-per-node {n}")
    if args.microbatches < 1 or args.batch % args.microbatches:
        ap.error(f"--batch {args.batch} does not split into "
                 f"--microbatches {args.microbatches}")


@contextlib.contextmanager
def interrupt_between_steps():
    """While the block runs: a first SIGINT only sets the returned event
    (the loop raises KeyboardInterrupt once its step is done), a second one
    interrupts at once. Off the main thread, where no handler can be set,
    SIGINT keeps its default."""
    stop = threading.Event()
    if threading.current_thread() is not threading.main_thread():
        yield stop
        return

    def handler(signum, frame):
        if stop.is_set():
            raise KeyboardInterrupt
        stop.set()

    old = signal.signal(signal.SIGINT, handler)
    try:
        yield stop
    finally:
        signal.signal(signal.SIGINT, old)


def _last_saved(ckpt: CheckpointManager) -> Optional[int]:
    return ckpt.saves[-1]["step"] if ckpt.saves else None


def train(args) -> Dict[str, Any]:
    """The monitored training run the CLI drives. Returns the losses, each
    step's end (seconds from the loop's start), the
    seconds and steps/s of the training loop (monitoring included; the
    set-up before it — probes attached, the operator stream recorded — in
    ``setup_s``, the session's final sweep and sinks after it in
    ``finalize_s``), the session and its report (None when monitoring is
    off), the fault injector, the actions the governor printed (each with
    the step it followed, ``action_steps``), the step the loop started at
    (``start_step``, > 0 after a resume) and the checkpoint manager's
    ``saves`` (empty without ``--checkpoint-dir``)."""
    mesh, rank = None, 0
    if args.data_mesh:
        mesh = mesh_mod.make_local_mesh(args.data_mesh, args.model_mesh,
                                        device=args.device)
        rank = torch.distributed.get_rank()
        dev = mesh_mod.local_device(args.device)
    else:
        dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    rt = Runtime(compute_dtype=torch.float32 if args.reduced
                 else torch.bfloat16, mesh=mesh)
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       optimizer=args.optimizer,
                       warmup_steps=args.steps // 10)
    opt = make_optimizer_for(tcfg, cfg, rt)

    data = SyntheticLMData(cfg, seq_len=args.seq, global_batch=args.batch,
                           seed=args.seed)
    state = init_train_state(cfg, opt, seed=args.seed, device=dev,
                             generator_device=dev if args.init_on_device
                             else "cpu", rt=rt)
    step_fn = make_train_step(cfg, rt, opt, microbatches=args.microbatches)

    # ---- fault tolerance: auto-resume ----
    ckpt = None
    start_step = 0
    if args.checkpoint_dir:
        shardings = (shardings_of(state, state_specs(cfg, rt, state), mesh)
                     if mesh is not None else None)
        ckpt = CheckpointManager(args.checkpoint_dir, shardings=shardings)
        restored, meta, rstep = ckpt.restore_latest(state)
        if restored is not None:
            state, start_step = restored, rstep
            if rank == 0:
                print(f"[resume] restored checkpoint at step {rstep}")
        ckpt.reserve(state)  # the host buffers, before the loop

    # ---- monitoring session (runtime attachment; user code unchanged) ----
    # the batch sweep historically fitted with min_events=48; the stream
    # path always used the StreamMonitor default (64) — preserve both
    legacy_defaults = {"probe_options": LEGACY_PROBE_OPTIONS}
    if not args.stream_monitor:
        legacy_defaults["detector"] = {"min_events": 48}
    spec = MonitorSpec.from_args(args, legacy_defaults=legacy_defaults)
    if rank != 0:
        spec.sinks = []  # rank 0 alone writes the sinks
    elif spec.mode != "off":
        if args.metrics_port >= 0:
            spec.sinks.append(SinkSpec(
                kind="prometheus",
                options={"serve": True, "port": args.metrics_port}))
        if args.board_out:
            spec.sinks.append(SinkSpec(kind="board", path=args.board_out))
    session = Session(spec, device=dev)
    if not session.off and args.metrics_port >= 0 and rank == 0:
        print(f"[monitor] metrics endpoint: "
              f"{session.sink('prometheus').url}/metrics", flush=True)
    injector = None
    if args.inject_faults and not session.off:
        injector = FaultInjector.random_schedule(args.steps, FAULT_KINDS,
                                                 seed=args.seed)

    losses: List[float] = []
    step_end_s: List[float] = []  # each step's end, from the loop's start
    actions, action_steps = [], []
    step = start_step
    stopped = False  # a SIGINT honoured at the end of its step
    t0 = time.perf_counter()
    with session.monitoring(), interrupt_between_steps() as stop:
        if not session.off:
            shp = ShapeConfig("run", args.seq, args.batch, "train")
            step_fn = session.observe_step_fn(
                step_fn, sample_args=(state, data.batch(0)),
                flops_per_step=model_flops(cfg, shp),
                mem_gb=sum(p.numel() * p.element_size()
                           for p in state.params.values()) / 2**30)
            sched = session.collector.collective_schedule
            if mesh is not None and rank == 0:
                print(f"[monitor] COLLECTIVE layer: "
                      + (f"{sched['ops']} collective(s) a step, read off "
                         f"the step on mesh {mesh_mod.describe(mesh)}"
                         if sched and sched["ops"] else
                         f"empty: the step issues no collective on mesh "
                         f"{mesh_mod.describe(mesh)}"), flush=True)
        t_loop = time.perf_counter()  # attach and the operator record before

        # ---- training loop ----
        # KeyboardInterrupt is caught INSIDE the monitoring context: the
        # session still finalises and closes its sinks, so a Ctrl-C'd run
        # leaves a valid board/metrics/report instead of nothing
        try:
            for step in range(start_step, args.steps):
                if injector is not None:
                    injector.apply(step, session.collector)
                state, metrics = step_fn(
                    state, batch_to_device(data.batch(step), dev))
                loss = float(metrics["loss"])  # waits for the step
                losses.append(loss)
                step_end_s.append(time.perf_counter() - t_loop)
                if args.log_every and rank == 0 and (
                        step % args.log_every == 0
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
                # a checkpoint holds the steps done: step + 1
                if ckpt is not None \
                        and (step + 1) % args.checkpoint_every == 0:
                    ckpt.save(step + 1, state, meta={"loss": loss})
                for action in out.actions:
                    print(f"[governor] {action.kind}: {action.reason}")
                    if action.kind == "checkpoint_now" and ckpt is not None \
                            and _last_saved(ckpt) != step + 1:
                        ckpt.save(step + 1, state, meta={"loss": loss,
                                                         "reason": "governor"})
                actions.extend(out.actions)
                action_steps.extend([step] * len(out.actions))
                if stop.is_set():  # SIGINT: the step is done, stop here
                    stopped = True
                    raise KeyboardInterrupt
        except KeyboardInterrupt:
            interrupted = True
            print(f"\n[monitor] interrupted at step {step}; "
                  "flushing monitor artifacts")
        else:
            interrupted = False
        if injector is not None:
            injector.clear(session.collector)
        t_end = time.perf_counter()
    t_final = time.perf_counter()  # the session's final sweep and sinks
    if ckpt is not None:
        # an interrupt that did not wait for its step's end (a second
        # SIGINT) may have cut the in-place update short: the last
        # checkpoint stands
        if losses and (stopped or not interrupted) \
                and _last_saved(ckpt) != start_step + len(losses):
            ckpt.save(start_step + len(losses), state,
                      meta={"loss": losses[-1]})
        ckpt.close()
    train_s = t_end - t_loop
    return {"losses": losses, "step_end_s": step_end_s,
            "seconds": train_s, "setup_s": t_loop - t0,
            "finalize_s": t_final - t_end,
            "steps_per_s": len(losses) / train_s if train_s else 0.0,
            "session": session,
            "report": None if session.off else session.result(),
            "injector": injector, "actions": actions,
            "action_steps": action_steps, "start_step": start_step,
            "saves": ckpt.saves if ckpt is not None else [],
            "interrupted": interrupted, "device": str(dev), "rank": rank,
            "mesh": mesh_mod.describe(mesh) if mesh is not None else None,
            "collectives": None if session.off
            else session.collector.collective_schedule}


def _verdict(report) -> str:
    if not report.incidents:
        return "no incidents"
    steps = report.anomalous_steps()
    return (f"{len(report.incidents)} incident(s), "
            f"{len(steps)} anomalous step(s)")


def main(argv: Optional[List[str]] = None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    _check_args(ap, args)
    group = (mesh_mod.process_group(args.device) if args.data_mesh
             else contextlib.nullcontext())
    with group:
        out = train(args)
        report = out["report"]
        if out["rank"] != 0:
            if report is not None:
                print(f"[rank {out['rank']}] {_verdict(report)}")
            return 130 if out["interrupted"] else 0
        if report is not None:
            print(report.render())
            print("[monitor] overhead stats:", report.overhead)
        losses = out["losses"]
        if losses:
            where = out["device"] + (f", mesh {out['mesh']}"
                                     if out["mesh"] else "")
            print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f}); "
                  f"{len(losses)} steps in {out['seconds']:.1f}s "
                  f"(+{out['setup_s']:.1f}s set-up) on {where}")
    return 130 if out["interrupted"] else 0


if __name__ == "__main__":
    sys.exit(main())
