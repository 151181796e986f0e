#!/usr/bin/env python3
"""What moves the full-width GPT-2 step's device time between levels, on
one NVIDIA GPU.

    python3 scripts/step_levels.py [--part gaps|cells|all] [--reps N]

The CUDA-graphed GPT-2 124M train step (bf16, batch 8, sequence 128, built
by `repro_torch.quickstart._workload`) is replayed in segments of
``--segment`` steps. Every replay is timed on the card with CUDA events: on
even steps a ~1 ms sleep kernel runs before the start event, so the graph
is already queued when the start event fires and the time is the graph's
own; on odd steps there is none, as the runtime probe times a launch.

``gaps``: between two segments one kind of work runs for ~0.8 s (as long
as an inline batch sweep), in a shuffled order, ``--reps`` times a kind:

- ``none``: nothing; ``idle``: the host sleeps (the card idles);
- ``gmm_cuda``: GMMDetector fits on the card on a side stream, as a sweep
  runs on the session's executor stream;
- ``gmm_cuda_pool``: the same with the fits' memory in a pool of its own
  (`torch.cuda.MemPool`);
- ``gmm_cpu``: the same fits on the CPU;
- ``kernels``: small kernels on a side stream, on memory allocated once;
- ``alloc``: allocations and frees of new sizes on a side stream, no math;
- ``empty_cache``: `torch.cuda.empty_cache()` after a side-stream fit;
- ``gmm_main``, ``kernels_main``: the fits, the small kernels, on the
  training's own stream.

Each gap prints the medians of the graph's device time over the segment
before and after it, and whether it moved by more than ``--move-ms``.

``cells``: the eval harness's clean control (`repro_torch.eval.runner`'s
spec, `_FAKE_HLO`, injector and `_drive`, as `run_scenario` composes a
cell) around the same step, under each ``--cells`` condition (detector
device ``cuda``/``cpu``, where the inline sweeps run (`sweep_on`),
mode), ``--cell-reps`` times each in a shuffled
order. Each cell prints its false-alarm rate, its diagnoses, the graph's
device ms per sweep interval and per 20 steps, the steps slower than the
median by over 0.5 ms, and the garbage collections over 1 ms.

The card's SM and memory clocks, power and clock-event reasons are sampled
by ``nvidia-smi`` every 200 ms and printed per segment. One JSON line per
gap or cell, a summary line last.
"""
from __future__ import annotations

import argparse
import contextlib
import datetime
import gc
import json
import os
import random
import subprocess
import sys
import threading
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

GAP_S = 0.8
PRE_CYCLES = 2_000_000  # ~1 ms at 1.98 GHz
KINDS = ("none", "idle", "gmm_cuda", "gmm_cuda_pool", "gmm_cpu", "kernels",
         "alloc", "empty_cache", "gmm_main", "kernels_main")


class Clocks:
    """``nvidia-smi`` sampling the card every 200 ms while the block runs."""

    QUERY = ("timestamp,clocks.sm,clocks.mem,power.draw,"
             "clocks_event_reasons.active")

    def __init__(self):
        self.samples = []

    def __enter__(self):
        self._proc = subprocess.Popen(
            ["nvidia-smi", f"--query-gpu={self.QUERY}",
             "--format=csv,noheader,nounits", "-lms", "200"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()
        return self

    def _read(self):
        for ln in self._proc.stdout:
            p = [x.strip() for x in ln.split(",")]
            try:
                ts = datetime.datetime.strptime(
                    p[0], "%Y/%m/%d %H:%M:%S.%f").timestamp()
                self.samples.append((ts, float(p[1]), float(p[2]),
                                     float(p[3]), p[4]))
            except (ValueError, IndexError):
                continue

    def __exit__(self, *exc):
        self._proc.terminate()
        try:
            self._proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait()
        self._reader.join(timeout=10)
        return False

    def over(self, t0, t1):
        sel = [s for s in self.samples if t0 <= s[0] <= t1]
        if not sel:
            return None
        return {"sm_mhz": sorted({s[1] for s in sel}),
                "mem_mhz": sorted({s[2] for s in sel}),
                "power_w": float(np.median([s[3] for s in sel])),
                "reasons": sorted({s[4] for s in sel})}


class ReplayTimer:
    """Times every `torch.cuda.CUDAGraph.replay` with CUDA events; with
    ``pre`` on, even replays are preceded by a sleep kernel."""

    def __init__(self, pre: bool):
        self.pre = pre
        self.n = 0
        self.rows = []  # (pre-busied, start, end, host launch s)
        self._orig = torch.cuda.CUDAGraph.replay

    def __enter__(self):
        orig, timer = self._orig, self

        def replay(graph, *a, **kw):
            busy = timer.pre and timer.n % 2 == 0
            timer.n += 1
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            if busy:
                torch.cuda._sleep(PRE_CYCLES)
            s.record()
            t0 = time.perf_counter()
            out = orig(graph, *a, **kw)
            host = time.perf_counter() - t0
            e.record()
            timer.rows.append((busy, s, e, host))
            return out

        torch.cuda.CUDAGraph.replay = replay
        return self

    def __exit__(self, *exc):
        torch.cuda.CUDAGraph.replay = self._orig
        return False

    def take(self):
        """(pre-busied, device ms, host launch ms) of the replays so far."""
        torch.cuda.synchronize()
        out = [(b, s.elapsed_time(e), 1e3 * h) for b, s, e, h in self.rows]
        self.rows = []
        return out


def sweep_like_x(rng):
    """Features shaped like one sweep's layer: 2,880 rows, 3 columns, 3
    clusters."""
    centres = 6.0 * rng.standard_normal((3, 3))
    return centres[rng.integers(0, 3, 2880)] + rng.standard_normal((2880, 3))


def gap(kind, ctx):
    from repro_torch.core.detector import GMMDetector

    t_end = time.perf_counter() + GAP_S
    side, X = ctx["side"], ctx["X"]
    if kind == "idle":
        time.sleep(GAP_S)
    elif kind == "gmm_main":
        while time.perf_counter() < t_end:
            GMMDetector(n_components=3, device="cuda").fit(X)
        torch.cuda.synchronize()
    elif kind == "kernels_main":
        buf = ctx["buf"]
        while time.perf_counter() < t_end:
            for _ in range(200):
                buf.mul_(0.999).add_(1e-3)
        torch.cuda.synchronize()
    elif kind in ("gmm_cuda", "gmm_cuda_pool", "empty_cache"):
        pool = (torch.cuda.use_mem_pool(ctx["pool"])
                if kind == "gmm_cuda_pool" else contextlib.nullcontext())
        with torch.cuda.stream(side), pool:
            while time.perf_counter() < t_end:
                GMMDetector(n_components=3, device="cuda").fit(X)
        side.synchronize()
        if kind == "empty_cache":
            torch.cuda.empty_cache()
    elif kind == "gmm_cpu":
        while time.perf_counter() < t_end:
            GMMDetector(n_components=3, device="cpu").fit(X)
    elif kind == "kernels":
        buf = ctx["buf"]
        with torch.cuda.stream(side):
            while time.perf_counter() < t_end:
                for _ in range(200):
                    buf.mul_(0.999).add_(1e-3)
        side.synchronize()
    elif kind == "alloc":
        rng = ctx["rng_alloc"]
        with torch.cuda.stream(side):
            while time.perf_counter() < t_end:
                keep = [torch.empty(int(n), device="cuda")
                        for n in rng.integers(1 << 10, 1 << 22, 64)]
                del keep
        side.synchronize()


def workload(steps):
    """The full-width step, after its set-up calls (on the current
    stream)."""
    from repro_torch import quickstart
    from repro_torch.models.model import batch_to_device

    dev = torch.device("cuda")
    batch, seq, data, state, step_fn = quickstart._workload(False, dev, steps)
    box = {"state": state, "s": 0}

    def one_step(fn=step_fn):
        box["state"], m = fn(box["state"], batch_to_device(
            data.batch(box["s"] % 1000), dev))
        box["s"] += 1
        return m

    for _ in range(quickstart.SETUP_STEPS):
        one_step()
    torch.cuda.synchronize()
    return box, data, step_fn, one_step


def segment_stats(rows):
    dev_pre = [d for b, d, _ in rows[4:] if b]
    dev_raw = [d for b, d, _ in rows[4:] if not b]
    host = [h for _, _, h in rows[4:]]
    med = (lambda v: float(np.median(v)) if v else None)
    return {"graph_ms_pre": med(dev_pre), "graph_ms_raw": med(dev_raw),
            "launch_host_ms": med(host)}


def part_gaps(args, clocks):
    box, data, step_fn, one_step = workload(10_000)
    ctx = {"side": torch.cuda.Stream(), "X": sweep_like_x(
        np.random.default_rng(0)), "buf": torch.zeros(1 << 16, device="cuda"),
        "rng_alloc": np.random.default_rng(1)}
    ctx["pool"] = (torch.cuda.MemPool() if hasattr(torch.cuda, "MemPool")
                   and hasattr(torch.cuda, "use_mem_pool") else None)
    kinds = [k for k in (args.kinds.split(",") if args.kinds else KINDS)
             if k != "gmm_cuda_pool" or ctx["pool"]]
    order = [k for k in kinds for _ in range(args.reps)]
    random.Random(0).shuffle(order)
    out = []
    with ReplayTimer(pre=True) as timer:
        def segment():
            t0 = time.time()
            for _ in range(args.segment):
                one_step()
                torch.cuda.synchronize()
            st = segment_stats(timer.take())
            st["clocks"] = clocks.over(t0, time.time())
            return st

        before = segment()
        for i, kind in enumerate(order):
            seg0 = torch.cuda.memory_stats().get("segment.all.current")
            t = time.perf_counter()
            gap(kind, ctx)
            gap_s = time.perf_counter() - t
            seg1 = torch.cuda.memory_stats().get("segment.all.current")
            after = segment()
            d = after["graph_ms_pre"] - before["graph_ms_pre"]
            line = {"part": "gaps", "i": i, "kind": kind,
                    "gap_s": round(gap_s, 3), "segments": [seg0, seg1],
                    "before": before, "after": after, "delta_ms": d,
                    "moved": bool(abs(d) > args.move_ms)}
            print(json.dumps(line), flush=True)
            out.append(line)
            before = after
        if args.child_kinds:
            # a second process on the same card while this one holds its
            # context, then this process's level again
            child = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--part",
                 "gaps", "--kinds", args.child_kinds, "--reps", "3"],
                capture_output=True, text=True)
            for ln in child.stdout.splitlines():
                print("child " + ln, flush=True)
            again = segment()
            print(json.dumps({"part": "gaps", "parent_after_child": again}),
                  flush=True)
    summary = {}
    for k in kinds:
        ls = [l for l in out if l["kind"] == k]
        summary[k] = {"gaps": len(ls), "moved": sum(l["moved"] for l in ls),
                      "up": sum(bool(l["delta_ms"] > args.move_ms)
                                for l in ls),
                      "abs_delta_ms_median": float(np.median(
                          [abs(l["delta_ms"]) for l in ls]))}
    levels = [l["after"]["graph_ms_pre"] for l in out]
    return {"part": "gaps", "by_kind": summary,
            "graph_ms_pre_range": [min(levels), max(levels)]}


def sweep_on(executor, how):
    """Where an inline executor's sweeps run: "training" (as built), "side"
    (a second stream) or "training_sync" (the training stream, waited for
    at the end of each sweep)."""
    orig = executor.on_stream
    if how == "side":
        executor.stream = torch.cuda.Stream()
    elif how == "training_sync":
        @contextlib.contextmanager
        def on_stream():
            with orig():
                yield
            torch.cuda.current_stream().synchronize()
        executor.on_stream = on_stream


def clean_cell(mode, det_device, sweep_stream, step_fn, box, data):
    """The clean control, composed as `repro_torch.eval.runner.run_scenario`
    composes a cell, around the full-width step; ``sweep_stream`` as
    `sweep_on` takes it."""
    from repro_torch.core.chaos import get_scenario
    from repro_torch.eval import matrix, runner
    from repro_torch.models.model import batch_to_device
    from repro_torch.session import MonitorSpec, Session

    dev = torch.device("cuda")
    cfg = runner.EvalConfig()
    scenario = get_scenario("clean_control")
    n = 240
    eval_start = int(n * scenario.clean_fraction)
    injector = scenario.injector(n)
    spec = MonitorSpec(
        mode=mode, probes=list(runner.EVAL_PROBES),
        probe_options={"device": {"interval": cfg.device_interval}},
        detector=cfg.detector_spec(holdoff_steps=n - eval_start, seed=0),
        diagnosis=cfg.diagnosis, governor=False, seed=0)
    session = Session(spec, device=det_device)
    if session._executor is not None:
        sweep_on(session._executor, sweep_stream)
    t0 = time.perf_counter()
    with ReplayTimer(pre=False) as timer:
        with session.monitoring():
            session.collector["collective"].register_compiled(
                runner._FAKE_HLO)
            fn = session.observe_step_fn(
                step_fn, sample_args=(box["state"], data.batch(0)),
                mem_gb=0.5)

            step_ms, gcs, cur = [], [], {"s": -1, "t": 0.0}

            def one_step(s):
                cur["s"] = s
                t = time.perf_counter()
                box["state"], _ = fn(box["state"], batch_to_device(
                    data.batch(s), dev))
                step_ms.append(1e3 * (time.perf_counter() - t))

            def on_gc(phase, info):  # collections and their pauses by step
                if phase == "start":
                    cur["t"] = time.perf_counter()
                else:
                    gcs.append((cur["s"], info["generation"], round(
                        1e3 * (time.perf_counter() - cur["t"]), 3)))

            gc.callbacks.append(on_gc)
            try:
                step_ts = runner._drive(session, injector, n, eval_start,
                                        cfg, one_step)
            finally:
                gc.callbacks.remove(on_gc)
        rows = timer.take()
    run = runner.ScenarioRun(
        scenario=scenario, mode=mode, config=cfg, n_steps=n,
        eval_start=eval_start, labels=injector.labels(n),
        windows=injector.windows(), faults=list(injector.faults),
        step_ts=step_ts, report=session.result(),
        wall_s=time.perf_counter() - t0)
    row = matrix._row(run)
    ms = np.asarray([d for _, d, _ in rows])
    edges = [0, *range(cfg.sweep_every + 1, len(ms), cfg.sweep_every),
             len(ms)]
    by20 = [0, *range(21, len(ms), 20), len(ms)]
    p50 = float(np.median(step_ms))
    return {"part": "cells", "mode": mode, "detector_device": str(det_device),
            "sweep_stream": sweep_stream,
            "step_ms_p50": p50,
            "slow_steps": [(i, round(t, 3)) for i, t in enumerate(step_ms)
                           if t > p50 + 0.5],
            "gc_over_1ms": [g for g in gcs if g[2] > 1.0],
            "gc_count": len(gcs),
            "graph_ms_by_20": [round(float(np.median(ms[a:b])), 3)
                               for a, b in zip(by20[:-1], by20[1:])],
            "far": row["metrics"]["false_alarm_rate"],
            "diagnoses": row.get("diagnosis", {}).get("kinds"),
            "diagnosed_incidents": [
                {"kind": d.fault_kind, "confidence": float(d.confidence),
                 "steps": [int(x) for x in i.steps],
                 "layer_deficit": {str(getattr(k, "value", k)): float(v)
                                   for k, v in i.layer_deficit.items()}}
                for d in run.report.diagnoses
                for i in run.report.incidents
                if i.incident_id == d.incident_id],
            "flagged_steps": {getattr(k, "value", str(k)): [
                int(x) for x in v.anomalous_steps]
                for k, v in run.report.layers.items()},
            "graph_ms_by_interval": [float(np.median(ms[a:b]))
                                     for a, b in zip(edges[:-1], edges[1:])],
            "wall_s": row["wall_s"]}


def part_cells(args):
    box, data, step_fn, _ = workload(10_000)
    conds = [tuple(c.split("/")) for c in args.cells.split(",")]
    order = [c for c in conds for _ in range(args.cell_reps)]
    random.Random(1).shuffle(order)
    out = []
    for i, (det, stream, mode) in enumerate(order):
        line = clean_cell(mode, det, stream, step_fn, box, data)
        line["i"] = i
        print(json.dumps(line), flush=True)
        out.append(line)
        gc.collect()
    summary = {}
    for det, stream, mode in conds:
        ls = [l for l in out if (l["detector_device"], l["sweep_stream"],
                                 l["mode"]) == (det, stream, mode)]
        summary[f"{det}/{stream}/{mode}"] = {
            "far": [l["far"] for l in ls],
            "up": sum(bool(max(np.diff(l["graph_ms_by_interval"]),
                               default=0) > args.move_ms) for l in ls),
            "down": sum(bool(min(np.diff(l["graph_ms_by_interval"]),
                                 default=0) < -args.move_ms) for l in ls)}
    return {"part": "cells", "by_condition": summary}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--part", choices=("gaps", "cells", "all"), default="all")
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--cell-reps", type=int, default=3)
    ap.add_argument("--child-kinds", default="",
                    help="after the gaps, run these gap kinds in a child "
                         "process, then time this process's step again")
    ap.add_argument("--kinds", default="",
                    help="comma-separated gap kinds (default: all)")
    ap.add_argument("--cells", default="cuda/training/batch,cuda/side/batch",
                    help="comma-separated detector device/sweep stream/mode")
    ap.add_argument("--segment", type=int, default=40)
    ap.add_argument("--move-ms", type=float, default=0.25)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("step_levels: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    summaries = []
    with Clocks() as clocks:
        for part in ("gaps", "cells"):
            if args.part not in (part, "all"):
                continue
            try:
                summaries.append(part_gaps(args, clocks) if part == "gaps"
                                 else part_cells(args))
            except Exception:  # noqa: BLE001 — report, go on to the next
                traceback.print_exc()
                summaries.append({"part": part, "failed": True})
    print(json.dumps({"summary": summaries}), flush=True)
    return int(any(s.get("failed") for s in summaries))


if __name__ == "__main__":
    sys.exit(main())
