#!/usr/bin/env python3
"""How often the evaluation's clean control is diagnosed, on one NVIDIA GPU.

    PYTHONPATH=src python3 scripts/clean_control_rate.py --mode stream \
        [--pass a|b] [--after-session] [--cells 20] [--label NAME] \
        [--fixture PATH]
    PYTHONPATH=src python3 scripts/clean_control_rate.py --runs 12

``--pass b`` (the default) builds the clean-control cell of
`chip_smoke.py`'s eval pass B with the functions `eval_pass_b` calls
(`runner.scenario_spec`, `runner.run_model_cell` and `matrix._row`, around
the full-width GPT-2 124M step: bf16, batch 8, sequence 128, CUDA-graphed,
built once by `quickstart._workload` with its set-up calls made before the
first cell). ``--pass a`` builds pass A's: the smoke scenario's clean cell
on the synthetic step, `runner.run_scenario` with the evaluator's default
config, 240 steps and seed 0, as `repro_torch.launch.evaluate --scenarios
smoke` runs it. Either cell runs ``--cells`` times in ``--mode`` (batch or
stream), in this one process. ``--after-session`` first runs one monitored
training session as `chip_smoke.py`'s ``session_path`` runs its batch mode
(`repro_torch.launch.train`, full width, 200 steps, ``--inject-faults``;
its detection sweeps on the thread executor's stream of their own), the
condition a cell met when pass A ran in the smoke's own process. Run one
process per mode and per condition: the package measured is the
``repro_torch`` on ``PYTHONPATH``, so two trees are two conditions.

One JSON line per cell: its false-alarm rate, its diagnoses, the steps
slower than the cell's median by over 0.5 ms (which, and by how much), the
CPU time the hypervisor took meanwhile (/proc/stat's steal), the
garbage collections (those over 1 ms, and how many fell inside a
monitored step), the monitored step's ms
(p50, p90), the steps each layer flagged, and, for every diagnosed
incident, its steps, its flags per layer, ``layer_deficit``, the mean
deficit per flag against the diagnoser's floor (``min_mean_deficit``) and
the blamed kind's share. A summary line last. With ``--fixture``, the
first diagnosed incident's flag rows (ts, layer, node, step, deficit) and
the device and collective evidence the diagnoser read are written there as
JSON, for ``tests/test_torch_diagnosis_parity.py``.

``--runs N`` measures pass A as `chip_smoke.py` runs it instead: the
evaluator (`repro_torch.launch.evaluate --scenarios smoke --modes
batch,stream`, TF32 off) in each of N fresh processes, one after
another, each its own context's first work; one line a run (its exit
code, each mode's clean-control FAR and diagnoses) and a summary.

Needs a card; pass B ~7 s a cell after ~30 s of set-up, pass A ~4 s a
cell, a ``--runs`` process ~25 s.
``--device cpu`` is a dry run on the reduced model.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import shutil
import subprocess
import sys
import time

SLOW_MS = 0.5  # a step this much over the cell's median step is slow
EVIDENCE_LAYERS = ("device", "collective")  # what the diagnoser splits on


def steal_s() -> float:
    """Seconds the hypervisor took from this machine's CPUs so far (the
    ``steal`` column of /proc/stat, in USER_HZ ticks); NaN if unreadable."""
    try:
        with open("/proc/stat") as f:
            return int(f.readline().split()[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return float("nan")


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unknown ({e!r})"


@contextlib.contextmanager
def collections():
    """For the block: every garbage collection, as (generation, start,
    end) on the perf_counter clock."""
    import gc

    got, start = [], [0.0]

    def cb(phase, info):
        if phase == "start":
            start[0] = time.perf_counter()
        else:
            got.append((info["generation"], start[0], time.perf_counter()))

    gc.callbacks.append(cb)
    try:
        yield got
    finally:
        gc.callbacks.remove(cb)


def gc_line(got, spans):
    """Collections over 1 ms: how many, the longest, and how many fell
    inside a monitored step (``spans``: each step's (start, end))."""
    import numpy as np

    long_ = [(g, a, b) for g, a, b in got if b - a > 1e-3]
    starts = np.array([a for a, _ in spans])
    ends = np.array([b for _, b in spans])
    inside = sum(bool(((starts <= a) & (a < ends)).any())
                 for _, a, _ in long_)
    return {"collections": len(got), "over_1ms": len(long_),
            "over_1ms_in_step": inside,
            "max_ms": round(1e3 * max((b - a for _, a, b in got),
                                      default=0.0), 3),
            "gen2": sum(g == 2 for g, _, _ in got)}


@contextlib.contextmanager
def recorded():
    """For the block: every incident the engines close, with the flag rows
    it was made of, and every evidence dict the diagnoser was given."""
    from repro_torch.diagnosis import engine as dmod
    from repro_torch.stream import incidents as imod

    got = {"groups": {}, "evidence": {}}
    attribute = imod.IncidentEngine._attribute
    diagnose = dmod.Diagnoser.diagnose

    def attribute_kept(self, g):
        inc = attribute(self, g)
        if inc is not None:
            got["groups"][inc.incident_id] = g.copy()
        return inc

    def diagnose_kept(self, incident, evidence=None):
        got["evidence"][incident.incident_id] = evidence or {}
        return diagnose(self, incident, evidence)

    imod.IncidentEngine._attribute = attribute_kept
    dmod.Diagnoser.diagnose = diagnose_kept
    try:
        yield got
    finally:
        imod.IncidentEngine._attribute = attribute
        dmod.Diagnoser.diagnose = diagnose


def incident_line(inc, diag, g, floor):
    """One diagnosed incident as printed."""
    import numpy as np

    from repro_torch.core.events import Layer

    layers = tuple(Layer)
    ids, counts = np.unique(g[:, 1].astype(int), return_counts=True)
    steps = sorted(inc.steps)
    return {"kind": diag.fault_kind, "share": diag.candidates[diag.fault_kind],
            "confidence": diag.confidence,
            "steps": {"first": steps[0] if steps else None,
                      "last": steps[-1] if steps else None,
                      "count": len(steps)},
            "n_flags": inc.n_flags,
            "flags_per_layer": {layers[i].value: int(c)
                                for i, c in zip(ids, counts)},
            "layer_deficit": {k: round(v, 3)
                              for k, v in inc.layer_deficit.items()},
            "mean_deficit": inc.severity / max(inc.n_flags, 1),
            "min_mean_deficit": floor}


def fixture(mode, inc, diag, g, evidence, label):
    """The incident's flag rows and the evidence the diagnoser read, as
    JSON (numbers rounded to what the float64 rows carry)."""
    import numpy as np

    from repro_torch.core.events import Layer

    layers = tuple(Layer)
    ev = {}
    for layer, cols in evidence.items():
        if layer.value not in EVIDENCE_LAYERS:
            continue
        ev[layer.value] = {
            k: (cols[k].astype(str).tolist() if cols[k].dtype.kind in "UOS"
                else np.asarray(cols[k], dtype=np.float64).tolist())
            for k in ("ts", "dur", "size", "name", "step", "node", "util",
                      "mem_gb", "power_w", "temp_c") if k in cols}
    return {"what": "a clean-control incident diagnosed on the card",
            "mode": mode, "label": label, "card": card(),
            "engine": {"gap_s": 0.25, "close_after_s": 0.25, "min_flags": 5},
            "layers": [l.value for l in layers],
            "rows": {"ts": g[:, 0].tolist(),
                     "layer": [layers[int(i)].value for i in g[:, 1]],
                     "node": g[:, 2].astype(int).tolist(),
                     "step": g[:, 3].astype(int).tolist(),
                     "deficit": g[:, 4].tolist()},
            "evidence": ev,
            "incident": {"n_flags": inc.n_flags, "severity": inc.severity,
                         "suspect_layer": inc.suspect_layer.value,
                         "layer_deficit": inc.layer_deficit},
            "diagnosis": {"fault_kind": diag.fault_kind,
                          "confidence": diag.confidence,
                          "candidates": diag.candidates}}


def lasting_shift(report, eval_start: int, n: int) -> bool:
    """Whether STEP and OPERATOR each flagged over half the scored steps
    (``eval_start`` to ``n``): a step time that moved and stayed."""
    scored = n - eval_start
    return all(
        k in report.layers
        and sum(s >= eval_start for s in report.layers[k].anomalous_steps)
        > scored / 2 for k in ("step", "operator"))


def threaded_session(dev) -> dict:
    """One monitored training session as `chip_smoke.py`'s ``session_path``
    runs its batch mode: the launcher's legacy probe options, the thread
    executor's sweeps on a CUDA stream of their own."""
    from repro_torch.launch import train

    spec = {"mode": "batch", "probe_options": train.LEGACY_PROBE_OPTIONS}
    size = (["--steps", "200", "--batch", "8", "--seq", "128"]
            if dev.type == "cuda" else
            ["--reduced", "--steps", "60", "--batch", "4", "--seq", "32"])
    out = train.train(train.parser().parse_args(
        ["--arch", "gpt2", "--device", dev.type, *size, "--inject-faults",
         "--log-every", "0", "--monitor-spec", json.dumps(spec)]))
    return {"steps": len(out["losses"]), "steps_per_s": out["steps_per_s"]}


def pass_a_cell(mode, dev, n):
    """Pass A's clean cell: ``one(timed) -> ScenarioRun``, ``timed`` called
    on the cell's session before its first step."""
    from repro_torch.core.chaos import get_scenario
    from repro_torch.eval import matrix, runner

    scenario = get_scenario("clean_control")
    cfg = matrix.CONFIG_GRID["default"]

    def one(timed):
        inner = runner._run_train_steps

        def watched(session, *a):
            timed(session)
            return inner(session, *a)

        runner._run_train_steps = watched
        try:
            return runner.run_scenario(scenario, mode, cfg, n_steps=n,
                                       seed=0, device=dev)
        finally:
            runner._run_train_steps = inner
    return one


def pass_b_cell(mode, dev, n, cells):
    """Pass B's clean cell around the full-width GPT-2 step, built once and
    shared by every cell: ``one(timed) -> ScenarioRun``."""
    import torch

    from repro_torch import quickstart
    from repro_torch.core.chaos import get_scenario
    from repro_torch.eval import runner
    from repro_torch.models.model import batch_to_device
    from repro_torch.session import Session

    batch, seq, data, state, step_fn = quickstart._workload(
        dev.type == "cpu", dev, cells * n + quickstart.SETUP_STEPS)
    for s in range(quickstart.SETUP_STEPS):  # graph capture, first use
        state, _ = step_fn(state, batch_to_device(data.batch(s), dev))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    cfg = runner.EvalConfig()
    scenario = get_scenario("clean_control")
    held = {"state": state}

    def one(timed):
        session = Session(runner.scenario_spec(scenario, mode, n, cfg,
                                               seed=0), device=dev)
        timed(session)
        run, held["state"], _ = runner.run_model_cell(
            session, scenario, n, cfg, step_fn, held["state"], data)
        return run
    return one


def evaluator_runs(n: int, dev) -> int:
    """``--runs``: pass A as the smoke's child runs it, in ``n`` fresh
    processes (this script again, with ``--one-run OUT``)."""
    tmp = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "results", "clean_control_runs")
    rcs, runs = [], []
    for i in range(n):
        out = os.path.join(tmp, f"run{i}")
        shutil.rmtree(out, ignore_errors=True)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one-run",
             out, "--device", dev.type], capture_output=True,
            text=True, timeout=600)
        path = os.path.join(out, "scenario_matrix.json")
        if not os.path.exists(path):
            print(proc.stderr[-2000:], file=sys.stderr)
            return 1
        with open(path) as f:
            rows = json.load(f)["rows"]
        clean = {r["mode"]: {"far": r["metrics"]["false_alarm_rate"],
                             "diagnoses": r["diagnosis"]["kinds"]}
                 for r in rows if r["scenario"] == "clean_control"}
        rcs.append(proc.returncode)
        runs.append(clean)
        print(json.dumps({"run": i, "rc": proc.returncode,
                          "clean_control": clean}), flush=True)
    print(json.dumps({"summary": {
        "runs": n, "failed_runs": sum(bool(rc) for rc in rcs),
        "diagnosed": {m: sum(bool(r[m]["diagnoses"]) for r in runs)
                      for m in ("batch", "stream")},
        "card": card()}}), flush=True)
    return 0


def one_run(out: str, dev) -> int:
    """``--one-run OUT``: the evaluator once, as pass A's child runs it."""
    from repro_torch.launch import evaluate

    argv = ["--scenarios", "smoke", "--modes", "batch,stream", "--device",
            dev.type, "--out", out]
    if dev.type == "cpu":
        argv += ["--steps", "160"]
    return evaluate.main(argv)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", choices=("batch", "stream"))
    ap.add_argument("--runs", type=int, default=0,
                    help="pass A as the smoke runs it, in N fresh processes")
    ap.add_argument("--one-run", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--pass", dest="pass_", choices=("a", "b"), default="b")
    ap.add_argument("--after-session", action="store_true",
                    help="first run one threaded-executor training session")
    ap.add_argument("--cells", type=int, default=20)
    ap.add_argument("--label", default="tree")
    ap.add_argument("--fixture", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: the reduced model, a dry run of the script")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("clean_control_rate: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke's passes
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(args.device)
    if args.one_run:
        return one_run(args.one_run, dev)
    if args.runs:
        return evaluator_runs(args.runs, dev)
    if args.mode is None:
        ap.error("--mode is required without --runs")

    from repro_torch.diagnosis import Diagnoser
    from repro_torch.eval import matrix

    print(card(), flush=True)
    floor = Diagnoser().min_mean_deficit
    n = 240  # chip_smoke.EVAL_STEPS
    if args.after_session:
        print(json.dumps({"after_session": threaded_session(dev)}),
              flush=True)
    one = (pass_a_cell(args.mode, dev, n) if args.pass_ == "a"
           else pass_b_cell(args.mode, dev, n, args.cells))
    cells, fixture_out = [], None
    for cell in range(args.cells):
        step_s, spans = [], []

        def timed(session):  # as chip_smoke's watched_cell
            observe = session.observe_step_fn

            def timed_observe(fn, **kw):
                monitored = observe(fn, **kw)

                def call(*a):
                    t0 = time.perf_counter()
                    out = monitored(*a)
                    t1 = time.perf_counter()
                    step_s.append(t1 - t0)
                    spans.append((t0, t1))
                    return out
                return call

            session.observe_step_fn = timed_observe

        steal0 = steal_s()
        with recorded() as got, collections() as gcs:
            run = one(timed)
        report = run.report
        row = matrix._row(run)
        ms = 1e3 * np.asarray(step_s)
        slow = np.flatnonzero(ms > np.median(ms) + SLOW_MS)
        incs = {i.incident_id: i for i in report.incidents}
        diagnosed = []
        for d in report.diagnoses:
            inc = incs[d.incident_id]
            g = got["groups"][d.incident_id]
            diagnosed.append(incident_line(inc, d, g, floor))
            if args.fixture and fixture_out is None:
                fixture_out = fixture(args.mode, inc, d, g,
                                      got["evidence"].get(d.incident_id, {}),
                                      args.label)
        line = {"cell": cell, "label": args.label, "pass": args.pass_,
                "after_session": args.after_session, "mode": args.mode,
                "far": row["metrics"]["false_alarm_rate"],
                "diagnoses": [d.fault_kind for d in report.diagnoses],
                "incidents": len(report.incidents),
                "incident_flags": [i.n_flags for i in report.incidents],
                "incident_mean_deficit": [
                    round(i.severity / max(i.n_flags, 1), 3)
                    for i in report.incidents],
                "slow_steps": len(slow),
                "slow_at": [int(i) for i in slow],
                "slow_excess_ms": [round(float(ms[i] - np.median(ms)), 3)
                                   for i in slow],
                "steal_s": steal_s() - steal0,
                "gc": gc_line(gcs, spans),
                "step_ms_p50_p90": np.percentile(ms, [50, 90]).tolist(),
                "flagged_steps": {k: [int(x) for x in v.anomalous_steps]
                                  for k, v in report.layers.items()
                                  if len(v.anomalous_steps)},
                "lasting_shift": lasting_shift(report, run.eval_start, n),
                "diagnosed": diagnosed, "wall_s": row["wall_s"]}
        print(json.dumps(line), flush=True)
        cells.append(line)
        del run, report
        gc.collect()
    if fixture_out is not None:
        os.makedirs(os.path.dirname(os.path.abspath(args.fixture)),
                    exist_ok=True)
        with open(args.fixture, "w") as f:
            json.dump(fixture_out, f)
    print(json.dumps({"summary": {
        "label": args.label, "pass": args.pass_,
        "after_session": args.after_session, "mode": args.mode,
        "cells": len(cells),
        "diagnosed_cells": sum(bool(c["diagnoses"]) for c in cells),
        "lasting_shift_cells": sum(c["lasting_shift"] for c in cells),
        "kinds": sorted({k for c in cells for k in c["diagnoses"]}),
        "far_max": max(c["far"] for c in cells),
        "slow_steps_per_cell": float(np.mean([c["slow_steps"]
                                              for c in cells])),
        "gc_over_1ms_in_step_per_cell": float(np.mean(
            [c["gc"]["over_1ms_in_step"] for c in cells])),
        "card": card()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
