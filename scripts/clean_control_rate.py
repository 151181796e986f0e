#!/usr/bin/env python3
"""How often the evaluation's clean control is diagnosed, on one NVIDIA GPU.

    PYTHONPATH=src python3 scripts/clean_control_rate.py --mode stream \
        [--cells 20] [--label NAME] [--fixture PATH]

Builds the clean-control cell of `chip_smoke.py`'s eval pass B with the
functions `eval_pass_b` calls (`runner.scenario_spec`,
`runner.run_model_cell` and `matrix._row`, around the full-width GPT-2 124M
step: bf16, batch 8, sequence 128, CUDA-graphed, built once by
`quickstart._workload` with its set-up calls made before the first cell)
and runs it ``--cells`` times in ``--mode`` (batch or stream), in this one
process. Run one process per mode and per condition: the package measured
is the ``repro_torch`` on ``PYTHONPATH``, so two trees are two conditions.

One JSON line per cell: its false-alarm rate, its diagnoses, the steps
slower than the cell's median by over 0.5 ms (which, and by how much), the
CPU time the hypervisor took meanwhile (/proc/stat's steal), the
monitored step's ms
(p50, p90) and, for every diagnosed incident, its steps, its flags per
layer, ``layer_deficit``, the mean deficit per flag against the
diagnoser's floor (``min_mean_deficit``) and the blamed kind's share. A
summary line last. With ``--fixture``, the first diagnosed incident's flag
rows (ts, layer, node, step, deficit) and the device and collective
evidence the diagnoser read are written there as JSON, for
``tests/test_torch_diagnosis_parity.py``.

Needs a card; ~7 s a cell after ~30 s of set-up.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", choices=("batch", "stream"), required=True)
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
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke's pass B
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch import quickstart
    from repro_torch.core.chaos import get_scenario
    from repro_torch.diagnosis import Diagnoser
    from repro_torch.eval import matrix, runner
    from repro_torch.models.model import batch_to_device
    from repro_torch.session import Session

    print(card(), flush=True)
    floor = Diagnoser().min_mean_deficit
    dev = torch.device(args.device)
    n = 240  # chip_smoke.EVAL_STEPS
    batch, seq, data, state, step_fn = quickstart._workload(
        dev.type == "cpu", dev, args.cells * n + quickstart.SETUP_STEPS)
    for s in range(quickstart.SETUP_STEPS):  # graph capture, first use
        state, _ = step_fn(state, batch_to_device(data.batch(s), dev))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    cfg = runner.EvalConfig()
    scenario = get_scenario("clean_control")
    cells, fixture_out = [], None
    for cell in range(args.cells):
        session = Session(runner.scenario_spec(scenario, args.mode, n, cfg,
                                               seed=0), device=dev)
        step_s = []
        observe = session.observe_step_fn

        def timed_observe(fn, **kw):  # as chip_smoke's watched_cell
            monitored = observe(fn, **kw)

            def call(*a):
                t0 = time.perf_counter()
                out = monitored(*a)
                step_s.append(time.perf_counter() - t0)
                return out
            return call

        session.observe_step_fn = timed_observe
        steal0 = steal_s()
        with recorded() as got:
            run, state, _ = runner.run_model_cell(session, scenario, n, cfg,
                                                  step_fn, state, data)
        session.observe_step_fn = observe
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
        line = {"cell": cell, "label": args.label, "mode": args.mode,
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
                "step_ms_p50_p90": np.percentile(ms, [50, 90]).tolist(),
                "diagnosed": diagnosed, "wall_s": row["wall_s"]}
        print(json.dumps(line), flush=True)
        cells.append(line)
        del session, run, report
        gc.collect()
    if fixture_out is not None:
        os.makedirs(os.path.dirname(os.path.abspath(args.fixture)),
                    exist_ok=True)
        with open(args.fixture, "w") as f:
            json.dump(fixture_out, f)
    print(json.dumps({"summary": {
        "label": args.label, "mode": args.mode, "cells": len(cells),
        "diagnosed_cells": sum(bool(c["diagnoses"]) for c in cells),
        "kinds": sorted({k for c in cells for k in c["diagnoses"]}),
        "far_max": max(c["far"] for c in cells),
        "slow_steps_per_cell": float(np.mean([c["slow_steps"]
                                              for c in cells])),
        "card": card()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
