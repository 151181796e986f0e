#!/usr/bin/env python3
"""What the DEVICE layer saw in clean-control cells, from the rows
`scripts/clean_control_rate.py` writes (``<cell>.device.json``: each
sampler-process sweep's perf_counter time, step, util, mem_gb, power_w and
temp_c, and the spans of the monitor's own detection work).

    PYTHONPATH=src python3 scripts/device_rows.py \\
        'OUT/*_clean_control_batch_nvml_cell*.device.json' \\
        [--lags 0,0.2,1] [--eval-start 96] [--steps 240]

Per cell: the rows, each reading's range and standard deviation over the
clean prefix (steps before ``--eval-start``) and over the live region, and
the DEVICE layer's false-alarm rate as a batch cell scores it — a
`GMMDetector` with the evaluator's defaults (`runner.EvalConfig`: 3
components, contamination 0.02) fitted on the prefix rows, a step flagged
where at least half its rows are (``vote``), runs shorter than
``min_run`` steps dropped — on all rows and on the rows left once those
inside a detection span, or within ``lag`` seconds after one, are
dropped. A summary line last. The DEVICE layer alone, on the CPU: the
other layers and the diagnoser are not replayed.
"""
from __future__ import annotations

import argparse
import glob
import json
import sys

import numpy as np

READINGS = ("util", "mem_gb", "power_w", "temp_c")


def device_far(ts, steps, X, zones, lag, eval_start, n_steps, cfg):
    """The DEVICE layer's FAR over the live region, rows within ``lag`` s
    after a detection span (or inside one) dropped when ``lag`` is not
    None. None when the prefix keeps fewer than ``min_events`` rows."""
    from repro_torch.core.detector import GMMDetector
    from repro_torch.eval.metrics import debounce

    keep = np.ones(len(ts), dtype=bool)
    if lag is not None:
        for a, b in zones:
            keep &= ~((ts >= a) & (ts <= b + lag))
    steps, X = steps[keep], X[keep]
    prefix = (steps >= 0) & (steps < eval_start)
    if prefix.sum() < cfg.min_events:
        return None, int(keep.sum())
    det = GMMDetector(n_components=cfg.n_components,
                      contamination=cfg.contamination, seed=0,
                      device="cpu").fit(X[prefix])
    flags = det.predict(X)
    ok = (steps >= 0) & (steps < n_steps)
    total = np.bincount(steps[ok], minlength=n_steps)
    flagged = np.bincount(steps[ok], weights=flags[ok].astype(np.float64),
                          minlength=n_steps)
    pred = (total > 0) & (flagged >= np.maximum(np.ceil(total * cfg.vote),
                                                1.0))
    pred = debounce(pred, cfg.min_run)
    return float(pred[eval_start:].mean()), int(keep.sum())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("pattern", help="glob of .device.json files")
    ap.add_argument("--lags", default="0,0.2,1",
                    help="seconds after a detection span, comma-separated")
    ap.add_argument("--eval-start", type=int, default=96)
    ap.add_argument("--steps", type=int, default=240)
    args = ap.parse_args(argv)

    from repro_torch.eval.runner import EvalConfig

    cfg = EvalConfig()
    lags = [float(x) for x in args.lags.split(",") if x]
    files = sorted(glob.glob(args.pattern))
    if not files:
        print(f"device_rows: nothing matches {args.pattern}",
              file=sys.stderr)
        return 1
    fars = {"all": []}
    fars.update({f"lag_{lag}": [] for lag in lags})
    for path in files:
        with open(path) as f:
            d = json.load(f)
        rows = np.asarray(d["rows"], dtype=np.float64).reshape(-1, 6)
        ts, steps, X = rows[:, 0], rows[:, 1].astype(np.int64), rows[:, 2:]
        prefix = steps < args.eval_start
        line = {"cell": path, "rows": int(len(rows)),
                "detection_spans": len(d["zones"]),
                "detection_s": round(sum(b - a for a, b in d["zones"]), 3)}
        for i, k in enumerate(READINGS):
            line[k] = {
                part: ([round(float(X[sel, i].min()), 3),
                        round(float(X[sel, i].max()), 3),
                        round(float(X[sel, i].std()), 4)]
                       if sel.any() else None)
                for part, sel in (("prefix", prefix), ("live", ~prefix))}
        far, n = device_far(ts, steps, X, d["zones"], None, args.eval_start,
                            args.steps, cfg)
        line["device_far"] = far
        fars["all"].append(far)
        for lag in lags:
            far, n = device_far(ts, steps, X, d["zones"], lag,
                                args.eval_start, args.steps, cfg)
            line[f"device_far_lag_{lag}"] = [far, n]
            fars[f"lag_{lag}"].append(far)
        print(json.dumps(line), flush=True)
    print(json.dumps({"summary": {
        k: {"cells": len(v), "modelled": sum(x is not None for x in v),
            "far_over_0.15": sum(x is not None and x >= 0.15 for x in v),
            "far_mean": (float(np.mean([x for x in v if x is not None]))
                         if any(x is not None for x in v) else None)}
        for k, v in fars.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
