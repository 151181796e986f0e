"""Scenario-matrix evaluation entry point (port of `repro/launch/evaluate.py`).

    PYTHONPATH=src python -m repro_torch.launch.evaluate --scenarios all \
        --out results/eval/

Runs the named chaos scenarios through the Session API in batch and stream
modes, scores detections AND diagnoses against the injected ground truth,
and writes ``scenario_matrix.json`` + ``leaderboard.md`` to ``--out``.
Exits non-zero when the clean-control scenario (if included) breaches the
documented false-alarm ceiling or emits any diagnosis, or when mean
blamed-kind accuracy over the faulted cells falls below ``--min-kind-acc``
— CI runs ``--scenarios smoke`` as a detection-and-diagnosis-quality
regression gate. See docs/evaluation.md and docs/diagnosis.md.

Runs on ``cuda`` unless ``--device cpu`` is given; without a card it
raises. ``--scenarios serve-smoke`` runs the request plane's gate: the
serve clean control must close zero SLO-breach incidents, and every
faulted serve cell must raise one (``--min-breach-recall``).
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.core.chaos import (SERVE_SMOKE_SCENARIOS, SMOKE_SCENARIOS,
                                    scenario_names)
from repro_torch.eval.matrix import (BAKEOFF_CONFIGS, CONFIG_GRID,
                                     FAR_CEILING, MODES,
                                     clean_control_diagnoses,
                                     clean_control_far, mean_kind_accuracy,
                                     render_leaderboard, run_matrix,
                                     save_matrix, serve_breach_recall,
                                     serve_clean_breaches)

def _resolve_scenarios(arg: str) -> list:
    if arg == "all":
        return scenario_names()
    if arg == "smoke":
        return list(SMOKE_SCENARIOS)
    if arg == "serve-smoke":
        return list(SERVE_SMOKE_SCENARIOS)
    names = [s for s in arg.split(",") if s]
    known = set(scenario_names())
    unknown = sorted(set(names) - known)
    if unknown:
        raise SystemExit(f"unknown scenario(s) {unknown}; "
                         f"available: {', '.join(sorted(known))} "
                         "(or 'all' / 'smoke')")
    return names


def _resolve_configs(arg: str) -> list:
    if arg == "grid":
        return list(CONFIG_GRID)
    if arg == "bakeoff":
        return list(BAKEOFF_CONFIGS)
    names = [c for c in arg.split(",") if c]
    unknown = sorted(set(names) - set(CONFIG_GRID))
    if unknown:
        raise SystemExit(f"unknown config(s) {unknown}; "
                         f"available: {', '.join(CONFIG_GRID)} "
                         "(or 'grid' / 'bakeoff')")
    return names


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scenarios", default="smoke",
                    help="'all', 'smoke', 'serve-smoke', or a "
                         "comma-separated list "
                         f"(all = {', '.join(scenario_names())})")
    ap.add_argument("--modes", default=",".join(MODES),
                    help="comma-separated subset of batch,stream")
    ap.add_argument("--configs", default="default",
                    help="'grid', 'bakeoff' (one config per detector "
                         "family), or a comma-separated subset of "
                         f"{', '.join(CONFIG_GRID)}")
    ap.add_argument("--steps", type=int, default=240,
                    help="steps per scenario run")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="where the monitored step and the detectors run")
    ap.add_argument("--out", default="results/eval",
                    help="output directory for scenario_matrix.json + "
                         "leaderboard.md")
    ap.add_argument("--far-ceiling", type=float, default=FAR_CEILING,
                    help="max allowed clean-control false-alarm rate "
                         "(exit 1 above it)")
    ap.add_argument("--min-kind-acc", type=float, default=0.5,
                    help="min mean blamed-kind accuracy over faulted cells "
                         "(exit 1 below it; set 0 to disable)")
    ap.add_argument("--min-breach-recall", type=float, default=1.0,
                    help="min SLO-breach recall over faulted serve cells "
                         "(exit 1 below it; the request plane is judged on "
                         "a deterministic virtual clock, so 1.0 is "
                         "achievable; set 0 to disable)")
    args = ap.parse_args(argv)

    scenarios = _resolve_scenarios(args.scenarios)
    modes = [m for m in args.modes.split(",") if m]
    bad_modes = sorted(set(modes) - set(MODES))
    if bad_modes:
        raise SystemExit(f"unknown mode(s) {bad_modes}; pick from {MODES}")
    configs = _resolve_configs(args.configs)

    if args.steps < 160:
        print(f"[eval] WARNING: --steps {args.steps} leaves a "
              f"<{int(args.steps * 0.4)}-step clean reference; thresholds "
              "calibrate poorly below ~160 steps and false-alarm rates "
              "become meaningless", file=sys.stderr)
    n_cells = len(scenarios) * len(modes) * len(configs)
    print(f"[eval] {len(scenarios)} scenario(s) x {len(modes)} mode(s) x "
          f"{len(configs)} config(s) = {n_cells} runs, "
          f"{args.steps} steps each, on {args.device}")

    def progress(row):
        m = row["metrics"]
        dg = row.get("diagnosis", {})
        acc = dg.get("kind_accuracy")
        acc_s = f"{100 * acc:5.1f}%" if acc is not None else "    —"
        if "slo" in row:
            s = row["slo"]
            print(f"[eval] {row['scenario']:<22} {row['mode']:<6} "
                  f"{row['config']:<14} "
                  f"breach_inc={s['incidents_total']} "
                  f"windows={s['windows_detected']}/{s['windows_total']} "
                  f"spurious={s['spurious']} "
                  f"diag={dg.get('diagnoses_total', 0)} kind_acc={acc_s} "
                  f"({row['wall_s']:.1f}s)", flush=True)
            return
        print(f"[eval] {row['scenario']:<22} {row['mode']:<6} "
              f"{row['config']:<14} F1={100 * m['f1']:5.1f}% "
              f"FAR={100 * m['false_alarm_rate']:5.1f}% "
              f"faults={m['faults_detected']}/{m['faults_total']} "
              f"diag={dg.get('diagnoses_total', 0)} kind_acc={acc_s} "
              f"({row['wall_s']:.1f}s)", flush=True)

    matrix = run_matrix(scenarios, modes=modes, configs=configs,
                        n_steps=args.steps, seed=args.seed,
                        progress=progress, device=args.device)
    matrix["far_ceiling"] = args.far_ceiling
    paths = save_matrix(matrix, args.out)
    print(f"[eval] wrote {paths['matrix']} and {paths['leaderboard']}")
    print()
    print(render_leaderboard(matrix))

    failed = False
    far = clean_control_far(matrix)
    if far is not None and far >= args.far_ceiling:
        print(f"[eval] FAIL: clean-control false-alarm rate "
              f"{100 * far:.1f}% >= ceiling {100 * args.far_ceiling:.0f}%",
              file=sys.stderr)
        failed = True
    n_diag = clean_control_diagnoses(matrix)
    if n_diag:
        print(f"[eval] FAIL: {n_diag} diagnosis(es) on the clean-control "
              "scenario (must be 0 — see docs/diagnosis.md)",
              file=sys.stderr)
        failed = True
    acc = mean_kind_accuracy(matrix)
    if acc is not None and acc < args.min_kind_acc:
        print(f"[eval] FAIL: mean blamed-kind accuracy {100 * acc:.1f}% < "
              f"{100 * args.min_kind_acc:.0f}% (--min-kind-acc)",
              file=sys.stderr)
        failed = True
    n_breach = serve_clean_breaches(matrix)
    if n_breach:
        print(f"[eval] FAIL: {n_breach} SLO-breach incident(s) on the serve "
              "clean control (must be 0 — see docs/serving.md)",
              file=sys.stderr)
        failed = True
    expected_cells = sorted({
        (kind, r["mode"]) for r in matrix["rows"]
        if r["workload"] != "request" and r["metrics"]["faults_total"]
        for kind in r["kinds"]})
    if expected_cells:
        crowned = {(w["kind"], w["mode"])
                   for w in matrix.get("winners", [])}
        missing = [c for c in expected_cells if c not in crowned]
        if missing:
            print(f"[eval] FAIL: no crowned winner for fault-kind x mode "
                  f"cell(s) {missing} — the bake-off table must cover "
                  "every faulted cell", file=sys.stderr)
            failed = True
    br = serve_breach_recall(matrix)
    if br is not None and br < args.min_breach_recall:
        print(f"[eval] FAIL: serve breach recall {100 * br:.1f}% < "
              f"{100 * args.min_breach_recall:.0f}% (--min-breach-recall)",
              file=sys.stderr)
        failed = True
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
