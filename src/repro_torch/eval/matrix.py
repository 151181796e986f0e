"""The scenario matrix: scenarios x modes x detector configs -> artifacts
(port of `repro/eval/matrix.py`).

`run_matrix` executes every requested cell through `run_scenario` and
returns one machine-readable dict; `save_matrix` writes it as
``scenario_matrix.json`` next to a rendered ``leaderboard.md``. CI runs the
smoke subset and holds the clean-control scenario's false-alarm rate below
`FAR_CEILING` — the detection-quality analogue of a perf-regression gate.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional, Sequence

from repro_torch.core.chaos import get_scenario
from repro_torch.device import DeviceLike
from repro_torch.eval.runner import EvalConfig, run_scenario

# documented false-alarm ceiling for the clean-control scenario (step-level
# false-alarm rate over the live region, either mode) — see
# docs/evaluation.md#false-alarm-ceiling before changing it. Typical runs
# sit at 0-8%; the ceiling leaves room for host timing noise (the latency
# layers measure REAL wall time, and CI machines have noisy neighbours).
FAR_CEILING = 0.15

MODES = ("batch", "stream")

# the named config axis: detector variants the matrix sweeps. "default" is
# the tuned GMM operating point; the single-knob variants (components K,
# window width, warm-start) keep regressions attributable, and the family
# configs put every registered detector backend on the same scenarios for
# the bake-off.
CONFIG_GRID: Dict[str, EvalConfig] = {
    c.name: c for c in (
        EvalConfig(name="default"),
        EvalConfig(name="k2", n_components=2),
        EvalConfig(name="k5", n_components=5),
        EvalConfig(name="wide_window", flush_every=40, sweep_every=120),
        EvalConfig(name="narrow_window", flush_every=10, sweep_every=30),
        EvalConfig(name="no_warm_start", warm_start=False),
        EvalConfig(name="isoforest", backend="isoforest", diagnosis=False),
        EvalConfig(name="mad", backend="mad", diagnosis=False),
        EvalConfig(name="spectral", backend="spectral", diagnosis=False),
    )
}

# the bake-off slice: one config per detector family, identical everywhere
# else, so per-cell wins measure the family and not the tuning
BAKEOFF_CONFIGS = ("default", "isoforest", "mad", "spectral")


def run_matrix(scenarios: Sequence[str], modes: Sequence[str] = MODES,
               configs: Sequence[str] = ("default",), n_steps: int = 240,
               seed: int = 0, progress=None,
               device: DeviceLike = None) -> Dict[str, object]:
    """Run every (scenario, mode, config) cell on ``device`` (``cuda``
    unless the CPU is asked for); returns the matrix dict."""
    rows: List[Dict[str, object]] = []
    for name in scenarios:
        scenario = get_scenario(name)
        for mode in modes:
            for cname in configs:
                cfg = CONFIG_GRID[cname] if isinstance(cname, str) else cname
                run = run_scenario(scenario, mode, cfg, n_steps=n_steps,
                                   seed=seed, device=device)
                row = _row(run)
                rows.append(row)
                if progress is not None:
                    progress(row)
    return {
        "n_steps": n_steps,
        "seed": seed,
        "modes": list(modes),
        "configs": {c: _config_json(CONFIG_GRID[c]) for c in configs
                    if isinstance(c, str) and c in CONFIG_GRID},
        "far_ceiling": FAR_CEILING,
        "rows": rows,
        "winners": crown_winners(rows),
    }


def _config_json(cfg: EvalConfig) -> Dict[str, object]:
    import dataclasses

    return dataclasses.asdict(cfg)


def _detect_cost_ms(run) -> Optional[float]:
    """Per-window detection cost (ms) from the report's overhead section.

    Stream cells report the monitor's own ``detect_ms_per_tick`` (one tick
    = one window); batch cells derive it from the detection executor's
    busy-time over completed sweeps. None when the cell never swept."""
    overhead = run.report.overhead or {}
    stream = overhead.get("stream") or {}
    cost = stream.get("detect_ms_per_tick")
    if cost is None:
        plane = overhead.get("detect_plane") or {}
        completed = plane.get("completed") or 0
        if completed:
            cost = 1e3 * float(plane.get("busy_seconds", 0.0)) / completed
    return None if cost is None else round(float(cost), 3)


def _row(run) -> Dict[str, object]:
    m = run.metrics()
    row: Dict[str, object] = {
        "scenario": run.scenario.name,
        "workload": run.scenario.workload,
        "kinds": list(run.scenario.kinds),
        "expected_layers": list(run.scenario.expected_layers),
        "mode": run.mode,
        "config": run.config.name,
        "detector": run.config.backend,
        "detect_ms_per_window": _detect_cost_ms(run),
        "eval_start": run.eval_start,
        "fault_windows": [list(w) for w in run.windows],
        "metrics": m.to_json(),
        "layers": {name: {"anomaly_rate": ls.anomaly_rate,
                          "events": ls.events,
                          "first_flag_ts": ls.first_flag_ts}
                   for name, ls in run.report.layers.items()},
        "wall_s": round(run.wall_s, 2),
    }
    im = run.incident_match()
    if im is not None:
        row["incidents"] = {"count": len(run.report.incidents),
                            **im.to_json()}
    if run.config.diagnosis:
        dm = run.diagnosis_metrics()
        row["diagnosis"] = {
            "kinds": [d.fault_kind for d in run.report.diagnoses],
            "actions": [d.action.kind for d in run.report.diagnoses],
            **dm.to_json()}
    if run.scenario.workload == "request":
        row["slo"] = run.slo_metrics().to_json()
    return row


def clean_control_far(matrix: Dict[str, object]) -> Optional[float]:
    """Worst clean-control false-alarm rate across modes/configs (None when
    the scenario was not part of the matrix)."""
    fars = [r["metrics"]["false_alarm_rate"] for r in matrix["rows"]
            if r["scenario"] == "clean_control"]
    return max(fars) if fars else None


def clean_control_diagnoses(matrix: Dict[str, object]) -> Optional[int]:
    """Total diagnoses emitted on the clean-control scenario across
    modes/configs — the no-false-diagnosis gate holds this at zero (None
    when the scenario was not part of the matrix)."""
    counts = [r["diagnosis"]["diagnoses_total"] for r in matrix["rows"]
              if r["scenario"] == "clean_control" and "diagnosis" in r]
    return sum(counts) if counts else None


def serve_clean_breaches(matrix: Dict[str, object]) -> Optional[int]:
    """Total SLO-breach incidents on the serve clean control across
    modes — the request-plane no-false-page gate holds this at zero (None
    when the scenario was not part of the matrix)."""
    counts = [r["slo"]["incidents_total"] for r in matrix["rows"]
              if r["scenario"] == "serve_clean_control" and "slo" in r]
    return sum(counts) if counts else None


def serve_breach_recall(matrix: Dict[str, object]) -> Optional[float]:
    """Mean breach-incident recall over the FAULTED serve cells (None when
    none is present): did every serve fault window raise an incident?"""
    recalls = [r["slo"]["recall"] for r in matrix["rows"]
               if "slo" in r and r["slo"]["windows_total"] > 0]
    return float(sum(recalls) / len(recalls)) if recalls else None


def mean_kind_accuracy(matrix: Dict[str, object]) -> Optional[float]:
    """Mean blamed-kind accuracy over the FAULTED cells (None when no
    faulted scenario is present). Cells that produced no diagnoses on a
    faulted run count as 0; clean-control cells are excluded — a spurious
    clean diagnosis is already caught by the clean_control_diagnoses gate
    and must not be double-counted here."""
    accs = [r["diagnosis"]["kind_accuracy"] for r in matrix["rows"]
            if "diagnosis" in r
            and r["diagnosis"]["windows_total"] > 0
            and r["diagnosis"]["kind_accuracy"] is not None]
    return float(sum(accs) / len(accs)) if accs else None


# -- per-cell winners ---------------------------------------------------------

def _cell_quality(row: Dict[str, object]) -> tuple:
    """Ranking key within a (fault kind, mode) cell: quality first (F1 to
    4 places — ties at that resolution are noise), then cheaper detection
    (unknown cost ranks below any measured cost)."""
    f1 = row["metrics"]["f1"] or 0.0
    cost = row.get("detect_ms_per_window")
    return (round(float(f1), 4), -(float("inf") if cost is None else cost))


def _winner_entry(row: Dict[str, object]) -> Dict[str, object]:
    m = row["metrics"]
    return {"detector": row.get("detector", "gmm"),
            "config": row["config"],
            "scenario": row["scenario"],
            "f1": m["f1"],
            "recall": m["recall"],
            "false_alarm_rate": m["false_alarm_rate"],
            "detect_ms_per_window": row.get("detect_ms_per_window")}


def crown_winners(rows: List[Dict[str, object]]
                  ) -> List[Dict[str, object]]:
    """The bake-off verdict: per fault-kind x mode cell, the best detector
    family (quality-first, detection cost as the tiebreak).

    Request-workload cells are excluded — the SLO plane thresholds them
    without any detector family in the loop. Within a cell each family is
    first reduced to its best row (families can enter under several
    configs), then families compete; the runner-up is kept so the margin
    is visible in the leaderboard."""
    cells: Dict[tuple, List[Dict[str, object]]] = {}
    for row in rows:
        if row["workload"] == "request" or not row["metrics"]["faults_total"]:
            continue
        for kind in row["kinds"]:
            cells.setdefault((kind, row["mode"]), []).append(row)
    winners: List[Dict[str, object]] = []
    for (kind, mode) in sorted(cells):
        best_by_family: Dict[str, Dict[str, object]] = {}
        for row in cells[(kind, mode)]:
            fam = row.get("detector", "gmm")
            cur = best_by_family.get(fam)
            if cur is None or _cell_quality(row) > _cell_quality(cur):
                best_by_family[fam] = row
        ranked = sorted(best_by_family.values(), key=_cell_quality,
                        reverse=True)
        winners.append({
            "kind": kind,
            "mode": mode,
            "winner": _winner_entry(ranked[0]),
            "runner_up": (_winner_entry(ranked[1])
                          if len(ranked) > 1 else None),
            "families": {fam: _winner_entry(r)
                         for fam, r in sorted(best_by_family.items())},
        })
    return winners


# -- rendering ----------------------------------------------------------------

def _fmt(x, pct: bool = False) -> str:
    if x is None:
        return "—"
    return f"{100 * x:.1f}%" if pct else f"{x:.1f}"


def render_leaderboard(matrix: Dict[str, object]) -> str:
    """The scenario matrix as a markdown leaderboard (one row per cell)."""
    lines = [
        "# Scenario-matrix leaderboard",
        "",
        f"{matrix['n_steps']} steps/run, seed {matrix['seed']}; metrics are "
        "step-level over the live region (see docs/evaluation.md). "
        f"Clean-control false-alarm ceiling: {100 * matrix['far_ceiling']:.0f}%.",
        "",
        "| scenario | workload | mode | config | detector | precision "
        "| recall | F1 | FAR | TTD (steps) | detect ms/win | faults hit "
        "| diag | kind acc | action match |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    rows = sorted(matrix["rows"],
                  key=lambda r: (r["scenario"], r["mode"], r["config"]))
    for r in rows:
        m = r["metrics"]
        faulty = bool(m["faults_total"])
        faults = (f"{m['faults_detected']}/{m['faults_total']}"
                  if faulty else "—")
        # P/R/F1 are vacuous without labelled-anomalous steps: FAR is the
        # clean-control scenario's headline number
        prf = [_fmt(m[k] if faulty else None, pct=True)
               for k in ("precision", "recall", "f1")]
        dg = r.get("diagnosis", {})
        cost = r.get("detect_ms_per_window")
        lines.append(
            f"| {r['scenario']} | {r['workload']} | {r['mode']} "
            f"| {r['config']} | {r.get('detector', 'gmm')} "
            f"| {prf[0]} | {prf[1]} | {prf[2]} "
            f"| {_fmt(m['false_alarm_rate'], pct=True)} "
            f"| {_fmt(m['ttd_steps'])} "
            f"| {'—' if cost is None else f'{cost:.2f}'} | {faults} "
            f"| {dg.get('diagnoses_total', '—')} "
            f"| {_fmt(dg.get('kind_accuracy'), pct=True)} "
            f"| {_fmt(dg.get('action_match_rate'), pct=True)} |")
    winners = matrix.get("winners") or []
    if winners:
        lines += [
            "",
            "## Per-cell winners",
            "",
            "Best detector family per fault-kind x mode cell; quality "
            "(F1) first, per-window detection cost breaks ties.",
            "",
            "| fault kind | mode | winner | F1 | FAR | detect ms/win "
            "| runner-up |",
            "|---|---|---|---|---|---|---|",
        ]
        for w in winners:
            win, ru = w["winner"], w["runner_up"]
            cost = win["detect_ms_per_window"]
            ru_txt = ("—" if ru is None else
                      f"{ru['detector']} ({_fmt(ru['f1'], pct=True)})")
            lines.append(
                f"| {w['kind']} | {w['mode']} | **{win['detector']}** "
                f"| {_fmt(win['f1'], pct=True)} "
                f"| {_fmt(win['false_alarm_rate'], pct=True)} "
                f"| {'—' if cost is None else f'{cost:.2f}'} "
                f"| {ru_txt} |")
    far = clean_control_far(matrix)
    if far is not None:
        verdict = "PASS" if far < matrix["far_ceiling"] else "FAIL"
        lines += ["", f"Clean-control FAR: {100 * far:.1f}% "
                      f"(ceiling {100 * matrix['far_ceiling']:.0f}%) — "
                      f"**{verdict}**"]
    n_diag = clean_control_diagnoses(matrix)
    if n_diag is not None:
        verdict = "PASS" if n_diag == 0 else "FAIL"
        lines += [f"Clean-control diagnoses: {n_diag} (must be 0) — "
                  f"**{verdict}**"]
    acc = mean_kind_accuracy(matrix)
    if acc is not None:
        lines += [f"Mean blamed-kind accuracy over faulted cells: "
                  f"{100 * acc:.1f}%"]
    n_breach = serve_clean_breaches(matrix)
    if n_breach is not None:
        verdict = "PASS" if n_breach == 0 else "FAIL"
        lines += [f"Serve clean-control SLO-breach incidents: {n_breach} "
                  f"(must be 0) — **{verdict}**"]
    br = serve_breach_recall(matrix)
    if br is not None:
        lines += [f"Serve fault-window breach recall: {100 * br:.1f}%"]
    return "\n".join(lines) + "\n"


def save_matrix(matrix: Dict[str, object], out_dir: str) -> Dict[str, str]:
    """Write scenario_matrix.json + leaderboard.md under ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    paths = {"matrix": os.path.join(out_dir, "scenario_matrix.json"),
             "leaderboard": os.path.join(out_dir, "leaderboard.md")}
    with open(paths["matrix"], "w") as f:
        json.dump(matrix, f, indent=1, default=float)
    with open(paths["leaderboard"], "w") as f:
        f.write(render_leaderboard(matrix))
    return paths
