"""Incident report rendering: incidents + diagnoses -> operator markdown
(port of `repro/diagnosis/report.py`; only the imports differ).

`render_incident_report` produces the page an operator reads when the
monitor pages them: a ranked summary table, then one section per incident
with the causal chain, the evidence that drove the attribution, and the
recommended action with its runbook link (docs/runbook.md documents the
manual playbook per fault kind). The `incident_report` sink
(`repro_torch.session.sinks`) writes this markdown plus a machine-readable JSON
sibling at session close.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

from repro_torch.core.governor import policy_for
from repro_torch.diagnosis.engine import Diagnosis
from repro_torch.stream.incidents import Incident

RUNBOOK_PATH = "docs/runbook.md"


def _fmt_window(t0: float, t1: float) -> str:
    return f"{t0:.2f}s – {t1:.2f}s"


def render_incident_report(incidents: Sequence[Incident],
                           diagnoses: Sequence[Diagnosis],
                           mode: str = "",
                           runbook: str = RUNBOOK_PATH) -> str:
    """The operator-facing markdown incident report."""
    by_id: Dict[int, Diagnosis] = {d.incident_id: d for d in diagnoses}
    ranked = sorted(incidents, key=lambda i: -i.severity)
    lines: List[str] = ["# Incident report", ""]
    if mode:
        lines += [f"Monitoring mode: `{mode}`.", ""]
    if not ranked:
        lines += ["No incidents: the run stayed within its fitted baseline "
                  "on every layer.", ""]
        return "\n".join(lines)
    lines += [
        f"{len(ranked)} incident(s), ranked by severity; "
        f"{len(by_id)} diagnosed.",
        "",
        "| # | window | suspect layer | node(s) | severity | fault kind "
        "| confidence | action |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for inc in ranked:
        d = by_id.get(inc.incident_id)
        nodes = ",".join(str(n) for n in inc.suspect_nodes) or "?"
        kind = f"`{d.fault_kind}`" if d else "—"
        conf = f"{d.confidence:.2f}" if d else "—"
        act = f"`{d.action.kind}`" if d else "—"
        lines.append(
            f"| {inc.incident_id} | {_fmt_window(inc.t_start, inc.t_end)} "
            f"| {inc.suspect_layer.value} | {nodes} | {inc.severity:.1f} "
            f"| {kind} | {conf} | {act} |")
    lines.append("")
    for inc in ranked:
        d = by_id.get(inc.incident_id)
        lines += _incident_section(inc, d, runbook)
    return "\n".join(lines)


def _incident_section(inc: Incident, d: Optional[Diagnosis],
                      runbook: str) -> List[str]:
    lines = [f"## Incident {inc.incident_id}", ""]
    nodes = ",".join(str(n) for n in inc.suspect_nodes) or "?"
    lines += [
        f"* window: {_fmt_window(inc.t_start, inc.t_end)} "
        f"({inc.n_flags} flags, steps {_steps_str(inc.steps)})",
        f"* suspect: layer `{inc.suspect_layer.value}`, node(s) {nodes}",
        "* layer deficit: " + ", ".join(
            f"`{k}`={v:.1f}" for k, v in sorted(
                inc.layer_deficit.items(), key=lambda kv: -kv[1])),
    ]
    if d is None:
        lines += ["", "_Undiagnosed: the per-flag deficit sits inside the calibration band (see docs/diagnosis.md) — indistinguishable from detector false positives._", ""]
        return lines
    pol = policy_for(d.fault_kind)
    anchor = f"{runbook}#{pol.runbook}" if pol.runbook else runbook
    lines += [
        f"* diagnosis: **`{d.fault_kind}`** ({d.family}), "
        f"confidence {d.confidence:.2f}",
        f"* causal chain: {d.chain_str()}",
        f"* candidates: " + ", ".join(
            f"`{k}`={v:.2f}" for k, v in d.candidates.items()),
    ]
    ev = {k: v for k, v in d.evidence.items() if k != "corroborated"}
    if ev:
        lines.append("* evidence: " + ", ".join(
            f"{k}={v}" for k, v in sorted(ev.items())))
    if not d.evidence.get("corroborated", True):
        lines.append("* _attribution from deficit shares only — no "
                     "corroborating telemetry in the evidence window_")
    lines += [
        "",
        f"**Recommended action: `{d.action.kind}`** — {d.action.reason}",
        "",
        f"Playbook: [{d.fault_kind}]({anchor})",
        "",
    ]
    return lines


def _steps_str(steps: Sequence[int]) -> str:
    s = sorted(steps)
    if not s:
        return "-"
    if len(s) > 6:
        return f"{s[0]}..{s[-1]} ({len(s)} steps)"
    return ",".join(str(x) for x in s)


def report_json(incidents: Sequence[Incident],
                diagnoses: Sequence[Diagnosis]) -> str:
    """The machine-readable sibling of the markdown report."""
    by_id = {d.incident_id: d for d in diagnoses}
    return json.dumps(
        [{"incident": inc.to_json(),
          "diagnosis": (by_id[inc.incident_id].to_json()
                        if inc.incident_id in by_id else None)}
         for inc in sorted(incidents, key=lambda i: -i.severity)],
        indent=1, default=float)
