"""Self-refreshing single-file HTML fleet status board (port of
`repro/obs/board.py`; pure Python, only this docstring differs).

Pure rendering: `BoardModel` is a plain-data snapshot of the fleet
(`BoardModel.from_obs` builds one from the live `SessionObs`), and
`render_board(model)` turns it into one self-contained HTML document —
inline CSS, inline SVG sparklines, a ``<meta http-equiv="refresh">`` tag,
no JavaScript, no external assets. The ``board`` sink rewrites the file
atomically every flush, so an operator keeps a browser tab open on it while
the fleet runs.

Sections: header strip (mode/uptime/totals), fleet health grid (one card
per node, coloured by freshness state), request-plane tier (when a serve
engine is monitored: throughput, TTFT/TPOT, occupancy, SLO breaches),
per-layer table with flag-rate sparklines from the window snapshot history,
active/recent incidents (tagged by kind: anomaly vs slo_breach), and the
top diagnoses with their recommended actions.
"""
from __future__ import annotations

import dataclasses
import html
from typing import Dict, List, Optional, Sequence

STATE_COLORS = {"healthy": "#2da44e", "degraded": "#d4a72c",
                "stale": "#cf222e"}


@dataclasses.dataclass
class NodeCard:
    node_id: int
    state: str  # healthy | degraded | stale
    freshness_s: float
    events_shipped: int = 0
    bytes_shipped: int = 0
    ring_dropped: int = 0


@dataclasses.dataclass
class GroupCard:
    group_id: int
    state: str  # healthy | degraded | stale
    freshness_s: float
    n_nodes: int = 0
    events_ingested: int = 0
    events_shed: int = 0


@dataclasses.dataclass
class LayerRow:
    layer: str
    window_rows: int
    flag_rate: float
    log_delta: float
    spark: Sequence[float] = ()  # flag-rate history, oldest first


@dataclasses.dataclass
class IncidentRow:
    incident_id: int
    t_start: float
    t_end: float
    suspect_layer: str
    suspect_nodes: Sequence[int]
    severity: float
    n_flags: int
    status: str
    kind: str = "anomaly"  # anomaly | slo_breach


@dataclasses.dataclass
class DiagnosisCard:
    incident_id: int
    fault_kind: str
    confidence: float
    severity: float
    blamed_nodes: Sequence[int]
    causal_chain: Sequence[str]
    action_kind: str
    action_reason: str


@dataclasses.dataclass
class BoardModel:
    """Everything the board shows, as plain data (renderable + testable
    without a live session)."""

    title: str
    mode: str
    generated: str  # human-readable timestamp (caller-supplied)
    uptime_s: float
    refresh_s: int
    nodes: List[NodeCard]
    layers: List[LayerRow]
    incidents: List[IncidentRow]
    diagnoses: List[DiagnosisCard]
    totals: Dict[str, object]  # label -> value footer strip
    # group tier (hierarchical topologies only; empty = flat fleet)
    groups: List[GroupCard] = dataclasses.field(default_factory=list)
    # request-plane tier (serve engine + SLO monitor; empty = no request
    # probe attached) — the raw serve_stats() aggregates
    serve: Dict[str, float] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_obs(cls, obs, history: Dict[str, Sequence[float]],
                 title: str = "eACGM fleet status", generated: str = "",
                 refresh_s: int = 2, max_incidents: int = 10,
                 max_diagnoses: int = 5) -> "BoardModel":
        """Snapshot a live `SessionObs` (+ the board sink's flag-rate
        history) into a model."""
        import time as _time

        session = obs.session
        nodes: List[NodeCard] = []
        groups: List[GroupCard] = []
        agent_stats: Dict[int, dict] = {}
        totals: Dict[str, object] = {}
        backend = session._backend
        if session.spec.mode == "stream" and backend is not None:
            mon = backend.monitor
            agent_stats = {nid: a.stats() for nid, a in mon.agents.items()}
            agg = mon.aggregator
            totals["events ingested"] = agg.events_ingested
            totals["lost batches"] = agg.lost_batches
            totals["detect ticks"] = mon.ticks
            totals["detect ms/tick"] = round(
                1e3 * mon.detect_seconds / max(mon.ticks, 1), 1)
            totals["incidents"] = len(mon.engine.incidents)
            if hasattr(mon, "groups"):  # hierarchical topology
                gstats = {gid: g.stats() for gid, g in mon.groups.items()}
                for gid, state, freshness in obs.group_states():
                    gs = gstats.get(gid, {})
                    agg_s = gs.get("aggregator", {})
                    groups.append(GroupCard(
                        group_id=gid, state=state, freshness_s=freshness,
                        n_nodes=int(gs.get("nodes", 0)),
                        events_ingested=int(
                            agg_s.get("events_ingested", 0)),
                        events_shed=int(
                            agg_s.get("events_shed_at_source", 0))))
                totals["groups"] = len(mon.groups)
                totals["events shed"] = agg.events_shed_at_source
        for nid, state, freshness in obs.node_states():
            st = agent_stats.get(nid, {})
            handle = session._nodes.get(nid)
            dropped = handle.collector.buffer.dropped if handle else 0
            nodes.append(NodeCard(
                node_id=nid, state=state, freshness_s=freshness,
                events_shipped=st.get("events_shipped", 0),
                bytes_shipped=st.get("bytes_shipped", 0),
                ring_dropped=dropped))
        if not nodes:  # batch mode: no wire freshness, show ring health
            for nid, handle in sorted(session._nodes.items()):
                buf = handle.collector.buffer
                nodes.append(NodeCard(node_id=nid, state="healthy",
                                      freshness_s=0.0,
                                      events_shipped=buf.pushed,
                                      ring_dropped=buf.dropped))
        layers = _layer_rows(session, history)
        incidents = [IncidentRow(
            incident_id=i.incident_id, t_start=i.t_start, t_end=i.t_end,
            suspect_layer=i.suspect_layer.value,
            suspect_nodes=list(i.suspect_nodes), severity=i.severity,
            n_flags=i.n_flags, status=i.status,
            kind=getattr(i, "kind", "anomaly"))
            for i in session.incidents_seen()[:max_incidents]]
        diagnoses = [DiagnosisCard(
            incident_id=d.incident_id, fault_kind=d.fault_kind,
            confidence=d.confidence, severity=d.severity,
            blamed_nodes=list(d.blamed_nodes),
            causal_chain=list(d.causal_chain),
            action_kind=d.action.kind, action_reason=d.action.reason)
            for d in session.diagnoses_seen()[:max_diagnoses]]
        return cls(title=title, mode=session.spec.mode,
                   generated=generated or _time.strftime(
                       "%Y-%m-%d %H:%M:%S"),
                   uptime_s=_time.time() - obs._t0, refresh_s=refresh_s,
                   nodes=nodes, layers=layers, incidents=incidents,
                   diagnoses=diagnoses, totals=totals, groups=groups,
                   serve=dict(session.serve_stats()))


def _layer_rows(session, history: Dict[str, Sequence[float]]
                ) -> List[LayerRow]:
    backend = session._backend
    rows: List[LayerRow] = []
    if backend is None:
        return rows
    if session.spec.mode == "stream":
        mon = backend.monitor
        dets = mon.last_detections
        for layer, w in mon.aggregator.windows.items():
            d = dets.get(layer)
            rows.append(LayerRow(
                layer=layer.value, window_rows=len(w),
                flag_rate=d.anomaly_rate if d is not None else 0.0,
                log_delta=float(d.log_delta) if d is not None else 0.0,
                spark=tuple(history.get(layer.value, ()))))
    else:
        for layer, d in backend.flags().items():
            rows.append(LayerRow(
                layer=layer.value, window_rows=int(len(d.flags)),
                flag_rate=d.anomaly_rate, log_delta=float(d.log_delta),
                spark=tuple(history.get(layer.value, ()))))
    return rows


# -- SVG ----------------------------------------------------------------------
def _sparkline(values: Sequence[float], width: int = 140, height: int = 28,
               color: str = "#539bf5") -> str:
    """Inline SVG polyline of a series (empty series -> flat placeholder)."""
    vs = [float(v) for v in values]
    if len(vs) < 2:
        vs = [0.0, 0.0] if not vs else [vs[0], vs[0]]
    lo, hi = min(vs), max(vs)
    span = (hi - lo) or 1.0
    pad = 2
    pts = []
    for i, v in enumerate(vs):
        x = pad + i * (width - 2 * pad) / (len(vs) - 1)
        y = height - pad - (v - lo) / span * (height - 2 * pad)
        pts.append(f"{x:.1f},{y:.1f}")
    return (f'<svg class="spark" width="{width}" height="{height}" '
            f'viewBox="0 0 {width} {height}">'
            f'<polyline fill="none" stroke="{color}" stroke-width="1.5" '
            f'points="{" ".join(pts)}"/></svg>')


_CSS = """
body{background:#0d1117;color:#c9d1d9;font:14px/1.45 -apple-system,'Segoe UI',
  Roboto,Helvetica,Arial,sans-serif;margin:0;padding:18px 26px}
h1{font-size:19px;margin:0 12px 0 0;display:inline}
h2{font-size:13px;text-transform:uppercase;letter-spacing:.08em;
  color:#8b949e;margin:26px 0 8px}
.meta{color:#8b949e;font-size:12px}
.badge{display:inline-block;border-radius:10px;padding:1px 9px;font-size:12px;
  background:#1f6feb;color:#fff;vertical-align:2px;margin-right:8px}
.grid{display:flex;flex-wrap:wrap;gap:10px}
.card{background:#161b22;border:1px solid #30363d;border-radius:8px;
  padding:10px 14px;min-width:150px}
.card .nid{font-weight:600}
.dot{display:inline-block;width:9px;height:9px;border-radius:50%;
  margin-right:6px}
table{border-collapse:collapse;width:100%;background:#161b22;
  border:1px solid #30363d;border-radius:8px}
th,td{text-align:left;padding:6px 12px;border-bottom:1px solid #21262d;
  font-size:13px}
th{color:#8b949e;font-weight:500}
tr:last-child td{border-bottom:none}
.num{text-align:right;font-variant-numeric:tabular-nums}
.spark{vertical-align:middle}
.sev{color:#f85149;font-weight:600}
.action{color:#d4a72c}
.chain{color:#8b949e;font-size:12px}
.empty{color:#8b949e;font-style:italic;padding:8px 0}
.footer{margin-top:26px;color:#8b949e;font-size:12px}
.footer b{color:#c9d1d9}
"""


def _esc(x) -> str:
    return html.escape(str(x))


def render_board(model: BoardModel) -> str:
    """One self-contained HTML document for the fleet status board."""
    out: List[str] = []
    w = out.append
    w("<!DOCTYPE html>")
    w('<html lang="en"><head><meta charset="utf-8">')
    if model.refresh_s > 0:
        w(f'<meta http-equiv="refresh" content="{int(model.refresh_s)}">')
    w(f"<title>{_esc(model.title)}</title>")
    w(f"<style>{_CSS}</style></head><body>")
    w(f"<h1>{_esc(model.title)}</h1>"
      f'<span class="badge">{_esc(model.mode)}</span>'
      f'<span class="meta">generated {_esc(model.generated)} · up '
      f"{model.uptime_s:.0f}s · auto-refresh {int(model.refresh_s)}s</span>")

    w("<h2>Fleet health</h2>")
    if model.nodes:
        w('<div class="grid" id="fleet">')
        for n in model.nodes:
            color = STATE_COLORS.get(n.state, "#8b949e")
            w(f'<div class="card" data-node="{n.node_id}" '
              f'data-state="{_esc(n.state)}">'
              f'<span class="dot" style="background:{color}"></span>'
              f'<span class="nid">node {n.node_id}</span> '
              f'<span class="meta">{_esc(n.state)}</span><br>'
              f'<span class="meta">last event {n.freshness_s:.1f}s ago · '
              f"{n.events_shipped} ev shipped · "
              f"{n.ring_dropped} ring-dropped</span></div>")
        w("</div>")
    else:
        w('<div class="empty">no nodes registered</div>')

    if model.groups:  # hierarchical topologies only
        w("<h2>Group tier</h2>")
        w('<div class="grid" id="groups">')
        for g in model.groups:
            color = STATE_COLORS.get(g.state, "#8b949e")
            w(f'<div class="card" data-group="{g.group_id}" '
              f'data-state="{_esc(g.state)}">'
              f'<span class="dot" style="background:{color}"></span>'
              f'<span class="nid">group {g.group_id}</span> '
              f'<span class="meta">{_esc(g.state)}</span><br>'
              f'<span class="meta">freshness {g.freshness_s:.1f}s · '
              f"{g.n_nodes} node(s) · {g.events_ingested} ev ingested · "
              f"{g.events_shed} shed</span></div>")
        w("</div>")

    if model.serve:  # request plane (serve engine monitored)
        s = model.serve
        breaches = int(s.get("slo_breaches_total", 0))
        b_color = "#cf222e" if breaches else "#2da44e"
        w("<h2>Request plane</h2>")
        w('<div class="grid" id="serve">')
        w(f'<div class="card"><span class="nid">throughput</span><br>'
          f'<span class="meta">{int(s.get("requests_total", 0))} requests '
          f'· {int(s.get("tokens_total", 0))} tokens</span></div>')
        w(f'<div class="card"><span class="nid">latency</span><br>'
          f'<span class="meta">'
          f'TTFT {1e3 * s.get("ttft_mean_s", 0.0):.0f}ms · '
          f'TPOT {1e3 * s.get("tpot_mean_s", 0.0):.0f}ms · '
          f'wait {1e3 * s.get("queue_wait_mean_s", 0.0):.0f}ms</span></div>')
        w(f'<div class="card"><span class="nid">load</span><br>'
          f'<span class="meta">queue {int(s.get("queue_depth", 0))} deep · '
          f'{100 * s.get("occupancy", 0.0):.0f}% slots busy</span></div>')
        w(f'<div class="card"><span class="dot" '
          f'style="background:{b_color}"></span>'
          f'<span class="nid">SLO</span><br>'
          f'<span class="meta">{breaches} breach rows · '
          f'{int(s.get("slo_breach_incidents_total", 0))} incidents'
          f'</span></div>')
        w("</div>")

    w("<h2>Layers</h2>")
    if model.layers:
        w("<table><tr><th>layer</th><th class=num>window rows</th>"
          "<th class=num>flag rate</th><th class=num>log &delta;</th>"
          "<th>flag-rate history</th></tr>")
        for lr in model.layers:
            w(f"<tr><td>{_esc(lr.layer)}</td>"
              f'<td class="num">{lr.window_rows}</td>'
              f'<td class="num">{lr.flag_rate:.3f}</td>'
              f'<td class="num">{lr.log_delta:.2f}</td>'
              f"<td>{_sparkline(lr.spark)}</td></tr>")
        w("</table>")
    else:
        w('<div class="empty">no layer windows yet (warming up)</div>')

    w("<h2>Incidents</h2>")
    if model.incidents:
        w('<table id="incidents"><tr><th>#</th><th>kind</th>'
          "<th>window</th><th>suspect layer</th><th>nodes</th>"
          "<th class=num>severity</th><th class=num>flags</th>"
          "<th>status</th></tr>")
        for i in model.incidents:
            nodes = ",".join(str(n) for n in i.suspect_nodes) or "-"
            w(f'<tr data-kind="{_esc(i.kind)}"><td>{i.incident_id}</td>'
              f"<td>{_esc(i.kind)}</td>"
              f"<td>{i.t_start:.2f}s&ndash;{i.t_end:.2f}s</td>"
              f"<td>{_esc(i.suspect_layer)}</td><td>{_esc(nodes)}</td>"
              f'<td class="num sev">{i.severity:.1f}</td>'
              f'<td class="num">{i.n_flags}</td>'
              f"<td>{_esc(i.status)}</td></tr>")
        w("</table>")
    else:
        w('<div class="empty">no incidents</div>')

    w("<h2>Diagnoses</h2>")
    if model.diagnoses:
        w('<div class="grid" id="diagnoses">')
        for d in model.diagnoses:
            nodes = ",".join(str(n) for n in d.blamed_nodes) or "-"
            chain = " &rarr; ".join(_esc(c) for c in d.causal_chain)
            w(f'<div class="card" data-kind="{_esc(d.fault_kind)}">'
              f"<b>{_esc(d.fault_kind)}</b> "
              f'<span class="meta">incident #{d.incident_id} · '
              f"confidence {d.confidence:.2f} · node(s) {_esc(nodes)}"
              f"</span><br>"
              f'<span class="chain">{chain}</span><br>'
              f'<span class="action">&#9656; {_esc(d.action_kind)}</span> '
              f'<span class="meta">{_esc(d.action_reason)}</span></div>')
        w("</div>")
    else:
        w('<div class="empty">no diagnoses</div>')

    if model.totals:
        parts = [f"{_esc(k)} <b>{_esc(v)}</b>"
                 for k, v in model.totals.items()]
        w(f'<div class="footer">{" · ".join(parts)}</div>')
    w("</body></html>")
    return "\n".join(out) + "\n"
