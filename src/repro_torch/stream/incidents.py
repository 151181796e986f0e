"""Incident engine: raw per-layer flags -> ranked cross-node incidents
(port of `repro/stream/incidents.py`; only the imports differ).

A production fleet monitor cannot page an operator per flagged event — a
single faulty NIC produces thousands of collective-layer flags across every
node in the ring. The engine turns window detections into a small number of
`Incident` records by

1. pooling flagged rows from all layers/nodes,
2. clustering them in time (flags separated by less than ``gap_s`` belong to
   the same incident),
3. attributing each cluster: the **suspect layer** is the non-symptom layer
   with the largest total score deficit (the STEP layer flags for *every*
   fault — it is the symptom, not the cause), the **suspect nodes** are the
   nodes carrying the bulk of that layer's deficit,
4. ranking by severity (total deficit, i.e. how far below delta the density
   fell, summed over flags).

Clusters are held open while new flags keep arriving and finalised once the
stream has moved ``close_after_s`` past their last flag.

The engine accepts batch `DetectionResult`s alongside streaming
`WindowDetection`s (the session's batch finalise runs its final sweep
through a fresh engine), and finalised incidents feed the root-cause
diagnoser (the JAX package's `repro/diagnosis/`, not ported yet) —
``layer_first_ts`` is recorded per incident so the diagnoser can order the
causal chain by deficit lead/lag.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.events import Layer
from repro_torch.stream.online import WindowDetection

# layers that aggregate the whole stack: never blamed while a specific layer
# also carries deficit
SYMPTOM_LAYERS = (Layer.STEP,)


@dataclasses.dataclass
class Incident:
    incident_id: int
    t_start: float
    t_end: float
    suspect_layer: Layer
    suspect_nodes: List[int]
    severity: float  # total score deficit across flags
    n_flags: int
    steps: List[int]  # anomalous step ids (union over layers)
    layer_deficit: Dict[str, float]  # layer -> summed (delta - score)
    node_flags: Dict[int, int]  # node -> flag count
    status: str = "open"  # open | closed
    # layer -> earliest flagged-event ts in this incident. The diagnosis
    # engine reads this as the causal lead/lag ordering: the layer that
    # flagged first leads the chain (see the JAX package's repro/diagnosis).
    layer_first_ts: Dict[str, float] = dataclasses.field(default_factory=dict)
    # "anomaly" (GMM density flags) or "slo_breach" (request-plane SLO
    # thresholding, see the JAX package's repro/serve/slo.py) — the two
    # planes cluster through the same engine but are reported and diagnosed
    # separately
    kind: str = "anomaly"

    def to_json(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        d["suspect_layer"] = self.suspect_layer.value
        return d

    def render(self) -> str:
        nodes = ",".join(str(n) for n in self.suspect_nodes)
        steps = _fmt_steps(self.steps)
        layers = " ".join(f"{k}={v:.1f}" for k, v in sorted(
            self.layer_deficit.items(), key=lambda kv: -kv[1]))
        tag = "" if self.kind == "anomaly" else f" {self.kind}"
        return (f"[incident #{self.incident_id} {self.status}{tag}] "
                f"t={self.t_start:.2f}s..{self.t_end:.2f}s "
                f"suspect={self.suspect_layer.value} node(s)={nodes} "
                f"severity={self.severity:.1f} flags={self.n_flags} "
                f"steps={steps}\n    layer deficit: {layers}")


def _fmt_steps(steps: Sequence[int]) -> str:
    if not steps:
        return "-"
    s = sorted(steps)
    if len(s) > 8:
        return f"{s[0]}..{s[-1]} ({len(s)} steps)"
    return ",".join(str(x) for x in s)


class IncidentEngine:
    """Stateful flag clustering across detection ticks."""

    def __init__(self, gap_s: float = 1.0, close_after_s: float = 2.0,
                 min_flags: int = 8, deficit_cap: float = 1e3):
        self.gap_s = float(gap_s)
        self.close_after_s = float(close_after_s)
        self.min_flags = int(min_flags)
        # per-flag deficit cap: a near-constant feature (std floored at 1e-9
        # in the standardizer) can push a single flag's (delta - score) to
        # ~1e12, which would let one degenerate feature dominate cross-layer
        # attribution and severity ranking
        self.deficit_cap = float(deficit_cap)
        self.incidents: List[Incident] = []  # finalised, ranked on report
        self._next_id = 1
        # pending flag rows: (ts, layer_idx, node, step, deficit)
        self._pending: List[np.ndarray] = []
        self._layers = tuple(Layer)
        self._layer_idx = {l: i for i, l in enumerate(self._layers)}
        # sliding windows re-score the same event every tick; the watermark
        # admits each (layer, node) row into the incident stream exactly once
        self._watermark: Dict[tuple, float] = {}
        self._floor = -np.inf  # rows at or before this ts never enter
        self._layer_floor: Dict[int, float] = {}  # per-layer late-fit floors

    @property
    def n_pending_flags(self) -> int:
        """Flag rows admitted but not yet clustered into a finalised
        incident — the backlog an open incident is accumulating."""
        return int(sum(a.shape[0] for a in self._pending))

    # -- ingestion ------------------------------------------------------------
    def set_floor(self, ts: float) -> None:
        """Exclude everything at or before ``ts`` from incident formation —
        called after warmup so the reference window's own calibration false
        positives (the contamination quantile flags ~c% of it by
        construction) don't open a spurious incident."""
        self._floor = float(ts)

    def set_layer_floor(self, layer: Layer, ts: float) -> None:
        """Same exclusion, for one layer — used when a layer is fitted late
        (its training window would otherwise feed calibration flags straight
        into an incident)."""
        self._layer_floor[self._layer_idx[layer]] = float(ts)

    def set_node_floor(self, layer: Layer, node: int, ts: float) -> None:
        """Same exclusion, for one (layer, node) pair — used by the
        hierarchical plane when one GROUP warms a layer late: only that
        group's member nodes should have their calibration flags excluded,
        not the whole fleet's."""
        key = (self._layer_idx[layer], int(node))
        self._watermark[key] = max(
            self._watermark.get(key, -np.inf), float(ts))

    def update(self, detections: Dict[Layer, WindowDetection],
               now: Optional[float] = None) -> List[Incident]:
        """Feed one tick's detections; returns incidents finalised by this
        update (clusters whose last flag is > close_after_s old)."""
        return self._finalise(self.ingest(detections, now))

    def finalise(self, now: float) -> List[Incident]:
        """Close clusters whose last flag is > close_after_s before ``now``
        (public wrapper; pair with `ingest`)."""
        return self._finalise(float(now))

    def ingest(self, detections: Dict[Layer, WindowDetection],
               now: Optional[float] = None) -> float:
        """Admit one tick's detections into the pending flag stream WITHOUT
        finalising. The hierarchical plane admits every group's detections
        first and then calls `finalise` once, so a cross-group flag cluster
        can never be split by group feed order. Returns the newest timestamp
        observed (input ``now`` folded in)."""
        rows = []
        t_max = now if now is not None else 0.0
        for layer, det in detections.items():
            # batch DetectionResults are accepted alongside streaming
            # WindowDetections: ts may be absent (legacy feature paths) and
            # nodes default to a single-node fleet
            ts_col = getattr(det, "ts", None)
            if ts_col is None:
                continue
            nodes_col = getattr(det, "nodes", None)
            if nodes_col is None:
                nodes_col = np.zeros(len(ts_col), dtype=np.int32)
            if len(ts_col):
                t_max = max(t_max, float(ts_col.max()))
            fresh = np.zeros(len(ts_col), dtype=bool)
            li = self._layer_idx[layer]
            floor = max(self._floor, self._layer_floor.get(li, -np.inf))
            for node in np.unique(nodes_col):
                key = (li, int(node))
                on_node = nodes_col == node
                node_ts = ts_col[on_node]
                wm = self._watermark.get(key, floor)
                fresh[on_node] = node_ts > wm
                self._watermark[key] = max(wm, float(node_ts.max()))
            f = det.flags & fresh
            if not f.any():
                continue
            deficit = np.clip(det.log_delta - det.scores[f], 0.0,
                              self.deficit_cap)
            rows.append(np.stack([
                ts_col[f],
                np.full(f.sum(), self._layer_idx[layer], dtype=np.float64),
                nodes_col[f].astype(np.float64),
                det.steps[f].astype(np.float64),
                deficit,
            ], axis=1))
        if rows:
            self._pending.append(np.concatenate(rows, axis=0))
        return t_max

    def flush(self) -> List[Incident]:
        """Force-finalise everything pending (end of run)."""
        return self._finalise(float("inf"))

    # -- clustering -----------------------------------------------------------
    def _finalise(self, now: float) -> List[Incident]:
        if not self._pending:
            return []
        rows = np.concatenate(self._pending, axis=0)
        rows = rows[np.argsort(rows[:, 0], kind="stable")]
        ts = rows[:, 0]
        # split where the inter-flag gap exceeds gap_s
        cuts = np.flatnonzero(np.diff(ts) > self.gap_s) + 1
        groups = np.split(rows, cuts)
        closed: List[Incident] = []
        keep: List[np.ndarray] = []
        for g in groups:
            if now - g[-1, 0] <= self.close_after_s:
                keep.append(g)  # still hot: may extend next tick
                continue
            inc = self._attribute(g)
            if inc is not None:
                closed.append(inc)
        self._pending = keep
        self.incidents.extend(closed)
        return closed

    def _attribute(self, g: np.ndarray) -> Optional[Incident]:
        if g.shape[0] < self.min_flags:
            return None
        layer_ids = g[:, 1].astype(int)
        deficits = g[:, 4]
        layer_deficit: Dict[str, float] = {}
        layer_first_ts: Dict[str, float] = {}
        for li in np.unique(layer_ids):
            on = layer_ids == li
            layer_deficit[self._layers[li].value] = float(deficits[on].sum())
            layer_first_ts[self._layers[li].value] = float(g[on, 0].min())
        # suspect layer: largest deficit among cause layers; symptom layers
        # only when nothing specific flagged
        cause = {k: v for k, v in layer_deficit.items()
                 if Layer(k) not in SYMPTOM_LAYERS}
        pool = cause or layer_deficit
        suspect_layer = Layer(max(pool, key=pool.get))
        # suspect nodes: nodes carrying >= 50% of the top node's deficit on
        # the suspect layer
        on_layer = layer_ids == self._layer_idx[suspect_layer]
        node_def: Dict[int, float] = {}
        for node in np.unique(g[on_layer, 2].astype(int)):
            node_def[int(node)] = float(
                deficits[on_layer & (g[:, 2] == node)].sum())
        top = max(node_def.values())
        suspects = sorted(n for n, d in node_def.items() if d >= 0.5 * top)
        node_flags = {int(n): int((g[:, 2] == n).sum())
                      for n in np.unique(g[:, 2].astype(int))}
        steps = np.unique(g[:, 3].astype(int))
        inc = Incident(
            incident_id=self._next_id,
            t_start=float(g[0, 0]), t_end=float(g[-1, 0]),
            suspect_layer=suspect_layer, suspect_nodes=suspects,
            severity=float(deficits.sum()), n_flags=int(g.shape[0]),
            steps=[int(s) for s in steps if s >= 0],
            layer_deficit=layer_deficit, node_flags=node_flags,
            status="closed", layer_first_ts=layer_first_ts)
        self._next_id += 1
        return inc

    # -- reporting ------------------------------------------------------------
    def ranked(self) -> List[Incident]:
        return sorted(self.incidents, key=lambda i: -i.severity)

    def render_report(self) -> str:
        incs = self.ranked()
        if not incs:
            return "no incidents"
        lines = [f"{len(incs)} incident(s), ranked by severity:"]
        lines += [i.render() for i in incs]
        return "\n".join(lines)

    def json_report(self) -> str:
        return json.dumps([i.to_json() for i in self.ranked()], indent=1)


# ---------------------------------------------------------------------------
# incident <-> ground-truth matching (evaluation harness)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class IncidentMatch:
    """Incidents scored against labelled fault windows (chaos ground truth).

    ``window_hits[i]`` lists the incident ids overlapping fault window ``i``;
    an incident overlapping no window is spurious. Precision/recall are at
    the incident/window level — the step-level metrics live in
    the JAX package's `repro/eval/metrics.py`.
    """

    window_hits: List[List[int]]
    spurious: List[int]  # incident ids matching no fault window

    @property
    def windows_detected(self) -> int:
        return sum(1 for hits in self.window_hits if hits)

    @property
    def recall(self) -> float:
        return (self.windows_detected / len(self.window_hits)
                if self.window_hits else 1.0)

    @property
    def precision(self) -> float:
        n_inc = len(self.spurious) + len(
            {i for hits in self.window_hits for i in hits})
        return 1.0 - len(self.spurious) / n_inc if n_inc else 1.0

    def to_json(self) -> Dict[str, object]:
        return {"window_hits": self.window_hits, "spurious": self.spurious,
                "windows_detected": self.windows_detected,
                "recall": self.recall, "precision": self.precision}


def match_incidents(incidents: Sequence[Incident],
                    windows: Sequence[tuple],
                    grace_steps: int = 0) -> IncidentMatch:
    """Match incidents to ``[start, end)`` fault step windows by step overlap.

    ``windows`` is typically ``FaultInjector.windows()``. An incident counts
    toward window ``[lo, hi)`` when any of its anomalous steps lands in
    ``[lo, hi + grace_steps)`` — detection can lag the window by up to a
    flush interval, which is what the grace covers.
    """
    window_hits: List[List[int]] = [[] for _ in windows]
    spurious: List[int] = []
    for inc in incidents:
        steps = set(inc.steps)
        hit = False
        for w, (lo, hi) in enumerate(windows):
            if any(lo <= s < hi + grace_steps for s in steps):
                window_hits[w].append(inc.incident_id)
                hit = True
        if not hit:
            spurious.append(inc.incident_id)
    return IncidentMatch(window_hits=window_hits, spurious=spurious)
