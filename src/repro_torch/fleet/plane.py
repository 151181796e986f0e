"""The fleet plane: hierarchical drop-in for `StreamMonitor` (port of
`repro/fleet/plane.py`; the group detectors run on ``device``).

`HierarchicalMonitor` keeps the flat monitor's driver surface exactly —
``register_node / warmup / tick / finish / stats / incidents`` plus the
``aggregator`` evidence handle — but routes every node agent into its
`GroupAggregator` (per `TopologySpec`) and merges the groups' detections
into ONE fleet-level `IncidentEngine`:

* Each group detects on its own windows with its own model — detection cost
  and window memory scale per group, and in a real deployment each group
  runs on its own host (the per-group ingest/detect wall times surfaced in
  `stats()["tiers"]` are the honest critical path of that layout).
* Cross-group incident merge is free by construction: every group's flags
  feed the same engine, whose time-gap clustering coalesces flags from
  different groups over the same fault window into a single incident while
  keeping per-node attribution (node ids are fleet-global). Groups' flags
  are all admitted BEFORE finalisation each tick, so feed order can never
  split a cluster (`IncidentEngine.ingest` / `finalise`).
* A group that warms a layer late only floors its OWN member nodes
  (`set_node_floor`) — other groups' detections on that layer keep flowing.

`FleetView` adapts the group tier to the `FleetAggregator` read surface
(`windows`, `nodes_seen`, `node_last_ts`, counters) so sessions, sinks, the
status board, and the self-metrics registry work unchanged on top of either
monitor.

Every group's `OnlineGMMDetector` fits and scores on ``device`` (default
``cuda``). Under the session's async plane a sweep (`detect_snapshot`) runs
every group's detection in turn on the executor's CUDA stream, inside the
executor's detection zone, as the flat monitor's sweep does.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.collector import Collector
from repro_torch.core.events import LAYERS, Layer
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fleet.governor import BackpressureGovernor
from repro_torch.fleet.group import GroupAggregator
from repro_torch.fleet.topology import FleetTopology, TopologySpec
from repro_torch.stream import wire
from repro_torch.stream.agent import NodeAgent
from repro_torch.stream.incidents import Incident, IncidentEngine
from repro_torch.stream.monitor import export_windows_trace
from repro_torch.stream.online import WindowDetection
from repro_torch.stream.window import AggSnapshot, LayerWindow


@dataclasses.dataclass
class FleetSweepOutcome:
    """Off-thread result of one hierarchical detection sweep, pending
    admission on the step thread (the plane-level `SweepOutcome`)."""

    per_group: Dict[int, Dict[Layer, WindowDetection]]
    # late-warmup floors recorded against the SNAPSHOT's membership/clock:
    # (layer, node_id, floor_ts) triples, applied at admit
    floors: List[Tuple[Layer, int, float]]
    t_latest: float
    detect_s: float


class _MergedWindow:
    """Read-only union of one layer's windows across all groups."""

    def __init__(self, layer: Layer, parts: List[LayerWindow]):
        self.layer = layer
        self._parts = parts

    def __len__(self) -> int:
        return sum(len(p) for p in self._parts)

    @property
    def capacity(self) -> int:
        return sum(p.capacity for p in self._parts)

    @property
    def evicted(self) -> int:
        return sum(p.evicted for p in self._parts)

    @property
    def names_truncated(self) -> int:
        return sum(p.names_truncated for p in self._parts)

    @property
    def t_newest(self) -> float:
        return max((p.t_newest for p in self._parts if len(p)), default=0.0)

    def view(self) -> Dict[str, np.ndarray]:
        """Copying concat of the live rows (the flat window's `view` is
        zero-copy; a cross-group union cannot be)."""
        live = [p.view() for p in self._parts if len(p)]
        if not live:
            return self._parts[0].view()
        if len(live) == 1:
            return live[0]
        return {k: np.concatenate([v[k] for v in live]) for k in live[0]}


class FleetView:
    """`FleetAggregator`-shaped read facade over the group tier."""

    LAYERS = LAYERS

    def __init__(self, plane: "HierarchicalMonitor"):
        self._plane = plane

    @property
    def _groups(self) -> List[GroupAggregator]:
        return list(self._plane.groups.values())

    @property
    def horizon_s(self) -> float:
        return self._plane.horizon_s

    @property
    def nodes_seen(self) -> Dict[int, int]:
        out: Dict[int, int] = {}
        for g in self._groups:
            out.update(g.agg.nodes_seen)
        return out

    @property
    def node_last_ts(self) -> Dict[int, float]:
        out: Dict[int, float] = {}
        for g in self._groups:
            out.update(g.agg.node_last_ts)
        return out

    @property
    def t_latest(self) -> float:
        return max((g.agg.t_latest for g in self._groups), default=0.0)

    @property
    def events_ingested(self) -> int:
        return sum(g.agg.events_ingested for g in self._groups)

    @property
    def events_dropped_at_source(self) -> int:
        return sum(g.agg.events_dropped_at_source for g in self._groups)

    @property
    def events_shed_at_source(self) -> int:
        return sum(g.agg.events_shed_at_source for g in self._groups)

    @property
    def lost_batches(self) -> int:
        return sum(g.agg.lost_batches for g in self._groups)

    @property
    def windows(self) -> Dict[Layer, _MergedWindow]:
        groups = self._groups
        return {layer: _MergedWindow(layer,
                                     [g.agg.windows[layer] for g in groups])
                for layer in self.LAYERS} if groups else {}

    def window(self, layer: Layer) -> _MergedWindow:
        return self.windows[layer]

    def evict(self, now: Optional[float] = None) -> int:
        return sum(g.agg.evict(now) for g in self._groups)

    def stats(self) -> Dict[str, object]:
        windows = self.windows
        return {
            "nodes": len(self.nodes_seen),
            "groups": len(self._plane.groups),
            "events_ingested": self.events_ingested,
            "events_dropped_at_source": self.events_dropped_at_source,
            "events_shed_at_source": self.events_shed_at_source,
            "lost_batches": self.lost_batches,
            "names_truncated": sum(w.names_truncated
                                   for w in windows.values()),
            "window_sizes": {l.value: len(w) for l, w in windows.items()
                             if len(w)},
            "t_latest": self.t_latest,
        }


def merge_detections(per_group: Dict[int, Dict[Layer, WindowDetection]]
                     ) -> Dict[Layer, WindowDetection]:
    """Union the groups' per-layer detections for fleet-level reporting.

    Flags/scores/steps/nodes/ts concatenate (node ids are fleet-global);
    ``log_delta`` becomes the mean of the groups' thresholds — a reporting
    summary only, incident deficits are computed per group BEFORE merging."""
    by_layer: Dict[Layer, List[WindowDetection]] = {}
    for dets in per_group.values():
        for layer, det in dets.items():
            by_layer.setdefault(layer, []).append(det)
    out: Dict[Layer, WindowDetection] = {}
    for layer, parts in by_layer.items():
        if len(parts) == 1:
            out[layer] = parts[0]
            continue
        refits = {p.refit for p in parts}
        out[layer] = WindowDetection(
            layer=layer,
            flags=np.concatenate([p.flags for p in parts]),
            scores=np.concatenate([p.scores for p in parts]),
            log_delta=float(np.mean([p.log_delta for p in parts])),
            steps=np.concatenate([p.steps for p in parts]),
            nodes=np.concatenate([p.nodes for p in parts]),
            ts=np.concatenate([p.ts for p in parts]),
            refit=refits.pop() if len(refits) == 1 else "mixed")
    return out


class HierarchicalMonitor:
    """Tree-structured streaming fleet monitor (node -> group -> fleet).

    Same driver contract as `StreamMonitor`; construct with a
    `TopologySpec` (usually via ``MonitorSpec.topology``)."""

    def __init__(self, topology: TopologySpec, n_components: int = 3,
                 contamination: float = 0.02, horizon_s: float = 60.0,
                 capacity_per_layer: int = 65536, min_events: int = 64,
                 incident_gap_s: float = 1.0,
                 incident_close_after_s: float = 2.0, min_flags: int = 8,
                 seed: int = 0, drift_tol: float = 3.0, track: bool = True,
                 wire_version: Optional[int] = None,
                 incremental: bool = True, device: DeviceLike = None):
        self.topology = FleetTopology(topology)
        self.horizon_s = float(horizon_s)
        self.wire_version = (wire.VERSION if wire_version is None
                             else int(wire_version))
        self._group_kw = dict(
            capacity_per_layer=capacity_per_layer, horizon_s=horizon_s,
            n_components=n_components, contamination=contamination,
            min_events=min_events, seed=seed, drift_tol=drift_tol,
            track=track, incremental=incremental,
            device=resolve_device(device))
        self.engine = IncidentEngine(gap_s=incident_gap_s,
                                     close_after_s=incident_close_after_s,
                                     min_flags=min_flags)
        self.groups: Dict[int, GroupAggregator] = {}
        self.agents: Dict[int, NodeAgent] = {}
        self._agent_group: Dict[int, int] = {}
        self.aggregator = FleetView(self)
        self.ticks = 0
        self.detect_seconds = 0.0
        self.merge_seconds = 0.0  # fleet-tier incident merge wall time
        self.last_detect_ms = 0.0
        self.last_detections: Dict[Layer, WindowDetection] = {}
        self.wire_tap: Optional[Callable[[bytes], None]] = None

    # -- fleet membership -----------------------------------------------------
    def register_node(self, node_id: int, collector: Collector,
                      ts_offset: float = 0.0) -> NodeAgent:
        gid = self.topology.group_of(node_id)
        if gid not in self.groups:
            self.topology.check_group_count(len(self.groups) + 1)
            self.groups[gid] = GroupAggregator(gid, **self._group_kw)
        spec = self.topology.spec
        governor = None
        if spec.max_events_per_flush:
            governor = BackpressureGovernor(
                spec.max_events_per_flush,
                min_per_layer=spec.min_per_layer,
                high_water=spec.high_water, decrease=spec.decrease,
                recover_fraction=spec.recover_fraction)
        agent = NodeAgent(node_id, collector, ts_offset=ts_offset,
                          governor=governor, wire_version=self.wire_version)
        self.agents[node_id] = agent
        self._agent_group[node_id] = gid
        return agent

    # -- pipeline stages ------------------------------------------------------
    def poll(self) -> int:
        """Flush every agent through the wire into its group's windows."""
        added = 0
        for nid, agent in self.agents.items():
            buf = agent.flush()
            if self.wire_tap is not None:
                self.wire_tap(buf)
            added += self.groups[self._agent_group[nid]].ingest(buf)
        for g in self.groups.values():
            g.evict()
        # close the control loop: each agent's governor tracks its group's
        # post-eviction occupancy
        for nid, agent in self.agents.items():
            if agent.governor is not None:
                agent.governor.feedback(
                    self.groups[self._agent_group[nid]].pressure())
        return added

    @property
    def warmed(self) -> bool:
        return any(g.warmed for g in self.groups.values())

    def warmup(self) -> List[Layer]:
        """Drain the clean prefix and fit every group's baselines on it."""
        self.poll()
        fitted = set()
        for g in self.groups.values():
            fitted.update(g.warmup())
        self.engine.set_floor(self.aggregator.t_latest)
        return sorted(fitted, key=LAYERS.index)

    def tick(self) -> List[Incident]:
        """One monitor cycle: poll, per-group detect, fleet merge."""
        self.poll()
        if not self.warmed:
            return []
        t0 = time.perf_counter()
        per_group: Dict[int, Dict[Layer, WindowDetection]] = {}
        for gid, g in self.groups.items():
            # late warmup floors only THIS group's member nodes
            for layer in g.warmup():
                for nid in g.agg.nodes_seen:
                    self.engine.set_node_floor(layer, nid, g.agg.t_latest)
            if g.warmed:
                per_group[gid] = g.detect()
        # fleet merge: admit every group's flags, THEN finalise once
        t1 = time.perf_counter()
        t_max = self.aggregator.t_latest
        for dets in per_group.values():
            t_max = max(t_max, self.engine.ingest(dets))
        closed = self.engine.finalise(t_max)
        self.merge_seconds += time.perf_counter() - t1
        self.last_detections = merge_detections(per_group)
        dt = time.perf_counter() - t0
        self.detect_seconds += dt
        self.last_detect_ms = 1e3 * dt
        self.ticks += 1
        return closed

    # -- async trio (poll/freeze -> detect off-thread -> admit) ---------------
    # tick() == admit(detect_snapshot(snapshot())) when nothing ingests in
    # between; the async plane runs the middle call on the executor worker.

    def snapshot(self) -> Optional[Dict[int, AggSnapshot]]:
        """Step-thread half: poll agents, freeze every group's windows.
        Returns None before any group has warmed."""
        self.poll()
        if not self.warmed:
            return None
        return {gid: g.agg.freeze() for gid, g in self.groups.items()}

    def detect_snapshot(self, snaps: Dict[int, AggSnapshot]
                        ) -> FleetSweepOutcome:
        """Worker half: per-group late-warmup + detect against frozen
        snapshots. Mutates only the group detectors (serialised by the
        executor); the shared incident engine is untouched until admit."""
        t0 = time.perf_counter()
        per_group: Dict[int, Dict[Layer, WindowDetection]] = {}
        floors: List[Tuple[Layer, int, float]] = []
        t_latest = 0.0
        for gid, snap in snaps.items():
            g = self.groups[gid]
            for layer in g.detector.warmup(snap):
                floors.extend((layer, nid, snap.t_latest)
                              for nid in snap.nodes_seen)
            if g.warmed:
                t1 = time.perf_counter()
                per_group[gid] = g.detector.detect(snap)
                g.detect_seconds += time.perf_counter() - t1
            t_latest = max(t_latest, snap.t_latest)
        return FleetSweepOutcome(per_group=per_group, floors=floors,
                                 t_latest=t_latest,
                                 detect_s=time.perf_counter() - t0)

    def admit(self, outcome: FleetSweepOutcome) -> List[Incident]:
        """Step-thread half two: publish a sweep — floors, fleet-tier
        incident merge, tick accounting."""
        for layer, nid, ts in outcome.floors:
            self.engine.set_node_floor(layer, nid, ts)
        t1 = time.perf_counter()
        t_max = outcome.t_latest
        for dets in outcome.per_group.values():
            t_max = max(t_max, self.engine.ingest(dets))
        closed = self.engine.finalise(t_max)
        merge_dt = time.perf_counter() - t1
        self.merge_seconds += merge_dt
        self.last_detections = merge_detections(outcome.per_group)
        self.detect_seconds += outcome.detect_s + merge_dt
        self.last_detect_ms = 1e3 * (outcome.detect_s + merge_dt)
        self.ticks += 1
        return closed

    def finish(self) -> List[Incident]:
        """Final poll + force-close any open incident (end of run)."""
        incidents = self.tick()
        incidents += self.engine.flush()
        return incidents

    def export_trace(self, path: str) -> str:
        """Perfetto export of the union of all groups' sliding windows."""
        return export_windows_trace(self.aggregator.windows, path)

    # -- reporting ------------------------------------------------------------
    @property
    def incidents(self) -> List[Incident]:
        return self.engine.ranked()

    @property
    def group_detectors(self) -> Dict[int, object]:
        return {gid: g.detector for gid, g in self.groups.items()}

    def detector_stats(self) -> Dict[str, object]:
        """Per-layer detector summary aggregated across groups: refit counts
        sum, thresholds/likelihoods average, ``groups`` counts fitted
        groups."""
        out: Dict[str, dict] = {}
        for g in self.groups.values():
            for layer_name, s in g.detector.stats().items():
                agg = out.setdefault(layer_name, {
                    "k": 0, "log_delta": [], "ll_fit": [],
                    "warm_refits": 0, "cold_refits": 0, "groups": 0})
                agg["k"] = max(agg["k"], s["k"])
                agg["log_delta"].append(s["log_delta"])
                agg["ll_fit"].append(s["ll_fit"])
                agg["warm_refits"] += s["warm_refits"]
                agg["cold_refits"] += s["cold_refits"]
                agg["groups"] += 1
        return {name: {"k": a["k"],
                       "log_delta": float(np.mean(a["log_delta"])),
                       "ll_fit": float(np.mean(a["ll_fit"])),
                       "warm_refits": a["warm_refits"],
                       "cold_refits": a["cold_refits"],
                       "groups": a["groups"]}
                for name, a in out.items()}

    def render_report(self) -> str:
        agg = self.aggregator.stats()
        head = (f"fleet: {agg['nodes']} node(s) in {agg['groups']} "
                f"group(s), {agg['events_ingested']} events ingested, "
                f"{agg['events_shed_at_source']} shed, "
                f"{agg['lost_batches']} lost batch(es), "
                f"{self.ticks} detection tick(s), "
                f"{1e3 * self.detect_seconds / max(self.ticks, 1):.1f} "
                f"ms/tick")
        return head + "\n" + self.engine.render_report()

    def stats(self) -> Dict[str, object]:
        agents = {nid: a.stats() for nid, a in self.agents.items()}
        agg_stats = self.aggregator.stats()
        return {
            "topology": self.topology.shape(len(self.agents)),
            "aggregator": agg_stats,
            "detector": self.detector_stats(),
            "groups": {gid: g.stats()
                       for gid, g in sorted(self.groups.items())},
            "agents": agents,
            "ticks": self.ticks,
            "detect_ms_per_tick":
                1e3 * self.detect_seconds / max(self.ticks, 1),
            "last_detect_ms": self.last_detect_ms,
            "incidents": len(self.engine.incidents),
            # tier wall-times: the honest critical path of a deployment
            # where each group aggregates on its own host
            "tiers": {
                "group_ingest_seconds_max": max(
                    (g.ingest_seconds for g in self.groups.values()),
                    default=0.0),
                "group_detect_seconds_max": max(
                    (g.detect_seconds for g in self.groups.values()),
                    default=0.0),
                "merge_seconds": self.merge_seconds,
            },
            "events_dropped": sum(a["ring_dropped"]
                                  for a in agents.values()),
            "events_shed": sum(a["events_shed"] for a in agents.values()),
            "names_truncated": sum(a["names_truncated"]
                                   for a in agents.values())
            + agg_stats["names_truncated"],
        }
