"""StreamMonitor: the top-level streaming fleet monitor (port of
`repro/stream/monitor.py`; only the imports differ).

Composes the subsystem end to end:

    node Collector --NodeAgent.flush()--> wire bytes
        --FleetAggregator.ingest()--> per-layer sliding windows
        --OnlineGMMDetector.detect()--> per-window flags
        --IncidentEngine.update()--> ranked cross-node incidents

Batches always travel through the wire encoding, even in-process — the
simulated fleet exercises exactly the bytes a real multi-host deployment
would ship.

Driver contract (see `repro_torch.quickstart.run_stream`):

    mon = StreamMonitor()
    mon.register_node(0, collector)
    ... run warmup steps ...
    mon.warmup()                  # fit baselines on the clean prefix
    ... each flush interval ...
    incidents = mon.tick()        # poll agents, detect, group incidents
    ... at shutdown ...
    incidents += mon.finish()
    print(mon.render_report())

Prefer `repro_torch.session.Session` with a ``MonitorSpec(mode="stream")``
as the driver entry point: the session drives this class (or, with a
``topology``, the hierarchical `repro_torch.fleet.HierarchicalMonitor`) and
folds its output into the unified `MonitorReport`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.collector import Collector
from repro_torch.core.events import Event, Layer, export_perfetto
from repro_torch.stream import wire
from repro_torch.stream.agent import NodeAgent
from repro_torch.stream.incidents import Incident, IncidentEngine
from repro_torch.stream.online import OnlineGMMDetector, WindowDetection
from repro_torch.stream.window import AggSnapshot, FleetAggregator


@dataclasses.dataclass
class SweepOutcome:
    """What a detection sweep computed off-thread, pending admission.

    Produced by ``detect_snapshot`` (any thread), consumed by ``admit``
    (step thread) — the hand-off boundary of the async detection plane.
    Everything incident-engine-facing stays out of the sweep: the engine is
    read by reporting on the step thread and is not thread-safe."""

    detections: Dict[Layer, WindowDetection]
    fitted: List[Layer]  # layers late-warmup fitted during this sweep
    t_latest: float  # snapshot fleet clock (floors + incident `now`)
    detect_s: float  # sweep wall time (compute only, excludes queueing)


def export_windows_trace(windows, path: str) -> str:
    """Perfetto export of the events currently held in per-layer sliding
    windows (flat monitor or merged fleet view — anything with `view()`).

    Bounded by the window horizon — a streaming monitor does not keep the
    whole run. Node ids are exported as pids so per-node tracks separate in
    the viewer."""
    events: List[Event] = []
    for layer, w in windows.items():
        v = w.view()
        for i in range(len(w)):
            meta = None
            if layer == Layer.DEVICE and not np.isnan(v["util"][i]):
                meta = {k: float(v[k][i]) for k in wire.TELEMETRY_KEYS}
            events.append(Event(
                layer=layer, name=str(v["name"][i]), ts=float(v["ts"][i]),
                dur=float(v["dur"][i]), size=float(v["size"][i]),
                step=int(v["step"][i]), pid=int(v["node"][i]), meta=meta))
    events.sort(key=lambda e: e.ts)
    return export_perfetto(events, path)


class StreamMonitor:
    def __init__(self, n_components: int = 3, contamination: float = 0.02,
                 horizon_s: float = 60.0, capacity_per_layer: int = 65536,
                 min_events: int = 64, incident_gap_s: float = 1.0,
                 incident_close_after_s: float = 2.0, min_flags: int = 8,
                 seed: int = 0, detector=None):
        self.aggregator = FleetAggregator(capacity_per_layer=capacity_per_layer,
                                          horizon_s=horizon_s)
        # any per-window detector with the OnlineGMMDetector surface
        # (warmup/warmed/detect/stats) slots in — see
        # repro_torch.stream.backends for the pluggable model families;
        # None = the GMM default
        self.detector = (detector if detector is not None
                         else OnlineGMMDetector(n_components=n_components,
                                                contamination=contamination,
                                                min_events=min_events,
                                                seed=seed))
        self.engine = IncidentEngine(gap_s=incident_gap_s,
                                     close_after_s=incident_close_after_s,
                                     min_flags=min_flags)
        self.agents: Dict[int, NodeAgent] = {}
        self.ticks = 0
        self.detect_seconds = 0.0  # cumulative detection wall time
        self.last_detect_ms = 0.0  # wall time of the most recent tick
        self.last_detections: Dict[Layer, WindowDetection] = {}
        # optional observer of every wire batch as it leaves an agent — the
        # session sink pipeline tees the transport through this
        self.wire_tap: Optional[Callable[[bytes], None]] = None

    # -- fleet membership -----------------------------------------------------
    def register_node(self, node_id: int, collector: Collector,
                      ts_offset: float = 0.0) -> NodeAgent:
        agent = NodeAgent(node_id, collector, ts_offset=ts_offset)
        self.agents[node_id] = agent
        return agent

    # -- pipeline stages ------------------------------------------------------
    def poll(self) -> int:
        """Flush every node agent through the wire into the aggregator."""
        added = 0
        for agent in self.agents.values():
            buf = agent.flush()
            if self.wire_tap is not None:
                self.wire_tap(buf)
            added += self.aggregator.ingest(buf)
        self.aggregator.evict()
        return added

    def warmup(self) -> List[Layer]:
        """Drain whatever the nodes have produced so far (assumed clean) and
        fit the per-layer models on it."""
        self.poll()
        fitted = self.detector.warmup(self.aggregator)
        self.engine.set_floor(self.aggregator.t_latest)
        return fitted

    def tick(self) -> List[Incident]:
        """One monitor cycle: poll, detect, group. Returns incidents closed
        by this cycle (the open one keeps accumulating)."""
        self.poll()
        if not self.detector.warmed:
            return []
        # late warmup: fit layers that lacked min_events at initial warmup
        # (e.g. slow device telemetry); their training window is excluded
        # from incident formation just like the initial one
        for layer in self.detector.warmup(self.aggregator):
            self.engine.set_layer_floor(layer, self.aggregator.t_latest)
        t0 = time.perf_counter()
        self.last_detections = self.detector.detect(self.aggregator)
        closed = self.engine.update(self.last_detections,
                                    now=self.aggregator.t_latest)
        dt = time.perf_counter() - t0
        self.detect_seconds += dt
        self.last_detect_ms = 1e3 * dt
        self.ticks += 1
        return closed

    # -- async trio (poll/freeze -> detect off-thread -> admit) ---------------
    # tick() == admit(detect_snapshot(snapshot())) when nothing ingests in
    # between; the async plane runs the middle call on the executor worker.

    def snapshot(self) -> Optional[AggSnapshot]:
        """Step-thread half of an async tick: poll agents, freeze the
        aggregator. Returns None before warmup (nothing to sweep)."""
        self.poll()
        if not self.detector.warmed:
            return None
        return self.aggregator.freeze()

    def detect_snapshot(self, snap: AggSnapshot) -> SweepOutcome:
        """Worker half: late-warmup + detect against a frozen snapshot.
        Touches only detector state — safe off-thread because the executor
        serialises sweeps per key."""
        t0 = time.perf_counter()
        fitted = self.detector.warmup(snap)
        detections = self.detector.detect(snap)
        return SweepOutcome(detections=detections, fitted=fitted,
                            t_latest=snap.t_latest,
                            detect_s=time.perf_counter() - t0)

    def admit(self, outcome: SweepOutcome) -> List[Incident]:
        """Step-thread half two: publish a sweep's results — late-warmup
        floors, incident engine update, tick accounting."""
        for layer in outcome.fitted:
            self.engine.set_layer_floor(layer, outcome.t_latest)
        self.last_detections = outcome.detections
        closed = self.engine.update(outcome.detections, now=outcome.t_latest)
        self.detect_seconds += outcome.detect_s
        self.last_detect_ms = 1e3 * outcome.detect_s
        self.ticks += 1
        return closed

    def finish(self) -> List[Incident]:
        """Final poll + force-close any open incident (end of run)."""
        incidents = self.tick()
        incidents += self.engine.flush()
        return incidents

    def export_trace(self, path: str) -> str:
        """Perfetto export of the events currently in the sliding windows.

        The agents drain the collectors' ring buffers, so the collector-side
        `export_trace` would be empty under streaming; this reconstructs the
        trace from the aggregated columns instead."""
        return export_windows_trace(self.aggregator.windows, path)

    # -- reporting ------------------------------------------------------------
    @property
    def incidents(self) -> List[Incident]:
        return self.engine.ranked()

    def render_report(self) -> str:
        agg = self.aggregator.stats()
        head = (f"fleet: {agg['nodes']} node(s), "
                f"{agg['events_ingested']} events ingested, "
                f"{agg['lost_batches']} lost batch(es), "
                f"{self.ticks} detection tick(s), "
                f"{1e3 * self.detect_seconds / max(self.ticks, 1):.1f} ms/tick")
        return head + "\n" + self.engine.render_report()

    def stats(self) -> Dict[str, object]:
        agents = {nid: a.stats() for nid, a in self.agents.items()}
        return {
            "aggregator": self.aggregator.stats(),
            "detector": self.detector.stats(),
            "agents": agents,
            "ticks": self.ticks,
            "detect_ms_per_tick":
                1e3 * self.detect_seconds / max(self.ticks, 1),
            "last_detect_ms": self.last_detect_ms,
            "incidents": len(self.engine.incidents),
            # monitor-side collection loss, aggregated across the fleet:
            # ring overwrites at the source + names clipped at the ring or
            # the aggregation windows (per-node detail stays under
            # "agents"; window-level detail under "aggregator")
            "events_dropped": sum(a["ring_dropped"]
                                  for a in agents.values()),
            "events_shed": sum(a["events_shed"] for a in agents.values()),
            "names_truncated": sum(a["names_truncated"]
                                   for a in agents.values())
            + self.aggregator.stats()["names_truncated"],
        }
