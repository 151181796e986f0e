"""Group tier: one group's aggregation + online detection (port of
`repro/fleet/group.py`; the detector runs on ``device``).

A `GroupAggregator` is the middle hop of the node -> group -> fleet tree: it
owns a `FleetAggregator` (per-layer sliding windows) fed only by its member
nodes, and a per-group `OnlineGMMDetector` fitted on those windows. In a real
deployment each group is its own process on a rack-local host; in simulation
the objects are in-process but the data path is identical — member batches
arrive as wire bytes and detection state never leaves the group. Its window
occupancy doubles as the backpressure signal the member agents' governors
subscribe to.

The group's `OnlineGMMDetector` fits and scores on ``device`` (default
``cuda``): every group launches the four GMM kernels on its own windows, one
group after another each tick.
"""
from __future__ import annotations

import time
from typing import Dict, List

from repro_torch.core.events import Layer
from repro_torch.device import DeviceLike
from repro_torch.stream.online import OnlineGMMDetector, WindowDetection
from repro_torch.stream.window import FleetAggregator


class GroupAggregator:
    """Aggregation + detection for one group of nodes."""

    def __init__(self, group_id: int, capacity_per_layer: int = 65536,
                 horizon_s: float = 60.0, n_components: int = 3,
                 contamination: float = 0.02, min_events: int = 64,
                 seed: int = 0, drift_tol: float = 3.0, track: bool = True,
                 incremental: bool = True, device: DeviceLike = None):
        self.group_id = int(group_id)
        self.agg = FleetAggregator(capacity_per_layer=capacity_per_layer,
                                   horizon_s=horizon_s)
        # per-group seed offset: groups bootstrap-fit independently
        self.detector = OnlineGMMDetector(
            n_components=n_components, contamination=contamination,
            min_events=min_events, seed=seed + self.group_id,
            drift_tol=drift_tol, incremental=incremental, device=device)
        self.detector.track = track
        self.ingest_seconds = 0.0  # group-tier critical-path accounting
        self.detect_seconds = 0.0

    # -- data path ------------------------------------------------------------
    def ingest(self, buf) -> int:
        t0 = time.perf_counter()
        added = self.agg.ingest(buf)
        self.ingest_seconds += time.perf_counter() - t0
        return added

    def evict(self) -> int:
        return self.agg.evict()

    def pressure(self) -> float:
        """Backpressure signal for member governors: worst window occupancy
        in [0, 1]."""
        return max((len(w) / w.capacity
                    for w in self.agg.windows.values()), default=0.0)

    # -- detection ------------------------------------------------------------
    @property
    def warmed(self) -> bool:
        return bool(self.detector.states)

    def warmup(self) -> List[Layer]:
        return self.detector.warmup(self.agg)

    def detect(self) -> Dict[Layer, WindowDetection]:
        t0 = time.perf_counter()
        out = self.detector.detect(self.agg)
        self.detect_seconds += time.perf_counter() - t0
        return out

    # -- reporting ------------------------------------------------------------
    def nodes(self) -> List[int]:
        return sorted(self.agg.nodes_seen)

    def stats(self) -> Dict[str, object]:
        return {"group_id": self.group_id,
                "nodes": len(self.agg.nodes_seen),
                "pressure": self.pressure(),
                "ingest_seconds": self.ingest_seconds,
                "detect_seconds": self.detect_seconds,
                "aggregator": self.agg.stats(),
                "detector": self.detector.stats()}
