"""Detector protocol + adapters over the existing GMM detectors (port of
`repro/session/detectors.py:1-257`).

A session detector backend exposes one lifecycle regardless of mode:

    fit(...)    -> fit/refit baselines on (assumed clean) reference data
    update(...) -> score the latest data; returns per-layer detections
    flags()     -> the most recent per-layer detections

`BatchGMMBackend` adapts `core.detector.FullStackMonitor` (offline refit on a
clean prefix), `OnlineGMMBackend` adapts the streaming pipeline
(`StreamMonitor`: agents -> windows -> warm-started EM -> incidents). Both
are registered under the "gmm" detector name, resolved per mode by the
session registry, so a spec can swap detector families without the drivers
knowing.

Both take the ``device`` their GMMs fit and score on (default ``cuda``: the
four GMM kernels). The reference's other families ("isoforest", "mad",
"spectral", `repro/session/detectors.py:260-375`) come with the port of
`repro/detect/families.py`, and its hierarchical topology with the fleet
slice; both raise here until then. Both backends keep the reference's async
snapshot/detect_snapshot/admit trio.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Protocol, runtime_checkable

from repro_torch.core.collector import Collector
from repro_torch.core.detector import DetectionResult, FullStackMonitor
from repro_torch.core.events import Layer
from repro_torch.core.features import EventsOrColumns
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.session.registry import register_detector
from repro_torch.session.spec import DetectorSpec
from repro_torch.stream.incidents import Incident
from repro_torch.stream.monitor import StreamMonitor
from repro_torch.stream.online import OnlineGMMDetector, WindowDetection

BATCH_CONTAMINATION = 1 / 6  # paper Table-I threshold policy
STREAM_CONTAMINATION = 0.02  # per-window rate of the fleet monitor


@runtime_checkable
class Detector(Protocol):
    """Common detector lifecycle (duck-typed; see module docstring)."""

    def fit(self, data) -> List[Layer]: ...

    def update(self, data) -> Dict[Layer, object]: ...

    def flags(self) -> Dict[Layer, object]: ...


@register_detector("gmm", mode="batch")
class BatchGMMBackend:
    """`FullStackMonitor` behind the Detector protocol.

    ``fit`` takes the clean reference data — a ColumnView (native) or a
    legacy `Event` list — and may be called again on a later, longer prefix:
    each call is a full refit, matching the periodic sweep the batch driver
    always ran. ``update`` scores columns/events with the current models.
    """

    def __init__(self, spec: Optional[DetectorSpec] = None,
                 device: DeviceLike = None):
        self.spec = spec or DetectorSpec()
        self.device = resolve_device(device)
        self._monitor: Optional[FullStackMonitor] = None
        self._last: Dict[Layer, DetectionResult] = {}

    @property
    def fitted(self) -> bool:
        return self._monitor is not None and bool(self._monitor.detectors)

    def fit(self, data: EventsOrColumns) -> List[Layer]:
        contamination = (BATCH_CONTAMINATION
                         if self.spec.contamination is None
                         else self.spec.contamination)
        self._monitor = FullStackMonitor(
            n_components=self.spec.n_components,
            contamination=contamination,
            min_events=self.spec.min_events, device=self.device).fit(data)
        return list(self._monitor.detectors)

    def update(self, data: EventsOrColumns) -> Dict[Layer, DetectionResult]:
        if not self.fitted:
            return {}
        self._last = self._monitor.detect(data)
        return self._last

    def flags(self) -> Dict[Layer, DetectionResult]:
        return self._last


@register_detector("gmm", mode="stream")
class OnlineGMMBackend:
    """The streaming pipeline behind the Detector protocol.

    Owns a `StreamMonitor`; node collectors register via ``register_node``.
    ``fit`` performs (idempotent) warmup on whatever the nodes have produced,
    ``update`` runs one poll/detect/incident tick. Incidents closed so far
    accumulate on ``.incidents``.
    """

    def __init__(self, spec: Optional[DetectorSpec] = None,
                 device: DeviceLike = None):
        self.spec = spec or DetectorSpec()
        self.device = resolve_device(device)
        contamination = (STREAM_CONTAMINATION
                         if self.spec.contamination is None
                         else self.spec.contamination)
        self.monitor = StreamMonitor(
            n_components=self.spec.n_components,
            contamination=contamination,
            horizon_s=self.spec.horizon_s,
            capacity_per_layer=self.spec.capacity_per_layer,
            min_events=self.spec.min_events,
            incident_gap_s=self.spec.incident_gap_s,
            incident_close_after_s=self.spec.incident_close_after_s,
            min_flags=self.spec.min_flags,
            seed=self.spec.seed,
            detector=self._window_detector(contamination))
        self.monitor.detector.drift_tol = self.spec.drift_tol
        self.monitor.detector.track = self.spec.warm_start
        self.monitor.detector.incremental = self.spec.incremental
        self.closed: List[Incident] = []
        # async plane state (attach_executor): staleness of the most
        # recently admitted sweep + admission counters
        self._executor = None
        self.lag_steps = 0
        self.lag_seconds = 0.0
        self.sweeps_admitted = 0

    def _window_detector(self, contamination: float):
        """The per-window detector: an `OnlineGMMDetector` on the backend's
        device. Family backends override this in the reference — everything
        else (async trio, incident engine, wire pipeline) is inherited."""
        return OnlineGMMDetector(n_components=self.spec.n_components,
                                 contamination=contamination,
                                 min_events=self.spec.min_events,
                                 seed=self.spec.seed, device=self.device)

    def configure_topology(self, topology) -> None:
        """The reference swaps the flat `StreamMonitor` for a hierarchical
        monitor here; that comes with the fleet slice of the port."""
        if topology is None:
            return
        raise NotImplementedError(
            "spec.topology is not ported yet: the hierarchical monitor "
            "comes with the fleet/ slice of the port (repro/fleet/plane.py, "
            "group.py, governor.py)")

    @property
    def fitted(self) -> bool:
        return self.monitor.detector.warmed

    @property
    def aggregator(self):
        """The fleet's per-layer sliding windows (`FleetAggregator`)."""
        return self.monitor.aggregator

    @property
    def window_detector(self):
        """The raw per-window detector (`OnlineGMMDetector`)."""
        return self.monitor.detector

    def register_node(self, node_id: int, collector: Collector,
                      ts_offset: float = 0.0) -> None:
        self.monitor.register_node(node_id, collector, ts_offset=ts_offset)

    def fit(self, data=None) -> List[Layer]:
        return self.monitor.warmup()

    def update(self, data=None) -> Dict[Layer, WindowDetection]:
        self.closed.extend(self.monitor.tick())
        return self.monitor.last_detections

    # -- async plane ----------------------------------------------------------
    def attach_executor(self, executor) -> None:
        """Opt into the async detection plane: ``update_async`` freezes a
        snapshot on the calling (step) thread, hands the sweep to this
        executor, and admits whatever sweeps have completed."""
        self._executor = executor

    def update_async(self, step: int = 0) -> Dict[Layer, WindowDetection]:
        """One async tick. With a thread executor the detections returned
        are the most recently ADMITTED sweep's — typically the previous
        cadence point's snapshot (staleness in ``lag_steps``/
        ``lag_seconds``). With an inline executor this is byte-identical to
        ``update()``."""
        snap = self.monitor.snapshot()
        if snap is None:
            return self.monitor.last_detections
        self._executor.submit(
            "stream", lambda: self.monitor.detect_snapshot(snap), step=step)
        self._admit_completed(step)
        return self.monitor.last_detections

    def _admit_completed(self, step: int) -> None:
        for r in self._executor.drain():
            if r.key != "stream":
                continue
            if r.error is not None:
                raise r.error
            self.closed.extend(self.monitor.admit(r.value))
            self.lag_steps = step - r.step
            self.lag_seconds = r.lag_s
            self.sweeps_admitted += 1

    def finish(self, step: int = 0) -> List[Incident]:
        n_closed = len(self.closed)
        if self._executor is not None:
            # quiesce the plane: every submitted sweep lands before the
            # final synchronous tick, so nothing is lost at shutdown
            self._executor.flush()
            self._admit_completed(step)
        closed = self.monitor.finish()
        self.closed.extend(closed)
        return self.closed[n_closed:]

    def flags(self) -> Dict[Layer, WindowDetection]:
        return self.monitor.last_detections

    @property
    def incidents(self) -> List[Incident]:
        return self.monitor.incidents
