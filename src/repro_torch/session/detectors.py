"""Detector protocol + adapters over the existing GMM detectors (port of
`repro/session/detectors.py`).

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
four GMM kernels); under a hierarchical topology (``spec.topology``) the
stream backend builds a `HierarchicalMonitor` whose group detectors run on
that device too.

Beside the GMM, the bake-off families register under "isoforest"
(extended isolation ensemble with warm-started tree reuse), "mad" (robust
per-feature quantile/MAD floor), and "spectral" (PCA/spectral residual
with incremental subspace updates) — `BatchModelBackend` /
`OnlineModelBackend` specialised per family. They are NumPy on the host, as
in the reference, and accept ``device`` only for a uniform constructor. All
share one score convention (higher = more normal;
`repro_torch.detect.families`), so every backend is interchangeable behind
the protocol and the async snapshot/detect_snapshot/admit trio.
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
        device. Family backends (`OnlineModelBackend`) override this —
        everything else (async trio, incident engine, wire pipeline) is
        inherited."""
        return OnlineGMMDetector(n_components=self.spec.n_components,
                                 contamination=contamination,
                                 min_events=self.spec.min_events,
                                 seed=self.spec.seed, device=self.device)

    def configure_topology(self, topology) -> None:
        """Swap the flat `StreamMonitor` for a `HierarchicalMonitor` built
        from a `TopologySpec` (the spec's ``topology`` section), its group
        detectors on the backend's device. Must run before any node
        registers — the window/detector state is rebuilt."""
        if topology is None:
            return
        if self.monitor.agents:
            raise RuntimeError("configure_topology must run before nodes "
                               "register")
        from repro_torch.fleet import HierarchicalMonitor
        contamination = (STREAM_CONTAMINATION
                         if self.spec.contamination is None
                         else self.spec.contamination)
        self.monitor = HierarchicalMonitor(
            topology,
            n_components=self.spec.n_components,
            contamination=contamination,
            horizon_s=self.spec.horizon_s,
            capacity_per_layer=self.spec.capacity_per_layer,
            min_events=self.spec.min_events,
            incident_gap_s=self.spec.incident_gap_s,
            incident_close_after_s=self.spec.incident_close_after_s,
            min_flags=self.spec.min_flags,
            seed=self.spec.seed,
            drift_tol=self.spec.drift_tol,
            track=self.spec.warm_start,
            incremental=self.spec.incremental,
            device=self.device)

    @property
    def hierarchical(self) -> bool:
        return hasattr(self.monitor, "groups")

    @property
    def fitted(self) -> bool:
        return (self.monitor.warmed if self.hierarchical
                else self.monitor.detector.warmed)

    @property
    def aggregator(self):
        """The fleet's per-layer sliding windows (`FleetAggregator`, or the
        `FleetView` facade under a hierarchical topology)."""
        return self.monitor.aggregator

    @property
    def window_detector(self):
        """The raw per-window detector (OnlineGMMDetector); under a
        hierarchical topology there is one per group — see
        ``monitor.group_detectors``."""
        if self.hierarchical:
            raise AttributeError(
                "hierarchical monitor has per-group detectors; use "
                "monitor.group_detectors")
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


# -- pluggable model families (the detector bake-off) -------------------------
# Each family registers a batch and a stream backend behind the same names
# the GMM uses, so a spec swaps families with one string
# (``DetectorSpec(backend="mad")``). Scores follow the shared convention
# (higher = more normal; see repro_torch.detect.families), so thresholding,
# incident formation, and metrics need zero per-family code.

class BatchModelBackend:
    """`repro_torch.detect.families.ModelStackMonitor` behind the Detector
    protocol — the batch lifecycle of `BatchGMMBackend` for any score-model
    family (full refit per ``fit`` call on the clean prefix; ``update``
    scores with the current models)."""

    family = ""  # subclasses set a repro_torch.detect.families name

    def __init__(self, spec: Optional[DetectorSpec] = None,
                 device: DeviceLike = None):
        self.spec = spec or DetectorSpec()
        self.device = resolve_device(device)
        self._monitor = None
        self._last: Dict[Layer, DetectionResult] = {}

    def _factory(self):
        from repro_torch.detect.families import model_factory

        return model_factory(self.family, seed=self.spec.seed,
                             n_trees=self.spec.n_trees,
                             refresh_trees=self.spec.refresh_trees,
                             var_target=self.spec.var_target)

    @property
    def fitted(self) -> bool:
        return self._monitor is not None and bool(self._monitor.detectors)

    def fit(self, data: EventsOrColumns) -> List[Layer]:
        from repro_torch.detect.families import ModelStackMonitor

        contamination = (BATCH_CONTAMINATION
                         if self.spec.contamination is None
                         else self.spec.contamination)
        self._monitor = ModelStackMonitor(
            self._factory(), contamination=contamination,
            min_events=self.spec.min_events).fit(data)
        return list(self._monitor.detectors)

    def update(self, data: EventsOrColumns) -> Dict[Layer, DetectionResult]:
        if not self.fitted:
            return {}
        self._last = self._monitor.detect(data)
        return self._last

    def flags(self) -> Dict[Layer, DetectionResult]:
        return self._last


class OnlineModelBackend(OnlineGMMBackend):
    """The streaming pipeline for any score-model family: swaps the GMM
    window detector for an `OnlineModelDetector` and inherits everything
    else (async trio, incidents, wire transport) from `OnlineGMMBackend`."""

    family = ""

    def _window_detector(self, contamination: float):
        from repro_torch.detect.families import model_factory
        from repro_torch.stream.backends import OnlineModelDetector

        factory = model_factory(self.family, seed=self.spec.seed,
                                n_trees=self.spec.n_trees,
                                refresh_trees=self.spec.refresh_trees,
                                var_target=self.spec.var_target)
        return OnlineModelDetector(factory, family=self.family,
                                   contamination=contamination,
                                   min_events=self.spec.min_events,
                                   seed=self.spec.seed)

    def configure_topology(self, topology) -> None:
        if topology is None:
            return
        raise ValueError(
            "hierarchical topology currently requires the 'gmm' detector "
            f"family (got backend={self.family!r}); drop the topology "
            "section or switch backends")


@register_detector("isoforest", mode="batch")
class BatchIsoForestBackend(BatchModelBackend):
    """Extended isolation ensemble (`repro_torch.detect.isoforest`), batch."""

    family = "isoforest"


@register_detector("isoforest", mode="stream")
class OnlineIsoForestBackend(OnlineModelBackend):
    """Extended isolation ensemble with warm-started tree reuse, stream."""

    family = "isoforest"


@register_detector("mad", mode="batch")
class BatchMADBackend(BatchModelBackend):
    """Robust per-feature quantile/MAD floor (`repro_torch.detect.robust`),
    batch."""

    family = "mad"


@register_detector("mad", mode="stream")
class OnlineMADBackend(OnlineModelBackend):
    """Robust per-feature quantile/MAD floor, stream."""

    family = "mad"


@register_detector("spectral", mode="batch")
class BatchSpectralBackend(BatchModelBackend):
    """PCA/spectral-residual detector (`repro_torch.detect.spectral`),
    batch."""

    family = "spectral"


@register_detector("spectral", mode="stream")
class OnlineSpectralBackend(OnlineModelBackend):
    """PCA/spectral-residual detector with incremental subspace updates,
    stream."""

    family = "spectral"
