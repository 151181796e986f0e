"""Session: one facade over batch and streaming monitoring (port of
`repro/session/session.py`).

The session subsumes the two hand-wired paths the drivers used to carry
(`Collector.standard()` + `FullStackMonitor` vs `StreamMonitor`'s
register/poll/tick/finish) behind a single lifecycle driven by a
`MonitorSpec`:

    spec = MonitorSpec(mode="stream")          # or from_file / from_args
    session = Session(spec, device="cuda")     # where the GMMs run
    with session.monitoring():
        step_fn = session.observe_step_fn(step_fn, sample_args=(state, b0))
        for step, batch in enumerate(data):
            state = step_fn(state, batch)
            out = session.on_step(step)        # cadence handled by the spec
    report = session.result()                  # unified MonitorReport

``mode="off"`` makes every call a no-op (``observe_step_fn`` returns the
callable unchanged), so drivers keep exactly one code path. Multi-node fleets
use ``session.node(node_id)`` to get additional monitored nodes (own
collector + probe suite built from the same spec).

On a CUDA device the async detection plane's sweeps run on a stream of
their own (`DetectionExecutor`), so they never queue behind the training
step. With a ``topology`` the stream backend runs the hierarchical fleet
plane (`repro_torch.fleet`), each group's detector on the session's device.
With ``spec.slo`` and the ``request`` probe, the request plane's SLOs are
judged every step (`repro_torch.serve.slo`), a plane apart from the GMM
anomalies. The ``prometheus`` and ``board`` sinks read the session's
self-telemetry (`obs_layer`, `repro_torch.obs.SessionObs`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.collector import Collector
from repro_torch.core.events import (Event, Layer, concat_columns,
                               select_columns)
from repro_torch.core.governor import Action, Governor
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.session import sinks as sinks_mod
from repro_torch.session.registry import build_probes, detector_backend
from repro_torch.session.report import MonitorReport
from repro_torch.session.spec import MonitorSpec
from repro_torch.stream import wire
from repro_torch.stream.incidents import Incident, IncidentEngine


@dataclasses.dataclass
class StepOutcome:
    """What one `on_step` call produced (empty between cadence points)."""

    warmed: List[Layer] = dataclasses.field(default_factory=list)
    incidents: List[Incident] = dataclasses.field(default_factory=list)
    actions: List[Action] = dataclasses.field(default_factory=list)
    detections: Dict[Layer, Any] = dataclasses.field(default_factory=dict)
    # root-cause diagnoses of the incidents closed by this step
    diagnoses: List[Any] = dataclasses.field(default_factory=list)

    def __bool__(self) -> bool:
        return bool(self.warmed or self.incidents or self.actions
                    or self.detections or self.diagnoses)


class NodeHandle:
    """One monitored node: a collector built from the session's spec."""

    def __init__(self, session: "Session", node_id: int,
                 collector: Collector):
        self.session = session
        self.node_id = node_id
        self.collector = collector

    def observe_step_fn(self, fn: Callable, **kw) -> Callable:
        return self.collector.observe_step_fn(fn, **kw)


class Session:
    def __init__(self, spec: Optional[MonitorSpec] = None,
                 device: DeviceLike = None):
        self.spec = spec or MonitorSpec()
        self.device = None
        # self-telemetry layer (repro_torch.obs.SessionObs), created on
        # demand by the first session sink that binds (prometheus/board)
        self.obs = None
        self._nodes: Dict[int, NodeHandle] = {}
        self._active = False
        self._report: Optional[MonitorReport] = None
        self._sinks: List[sinks_mod.Sink] = []
        self._backend = None
        self.governor: Optional[Governor] = None
        self._diagnoses_seen: List[Any] = []
        self._actions_seen: List[Action] = []
        # async detection plane (repro_torch.detect): background executor +
        # staleness of the most recently admitted batch sweep
        self._executor = None
        self.async_lag_steps = 0
        self.async_lag_seconds = 0.0
        self.sweeps_admitted = 0
        self._last_step = 0  # newest step seen; finalize admits against it
        if self.off:
            return
        self.device = resolve_device(device)
        self._sinks = [sinks_mod.build_sink(s) for s in self.spec.sinks]
        self._backend = detector_backend(
            self.spec.detector.backend, self.spec.mode)(self.spec.detector,
                                                        device=self.device)
        if self.spec.detector.async_detect:
            from repro_torch.detect import DetectionExecutor

            # on the card, a threaded sweep gets a stream of its own; an
            # inline sweep runs on the caller's: kernels on a second stream
            # move the job's later graph replays between two levels ~5%
            # apart (scripts/step_levels.py), a shift the STEP layer flags
            stream = (torch.cuda.Stream(self.device)
                      if self.device.type == "cuda"
                      and self.spec.detector.executor == "thread" else None)
            self._executor = DetectionExecutor(
                mode=self.spec.detector.executor, stream=stream)
            if hasattr(self._backend, "attach_executor"):
                self._backend.attach_executor(self._executor)
        if self.spec.topology is not None:
            # node -> group -> fleet tree (repro_torch.fleet); must precede node
            # registration AND the wire-tap below, which replaces the monitor
            if hasattr(self._backend, "configure_topology"):
                self._backend.configure_topology(self.spec.topology)
            else:
                warnings.warn(
                    f"detector backend {self.spec.detector.backend!r} has "
                    "no topology support; the topology section is ignored",
                    UserWarning, stacklevel=2)
        if self.spec.governor:
            self.governor = Governor()
        self._diagnoser = None
        if self.spec.diagnosis:
            from repro_torch.diagnosis import Diagnoser

            self._diagnoser = Diagnoser()
        # request-plane SLO monitoring: a separate thresholding plane over
        # the request probe's rows, never mixed with the GMM anomaly flags
        self._slo = None
        self._slo_diagnoses: List[Any] = []
        if self.spec.slo is not None:
            if "request" in self.spec.probes:
                from repro_torch.serve.slo import SLOMonitor

                self._slo = SLOMonitor(self.spec.slo)
            else:
                warnings.warn(
                    "spec.slo is set but the 'request' probe is not in "
                    "spec.probes; SLOs will not be judged",
                    UserWarning, stacklevel=2)
        if self.spec.mode == "stream":
            # tee the wire transport into the sink pipeline
            if any(s.wants_wire or s.wants_events for s in self._sinks):
                self._backend.monitor.wire_tap = self._tap_wire
        for s in self._sinks:
            if s.wants_session:
                s.bind_session(self)

    # -- basic properties -----------------------------------------------------
    @property
    def off(self) -> bool:
        return self.spec.mode == "off"

    @property
    def detector(self):
        return self._backend

    @property
    def collector(self) -> Optional[Collector]:
        return None if self.off else self.node(0).collector

    def obs_layer(self, **kw):
        """Get-or-create the session's self-telemetry layer
        (`repro_torch.obs.SessionObs`); shared by every session sink, so the
        exposition endpoint, the metrics file, and the status board all
        read one registry."""
        if self.off:
            raise RuntimeError("mode 'off' sessions have no telemetry")
        if self.obs is None:
            from repro_torch.obs.selfmetrics import SessionObs

            self.obs = SessionObs(self, **kw)
        return self.obs

    def sink(self, kind: str) -> sinks_mod.Sink:
        """The first configured sink of ``kind`` (e.g. to read the
        prometheus sink's bound endpoint port)."""
        for s in self._sinks:
            if s.kind == kind:
                return s
        raise KeyError(f"no sink of kind {kind!r} in this session; "
                       f"configured: {[s.kind for s in self._sinks]}")

    # -- telemetry accessors (read by repro_torch.obs) -----------------------
    def incidents_seen(self) -> List[Incident]:
        """Incidents finalised so far, severity-ranked (stream: live from
        the engine; batch: from the final report once built). SLO-breach
        incidents are merged in until the final report carries them."""
        if self._report is not None:
            return sorted(self._report.incidents, key=lambda i: -i.severity)
        slo = self.slo_incidents_seen()
        if self.spec.mode == "stream" and self._backend is not None:
            slo = self._backend.monitor.engine.ranked() + slo
        return sorted(slo, key=lambda i: -i.severity)

    def slo_incidents_seen(self) -> List[Incident]:
        """Request-plane SLO-breach incidents closed so far."""
        return list(self._slo.closed) if self._slo is not None else []

    def serve_stats(self) -> Dict[str, float]:
        """Request-plane aggregates (probe running totals + SLO counters);
        empty when no request probe is attached."""
        probe = self._request_probe()
        out: Dict[str, float] = dict(probe.stats()) if probe else {}
        if self._slo is not None:
            out["slo_breaches_total"] = float(self._slo.breaches_total)
            out["slo_breach_incidents_total"] = float(len(self._slo.closed))
        return out

    def _request_probe(self):
        for h in self._nodes.values():
            for p in h.collector.probes:
                if p.name == "request":
                    return p
        return None

    def diagnoses_seen(self) -> List[Any]:
        """Root-cause diagnoses emitted so far (finalise replaces the
        mid-run set: the final sweep re-diagnoses every incident)."""
        return list(self._diagnoses_seen)

    def incident_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for i in self.incidents_seen():
            key = i.suspect_layer.value
            out[key] = out.get(key, 0) + 1
        return out

    def diagnosis_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for d in self._diagnoses_seen:
            out[d.fault_kind] = out.get(d.fault_kind, 0) + 1
        return out

    def action_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for a in self._actions_seen:
            out[a.kind] = out.get(a.kind, 0) + 1
        return out

    # -- fleet membership -----------------------------------------------------
    def node(self, node_id: int = 0, ts_offset: float = 0.0) -> NodeHandle:
        if self.off:
            raise RuntimeError("mode 'off' sessions have no monitored nodes")
        if node_id not in self._nodes:
            probes = build_probes(self.spec.probes, self.spec.probe_options)
            col = Collector(probes, self.spec.capacity)
            handle = NodeHandle(self, node_id, col)
            self._nodes[node_id] = handle
            if self.spec.mode == "stream":
                self._backend.register_node(node_id, col,
                                            ts_offset=ts_offset)
            if self._active:
                col.attach()
        return self._nodes[node_id]

    # -- lifecycle ------------------------------------------------------------
    @contextlib.contextmanager
    def monitoring(self):
        if self.off:
            yield self
            return
        self.node(0)  # default node exists for observe_step_fn
        for h in self._nodes.values():
            h.collector.attach()
        self._active = True
        try:
            yield self
        finally:
            try:
                self._finalize()
            finally:
                self._active = False
                for h in reversed(list(self._nodes.values())):
                    h.collector.detach()

    def observe_step_fn(self, fn: Callable, **kw) -> Callable:
        """Wrap the node-0 step callable; identity when monitoring is off."""
        if self.off:
            return fn
        return self.node(0).observe_step_fn(fn, **kw)

    # probes that observe the process globally and would therefore record the
    # detector's own work: the python profile hook fires on every
    # repro_torch/torch call, and the xla probe's runtime hooks fire on the
    # EM fit's synchronisations
    SELF_OBSERVING_PROBES = ("python", "xla")

    @contextlib.contextmanager
    def _detection_pause(self):
        """Detach self-observing probes while detection runs. Monitor
        self-observation both poisons those layers' features (the EM fit's
        unfamiliar call/dispatch events score as anomalies at whatever step
        the sweep lands on) and, for the python hook, turns a seconds-long
        sweep into minutes. The block runs on the detection plane's stream,
        as its sweeps do (`DetectionExecutor.on_stream`)."""
        paused = [(h, p) for h in self._nodes.values()
                  for p in h.collector.probes
                  if p.name in self.SELF_OBSERVING_PROBES and p.attached]
        for _, p in paused:
            p.detach()
        try:
            if self._executor is None:
                yield
            else:
                with self._executor.on_stream():
                    yield
        finally:
            for h, p in paused:
                p.attach(h.collector.buffer, t0=h.collector.t0)

    # -- cadence --------------------------------------------------------------
    def on_step(self, step: int) -> StepOutcome:
        """Call once per training/serving step; the spec decides when this
        flushes, fits, detects, and forms incidents. The SLO plane (when
        configured) is judged every call — breaches must not wait for a
        detector cadence point."""
        out = StepOutcome()
        if self.off or step <= 0:
            return out
        self._last_step = max(self._last_step, step)
        det = self.spec.detector
        cadence = step % (det.flush_every if self.spec.mode == "stream"
                          else det.sweep_every) == 0
        if cadence:
            self._detect_step(step, out)
        self._slo_step(out)
        if not cadence and not out:
            return out
        if self.governor is not None and out.detections:
            out.actions = self.governor.decide(out.detections)
        if self.governor is not None and out.diagnoses:
            out.actions.extend(d.action for d in out.diagnoses)
            out.actions.sort(key=lambda a: -a.severity)
        self._diagnoses_seen.extend(out.diagnoses)
        self._actions_seen.extend(out.actions)
        self._refresh_sinks()
        return out

    def _detect_step(self, step: int, out: StepOutcome) -> None:
        """One detector cadence point (anomaly plane), filling ``out``."""
        det = self.spec.detector
        if self.spec.mode == "stream":
            if not self._backend.fitted:
                out.warmed = self.warmup()
                return
            n_closed = len(self._backend.closed)
            with self._detection_pause():
                if self._executor is not None:
                    out.detections = self._backend.update_async(step)
                    self.async_lag_steps = self._backend.lag_steps
                    self.async_lag_seconds = self._backend.lag_seconds
                    self.sweeps_admitted = self._backend.sweeps_admitted
                else:
                    out.detections = self._backend.update()
            out.incidents = self._backend.closed[n_closed:]
            if out.incidents and self._diagnoser is not None:
                out.diagnoses = self._diagnoser.diagnose_all(
                    out.incidents, self._stream_evidence())
        else:  # batch: periodic snapshot sweep (fit on the clean prefix)
            cols = self._snapshot_columns()
            train = select_columns(
                cols, cols["step"] < step - det.holdoff_steps)
            if not train["ts"].shape[0]:
                return
            with self._detection_pause():
                if self._executor is not None:
                    out.detections = self._batch_sweep_async(step, cols,
                                                             train)
                else:
                    self._backend.fit(train)
                    out.detections = self._backend.update(cols)

    def _slo_step(self, out: StepOutcome) -> None:
        """Judge freshly drained request rows against the SLO spec; append
        any closed breach incidents (and their request-plane diagnoses)."""
        if self._slo is None:
            return
        probe = self._request_probe()
        if probe is None:
            return
        self._slo.observe(probe.drain_slo_rows())
        closed = self._slo.tick()
        if not closed:
            return
        out.incidents = list(out.incidents) + closed
        if self._diagnoser is not None:
            diags = [d for d in (
                self._diagnoser.diagnose_slo(
                    inc, self._slo.evidence_for(inc), self.spec.slo)
                for inc in closed) if d is not None]
            out.diagnoses = list(out.diagnoses) + diags
            self._slo_diagnoses.extend(diags)

    def _batch_sweep_async(self, step: int, cols, train) -> Dict[Layer, Any]:
        """Batch-mode async sweep: the fit+score closure runs on the
        executor over the snapshot taken THIS cadence point; the detections
        published now are from the most recently COMPLETED sweep (same step
        under the inline executor, typically the previous cadence point
        under the thread executor — staleness in ``async_lag_steps``)."""
        backend = self._backend

        def sweep():
            backend.fit(train)
            return backend.update(cols)

        self._executor.submit("batch", sweep, step=step)
        return self._admit_batch(step)

    def _admit_batch(self, step: int) -> Dict[Layer, Any]:
        detections: Dict[Layer, Any] = {}
        for r in self._executor.drain():
            if r.key != "batch":
                continue
            if r.error is not None:
                raise r.error
            detections = r.value or {}
            self.async_lag_steps = step - r.step
            self.async_lag_seconds = r.lag_s
            self.sweeps_admitted += 1
        return detections

    def warmup(self) -> List[Layer]:
        """Streaming: fit baselines on the (assumed clean) data so far.
        No-op in other modes (batch fits on its sweep cadence)."""
        if self.off or self.spec.mode != "stream":
            return []
        with self._detection_pause():
            fitted = self._backend.fit()
        self._refresh_sinks()
        return fitted

    def tick(self) -> List[Incident]:
        """Streaming: one poll/detect/incident cycle, off-cadence."""
        if self.off or self.spec.mode != "stream":
            return []
        n_closed = len(self._backend.closed)
        with self._detection_pause():
            if self._executor is not None:
                self._backend.update_async()
            else:
                self._backend.update()
        self._refresh_sinks()
        return self._backend.closed[n_closed:]

    # -- sinks ----------------------------------------------------------------
    def _refresh_sinks(self) -> None:
        """Let live sinks (board, exposition file) rewrite their output;
        called at every detection cadence point. A failing sink must not
        take down the monitored run."""
        for s in self._sinks:
            if s.wants_session:
                try:
                    s.on_flush()
                except Exception as e:
                    warnings.warn(
                        f"sink {s.kind!r}: on_flush failed ({e!r})",
                        RuntimeWarning, stacklevel=2)

    def _tap_wire(self, buf: bytes) -> None:
        events: Optional[List[Event]] = None
        for s in self._sinks:
            if s.wants_wire:
                s.on_wire(buf)
            if s.wants_events:
                if events is None:
                    batch = wire.decode(buf)
                    events = wire.columns_to_events(batch.columns)
                    for e in events:  # per-node tracks, like export_trace
                        e.pid = batch.node_id
                s.on_events(events)

    def _snapshot_columns(self) -> Dict[str, np.ndarray]:
        return concat_columns([h.collector.snapshot_columns()
                               for h in self._nodes.values()])

    # -- diagnosis ------------------------------------------------------------
    def _stream_evidence(self):
        """Per-layer evidence for the diagnoser: the aggregator's current
        window views (bounded by the sliding-window horizon)."""
        agg = self._backend.aggregator
        return {layer: w.view() for layer, w in agg.windows.items()
                if len(w)}

    def _batch_incidents(self, cols: Dict[str, np.ndarray],
                         detections: Dict[Layer, Any]) -> List[Incident]:
        """Form incidents from the final batch detections — the batch-mode
        analogue of the streaming IncidentEngine path. Calibration flags
        inside the training prefix (the contamination quantile flags ~c% of
        it by construction) are excluded via the engine floor."""
        det = self.spec.detector
        engine = IncidentEngine(gap_s=det.incident_gap_s,
                                close_after_s=det.incident_close_after_s,
                                min_flags=det.min_flags)
        if cols["ts"].shape[0]:
            last = int(cols["step"].max())
            train = cols["step"] < last - det.holdoff_steps
            if train.any():
                engine.set_floor(float(cols["ts"][train].max()))
        engine.update(detections)
        engine.flush()
        return engine.ranked()

    # -- finalisation ---------------------------------------------------------
    def _finalize(self) -> None:
        # Detach every probe BEFORE the final drain: the drained columns are
        # zero-copy views, and sink materialisation / final fits must not
        # race live emission (the python probe in particular fires on the
        # materialisation loop's own frames). monitoring() detaches again on
        # exit — detach is idempotent.
        for h in reversed(list(self._nodes.values())):
            h.collector.detach()
        incidents: List[Incident] = []
        detections: Dict[Layer, Any] = {}
        diagnoses: List[Any] = []
        try:
            if self._executor is not None and self.spec.mode == "batch":
                # quiesce in-flight batch sweeps before the final
                # synchronous refit below (their detections are superseded
                # by it; draining only updates staleness accounting)
                self._executor.flush()
                self._admit_batch(step=self._last_step)
            if self.spec.mode == "stream":
                with self._detection_pause():
                    self._backend.finish(step=self._last_step)
                incidents = self._backend.incidents  # ranked, all closed
                detections = self._backend.flags()
            else:
                parts: List[Dict[str, np.ndarray]] = []
                for h in self._nodes.values():
                    node_cols = h.collector.drain_columns()
                    # per-node tracks, matching the stream path (_tap_wire):
                    # replace the OS pid with the fleet node id (new array —
                    # the drained views alias ring storage, stay untouched)
                    node_cols["pid"] = np.full(node_cols["ts"].shape[0],
                                               h.node_id, dtype=np.int64)
                    events: Optional[List[Event]] = None
                    for s in self._sinks:
                        if s.wants_events:  # compat sinks: materialise ONCE
                            if events is None:
                                events = wire.columns_to_events(node_cols)
                            s.on_events(events)
                        if s.wants_wire:
                            s.on_wire(wire.encode_columns(
                                node_cols, node_id=h.node_id, seq=0))
                    parts.append(node_cols)
                cols = concat_columns(parts)
                with self._detection_pause():
                    if cols["ts"].shape[0]:
                        # final refit on the full clean prefix: mid-run
                        # sweeps may have fitted before slow layers reached
                        # min_events
                        last = int(cols["step"].max())
                        train = select_columns(
                            cols, cols["step"]
                            < last - self.spec.detector.holdoff_steps)
                        self._backend.fit(
                            train if train["ts"].shape[0] else cols)
                    detections = self._backend.update(cols)
                if detections:
                    incidents = self._batch_incidents(cols, detections)
            if incidents and self._diagnoser is not None:
                if self.spec.mode == "stream":
                    evidence = self._stream_evidence()
                else:
                    from repro_torch.diagnosis import evidence_from_columns

                    evidence = evidence_from_columns(cols)
                diagnoses = self._diagnoser.diagnose_all(incidents, evidence)
        finally:
            # Flush-on-interrupt: even if the finalise sweep raised (or the
            # run was Ctrl-C'd), build a report from what we have and close
            # every sink, so the board/metrics/report artifacts are valid.
            if self.spec.mode == "stream" and not incidents \
                    and self._backend is not None:
                incidents = self._backend.incidents  # whatever closed so far
            if self._slo is not None:
                # drain + force-close the SLO plane, then merge its full
                # incident set (mid-run closes included) into the report
                try:
                    probe = self._request_probe()
                    if probe is not None:
                        self._slo.observe(probe.drain_slo_rows())
                    for inc in self._slo.flush():
                        if self._diagnoser is None:
                            continue
                        d = self._diagnoser.diagnose_slo(
                            inc, self._slo.evidence_for(inc), self.spec.slo)
                        if d is not None:
                            self._slo_diagnoses.append(d)
                except Exception as e:
                    warnings.warn(f"SLO finalise failed ({e!r})",
                                  RuntimeWarning, stacklevel=2)
                incidents = list(incidents) + list(self._slo.closed)
            if diagnoses:
                # the final sweep re-diagnoses every anomaly incident;
                # replace the mid-run accumulation instead of double
                # counting, then append the SLO plane's diagnoses (which
                # are only ever produced once per incident)
                diagnoses = list(diagnoses) + list(self._slo_diagnoses)
                self._diagnoses_seen = list(diagnoses)
            elif self._diagnoses_seen or self._slo_diagnoses:
                # no final anomaly sweep output: keep the mid-run set and
                # fold in any SLO diagnoses it does not already contain
                # (mid-run SLO closes were appended to both ledgers)
                merged = list(self._diagnoses_seen)
                merged += [d for d in self._slo_diagnoses
                           if not any(d is m for m in merged)]
                diagnoses = merged
                self._diagnoses_seen = list(merged)
            if self._executor is not None:
                self._executor.close()
                if hasattr(self._backend, "sweeps_admitted"):
                    # stream: the backend drove admission; mirror its final
                    # staleness accounting onto the session surface
                    self.async_lag_steps = self._backend.lag_steps
                    self.async_lag_seconds = self._backend.lag_seconds
                    self.sweeps_admitted = self._backend.sweeps_admitted
            overhead = {h.node_id: h.collector.overhead_stats()
                        for h in self._nodes.values()}
            if self.spec.mode == "stream" and self._backend is not None:
                overhead["stream"] = self._backend.monitor.stats()
            if self._executor is not None:
                overhead["detect_plane"] = dict(
                    self._executor.stats(),
                    lag_steps=self.async_lag_steps,
                    lag_seconds=self.async_lag_seconds,
                    sweeps_admitted=self.sweeps_admitted)
            report = MonitorReport.build(self.spec.mode, detections,
                                         incidents, overhead,
                                         sink_outputs={},
                                         diagnoses=diagnoses)
            for s in self._sinks:
                try:
                    path = s.close(report)
                except Exception as e:
                    warnings.warn(
                        f"sink {s.kind!r}: close failed ({e!r})",
                        RuntimeWarning, stacklevel=2)
                    continue
                if path:
                    report.sink_outputs[s.kind] = path
            self._report = report

    def result(self) -> MonitorReport:
        """The unified report. Final after `monitoring()` exits; an interim
        snapshot (sinks left open) when called mid-run."""
        if self._report is not None:
            return self._report
        if self.off:
            return MonitorReport.build("off", {}, [], {}, {})
        detections = self._backend.flags()
        incidents = (self._backend.incidents
                     if self.spec.mode == "stream" else [])
        incidents = list(incidents) + self.slo_incidents_seen()
        overhead = {h.node_id: h.collector.overhead_stats()
                    for h in self._nodes.values()}
        return MonitorReport.build(self.spec.mode, detections, incidents,
                                   overhead, sink_outputs={})
