"""Unified monitoring session API (port of `repro/session/`): one
declarative spec, pluggable probes/detectors/sinks for batch and streaming.

Public API:
    MonitorSpec / DetectorSpec / SinkSpec — declarative session description
        (Python / JSON file / --monitor-spec CLI / REPRO_MONITOR_SPEC env)
    Session          — one lifecycle over batch + streaming monitoring
    MonitorReport    — unified per-layer detections + incidents result
    register_probe / register_detector / register_sink — extension points
    BatchGMMBackend / OnlineGMMBackend — Detector-protocol adapters over the
        GMM detectors
"""
from repro_torch.session.spec import (DetectorSpec, MonitorSpec,  # noqa: F401
                                      SinkSpec, SPEC_ENV_VAR,
                                      STANDARD_PROBES)
from repro_torch.session.registry import (build_probe,  # noqa: F401
                                          build_probes, detector_backend,
                                          detector_backends, detector_names,
                                          probe_names, register_detector,
                                          register_probe, register_sink,
                                          sink_kinds)
from repro_torch.session.detectors import (BatchGMMBackend,  # noqa: F401
                                           Detector, OnlineGMMBackend)
from repro_torch.session.sinks import (IncidentReportSink,  # noqa: F401
                                       JsonlEventSink, PerfettoSink,
                                       ReportSink, Sink, WireSink,
                                       read_wire_capture)
from repro_torch.session.report import LayerSummary, MonitorReport  # noqa: F401
from repro_torch.session.session import (NodeHandle, Session,  # noqa: F401
                                         StepOutcome)
