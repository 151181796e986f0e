"""Sink pipeline: where a session's observations end up (port of
`repro/session/sinks.py`).

A sink receives the session's event stream and/or raw wire batches while the
session runs, and is closed with the final `MonitorReport`:

    on_events(events) — decoded events (batch: one drain at finalise;
                        stream: each node flush, already ts-rebased)
    on_wire(buf)      — wire-encoded `EventBatch` bytes (stream transport;
                        batch mode encodes the final drain per node)
    bind_session(s)   — session sinks only (``wants_session``): attach to
                        the running session before monitoring starts
    on_flush()        — session sinks only: called at every detection
                        cadence point (flush/sweep) to refresh live output
    close(report)     — flush and return the output path (or None)

Builtin kinds: ``perfetto`` (trace viewer JSON), ``jsonl`` (one event per
line), ``wire`` (length-prefixed wire batches, replayable through
`wire.decode`), ``report`` (the unified MonitorReport as JSON, incidents
included), ``incident_report`` (the operator-facing markdown incident
report with diagnoses + a JSON sibling). Third-party sinks register with
``@register_sink("kind")`` and become addressable from `SinkSpec.kind`. The
reference's live ``prometheus`` and ``board`` sinks (`repro/obs/sinks.py`)
come with the port's ``obs/`` slice; asking for one raises until then.
"""
from __future__ import annotations

import json
import os
import struct
from typing import IO, List, Optional

from repro_torch.core.events import Event, to_chrome_trace
from repro_torch.session.registry import register_sink, sink_class
from repro_torch.session.spec import SinkSpec


class Sink:
    kind = "sink"
    wants_events = False
    wants_wire = False
    # session sinks observe the running Session itself (self-telemetry)
    # rather than the event stream; they get bind_session() before
    # monitoring starts and on_flush() at every detection cadence point
    wants_session = False

    def __init__(self, path: str = "", **options):
        self.path = path
        self.options = options
        self.session = None

    def on_events(self, events: List[Event]) -> None:
        pass

    def on_wire(self, buf: bytes) -> None:
        pass

    def bind_session(self, session) -> None:
        self.session = session

    def on_flush(self) -> None:
        pass

    def close(self, report) -> Optional[str]:
        return None


# sinks of the reference that wait for a later slice of the port
LATER_SINKS = {"prometheus": "obs/ (repro/obs/sinks.py)",
               "board": "obs/ (repro/obs/sinks.py)"}


def build_sink(spec: SinkSpec) -> Sink:
    if spec.kind in LATER_SINKS:
        raise NotImplementedError(
            f"sink {spec.kind!r} is not ported yet: it comes with the "
            f"{LATER_SINKS[spec.kind]} slice of the port")
    return sink_class(spec.kind)(path=spec.path, **spec.options)


def _ensure_dir(path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)


def atomic_write(path: str, data) -> str:
    """Write a whole file atomically: tmp sibling + `os.replace`. A reader
    (browser tab on the board, scraper on the exposition file) never sees a
    half-written document, and a run that dies mid-write leaves the previous
    complete version in place."""
    _ensure_dir(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    mode = "wb" if isinstance(data, (bytes, bytearray)) else "w"
    try:
        with open(tmp, mode) as f:
            f.write(data)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


@register_sink("perfetto")
class PerfettoSink(Sink):
    """Accumulates the event stream; writes one Chrome-trace JSON at close.

    Bounded: keeps the newest ``max_events`` (spec option; default 1M) so a
    long streaming run cannot grow the trace buffer without limit — the
    exported trace covers the tail of the run, like a flight recorder."""

    kind = "perfetto"
    wants_events = True

    def __init__(self, path: str = "results/trace.json", **options):
        super().__init__(path or "results/trace.json", **options)
        self.max_events = int(options.get("max_events", 1_000_000))
        self.events_dropped = 0
        self._events: List[Event] = []

    def on_events(self, events: List[Event]) -> None:
        self._events.extend(events)
        if len(self._events) > self.max_events:
            self.events_dropped += len(self._events) - self.max_events
            self._events = self._events[-self.max_events:]

    def close(self, report) -> Optional[str]:
        self._events.sort(key=lambda e: e.ts)
        return atomic_write(self.path, json.dumps(
            to_chrome_trace(self._events)))


@register_sink("jsonl")
class JsonlEventSink(Sink):
    """Streams events as JSON lines (incremental; bounded memory)."""

    kind = "jsonl"
    wants_events = True

    def __init__(self, path: str = "results/events.jsonl", **options):
        super().__init__(path or "results/events.jsonl", **options)
        self._f: Optional[IO[str]] = None
        self.events_written = 0

    def on_events(self, events: List[Event]) -> None:
        if self._f is None:
            _ensure_dir(self.path)
            self._f = open(self.path, "w")
        for e in events:
            self._f.write(json.dumps(e.to_json()) + "\n")
        self.events_written += len(events)

    def close(self, report) -> Optional[str]:
        if self._f is None:
            return None
        self._f.close()
        self._f = None
        return self.path


@register_sink("wire")
class WireSink(Sink):
    """Length-prefixed wire batches — a replayable transport capture (each
    frame decodes with `repro_torch.stream.wire.decode`, and with the
    reference's `repro.stream.wire.decode`: the wire is byte-identical)."""

    kind = "wire"
    wants_wire = True

    def __init__(self, path: str = "results/events.wire", **options):
        super().__init__(path or "results/events.wire", **options)
        self._f: Optional[IO[bytes]] = None
        self.batches_written = 0

    def on_wire(self, buf: bytes) -> None:
        if self._f is None:
            _ensure_dir(self.path)
            self._f = open(self.path, "wb")
        self._f.write(struct.pack("<I", len(buf)))
        self._f.write(buf)
        self.batches_written += 1

    def close(self, report) -> Optional[str]:
        if self._f is None:
            return None
        self._f.close()
        self._f = None
        return self.path


@register_sink("report")
class ReportSink(Sink):
    """Writes the final unified MonitorReport (incidents included) as JSON."""

    kind = "report"

    def __init__(self, path: str = "results/monitor_report.json", **options):
        super().__init__(path or "results/monitor_report.json", **options)

    def close(self, report) -> Optional[str]:
        return report.save(self.path)


@register_sink("incident_report")
class IncidentReportSink(Sink):
    """Writes the operator incident report: ranked incidents with their
    root-cause diagnoses, causal chains, and recommended actions as markdown
    (`repro_torch.diagnosis.render_incident_report`), plus a machine-readable
    ``.json`` sibling next to it."""

    kind = "incident_report"

    def __init__(self, path: str = "results/incident_report.md", **options):
        super().__init__(path or "results/incident_report.md", **options)

    def close(self, report) -> Optional[str]:
        from repro_torch.diagnosis import render_incident_report, report_json

        atomic_write(self.path, render_incident_report(
            report.incidents, report.diagnoses, mode=report.mode))
        json_path = os.path.splitext(self.path)[0] + ".json"
        atomic_write(json_path, report_json(report.incidents,
                                            report.diagnoses))
        return self.path


def read_wire_capture(path: str) -> List[bytes]:
    """Inverse of WireSink: the captured frames, ready for `wire.decode`."""
    frames: List[bytes] = []
    with open(path, "rb") as f:
        while True:
            head = f.read(4)
            if len(head) < 4:
                break
            (n,) = struct.unpack("<I", head)
            frames.append(f.read(n))
    return frames
