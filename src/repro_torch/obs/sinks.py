"""Live sinks: ``prometheus`` (exposition file + optional HTTP endpoint)
and ``board`` (self-refreshing HTML status board) (port of
`repro/obs/sinks.py`; only the imports differ).

Both are *session* sinks: they don't consume the event stream, they bind to
the running `Session` and publish its self-telemetry (`SessionObs`). The
session calls ``on_flush()`` at every detection-cadence point; each flush
atomically rewrites the output file, and `close()` performs a final write
from the finished report so an interrupted run still leaves a valid
artifact.

SinkSpec options:

    {"kind": "prometheus", "path": "results/metrics.prom",
     "options": {"serve": true, "port": 0, "host": "127.0.0.1"}}
    {"kind": "board", "path": "results/board.html",
     "options": {"refresh_s": 2, "history": 240,
                 "title": "my fleet", "max_label_sets": 64}}

``port: 0`` binds an ephemeral port — read it back from
``session.sink("prometheus").port`` (the fleet demo and tests do this so
parallel runs never collide). Freshness thresholds (``degraded_after_s``,
``stale_after_s``) configure the shared `SessionObs` through either sink.
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Optional

from repro_torch.obs.board import BoardModel, render_board
from repro_torch.obs.httpd import MetricsServer
from repro_torch.session.registry import register_sink
from repro_torch.session.sinks import Sink, atomic_write

# SessionObs constructor knobs a sink may forward from its SinkSpec options
_OBS_KEYS = ("degraded_after_s", "stale_after_s", "max_label_sets")


def _bind_obs(sink: Sink, session):
    kw = {k: sink.options[k] for k in _OBS_KEYS if k in sink.options}
    return session.obs_layer(**kw)


@register_sink("prometheus")
class PrometheusSink(Sink):
    """Renders the monitor's self-telemetry in Prometheus text-exposition
    format — to ``path`` on every flush, and live via a stdlib HTTP
    endpoint (``/metrics`` + ``/healthz``) when ``serve`` is set."""

    kind = "prometheus"
    wants_session = True

    def __init__(self, path: str = "results/metrics.prom", **options):
        super().__init__(path or "results/metrics.prom", **options)
        self.serve = bool(options.get("serve", False))
        self.host = str(options.get("host", "127.0.0.1"))
        self.requested_port = int(options.get("port", 9464))
        self.obs = None
        self.server: Optional[MetricsServer] = None
        self.port: Optional[int] = None

    def bind_session(self, session) -> None:
        super().bind_session(session)
        self.obs = _bind_obs(self, session)
        if self.serve:
            self.server = MetricsServer(
                render_metrics=self.obs.scrape, host=self.host,
                port=self.requested_port, health=self.obs.health).start()
            self.port = self.server.port

    @property
    def url(self) -> Optional[str]:
        return self.server.url if self.server is not None else None

    def on_flush(self) -> None:
        if self.obs is not None:
            atomic_write(self.path, self.obs.scrape())

    def close(self, report) -> Optional[str]:
        if self.obs is None:
            return None
        self.obs.finalize_from_report(report)
        atomic_write(self.path, self.obs.scrape())
        if self.server is not None:
            self.server.stop()
            self.server = None
        return self.path


@register_sink("board")
class BoardSink(Sink):
    """Atomically rewrites a single-file HTML fleet status board every
    flush: health grid, per-layer flag-rate sparklines, incidents, top
    diagnoses with recommended actions."""

    kind = "board"
    wants_session = True

    def __init__(self, path: str = "results/board.html", **options):
        super().__init__(path or "results/board.html", **options)
        self.refresh_s = int(options.get("refresh_s", 2))
        self.max_history = int(options.get("history", 240))
        self.title = str(options.get("title", "eACGM fleet status"))
        self.obs = None
        # per-layer flag-rate series sampled at each flush (sparkline feed)
        self._history: Dict[str, List[float]] = {}

    def bind_session(self, session) -> None:
        super().bind_session(session)
        self.obs = _bind_obs(self, session)

    def _record_history(self) -> None:
        backend = self.session._backend
        if backend is None:
            return
        if self.session.spec.mode == "stream":
            dets = backend.monitor.last_detections
        else:
            dets = backend.flags()
        for layer, d in dets.items():
            series = self._history.setdefault(layer.value, [])
            series.append(float(d.anomaly_rate))
            if len(series) > self.max_history:
                del series[: len(series) - self.max_history]

    def on_flush(self) -> None:
        if self.obs is None:
            return
        self._record_history()
        model = BoardModel.from_obs(self.obs, self._history,
                                    title=self.title,
                                    refresh_s=self.refresh_s)
        atomic_write(self.path, render_board(model))

    def close(self, report) -> Optional[str]:
        if self.obs is None:
            return None
        self.obs.finalize_from_report(report)
        self._record_history()
        # final board stops auto-refreshing (the run is over)
        model = BoardModel.from_obs(self.obs, self._history,
                                    title=self.title, refresh_s=0)
        try:
            atomic_write(self.path, render_board(model))
        except Exception as e:  # a failed final render must not eat close
            warnings.warn(f"board sink: final render failed ({e!r})",
                          RuntimeWarning, stacklevel=2)
        return self.path
