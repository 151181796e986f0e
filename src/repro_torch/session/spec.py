"""MonitorSpec: one declarative description of a monitoring session (port
of `repro/session/spec.py`: the same fields and defaults, so a spec's JSON
is the reference's).

A spec names everything the old drivers hand-wired — which probes to attach
(by registry name), how to detect (batch refit sweeps vs streaming windowed
EM), and where results go (sinks) — and is constructible from Python, from a
JSON file, or from a single ``--monitor-spec`` CLI/env knob:

    MonitorSpec(mode="stream")                        # Python
    MonitorSpec.from_file("examples/fleet_spec.json")  # JSON file
    --monitor-spec '{"mode": "batch"}'                 # inline JSON
    --monitor-spec examples/fleet_spec.json            # path
    REPRO_MONITOR_SPEC=...                             # environment

``from_args`` also maps the deprecated per-driver flags (``--monitor``,
``--stream-monitor``, ``--stream-flush-every``, ``--trace-out``) onto spec
fields so old command lines keep working.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import warnings
from typing import Any, Dict, List, Mapping, Optional

from repro_torch.fleet.topology import TopologySpec

SPEC_ENV_VAR = "REPRO_MONITOR_SPEC"
MODES = ("off", "batch", "stream")
# default probe suite = Collector.standard()'s hard-coded list, now by name
STANDARD_PROBES = ("python", "xla", "operator", "collective", "device", "step")


def _check_fields(cls, d: Mapping[str, Any]) -> None:
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(d) - known)
    if unknown:
        raise ValueError(f"unknown {cls.__name__} field(s) {unknown}; "
                         f"known: {sorted(known)}")


@dataclasses.dataclass
class DetectorSpec:
    """Detection parameters; ``backend`` is a detector-registry name resolved
    per mode (``("gmm", "batch")`` -> BatchGMMBackend, ``("gmm", "stream")``
    -> OnlineGMMBackend)."""

    backend: str = "gmm"
    n_components: int = 3
    # None -> backend default (batch: 1/6, the paper's Table-I policy;
    # stream: 0.02, the fleet monitor's per-window rate)
    contamination: Optional[float] = None
    min_events: int = 64
    seed: int = 0
    # batch mode: refit cadence and the clean-prefix holdoff
    sweep_every: int = 50
    holdoff_steps: int = 25
    # stream mode: model tracking. True = warm-started EM refit per window
    # (cold refit on drift); False = the model is frozen after warmup — the
    # evaluation harness sweeps this to price what tracking buys
    warm_start: bool = True
    # stream mode: flush/tick cadence + window and incident parameters
    flush_every: int = 25
    horizon_s: float = 60.0
    capacity_per_layer: int = 65536
    drift_tol: float = 3.0
    incident_gap_s: float = 1.0
    incident_close_after_s: float = 2.0
    min_flags: int = 8
    # async detection plane: sweeps run on a background executor and their
    # results are admitted at the NEXT cadence point (docs/detection.md).
    # False = legacy synchronous sweeps on the step thread.
    async_detect: bool = True
    # executor mode when async: "thread" (background worker — the step
    # thread never runs EM) or "inline" (execute at submit; deterministic,
    # byte-identical to the synchronous path — tests and debugging)
    executor: str = "thread"
    # stream mode: incremental (stepwise-EM) warm refits — fold only the
    # window rows that arrived since the last sweep into persistent
    # sufficient statistics instead of re-running EM on a window bootstrap
    incremental: bool = True
    # family knobs (ignored by backends they do not apply to, like
    # n_components is by the non-GMM families):
    # isoforest — ensemble size and the fraction of trees rebuilt per
    # streaming refresh (warm-started tree reuse)
    n_trees: int = 64
    refresh_trees: float = 0.25
    # spectral — retained-variance target of the principal subspace
    var_target: float = 0.98

    def __post_init__(self) -> None:
        if self.executor not in ("thread", "inline"):
            raise ValueError("executor must be 'thread' or 'inline', "
                             f"got {self.executor!r}")

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "DetectorSpec":
        _check_fields(cls, d)
        return cls(**d)


@dataclasses.dataclass
class SinkSpec:
    """One output of the session: ``kind`` is a sink-registry key
    (perfetto | jsonl | wire | report), ``path`` the destination file."""

    kind: str
    path: str = ""
    options: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "SinkSpec":
        _check_fields(cls, d)
        return cls(**d)


@dataclasses.dataclass
class MonitorSpec:
    mode: str = "off"  # off | batch | stream
    probes: List[str] = dataclasses.field(
        default_factory=lambda: list(STANDARD_PROBES))
    probe_options: Dict[str, Dict[str, Any]] = dataclasses.field(
        default_factory=dict)
    capacity: int = 1_000_000  # collector ring-buffer capacity
    detector: DetectorSpec = dataclasses.field(default_factory=DetectorSpec)
    sinks: List[SinkSpec] = dataclasses.field(default_factory=list)
    governor: bool = True  # decide() mitigation actions from detections
    # root-cause diagnosis of finalised incidents (repro_torch.diagnosis): blamed
    # fault kind + causal chain + recommended action on the MonitorReport
    diagnosis: bool = True
    # stream mode only: node -> group -> fleet aggregation tree + the
    # agent-side backpressure governor (repro_torch.fleet). None = flat
    # monitor.
    topology: Optional[TopologySpec] = None
    # request-plane service-level objectives (repro_torch.serve.slo.SLOSpec
    # or its dict form). When set and the "request" probe is attached,
    # breaches of the declared targets close as kind="slo_breach" incidents
    # — a separate plane from the GMM anomaly incidents above. None = SLOs
    # not judged.
    slo: Optional[Any] = None
    seed: int = 0

    def __post_init__(self) -> None:
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")
        if isinstance(self.detector, Mapping):
            self.detector = DetectorSpec.from_dict(self.detector)
        if isinstance(self.slo, Mapping):
            # lazy: the serve plane is an import non-serving specs (tools,
            # docs checks) should not pay for unless SLOs are used
            from repro_torch.serve.slo import SLOSpec
            self.slo = SLOSpec.from_dict(self.slo)
        if isinstance(self.topology, Mapping):
            _check_fields(TopologySpec, self.topology)
            self.topology = TopologySpec(**self.topology)
        if self.topology is not None and self.mode not in ("stream", "off"):
            raise ValueError(
                "topology is a stream-mode concept; remove the topology "
                f"section or set mode='stream' (got mode={self.mode!r})")
        self.sinks = [SinkSpec.from_dict(s) if isinstance(s, Mapping) else s
                      for s in self.sinks]

    # -- serialisation --------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "MonitorSpec":
        _check_fields(cls, d)
        return cls(**d)

    @classmethod
    def from_json(cls, text: str) -> "MonitorSpec":
        return cls.from_dict(json.loads(text))

    @classmethod
    def from_file(cls, path: str) -> "MonitorSpec":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    @classmethod
    def parse(cls, source: str) -> "MonitorSpec":
        """Inline JSON (starts with '{') or a path to a JSON file."""
        source = source.strip()
        if source.startswith("{"):
            return cls.from_json(source)
        if not os.path.exists(source):
            raise FileNotFoundError(
                f"--monitor-spec {source!r}: not inline JSON and no such "
                f"file")
        return cls.from_file(source)

    # -- CLI ------------------------------------------------------------------
    @staticmethod
    def add_cli_args(ap: argparse.ArgumentParser) -> None:
        ap.add_argument(
            "--monitor-spec", default="",
            help="monitoring session spec: inline JSON or a path to a JSON "
                 f"file (env fallback: {SPEC_ENV_VAR}). Replaces --monitor/"
                 "--stream-monitor/--stream-flush-every.")

    @classmethod
    def from_args(cls, args: argparse.Namespace,
                  env: Optional[Mapping[str, str]] = None,
                  legacy_defaults: Optional[Dict[str, Any]] = None
                  ) -> "MonitorSpec":
        """Resolve the session spec from parsed CLI args.

        Precedence: explicit ``--monitor-spec`` > ``REPRO_MONITOR_SPEC`` env
        var > deprecated per-driver flags. ``legacy_defaults`` (a partial
        spec dict) is merged in only on the legacy-flag path, letting a
        driver keep its historical probe/detector tuning without constraining
        explicit specs."""
        env = os.environ if env is None else env
        source = getattr(args, "monitor_spec", "") or env.get(SPEC_ENV_VAR, "")
        legacy_mode = ("stream" if getattr(args, "stream_monitor", False)
                       else "batch" if getattr(args, "monitor", False)
                       else "off")
        if source:
            spec = cls.parse(source)
            if legacy_mode != "off":
                warnings.warn(
                    "--monitor/--stream-monitor are ignored when "
                    "--monitor-spec is given; the spec's mode "
                    f"({spec.mode!r}) wins", UserWarning, stacklevel=2)
        else:
            d: Dict[str, Any] = dict(legacy_defaults or {})
            d["mode"] = legacy_mode
            spec = cls.from_dict(d)
            if legacy_mode != "off":
                warnings.warn(
                    "--monitor/--stream-monitor are deprecated; use "
                    f"--monitor-spec '{{\"mode\": \"{legacy_mode}\"}}' "
                    "(see README migration note)", DeprecationWarning,
                    stacklevel=2)
            flush = getattr(args, "stream_flush_every", None)
            if flush is not None:
                spec.detector.flush_every = int(flush)
            seed = getattr(args, "seed", None)
            if seed is not None:
                spec.seed = spec.detector.seed = int(seed)
        # --trace-out stays additive in both paths: it is a sink, not a mode
        trace_out = getattr(args, "trace_out", "")
        if trace_out and not any(s.kind == "perfetto" for s in spec.sinks):
            spec.sinks.append(SinkSpec(kind="perfetto", path=trace_out))
        return spec
