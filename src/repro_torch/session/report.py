"""MonitorReport: the unified result of a monitoring session (port of
`repro/session/report.py`; only the imports differ).

Batch detections (`DetectionResult`) and streaming window detections
(`WindowDetection`) share flags/scores/log_delta/steps; the report normalises
them into per-layer summaries and carries the incidents — formed by the
streaming engine mid-run, or by the batch final sweep — plus their
root-cause diagnoses (`repro_torch.diagnosis`) alongside, so callers read one
shape regardless of the spec's mode.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.core.events import Layer
from repro_torch.stream.incidents import Incident


@dataclasses.dataclass
class LayerSummary:
    layer: str
    events: int
    anomaly_rate: float
    anomalous_steps: List[int]
    log_delta: float
    # collector-clock timestamp (s) of this layer's earliest flagged event;
    # None when nothing flagged. The evaluation harness reads this (plus the
    # raw detections) to compute time-to-detect.
    first_flag_ts: Optional[float] = None


@dataclasses.dataclass
class MonitorReport:
    mode: str
    layers: Dict[str, LayerSummary]
    incidents: List[Incident]
    overhead: Dict[str, Any]
    sink_outputs: Dict[str, str]
    # raw per-layer detection objects (DetectionResult | WindowDetection)
    detections: Dict[Layer, Any] = dataclasses.field(default_factory=dict,
                                                     repr=False)
    # root-cause diagnoses of the incidents above (repro_torch.diagnosis), in the
    # incidents' severity order
    diagnoses: List[Any] = dataclasses.field(default_factory=list)

    @classmethod
    def build(cls, mode: str, detections: Dict[Layer, Any],
              incidents: List[Incident], overhead: Dict[str, Any],
              sink_outputs: Dict[str, str],
              diagnoses: Any = ()) -> "MonitorReport":
        layers = {}
        for layer, det in detections.items():
            # both DetectionResult and WindowDetection carry per-event ts
            ts = getattr(det, "ts", None)
            first_ts = (float(ts[det.flags].min())
                        if ts is not None and det.flags.any() else None)
            layers[layer.value] = LayerSummary(
                layer=layer.value,
                events=int(len(det.flags)),
                anomaly_rate=float(det.anomaly_rate),
                anomalous_steps=[int(s) for s in det.anomalous_steps()],
                log_delta=float(det.log_delta),
                first_flag_ts=first_ts)
        return cls(mode=mode, layers=layers, incidents=list(incidents),
                   overhead=overhead, sink_outputs=sink_outputs,
                   detections=dict(detections), diagnoses=list(diagnoses))

    def anomalous_steps(self) -> List[int]:
        steps = sorted({s for ls in self.layers.values()
                        for s in ls.anomalous_steps})
        return steps

    def to_json(self) -> Dict[str, Any]:
        return {
            "mode": self.mode,
            "layers": {k: dataclasses.asdict(v)
                       for k, v in self.layers.items()},
            "incidents": [i.to_json() for i in self.incidents],
            "diagnoses": [d.to_json() for d in self.diagnoses],
            "anomalous_steps": self.anomalous_steps(),
            "overhead": self.overhead,
            "sink_outputs": self.sink_outputs,
        }

    def save(self, path: str) -> str:
        from repro_torch.session.sinks import atomic_write

        return atomic_write(path, json.dumps(self.to_json(), indent=1))

    def collection_losses(self) -> Dict[str, int]:
        """Events lost/degraded by the monitor itself, aggregated over
        nodes: ring overwrites (``dropped``), backpressure-governor
        sampling (``shed``), and clipped event names (``names_truncated``).
        Batch overhead carries them per node (`overhead_stats`), stream
        overhead additionally under the ``"stream"`` key
        (`StreamMonitor.stats` / `HierarchicalMonitor.stats`) — this reads
        both shapes so the report surfaces collection loss in every mode."""
        totals = {"dropped": 0, "shed": 0, "names_truncated": 0}
        for key, stats in self.overhead.items():
            if not isinstance(stats, dict):
                continue
            if key == "stream":
                # ring-level loss is already counted via the per-node
                # entries; the stream entry contributes the aggregator's
                # *window-level* name clipping plus the agents' governor
                # shedding (a stream-only mechanism)
                agg = stats.get("aggregator", {})
                if isinstance(agg, dict):
                    totals["names_truncated"] += int(
                        agg.get("names_truncated", 0))
                totals["shed"] += int(stats.get("events_shed", 0))
            else:
                totals["dropped"] += int(stats.get("dropped", 0))
                totals["names_truncated"] += int(
                    stats.get("names_truncated", 0))
        return totals

    def render(self) -> str:
        if self.mode == "off":
            return "monitoring off"
        lines = [f"monitor report ({self.mode} mode):"]
        for name, ls in sorted(self.layers.items()):
            steps = ls.anomalous_steps
            tail = (f" steps={steps[0]}..{steps[-1]}({len(steps)})"
                    if steps else "")
            lines.append(f"  {name:<10} {ls.events:6d} events  "
                         f"anomaly_rate={ls.anomaly_rate:.3f}{tail}")
        if self.incidents:
            ranked = sorted(self.incidents, key=lambda i: -i.severity)
            lines.append(f"  {len(ranked)} incident(s), ranked:")
            lines += ["  " + i.render() for i in ranked]
        else:
            lines.append("  no incidents")
        if self.diagnoses:
            lines.append(f"  {len(self.diagnoses)} diagnosis(es):")
            lines += ["  " + d.render() for d in self.diagnoses]
        losses = self.collection_losses()
        if any(losses.values()):
            lines.append(
                f"  collection loss: {losses['dropped']} ring-dropped "
                f"event(s), {losses['shed']} governor-shed event(s), "
                f"{losses['names_truncated']} name(s) truncated")
        for kind, path in self.sink_outputs.items():
            lines.append(f"  sink {kind} -> {path}")
        return "\n".join(lines)
