"""Streaming fleet monitor (port of `repro/stream/`): online windowed
detection, multi-node aggregation, and incident reports on top of the
collector/probe stack.

Public API:
    StreamMonitor     — end-to-end orchestrator (agents -> windows ->
                        online GMM -> incidents)
    NodeAgent         — per-node ring-buffer flusher (wire producer)
    FleetAggregator   — multi-node columnar sliding windows
    OnlineGMMDetector — warm-started per-window EM + drift refit, on the card
    IncidentEngine    — flag clustering / attribution / ranking
    match_incidents   — incidents scored against labelled fault windows
    wire              — columnar Event-batch serialization

The pluggable model families' window detector is
`repro_torch.stream.backends.OnlineModelDetector`; the hierarchical
node -> group -> fleet monitor is `repro_torch.fleet.HierarchicalMonitor`.
"""
from repro_torch.stream import wire  # noqa: F401
from repro_torch.stream.agent import NodeAgent  # noqa: F401
from repro_torch.stream.incidents import (Incident,  # noqa: F401
                                          IncidentEngine, IncidentMatch,
                                          match_incidents)
from repro_torch.stream.monitor import StreamMonitor  # noqa: F401
from repro_torch.stream.online import (OnlineGMMDetector,  # noqa: F401
                                       WindowDetection)
from repro_torch.stream.window import (FleetAggregator,  # noqa: F401
                                       LayerWindow)
