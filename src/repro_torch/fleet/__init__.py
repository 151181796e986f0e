"""Hierarchical fleet plane (port of `repro/fleet/`): scale the streaming
monitor past one process.

The flat `StreamMonitor` pipes every node agent into ONE `FleetAggregator`
— fine for a 4-node demo, hopeless at O(1000) nodes (a single window store,
a single detector, and a wire bill of ~125 B/event). This package adds the
missing tier:

    node Collector --NodeAgent(+ BackpressureGovernor)--> wire v3 bytes
        --GroupAggregator.ingest()--> per-GROUP sliding windows + detector
        --HierarchicalMonitor--> fleet-level incident merge (cross-group
          dedup by layer + overlapping window, per-node attribution kept)

* `TopologySpec` / `FleetTopology` — the node -> group -> fleet tree
  (fan-in capped per tier), configured via the ``topology`` section of a
  `MonitorSpec`.
* `BackpressureGovernor` — adaptive AIMD budget on the agent->group path;
  sheds load by stratified per-layer sampling (never starves a layer) and
  accounts every shed event in the batch header.
* `GroupAggregator` — one group's aggregation + online detection tier, its
  GMM on the monitor's ``device``.
* `HierarchicalMonitor` — drop-in replacement for `StreamMonitor` (same
  driver surface) that routes agents into groups and merges group
  detections into one fleet incident stream.
"""
from repro_torch.fleet.governor import BackpressureGovernor
from repro_torch.fleet.group import GroupAggregator
from repro_torch.fleet.plane import FleetView, HierarchicalMonitor
from repro_torch.fleet.topology import FleetTopology, TopologySpec

__all__ = ["BackpressureGovernor", "FleetTopology", "FleetView",
           "GroupAggregator", "HierarchicalMonitor", "TopologySpec"]
