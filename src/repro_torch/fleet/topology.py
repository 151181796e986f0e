"""Fleet topology: the node -> group -> fleet aggregation tree (port of
`repro/fleet/topology.py`, unchanged).

A topology is declared in the ``topology`` section of a `MonitorSpec` (or
``fleet_spec.json``) and resolved here into routing + validation. The tree
has exactly two aggregation tiers — node agents fan into group aggregators,
group aggregators fan into the fleet plane — with the fan-in of each tier
capped so no single process ever merges more than ``fan_in`` children
(EROICA-style hierarchical assurance: bounded per-hop merge cost).

Group membership is static and arithmetic (``node_id // group_size``): in a
real deployment that is the rack/pod mapping; in simulation it keeps routing
O(1) with zero per-event state.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping


@dataclasses.dataclass
class TopologySpec:
    """Declarative tree + governor knobs (the ``topology`` spec section).

    ``max_events_per_flush`` > 0 arms the per-agent `BackpressureGovernor`
    with that budget ceiling; 0 disables shedding entirely (every event
    ships, the demo default).
    """

    group_size: int = 16       # nodes per group (node->group fan-in)
    fan_in: int = 32           # max children per aggregation tier
    max_events_per_flush: int = 0  # governor budget ceiling; 0 = disabled
    min_per_layer: int = 32    # stratified floor: events kept per layer
    high_water: float = 0.85   # group occupancy that triggers shedding
    decrease: float = 0.5      # multiplicative budget cut under pressure
    recover_fraction: float = 0.05  # additive budget recovery per flush

    def __post_init__(self) -> None:
        if self.group_size < 1:
            raise ValueError(f"topology.group_size must be >= 1, "
                             f"got {self.group_size}")
        if self.fan_in < 1:
            raise ValueError(f"topology.fan_in must be >= 1, "
                             f"got {self.fan_in}")
        if self.group_size > self.fan_in:
            raise ValueError(
                f"topology.group_size ({self.group_size}) exceeds the tier "
                f"fan-in cap ({self.fan_in}): a group is one aggregation "
                "hop and must respect it")
        if self.max_events_per_flush < 0:
            raise ValueError("topology.max_events_per_flush must be >= 0")
        if self.min_per_layer < 1:
            raise ValueError("topology.min_per_layer must be >= 1")
        if not 0.0 < self.high_water <= 1.0:
            raise ValueError(f"topology.high_water must be in (0, 1], "
                             f"got {self.high_water}")
        if not 0.0 < self.decrease < 1.0:
            raise ValueError(f"topology.decrease must be in (0, 1), "
                             f"got {self.decrease}")
        if not 0.0 < self.recover_fraction <= 1.0:
            raise ValueError("topology.recover_fraction must be in (0, 1]")

    @classmethod
    def parse(cls, obj: "TopologySpec | Mapping[str, Any] | None"
              ) -> "TopologySpec | None":
        if obj is None or isinstance(obj, cls):
            return obj
        return cls(**dict(obj))

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class FleetTopology:
    """Resolved routing for a concrete fleet."""

    def __init__(self, spec: TopologySpec):
        self.spec = spec

    def group_of(self, node_id: int) -> int:
        return int(node_id) // self.spec.group_size

    def n_groups(self, n_nodes: int) -> int:
        return -(-int(n_nodes) // self.spec.group_size)  # ceil div

    def check_group_count(self, n_groups: int) -> None:
        """The group -> fleet tier must also respect the fan-in cap."""
        if n_groups > self.spec.fan_in:
            raise ValueError(
                f"fleet tier fan-in exceeded: {n_groups} groups > fan_in "
                f"{self.spec.fan_in} — raise topology.group_size or fan_in")

    def shape(self, n_nodes: int) -> Dict[str, Any]:
        """Describe the tree for reports/benchmarks."""
        g = self.n_groups(n_nodes)
        tiers: List[Dict[str, Any]] = [
            {"tier": "node", "count": int(n_nodes)},
            {"tier": "group", "count": g,
             "fan_in": min(int(n_nodes), self.spec.group_size)},
            {"tier": "fleet", "count": 1, "fan_in": g},
        ]
        return {"tiers": tiers, "fan_in_cap": self.spec.fan_in,
                "group_size": self.spec.group_size}
