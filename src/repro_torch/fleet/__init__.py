"""Fleet plane (port of `repro/fleet/`). Only the topology is ported so far
(`MonitorSpec.topology` reads it); the group aggregator, the hierarchical
monitor and the backpressure governor come with the fleet slice, and a
session with a topology raises until then."""
from repro_torch.fleet.topology import FleetTopology, TopologySpec

__all__ = ["FleetTopology", "TopologySpec"]
