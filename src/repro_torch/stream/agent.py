"""Per-node agent: periodically flushes a Collector's event table onto the
wire (port of `repro/stream/agent.py`; only the imports differ).

The agent is the node-resident half of the fleet monitor. It owns nothing but
a reference to the node's `Collector` (the eACGM daemon) and a flush counter;
each `flush()` drains the columnar event table, rebases timestamps onto the
fleet epoch, and returns a wire-encoded `EventBatch` — columns in, columns
out, zero `Event` objects. Dropped-event counts are carried per batch so the
aggregator can account for ring overruns (paper: bounded-memory perf
buffers) without trusting the stream to be complete.

At fleet scale the agent optionally runs a `BackpressureGovernor`
(`repro_torch.fleet.governor`) on the agent→group path: when the group
tier signals pressure, the governor sheds load by stratified per-layer
sampling BEFORE encoding — never starving a layer, and stamping the shed
count into the batch header so the loss is accounted fleet-wide, not
silent.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np

from repro_torch.core.collector import Collector
from repro_torch.stream import wire


class NodeAgent:
    """Drains one node's collector into wire-format batches.

    ``ts_offset`` rebases node-local event timestamps (seconds since the
    collector's t0) onto a shared fleet clock; in a real deployment this is
    the node's NTP-disciplined epoch offset, in simulation it aligns the
    per-node monotonic clocks.

    ``governor`` (optional) is a
    `repro_torch.fleet.governor.BackpressureGovernor` (or anything with its
    ``admit(cols) -> (cols, shed_by_layer)`` and ``budget``), applied to
    every flush;
    ``wire_version`` selects the wire encoding (defaults to `wire.VERSION`,
    the compressed v3 format).
    """

    def __init__(self, node_id: int, collector: Collector,
                 ts_offset: float = 0.0, governor=None,
                 wire_version: Optional[int] = None):
        self.node_id = node_id
        self.collector = collector
        self.ts_offset = ts_offset
        self.governor = governor
        self.wire_version = (wire.VERSION if wire_version is None
                             else int(wire_version))
        self.seq = 0
        self.events_shipped = 0
        self.events_shed = 0  # sampled out by the governor, pre-encode
        self.bytes_shipped = 0
        self.encode_seconds = 0.0  # cumulative wire-encode wall time
        self._last_dropped = 0

    def flush(self) -> bytes:
        """Drain the event table and return one wire-encoded batch.

        Columnar end to end: the drained `EventTable` views ARE the wire
        columns — no `Event` objects are materialised."""
        cols = self.collector.drain_columns()
        if self.ts_offset and cols["ts"].shape[0]:
            cols["ts"] = cols["ts"] + self.ts_offset
        shed = 0
        if self.governor is not None and cols["ts"].shape[0]:
            cols, shed_by_layer = self.governor.admit(cols)
            shed = int(sum(shed_by_layer.values()))
            self.events_shed += shed
        total_dropped = self.collector.buffer.dropped
        batch = wire.EventBatch(
            node_id=self.node_id, seq=self.seq, t_base=self.ts_offset,
            columns=cols, dropped=total_dropped - self._last_dropped,
            shed=shed)
        self._last_dropped = total_dropped
        self.seq += 1
        t0 = time.perf_counter()
        buf = wire.encode(batch, version=self.wire_version)
        self.encode_seconds += time.perf_counter() - t0
        self.events_shipped += len(batch)
        self.bytes_shipped += len(buf)
        return buf

    def stats(self) -> dict:
        return {"node_id": self.node_id, "flushes": self.seq,
                "events_shipped": self.events_shipped,
                "events_shed": self.events_shed,
                "bytes_shipped": self.bytes_shipped,
                "encode_seconds": self.encode_seconds,
                "dropped_total": self._last_dropped,
                "wire_version": self.wire_version,
                "governor_budget": (self.governor.budget
                                    if self.governor is not None else None),
                # ring-level accounting straight from the collector: the
                # monitor's own loss/degradation is part of agent health
                "ring_dropped": self.collector.buffer.dropped,
                "names_truncated": self.collector.buffer.names_truncated}
