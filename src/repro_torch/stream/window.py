"""Per-layer sliding windows over preallocated numpy columns + the fleet
aggregator that feeds them from node batches (port of
`repro/stream/window.py`; only the imports differ).

The aggregator is the service-side state of the streaming monitor: one
`LayerWindow` per monitored layer, each a fixed-capacity columnar store with
time-horizon eviction. Ingest is vectorised end to end — a decoded wire batch
is split into per-layer masks and block-copied into the window columns; no
`Event` objects exist on the hot path.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np

from repro_torch.core.events import NAME_DT, NAME_WIDTH, Layer
from repro_torch.stream import wire

# columns every window keeps (name dtype is fixed-width so the store is flat)
_F64 = ("ts", "dur", "size") + wire.TELEMETRY_KEYS
_NAME_DT = NAME_DT


class LayerWindow:
    """Fixed-capacity sliding window of one layer's events, columnar.

    Rows live in preallocated arrays `[0, n)`; appends block-copy into the
    tail, overflow and horizon eviction compact in place. Rows are kept in
    arrival order (per-node batches are time-sorted; cross-node interleaving
    is only approximately sorted, so eviction uses a mask, not a tail
    pointer).
    """

    def __init__(self, layer: Layer, capacity: int = 65536,
                 horizon_s: float = 60.0):
        self.layer = layer
        self.capacity = int(capacity)
        self.horizon_s = float(horizon_s)
        self.n = 0
        self.evicted = 0  # rows dropped (horizon or overflow) over lifetime
        self.names_truncated = 0  # names clipped to the fixed width
        self.cols: Dict[str, np.ndarray] = {
            k: np.zeros(self.capacity, dtype=np.float64) for k in _F64}
        self.cols["step"] = np.zeros(self.capacity, dtype=np.int64)
        self.cols["node"] = np.zeros(self.capacity, dtype=np.int32)
        self.cols["name"] = np.zeros(self.capacity, dtype=_NAME_DT)

    def __len__(self) -> int:
        return self.n

    # -- mutation -------------------------------------------------------------
    def append(self, cols: Dict[str, np.ndarray], node_id: int,
               sel: Optional[np.ndarray] = None) -> int:
        """Block-copy rows from a wire-format column dict (optionally the
        subset selected by boolean mask ``sel``). Returns rows added."""

        def pick(key: str) -> np.ndarray:
            c = cols[key]
            return c[sel] if sel is not None else c

        ts = pick("ts")
        n_add = int(ts.shape[0])
        if n_add == 0:
            return 0
        if n_add > self.capacity:  # keep only the newest capacity rows
            self.evicted += n_add - self.capacity
            keep = np.argsort(ts, kind="stable")[n_add - self.capacity:]
            sel = keep if sel is None else np.flatnonzero(sel)[keep]
            ts = cols["ts"][sel]
            n_add = self.capacity
        if self.n + n_add > self.capacity:
            self._make_room(self.n + n_add - self.capacity)
        lo, hi = self.n, self.n + n_add
        for k in _F64:
            self.cols[k][lo:hi] = pick(k)
        self.cols["step"][lo:hi] = pick("step")
        incoming = pick("name")
        if incoming.dtype.itemsize > 4 * NAME_WIDTH:
            # assignment into the fixed-width store clips: count, don't hide
            self.names_truncated += int(
                (np.char.str_len(incoming) > NAME_WIDTH).sum())
        self.cols["name"][lo:hi] = incoming
        self.cols["node"][lo:hi] = node_id
        self.n = hi
        return n_add

    def _make_room(self, n_drop: int) -> None:
        """Drop the n_drop oldest rows (by ts) via in-place compaction."""
        order = np.argsort(self.cols["ts"][:self.n], kind="stable")
        keep = np.sort(order[n_drop:])
        self._compact(keep)
        self.evicted += n_drop

    def evict_older_than(self, cutoff_ts: float) -> int:
        """Horizon eviction: drop rows with ts < cutoff. Returns rows
        dropped."""
        if self.n == 0:
            return 0
        keep = np.flatnonzero(self.cols["ts"][:self.n] >= cutoff_ts)
        dropped = self.n - keep.shape[0]
        if dropped:
            self._compact(keep)
            self.evicted += dropped
        return dropped

    def _compact(self, keep: np.ndarray) -> None:
        for k, col in self.cols.items():
            col[:keep.shape[0]] = col[keep]
        self.n = int(keep.shape[0])

    # -- views ----------------------------------------------------------------
    def view(self) -> Dict[str, np.ndarray]:
        """Zero-copy views of the live rows (invalidated by mutation)."""
        return {k: col[:self.n] for k, col in self.cols.items()}

    def freeze(self) -> "SnapshotWindow":
        """Owned copy of the live rows, safe to read from another thread
        while this window keeps mutating. The async detection plane hands
        these to the executor — a zero-copy ``view()`` would tear the moment
        ingest compacts or appends under it.

        ``n`` is read once: `append` publishes new rows before bumping
        ``n``, so a single read yields a consistent prefix even if an append
        races this copy (compaction still requires freeze and ingest to
        share a thread, which the session's step loop guarantees)."""
        n = self.n
        return SnapshotWindow(self.layer,
                              {k: col[:n].copy()
                               for k, col in self.cols.items()})

    @property
    def t_newest(self) -> float:
        return float(self.cols["ts"][:self.n].max()) if self.n else 0.0


class SnapshotWindow:
    """Immutable point-in-time copy of a LayerWindow (duck-compatible with
    the read surface the detector uses: layer / __len__ / view())."""

    __slots__ = ("layer", "cols", "n")

    def __init__(self, layer: Layer, cols: Dict[str, np.ndarray]):
        self.layer = layer
        self.cols = cols
        self.n = int(cols["ts"].shape[0]) if cols else 0

    def __len__(self) -> int:
        return self.n

    def view(self) -> Dict[str, np.ndarray]:
        return self.cols

    @property
    def t_newest(self) -> float:
        return float(self.cols["ts"].max()) if self.n else 0.0


class FleetAggregator:
    """Merges wire batches from N nodes into per-layer sliding windows."""

    LAYERS = tuple(Layer)
    MISSING_SEQ_CAP = 512  # outstanding seq gaps remembered per node

    def __init__(self, capacity_per_layer: int = 65536,
                 horizon_s: float = 60.0):
        self.horizon_s = float(horizon_s)
        self.windows: Dict[Layer, LayerWindow] = {
            layer: LayerWindow(layer, capacity_per_layer, horizon_s)
            for layer in self.LAYERS}
        self.nodes_seen: Dict[int, int] = {}  # node_id -> newest seq seen
        # seq gaps counted into lost_batches that a late delivery may still
        # fill (bounded per node; overflow stays counted as lost)
        self._missing_seqs: Dict[int, set] = {}
        self.lost_batches = 0
        self.events_ingested = 0
        self.events_dropped_at_source = 0
        self.events_shed_at_source = 0
        self.t_latest = 0.0
        # node_id -> fleet-clock ts of the node's newest ingested event.
        # Freshness = t_latest - node_last_ts[n]: event-time, so a node
        # whose agent stops flushing goes stale as soon as the REST of the
        # fleet advances the clock past it (no wall-clock dependency).
        self.node_last_ts: Dict[int, float] = {}

    def ingest(self, batch: Union[bytes, wire.EventBatch]) -> int:
        """Merge one node flush; returns events added across layers."""
        if isinstance(batch, (bytes, bytearray, memoryview)):
            batch = wire.decode(bytes(batch))
        nid = batch.node_id
        last = self.nodes_seen.get(nid)
        if last is None or batch.seq == last + 1:
            self.nodes_seen[nid] = batch.seq
        elif batch.seq > last + 1:
            # gap: count it lost, but remember WHICH seqs are outstanding so
            # an out-of-order late delivery uncounts itself instead of
            # flipping a healthy node's accounting
            missing = self._missing_seqs.setdefault(nid, set())
            missing.update(range(last + 1, batch.seq))
            self.lost_batches += batch.seq - last - 1
            while len(missing) > self.MISSING_SEQ_CAP:
                missing.discard(min(missing))  # oldest gaps stay counted
            self.nodes_seen[nid] = batch.seq
        else:
            # late or duplicate arrival: seq <= newest seen. A late batch
            # that fills a counted gap is a delivery, not a loss.
            missing = self._missing_seqs.get(nid)
            if missing and batch.seq in missing:
                missing.discard(batch.seq)
                self.lost_batches -= 1
        self.events_dropped_at_source += batch.dropped
        self.events_shed_at_source += batch.shed
        cols = batch.columns
        n = int(cols["ts"].shape[0])
        if n == 0:
            return 0
        layer_codes = cols["layer"]
        added = 0
        for code, layer in enumerate(self.LAYERS):
            sel = layer_codes == np.int8(code)
            if not sel.any():
                continue
            added += self.windows[layer].append(cols, batch.node_id, sel=sel)
        self.events_ingested += added
        t_max = float(cols["ts"].max())
        self.t_latest = max(self.t_latest, t_max)
        self.node_last_ts[batch.node_id] = max(
            self.node_last_ts.get(batch.node_id, -np.inf), t_max)
        return added

    def evict(self, now: Optional[float] = None) -> int:
        """Advance the horizon on every window; returns rows dropped."""
        cutoff = (self.t_latest if now is None else now) - self.horizon_s
        return sum(w.evict_older_than(cutoff) for w in self.windows.values())

    def window(self, layer: Layer) -> LayerWindow:
        return self.windows[layer]

    def freeze(self) -> "AggSnapshot":
        """Owned point-in-time copy of every layer window + the clock/
        membership facts detection publishing needs (duck-compatible with
        the aggregator surface `OnlineGMMDetector` reads). Taken on the
        ingest thread; read on the detection executor's worker."""
        return AggSnapshot(
            windows={layer: w.freeze() for layer, w in self.windows.items()},
            t_latest=self.t_latest,
            nodes_seen=dict(self.nodes_seen),
            node_last_ts=dict(self.node_last_ts))

    def stats(self) -> Dict[str, object]:
        return {
            "nodes": len(self.nodes_seen),
            "events_ingested": self.events_ingested,
            "events_dropped_at_source": self.events_dropped_at_source,
            "events_shed_at_source": self.events_shed_at_source,
            "lost_batches": self.lost_batches,
            # names clipped to the fixed column width on ingest — nonzero
            # means kernel names in traces/reports are prefixes
            "names_truncated": sum(w.names_truncated
                                   for w in self.windows.values()),
            "window_sizes": {l.value: len(w) for l, w in self.windows.items()
                             if len(w)},
            "t_latest": self.t_latest,
        }


class AggSnapshot:
    """Frozen FleetAggregator read surface for off-thread detection."""

    __slots__ = ("windows", "t_latest", "nodes_seen", "node_last_ts")

    def __init__(self, windows: Dict[Layer, SnapshotWindow], t_latest: float,
                 nodes_seen: Dict[int, int], node_last_ts: Dict[int, float]):
        self.windows = windows
        self.t_latest = t_latest
        self.nodes_seen = nodes_seen
        self.node_last_ts = node_last_ts

    def window(self, layer: Layer) -> SnapshotWindow:
        return self.windows[layer]
