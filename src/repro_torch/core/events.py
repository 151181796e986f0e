"""Event model: columnar event table (native), typed trace events (compat),
ring buffer shim, Perfetto export.

The eACGM event record mirrors the paper's schema: every probe emits
(layer, name, timestamp, duration, size, pid/tid, telemetry). Since the
columnar redesign the *native* representation is `EventTable` — a
preallocated struct-of-arrays ring sharing the wire schema, so a record
travels from probe emission through the wire to feature extraction without
ever being materialised as a Python object. `Event` and `RingBuffer` remain
as the compat shim for third-party probes and for tests/tools that want
object-per-event ergonomics.
"""
from __future__ import annotations

import dataclasses
import enum
import json
import math
import os
import threading
import time
from typing import Any, Dict, Iterable, Iterator, List, Optional, Union

import numpy as np


class Layer(str, enum.Enum):
    """Monitored stack layers (paper Fig. 1). XLA≈CUDA, OPERATOR≈Torch,
    COLLECTIVE≈NCCL, DEVICE≈libnvml GPU metrics."""

    XLA = "xla"
    PYTHON = "python"
    OPERATOR = "operator"
    COLLECTIVE = "collective"
    DEVICE = "device"
    STEP = "step"
    REQUEST = "request"  # serve plane: per-request lifecycle records


# Layer enum <-> wire code (int8). Order is the Layer declaration order and
# must stay append-only for cross-version compatibility.
LAYERS = tuple(Layer)
LAYER_CODE: Dict[Layer, np.int8] = {l: np.int8(i) for i, l in enumerate(LAYERS)}

# meta keys promoted to dedicated columns (device telemetry hot path)
TELEMETRY_KEYS = ("util", "mem_gb", "power_w", "temp_c")

# fixed-width unicode event names: flat storage on the wire and in the
# sliding windows. Longer names are clipped — counted, never silent (see
# EventTable.names_truncated / LayerWindow.names_truncated).
NAME_WIDTH = 64
NAME_DT = np.dtype(f"<U{NAME_WIDTH}")

# The shared column schema from probe emission to detection ("ColumnView"):
# every producer (EventTable.drain_columns, wire.decode, LayerWindow.view)
# yields a plain dict of same-length 1-D arrays with these dtypes. The
# ``meta`` column holds residual metadata as compact JSON strings (almost
# always empty); EventTable stores it as object dtype, the wire ships it as
# fixed-width unicode.
COLUMN_SCHEMA: Dict[str, np.dtype] = {
    "layer": np.dtype(np.int8),
    "name": NAME_DT,
    "ts": np.dtype(np.float64),
    "dur": np.dtype(np.float64),
    "size": np.dtype(np.float64),
    "pid": np.dtype(np.int64),
    "tid": np.dtype(np.int64),
    "step": np.dtype(np.int64),
    **{k: np.dtype(np.float64) for k in TELEMETRY_KEYS},
}


@dataclasses.dataclass
class Event:
    layer: Layer
    name: str
    ts: float  # seconds (monotonic epoch of the collector)
    dur: float = 0.0  # seconds
    size: float = 0.0  # bytes (messages/allocs) or generic magnitude
    pid: int = 0
    tid: int = 0
    step: int = -1
    meta: Optional[Dict[str, Any]] = None

    def to_json(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["layer"] = self.layer.value
        return d


# ---------------------------------------------------------------------------
# EventTable: the native columnar event store
# ---------------------------------------------------------------------------

_NAN = float("nan")


class EventTable:
    """Preallocated struct-of-arrays event ring — the columnar RingBuffer.

    Appends are *row blocks*: a probe hands over equal-length (or scalar,
    broadcast) column values and the table block-copies them into the ring
    under one lock. Overflow overwrites the oldest rows, exactly like the
    BPF perf ring buffers the paper reads from. ``drain_columns`` returns
    zero-copy views of the live region (one concatenation when the ring has
    wrapped); the views stay intact for the next ``capacity - n`` appended
    rows (appends only write ahead of the drained region), and low-headroom
    drains return lock-scoped copies instead — the same bounded-validity
    contract a drained perf buffer gives.

    Locked regions contain no Python-level call/return (only C-level slice
    assignment): a Python frame finishing inside the lock fires the python
    probe's profile hook, whose emit -> append re-enters this non-reentrant
    lock on the same thread (see RingBuffer's matching note).
    """

    def __init__(self, capacity: int = 1_000_000):
        self.capacity = max(1, int(capacity))
        self.cols: Dict[str, np.ndarray] = {
            k: np.zeros(self.capacity, dtype=dt)
            for k, dt in COLUMN_SCHEMA.items()}
        for k in TELEMETRY_KEYS:
            self.cols[k].fill(_NAN)
        self.cols["meta"] = np.full(self.capacity, "", dtype=object)
        self._col_keys = list(self.cols)  # plain list: lock-safe iteration
        self._head = 0
        self._count = 0
        self._dropped = 0
        self._pushed = 0
        self.names_truncated = 0  # names clipped to NAME_WIDTH over lifetime
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return self._count

    @property
    def dropped(self) -> int:
        return self._dropped

    @property
    def pushed(self) -> int:
        """Lifetime row count — survives drain() (streaming agents drain
        the buffer continuously, so len() is not a throughput stat)."""
        return self._pushed

    # -- append ---------------------------------------------------------------

    def append_rows(self, layer: Union[Layer, int], name, ts, dur=0.0,
                    size=0.0, pid=0, tid=0, step=-1, util=_NAN, mem_gb=_NAN,
                    power_w=_NAN, temp_c=_NAN, meta="") -> int:
        """Block-append a batch of rows (arrays) or one row (scalars).

        ``layer`` is one Layer (or its int8 code) for the whole block; every
        other argument is a scalar (filled across the block) or an
        (n,)-array. Returns the number of rows appended."""
        code = LAYER_CODE[layer] if isinstance(layer, Layer) else int(layer)
        trunc = 0
        scalar_name_clipped = False
        if type(name) is str:  # scalar-row fast path candidate
            n = None
            scalar_name_clipped = len(name) > NAME_WIDTH
        else:
            name = np.asarray(name)
            if name.ndim == 0:
                name = str(name)
                n = None
                scalar_name_clipped = len(name) > NAME_WIDTH
            else:
                if name.dtype.kind != "U":  # object/bytes arrays
                    name = name.astype(str)
                n = int(name.shape[0])
                if name.dtype.itemsize > 4 * NAME_WIDTH:
                    trunc = int((np.char.str_len(name) > NAME_WIDTH).sum())
        # Normalise values: python/numpy scalars pass through (slice-filled
        # under the lock); arrays must match the block length. Everything
        # happens OUT of the lock (see class note).
        blocks: Dict[str, Any] = {"layer": code, "name": name}
        for k, v in (("ts", ts), ("dur", dur), ("size", size), ("pid", pid),
                     ("tid", tid), ("step", step), ("util", util),
                     ("mem_gb", mem_gb), ("power_w", power_w),
                     ("temp_c", temp_c)):
            ty = type(v)
            if ty is float or ty is int:
                blocks[k] = v
                continue
            a = np.asarray(v, COLUMN_SCHEMA[k])
            if a.ndim == 0:
                blocks[k] = a[()]
            else:
                if n is None:
                    n = int(a.shape[0])
                elif a.shape[0] != n:
                    raise ValueError(
                        f"append_rows column {k!r} has length {a.shape[0]}, "
                        f"expected {n}")
                blocks[k] = a
        if isinstance(meta, np.ndarray) and meta.ndim:
            if n is None:
                n = int(meta.shape[0])
            elif meta.shape[0] != n:
                raise ValueError(
                    f"append_rows column 'meta' has length {meta.shape[0]}, "
                    f"expected {n}")
            blocks["meta"] = meta
        else:
            blocks["meta"] = str(meta)
        cap = self.capacity
        cols = self.cols
        if n is None:  # all scalars: one row, item assignment only
            with self._lock:
                head = self._head
                for k, v in blocks.items():
                    cols[k][head] = v
                self._head = head + 1 if head + 1 < cap else 0
                if self._count == cap:
                    self._dropped += 1
                else:
                    self._count += 1
                self._pushed += 1
                self.names_truncated += 1 if scalar_name_clipped else trunc
            return 1
        if n == 0:
            return 0
        if scalar_name_clipped:  # clipped scalar fills the whole block
            trunc = n
        if n > cap:  # keep only the newest capacity rows
            for k, blk in blocks.items():
                if isinstance(blk, np.ndarray):
                    blocks[k] = blk[n - cap:]
            extra = n - cap
            n = cap
        else:
            extra = 0
        with self._lock:
            head = self._head
            first = cap - head if head + n > cap else n
            if first < n:
                for k, blk in blocks.items():
                    if isinstance(blk, np.ndarray):
                        cols[k][head:] = blk[:first]
                        cols[k][: n - first] = blk[first:]
                    else:
                        cols[k][head:] = blk
                        cols[k][: n - first] = blk
            else:
                for k, blk in blocks.items():
                    cols[k][head:head + n] = blk
            self._head = (head + n) % cap
            overwritten = self._count + n - cap
            self._dropped += extra + (overwritten if overwritten > 0 else 0)
            self._count = self._count + n if self._count + n < cap else cap
            self._pushed += n + extra
            self.names_truncated += trunc
        return n + extra

    def push(self, ev: Event) -> None:
        """Scalar Event adapter (compat: third-party probes, tests). Lifts
        device telemetry out of ``meta`` into the dedicated columns and
        JSON-encodes any residual meta."""
        meta = ev.meta or {}
        telemetry = {k: float(meta[k]) for k in TELEMETRY_KEYS if k in meta}
        residual = {k: v for k, v in meta.items() if k not in TELEMETRY_KEYS}
        self.append_rows(
            ev.layer, ev.name, ev.ts, dur=ev.dur, size=ev.size, pid=ev.pid,
            tid=ev.tid, step=ev.step,
            meta=(json.dumps(residual, separators=(",", ":"), default=str)
                  if residual else ""),
            **{k: telemetry.get(k, _NAN) for k in TELEMETRY_KEYS})

    # -- read -----------------------------------------------------------------

    # Reads are safe against concurrent appends because appends only write
    # AHEAD of the live region: a view/copy of [start, start+n) stays intact
    # for the next (capacity - n) appended rows. When that headroom is
    # smaller than _COPY_HEADROOM (e.g. a full ring, where the very next
    # append overwrites the oldest row), the read copies the region INSIDE
    # the lock instead — C-level slice/copy/concatenate only, per the class
    # deadlock note.
    _COPY_HEADROOM = 4096

    def _read(self, reset: bool) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        cap = self.capacity
        with self._lock:
            n, head = self._count, self._head
            if reset:
                self._count = 0
            start = (head - n) % cap
            if cap - n < self._COPY_HEADROOM:
                # low headroom: copy under the lock (no Python-level calls:
                # plain loop + C-level ndarray methods — see class note)
                for k in self._col_keys:
                    c = self.cols[k]
                    if start + n <= cap:
                        out[k] = c[start:start + n].copy()
                    else:
                        out[k] = np.concatenate((c[start:],
                                                 c[:start + n - cap]))
                return out
        if start + n <= cap:
            return {k: c[start:start + n] for k, c in self.cols.items()}
        return {k: np.concatenate((c[start:], c[:start + n - cap]))
                for k, c in self.cols.items()}

    def drain_columns(self) -> Dict[str, np.ndarray]:
        """Remove and return all rows, oldest first, as a ColumnView.

        Zero-copy in the steady state: the returned arrays are views into
        the ring, intact until (capacity - n) further rows are appended —
        consume (encode / featurise) before then. Low-headroom drains (a
        near-full ring, where concurrent appends would overwrite the region
        immediately) return lock-scoped copies instead."""
        return self._read(reset=True)

    def snapshot_columns(self) -> Dict[str, np.ndarray]:
        """Copy of the live rows, oldest first (stable under later appends —
        snapshots outlive arbitrary amounts of subsequent traffic)."""
        return self._owned(self._read(reset=False))

    # -- Event-object compat --------------------------------------------------

    @staticmethod
    def _owned(cols: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Promote ring views to owned copies: the slow per-row Event
        materialisation below must not race live emission into the ring
        (e.g. the python probe firing on the materialisation loop itself)."""
        return {k: (v if v.base is None else v.copy())
                for k, v in cols.items()}

    def drain(self) -> List[Event]:
        """Compat shim: drain and materialise `Event` objects."""
        return columns_to_events(self._owned(self.drain_columns()))

    def snapshot(self) -> List[Event]:
        return columns_to_events(self._owned(self._read(reset=False)))


class RingBuffer:
    """Bounded Event-object buffer; overwrites oldest (like a BPF ring
    buffer). Compat shim: the collectors now run on `EventTable`; this class
    remains for third-party probes and object-per-event tooling."""

    def __init__(self, capacity: int = 1_000_000):
        self.capacity = max(1, int(capacity))  # capacity 0 would div-by-zero
        self._buf: List[Optional[Event]] = [None] * self.capacity
        self._head = 0
        self._count = 0
        self._dropped = 0
        self._pushed = 0
        self._lock = threading.Lock()

    def push(self, ev: Event) -> None:
        with self._lock:
            if self._count == self.capacity:
                self._dropped += 1
            self._buf[self._head] = ev
            self._head = (self._head + 1) % self.capacity
            self._count = min(self._count + 1, self.capacity)
            self._pushed += 1

    def __len__(self) -> int:
        return self._count

    @property
    def dropped(self) -> int:
        return self._dropped

    @property
    def pushed(self) -> int:
        """Lifetime event count — survives drain() (streaming agents drain
        the buffer continuously, so len() is not a throughput stat)."""
        return self._pushed

    # NOTE: the locked regions of drain/snapshot must contain no Python-level
    # call/return (only C-level slicing): a Python frame finishing inside the
    # lock fires the python probe's profile hook, whose emit() -> push()
    # re-enters this non-reentrant lock on the same thread — a deadlock
    # whenever the buffer is read while that probe is attached.

    def drain(self) -> List[Event]:
        """Remove and return all events, oldest first."""
        with self._lock:
            n, head = self._count, self._head
            start = (head - n) % self.capacity
            if start + n <= self.capacity:
                out = self._buf[start:start + n]
            else:
                out = self._buf[start:] + self._buf[:(start + n)
                                                    % self.capacity]
            self._count = 0
        return [e for e in out if e is not None]

    def snapshot(self) -> List[Event]:
        with self._lock:
            n, head = self._count, self._head
            start = (head - n) % self.capacity
            if start + n <= self.capacity:
                out = self._buf[start:start + n]
            else:
                out = self._buf[start:] + self._buf[:(start + n)
                                                    % self.capacity]
        return [e for e in out if e is not None]


# ---------------------------------------------------------------------------
# Event list <-> column dict conversion (the compat boundary)
# ---------------------------------------------------------------------------


def empty_columns() -> Dict[str, np.ndarray]:
    """(0,)-shaped ColumnView with the canonical dtypes."""
    cols = {k: np.empty(0, dtype=dt) for k, dt in COLUMN_SCHEMA.items()}
    cols["meta"] = np.empty(0, dtype="<U1")
    return cols


def events_to_columns(events: List[Event]) -> Dict[str, np.ndarray]:
    """Columnarise an Event list: int8 layer codes, lifted telemetry columns,
    residual meta as a compact-JSON string column."""
    if not events:
        return empty_columns()
    cols: Dict[str, np.ndarray] = {
        "layer": np.array([LAYER_CODE[e.layer] for e in events],
                          dtype=np.int8),
        "name": np.array([e.name for e in events]),
        "ts": np.array([e.ts for e in events], dtype=np.float64),
        "dur": np.array([e.dur for e in events], dtype=np.float64),
        "size": np.array([e.size for e in events], dtype=np.float64),
        "pid": np.array([e.pid for e in events], dtype=np.int64),
        "tid": np.array([e.tid for e in events], dtype=np.int64),
        "step": np.array([e.step for e in events], dtype=np.int64),
    }
    for k in TELEMETRY_KEYS:
        cols[k] = np.array(
            [float((e.meta or {}).get(k, _NAN)) for e in events],
            dtype=np.float64)
    residual: List[str] = []
    for e in events:
        extra = {k: v for k, v in (e.meta or {}).items()
                 if k not in TELEMETRY_KEYS}
        residual.append(json.dumps(extra, separators=(",", ":"),
                                   default=str) if extra else "")
    cols["meta"] = np.array(residual)
    return cols


def columns_to_events(cols: Dict[str, np.ndarray]) -> List[Event]:
    """Inverse of events_to_columns (compat: tests, sinks, trace export)."""
    out: List[Event] = []
    n = int(cols["ts"].shape[0])
    meta_col = cols.get("meta")
    for i in range(n):
        meta: Optional[Dict[str, Any]] = None
        telemetry = {k: float(cols[k][i]) for k in TELEMETRY_KEYS
                     if not math.isnan(cols[k][i])}
        if telemetry:
            meta = telemetry
        raw = str(meta_col[i]) if meta_col is not None else ""
        if raw:
            meta = dict(meta or {}, **json.loads(raw))
        out.append(Event(
            layer=LAYERS[int(cols["layer"][i])],
            name=str(cols["name"][i]),
            ts=float(cols["ts"][i]),
            dur=float(cols["dur"][i]),
            size=float(cols["size"][i]),
            pid=int(cols["pid"][i]),
            tid=int(cols["tid"][i]),
            step=int(cols["step"][i]),
            meta=meta,
        ))
    return out


def select_columns(cols: Dict[str, np.ndarray],
                   mask: np.ndarray) -> Dict[str, np.ndarray]:
    """Row-subset a ColumnView by boolean mask (or index array)."""
    return {k: v[mask] for k, v in cols.items()}


def concat_columns(parts: List[Dict[str, np.ndarray]]
                   ) -> Dict[str, np.ndarray]:
    """Concatenate ColumnViews row-wise (multi-node merges)."""
    parts = [p for p in parts if int(p["ts"].shape[0])]
    if not parts:
        return empty_columns()
    if len(parts) == 1:
        return dict(parts[0])
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


# ---------------------------------------------------------------------------
# Perfetto / Chrome-trace export (paper §III-A: "visualized via Perfetto")
# ---------------------------------------------------------------------------

_TID_BY_LAYER = {l: i for i, l in enumerate(Layer)}


def to_chrome_trace(events: Iterable[Event]) -> Dict[str, Any]:
    trace = []
    for ev in events:
        trace.append({
            "name": ev.name,
            "cat": ev.layer.value,
            "ph": "X" if ev.dur else "i",
            "ts": ev.ts * 1e6,
            "dur": ev.dur * 1e6,
            "pid": ev.pid or os.getpid(),
            "tid": ev.tid or _TID_BY_LAYER[ev.layer],
            "args": dict(ev.meta or {}, size=ev.size, step=ev.step),
        })
    return {"traceEvents": trace, "displayTimeUnit": "ms"}


def export_perfetto(events: Iterable[Event], path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(to_chrome_trace(events), f)
    return path


# Canonical column dtypes of the *legacy* feature-builder view. String
# columns use object-free unicode; an empty event list must still yield
# correctly-dtyped (0,)-shaped columns — the stream wire format
# (the JAX package's repro.stream.wire) round-trips empty flushes through this schema.
EVENT_SCHEMA: Dict[str, np.dtype] = {
    "layer": np.dtype("<U10"),
    "name": NAME_DT,
    "ts": np.dtype(np.float64),
    "dur": np.dtype(np.float64),
    "size": np.dtype(np.float64),
    "step": np.dtype(np.int64),
}


def empty_arrays() -> Dict[str, np.ndarray]:
    """Explicit empty-schema path: (0,) columns with the canonical dtypes
    (``np.array([])`` would produce float64 for the string columns)."""
    return {k: np.empty(0, dtype=dt) for k, dt in EVENT_SCHEMA.items()}


def events_to_arrays(events: List[Event]) -> Dict[str, np.ndarray]:
    """Legacy columnar view (string layer labels; superseded by
    events_to_columns for everything downstream of the probes)."""
    if not events:
        return empty_arrays()
    return {
        "layer": np.array([e.layer.value for e in events]),
        "name": np.array([e.name for e in events]),
        "ts": np.array([e.ts for e in events], dtype=np.float64),
        "dur": np.array([e.dur for e in events], dtype=np.float64),
        "size": np.array([e.size for e in events], dtype=np.float64),
        "step": np.array([e.step for e in events], dtype=np.int64),
    }
