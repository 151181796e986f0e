"""Compact columnar wire format for event batches (port of
`repro/stream/wire.py`; only the imports differ, so the bytes are the same).

Node agents ship drained event-table contents to the fleet aggregator as
*columns*, not objects: one contiguous buffer per field, preceded by a small
JSON header. Since the columnar redesign the drained `EventTable` columns ARE
the wire schema — encoding is O(columns) buffer copies with no per-event
Python work at all, and the receiver ingests the columns straight into its
preallocated sliding windows without ever materialising `Event` objects.

Layout (little-endian), shared by every version:

    MAGIC "EACS" | u16 version | u32 header_len | header JSON (utf-8)
    | column block 0 | column block 1 | ...

Versions (all constants live HERE and nowhere else):

* **v1/v2 (plain)** — every column travels as raw fixed-dtype bytes; the
  header records node_id / seq / t_base / dropped / shed plus, per column,
  the dtype string and shape needed to reinterpret the bytes. String columns
  travel as fixed-width unicode (``<U#``): ~125 B/event, trivially seekable.
  v1 and v2 share the layout byte for byte (v2 merely added the ``shed``
  header field, which v1 readers never emitted); both decode identically.
* **v3 (compressed, the default)** — the fleet-scale encoding. Per batch:
  the ``<U64`` name column is dictionary-encoded (unique names once in the
  header, narrow uint codes on the wire), timestamps are quantised to
  integer nanoseconds and shipped as first-value + narrowed deltas
  (reconstruction error ≤ 0.5 ns per event, non-accumulating), integer
  columns (pid/tid/step) are min-offset narrowed or elided when constant,
  device telemetry (util/mem_gb/power_w/temp_c) ships sparsely — explicit
  row indices plus values only for rows that carry any — and the ``meta``
  column rides in the header as (index, value) pairs, absent when all-empty.
  Typical batches land at 20-30 B/event, a >4x reduction over plain.

Clips past ``events.NAME_WIDTH`` are *counted*, never silent — see
`EventTable.names_truncated` / `LayerWindow.names_truncated`; the v3
dictionary preserves natural-width names end to end exactly like plain.

``shed`` accounts events the node-side backpressure governor sampled OUT of
the batch before encoding (see the JAX package's `repro/fleet/governor.py`);
receivers surface it so no shed event is ever silent.
"""
from __future__ import annotations

import dataclasses
import json
import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

# Columnar conversion + schema constants live with the event model now;
# re-exported here because this module was their original home.
from repro_torch.core.events import (  # noqa: F401
    LAYER_CODE, LAYERS, TELEMETRY_KEYS, Event, Layer, columns_to_events,
    empty_arrays, empty_columns, events_to_arrays, events_to_columns)

MAGIC = b"EACS"

# -- wire versions (single source of truth) ---------------------------------
VERSION_LEGACY = 1      # original plain layout (pre-shed header)
VERSION_PLAIN = 2       # plain layout + shed accounting in the header
VERSION_COMPRESSED = 3  # dictionary names + delta timestamps + sparse cols
SUPPORTED_VERSIONS: Tuple[int, ...] = (
    VERSION_LEGACY, VERSION_PLAIN, VERSION_COMPRESSED)
VERSION = VERSION_COMPRESSED  # default encode version

# wire columns in serialization order
WIRE_COLUMNS = ("layer", "name", "ts", "dur", "size", "pid", "tid", "step",
                "util", "mem_gb", "power_w", "temp_c", "meta")

# v3: integer columns that get min-offset narrowing / constant elision
_V3_INT_COLS = ("pid", "tid", "step")
# v3: float columns kept raw at full precision (detector features)
_V3_RAW_F64 = ("dur", "size")

_TS_SCALE = 1e9  # v3 timestamps quantise to integer nanoseconds


class WireVersionError(ValueError):
    """Decoded batch speaks a wire version this build does not support."""

    def __init__(self, got: int, supported: Sequence[int] = SUPPORTED_VERSIONS):
        supported = tuple(supported)
        super().__init__(
            f"wire version mismatch: batch has version {got}, this build "
            f"supports versions {', '.join(map(str, supported))} only — "
            f"re-encode the batch or upgrade the peer")
        self.got = got
        self.supported = supported


@dataclasses.dataclass
class EventBatch:
    """One flush from one node: columnar events + provenance."""

    node_id: int
    seq: int  # per-node flush counter (gaps => lost batches)
    # provenance only: the node epoch offset the agent ALREADY added to the
    # ts column before shipping (ts values arrive fleet-absolute; receivers
    # must not re-apply t_base)
    t_base: float
    columns: Dict[str, np.ndarray]
    dropped: int = 0  # ring-buffer overwrites since the previous flush
    shed: int = 0  # events the backpressure governor sampled out pre-encode

    def __len__(self) -> int:
        return int(self.columns["ts"].shape[0])

    def nbytes(self) -> int:
        return sum(int(c.nbytes) for c in self.columns.values())


def _wire_ready(col: np.ndarray) -> np.ndarray:
    """Fixed-dtype, contiguous view of a column for raw serialization.

    EventTable stores the ``meta`` column as object dtype (variable-length
    JSON strings); on the wire it becomes fixed-width unicode."""
    if col.dtype == object:
        col = col.astype(str) if col.shape[0] else np.empty(0, "<U1")
        if col.dtype.itemsize == 0:  # all-empty strings -> <U0 is unportable
            col = col.astype("<U1")
    return np.ascontiguousarray(col)


def _header_dict(batch: EventBatch) -> Dict[str, Any]:
    return {"node_id": batch.node_id, "seq": batch.seq,
            "t_base": batch.t_base, "dropped": batch.dropped,
            "shed": batch.shed}


def _frame(version: int, header: Dict[str, Any],
           parts: List[bytes]) -> bytes:
    hjson = json.dumps(header, separators=(",", ":")).encode()
    return b"".join([MAGIC, struct.pack("<HI", version, len(hjson)), hjson]
                    + parts)


# ---------------------------------------------------------------------------
# plain layout (v1/v2)
# ---------------------------------------------------------------------------


def _encode_plain(batch: EventBatch, version: int) -> bytes:
    parts: List[bytes] = []
    colspec = []
    for name in WIRE_COLUMNS:
        col = _wire_ready(batch.columns[name])
        raw = col.tobytes()
        colspec.append({"name": name, "dtype": col.dtype.str,
                        "n": int(col.shape[0]), "nbytes": len(raw)})
        parts.append(raw)
    header = _header_dict(batch)
    header["columns"] = colspec
    return _frame(version, header, parts)


def _decode_plain(header: Dict[str, Any], buf: bytes,
                  off: int) -> Dict[str, np.ndarray]:
    columns: Dict[str, np.ndarray] = {}
    for spec in header["columns"]:
        nbytes = spec["nbytes"]
        raw = buf[off:off + nbytes]
        if len(raw) != nbytes:
            raise ValueError(f"truncated column {spec['name']}: "
                             f"{len(raw)}/{nbytes} bytes")
        arr = np.frombuffer(raw, dtype=np.dtype(spec["dtype"]))
        if arr.shape[0] != spec["n"]:
            raise ValueError(f"column {spec['name']} length mismatch")
        columns[spec["name"]] = arr
        off += nbytes
    return columns


# ---------------------------------------------------------------------------
# compressed layout (v3)
# ---------------------------------------------------------------------------


def _narrow_uint(values: np.ndarray) -> Tuple[np.ndarray, int]:
    """Min-offset unsigned narrowing: values -> (narrow offsets, base)."""
    base = int(values.min()) if values.shape[0] else 0
    span = int(values.max()) - base if values.shape[0] else 0
    for dt in (np.uint8, np.uint16, np.uint32):
        if span <= np.iinfo(dt).max:
            return (values - base).astype(dt), base
    return (values - base).astype(np.uint64), base


def _encode_compressed(batch: EventBatch) -> bytes:
    cols = batch.columns
    n = int(cols["ts"].shape[0])
    header = _header_dict(batch)
    header["n"] = n
    colspec: List[Dict[str, Any]] = []
    parts: List[bytes] = []

    def block(spec: Dict[str, Any], arr: Optional[np.ndarray]) -> None:
        raw = arr.tobytes() if arr is not None else b""
        if arr is not None:
            spec["block"] = arr.dtype.str
        spec["nbytes"] = len(raw)
        colspec.append(spec)
        parts.append(raw)

    if n:
        # layer: raw int8
        layer = np.ascontiguousarray(cols["layer"], dtype=np.int8)
        block({"name": "layer", "enc": "raw", "dtype": "|i1", "n": n}, layer)

        # name: per-batch dictionary, narrow uint codes on the wire
        names_fw = _wire_ready(cols["name"])
        uniq, codes = np.unique(names_fw, return_inverse=True)
        header["names"] = [str(s) for s in uniq]
        codes_arr, _ = _narrow_uint(codes.astype(np.int64))
        block({"name": "name", "enc": "dict", "dtype": names_fw.dtype.str,
               "n": n}, codes_arr)

        # ts: integer-nanosecond quantisation, first value + narrowed deltas
        ts_ns = np.round(np.asarray(cols["ts"], np.float64)
                         * _TS_SCALE).astype(np.int64)
        diffs = np.diff(ts_ns)
        packed, base = _narrow_uint(diffs)
        block({"name": "ts", "enc": "delta", "dtype": "<f8", "n": n,
               "first": int(ts_ns[0]), "base": base}, packed)

        # dur/size: full-precision floats (detector features). Many batches
        # carry few distinct values (tensor sizes, zero durations) — dict-
        # encode when that wins, raw f8 otherwise; precision is exact either
        # way.
        for key in _V3_RAW_F64:
            arr = np.ascontiguousarray(cols[key], dtype=np.float64)
            uniq, codes = np.unique(arr, return_inverse=True)
            if (uniq.shape[0] <= 256 and uniq.shape[0] * 4 <= n
                    and not np.isnan(uniq).any()):
                codes_arr, _ = _narrow_uint(codes.astype(np.int64))
                block({"name": key, "enc": "fdict", "dtype": "<f8", "n": n,
                       "n_dict": int(uniq.shape[0])},
                      np.concatenate([uniq.view(np.uint8),
                                      codes_arr.view(np.uint8)]))
                colspec[-1]["block"] = codes_arr.dtype.str
            else:
                block({"name": key, "enc": "raw", "dtype": "<f8", "n": n},
                      arr)

        # pid/tid/step: constant elision, else min-offset narrowing
        for key in _V3_INT_COLS:
            ints = np.asarray(cols[key], np.int64)
            lo, hi = int(ints.min()), int(ints.max())
            if lo == hi:
                block({"name": key, "enc": "const", "dtype": "<i8", "n": n,
                       "value": lo}, None)
            else:
                packed, base = _narrow_uint(ints)
                block({"name": key, "enc": "minoff", "dtype": "<i8", "n": n,
                       "base": base}, packed)

        # telemetry: one shared index of rows carrying ANY telemetry, then
        # values-at-index per column (device events are a small fraction)
        tele = np.stack([np.asarray(cols[k], np.float64)
                         for k in TELEMETRY_KEYS])
        idx = np.flatnonzero(~np.isnan(tele).all(axis=0))
        idx_arr, idx_base = _narrow_uint(idx.astype(np.int64))
        block({"name": "__rows__", "enc": "index", "n": int(idx.shape[0]),
               "base": idx_base}, idx_arr)
        for j, key in enumerate(TELEMETRY_KEYS):
            block({"name": key, "enc": "sparse", "dtype": "<f8", "n": n},
                  np.ascontiguousarray(tele[j, idx]))

        # meta: (row, value) pairs in the header, absent when all-empty
        meta = cols["meta"]
        if meta.dtype == object:
            nonempty = [(i, str(v)) for i, v in enumerate(meta) if v]
        else:
            midx = np.flatnonzero(np.char.str_len(meta.astype(str)))
            nonempty = [(int(i), str(meta[i])) for i in midx]
        if nonempty:
            header["meta"] = {"idx": [i for i, _ in nonempty],
                              "vals": [v for _, v in nonempty]}

    header["columns"] = colspec
    return _frame(VERSION_COMPRESSED, header, parts)


def _decode_compressed(header: Dict[str, Any], buf: bytes,
                       off: int) -> Dict[str, np.ndarray]:
    n = int(header.get("n", 0))
    if n == 0:
        return empty_columns()
    names = header.get("names")
    if not isinstance(names, list):
        raise ValueError("corrupt wire header: missing name dictionary")
    columns: Dict[str, np.ndarray] = {}
    tele_idx: Optional[np.ndarray] = None
    for spec in header["columns"]:
        nbytes = spec["nbytes"]
        raw = buf[off:off + nbytes]
        if len(raw) != nbytes:
            raise ValueError(f"truncated column {spec['name']}: "
                             f"{len(raw)}/{nbytes} bytes")
        off += nbytes
        enc = spec.get("enc")
        blk = (np.frombuffer(raw, dtype=np.dtype(spec["block"]))
               if "block" in spec else np.empty(0, np.int64))
        if enc == "raw":
            if blk.shape[0] != spec["n"]:
                raise ValueError(f"column {spec['name']} length mismatch")
            columns[spec["name"]] = blk
        elif enc == "dict":
            codes = blk.astype(np.int64)
            if codes.shape[0] != spec["n"]:
                raise ValueError(f"column {spec['name']} length mismatch")
            if codes.shape[0] and int(codes.max()) >= len(names):
                raise ValueError(
                    f"corrupt name dictionary: code {int(codes.max())} out "
                    f"of range (dictionary has {len(names)} entries)")
            columns[spec["name"]] = np.array(
                names, dtype=spec["dtype"])[codes]
        elif enc == "delta":
            if blk.shape[0] != spec["n"] - 1:
                raise ValueError(f"column {spec['name']} length mismatch")
            ts_ns = np.empty(spec["n"], np.int64)
            ts_ns[0] = int(spec["first"])
            np.cumsum(blk.astype(np.int64) + int(spec["base"]),
                      out=ts_ns[1:])
            ts_ns[1:] += ts_ns[0]
            columns[spec["name"]] = (ts_ns / _TS_SCALE).astype(
                np.dtype(spec["dtype"]))
        elif enc == "fdict":
            nd = int(spec["n_dict"])
            values = np.frombuffer(raw[:nd * 8], dtype="<f8")
            codes = np.frombuffer(raw[nd * 8:],
                                  dtype=np.dtype(spec["block"]))
            if values.shape[0] != nd or codes.shape[0] != spec["n"]:
                raise ValueError(f"column {spec['name']} length mismatch")
            if codes.shape[0] and int(codes.max()) >= nd:
                raise ValueError(
                    f"corrupt value dictionary in {spec['name']}: code "
                    f"{int(codes.max())} out of range ({nd} entries)")
            columns[spec["name"]] = values[codes.astype(np.int64)]
        elif enc == "const":
            columns[spec["name"]] = np.full(
                spec["n"], spec["value"], dtype=np.dtype(spec["dtype"]))
        elif enc == "minoff":
            if blk.shape[0] != spec["n"]:
                raise ValueError(f"column {spec['name']} length mismatch")
            columns[spec["name"]] = (blk.astype(np.int64)
                                     + int(spec["base"])).astype(
                np.dtype(spec["dtype"]))
        elif enc == "index":
            tele_idx = blk.astype(np.int64) + int(spec.get("base", 0))
            if tele_idx.shape[0] != spec["n"]:
                raise ValueError("telemetry index length mismatch")
            if tele_idx.shape[0] and (int(tele_idx.max()) >= n
                                      or int(tele_idx.min()) < 0):
                raise ValueError("corrupt telemetry index: row out of range")
        elif enc == "sparse":
            if tele_idx is None:
                raise ValueError(
                    f"corrupt batch: sparse column {spec['name']} precedes "
                    "its telemetry index")
            if blk.shape[0] != tele_idx.shape[0]:
                raise ValueError(f"column {spec['name']} length mismatch")
            full = np.full(n, np.nan, dtype=np.dtype(spec["dtype"]))
            full[tele_idx] = blk
            columns[spec["name"]] = full
        else:
            raise ValueError(f"unknown column encoding {enc!r} "
                             f"for {spec['name']}")
    meta_spec = header.get("meta")
    if meta_spec:
        idx, vals = meta_spec["idx"], meta_spec["vals"]
        if len(idx) != len(vals) or (idx and (max(idx) >= n or min(idx) < 0)):
            raise ValueError("corrupt meta block: index out of range")
        width = max(1, max((len(v) for v in vals), default=1))
        meta = np.zeros(n, dtype=f"<U{width}")
        meta[np.asarray(idx, np.int64)] = vals
    else:
        meta = np.zeros(n, dtype="<U1")
    columns["meta"] = meta
    missing = [k for k in WIRE_COLUMNS if k not in columns]
    if missing:
        raise ValueError(f"corrupt batch: missing columns {missing}")
    return columns


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def encode(batch: EventBatch, version: Optional[int] = None) -> bytes:
    """EventBatch -> wire bytes (``version`` defaults to `VERSION`)."""
    version = VERSION if version is None else int(version)
    if version in (VERSION_LEGACY, VERSION_PLAIN):
        return _encode_plain(batch, version)
    if version == VERSION_COMPRESSED:
        return _encode_compressed(batch)
    raise WireVersionError(version)


def decode(buf: bytes) -> EventBatch:
    """Wire bytes -> EventBatch. Validates magic/version and column sizes.

    Raises `WireVersionError` on any version outside `SUPPORTED_VERSIONS`:
    the header layout beyond the version field is version-specific, so a
    mismatched parse would silently misread."""
    if buf[:4] != MAGIC:
        raise ValueError(f"bad magic {buf[:4]!r}")
    version, hlen = struct.unpack_from("<HI", buf, 4)
    if version not in SUPPORTED_VERSIONS:
        raise WireVersionError(version)
    off = 10
    hraw = buf[off:off + hlen]
    if len(hraw) != hlen:
        raise ValueError(f"truncated header: {len(hraw)}/{hlen} bytes")
    try:
        header = json.loads(hraw.decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"corrupt wire header: {e}") from None
    off += hlen
    if version == VERSION_COMPRESSED:
        columns = _decode_compressed(header, buf, off)
    else:
        columns = _decode_plain(header, buf, off)
    return EventBatch(node_id=header["node_id"], seq=header["seq"],
                      t_base=header["t_base"], dropped=header["dropped"],
                      shed=header.get("shed", 0), columns=columns)


def encode_columns(cols: Dict[str, np.ndarray], *, node_id: int, seq: int,
                   t_base: float = 0.0, dropped: int = 0, shed: int = 0,
                   version: Optional[int] = None) -> bytes:
    """ColumnView -> wire bytes (the native path: no Event objects)."""
    return encode(EventBatch(node_id=node_id, seq=seq, t_base=t_base,
                             columns=cols, dropped=dropped, shed=shed),
                  version=version)


def encode_events(events: List[Event], *, node_id: int, seq: int,
                  t_base: float = 0.0, dropped: int = 0, shed: int = 0,
                  version: Optional[int] = None) -> bytes:
    """Convenience: Event list -> wire bytes in one call (compat path)."""
    return encode_columns(events_to_columns(events), node_id=node_id,
                          seq=seq, t_base=t_base, dropped=dropped, shed=shed,
                          version=version)
