"""Windowed feature extraction: event columns -> per-layer feature matrices.

Mirrors the paper's per-layer modelling: latency layers (XLA/CUDA, Python,
Operator/Torch) use (duration, size, inter-arrival); the device layer uses
(utilisation, memory, power, temperature); the collective layer uses
(latency, message size, achieved bandwidth).

Columnar-native: `build_features` consumes a ColumnView (the dict of flat
arrays produced by `EventTable.drain_columns`, `wire.decode`, or
`LayerWindow.view`) and every per-name statistic is a vectorised group-by
(np.unique + argsort), never a Python loop over records. `List[Event]` input
is accepted as a compat shim and columnarised once at the boundary. The same
raw-matrix code serves both the batch featurizer here and the streaming
detector (`repro_torch.stream.online`), so the two paths cannot drift.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.events import (LAYER_CODE, TELEMETRY_KEYS, Event, Layer,
                               events_to_columns)

LATENCY_LAYERS = (Layer.XLA, Layer.PYTHON, Layer.OPERATOR, Layer.STEP)

LATENCY_FEATURES = ("log_dur_us", "rel_dur", "log_bytes")
COLLECTIVE_FEATURES = ("log_lat_us", "rel_dur", "log_bytes", "log_bw")
DEVICE_FEATURES = ("util", "mem_gb", "power_w", "temp_c")

ColumnView = Dict[str, np.ndarray]
EventsOrColumns = Union[List[Event], ColumnView]


@dataclasses.dataclass
class FeatureSet:
    layer: Layer
    X: np.ndarray  # (N, D) float64
    steps: np.ndarray  # (N,) step id per row (-1 when unknown)
    names: List[str]  # feature names
    event_names: np.ndarray  # (N,) source event name
    # (N,) source event timestamps (seconds, collector clock); carried so
    # detection results can report WHEN a flag fired, not just at which step
    ts: Optional[np.ndarray] = None
    # (N,) node id per row (the pid column, which the session rewrites to
    # node ids at drain time) — lets batch detections attribute flags to
    # fleet members the way streaming WindowDetections do
    nodes: Optional[np.ndarray] = None


def ensure_columns(data: EventsOrColumns) -> ColumnView:
    """Accept a ColumnView as-is; columnarise a legacy Event list once."""
    if isinstance(data, dict):
        return data
    return events_to_columns(data)


def grouped_medians(inv: np.ndarray, values: np.ndarray,
                    n_groups: int) -> np.ndarray:
    """Per-group medians, fully vectorised: one lexsort over (group, value)
    then a middle-element gather per group. ``inv`` is the group id per row
    (np.unique's return_inverse); every group must be non-empty."""
    order = np.lexsort((values, inv))
    v = values[order]
    counts = np.bincount(inv, minlength=n_groups)
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    lo = starts + (counts - 1) // 2
    hi = starts + counts // 2
    return 0.5 * (v[lo] + v[hi])


def per_name_gaps(ts: np.ndarray, names: np.ndarray) -> np.ndarray:
    """Inter-arrival gap to the previous event OF THE SAME NAME (0 for each
    name's first occurrence) — the argsort/np.unique replacement of the old
    per-row dict loop. ``ts`` must be ascending (build_features sorts)."""
    gap = np.zeros_like(ts, dtype=np.float64)
    if ts.shape[0] == 0:
        return gap
    _, inv = np.unique(names, return_inverse=True)
    # stable sort by name keeps each name's rows in time order; consecutive
    # same-name rows are then exactly (previous occurrence, this occurrence)
    order = np.argsort(inv, kind="stable")
    same = inv[order][1:] == inv[order][:-1]
    d = ts[order][1:] - ts[order][:-1]
    gap[order[1:][same]] = d[same]
    return gap


def _keep_idx(layer: Layer, cols: ColumnView) -> np.ndarray:
    """Row indices of ``cols`` belonging to ``layer``, minus static/
    records. The (string-compare) static/ scan runs only over the layer's
    own rows, not the whole multi-layer table."""
    names = cols["name"]
    if "layer" in cols:
        lc = cols["layer"]
        if lc.dtype.kind in "iu":  # int8 wire codes (native)
            idx = np.flatnonzero(lc == np.int8(LAYER_CODE[layer]))
        else:  # legacy string labels
            idx = np.flatnonzero(lc == layer.value)
    else:  # single-layer view (e.g. LayerWindow)
        idx = np.arange(names.shape[0])
    if idx.shape[0]:
        sub = names[idx].astype(str, copy=False)
        idx = idx[~np.char.startswith(sub, "static/")]
    return idx


def raw_feature_matrix(layer: Layer, cols: ColumnView,
                       idx: np.ndarray) -> Optional[Tuple[np.ndarray,
                                                          np.ndarray]]:
    """The per-layer feature space over rows ``idx`` of ``cols``, with the
    rel_dur column left at zero (callers fill it from per-name baselines).

    Returns (X, kept_idx) — device layers drop rows without telemetry, so
    ``kept_idx`` may be a subset of ``idx``. Shared by the batch featurizer
    and the streaming window detector."""
    if layer == Layer.DEVICE:
        has_tel = ~np.isnan(cols["util"][idx])
        idx = idx[has_tel]
        if not idx.shape[0]:
            return None
        X = np.stack([cols[k][idx] for k in DEVICE_FEATURES], axis=1)
        return X.astype(np.float64, copy=False), idx
    if not idx.shape[0]:
        return None
    dur = cols["dur"][idx]
    size = cols["size"][idx]
    log_dur = np.log1p(dur * 1e6)
    feats = [log_dur, np.zeros_like(log_dur), np.log1p(size)]
    if layer == Layer.COLLECTIVE:
        bw = np.where(dur > 0, size / np.maximum(dur, 1e-9), 0.0)
        feats.append(np.log1p(bw))
    return np.stack(feats, axis=1), idx


def name_medians(names: np.ndarray, log_dur: np.ndarray
                 ) -> Tuple[Dict[str, float], float]:
    """Per-name median log-duration baselines + the global fallback."""
    if not names.shape[0]:
        return {}, 0.0
    uniq, inv = np.unique(names, return_inverse=True)
    med = grouped_medians(inv, log_dur, uniq.shape[0])
    return ({str(n): float(m) for n, m in zip(uniq, med)},
            float(np.median(log_dur)))


def baseline_for(names: np.ndarray, medians: Dict[str, float],
                 global_median: float) -> np.ndarray:
    """Per-row baseline = fitted per-name median (global fallback): one
    dict lookup per UNIQUE name, gathered back to rows."""
    uniq, inv = np.unique(names, return_inverse=True)
    base = np.array([medians.get(str(n), global_median) for n in uniq])
    return base[inv]


def build_features(data: EventsOrColumns, layer: Layer
                   ) -> Optional[FeatureSet]:
    """One layer's feature matrix from an event stream (columns or a legacy
    Event list). rel_dur is the deviation from the per-name median of THIS
    window — "is this op slower than ITS OWN baseline", the per-operator
    view the paper gets from symbol-level uprobes."""
    cols = ensure_columns(data)
    idx = _keep_idx(layer, cols)
    if not idx.shape[0]:
        return None
    order = np.argsort(cols["ts"][idx], kind="stable")
    idx = idx[order]
    raw = raw_feature_matrix(layer, cols, idx)
    if raw is None:
        return None
    X, idx = raw
    names = cols["name"][idx]
    steps = cols["step"][idx].astype(np.int64, copy=False)
    ts = cols["ts"][idx]
    nodes = cols["pid"][idx] if "pid" in cols else None
    if layer == Layer.DEVICE:
        return FeatureSet(layer, X, steps, list(DEVICE_FEATURES), names,
                          ts=ts, nodes=nodes)
    medians, gmed = name_medians(names, X[:, 0])
    X[:, 1] = X[:, 0] - baseline_for(names, medians, gmed)
    # NOTE: inter-arrival gaps (per_name_gaps) and name-frequency features
    # are deliberately excluded: they are window-relative, so a detector
    # fitted on a clean window systematically mis-scores a window with holes
    # (see tests).
    feat_names = (COLLECTIVE_FEATURES if layer == Layer.COLLECTIVE
                  else LATENCY_FEATURES)
    return FeatureSet(layer, X, steps, list(feat_names), names, ts=ts,
                      nodes=nodes)


class LayerFeaturizer:
    """Learned per-layer featurization: per-name duration baselines are
    fitted ONCE (on the reference window) and reused at detect time — a
    detector must not re-derive its normalisation from the window it is
    scoring (that leaks the anomalies into the baseline)."""

    def __init__(self, layer: Layer):
        self.layer = layer
        self.medians: Dict[str, float] = {}
        self.global_median = 0.0

    def fit(self, data: EventsOrColumns) -> Optional["LayerFeaturizer"]:
        fs = build_features(data, self.layer)
        if fs is None:
            return None
        self.medians, self.global_median = name_medians(fs.event_names,
                                                        fs.X[:, 0])
        return self

    def transform(self, data: EventsOrColumns) -> Optional[FeatureSet]:
        fs = build_features(data, self.layer)
        if fs is None:
            return None
        if self.layer == Layer.DEVICE:
            return fs  # absolute telemetry features
        X = fs.X.copy()
        X[:, 1] = fs.X[:, 0] - baseline_for(fs.event_names, self.medians,
                                            self.global_median)
        return FeatureSet(fs.layer, X, fs.steps, fs.names, fs.event_names,
                          ts=fs.ts, nodes=fs.nodes)

    def fit_transform(self, data: EventsOrColumns) -> Optional[FeatureSet]:
        if self.fit(data) is None:
            return None
        return self.transform(data)


class Standardizer:
    def __init__(self):
        self.mean: Optional[np.ndarray] = None
        self.std: Optional[np.ndarray] = None

    def fit(self, X: np.ndarray) -> "Standardizer":
        self.mean = X.mean(0)
        self.std = np.maximum(X.std(0), 1e-9)
        return self

    def transform(self, X: np.ndarray) -> np.ndarray:
        return (X - self.mean) / self.std

    def fit_transform(self, X: np.ndarray) -> np.ndarray:
        return self.fit(X).transform(X)
