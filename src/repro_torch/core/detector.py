"""Per-layer anomaly detection (paper Algorithm 2) + the full-stack monitor.

`GMMDetector` is the paper's detector: fit a GMM on a (recent) window of
per-layer features, then flag events whose best-component density falls below
delta. Delta can be given directly (paper) or calibrated from a contamination
rate (the quantile of training scores) — the latter is what Table I uses so
every method sees the same threshold policy.

The GMM fits and scores on ``device`` (default ``cuda``: the ``gmm_score`` and
``gmm_best`` kernels); features and thresholds stay numpy on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.core.events import Layer
from repro_torch.core.features import (EventsOrColumns, LayerFeaturizer,
                                       Standardizer, ensure_columns)
from repro_torch.core.gmm import GMM
from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass
class DetectionResult:
    layer: Layer
    flags: np.ndarray  # (N,) bool
    scores: np.ndarray  # (N,) best-component log density
    log_delta: float
    steps: np.ndarray  # (N,) step ids
    # (N,) event timestamps (seconds, collector clock); None when the feature
    # pipeline did not carry them. Lets callers measure time-to-detect.
    ts: Optional[np.ndarray] = None
    # (N,) node ids (from the pid column, session-rewritten to node ids);
    # lets the incident engine attribute batch flags to fleet members
    nodes: Optional[np.ndarray] = None

    @property
    def anomaly_rate(self) -> float:
        return float(np.mean(self.flags)) if len(self.flags) else 0.0

    def anomalous_steps(self) -> np.ndarray:
        return np.unique(self.steps[self.flags & (self.steps >= 0)])


class GMMDetector:
    """Definition-1 detector over one feature space."""

    def __init__(self, n_components: int = 4, contamination: float = 1 / 6,
                 log_delta: Optional[float] = None, n_iters: int = 60,
                 seed: int = 0, reg: float = 1e-2,
                 device: DeviceLike = None):
        # reg floors the covariance in standardized units: per-name event
        # clusters are nearly degenerate, and an unfloored GMM becomes
        # pathologically overconfident about them.
        self.gmm = GMM(n_components=n_components, n_iters=n_iters, seed=seed,
                       reg=reg, device=device)
        self.contamination = contamination
        self.log_delta = log_delta
        self.std = Standardizer()

    def fit(self, X: np.ndarray) -> "GMMDetector":
        Xs = self.std.fit_transform(X)
        self.gmm.fit(Xs)
        if self.log_delta is None:
            scores = self.gmm.score(Xs)
            self.log_delta = float(np.quantile(scores, self.contamination))
        return self

    def score(self, X: np.ndarray) -> np.ndarray:
        return self.gmm.score(self.std.transform(X))

    def predict(self, X: np.ndarray) -> np.ndarray:
        """True = anomalous (Definition 1)."""
        return self.score(X) < self.log_delta


class FullStackMonitor:
    """One GMMDetector per monitored layer — the paper's top-level loop."""

    LAYERS = (Layer.XLA, Layer.PYTHON, Layer.OPERATOR, Layer.COLLECTIVE,
              Layer.DEVICE, Layer.STEP)

    def __init__(self, n_components: int = 4, contamination: float = 1 / 6,
                 min_events: int = 64, device: DeviceLike = None):
        self.n_components = n_components
        self.device = resolve_device(device)
        self.contamination = contamination
        self.min_events = min_events
        self.detectors: Dict[Layer, GMMDetector] = {}
        self.featurizers: Dict[Layer, LayerFeaturizer] = {}

    def fit(self, data: EventsOrColumns) -> "FullStackMonitor":
        cols = ensure_columns(data)  # columnarise legacy Event lists ONCE
        for layer in self.LAYERS:
            feat = LayerFeaturizer(layer)
            fs = feat.fit_transform(cols)
            if fs is None or fs.X.shape[0] < self.min_events:
                continue
            k = min(self.n_components, max(1, fs.X.shape[0] // 32))
            self.featurizers[layer] = feat
            self.detectors[layer] = GMMDetector(
                n_components=k, contamination=self.contamination,
                device=self.device).fit(fs.X)
        return self

    def detect(self, data: EventsOrColumns) -> Dict[Layer, DetectionResult]:
        cols = ensure_columns(data)
        out: Dict[Layer, DetectionResult] = {}
        for layer, det in self.detectors.items():
            fs = self.featurizers[layer].transform(cols)
            if fs is None or not len(fs.X):
                continue
            scores = det.score(fs.X)
            out[layer] = DetectionResult(
                layer=layer, flags=scores < det.log_delta, scores=scores,
                log_delta=det.log_delta, steps=fs.steps, ts=fs.ts,
                nodes=fs.nodes)
        return out
