"""Online per-window detection for the pluggable model families (port of
`repro/stream/backends.py`; only the imports differ).

`OnlineModelDetector` is the family-generic counterpart of
`OnlineGMMDetector`: same aggregator-window lifecycle (idempotent
``warmup`` -> per-tick ``detect`` -> tracked model maintenance), same
featurisation (`_raw_features` / `_apply_baseline` from
`repro_torch.stream.online`, which themselves delegate to `core.features`
— the batch and stream paths cannot drift), same `WindowDetection` output and
threshold policy. Only the per-layer model differs: any
`repro_torch.detect.families.ScoreModel` (isolation ensemble, MAD envelope,
spectral residual) slots in via a factory.

Tracking, when enabled (``track``, from the spec's ``warm_start``):

* ``incremental=True``: ``partial_fit`` folds the window's inlier rows
  into the model (tree refresh / stat blend / covariance EMA — each
  family's warm refit);
* ``incremental=False``: a full ``fit`` on the inlier sample per sweep
  (the cold-refit-every-window regime, still cheap for these families);
* either way the threshold drifts toward the window's contamination
  quantile, clamped per sweep to a scale-free step (a fraction of the
  training scores' IQR — the families' score scales differ, so the GMM's
  fixed nat-step would be wrong for them).

`StreamMonitor` accepts any of these via its ``detector=`` parameter, so
the async snapshot/detect_snapshot/admit trio, incident engine, and wire
pipeline are inherited by every family for free.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.events import Layer
from repro_torch.core.features import name_medians
from repro_torch.detect.families import ModelFactory, ScoreModel
from repro_torch.stream.online import (OnlineGMMDetector, WindowDetection,
                                 WindowFeatures, _apply_baseline,
                                 _raw_features)
from repro_torch.stream.window import FleetAggregator, LayerWindow


@dataclasses.dataclass
class _LayerModelState:
    medians: Dict[str, float]
    global_median: float
    mean: np.ndarray
    std: np.ndarray
    model: ScoreModel
    log_delta: float
    delta_step: float  # per-sweep threshold clamp (score-scale relative)
    refits: int = 0


class OnlineModelDetector:
    """One warm-startable ScoreModel per layer over the sliding windows."""

    # same exclusion as the GMM: REQUEST rows are SLO-thresholded
    LAYERS = OnlineGMMDetector.LAYERS

    def __init__(self, factory: ModelFactory, family: str = "",
                 contamination: float = 0.02, min_events: int = 64,
                 fit_rows: int = 2048, seed: int = 0,
                 delta_frac: float = 0.25):
        self.factory = factory
        self.family = family
        self.contamination = contamination
        self.min_events = min_events
        # cap on rows handed to fit/partial_fit per sweep (subsample; these
        # models need no fixed compiled shape, so no bootstrap-up)
        self.fit_rows = fit_rows
        # threshold clamp = delta_frac * IQR of the training scores: the
        # families' score scales differ by orders of magnitude, so the step
        # must be derived from the fitted score distribution
        self.delta_frac = float(delta_frac)
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        # knobs the session backend sets from the spec (GMM-parity surface;
        # drift_tol is accepted for uniformity — these families re-fit
        # continuously instead of watching a likelihood collapse)
        self.track = True
        self.incremental = True
        self.drift_tol = 3.0
        self.states: Dict[Layer, _LayerModelState] = {}

    # -- helpers --------------------------------------------------------------
    def _subsample(self, X: np.ndarray) -> np.ndarray:
        n = X.shape[0]
        if n <= self.fit_rows:
            return X
        return X[self._rng.choice(n, self.fit_rows, replace=False)]

    def _featurize(self, window: LayerWindow,
                   state: _LayerModelState) -> Optional[WindowFeatures]:
        if len(window) == 0:
            return None
        fs = _raw_features(window.layer, window.view())
        if fs is None:
            return None
        if window.layer != Layer.DEVICE:
            _apply_baseline(fs, state.medians, state.global_median)
        return fs

    def _cold_fit(self, layer: Layer,
                  fs: WindowFeatures) -> _LayerModelState:
        if layer == Layer.DEVICE:
            medians, gmed = {}, 0.0
        else:
            medians, gmed = name_medians(fs.names, fs.X[:, 0])
            _apply_baseline(fs, medians, gmed)
        mean = fs.X.mean(0)
        std = np.maximum(fs.X.std(0), 1e-9)
        Xs = (fs.X - mean) / std
        model = self.factory().fit(self._subsample(Xs))
        scores = model.decision_scores(Xs)
        q25, q75 = np.quantile(scores, (0.25, 0.75))
        return _LayerModelState(
            medians=medians, global_median=gmed, mean=mean, std=std,
            model=model,
            log_delta=float(np.quantile(scores, self.contamination)),
            delta_step=max(1e-3, self.delta_frac * float(q75 - q25)))

    # -- lifecycle ------------------------------------------------------------
    def warmup(self, agg: FleetAggregator) -> List[Layer]:
        """Fit baselines + models on the current (assumed-clean) windows of
        every layer not yet modelled; idempotent (late layers fit once they
        reach min_events). Returns the newly fitted layers."""
        fitted = []
        for layer in self.LAYERS:
            if layer in self.states:
                continue
            window = agg.window(layer)
            if len(window) < self.min_events:
                continue
            fs = _raw_features(layer, window.view())
            if fs is None or fs.X.shape[0] < self.min_events:
                continue
            self.states[layer] = self._cold_fit(layer, fs)
            fitted.append(layer)
        return fitted

    @property
    def warmed(self) -> bool:
        return bool(self.states)

    # -- per-window detection --------------------------------------------------
    def detect(self, agg: FleetAggregator, refit: bool = True
               ) -> Dict[Layer, WindowDetection]:
        out: Dict[Layer, WindowDetection] = {}
        for layer, state in self.states.items():
            fs = self._featurize(agg.window(layer), state)
            if fs is None or not len(fs.X):
                continue
            Xs = (fs.X - state.mean) / state.std
            scores = state.model.decision_scores(Xs)
            flags = scores < state.log_delta
            mode = "none"
            if refit and self.track:
                mode = self._track(state, Xs, flags, scores)
            out[layer] = WindowDetection(
                layer=layer, flags=flags, scores=scores,
                log_delta=state.log_delta, steps=fs.steps, nodes=fs.nodes,
                ts=fs.ts, refit=mode)
        return out

    def _track(self, state: _LayerModelState, Xs: np.ndarray,
               flags: np.ndarray, scores: np.ndarray) -> str:
        """Model maintenance after scoring: fold/refit on the inlier rows
        (flagged rows are censored — a burst must not teach the model) and
        drift the threshold toward the window's contamination quantile,
        clamped to ``delta_step`` per sweep."""
        inliers = Xs[~flags]
        if inliers.shape[0] < max(16, self.min_events // 4):
            return "none"
        sample = self._subsample(inliers)
        if self.incremental:
            state.model.partial_fit(sample)
        else:
            state.model.fit(sample)
        state.refits += 1
        target = float(np.quantile(scores, self.contamination))
        state.log_delta += float(np.clip(target - state.log_delta,
                                         -state.delta_step,
                                         state.delta_step))
        return "warm"

    def stats(self) -> Dict[str, object]:
        return {layer.value: dict(
                    {"family": self.family,
                     "log_delta": s.log_delta,
                     "warm_refits": s.refits,
                     "cold_refits": 0},
                    **(s.model.stats() if hasattr(s.model, "stats") else {}))
                for layer, s in self.states.items()}
