"""Detector model families behind one score convention (port of
`repro/detect/families.py`; only the imports differ).

A *family* is a per-feature-space score model (`ScoreModel`): fit on clean
standardized features, emit per-row ``decision_scores`` where **higher =
more normal**, optionally fold new inlier rows via ``partial_fit``. The
GMM's best-component log-density already follows this convention, and the
bake-off families negate their anomaly statistics to match — so every
downstream consumer (threshold calibration, `WindowDetection` /
`DetectionResult`, incident engine, eval metrics) works unchanged for any
family:

    log_delta = quantile(decision_scores(train), contamination)
    flags     = decision_scores(window) < log_delta

`model_factory` maps a family name + `DetectorSpec` knobs to a fresh-model
constructor; `ModelStackMonitor` is the batch full-stack loop
(`core.detector.FullStackMonitor` generalised to any family) used by the
``isoforest`` / ``mad`` / ``spectral`` batch backends.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Protocol, runtime_checkable

import numpy as np

from repro_torch.core.detector import DetectionResult, FullStackMonitor
from repro_torch.core.events import Layer
from repro_torch.core.features import (EventsOrColumns, LayerFeaturizer,
                                 Standardizer, ensure_columns)
from repro_torch.detect.isoforest import IsolationEnsemble
from repro_torch.detect.robust import RobustMADModel
from repro_torch.detect.spectral import SpectralResidualModel

# score-model families pluggable beside the GMM (the GMM keeps its own EM
# pipeline on the card; it is a registry peer, not a ScoreModel). These
# families stay NumPy on the host, as in the reference: none of them reaches
# a GMM kernel
MODEL_FAMILIES = ("isoforest", "mad", "spectral")


@runtime_checkable
class ScoreModel(Protocol):
    """One family's per-feature-space model (duck-typed)."""

    def fit(self, X: np.ndarray) -> "ScoreModel": ...

    def decision_scores(self, X: np.ndarray) -> np.ndarray: ...

    def partial_fit(self, X: np.ndarray) -> None: ...


ModelFactory = Callable[[], ScoreModel]


def model_factory(family: str, *, seed: int = 0, n_trees: int = 64,
                  refresh_trees: float = 0.25,
                  var_target: float = 0.98) -> ModelFactory:
    """Fresh-model constructor for ``family`` with the spec's knobs bound.

    The factory is called once per layer — each layer gets its own model
    instance (seeded models consume their own RNG stream per instance)."""
    if family == "isoforest":
        return lambda: IsolationEnsemble(n_trees=n_trees,
                                         refresh_frac=refresh_trees,
                                         seed=seed)
    if family == "mad":
        return lambda: RobustMADModel()
    if family == "spectral":
        return lambda: SpectralResidualModel(var_target=var_target)
    raise KeyError(f"unknown model family {family!r}; "
                   f"available: {', '.join(MODEL_FAMILIES)}")


@dataclasses.dataclass
class _FittedLayer:
    featurizer: LayerFeaturizer
    std: Standardizer
    model: ScoreModel
    log_delta: float


class ModelStackMonitor:
    """One ScoreModel per monitored layer — `FullStackMonitor` for any
    family. Same layers, same per-layer featurizer/standardizer freeze,
    same contamination-quantile threshold policy."""

    LAYERS = FullStackMonitor.LAYERS

    def __init__(self, factory: ModelFactory, contamination: float = 1 / 6,
                 min_events: int = 64):
        self.factory = factory
        self.contamination = contamination
        self.min_events = min_events
        self.detectors: Dict[Layer, _FittedLayer] = {}

    def fit(self, data: EventsOrColumns) -> "ModelStackMonitor":
        cols = ensure_columns(data)
        for layer in self.LAYERS:
            feat = LayerFeaturizer(layer)
            fs = feat.fit_transform(cols)
            if fs is None or fs.X.shape[0] < self.min_events:
                continue
            std = Standardizer()
            Xs = std.fit_transform(fs.X)
            model = self.factory().fit(Xs)
            scores = model.decision_scores(Xs)
            self.detectors[layer] = _FittedLayer(
                featurizer=feat, std=std, model=model,
                log_delta=float(np.quantile(scores, self.contamination)))
        return self

    def detect(self, data: EventsOrColumns) -> Dict[Layer, DetectionResult]:
        cols = ensure_columns(data)
        out: Dict[Layer, DetectionResult] = {}
        for layer, det in self.detectors.items():
            fs = det.featurizer.transform(cols)
            if fs is None or not len(fs.X):
                continue
            scores = det.model.decision_scores(det.std.transform(fs.X))
            out[layer] = DetectionResult(
                layer=layer, flags=scores < det.log_delta, scores=scores,
                log_delta=det.log_delta, steps=fs.steps, ts=fs.ts,
                nodes=fs.nodes)
        return out
