"""Robust per-feature quantile/MAD baseline detector (port of
`repro/detect/robust.py`, unchanged: NumPy float64 on the host).

The cheap reference floor of the bake-off: per-feature median + MAD fitted
on the clean window, score = negated worst robust z-score across features.
Fully vectorised over the `EventTable` feature columns — scoring a window
is one subtract, one divide, and one row-max; there is nothing to compile
and nothing iterative, which is exactly why it anchors the
``detect_ms_per_window`` cost axis of the leaderboard.

Scores follow the repo-wide convention (`repro_torch.detect.families`):
**higher = more normal** (``-max_j |z_j|``), thresholded by the caller at the
contamination quantile of the training scores, so the MAD floor sees the
same threshold policy as every other family.

Streaming (``partial_fit``) blends the fitted centre/scale toward the new
window's robust statistics with a clamped step — the MAD analogue of the
GMM's warm refit: slow benign drift is followed, a burst fault (whose rows
are censored to inliers by the caller anyway) cannot drag the baseline.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

# MAD of a normal sample estimates sigma / 1.4826
_MAD_TO_SIGMA = 1.4826


def _robust_stats(X: np.ndarray) -> tuple:
    """(median, scale) per feature; scale falls back MAD -> std -> 1 so a
    feature that is constant in the window (e.g. a fixed message size)
    cannot produce infinite z-scores."""
    med = np.median(X, axis=0)
    mad = _MAD_TO_SIGMA * np.median(np.abs(X - med), axis=0)
    std = X.std(axis=0)
    scale = np.where(mad > 1e-9, mad, np.where(std > 1e-9, std, 1.0))
    return med, scale


class RobustMADModel:
    """Per-feature median/MAD envelope over one feature space."""

    def __init__(self, blend: float = 0.2):
        # partial_fit step: fraction of the gap to the new window's robust
        # stats folded in per sweep (clamped drift tracking)
        self.blend = float(blend)
        self.med: Optional[np.ndarray] = None
        self.scale: Optional[np.ndarray] = None
        self.refreshes = 0

    @property
    def fitted(self) -> bool:
        return self.med is not None

    def fit(self, X: np.ndarray) -> "RobustMADModel":
        X = np.asarray(X, dtype=np.float64)
        self.med, self.scale = _robust_stats(X)
        return self

    def partial_fit(self, X: np.ndarray) -> None:
        X = np.asarray(X, dtype=np.float64)
        if X.shape[0] == 0:
            return
        if self.med is None:
            self.fit(X)
            return
        med, scale = _robust_stats(X)
        self.med = self.med + self.blend * (med - self.med)
        self.scale = np.maximum(
            self.scale + self.blend * (scale - self.scale), 1e-9)
        self.refreshes += 1

    def decision_scores(self, X: np.ndarray) -> np.ndarray:
        """Negated worst per-feature robust z: higher = more normal."""
        X = np.asarray(X, dtype=np.float64)
        if X.shape[0] == 0:
            return np.zeros(0)
        z = np.abs((X - self.med) / self.scale)
        return -z.max(axis=1)

    def stats(self) -> Dict[str, object]:
        return {"family": "mad", "refreshes": self.refreshes,
                "scale_min": (float(self.scale.min())
                              if self.scale is not None else None)}
