"""PCA / spectral-residual detector over the shared featurisation (port of
`repro/detect/spectral.py`, unchanged: NumPy float64 on the host).

The hardware-telemetry literature (see PAPERS.md) detects infrastructure
anomalies by modelling the *correlation structure* of the telemetry: fit a
principal subspace on clean data, then score new samples by how far they
fall outside it (SPE, the squared prediction error of the residual
subspace) and how extreme they are *inside* it (Hotelling's T^2 over the
retained components). This model does exactly that over the same
`core/features.py` matrices every other family sees:

    score(x) = -( T^2(x) + SPE(x) / s_r )

with ``T^2 = sum_i t_i^2 / lambda_i`` over the retained components and
``s_r`` the mean residual eigenvalue — both terms are scale-normalised, so
the combined statistic is a regularised Mahalanobis distance. Higher =
more normal (repo convention, `repro_torch.detect.families`); the caller
thresholds at the contamination quantile of training scores.

The online path is **incremental**: ``partial_fit`` folds the new window's
mean/covariance into EMA running moments and re-eigendecomposes — the
feature spaces are 3-4 dimensional, so the decomposition is microseconds
and the subspace tracks slow drift continuously instead of refitting cold.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class SpectralResidualModel:
    """Principal-subspace + residual-energy detector over one feature space."""

    def __init__(self, var_target: float = 0.98, blend: float = 0.2,
                 reg: float = 1e-6):
        # smallest leading subspace explaining var_target of the variance is
        # retained; everything else is the residual ("spectral residual")
        self.var_target = float(var_target)
        # EMA weight of partial_fit's covariance fold (incremental update)
        self.blend = float(blend)
        self.reg = float(reg)
        self.mu: Optional[np.ndarray] = None
        self.cov: Optional[np.ndarray] = None
        self.Vq: Optional[np.ndarray] = None  # (D, q) retained components
        self.lam: Optional[np.ndarray] = None  # (q,) retained eigenvalues
        self.s_r = reg  # residual-energy normaliser (mean residual eigval)
        self.q = 0
        self.refreshes = 0

    @property
    def fitted(self) -> bool:
        return self.Vq is not None

    def _decompose(self, cov: np.ndarray) -> None:
        d = cov.shape[0]
        self.cov = cov
        w, V = np.linalg.eigh(cov + self.reg * np.eye(d))
        w, V = w[::-1], V[:, ::-1]  # descending
        w = np.maximum(w, self.reg)
        cum = np.cumsum(w) / w.sum()
        q = int(np.searchsorted(cum, self.var_target) + 1)
        # keep at least one residual dimension when D > 1, so SPE is defined
        self.q = max(1, min(q, d - 1)) if d > 1 else 1
        self.Vq = V[:, :self.q]
        self.lam = w[:self.q]
        resid = w[self.q:]
        self.s_r = max(float(resid.mean()) if resid.size else self.reg,
                       self.reg)

    def fit(self, X: np.ndarray) -> "SpectralResidualModel":
        X = np.asarray(X, dtype=np.float64)
        self.mu = X.mean(axis=0)
        Xc = X - self.mu
        self._decompose((Xc.T @ Xc) / max(1, X.shape[0]))
        return self

    def partial_fit(self, X: np.ndarray) -> None:
        """Incremental subspace update: EMA-fold the window's moments, then
        re-eigendecompose (D <= 4, so this is trivially cheap)."""
        X = np.asarray(X, dtype=np.float64)
        if X.shape[0] == 0:
            return
        if self.mu is None:
            self.fit(X)
            return
        self.mu = self.mu + self.blend * (X.mean(axis=0) - self.mu)
        Xc = X - self.mu
        cov_new = (Xc.T @ Xc) / max(1, X.shape[0])
        self._decompose((1.0 - self.blend) * self.cov + self.blend * cov_new)
        self.refreshes += 1

    def decision_scores(self, X: np.ndarray) -> np.ndarray:
        """Negated (T^2 + SPE/s_r): higher = more normal."""
        X = np.asarray(X, dtype=np.float64)
        if X.shape[0] == 0:
            return np.zeros(0)
        Xc = X - self.mu
        t = Xc @ self.Vq  # (N, q) scores in the retained subspace
        t2 = np.square(t / np.sqrt(self.lam)).sum(axis=1)
        spe = np.square(Xc - t @ self.Vq.T).sum(axis=1)
        return -(t2 + spe / self.s_r)

    def stats(self) -> Dict[str, object]:
        return {"family": "spectral", "q": self.q, "s_r": self.s_r,
                "refreshes": self.refreshes}
