"""Baseline detectors for paper Table I: KMeans, Isolation Forest, DBSCAN,
XGBoost(-style gradient boosting), SVM, Random Forest — implemented from
scratch in NumPy/SciPy (no sklearn); port of `repro/core/baselines.py`,
the same arithmetic, so the same seeds give the same scores.

Common protocol:
    det.fit(X, y=None)           # y used only by the supervised methods
    det.scores(X) -> (N,)        # higher = more anomalous
    det.predict(X) -> bool (N,)  # thresholded at the shared contamination rate

Unsupervised methods calibrate their threshold at the contamination quantile
of the training scores — the same policy the GMM detector uses, so Table I
compares models, not thresholds.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph

from repro_torch.core.features import Standardizer
from repro_torch.core.trees import build_tree


class _Base:
    contamination: float = 1 / 6
    threshold: Optional[float] = None

    def _calibrate(self, train_scores: np.ndarray) -> None:
        self.threshold = float(np.quantile(train_scores, 1 - self.contamination))

    def predict(self, X: np.ndarray) -> np.ndarray:
        return self.scores(X) > self.threshold


# ---------------------------------------------------------------------------


class KMeansDetector(_Base):
    """Lloyd's algorithm + kmeans++ init; score = distance to nearest centroid."""

    def __init__(self, k: int = 8, iters: int = 50, seed: int = 0,
                 contamination: float = 1 / 6):
        self.k, self.iters, self.seed = k, iters, seed
        self.contamination = contamination
        self.std = Standardizer()

    def _pp_init(self, X, rng):
        C = [X[rng.integers(len(X))]]
        for _ in range(self.k - 1):
            d2 = np.min(((X[:, None] - np.array(C)[None]) ** 2).sum(-1), axis=1)
            p = d2 / d2.sum()
            C.append(X[rng.choice(len(X), p=p)])
        return np.array(C)

    def fit(self, X, y=None):
        X = self.std.fit_transform(X)
        rng = np.random.default_rng(self.seed)
        sub = X[rng.choice(len(X), min(len(X), 20000), replace=False)]
        C = self._pp_init(sub, rng)
        for _ in range(self.iters):
            d = ((sub[:, None] - C[None]) ** 2).sum(-1)
            a = d.argmin(1)
            newC = np.array([sub[a == j].mean(0) if (a == j).any() else C[j]
                             for j in range(self.k)])
            if np.allclose(newC, C, atol=1e-6):
                break
            C = newC
        self.C = C
        self._calibrate(self.scores_raw(X))
        return self

    def scores_raw(self, Xs):
        return np.sqrt(((Xs[:, None] - self.C[None]) ** 2).sum(-1).min(1))

    def scores(self, X):
        return self.scores_raw(self.std.transform(X))


class IsolationForestDetector(_Base):
    """Liu et al. 2008: random trees on subsamples; score = 2^(-E[path]/c(n))."""

    def __init__(self, n_trees: int = 100, subsample: int = 256, seed: int = 0,
                 contamination: float = 1 / 6):
        self.n_trees, self.subsample, self.seed = n_trees, subsample, seed
        self.contamination = contamination

    @staticmethod
    def _c(n):
        if n <= 1:
            return 0.0
        return 2 * (np.log(n - 1) + 0.5772156649) - 2 * (n - 1) / n

    def _build(self, X, rng, depth, max_depth):
        n = len(X)
        if depth >= max_depth or n <= 1:
            return {"leaf": True, "adj": self._c(n)}
        j = rng.integers(X.shape[1])
        lo, hi = X[:, j].min(), X[:, j].max()
        if lo == hi:
            return {"leaf": True, "adj": self._c(n)}
        t = rng.uniform(lo, hi)
        m = X[:, j] <= t
        return {"leaf": False, "j": j, "t": t,
                "l": self._build(X[m], rng, depth + 1, max_depth),
                "r": self._build(X[~m], rng, depth + 1, max_depth)}

    def fit(self, X, y=None):
        rng = np.random.default_rng(self.seed)
        n = min(self.subsample, len(X))
        max_depth = int(np.ceil(np.log2(max(n, 2))))
        self.trees = [self._build(X[rng.choice(len(X), n, replace=False)],
                                  rng, 0, max_depth)
                      for _ in range(self.n_trees)]
        self.c_n = self._c(n)
        self._calibrate(self.scores(X))
        return self

    def _path(self, tree, X, depth=0):
        out = np.zeros(len(X))
        if tree["leaf"] or len(X) == 0:
            return np.full(len(X), depth + tree.get("adj", 0.0))
        m = X[:, tree["j"]] <= tree["t"]
        out[m] = self._path(tree["l"], X[m], depth + 1)
        out[~m] = self._path(tree["r"], X[~m], depth + 1)
        return out

    def scores(self, X):
        paths = np.mean([self._path(t, X) for t in self.trees], axis=0)
        return 2.0 ** (-paths / max(self.c_n, 1e-9))


class DBSCANDetector(_Base):
    """Ester et al. 1996 on a subsample (blocked pairwise distances + sparse
    connected components); outside points scored by distance to nearest core."""

    def __init__(self, eps: Optional[float] = None, min_pts: int = 8,
                 max_n: int = 8000, seed: int = 0, contamination: float = 1 / 6):
        self.eps, self.min_pts, self.max_n, self.seed = eps, min_pts, max_n, seed
        self.contamination = contamination
        self.std = Standardizer()

    def fit(self, X, y=None):
        Xs = self.std.fit_transform(X)
        rng = np.random.default_rng(self.seed)
        sub = Xs[rng.choice(len(Xs), min(len(Xs), self.max_n), replace=False)]
        if self.eps is None:  # median 4-NN distance heuristic
            d = np.sqrt(((sub[:500, None] - sub[None, :]) ** 2).sum(-1))
            self.eps = float(np.median(np.sort(d, axis=1)[:, self.min_pts]))
        n = len(sub)
        rows, cols = [], []
        block = 1024
        counts = np.zeros(n, np.int32)
        for i in range(0, n, block):
            d = np.sqrt(((sub[i:i + block, None] - sub[None]) ** 2).sum(-1))
            r, c = np.nonzero(d <= self.eps)
            rows.append(r + i)
            cols.append(c)
            counts[i:i + block] = (d <= self.eps).sum(1)
        core = counts >= self.min_pts
        r = np.concatenate(rows)
        c = np.concatenate(cols)
        keep = core[r] & core[c]
        g = sp.coo_matrix((np.ones(keep.sum()), (r[keep], c[keep])), shape=(n, n))
        _, labels = csgraph.connected_components(g.tocsr(), directed=False)
        labels = np.where(core, labels, -1)
        self.cores = sub[core] if core.any() else sub
        self._calibrate(self.scores(X))
        return self

    def scores(self, X):
        Xs = self.std.transform(X)
        out = np.empty(len(Xs))
        for i in range(0, len(Xs), 2048):
            d = np.sqrt(((Xs[i:i + 2048, None] - self.cores[None]) ** 2).sum(-1))
            out[i:i + 2048] = d.min(1)
        return out / max(self.eps, 1e-9)


class SVMDetector(_Base):
    """Linear SVM (hinge loss, Pegasos SGD) on random Fourier features
    (≈ RBF SVM). Supervised, like the paper's SVM row."""

    def __init__(self, n_features: int = 128, gamma: float = 0.5,
                 epochs: int = 20, lam: float = 1e-4, seed: int = 0,
                 contamination: float = 1 / 6):
        self.R, self.gamma, self.epochs, self.lam, self.seed = (
            n_features, gamma, epochs, lam, seed)
        self.contamination = contamination
        self.std = Standardizer()

    def _phi(self, X):
        return np.sqrt(2.0 / self.R) * np.cos(X @ self.W + self.b)

    def fit(self, X, y=None):
        Xs = self.std.fit_transform(X)
        rng = np.random.default_rng(self.seed)
        D = Xs.shape[1]
        self.W = rng.normal(0, np.sqrt(2 * self.gamma), (D, self.R))
        self.b = rng.uniform(0, 2 * np.pi, self.R)
        Z = self._phi(Xs)
        t = np.where(y > 0, 1.0, -1.0) if y is not None else -np.ones(len(Xs))
        # class-balanced hinge SGD
        w = np.zeros(self.R)
        bias = 0.0
        pos_w = (len(t) / max((t > 0).sum(), 1)) if y is not None else 1.0
        step = 0
        for _ in range(self.epochs):
            order = rng.permutation(len(Z))
            for i0 in range(0, len(order), 256):
                idx = order[i0:i0 + 256]
                step += 1
                eta = 1.0 / (self.lam * step)
                zi, ti = Z[idx], t[idx]
                margin = ti * (zi @ w + bias)
                viol = margin < 1
                cw = np.where(ti > 0, pos_w, 1.0) * viol
                w = (1 - eta * self.lam) * w + eta * (cw * ti) @ zi / len(idx)
                bias += eta * np.mean(cw * ti)
        self.w, self.bias = w, bias
        self._calibrate(self.scores(X))
        return self

    def scores(self, X):
        return self._phi(self.std.transform(X)) @ self.w + self.bias


class RandomForestDetector(_Base):
    """Bagged CART trees on class indicators (supervised)."""

    def __init__(self, n_trees: int = 50, max_depth: int = 8, seed: int = 0,
                 contamination: float = 1 / 6):
        self.n_trees, self.max_depth, self.seed = n_trees, max_depth, seed
        self.contamination = contamination

    def fit(self, X, y):
        rng = np.random.default_rng(self.seed)
        n = len(X)
        pos_frac = max(y.mean(), 1e-6)
        w = np.where(y > 0, 0.5 / pos_frac, 0.5 / (1 - pos_frac))
        self.trees = []
        for _ in range(self.n_trees):
            idx = rng.choice(n, n, replace=True)
            t = build_tree(X[idx], grad=-(w[idx] * y[idx].astype(float)),
                           hess=w[idx], max_depth=self.max_depth,
                           feature_frac=0.7, rng=rng)
            self.trees.append(t)
        self._calibrate(self.scores(X))
        return self

    def scores(self, X):
        return np.mean([t.predict(X) for t in self.trees], axis=0)


class GradientBoostingDetector(_Base):
    """XGBoost-style Newton boosting with logistic loss (supervised)."""

    def __init__(self, n_rounds: int = 100, max_depth: int = 3, lr: float = 0.1,
                 seed: int = 0, contamination: float = 1 / 6):
        self.n_rounds, self.max_depth, self.lr, self.seed = (
            n_rounds, max_depth, lr, seed)
        self.contamination = contamination

    def fit(self, X, y):
        rng = np.random.default_rng(self.seed)
        n = len(X)
        pos_frac = max(y.mean(), 1e-6)
        sw = np.where(y > 0, 0.5 / pos_frac, 0.5 / (1 - pos_frac))
        f = np.zeros(n)
        self.trees = []
        for _ in range(self.n_rounds):
            p = 1.0 / (1.0 + np.exp(-f))
            grad = sw * (p - y)
            hess = sw * np.maximum(p * (1 - p), 1e-6)
            t = build_tree(X, grad, hess, max_depth=self.max_depth, rng=rng)
            self.trees.append(t)
            f += self.lr * t.predict(X)
        self._calibrate(self.scores(X))
        return self

    def scores(self, X):
        f = np.zeros(len(X))
        for t in self.trees:
            f += self.lr * t.predict(X)
        return f


def make_detectors(contamination: float = 1 / 6, seed: int = 0) -> Dict[str, object]:
    """The Table-I lineup (GMM is added by the benchmark itself)."""
    return {
        "KMeans": KMeansDetector(seed=seed, contamination=contamination),
        "IsolationForest": IsolationForestDetector(seed=seed,
                                                   contamination=contamination),
        "DBSCAN": DBSCANDetector(seed=seed, contamination=contamination),
        "XGBoost": GradientBoostingDetector(seed=seed,
                                            contamination=contamination),
        "SVM": SVMDetector(seed=seed, contamination=contamination),
        "RandomForest": RandomForestDetector(seed=seed,
                                             contamination=contamination),
    }


def evaluate(pred: np.ndarray, truth: np.ndarray) -> Dict[str, float]:
    pred = pred.astype(bool)
    truth = truth.astype(bool)
    tp = float(np.sum(pred & truth))
    fp = float(np.sum(pred & ~truth))
    fn = float(np.sum(~pred & truth))
    acc = float(np.mean(pred == truth))
    prec = tp / max(tp + fp, 1e-9)
    rec = tp / max(tp + fn, 1e-9)
    f1 = 2 * prec * rec / max(prec + rec, 1e-9)
    return {"accuracy": acc, "recall": rec, "precision": prec, "f1": f1}
