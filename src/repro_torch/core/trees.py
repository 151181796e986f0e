"""Vectorised histogram-based decision trees (shared by the RandomForest and
gradient-boosting baselines of paper Table I). Pure numpy; array-encoded trees
with batched traversal. Port of `repro/core/trees.py`, unchanged in its
arithmetic."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Tree:
    feature: np.ndarray  # (nodes,) int32, -1 = leaf
    threshold: np.ndarray  # (nodes,) float64
    left: np.ndarray  # (nodes,) int32
    right: np.ndarray  # (nodes,) int32
    value: np.ndarray  # (nodes,) float64 leaf prediction

    def predict(self, X: np.ndarray) -> np.ndarray:
        node = np.zeros(X.shape[0], dtype=np.int32)
        for _ in range(64):  # bounded depth
            feat = self.feature[node]
            interior = feat >= 0
            if not interior.any():
                break
            go_left = np.zeros_like(interior)
            go_left[interior] = (X[interior, feat[interior]]
                                 <= self.threshold[node[interior]])
            node = np.where(interior, np.where(go_left, self.left[node],
                                               self.right[node]), node)
        return self.value[node]


def _quantile_bins(X: np.ndarray, n_bins: int) -> np.ndarray:
    qs = np.linspace(0, 1, n_bins + 1)[1:-1]
    return np.quantile(X, qs, axis=0)  # (n_bins-1, D)


def build_tree(X: np.ndarray, grad: np.ndarray, hess: np.ndarray, *,
               max_depth: int = 6, min_leaf: int = 8, n_bins: int = 32,
               reg_lambda: float = 1.0, feature_frac: float = 1.0,
               rng: Optional[np.random.Generator] = None) -> Tree:
    """Newton-boosted regression tree: split gain on (grad, hess) stats.

    For classification trees pass grad = residual targets, hess = ones
    (then leaves are mean targets -> CART regression on class indicator).
    """
    rng = rng or np.random.default_rng(0)
    N, D = X.shape
    bins = _quantile_bins(X, n_bins)  # (B-1, D)
    codes = np.stack([np.searchsorted(bins[:, j], X[:, j]) for j in range(D)],
                     axis=1).astype(np.int32)  # (N, D) in [0, B-1]

    feature = [-1]
    threshold = [0.0]
    left = [-1]
    right = [-1]
    value = [0.0]
    stack = [(0, np.arange(N), 0)]  # (node_id, sample idx, depth)

    while stack:
        nid, idx, depth = stack.pop()
        g, h = grad[idx], hess[idx]
        G, H = g.sum(), h.sum()
        value[nid] = -G / (H + reg_lambda)
        if depth >= max_depth or len(idx) < 2 * min_leaf:
            continue
        feats = np.arange(D)
        if feature_frac < 1.0:
            k = max(1, int(D * feature_frac))
            feats = rng.choice(D, k, replace=False)
        best_gain, best = 0.0, None
        base = G * G / (H + reg_lambda)
        for j in feats:
            c = codes[idx, j]
            gs = np.bincount(c, weights=g, minlength=len(bins) + 1)
            hs = np.bincount(c, weights=h, minlength=len(bins) + 1)
            ns = np.bincount(c, minlength=len(bins) + 1)
            gl, hl, nl = np.cumsum(gs)[:-1], np.cumsum(hs)[:-1], np.cumsum(ns)[:-1]
            gr, hr, nr = G - gl, H - hl, len(idx) - nl
            ok = (nl >= min_leaf) & (nr >= min_leaf)
            gain = np.where(
                ok,
                gl * gl / (hl + reg_lambda) + gr * gr / (hr + reg_lambda) - base,
                -np.inf)
            b = int(np.argmax(gain))
            if gain[b] > best_gain:
                best_gain, best = float(gain[b]), (int(j), b)
        if best is None:
            continue
        j, b = best
        thr = bins[b, j]
        mask = X[idx, j] <= thr
        li, ri = idx[mask], idx[~mask]
        if not len(li) or not len(ri):
            continue
        lid, rid = len(feature), len(feature) + 1
        feature.extend([-1, -1]); threshold.extend([0.0, 0.0])
        left.extend([-1, -1]); right.extend([-1, -1]); value.extend([0.0, 0.0])
        feature[nid], threshold[nid] = j, float(thr)
        left[nid], right[nid] = lid, rid
        stack.append((lid, li, depth + 1))
        stack.append((rid, ri, depth + 1))

    return Tree(np.array(feature, np.int32), np.array(threshold),
                np.array(left, np.int32), np.array(right, np.int32),
                np.array(value))
