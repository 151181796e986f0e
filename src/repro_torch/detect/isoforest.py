"""Extended isolation ensemble: vectorised isolation-forest scoring (port
of `repro/detect/isoforest.py`, unchanged: NumPy float64 on the host, so
the same seed grows the same trees).

The paper's Table-I IsolationForest baseline (the JAX package's
`repro/core/baselines.py`, not ported yet) walks Python dict trees per
row — fine for an offline table, unusable per window. This is the
production variant behind the ``isoforest`` detector backend:

* **extended** splits (Hariri et al.): each internal node cuts along a
  random *hyperplane* (unit normal + offset drawn from the projected data
  range), not an axis — axis-parallel iForests leave "ghost" low-score
  bands along the axes of normal clusters;
* **array trees**: every tree is a complete binary tree stored as flat
  arrays (normal, offset, leaf path length), so scoring walks all trees
  level-by-level with NumPy gathers — no per-row recursion;
* **warm-started tree reuse** for streaming: ``partial_fit`` rebuilds only
  the oldest ``refresh_frac`` of the ensemble on the new window and keeps
  the rest, the forest analogue of the GMM's warm EM refit. A full ``fit``
  is the cold refit.

Scores follow the repo-wide convention (see `repro_torch.detect.families`):
**higher = more normal**. ``decision_scores`` returns the *negated*
iForest anomaly score ``-2^(-E[h(x)]/c(psi))``, so callers threshold with
``flags = scores < quantile(train_scores, contamination)`` exactly as they
do for the GMM's log-density.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np

_EULER = 0.5772156649015329
# score in row blocks: the level walk gathers an (N, T, D) normal tensor,
# and an unbounded N over a 65k-row window would allocate tens of MB per
# level for no speedup
_SCORE_BLOCK = 4096


def c_factor(n: int) -> float:
    """Average unsuccessful-search path length of a BST over ``n`` points —
    the iForest normaliser AND the leaf adjustment for unsplit subsets."""
    if n <= 1:
        return 0.0
    if n == 2:
        return 1.0
    h = math.log(n - 1.0) + _EULER
    return 2.0 * h - 2.0 * (n - 1.0) / n


@dataclasses.dataclass
class _Tree:
    """One extended isolation tree as a complete binary tree in arrays.

    Node ``i`` has children ``2i+1``/``2i+2``; ``internal`` marks split
    nodes, ``path`` holds the termination path length (depth + c(count)) at
    leaves and is 0 elsewhere."""

    W: np.ndarray  # (n_nodes, D) split normals (zero rows at leaves)
    b: np.ndarray  # (n_nodes,) split offsets
    internal: np.ndarray  # (n_nodes,) bool
    path: np.ndarray  # (n_nodes,) float64
    depth: int


def build_tree(X: np.ndarray, rng: np.random.Generator,
               max_depth: int) -> _Tree:
    n_nodes = 2 ** (max_depth + 1) - 1
    d = X.shape[1]
    W = np.zeros((n_nodes, d))
    b = np.zeros(n_nodes)
    internal = np.zeros(n_nodes, dtype=bool)
    path = np.zeros(n_nodes)

    def grow(node: int, idx: np.ndarray, depth: int) -> None:
        n = idx.shape[0]
        if depth >= max_depth or n <= 1:
            path[node] = depth + c_factor(n)
            return
        w = rng.standard_normal(d)
        w /= max(float(np.linalg.norm(w)), 1e-12)
        proj = X[idx] @ w
        lo, hi = float(proj.min()), float(proj.max())
        if hi - lo <= 1e-12:  # all points identical along every drawn plane
            path[node] = depth + c_factor(n)
            return
        thr = rng.uniform(lo, hi)
        left = proj < thr
        if not left.any() or left.all():
            path[node] = depth + c_factor(n)
            return
        internal[node] = True
        W[node] = w
        b[node] = thr
        grow(2 * node + 1, idx[left], depth + 1)
        grow(2 * node + 2, idx[~left], depth + 1)

    grow(0, np.arange(X.shape[0]), 0)
    return _Tree(W=W, b=b, internal=internal, path=path, depth=max_depth)


class IsolationEnsemble:
    """Warm-startable extended isolation forest over one feature space."""

    def __init__(self, n_trees: int = 64, subsample: int = 256,
                 refresh_frac: float = 0.25, seed: int = 0):
        self.n_trees = int(n_trees)
        self.subsample = int(subsample)
        # streaming refresh: fraction of the ensemble rebuilt per
        # partial_fit (the rest is REUSED — tree-level warm start)
        self.refresh_frac = float(refresh_frac)
        self._rng = np.random.default_rng(seed)
        self._trees: List[_Tree] = []
        self._age: List[int] = []  # build counter per tree (oldest first out)
        self._builds = 0
        self._cn = 1.0  # c(psi) score normaliser, fixed at fit
        self._depth = 8
        self.refreshes = 0

    @property
    def fitted(self) -> bool:
        return bool(self._trees)

    def _sample(self, X: np.ndarray, k: int) -> np.ndarray:
        n = X.shape[0]
        if n <= k:
            return X
        return X[self._rng.choice(n, size=k, replace=False)]

    def _build(self, X: np.ndarray, k: int) -> _Tree:
        t = build_tree(self._sample(X, k), self._rng, self._depth)
        self._builds += 1
        return t

    def fit(self, X: np.ndarray) -> "IsolationEnsemble":
        """Cold fit: build the whole ensemble on subsamples of ``X``."""
        X = np.asarray(X, dtype=np.float64)
        k = min(self.subsample, max(2, X.shape[0]))
        self._cn = max(c_factor(k), 1e-9)
        self._depth = max(1, int(math.ceil(math.log2(max(2, k)))))
        self._trees = [self._build(X, k) for _ in range(self.n_trees)]
        self._age = list(range(self.n_trees))
        return self

    def partial_fit(self, X: np.ndarray) -> None:
        """Warm refresh: rebuild the ``refresh_frac`` OLDEST trees on the
        new (assumed inlier) sample; the remaining trees are reused as-is.
        Tracks slow drift at a fraction of a cold fit's cost."""
        if not self._trees:
            self.fit(X)
            return
        X = np.asarray(X, dtype=np.float64)
        if X.shape[0] < 2:
            return
        k = min(self.subsample, X.shape[0])
        n_new = max(1, int(round(self.refresh_frac * len(self._trees))))
        for i in np.argsort(self._age)[:n_new]:
            self._trees[i] = self._build(X, k)
            self._age[i] = self._builds
        self.refreshes += 1

    def _paths(self, X: np.ndarray) -> np.ndarray:
        """Mean termination path length per row, all trees walked jointly
        one level at a time (gather normals of the current node per
        (row, tree), project, descend)."""
        T = len(self._trees)
        W = np.stack([t.W for t in self._trees])  # (T, n_nodes, D)
        b = np.stack([t.b for t in self._trees])
        internal = np.stack([t.internal for t in self._trees])
        path = np.stack([t.path for t in self._trees])
        tidx = np.arange(T)[None, :]
        N = X.shape[0]
        node = np.zeros((N, T), dtype=np.int64)
        for _ in range(self._depth):
            live = internal[tidx, node]
            if not live.any():
                break
            w = W[tidx, node]  # (N, T, D)
            proj = np.einsum("ntd,nd->nt", w, X)
            child = np.where(proj < b[tidx, node], 2 * node + 1, 2 * node + 2)
            node = np.where(live, child, node)
        return path[tidx, node].mean(axis=1)

    def decision_scores(self, X: np.ndarray) -> np.ndarray:
        """Negated iForest anomaly score: higher = more normal, in (-1, 0)."""
        X = np.asarray(X, dtype=np.float64)
        if X.shape[0] == 0 or not self._trees:
            return np.zeros(X.shape[0])
        out = np.empty(X.shape[0])
        for lo in range(0, X.shape[0], _SCORE_BLOCK):
            block = X[lo:lo + _SCORE_BLOCK]
            out[lo:lo + block.shape[0]] = self._paths(block)
        return -np.power(2.0, -out / self._cn)

    def stats(self) -> Dict[str, object]:
        return {"family": "isoforest", "trees": len(self._trees),
                "depth": self._depth, "builds": self._builds,
                "refreshes": self.refreshes}
