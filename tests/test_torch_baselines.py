"""The Table I baselines of the port (`repro_torch.core.{baselines,trees}`):
the reference's sanity cases (`tests/test_baselines.py`) on the port, and
parity with `repro.core.baselines` on the same NumPy inputs — every
detector's scores and predictions, and the trees' predictions, equal."""
import numpy as np
import pytest

from repro.core import baselines as jbaselines
from repro.core import trees as jtrees
from repro_torch.core import baselines, trees
from repro_torch.core.baselines import evaluate, make_detectors

NAMES = ["KMeans", "IsolationForest", "DBSCAN", "XGBoost", "SVM",
         "RandomForest"]


def planted(n=1200, frac=1 / 6, seed=0):
    """Normal points in a tight gaussian; anomalies scattered uniformly
    (the reference test's data)."""
    rng = np.random.default_rng(seed)
    n_anom = int(n * frac)
    X_norm = rng.normal(0, 1, (n - n_anom, 3))
    X_anom = rng.uniform(-8, 8, (n_anom, 3))
    keep = np.linalg.norm(X_anom, axis=1) > 3.5  # keep true outliers only
    X_anom = np.where(keep[:, None], X_anom,
                      X_anom + np.sign(X_anom) * 4)
    X = np.concatenate([X_norm, X_anom])
    y = np.concatenate([np.zeros(n - n_anom), np.ones(n_anom)])
    idx = rng.permutation(n)
    return X[idx], y[idx]


def fit(det, X, y):
    try:
        return det.fit(X, y)
    except TypeError:  # the unsupervised detectors take no labels
        return det.fit(X)


@pytest.mark.parametrize("name", NAMES)
def test_detector_beats_chance(name):
    X, y = planted()
    det = fit(make_detectors(contamination=float(y.mean()))[name], X, y)
    m = evaluate(det.predict(X), y)
    assert m["accuracy"] > 0.8, (name, m)
    assert m["recall"] > 0.5, (name, m)


@pytest.mark.parametrize("name", NAMES)
def test_detector_matches_the_reference(name):
    """Fitted on one seed's data and scored on another's, the port's
    detector gives the reference's scores, threshold and flags exactly."""
    X, y = planted(n=600, seed=1)
    Xt, _ = planted(n=300, seed=2)
    c = float(y.mean())
    mine = fit(make_detectors(contamination=c, seed=3)[name], X, y)
    theirs = fit(jbaselines.make_detectors(contamination=c, seed=3)[name],
                 X, y)
    assert type(mine).__name__ == type(theirs).__name__
    assert mine.threshold == theirs.threshold
    np.testing.assert_array_equal(mine.scores(Xt), theirs.scores(Xt))
    np.testing.assert_array_equal(mine.predict(Xt), theirs.predict(Xt))
    assert np.isfinite(mine.scores(Xt)).all()


def test_evaluate_math():
    pred = np.array([1, 1, 0, 0], bool)
    truth = np.array([1, 0, 1, 0], bool)
    m = evaluate(pred, truth)
    assert m["accuracy"] == 0.5
    assert m["recall"] == 0.5
    assert m["precision"] == 0.5
    assert abs(m["f1"] - 0.5) < 1e-9
    assert m == jbaselines.evaluate(pred, truth)


def test_evaluate_perfect():
    y = np.array([1, 0, 1, 0], bool)
    m = evaluate(y, y)
    assert m["accuracy"] == m["recall"] == m["f1"] == 1.0


def test_trees_predict_shapes():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(500, 4))
    y = (X[:, 0] > 0.5).astype(float)
    t = trees.build_tree(X, grad=-y, hess=np.ones(500), max_depth=4)
    pred = t.predict(X)
    assert pred.shape == (500,)
    # tree must split on the informative feature
    assert (pred[X[:, 0] > 0.5].mean()) > (pred[X[:, 0] <= 0.5].mean())


@pytest.mark.parametrize("feature_frac", [1.0, 0.5])
def test_tree_matches_the_reference(feature_frac):
    """Newton statistics and a feature subsample from one seed: the same
    nodes, thresholds and leaf values, so the same predictions."""
    rng = np.random.default_rng(4)
    X = rng.normal(size=(400, 5))
    y = (X[:, 1] + 0.3 * X[:, 3] > 0.2).astype(float)
    grad, hess = -y + 0.1 * rng.normal(size=400), rng.uniform(0.5, 1.5, 400)
    kw = dict(max_depth=5, min_leaf=6, n_bins=16, feature_frac=feature_frac)
    mine = trees.build_tree(X, grad, hess, rng=np.random.default_rng(5),
                            **kw)
    theirs = jtrees.build_tree(X, grad, hess, rng=np.random.default_rng(5),
                               **kw)
    for k in ("feature", "threshold", "left", "right", "value"):
        np.testing.assert_array_equal(getattr(mine, k), getattr(theirs, k))
    Xt = rng.normal(size=(200, 5))
    np.testing.assert_array_equal(mine.predict(Xt), theirs.predict(Xt))
    assert len(mine.feature) > 1  # it split


def test_baselines_standardize_with_the_port_s_features():
    det = baselines.KMeansDetector(k=3)
    from repro_torch.core.features import Standardizer

    assert isinstance(det.std, Standardizer)
