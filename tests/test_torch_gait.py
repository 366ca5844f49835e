"""The port's gait study (`apps/gait.py`) against the JAX package's, and its numpy forest (`apps/forest.py`) against
sklearn, on the CPU.

- `smooth_track`, `gait_features` and `group_stats` equal to the JAX functions within 1e-12 on seeded walkers
  (`tests/test_gait.py:make_walker`; `chip_smoke.make_walker` is its copy).
- The forest against sklearn 1.9's `RandomForestClassifier(n_estimators, random_state=seed)` and
  `cross_val_score(clf, X, y, cv=3)` on seeded gait studies of 2 and 3 groups, 12 to 40 tracks, n_estimators 10 and
  200: the stratified test folds, each fold's predictions on its test fold, the cv accuracies and the full fit's
  predictions exactly, its probabilities and every tree's splits exactly, `feature_importances_` within 1e-12.
- `GaitStudy.run`'s whole report equal to the JAX one's.
"""

import numpy as np
import pytest
from sklearn.ensemble import RandomForestClassifier as SkForest
from sklearn.model_selection import StratifiedKFold, cross_val_score as sk_cross_val_score

from chip_smoke import make_walker as smoke_walker
from drone_yolo_tpu.apps import gait as jax_gait
from drone_yolo_tpu_torch.apps import GaitStudy, forest, gait
from test_gait import make_walker

TOL = 1e-12
# (groups, tracks, seed, n_estimators)
STUDIES = [(2, 12, 0, 10), (2, 28, 1, 200), (3, 18, 2, 10), (3, 30, 3, 200), (2, 40, 4, 10), (3, 24, 5, 10),
           (3, 15, 6, 10)]


def study(groups: int, n: int, seed: int):
    """Walkers of `groups` groups, each group a cadence and speed of its own: ({tid: kpts}, {tid: group})."""
    rng = np.random.default_rng(seed)
    tracks, labels = {}, {}
    for i in range(n):
        g = i % groups
        tracks[i] = make_walker(rng, n_frames=int(rng.integers(60, 121)), cadence=rng.normal(1.6 + 0.3 * g, 0.15),
                                speed=rng.normal(70 + 15 * g, 8))
        labels[i] = ("old", "young", "child")[g]
    return tracks, labels


def test_features_and_stats_equal_jax():
    tracks, labels = study(3, 12, 7)
    assert np.array_equal(smoke_walker(np.random.default_rng(3)), make_walker(np.random.default_rng(3)))
    feats, jfeats = [], []
    for tid, k in tracks.items():
        np.testing.assert_allclose(gait.smooth_track(k), jax_gait.smooth_track(k), rtol=0, atol=TOL)
        np.testing.assert_allclose(gait.smooth_track(k, 50.0), jax_gait.smooth_track(k, 50.0), rtol=0, atol=TOL)
        for smooth in (True, False):
            got, want = gait.gait_features(k, fps=25.0, gsd=0.04, smooth=smooth), \
                jax_gait.gait_features(k, fps=25.0, gsd=0.04, smooth=smooth)
            assert list(got) == list(want) == list(gait.FEATURE_NAMES)
            np.testing.assert_allclose([got[n] for n in got], [want[n] for n in want], rtol=0, atol=TOL)
        feats.append(gait.gait_features(k))
        jfeats.append(jax_gait.gait_features(k))
    short = make_walker(np.random.default_rng(0), n_frames=6)
    np.testing.assert_array_equal(gait.smooth_track(short), jax_gait.smooth_track(short))  # too short to smooth
    a, b = np.linspace(0, 1, 20)[:, None] * [1, 2], np.zeros((20, 2))
    np.testing.assert_allclose(gait._angle(a, b, a[::-1]), jax_gait._angle(a, b, a[::-1]), rtol=0, atol=TOL)
    assert gait._oscillation(np.zeros(30), 30.0) == jax_gait._oscillation(np.zeros(30), 30.0) == (0.0, 0.0)
    got, want = gait.group_stats(feats, list(labels.values())), jax_gait.group_stats(jfeats, list(labels.values()))
    assert list(got) == list(want) and len(got) > 0
    for name in got:
        assert got[name]["group_means"].keys() == want[name]["group_means"].keys()
        np.testing.assert_allclose([got[name][k] for k in ("anova_F", "anova_p", "kruskal_H", "kruskal_p")],
                                   [want[name][k] for k in ("anova_F", "anova_p", "kruskal_H", "kruskal_p")],
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(list(got[name]["group_means"].values()),
                                   list(want[name]["group_means"].values()), rtol=0, atol=TOL)


@pytest.mark.parametrize("groups,n,seed,n_estimators", STUDIES)
def test_forest_equals_sklearn(groups, n, seed, n_estimators):
    tracks, labels = study(groups, n, seed)
    x = np.array([[f[k] for k in gait.FEATURE_NAMES] for f in map(gait.gait_features, tracks.values())])
    y = np.array(list(labels.values()))
    folds = forest.stratified_test_folds(y, 3)
    sk_folds = [test for _, test in StratifiedKFold(3).split(x, y)]
    assert [list(np.flatnonzero(folds == i)) for i in range(3)] == [list(t) for t in sk_folds]
    scores = []
    for i in range(3):  # each fold's forest and its predictions on the fold
        test = folds == i
        got = forest.RandomForestClassifier(n_estimators, seed).fit(x[~test], y[~test])
        want = SkForest(n_estimators=n_estimators, random_state=seed).fit(x[~test], y[~test])
        np.testing.assert_array_equal(got.predict(x[test]), want.predict(x[test]))
        scores.append(got.score(x[test], y[test]))
    want_scores = sk_cross_val_score(SkForest(n_estimators=n_estimators, random_state=seed), x, y, cv=3)
    np.testing.assert_array_equal(scores, want_scores)
    if n_estimators < 100:  # cross_val_score fits the same fold forests again: at 10 trees only, for time
        np.testing.assert_array_equal(
            forest.cross_val_score(forest.RandomForestClassifier(n_estimators, seed), x, y), want_scores)
    got = forest.RandomForestClassifier(n_estimators, seed).fit(x, y)
    want = SkForest(n_estimators=n_estimators, random_state=seed).fit(x, y)
    for g, w in zip(got.estimators_, want.estimators_):  # every tree's splits
        np.testing.assert_array_equal(g.feature, w.tree_.feature)
        np.testing.assert_array_equal(g.threshold, w.tree_.threshold)
        np.testing.assert_array_equal(g.left, w.tree_.children_left)
    probe = np.concatenate([x, x + np.random.default_rng(seed).normal(0, x.std(0) * 0.3, x.shape)])
    np.testing.assert_array_equal(got.classes_, want.classes_)
    np.testing.assert_array_equal(got.predict(probe), want.predict(probe))
    np.testing.assert_array_equal(got.predict_proba(probe), want.predict_proba(probe))
    np.testing.assert_allclose(got.feature_importances_, want.feature_importances_, rtol=0, atol=TOL)


def test_gait_study_report_equals_jax():
    n = 24
    tracks, labels = study(3, n, 8)
    tracks[n] = tracks[0][:10]  # too short: left out by both
    got, want = GaitStudy(fps=25.0, gsd=0.05).run(tracks, labels), jax_gait.GaitStudy(fps=25.0, gsd=0.05).run(tracks,
                                                                                                             labels)
    assert got == want and set(got) == {"features", "stats", "classifier"} and n not in got["features"]
    one = GaitStudy().run({0: tracks[0], 1: tracks[1]}, {0: "old", 1: "old"})
    assert one == jax_gait.GaitStudy().run({0: tracks[0], 1: tracks[1]}, {0: "old", 1: "old"})
    assert list(one) == ["features"]  # one group: no statistics, no classifier


def test_forest_refuses_missing_values():
    x = np.ones((6, 2))
    x[0, 0] = np.nan
    with pytest.raises(ValueError, match="NaN"):
        forest.RandomForestClassifier(3, 0).fit(x, [0, 1] * 3)
