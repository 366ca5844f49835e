"""A random forest classifier and stratified cross-validation in numpy: what the gait study takes from sklearn.

The JAX package's `classify_groups` fits `sklearn.ensemble.RandomForestClassifier(n_estimators, random_state=seed)`
and scores it by `sklearn.model_selection.cross_val_score(clf, X, y, cv=3)`. This module grows the same trees for the
same seed, with sklearn's defaults (gini, `max_features="sqrt"`, bootstrap, trees grown until their leaves are pure or
cannot be split):

- X is taken as float32, as sklearn's forest takes it; the classes are `np.unique(y)`;
- tree t's seed is the t-th `RandomState(seed).randint(np.iinfo(np.int32).max)`; its bootstrap is
  `RandomState(tree_seed).randint(0, n, n)`, counted into integer sample weights (a sample drawn no time is left out);
  its splitter's generator is sklearn's xorshift `rand_r`, seeded by `RandomState(tree_seed).randint(0, RAND_R_MAX)`;
- nodes are split depth first, the left child first; a node draws features by Fisher-Yates over the splitter's one
  feature permutation, kept from node to node, skipping the features found constant above it (a feature whose values
  span at most `FEATURE_THRESHOLD` in float32), until `max_features` non-constant ones are seen; a split lies between
  two sorted values more than `FEATURE_THRESHOLD` apart, at the mean of their halves; the first split of the greatest
  proxy improvement (-w_right gini_right - w_left gini_left, on weighted class counts) wins, a later feature only when
  strictly greater;
- a leaf's value is its weighted class fractions; the forest's probabilities are their sum over the trees in order,
  divided by the tree count; `feature_importances_` is the mean of each split tree's normalised weighted impurity
  decrease, normalised;
- `cross_val_score` splits as `StratifiedKFold(cv)` without shuffling and fits a new forest of the same seed on each
  training fold; a fold's score is its accuracy.

With integer sample weights every count and sum is exact, so the split search is vectorised over the positions of a
feature without changing a decision. Missing values (NaN), which sklearn's trees route by a second search pass, are
refused.
"""

from __future__ import annotations

import numpy as np

RAND_R_MAX = 0x7FFFFFFF
FEATURE_THRESHOLD = np.float32(1e-7)
EPSILON = np.finfo(np.float64).eps


class _RandR:
    """sklearn's `our_rand_r`: a 32-bit xorshift whose outputs are taken modulo RAND_R_MAX + 1."""

    def __init__(self, seed: int):
        self.state = int(seed) & 0xFFFFFFFF

    def randint(self, low: int, high: int) -> int:
        s = self.state or 1
        s ^= (s << 13) & 0xFFFFFFFF
        s ^= s >> 17
        s ^= (s << 5) & 0xFFFFFFFF
        self.state = s
        return low + (s % (RAND_R_MAX + 1)) % (high - low)


def _gini(counts: np.ndarray, w: np.ndarray) -> np.ndarray:
    """1 - sum_c counts_c^2 / w^2 over the last axis of counts (sums of integers: exact in any order)."""
    return 1.0 - (counts * counts).sum(-1) / (w * w)


class DecisionTree:
    """One tree of the forest, grown as sklearn's `DecisionTreeClassifier` grows it (see the module docstring)."""

    def fit(self, x: np.ndarray, y: np.ndarray, n_classes: int, weight: np.ndarray, seed: int, max_features: int):
        """x (n, f) float32, y (n,) class indices, weight (n,) integer-valued sample weights."""
        self._rand = _RandR(np.random.RandomState(seed).randint(0, RAND_R_MAX))
        self._x, self._weight, self._max_features = x, weight, max_features
        self._onehot = np.eye(n_classes)[y] * weight[:, None]  # weighted class counts of each sample
        self._samples = np.flatnonzero(weight != 0.0)  # sklearn leaves out the samples of weight 0
        self._features, self._constant = np.arange(x.shape[1]), np.zeros(x.shape[1], np.intp)
        self._total_w = float(weight.sum())
        feat, thr, left, right, imp, wn, value = [], [], [], [], [], [], []
        stack = [(0, len(self._samples), -1, False, np.inf, 0)]
        while stack:  # depth first, the left child first
            start, end, parent, is_left, impurity, n_const = stack.pop()
            idx = self._samples[start:end]
            counts = self._onehot[idx].sum(0)
            w = float(weight[idx].sum())
            if parent < 0:
                impurity = float(_gini(counts, np.float64(w)))
            split = None
            if not (end - start < 2 or impurity <= EPSILON):
                split, n_const = self._split(start, end, n_const, counts, w, impurity)
                if split is not None and split[4] + EPSILON < 0.0:
                    split = None
            node = len(feat)
            if parent >= 0:
                (left if is_left else right)[parent] = node
            feat.append(-2 if split is None else split[0])
            thr.append(-2.0 if split is None else split[1])
            left.append(-1)
            right.append(-1)
            imp.append(impurity)
            wn.append(w)
            value.append(counts / w)
            if split is not None:
                _, _, pos, (imp_l, imp_r), _ = split
                stack.append((pos, end, node, False, imp_r, n_const))
                stack.append((start, pos, node, True, imp_l, n_const))
        self.feature, self.threshold = np.array(feat), np.array(thr)
        self.left, self.right = np.array(left), np.array(right)
        self.impurity, self.weighted_n, self.value = np.array(imp), np.array(wn), np.array(value)
        del self._x, self._weight, self._onehot, self._samples, self._features, self._constant, self._rand
        return self

    def _split(self, start, end, n_known, counts, w, impurity):
        """sklearn's `node_split_best` on samples[start:end]: (feature, threshold, pos, (gini_left, gini_right),
        improvement) or None, and the constant-feature count for the children. Reorders samples[start:end] into the
        left and right child and updates the feature permutation as sklearn does."""
        x, weight, onehot, features, constant = self._x, self._weight, self._onehot, self._features, self._constant
        idx = self._samples[start:end].copy()
        f_i, n_total, n_visited, n_found, n_drawn = len(features), n_known, 0, 0, 0
        best, best_proxy = None, -np.inf
        while f_i > n_total and (n_visited < self._max_features or n_visited <= n_found + n_drawn):
            n_visited += 1
            f_j = self._rand.randint(n_drawn, f_i - n_found)
            if f_j < n_known:
                features[[n_drawn, f_j]] = features[[f_j, n_drawn]]
                n_drawn += 1
                continue
            f_j += n_found
            f = features[f_j]
            order = np.argsort(x[idx, f], kind="stable")
            xs = x[idx[order], f]
            if xs[-1] <= xs[0] + FEATURE_THRESHOLD:
                features[[f_j, n_total]] = features[[n_total, f_j]]
                n_found += 1
                n_total += 1
                continue
            f_i -= 1
            features[[f_i, f_j]] = features[[f_j, f_i]]
            pos = np.flatnonzero(xs[1:] > xs[:-1] + FEATURE_THRESHOLD) + 1  # the first sample of each right child
            sum_left = np.cumsum(onehot[idx[order]], 0)[pos - 1]
            w_left = np.cumsum(weight[idx[order]])[pos - 1]
            w_right = w - w_left
            proxy = -w_right * _gini(counts - sum_left, w_right) - w_left * _gini(sum_left, w_left)
            k = int(np.argmax(proxy))
            if proxy[k] > best_proxy:
                best_proxy = proxy[k]
                best = (int(f), float(xs[pos[k] - 1]) / 2.0 + float(xs[pos[k]]) / 2.0, start + int(pos[k]))
        if best is not None:
            f, threshold, pos = best
            go_left = x[idx, f].astype(np.float64) <= threshold
            self._samples[start:end] = np.concatenate([idx[go_left], idx[~go_left]])
            sum_left = onehot[idx[go_left]].sum(0)
            w_left = float(weight[idx[go_left]].sum())
            w_right = w - w_left
            imp_l = float(_gini(sum_left, np.float64(w_left)))
            imp_r = float(_gini(counts - sum_left, np.float64(w_right)))
            improvement = (w / self._total_w) * (impurity - (w_right / w * imp_r) - (w_left / w * imp_l))
            best = (f, threshold, pos, (imp_l, imp_r), improvement)
        features[:n_known] = constant[:n_known]
        constant[n_known:n_known + n_found] = features[n_known:n_known + n_found]
        return best, n_total

    def apply(self, x: np.ndarray) -> np.ndarray:
        """The leaf of each row of x (float32): left where x[feature] <= threshold (compared in float64)."""
        node = np.zeros(len(x), np.intp)
        while True:
            inner = self.left[node] >= 0
            if not inner.any():
                return node
            n = node[inner]
            go_left = x[np.flatnonzero(inner), self.feature[n]].astype(np.float64) <= self.threshold[n]
            node[inner] = np.where(go_left, self.left[n], self.right[n])

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        return self.value[self.apply(x)]

    def feature_importances(self, n_features: int) -> np.ndarray:
        """sklearn's `compute_feature_importances`: the weighted impurity decrease of each split, by feature, over
        the root's weight, normalised to sum 1 (all zero for a tree that is one leaf)."""
        out = np.zeros(n_features)
        for node in np.flatnonzero(self.left >= 0):
            lc, rc = self.left[node], self.right[node]
            out[self.feature[node]] += (self.weighted_n[node] * self.impurity[node]
                                        - self.weighted_n[lc] * self.impurity[lc]
                                        - self.weighted_n[rc] * self.impurity[rc])
        out /= self.weighted_n[0]
        total = out.sum()
        return out / total if total > 0.0 else out


def _as_x(x) -> np.ndarray:
    x = np.asarray(x, dtype=np.float32)
    if x.ndim != 2:
        raise ValueError(f"X must be 2-D (samples, features), got shape {x.shape}")
    if not np.isfinite(x).all():
        raise ValueError("X holds NaN or infinite values: the forest does not route missing values (sklearn's trees "
                         "do, by a second search pass, which is not ported)")
    return x


class RandomForestClassifier:
    """`sklearn.ensemble.RandomForestClassifier(n_estimators, random_state=seed)` with its defaults: `fit`,
    `predict_proba`, `predict`, `score`, `classes_`, `estimators_` and `feature_importances_`."""

    def __init__(self, n_estimators: int = 100, random_state: int = 0):
        self.n_estimators, self.random_state = int(n_estimators), int(random_state)

    def fit(self, x, y) -> RandomForestClassifier:
        x = _as_x(x)
        self.classes_, y_idx = np.unique(np.asarray(y), return_inverse=True)
        n, n_features = x.shape
        self.n_features_in_ = n_features
        max_features = max(1, int(np.sqrt(n_features)))
        rs = np.random.RandomState(self.random_state)
        seeds = [rs.randint(np.iinfo(np.int32).max) for _ in range(self.n_estimators)]
        self.estimators_ = []
        for s in seeds:
            weight = np.bincount(np.random.RandomState(s).randint(0, n, n), minlength=n).astype(np.float64)
            self.estimators_.append(DecisionTree().fit(x, y_idx, len(self.classes_), weight, s, max_features))
        return self

    def predict_proba(self, x) -> np.ndarray:
        x = _as_x(x)
        proba = np.zeros((len(x), len(self.classes_)))
        for tree in self.estimators_:
            proba += tree.predict_proba(x)
        proba /= len(self.estimators_)
        return proba

    def predict(self, x) -> np.ndarray:
        return self.classes_.take(np.argmax(self.predict_proba(x), axis=1), axis=0)

    def score(self, x, y) -> float:
        return float(np.mean(self.predict(x) == np.asarray(y)))

    @property
    def feature_importances_(self) -> np.ndarray:
        trees = [t.feature_importances(self.n_features_in_) for t in self.estimators_ if len(t.feature) > 1]
        if not trees:
            return np.zeros(self.n_features_in_)
        mean = np.mean(trees, axis=0, dtype=np.float64)
        return mean / np.sum(mean)


def stratified_test_folds(y, n_splits: int) -> np.ndarray:
    """`StratifiedKFold(n_splits)._make_test_folds` without shuffling: each sample's test fold. Classes are taken in
    the order of their first appearance; class k's samples, in order, fill the folds by the allocation of the sorted
    labels dealt round robin."""
    y = np.asarray(y)
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv]
    n_classes = len(y_idx)
    if np.all(n_splits > np.bincount(y_encoded)):
        raise ValueError(f"n_splits={n_splits} cannot be greater than the number of members in each class.")
    y_order = np.sort(y_encoded)
    allocation = np.asarray([np.bincount(y_order[i::n_splits], minlength=n_classes) for i in range(n_splits)])
    folds = np.empty(len(y), dtype="i")
    for k in range(n_classes):
        folds[y_encoded == k] = np.arange(n_splits).repeat(allocation[:, k])
    return folds


def cross_val_score(clf: RandomForestClassifier, x, y, cv: int = 3) -> np.ndarray:
    """`sklearn.model_selection.cross_val_score(clf, x, y, cv=cv)` for a classifier: the accuracy on each fold of
    `stratified_test_folds`, of a new forest with clf's parameters fitted on the other folds."""
    x, y = np.asarray(x), np.asarray(y)
    folds = stratified_test_folds(y, cv)
    scores = []
    for i in range(cv):
        test = folds == i
        fold = RandomForestClassifier(clf.n_estimators, clf.random_state).fit(x[~test], y[~test])
        scores.append(fold.score(x[test], y[test]))
    return np.array(scores)
