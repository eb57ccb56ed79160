"""Histogram gradient-boosted regression trees in numpy: the regressor of
``LatencyModel`` (the reference fits scikit-learn's
``HistGradientBoostingRegressor``, which the card's Python does not carry).

The algorithm is scikit-learn's for a squared-error regressor with numeric
features, step for step, so the same samples give the same trees:

- **Binning.** Per feature, the thresholds are the midpoints of the distinct
  values when there are at most ``max_bins`` of them, else the
  ``averaged_inverted_cdf`` percentiles at ``max_bins`` equal steps (repeats
  dropped); a value goes to bin ``i`` when ``t[i-1] < x <= t[i]``. Bin
  ``max_bins`` is kept for missing values (NaN), as scikit-learn's is.
- **Boosting.** The baseline is the mean of ``y``; each iteration takes the
  gradients ``raw - y`` in float32 (the hessians are constant 1) and grows
  one tree whose leaf values, times ``learning_rate``, are added to ``raw``.
- **Growth.** Best-first: a heap of splittable nodes ordered by gain (the
  same ``heapq`` order), at most ``max_leaf_nodes`` leaves, ``max_depth``,
  ``min_samples_leaf`` on both sides and ``min_hessian_to_split``. A node's
  histograms are summed in float64 over its samples in partition order; of
  two children the smaller is summed and the larger is its parent's minus it.
- **Split.** Per feature the bins are scanned left to right; the gain of a
  split is ``loss(node) - gL * vL - gR * vR`` with ``v = -g / (h + 1e-15)``
  and ``loss(node) = g * v(node)`` (the root's value is 0). Ties go to the
  lower bin and then to the lower feature, as scikit-learn's strict ``>``.
- **Early stopping.** On when there are more than 10,000 rows
  (``early_stopping="auto"``): 10% held out by a shuffled split drawn from
  ``rng``, scored by the negative half squared error, stopped once the last
  ``n_iter_no_change`` scores do not beat the one before them by ``tol``.
- **Prediction.** ``x <= threshold`` goes left; NaN goes where the larger
  child went in training (no training NaN) or the scan put it.

``Trees`` holds only numpy arrays, so a fitted model pickles without any of
this module's classes but ``Trees``.
"""

from __future__ import annotations

import heapq
from typing import Optional

import numpy as np

ALMOST_INF = 1e300
MIN_HESSIAN_TO_SPLIT = 1e-3
# scikit-learn's defaults, which the reference leaves as they are
MAX_LEAF_NODES = 31
MAX_BINS = 255
EARLY_STOPPING_MIN_ROWS = 10_000  # early_stopping="auto"
VALIDATION_FRACTION = 0.1
N_ITER_NO_CHANGE = 10
TOL = 1e-7
BINMAPPER_SUBSAMPLE = 200_000


def bin_thresholds(col: np.ndarray, max_bins: int) -> np.ndarray:
    """scikit-learn's ``_find_binning_thresholds`` without sample weights."""
    col = col[~np.isnan(col)]
    col = np.sort(col)
    distinct = np.unique(col).astype(np.float64)
    if len(distinct) <= 1:
        return np.asarray([], np.float64)
    if len(distinct) <= max_bins:
        thr = (distinct[:-1] + distinct[1:]) * 0.5
    else:
        pct = np.linspace(0, 100, num=max_bins + 1)[1:-1]
        thr = np.percentile(col, pct, method="averaged_inverted_cdf")
    uniq = np.unique(thr)
    if uniq.shape[0] != thr.shape[0]:
        thr = uniq
    return np.clip(thr, None, ALMOST_INF)


def bin_data(X: np.ndarray, thresholds: list[np.ndarray], missing_bin: int) -> np.ndarray:
    out = np.empty(X.shape, np.uint8)
    for f, thr in enumerate(thresholds):
        col = X[:, f]
        b = np.searchsorted(thr, col, side="left")
        b[np.isnan(col)] = missing_bin
        out[:, f] = b
    return out


class _Split:
    __slots__ = ("gain", "feature", "bin", "missing_left", "g_left", "h_left", "g_right",
                 "h_right", "n_left", "n_right", "v_left", "v_right")


class _Node:
    __slots__ = ("depth", "idx", "g", "h", "value", "split", "hist", "left", "right",
                 "is_leaf")

    def __init__(self, depth, idx, g, h, value):
        self.depth, self.idx, self.g, self.h, self.value = depth, idx, g, h, value
        self.split: Optional[_Split] = None
        self.hist = None
        self.left = self.right = None
        self.is_leaf = False

    def __lt__(self, other: "_Node") -> bool:  # heapq pops the highest gain first
        return self.split.gain > other.split.gain


def _node_value(g, h):
    return -g / (h + 0.0 + 1e-15)


class _Grower:
    """One tree: scikit-learn's ``TreeGrower`` for constant hessians, numeric
    features and no constraints."""

    def __init__(self, Xb, grad, n_bins, n_bins_non_missing, has_missing, max_leaf_nodes,
                 max_depth, min_samples_leaf, shrinkage):
        self.Xb, self.grad = Xb, grad
        self.n_features = Xb.shape[1]
        self.n_bins = n_bins
        self.missing_bin = n_bins - 1
        self.nbnm = n_bins_non_missing
        self.has_missing = has_missing
        self.max_leaf_nodes, self.max_depth = max_leaf_nodes, max_depth
        self.msl = min_samples_leaf
        self.shrinkage = shrinkage
        self.offsets = np.arange(self.n_features, dtype=np.intp) * n_bins
        self.features = np.arange(self.n_features)
        self.bins = np.arange(n_bins)[None, :]
        # the scan's last bin: the last non-missing one stays right unless
        # missing values exist to go there
        self.end = (n_bins_non_missing.astype(np.intp) - 1
                    + np.asarray(has_missing, np.intp))[:, None]
        self.splittable: list[_Node] = []
        self.leaves: list[_Node] = []
        n = Xb.shape[0]
        idx = np.arange(n, dtype=np.intp)
        hist = self._hist(idx)
        # the root's sums: feature 0's histogram summed, n constant hessians
        self.root = _Node(0, idx, hist[0][0].sum(), float(np.float32(1.0) * n), 0.0)
        if n < 2 * self.msl or self.root.h < MIN_HESSIAN_TO_SPLIT:
            self._finalize(self.root)
            return
        self.root.hist = hist
        self._split_and_push(self.root)

    def _hist(self, idx):
        """(sum_gradients, count) per (feature, bin), summed in sample order."""
        flat = (self.Xb[idx].astype(np.intp) + self.offsets).ravel()
        size = self.n_features * self.n_bins
        g = np.bincount(flat, weights=np.repeat(self.grad[idx], self.n_features).astype(
            np.float64), minlength=size).reshape(self.n_features, self.n_bins)
        c = np.bincount(flat, minlength=size).reshape(self.n_features, self.n_bins)
        return g, c

    def _finalize(self, node):
        node.is_leaf = True
        self.leaves.append(node)

    def _find_split(self, node) -> _Split:
        hg, hc = node.hist
        n = node.idx.shape[0]
        loss_node = node.g * node.value
        # every feature's left-to-right scan at once: bin b of feature f is
        # a candidate when b < end[f] (cumulative sums run bin by bin, as the
        # scan's do)
        gl = np.cumsum(hg, axis=1)
        nl = np.cumsum(hc, axis=1)
        hl = nl.astype(np.float64)
        nr = n - nl
        hr = node.h - hl
        gr = node.g - gl
        ok = ((self.bins < self.end) & (nl >= self.msl) & (nr >= self.msl)
              & (hl >= MIN_HESSIAN_TO_SPLIT) & (hr >= MIN_HESSIAN_TO_SPLIT))
        gain = loss_node - gl * _node_value(gl, hl)
        gain = gain - gr * _node_value(gr, hr)
        gain = np.where(ok & (gain > 0.0), gain, -np.inf)
        fbins = np.argmax(gain, axis=1)
        fgains = gain[self.features, fbins]
        best = _Split()
        best.gain = -1.0
        for f in range(self.n_features):
            b, fgain, missing_left = int(fbins[f]), fgains[f], False
            left = (float(gl[f, b]), float(hl[f, b]), int(nl[f, b]))
            if self.has_missing[f]:
                # right to left: the missing bin goes left with the bins below
                r2l = self._scan_right_to_left(node, f, loss_node)
                if r2l[1] > fgain:
                    b, fgain, left, missing_left = r2l[0], r2l[1], r2l[2], True
            if fgain == -np.inf or not fgain > best.gain:
                continue
            best.gain, best.feature, best.bin, best.missing_left = float(fgain), f, b, missing_left
            best.g_left, best.h_left, best.n_left = left
            best.g_right, best.h_right = node.g - best.g_left, node.h - best.h_left
            best.n_right = n - best.n_left
        if best.gain > 0:
            best.v_left = _node_value(best.g_left, best.h_left)
            best.v_right = _node_value(best.g_right, best.h_right)
        return best

    def _scan_right_to_left(self, node, f, loss_node):
        hg, hc = node.hist
        n = node.idx.shape[0]
        top = int(self.nbnm[f]) - 1  # bins top..1 go right in turn
        best_gain, best_bin, best_left = -np.inf, 0, None
        gr = hr = 0.0
        nr = 0
        for b in range(top, 0, -1):
            nr += int(hc[f, b])
            hr += float(hc[f, b])
            gr += float(hg[f, b])
            nl = n - nr
            hl, gl = node.h - hr, node.g - gr
            if nr < self.msl or hr < MIN_HESSIAN_TO_SPLIT:
                continue
            if nl < self.msl or hl < MIN_HESSIAN_TO_SPLIT:
                break
            gain = loss_node - gl * _node_value(gl, hl) - gr * _node_value(gr, hr)
            if gain > best_gain and gain > 0.0:
                best_gain, best_bin, best_left = gain, b - 1, (gl, hl, nl)
        return best_bin, best_gain, best_left

    def _split_and_push(self, node):
        node.split = self._find_split(node)
        if node.split.gain <= 0:
            self._finalize(node)
        else:
            heapq.heappush(self.splittable, node)

    def grow(self) -> None:
        while self.splittable:
            self._split_next()
        for leaf in self.leaves:
            leaf.value *= self.shrinkage

    def _split_next(self) -> None:
        node = heapq.heappop(self.splittable)
        s = node.split
        col = self.Xb[node.idx, s.feature]
        go_left = col <= s.bin
        if s.missing_left:
            go_left |= col == self.missing_bin
        elif not self.has_missing[s.feature]:
            go_left &= col != self.missing_bin
        depth = node.depth + 1
        n_leaf_nodes = len(self.leaves) + len(self.splittable) + 2
        left = _Node(depth, node.idx[go_left], s.g_left, s.h_left, s.v_left)
        right = _Node(depth, node.idx[~go_left], s.g_right, s.h_right, s.v_right)
        node.left, node.right = left, right
        if not self.has_missing[s.feature]:
            s.missing_left = left.idx.shape[0] > right.idx.shape[0]
        if self.max_leaf_nodes is not None and n_leaf_nodes == self.max_leaf_nodes:
            self._finalize(left)
            self._finalize(right)
            while self.splittable:
                self._finalize(self.splittable.pop())
            return
        if self.max_depth is not None and depth == self.max_depth:
            self._finalize(left)
            self._finalize(right)
            return
        if left.idx.shape[0] < 2 * self.msl:
            self._finalize(left)
        if right.idx.shape[0] < 2 * self.msl:
            self._finalize(right)
        if not left.is_leaf or not right.is_leaf:
            small, large = ((left, right) if left.idx.shape[0] < right.idx.shape[0]
                            else (right, left))
            small.hist = self._hist(small.idx)
            large.hist = (node.hist[0] - small.hist[0], node.hist[1] - small.hist[1])
            node.hist = None
            if not left.is_leaf:
                self._split_and_push(left)
            if not right.is_leaf:
                self._split_and_push(right)
            for child in (left, right):
                if child.is_leaf:
                    child.hist = None
        node.hist = None

    def arrays(self, thresholds):
        """The tree as flat arrays in scikit-learn's depth-first node order:
        (feature, threshold, missing_left, left, right, is_leaf, value)."""
        feat, thr, miss, lft, rgt, leaf, val = [], [], [], [], [], [], []

        def visit(node) -> int:
            i = len(feat)
            feat.append(0)
            thr.append(0.0)
            miss.append(False)
            lft.append(0)
            rgt.append(0)
            leaf.append(node.is_leaf)
            val.append(node.value)
            if node.is_leaf:
                return i
            s = node.split
            feat[i], miss[i] = s.feature, bool(s.missing_left)
            thr[i] = (np.inf if s.bin == int(self.nbnm[s.feature]) - 1
                      else float(thresholds[s.feature][s.bin]))
            lft[i] = visit(node.left)
            rgt[i] = visit(node.right)
            return i

        visit(self.root)
        return (np.asarray(feat, np.intp), np.asarray(thr, np.float64),
                np.asarray(miss, bool), np.asarray(lft, np.intp), np.asarray(rgt, np.intp),
                np.asarray(leaf, bool), np.asarray(val, np.float64))

    def leaf_updates(self, raw: np.ndarray) -> None:
        for leaf in self.leaves:
            raw[leaf.idx] += leaf.value


class Trees:
    """A fitted ensemble: the baseline and every tree's node arrays, padded
    to one width so prediction walks all trees at once."""

    def __init__(self, baseline: float, trees: list[tuple], n_features: int) -> None:
        self.baseline = float(baseline)
        self.n_features = n_features
        self.n_trees = len(trees)
        width = max((len(t[0]) for t in trees), default=1)

        def pad(k, dtype, fill):
            out = np.full((max(1, len(trees)), width), fill, dtype)
            for i, t in enumerate(trees):
                out[i, :len(t[k])] = t[k]
            return out

        self.feature = pad(0, np.intp, 0)
        self.threshold = pad(1, np.float64, 0.0)
        self.missing_left = pad(2, bool, False)
        self.left = pad(3, np.intp, 0)
        self.right = pad(4, np.intp, 0)
        self.is_leaf = pad(5, bool, True)
        self.value = pad(6, np.float64, 0.0)
        self.depth = 1
        for t in trees:  # the deepest leaf bounds the walk
            self.depth = max(self.depth, _depth(t[3], t[4], t[5]))

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, np.float64)
        out = np.full(X.shape[0], self.baseline)
        if self.n_trees == 0 or X.shape[0] == 0:
            return out
        rows = np.arange(X.shape[0])[:, None]
        trees = np.arange(self.n_trees)[None, :]
        node = np.zeros((X.shape[0], self.n_trees), np.intp)
        for _ in range(self.depth):
            leaf = self.is_leaf[trees, node]
            x = X[rows, self.feature[trees, node]]
            go_left = np.where(np.isnan(x), self.missing_left[trees, node],
                               x <= self.threshold[trees, node])
            nxt = np.where(go_left, self.left[trees, node], self.right[trees, node])
            node = np.where(leaf, node, nxt)
        vals = self.value[trees, node]
        for t in range(self.n_trees):  # tree by tree, as scikit-learn adds them
            out += vals[:, t]
        return out


def _depth(left, right, is_leaf) -> int:
    best, stack = 0, [(0, 0)]
    while stack:
        i, d = stack.pop()
        if is_leaf[i]:
            best = max(best, d)
        else:
            stack += [(int(left[i]), d + 1), (int(right[i]), d + 1)]
    return best


class HistGradientBoostingRegressor:
    """scikit-learn's regressor with the parameters ``LatencyModel`` sets
    and the rest at scikit-learn's defaults (the constants above); ``rng``
    draws the early-stopping split (scikit-learn draws it from an unseeded
    ``random_state=None``)."""

    def __init__(self, max_iter: int = 100, max_depth: Optional[int] = None,
                 learning_rate: float = 0.1, min_samples_leaf: int = 20,
                 rng: Optional[np.random.Generator] = None) -> None:
        self.max_iter, self.max_depth = max_iter, max_depth
        self.learning_rate, self.min_samples_leaf = learning_rate, min_samples_leaf
        self.rng = rng if rng is not None else np.random.default_rng()
        self.trees: Optional[Trees] = None
        self.n_iter_ = 0
        self.validation_score_: list[float] = []

    def fit(self, X, y) -> "HistGradientBoostingRegressor":
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        n = X.shape[0]
        stop_early = n > EARLY_STOPPING_MIN_ROWS
        X_val = y_val = None
        if stop_early:
            n_val = int(np.ceil(VALIDATION_FRACTION * n))
            perm = self.rng.permutation(n)
            X, X_val = X[perm[n_val:]], X[perm[:n_val]]
            y, y_val = y[perm[n_val:]], y[perm[:n_val]]
            n = X.shape[0]
        n_bins = MAX_BINS + 1
        fit_rows = X
        if n > BINMAPPER_SUBSAMPLE:
            fit_rows = X[self.rng.choice(n, BINMAPPER_SUBSAMPLE, replace=True)]
        thresholds = [bin_thresholds(fit_rows[:, f], MAX_BINS) for f in range(X.shape[1])]
        n_bins_non_missing = np.asarray([len(t) + 1 for t in thresholds], np.uint32)
        Xb = np.asfortranarray(bin_data(X, thresholds, n_bins - 1))
        has_missing = (Xb == n_bins - 1).any(axis=0)
        baseline = float(np.average(y))
        raw = np.zeros(n) + baseline
        trees: list[tuple] = []
        val_raw = None
        self.validation_score_ = []
        if stop_early:
            val_raw = np.zeros(X_val.shape[0]) + baseline
            self.validation_score_.append(-_half_squared_error(y_val, val_raw))
        for _ in range(self.max_iter):
            grad = (raw - y).astype(np.float32)
            grower = _Grower(Xb, grad, n_bins, n_bins_non_missing, has_missing,
                             MAX_LEAF_NODES, self.max_depth, self.min_samples_leaf,
                             self.learning_rate)
            grower.grow()
            trees.append(grower.arrays(thresholds))
            grower.leaf_updates(raw)
            if stop_early:
                val_raw += Trees(0.0, trees[-1:], X.shape[1]).predict(X_val)
                self.validation_score_.append(-_half_squared_error(y_val, val_raw))
                if _should_stop(self.validation_score_):
                    break
        self.n_iter_ = len(trees)
        self.trees = Trees(baseline, trees, X.shape[1])
        return self

    def predict(self, X) -> np.ndarray:
        return self.trees.predict(X)


def _should_stop(scores: list[float]) -> bool:
    """The last ``N_ITER_NO_CHANGE`` scores beat the one before them by no
    more than ``TOL``."""
    ref = N_ITER_NO_CHANGE + 1
    if len(scores) < ref:
        return False
    ref_score = scores[-ref] + TOL
    return not any(s > ref_score for s in scores[-ref + 1:])


def _half_squared_error(y, raw) -> float:
    return float(np.average(0.5 * (y - raw) ** 2))
