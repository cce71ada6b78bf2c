"""The semi-supervised rescoring models, without scikit-learn.

`ann_solo_tpu/fdr.py` builds its fold models from scikit-learn: the scaler
pipeline StandardScaler -> VarianceThreshold -> CorrelationThreshold(0.95),
`LinearSVC(dual="auto", max_iter=5000)` and
`RandomForestClassifier(random_state=1)` under a 3-fold `GridSearchCV`.
This module holds their counterparts:

* `ScalerChain`, `CorrelationThreshold`, `LinearSVM`, `stratified_folds`,
  `param_grid` and `grid_winner` are NumPy in float64 on the host and
  deterministic: each is held to scikit-learn's result in
  `tests/test_torch_fdr_models.py`.
* `RandomForest` and `grid_search_forest` grow their trees with torch ops
  on the engine's device, level by level and batched over every tree of a
  forest and over several forests (grid settings and folds) at once.

The forest follows scikit-learn's defaults (100 trees, Gini, sqrt(F)
features a node drawn without replacement and extended until one of them
can split, min_samples_split 2, min_samples_leaf 1, class-1 probability =
the mean over trees of the leaf's class fraction) and its bootstraps: the
rows each tree draws are scikit-learn's own for ``random_state=1``
(`bootstrap_counts`), and a class weight is applied as scikit-learn 1.9
applies it, as the rows' probabilities in those draws, the trees growing
on plain counts.  The feature subsets come from scikit-learn's C
generator and are not reproduced, so the forest's bits are not the
target.  Two things differ by design:

* splits are searched on per-feature histograms of at most `MAX_BINS`
  bins (features binned once per fit, on the rows fitted; a feature with
  no more distinct values than that is searched exactly, at the midpoints
  scikit-learn uses);
* the per-node feature order comes from one NumPy generator per forest,
  seeded with `SEED`, on the host, like the bootstraps.  The histograms
  hold integer row counts per class, so the CPU and the GPU see the same
  sums and pick the same splits.

Because a level's draws depend only on the levels above it, a forest
grown with ``max_depth=d`` is the forest grown without a limit, cut at
depth d.  The grid search uses that: per class weight and fold it grows
one unlimited forest and reads every ``max_depth`` setting off it.
"""

from __future__ import annotations

import dataclasses
import itertools
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ann_solo_tpu_torch.device import DeviceLike, resolve_device

MAX_BINS = 64
N_TREES = 100
N_SPLITS = 3  # folds of the grid search
SEED = 1
# Rows x trees grown in one batch of forests, and histogram cells of one
# split search (node x feature x bin), both bounds on transient memory.
_BATCH_ROWS = 1 << 21
_HIST_CELLS = 1 << 23
_NO_LIMIT = 1 << 30  # max_depth None

RF_PARAM_GRID = {
    "max_depth": [3, 5, 7, 9, None],
    "class_weight": [
        None,
        {0: 0.1, 1: 1}, {0: 0.1, 1: 10}, {0: 1, 1: 0.1},
        {0: 1, 1: 10}, {0: 10, 1: 0.1}, {0: 10, 1: 1},
    ],
}


# --------------------------------------------------------------------- #
# Scaler chain


class CorrelationThreshold:
    """Drop features highly correlated with an earlier feature
    (reference utils.py:23-66)."""

    def __init__(self, threshold: float) -> None:
        self.threshold = threshold

    def fit(self, X, y=None) -> "CorrelationThreshold":
        with np.errstate(invalid="ignore", divide="ignore"):
            corr = np.abs(np.atleast_2d(np.corrcoef(X, rowvar=False)))
        corr = np.nan_to_num(corr)
        self.mask_ = ~(np.tril(corr, k=-1) > self.threshold).any(axis=1)
        return self

    def transform(self, X) -> np.ndarray:
        return np.asarray(X)[:, self.mask_]


class ScalerChain:
    """Standardize, drop zero-variance columns, drop columns correlated
    above 0.95 with an earlier one: scikit-learn's
    ``make_pipeline(StandardScaler(), VarianceThreshold(),
    CorrelationThreshold(0.95))``, fit on the rows given and applied to
    any rows."""

    def __init__(self, threshold: float = 0.95) -> None:
        self.threshold = threshold

    def fit(self, X) -> "ScalerChain":
        X = np.asarray(X, np.float64)
        n = X.shape[0]
        self.mean_ = X.mean(axis=0)
        var = X.var(axis=0)  # population variance
        # A column indistinguishable from a constant scales by 1
        # (StandardScaler's bound on the two-pass variance's error).
        eps = np.finfo(np.float64).eps
        constant = var <= n * eps * var + (n * self.mean_ * eps) ** 2
        self.scale_ = np.sqrt(var)
        self.scale_[constant] = 1.0
        Z = (X - self.mean_) / self.scale_
        # VarianceThreshold(0): the smaller of variance and peak-to-peak,
        # which is exactly 0 for a constant column.
        variances = np.minimum(Z.var(axis=0), np.ptp(Z, axis=0))
        varying = variances > 0
        if not varying.any():
            raise ValueError(
                "No feature in X meets the variance threshold 0.00000")
        correlation = CorrelationThreshold(self.threshold).fit(Z[:, varying])
        self.support_ = np.nonzero(varying)[0][correlation.mask_]
        return self

    def transform(self, X) -> np.ndarray:
        Z = (np.asarray(X, np.float64) - self.mean_) / self.scale_
        return Z[:, self.support_]

    def fit_transform(self, X) -> np.ndarray:
        return self.fit(X).transform(X)


# --------------------------------------------------------------------- #
# Linear SVM


class LinearSVM:
    """L2-regularized squared-hinge linear SVM as liblinear solves it for
    ``LinearSVC(dual="auto", max_iter=5000)`` on more rows than columns:

        min_w  0.5 |w|^2 + sum_i max(0, 1 - s_i w.x_i)^2,  s_i = +-1,

    with a constant feature 1 appended to every row, so the intercept is
    penalized like any coefficient.  The solver is liblinear's own
    trust-region Newton method (TRON: conjugate gradients inside a trust
    region, started at w = 0) with its constants and its stopping rule,
    |gradient| <= 1e-4 * min(#positive, #negative) / n of the start's.
    Stopping where liblinear stops matters: the semi-supervised loop feeds
    each model's scores into the next, and a solver run to the optimum
    drifts from the reference by more than the stopping tolerance over
    ten iterations.
    """

    _EPS = 1e-4  # LinearSVC's tol
    _MAX_ITER = 5000
    # Acceptance and trust-region update constants of tron.cpp.
    _ETA = (1e-4, 0.25, 0.75)
    _SIGMA = (0.25, 0.5, 4.0)

    def fit(self, X, y) -> "LinearSVM":
        A = np.column_stack([np.asarray(X, np.float64), np.ones(len(X))])
        s = np.where(np.asarray(y) > 0, 1.0, -1.0)
        n_pos = int((s > 0).sum())
        eps = self._EPS * max(min(n_pos, len(s) - n_pos), 1) / len(s)
        eta0, eta1, eta2 = self._ETA
        sigma1, sigma2, sigma3 = self._SIGMA

        def objective(w):
            margin = 1.0 - s * (A @ w)
            margin = margin[margin > 0]
            return (2.0 * (margin @ margin) + w @ w) / 2.0

        def gradient(w):
            z = s * (A @ w)
            active = z < 1
            rows = A[active]
            return w + 2.0 * (rows.T @ (s[active] * (z[active] - 1))), rows

        w = np.zeros(A.shape[1])
        f = objective(w)
        g, rows = gradient(w)
        delta = start_norm = float(np.linalg.norm(g))
        iteration = 1
        while iteration <= self._MAX_ITER and start_norm > 0:
            step, residual = self._trust_region_cg(g, rows, delta)
            w_new = w + step
            gs = float(g @ step)
            predicted = -0.5 * (gs - float(step @ residual))
            f_new = objective(w_new)
            actual = f - f_new
            step_norm = float(np.linalg.norm(step))
            if iteration == 1:
                delta = min(delta, step_norm)
            if f_new - f - gs <= 0:
                alpha = sigma3
            else:
                alpha = max(sigma1, -0.5 * (gs / (f_new - f - gs)))
            if actual < eta0 * predicted:
                delta = min(max(alpha, sigma1) * step_norm, sigma2 * delta)
            elif actual < eta1 * predicted:
                delta = max(sigma1 * delta,
                            min(alpha * step_norm, sigma2 * delta))
            elif actual < eta2 * predicted:
                delta = max(sigma1 * delta,
                            min(alpha * step_norm, sigma3 * delta))
            else:
                delta = max(delta, min(alpha * step_norm, sigma3 * delta))
            if actual > eta0 * predicted:
                iteration += 1
                w, f = w_new, f_new
                g, rows = gradient(w)
                if np.linalg.norm(g) <= eps * start_norm:
                    break
            if abs(actual) <= 0 and predicted <= 0:
                break
            if (abs(actual) <= 1e-12 * abs(f)
                    and abs(predicted) <= 1e-12 * abs(f)):
                break
        self.coef_ = w[:-1]
        self.intercept_ = float(w[-1])
        return self

    @staticmethod
    def _trust_region_cg(g, rows, delta):
        """Conjugate gradients on H step = -g, H = I + 2 rows^T rows,
        stopped at a residual of 0.1 |g| or at the trust region's
        boundary.  Returns (step, residual)."""
        step = np.zeros_like(g)
        r = -g
        d = r.copy()
        cg_tol = 0.1 * np.linalg.norm(g)
        r_dot = r @ r
        while np.linalg.norm(r) > cg_tol:
            Hd = d + 2.0 * (rows.T @ (rows @ d))
            alpha = r_dot / (d @ Hd)
            step = step + alpha * d
            if np.linalg.norm(step) > delta:
                step = step - alpha * d
                sd, ss, dd = step @ d, step @ step, d @ d
                radius = np.sqrt(sd * sd + dd * (delta * delta - ss))
                if sd >= 0:
                    alpha = (delta * delta - ss) / (sd + radius)
                else:
                    alpha = (radius - sd) / dd
                step = step + alpha * d
                r = r - alpha * Hd
                break
            r = r - alpha * Hd
            r_new = r @ r
            d = d * (r_new / r_dot) + r
            r_dot = r_new
        return step, r

    def decision_function(self, X) -> np.ndarray:
        return np.asarray(X, np.float64) @ self.coef_ + self.intercept_


# --------------------------------------------------------------------- #
# Folds and the grid


def stratified_folds(y, n_splits: int = 3) -> np.ndarray:
    """Test-fold number of every row: scikit-learn's unshuffled
    ``StratifiedKFold(n_splits)`` (classes numbered by first appearance,
    each class dealt to the folds in contiguous blocks)."""
    y = np.asarray(y)
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv]
    n_classes = len(y_idx)
    y_counts = np.bincount(y_encoded)
    if np.all(n_splits > y_counts):
        raise ValueError(
            f"n_splits={n_splits} cannot be greater than the number of "
            "members in each class.")
    if n_splits > y_counts.min():
        warnings.warn(
            f"The least populated class in y has only {y_counts.min()} "
            f"members, which is less than n_splits={n_splits}.", UserWarning)
    y_order = np.sort(y_encoded)
    allocation = np.asarray([
        np.bincount(y_order[i::n_splits], minlength=n_classes)
        for i in range(n_splits)
    ])
    test_folds = np.empty(len(y), dtype=np.int64)
    for k in range(n_classes):
        test_folds[y_encoded == k] = np.arange(n_splits).repeat(
            allocation[:, k])
    return test_folds


def param_grid(
    grid: Optional[Dict[str, Sequence]] = None,
) -> List[Dict[str, object]]:
    """The settings of a grid in scikit-learn's ``ParameterGrid`` order:
    keys sorted, the last key varying fastest."""
    grid = RF_PARAM_GRID if grid is None else grid
    keys = sorted(grid)
    return [dict(zip(keys, values))
            for values in itertools.product(*(grid[k] for k in keys))]


def grid_winner(mean_scores: Sequence[float]) -> int:
    """Index of the best setting: the highest mean score, ties to the
    first setting in grid order (``GridSearchCV``'s rank 1)."""
    mean_scores = np.asarray(mean_scores, np.float64)
    return int(np.nonzero(mean_scores == mean_scores.max())[0][0])


# --------------------------------------------------------------------- #
# Random forest


def bin_thresholds(X: np.ndarray, max_bins: int = MAX_BINS) -> List[np.ndarray]:
    """Ascending split thresholds of each column: the midpoints between
    its distinct values when there are at most `max_bins` of them, else
    midpoints between the distinct values at `max_bins` - 1 evenly spaced
    ranks.  A midpoint that rounds up to its upper value is replaced by
    the lower one, so ``x <= threshold`` always separates the two."""
    out = []
    for column in np.asarray(X, np.float64).T:
        distinct = np.unique(column)
        if len(distinct) > max_bins:
            ranks = np.linspace(0, len(column) - 1, max_bins + 1)[1:-1]
            cuts = np.unique(np.sort(column)[ranks.astype(np.int64)])
            # Each cut value closes a bin: threshold halfway to the next
            # distinct value above it.
            above = distinct[np.searchsorted(distinct, cuts, "right").clip(
                max=len(distinct) - 1)]
            lower, upper = cuts[above > cuts], above[above > cuts]
        else:
            lower, upper = distinct[:-1], distinct[1:]
        mid = lower / 2.0 + upper / 2.0
        out.append(np.where(mid >= upper, lower, mid))
    return out


def bin_rows(X: np.ndarray, thresholds: List[np.ndarray]) -> np.ndarray:
    """(n, F) uint8 bin numbers: the count of a column's thresholds below
    each value, so ``bin <= b`` is ``x <= thresholds[b]``."""
    X = np.asarray(X, np.float64)
    out = np.empty(X.shape, np.uint8)
    for f, edges in enumerate(thresholds):
        out[:, f] = np.searchsorted(edges, X[:, f], side="left")
    return out


@dataclasses.dataclass
class _Job:
    """One forest to grow: the rows it trains on (indices into the binned
    matrix), the weight of each of them in the bootstrap draws (None: all
    equal) and its depth limit."""

    rows: np.ndarray
    row_weight: Optional[np.ndarray]
    max_depth: Optional[int]


@dataclasses.dataclass
class _Trees:
    """Forests grown together, as flat node arrays; forest j's roots are
    nodes j*n_trees .. (j+1)*n_trees - 1."""

    feature: torch.Tensor  # (nodes,) int64, -1 at a leaf
    threshold: torch.Tensor  # (nodes,) int64 bin: left if bin <= threshold
    left: torch.Tensor  # (nodes,) int64 left child; the right one follows
    value: torch.Tensor  # (nodes,) float64 weighted class-1 fraction
    n_levels: int
    n_trees: int


def _row_weight(class_weight, y: np.ndarray) -> Optional[np.ndarray]:
    """The bootstrap weight of rows labelled `y` under `class_weight`."""
    if class_weight is None:
        return None
    pair = np.array([class_weight[0], class_weight[1]], np.float64)
    return pair[np.asarray(y).astype(np.int64)]


def _first_max(values: torch.Tensor):
    """(max, first index of it) along dim 1, the same on every device."""
    best = values.max(dim=1).values
    lane = torch.arange(values.shape[1], device=values.device)
    first = torch.where(values == best[:, None], lane,
                        values.shape[1]).min(dim=1).values
    return best, first


def _split_search(xb, y, p_node, p_row, p_cnt, feats,
                  first_valid_only: bool):
    """Best histogram split of each node over its candidate features.

    `p_*` are the (node, row, bootstrap count) pairs of the nodes 0..M-1,
    `feats` (M, m) their candidate features in draw order.  Returns (found (M,) bool, feature (M,), bin (M,)):
    the split maximizing the Gini proxy sum_k left_k^2 / left +
    sum_k right_k^2 / right among those leaving a row on each side, ties
    to the earliest candidate and the lowest bin.  With
    `first_valid_only`, only the first candidate that can split at all is
    searched (the features drawn past sqrt(F)).
    """
    n_nodes, m = feats.shape
    dev = xb.device
    found = torch.zeros(n_nodes, dtype=torch.bool, device=dev)
    feature = torch.zeros(n_nodes, dtype=torch.int64, device=dev)
    threshold = torch.zeros(n_nodes, dtype=torch.int64, device=dev)
    step = max(1, _HIST_CELLS // (m * MAX_BINS))
    lane = torch.arange(m, device=dev)
    for lo in range(0, n_nodes, step):
        hi = min(lo + step, n_nodes)
        if lo == 0 and hi == n_nodes:
            node, row, cnt = p_node, p_row, p_cnt
        else:
            inside = (p_node >= lo) & (p_node < hi)
            node, row, cnt = p_node[inside] - lo, p_row[inside], p_cnt[inside]
        f = feats[lo:hi]
        bins = xb[row[:, None], f[node]].to(torch.int64)  # (P, m)
        cell = ((node[:, None] * m + lane) * MAX_BINS + bins) * 2 \
            + y[row][:, None]
        hist = torch.zeros((hi - lo) * m * MAX_BINS * 2, dtype=torch.int64,
                           device=dev)
        hist.scatter_add_(0, cell.reshape(-1),
                          cnt[:, None].expand(-1, m).reshape(-1))
        # Integer counts up to here: exact on every device.
        left = hist.view(hi - lo, m, MAX_BINS, 2).cumsum(dim=2)
        right = left[:, :, -1:, :] - left
        valid = (left.sum(dim=3) > 0) & (right.sum(dim=3) > 0)
        if first_valid_only:
            can = valid.any(dim=2)  # (M, m)
            first = torch.where(can, lane, m).min(dim=1).values
            valid &= (lane[None] == first[:, None])[:, :, None]
        l0 = left[..., 0].to(torch.float64)
        l1 = left[..., 1].to(torch.float64)
        r0 = right[..., 0].to(torch.float64)
        r1 = right[..., 1].to(torch.float64)
        proxy = (l0 * l0 + l1 * l1) / (l0 + l1) \
            + (r0 * r0 + r1 * r1) / (r0 + r1)
        proxy = torch.where(valid, proxy, float("-inf"))
        best, pos = _first_max(proxy.view(hi - lo, m * MAX_BINS))
        ok = best > float("-inf")
        pos = pos.clamp(max=m * MAX_BINS - 1)
        found[lo:hi] = ok
        feature[lo:hi] = f.gather(1, (pos // MAX_BINS)[:, None])[:, 0]
        threshold[lo:hi] = pos % MAX_BINS
    return found, feature, threshold


def bootstrap_counts(n_rows: int, row_weight: Optional[np.ndarray],
                     n_trees: int = N_TREES,
                     bootstrap: bool = True) -> np.ndarray:
    """(n_trees, n_rows) times each tree drew each row: scikit-learn's own
    draws for ``random_state=SEED``.  The forest's RandomState hands every
    tree a seed; the tree's RandomState draws `n_rows` rows with
    replacement, uniformly or, under a class weight, with probability
    proportional to the row's weight.  Without `bootstrap` every tree
    holds every row once."""
    if not bootstrap:
        return np.ones((n_trees, n_rows), np.int64)
    forest_state = np.random.RandomState(SEED)
    tree_seeds = [forest_state.randint(np.iinfo(np.int32).max)
                  for _ in range(n_trees)]
    if row_weight is not None:
        p = row_weight / np.sum(row_weight)
    counts = np.empty((n_trees, n_rows), np.int64)
    for t, seed in enumerate(tree_seeds):
        state = np.random.RandomState(seed)
        if row_weight is None:
            draws = state.randint(0, n_rows, n_rows)
        else:
            draws = state.choice(n_rows, n_rows, replace=True, p=p)
        counts[t] = np.bincount(draws, minlength=n_rows)
    return counts


@torch.no_grad()
def _grow(xb: torch.Tensor, y: torch.Tensor, jobs: List[_Job],
          max_features: int, n_trees: int = N_TREES,
          bootstrap: bool = True) -> _Trees:
    """Grow the forests of `jobs` together, one tree level at a time.

    `xb` (n, F) uint8 bins and `y` (n,) int64 labels live on the device
    the trees are grown on.  Each forest takes its bootstraps from
    `bootstrap_counts` and, from its own generator seeded with `SEED`, at
    every level one random key per (splitting node, feature), nodes in
    (tree, node) order;
    a node's candidates are its features in ascending key order.
    Without `bootstrap` every tree trains on every row once.
    """
    dev = xb.device
    n_feat = xb.shape[1]
    rngs, nodes, rows, counts = [], [], [], []
    for j, job in enumerate(jobs):
        rng = np.random.default_rng(SEED)
        count = bootstrap_counts(len(job.rows), job.row_weight, n_trees,
                                 bootstrap)
        tree, row = np.nonzero(count)
        nodes.append(tree + j * n_trees)
        rows.append(np.asarray(job.rows, np.int64)[row])
        counts.append(count[tree, row])
        rngs.append(rng)
    p_node = torch.from_numpy(np.concatenate(nodes)).to(dev)
    p_row = torch.from_numpy(np.concatenate(rows)).to(dev)
    p_cnt = torch.from_numpy(np.concatenate(counts).astype(np.int64)).to(dev)

    job_depth = torch.tensor(
        [_NO_LIMIT if job.max_depth is None else job.max_depth
         for job in jobs], dtype=torch.int64, device=dev)
    node_job = torch.arange(len(jobs), device=dev).repeat_interleave(n_trees)
    levels = {"feature": [], "threshold": [], "left": [], "value": []}
    lo, depth = 0, 0
    while True:
        m_nodes = node_job.shape[0]
        local = p_node - lo
        classes = torch.zeros(m_nodes * 2, dtype=torch.int64, device=dev)
        classes.scatter_add_(0, local * 2 + y[p_row], p_cnt)
        classes = classes.view(m_nodes, 2)
        n_rows = torch.bincount(local, minlength=m_nodes)
        c0 = classes[:, 0].to(torch.float64)
        c1 = classes[:, 1].to(torch.float64)
        levels["value"].append(c1 / (c0 + c1))
        can = ((depth < job_depth[node_job]) & (n_rows >= 2)
               & (classes[:, 0] > 0) & (classes[:, 1] > 0))
        feature = torch.full((m_nodes,), -1, dtype=torch.int64, device=dev)
        threshold = torch.zeros(m_nodes, dtype=torch.int64, device=dev)
        left = torch.zeros(m_nodes, dtype=torch.int64, device=dev)
        split_nodes = torch.nonzero(can)[:, 0]
        per_job = torch.bincount(node_job[split_nodes],
                                 minlength=len(jobs)).tolist()
        if split_nodes.shape[0]:
            keys = np.concatenate([
                rng.random((c, n_feat), dtype=np.float32)
                for rng, c in zip(rngs, per_job)
            ])
            order = torch.sort(torch.from_numpy(keys).to(dev), dim=1,
                               stable=True).indices
            slot = torch.cumsum(can, 0) - 1  # node -> splitting-node number
            keep = can[local]
            s_node, s_row, s_cnt = slot[local[keep]], p_row[keep], p_cnt[keep]
            found, s_feat, s_thr = _split_search(
                xb, y, s_node, s_row, s_cnt, order[:, :max_features],
                False)
            missing = torch.nonzero(~found)[:, 0]
            if missing.shape[0] and max_features < n_feat:
                # None of the first sqrt(F) features can split: go on in
                # draw order to the first feature that can.
                renumber = torch.full_like(found, -1, dtype=torch.int64)
                renumber[missing] = torch.arange(missing.shape[0], device=dev)
                inside = ~found[s_node]
                f2, feat2, thr2 = _split_search(
                    xb, y, renumber[s_node[inside]], s_row[inside],
                    s_cnt[inside], order[missing][:, max_features:],
                    True)
                found[missing] = f2
                s_feat[missing] = feat2
                s_thr[missing] = thr2
            split = split_nodes[found]
            n_split = split.shape[0]
            child = lo + m_nodes + 2 * torch.arange(n_split, device=dev)
            feature[split] = s_feat[found]
            threshold[split] = s_thr[found]
            left[split] = child
            # Move the rows of the split nodes to their children.
            moved = found[s_node]
            s_local = split_nodes[s_node[moved]]
            s_row, s_cnt = s_row[moved], s_cnt[moved]
            go_right = xb[s_row, feature[s_local]].to(torch.int64) \
                > threshold[s_local]
            p_node = left[s_local] + go_right.to(torch.int64)
            p_row, p_cnt = s_row, s_cnt
            node_job = node_job[split].repeat_interleave(2)
        else:
            n_split = 0
        levels["feature"].append(feature)
        levels["threshold"].append(threshold)
        levels["left"].append(left)
        lo += m_nodes
        depth += 1
        if n_split == 0:
            break
    return _Trees(*(torch.cat(levels[name]) for name in
                    ("feature", "threshold", "left", "value")), depth,
                  n_trees)


@torch.no_grad()
def _predict(trees: _Trees, forest: int, xb: torch.Tensor,
             depths: Sequence[Optional[int]]) -> List[torch.Tensor]:
    """Class-1 probability of the rows of `xb` under forest `forest`, cut
    at each of `depths` (None: the whole trees): the mean over its trees
    of the value of the node each row reaches, summed in tree order."""
    dev = xb.device
    n = xb.shape[0]
    n_trees = trees.n_trees
    rows = torch.arange(n, device=dev)[None].expand(n_trees, n)
    node = torch.arange(forest * n_trees, (forest + 1) * n_trees,
                        device=dev)[:, None].expand(n_trees, n)

    # A tensor divisor: CUDA's division by a Python scalar multiplies by
    # its reciprocal, one ulp off the CPU's quotient for some sums.
    divisor = torch.tensor(float(n_trees), dtype=torch.float64, device=dev)

    def mean(node):
        values = trees.value[node]
        total = torch.zeros(n, dtype=torch.float64, device=dev)
        for t in range(n_trees):
            total = total + values[t]
        return total / divisor

    wanted = {min(d, trees.n_levels) if d is not None else trees.n_levels
              for d in depths}
    at = {}
    for step in range(trees.n_levels + 1):
        if step in wanted:
            at[step] = mean(node)
        if step == trees.n_levels:
            break
        feature = trees.feature[node]
        bins = xb[rows, feature.clamp(min=0)].to(torch.int64)
        below = trees.left[node] + (bins > trees.threshold[node]).to(
            torch.int64)
        node = torch.where(feature < 0, node, below)
    return [at[min(d, trees.n_levels) if d is not None else trees.n_levels]
            for d in depths]


def _batches(jobs: List[_Job]) -> List[List[int]]:
    """Job numbers cut into batches of at most `_BATCH_ROWS` rows x
    trees."""
    out, size = [[]], 0
    for j, job in enumerate(jobs):
        cost = len(job.rows) * N_TREES
        if out[-1] and size + cost > _BATCH_ROWS:
            out.append([])
            size = 0
        out[-1].append(j)
        size += cost
    return out


class RandomForest:
    """A fitted forest: `predict_proba1` is scikit-learn's
    ``predict_proba(X)[:, 1]`` of its counterpart."""

    def __init__(self, class_weight=None, max_depth: Optional[int] = None,
                 device: DeviceLike = None, n_trees: int = N_TREES,
                 bootstrap: bool = True, max_features="sqrt") -> None:
        self.class_weight = class_weight
        self.max_depth = max_depth
        self.device = device  # None: the CUDA GPU, resolved in `fit`
        self.n_trees = n_trees
        self.bootstrap = bootstrap
        self.max_features = max_features  # "sqrt", or None for all

    def fit(self, X, y) -> "RandomForest":
        self.device = resolve_device(self.device)
        X = np.asarray(X, np.float64)
        self.thresholds_ = bin_thresholds(X)
        xb = torch.from_numpy(bin_rows(X, self.thresholds_)).to(self.device)
        y_d = torch.from_numpy(np.asarray(y).astype(np.int64)).to(self.device)
        job = _Job(np.arange(len(X)), _row_weight(self.class_weight, y),
                   self.max_depth)
        self.trees_ = _grow(
            xb, y_d, [job],
            max_features_of(X.shape[1]) if self.max_features == "sqrt"
            else X.shape[1],
            self.n_trees, self.bootstrap)
        return self

    def predict_proba1(self, X) -> np.ndarray:
        xb = torch.from_numpy(bin_rows(X, self.thresholds_)).to(self.device)
        return _predict(self.trees_, 0, xb, [None])[0].cpu().numpy()


def max_features_of(n_features: int) -> int:
    """``max_features="sqrt"``."""
    return max(1, int(np.sqrt(n_features)))


def grid_search_forest(X, y, device: DeviceLike = None, grid=None):
    """The 3-fold grid search of the forest's settings
    (``GridSearchCV(RandomForestClassifier(random_state=1), grid, cv=3,
    refit=False)``): stratified unshuffled folds, plain accuracy on the
    held-out fold, the highest mean wins, ties to the first setting.

    Returns (best settings, mean accuracy of every setting in grid
    order).  Each fold bins the features on its training rows only; per
    class weight and fold one unlimited forest is grown and every
    ``max_depth`` is read off it (see the module docstring).  `device` is
    where the trees grow (None: the CUDA GPU).
    """
    device = resolve_device(device)
    X = np.asarray(X, np.float64)
    y = np.asarray(y).astype(np.int64)
    n = len(y)
    settings = param_grid(grid)
    weights = []
    for setting in settings:
        if setting["class_weight"] not in weights:
            weights.append(setting["class_weight"])
    test_fold = stratified_folds(y, N_SPLITS)
    # Fold f's binned copy of all rows is rows f*n .. (f+1)*n - 1 of `xb`.
    binned, jobs, keys = [], [], []
    for fold in range(N_SPLITS):
        train = np.nonzero(test_fold != fold)[0]
        binned.append(bin_rows(X, bin_thresholds(X[train])))
        for w, weight in enumerate(weights):
            jobs.append(_Job(train + fold * n, _row_weight(weight, y[train]),
                             None))
            keys.append((fold, w))
    xb = torch.from_numpy(np.concatenate(binned)).to(device)
    y_d = torch.from_numpy(np.tile(y, N_SPLITS)).to(device)
    depths = sorted({s["max_depth"] for s in settings},
                    key=lambda d: _NO_LIMIT if d is None else d)
    accuracy = {}
    for batch in _batches(jobs):
        trees = _grow(xb, y_d, [jobs[j] for j in batch],
                      max_features_of(X.shape[1]))
        for slot, j in enumerate(batch):
            fold, w = keys[j]
            held = torch.from_numpy(
                np.nonzero(test_fold == fold)[0] + fold * n).to(device)
            probs = _predict(trees, slot, xb[held], depths)
            for depth, p in zip(depths, probs):
                predicted = (p > 0.5).to(torch.int64)
                correct = int((predicted == y_d[held]).sum())
                accuracy[(fold, w, depth)] = correct / max(len(held), 1)
    means = []
    for setting in settings:
        w = weights.index(setting["class_weight"])
        scores = [accuracy[(fold, w, setting["max_depth"])]
                  for fold in range(N_SPLITS)]
        means.append(sum(scores) / N_SPLITS)
    return settings[grid_winner(means)], means
