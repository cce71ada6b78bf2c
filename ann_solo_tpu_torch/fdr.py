"""Rescoring and FDR control (reference: ann_solo/utils.py).

The port's copy of `ann_solo_tpu/fdr.py`:

* target-decoy competition q-values with the mokapot convention
  ``q = (#decoys + 1) / #targets`` at each score threshold, monotonized from
  the low-score end (validated against the reference's golden test,
  src/tests/utils_test.py:60-80),
* mass-difference group FDR for open searches (utils.py:204-273),
* the SSM feature table, whose cosine column ranks the SSMs of
  ``--model none``,
* a Percolator-style semi-supervised cross-validated rescoring loop
  (mokapot.brew equivalent) with linear-SVM or random-forest models and the
  reference's preprocessing pipeline (standardize -> drop zero variance ->
  CorrelationThreshold(0.95), utils.py:147-151).

The JAX package takes its models from scikit-learn; this one from
`models/rescoring.py` (NumPy for the scaler chain and the SVM, torch ops
on the engine's device for the random forest and its grid search).
`tests/test_torch_engine_fdr.py` holds FDR and features equal to the JAX
package, `tests/test_torch_fdr_models.py` the models to scikit-learn piece
by piece and `brew` to the JAX package's planted-truth criteria.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional

import numpy as np
import scipy.signal

from ann_solo_tpu_torch.device import DeviceLike
from ann_solo_tpu_torch.io.masses import mass_diff
from ann_solo_tpu_torch.models import similarity
from ann_solo_tpu_torch.models.rescoring import (
    RF_PARAM_GRID as _RF_PARAM_GRID,
    LinearSVM,
    RandomForest,
    ScalerChain,
    grid_search_forest,
)
from ann_solo_tpu_torch.models.spectrum import SpectrumSpectrumMatch

logger = logging.getLogger(__name__)

# Feature columns whose non-finite values are replaced by the column max
# (utils.py:105-117).
_INF_COLS = [
    "mse_mz", "mse_int", "mse_mz_top5", "mse_int_top5",
    "manhattan", "euclidean", "chebyshev", "canberra",
]

# Non-feature metadata columns.
_META_COLS = ("index", "sequence", "is_target", "group")


def tdc_qvalues(scores: np.ndarray, is_target: np.ndarray) -> np.ndarray:
    """Target-decoy competition q-values (mokapot convention).

    Ties share a threshold; q = (cum_decoys + 1) / cum_targets evaluated at
    each distinct score, monotonized from the low-score end, clipped to 1.
    """
    scores = np.asarray(scores, np.float64)
    is_target = np.asarray(is_target, bool)
    # Aggregate counts per distinct score (ascending).
    unique_scores, inverse = np.unique(scores, return_inverse=True)
    n_unique = len(unique_scores)
    t_counts = np.bincount(
        inverse, weights=is_target.astype(float), minlength=n_unique
    )
    d_counts = np.bincount(
        inverse, weights=(~is_target).astype(float), minlength=n_unique
    )
    # Cumulative counts from the best (highest) score down.
    cum_t = np.cumsum(t_counts[::-1])
    cum_d = np.cumsum(d_counts[::-1])
    fdr = (cum_d + 1) / np.maximum(cum_t, 1)
    # Monotonize: q at a threshold is the minimum FDR at any lower or equal
    # threshold (reverse running minimum), then clip.
    q_desc = np.minimum.accumulate(fdr[::-1])[::-1]
    q_unique_desc = np.minimum(q_desc, 1.0)
    # Map back: unique_scores ascending -> index from the top.
    q_per_unique = q_unique_desc[::-1]
    return q_per_unique[inverse]


def _get_ssm_groups(
    ssms: List[SpectrumSpectrumMatch], min_group_size: int
) -> np.ndarray:
    """Group SSMs by precursor mass difference (utils.py:204-273).

    Within each nominal-Da interval a 101-bin histogram of the mass
    differences is peak-picked (scipy prominences); each SSM is assigned to
    the closest peak whose base interval contains it.  Groups smaller than
    `min_group_size` fall into residual group -1.
    """
    mass_diffs = np.asarray(
        [
            (ssm.exp_mass_to_charge - ssm.calc_mass_to_charge) * ssm.charge
            for ssm in ssms
        ]
    )
    groups = -np.ones(len(ssms), np.int32)
    group_offset = 0
    nominal = np.round(mass_diffs)
    for nominal_md in np.unique(nominal):
        member_idx = np.nonzero(nominal == nominal_md)[0]
        bins = np.linspace(nominal_md - 0.5, nominal_md + 0.5, 101)
        hist, _ = np.histogram(mass_diffs[member_idx], bins=bins)
        peaks_bin_i, prominences = scipy.signal.find_peaks(
            hist, prominence=(None, None)
        )
        if len(peaks_bin_i) > 0:
            peak_mz = bins[peaks_bin_i]
            left = bins[prominences["left_bases"]]
            right = bins[prominences["right_bases"]]
            for j in member_idx:
                md = mass_diffs[j]
                in_base = (left < md) & (md < right)
                if in_base.any():
                    dist = np.where(
                        in_base, np.abs(peak_mz - md), np.inf
                    )
                    groups[j] = group_offset + int(np.argmin(dist))
        group_offset += len(peaks_bin_i)
    # Merge small groups into the residual group.
    labels, counts = np.unique(groups, return_counts=True)
    small = set(labels[counts < min_group_size])
    groups[np.isin(groups, list(small))] = -1
    return groups


def compute_ssm_features(
    ssms: List[SpectrumSpectrumMatch], config
) -> Dict[str, np.ndarray]:
    """Assemble the full SSM feature table (utils.py:276-457).

    SSMs without peak matches are skipped (their position is simply absent
    from the "index" column), matching the reference.
    """
    kept = [i for i, ssm in enumerate(ssms)
            if ssm.peak_matches is not None and len(ssm.peak_matches) > 0]
    n = len(kept)
    if n == 0:
        return {"index": np.zeros(0, np.int64)}
    max_k = max(
        max(len(ssms[i].query_spectrum.mz) for i in kept),
        max(len(ssms[i].library_spectrum.mz) for i in kept),
    )
    max_m = max(len(ssms[i].peak_matches) for i in kept)
    q_mz = np.zeros((n, max_k))
    q_int = np.zeros((n, max_k))
    l_mz = np.zeros((n, max_k))
    l_int = np.zeros((n, max_k))
    n_q = np.zeros(n, np.int32)
    n_l = np.zeros(n, np.int32)
    match_q = -np.ones((n, max_m), np.int64)
    match_c = -np.ones((n, max_m), np.int64)
    for row, i in enumerate(kept):
        ssm = ssms[i]
        qs, ls = ssm.query_spectrum, ssm.library_spectrum
        n_q[row] = len(qs.mz)
        n_l[row] = len(ls.mz)
        q_mz[row, : n_q[row]] = qs.mz
        q_int[row, : n_q[row]] = qs.intensity
        l_mz[row, : n_l[row]] = ls.mz
        l_int[row, : n_l[row]] = ls.intensity
        pm = np.asarray(ssm.peak_matches)
        match_q[row, : len(pm)] = pm[:, 0]
        match_c[row, : len(pm)] = pm[:, 1]

    block = similarity.MatchBlock(
        q_mz, q_int, n_q, l_mz, l_int, n_l, match_q, match_c
    )
    features = similarity.batch_features(block, config)

    # Metadata features (utils.py:350-406).
    charges = np.asarray(
        [ssms[i].query_spectrum.precursor_charge for i in kept]
    )
    query_mz = np.asarray(
        [ssms[i].query_spectrum.precursor_mz for i in kept]
    )
    lib_mz = np.asarray(
        [ssms[i].library_spectrum.precursor_mz for i in kept]
    )
    features["index"] = np.asarray(kept, np.int64)
    features["sequence_len"] = np.asarray(
        [len(ssms[i].sequence or "") for i in kept], np.float64
    )
    features["precursor_charge_2"] = (charges <= 2).astype(np.float64)
    features["precursor_charge_3"] = (charges == 3).astype(np.float64)
    features["precursor_charge_4"] = (charges == 4).astype(np.float64)
    features["precursor_charge_5"] = (charges >= 5).astype(np.float64)
    features["query_prec_mz"] = query_mz
    features["lib_prec_mz"] = lib_mz
    features["mz_diff_ppm"] = mass_diff(query_mz, lib_mz, False)
    features["abs_mz_diff_ppm"] = np.abs(features["mz_diff_ppm"])
    features["mz_diff_da"] = mass_diff(query_mz, lib_mz, True)
    features["abs_mz_diff_da"] = np.abs(features["mz_diff_da"])
    features["is_target"] = np.asarray(
        [not ssms[i].is_decoy for i in kept], bool
    )
    # Replace non-finite values with the column max (utils.py:105-117).
    for col in _INF_COLS:
        column = features[col]
        finite = np.isfinite(column)
        column[~finite] = column[finite].max() if finite.any() else 0.0
    return features


def _make_scaler():
    return ScalerChain(0.95)


def _fit_fold_model(
    X: np.ndarray,
    is_target: np.ndarray,
    init_scores: np.ndarray,
    train_fdr: float,
    model: str,
    max_iter: int = 10,
    device: DeviceLike = None,
    report: Optional[Dict[str, object]] = None,
):
    """Percolator-style semi-supervised iteration on one training split.

    Returns a fitted (scaler, classifier) pair, or None if no confident
    positives could be found (mokapot falls back to the initial direction).
    The forest's grid search runs once, at the first iteration; its winner
    is appended to ``report["grid"]`` when a report is given.
    """
    scores = init_scores
    fitted = None
    best_params = None
    for iteration in range(max_iter):
        q = tdc_qvalues(scores, is_target)
        positives = is_target & (q <= train_fdr)
        n_pos = int(positives.sum())
        if n_pos == 0 or (~is_target).sum() == 0:
            break
        train_mask = positives | ~is_target
        y = is_target[train_mask].astype(int)
        scaler = _make_scaler()
        Xt = scaler.fit_transform(X[train_mask])
        if model == "svm":
            clf = LinearSVM()
        elif model == "rf":
            if best_params is None:
                best_params, _ = grid_search_forest(
                    Xt, y, device=device, grid=_RF_PARAM_GRID
                )
                if report is not None:
                    report.setdefault("grid", []).append(best_params)
            clf = RandomForest(device=device, **best_params)
        else:
            raise ValueError(
                "Unknown semi-supervised machine learning model given"
            )
        clf.fit(Xt, y)
        fitted = (scaler, clf)
        scores = _decision_scores(fitted, X)
    return fitted


def _decision_scores(fitted, X: np.ndarray) -> np.ndarray:
    scaler, clf = fitted
    Xt = scaler.transform(X)
    if hasattr(clf, "decision_function"):
        return clf.decision_function(Xt)
    return clf.predict_proba1(Xt)


def brew(
    X: np.ndarray,
    is_target: np.ndarray,
    init_scores: np.ndarray,
    train_fdr: float,
    model: str,
    folds: int = 3,
    seed: int = 42,
    device: DeviceLike = None,
    report: Optional[Dict[str, object]] = None,
) -> np.ndarray:
    """Cross-validated semi-supervised rescoring (mokapot.brew convention).

    Each fold is scored by a model trained on the other folds; per-fold test
    scores are standardized against the fold's decoy distribution so they
    pool comparably.  The structure, the fold assignment and the fallback
    are the JAX package's `brew`; it claims convention-level parity with
    mokapot only, validated on planted ground truth, and so does this one
    (`tests/test_torch_fdr_models.py`).  `device` is where the random
    forest grows its trees (None: the CUDA GPU, resolved only when the
    model is "rf"); the SVM and the scaler run on the host.
    """
    n = len(is_target)
    rng = np.random.RandomState(seed)
    fold_of = rng.permutation(n) % folds
    final = np.array(init_scores, np.float64)
    for fold in range(folds):
        test = fold_of == fold
        train = ~test
        fitted = _fit_fold_model(
            X[train], is_target[train], init_scores[train], train_fdr, model,
            device=device, report=report,
        )
        if fitted is None:
            logger.warning(
                "Fold %d: no confident positives; keeping the initial "
                "score direction", fold,
            )
            test_scores = np.array(init_scores[test], np.float64)
        else:
            test_scores = _decision_scores(fitted, X[test])
        decoy_scores = test_scores[~is_target[test]]
        if len(decoy_scores) > 1 and decoy_scores.std() > 0:
            test_scores = (
                test_scores - decoy_scores.mean()
            ) / decoy_scores.std()
        final[test] = test_scores
    return final


def check_model(model: Optional[str]) -> None:
    """Refuse a rescoring model this package does not know: None (the
    cosine ranking of ``--model none``), "svm" and "rf" are the models."""
    if model not in (None, "svm", "rf"):
        raise ValueError(
            "Unknown semi-supervised machine learning model given: "
            f"{model!r} (the models are rf, svm and none)"
        )


def score_ssms(
    ssms: List[SpectrumSpectrumMatch],
    fdr: float,
    model: Optional[str],
    grouped: bool = False,
    min_group_size: int = 100,
    config=None,
    device: DeviceLike = None,
    report: Optional[Dict[str, object]] = None,
) -> List[SpectrumSpectrumMatch]:
    """Score SSMs and assign q-values (reference utils.py:69-201).

    `model` is "rf", "svm", or None (rank by cosine similarity only).
    Target SSMs receive q-values; decoy SSMs keep q = NaN (the reference's
    mokapot confidence output also only covers targets).  `device` is
    where a random forest grows (None: the CUDA GPU, resolved only when
    the model is "rf").  With a `report` dict given, the seconds of the
    feature table ("features_sec") and of the model ("model_sec") and the
    forest's grid winners per fold ("grid") are written to it.
    """
    check_model(model)
    if config is None:
        from ann_solo_tpu_torch.config import config as config_

        config = config_
    logger.debug(
        "Compute features for semi-supervised scoring from %d SSMs",
        len(ssms),
    )
    t0 = time.perf_counter()
    features = compute_ssm_features(ssms, config)
    if report is not None:
        report["features_sec"] = time.perf_counter() - t0
    idx = features["index"]
    if len(idx) == 0:
        return ssms
    is_target = features["is_target"]
    if grouped:
        groups = _get_ssm_groups(
            [ssms[i] for i in idx], min_group_size
        )
        logger.debug(
            "Partitioned %d SSMs into %d groups",
            len(idx), len(np.unique(groups)),
        )
    else:
        groups = np.zeros(len(idx), np.int32)

    if model is None:
        logger.debug("Calculate q-values based on the cosine similarity")
        scores = features["cosine"]
    else:
        logger.debug(
            "Train semi-supervised %s model and score SSMs", model.upper()
        )
        feature_cols = sorted(
            k for k in features if k not in _META_COLS
        )
        X = np.column_stack([features[k] for k in feature_cols])
        t0 = time.perf_counter()
        scores = brew(
            X, is_target, features["cosine"], fdr, model,
            device=device, report=report,
        )
        if report is not None:
            report["model_sec"] = time.perf_counter() - t0

    # q-values per group; residual group (-1) included as its own group.
    q = np.full(len(idx), np.nan)
    for group in np.unique(groups):
        members = groups == group
        q[members] = tdc_qvalues(scores[members], is_target[members])

    for row, ssm_i in enumerate(idx):
        ssms[ssm_i].search_engine_score = float(scores[row])
        if is_target[row]:
            ssms[ssm_i].q = float(q[row])
    return ssms
