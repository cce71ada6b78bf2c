"""Rescoring and FDR control (reference: ann_solo/utils.py).

The port's copy of `ann_solo_tpu/fdr.py` for ``--model none``:

* target-decoy competition q-values with the mokapot convention
  ``q = (#decoys + 1) / #targets`` at each score threshold, monotonized from
  the low-score end (validated against the reference's golden test,
  src/tests/utils_test.py:60-80),
* mass-difference group FDR for open searches (utils.py:204-273),
* the SSM feature table, whose cosine column ranks the SSMs.

The semi-supervised models (``--model rf`` and ``--model svm``) need
scikit-learn in the JAX package and are not ported yet: `check_model`
refuses them before any work is done.  `tests/test_torch_engine_fdr.py`
holds the rest equal to the JAX package.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np
import scipy.signal

from ann_solo_tpu_torch.io.masses import mass_diff
from ann_solo_tpu_torch.models import similarity
from ann_solo_tpu_torch.models.spectrum import SpectrumSpectrumMatch

logger = logging.getLogger(__name__)

# Feature columns whose non-finite values are replaced by the column max
# (utils.py:105-117).
_INF_COLS = [
    "mse_mz", "mse_int", "mse_mz_top5", "mse_int_top5",
    "manhattan", "euclidean", "chebyshev", "canberra",
]


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


def check_model(model: Optional[str]) -> None:
    """Refuse a rescoring model this package does not have (only None,
    the cosine ranking of ``--model none``, is ported)."""
    if model is not None:
        raise ValueError(
            f"--model {model} is not supported by ann_solo_tpu_torch yet "
            "(its semi-supervised rescoring needs scikit-learn); use "
            "--model none"
        )


def score_ssms(
    ssms: List[SpectrumSpectrumMatch],
    fdr: float,
    model: Optional[str],
    grouped: bool = False,
    min_group_size: int = 100,
    config=None,
) -> List[SpectrumSpectrumMatch]:
    """Score SSMs and assign q-values (reference utils.py:69-201).

    `model` must be None (rank by cosine similarity only): see
    `check_model`.
    Target SSMs receive q-values; decoy SSMs keep q = NaN (the reference's
    mokapot confidence output also only covers targets).
    """
    check_model(model)
    if config is None:
        from ann_solo_tpu_torch.config import config as config_

        config = config_
    logger.debug(
        "Compute features for semi-supervised scoring from %d SSMs",
        len(ssms),
    )
    features = compute_ssm_features(ssms, config)
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

    logger.debug("Calculate q-values based on the cosine similarity")
    scores = features["cosine"]

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
