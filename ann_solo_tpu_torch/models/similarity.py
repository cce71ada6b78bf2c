"""Batched spectrum-similarity features.

Vectorized re-design of the reference's per-SSM
`SpectrumSimilarityCalculator` (ann_solo/spectrum_similarity.py:13-731) and
feature assembly (`_compute_ssm_features`, utils.py:276-457): the ~45
features for *all* SSMs are computed as masked NumPy array ops over padded
match blocks (one pass instead of 2 calculator objects per SSM).  Only the
rank-statistics (Kendall tau / Spearman, which need exact tie handling)
remain per-SSM scipy calls.

All formulas follow the reference exactly (docstrings cite the line ranges).

The port's copy of `ann_solo_tpu/models/similarity.py` (the port imports nothing of
the JAX package); `tests/test_torch_engine_io.py` holds it equal.
"""

from __future__ import annotations

import math
import warnings
from typing import Dict

import numpy as np
import scipy.stats

from ann_solo_tpu_torch.models.vectorize import get_dim

_EPS = np.finfo(float).eps


class MatchBlock:
    """Padded per-SSM arrays for batched feature computation.

    Attributes (B = #SSMs, K = max peaks, M = max matches):
      q_mz, q_int, n_q     : query peaks (processed)
      l_mz, l_int, n_l     : library peaks (processed)
      match_q, match_c     : (B, M) peak-match indices, -1 padded
    """

    def __init__(self, q_mz, q_int, n_q, l_mz, l_int, n_l, match_q, match_c):
        self.q_mz = np.asarray(q_mz, np.float64)
        self.q_int = np.asarray(q_int, np.float64)
        self.n_q = np.asarray(n_q, np.int32)
        self.l_mz = np.asarray(l_mz, np.float64)
        self.l_int = np.asarray(l_int, np.float64)
        self.n_l = np.asarray(n_l, np.int32)
        self.match_q = np.asarray(match_q, np.int64)
        self.match_c = np.asarray(match_c, np.int64)

        b, k = self.q_mz.shape
        self.valid_m = (self.match_q >= 0) & (self.match_c >= 0)
        mq = np.clip(self.match_q, 0, k - 1)
        mc = np.clip(self.match_c, 0, k - 1)
        rows = np.arange(b)[:, None]
        self.m_q_mz = np.where(self.valid_m, self.q_mz[rows, mq], 0.0)
        self.m_q_int = np.where(self.valid_m, self.q_int[rows, mq], 0.0)
        self.m_l_mz = np.where(self.valid_m, self.l_mz[rows, mc], 0.0)
        self.m_l_int = np.where(self.valid_m, self.l_int[rows, mc], 0.0)

        lanes = np.arange(k)[None, :]
        self.q_peak_valid = lanes < self.n_q[:, None]
        self.l_peak_valid = lanes < self.n_l[:, None]
        # Unmatched masks: valid peaks not appearing in the match lists.
        # Padded match lanes scatter into a sacrificial extra column k (a
        # direct scatter of valid_m at clipped index 0 would let a padded
        # lane's False overwrite a real match on peak 0).
        q_matched_ext = np.zeros((b, k + 1), bool)
        l_matched_ext = np.zeros((b, k + 1), bool)
        np.put_along_axis(
            q_matched_ext, np.where(self.valid_m, mq, k), True, axis=1
        )
        np.put_along_axis(
            l_matched_ext, np.where(self.valid_m, mc, k), True, axis=1
        )
        q_matched_mask = q_matched_ext[:, :k]
        l_matched_mask = l_matched_ext[:, :k]
        self.q_unmatched = self.q_peak_valid & ~q_matched_mask
        self.l_unmatched = self.l_peak_valid & ~l_matched_mask

    @property
    def batch_size(self) -> int:
        return self.q_mz.shape[0]

    def top_restricted(self, top: int) -> "TopMatchBlock":
        return TopMatchBlock(self, top)


class TopMatchBlock:
    """Match block restricted to the `top` most intense library peaks
    (reference spectrum_similarity.py:49-76)."""

    def __init__(self, block: MatchBlock, top: int):
        b, k = block.l_int.shape
        self.top = top
        # Top-`top` library peaks by intensity (among valid lanes).
        key = np.where(block.l_peak_valid, block.l_int, -np.inf)
        order = np.argsort(-key, axis=1, kind="stable")
        top_mask = np.zeros((b, k), bool)
        rows = np.arange(b)[:, None]
        top_cols = order[:, :top]
        np.put_along_axis(top_mask, top_cols, True, axis=1)
        top_mask &= block.l_peak_valid
        self.l_top_mask = top_mask

        mc = np.clip(block.match_c, 0, k - 1)
        in_top = top_mask[rows, mc] & block.valid_m
        self.valid_m = in_top
        self.has_any = in_top.any(axis=1)
        self.m_q_mz = np.where(in_top, block.m_q_mz, 0.0)
        self.m_q_int = np.where(in_top, block.m_q_int, 0.0)
        self.m_l_mz = np.where(in_top, block.m_l_mz, 0.0)
        self.m_l_int = np.where(in_top, block.m_l_int, 0.0)
        self.l_unmatched = block.l_unmatched & top_mask
        self.l_int = block.l_int


def _safe_div(a, b, fill=0.0):
    out = np.full(np.broadcast(a, b).shape, fill, np.float64)
    np.divide(a, b, out=out, where=np.asarray(b) != 0)
    return out


def _masked_entropy(x: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Row-wise Shannon entropy of masked, unnormalized intensities."""
    x = np.where(mask, x, 0.0)
    total = x.sum(axis=1, keepdims=True)
    p = _safe_div(x, total)
    with np.errstate(divide="ignore", invalid="ignore"):
        log_p = np.where(p > 0, np.log(p), 0.0)
    return -(p * log_p).sum(axis=1)


def _weighted_entropy(x: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Weighted spectral entropy (spectrum_similarity.py:703-731)."""
    weight_start, entropy_cutoff = 0.25, 3.0
    weight_slope = (1 - weight_start) / entropy_cutoff
    ent = _masked_entropy(x, mask)
    weight = weight_start + weight_slope * ent
    xw = np.where(mask, np.power(np.where(mask, x, 1.0), weight[:, None]),
                  0.0)
    ent_w = _masked_entropy(xw, mask)
    return np.where(ent > entropy_cutoff, ent, ent_w)


def _pearson_rows(x, y, mask):
    """Row-wise Pearson correlation over masked entries (0 where NaN)."""
    n = mask.sum(axis=1)
    xs = np.where(mask, x, 0.0)
    ys = np.where(mask, y, 0.0)
    with np.errstate(invalid="ignore", divide="ignore"):
        mx = _safe_div(xs.sum(axis=1), n)
        my = _safe_div(ys.sum(axis=1), n)
        dx = np.where(mask, x - mx[:, None], 0.0)
        dy = np.where(mask, y - my[:, None], 0.0)
        cov = (dx * dy).sum(axis=1)
        var_x = (dx * dx).sum(axis=1)
        var_y = (dy * dy).sum(axis=1)
        corr = cov / np.sqrt(var_x * var_y)
    return np.where(np.isfinite(corr), corr, 0.0)


def batch_features(block: MatchBlock, config) -> Dict[str, np.ndarray]:
    """Compute all similarity features for a batch of SSMs.

    Returns a dict of (B,) float arrays using the reference feature names
    (utils.py:294-342).  Metadata features (sequence, charge one-hots, m/z
    diffs) are added by the caller.
    """
    top = block.top_restricted(5)
    b = block.batch_size
    n_matched = block.valid_m.sum(axis=1).astype(np.float64)
    n_matched_top = top.valid_m.sum(axis=1).astype(np.float64)
    has_match = n_matched > 0
    has_match_top = top.has_any

    feats: Dict[str, np.ndarray] = {}

    # --- cosine (spectrum_similarity.py:81-106) ---
    dot_full = (block.m_q_int * block.m_l_int).sum(axis=1)
    feats["cosine"] = np.where(has_match, dot_full, 0.0)
    norm_top = np.sqrt((top.m_q_int**2).sum(axis=1)) * np.sqrt(
        (top.m_l_int**2).sum(axis=1)
    )
    dot_top = (top.m_q_int * top.m_l_int).sum(axis=1)
    feats["cosine_top5"] = np.where(
        has_match_top, _safe_div(dot_top, norm_top), 0.0
    )

    # --- peak counts / fractions (:108-201) ---
    feats["n_matched_peaks"] = n_matched
    feats["frac_n_peaks_query"] = np.where(
        has_match, _safe_div(n_matched, block.n_q), 0.0
    )
    feats["frac_n_peaks_lib"] = np.where(
        has_match, _safe_div(n_matched, block.n_l), 0.0
    )
    n_l_top = n_matched_top + top.l_unmatched.sum(axis=1)
    feats["frac_n_peaks_lib_top5"] = np.where(
        has_match_top, _safe_div(n_matched_top, n_l_top), 0.0
    )
    sum_q_int = np.where(block.q_peak_valid, block.q_int, 0.0).sum(axis=1)
    sum_l_int = np.where(block.l_peak_valid, block.l_int, 0.0).sum(axis=1)
    feats["frac_int_query"] = np.where(
        has_match, _safe_div(block.m_q_int.sum(axis=1), sum_q_int), 0.0
    )
    feats["frac_int_lib"] = np.where(
        has_match, _safe_div(block.m_l_int.sum(axis=1), sum_l_int), 0.0
    )
    sum_l_int_top = top.m_l_int.sum(axis=1) + np.where(
        top.l_unmatched, block.l_int, 0.0
    ).sum(axis=1)
    feats["frac_int_lib_top5"] = np.where(
        has_match_top, _safe_div(top.m_l_int.sum(axis=1), sum_l_int_top), 0.0
    )

    # --- mean squared errors (:203-233), inf when no matches ---
    def mse(m_a, m_b, valid, count, has):
        err = ((m_a - m_b) ** 2 * valid).sum(axis=1)
        return np.where(has, _safe_div(err, count), np.inf)

    feats["mse_mz"] = mse(
        block.m_q_mz, block.m_l_mz, block.valid_m, n_matched, has_match
    )
    feats["mse_mz_top5"] = mse(
        top.m_q_mz, top.m_l_mz, top.valid_m, n_matched_top, has_match_top
    )
    feats["mse_int"] = mse(
        block.m_q_int, block.m_l_int, block.valid_m, n_matched, has_match
    )
    feats["mse_int_top5"] = mse(
        top.m_q_int, top.m_l_int, top.valid_m, n_matched_top, has_match_top
    )

    # --- spectral contrast angle (:235-249) ---
    feats["contrast_angle"] = (
        1.0 - 2 * np.arccos(np.clip(feats["cosine"], 0.0, 1.0)) / np.pi
    )
    feats["contrast_angle_top5"] = (
        1.0 - 2 * np.arccos(np.clip(feats["cosine_top5"], 0.0, 1.0)) / np.pi
    )

    # --- hypergeometric score (:251-306) ---
    n_peak_bins, _, _ = get_dim(
        float(config.min_mz), float(config.max_mz), float(config.bin_size)
    )
    n_lib_peaks = block.n_l.astype(np.int64)
    with np.errstate(divide="ignore"):
        hgt = scipy.stats.hypergeom.sf(
            n_matched.astype(np.int64), n_peak_bins, n_lib_peaks,
            n_lib_peaks,
        )
        feats["hypergeometric_score"] = np.minimum(
            -np.log(np.maximum(hgt, 0.0)), 100.0
        )

    # --- rank statistics: exact tie handling via scipy per SSM (:308-331) ---
    kendall = np.zeros(b)
    spearman = np.zeros(b)
    spearman_top = np.zeros(b)
    for i in range(b):
        if has_match[i]:
            sel = block.valid_m[i]
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                pvalue = scipy.stats.kendalltau(
                    block.m_q_int[i, sel], block.m_l_int[i, sel]
                )[1]
            kendall[i] = -np.log(pvalue) if not np.isnan(pvalue) else 0.0
            spearman[i] = _spearman_ssm(
                block.m_q_int[i, sel], block.m_l_int[i, sel],
                block.l_int[i][block.l_unmatched[i]],
            )
        if has_match_top[i]:
            sel = top.valid_m[i]
            spearman_top[i] = _spearman_ssm(
                top.m_q_int[i, sel], top.m_l_int[i, sel],
                block.l_int[i][top.l_unmatched[i]],
            )
    feats["kendalltau"] = kendall
    feats["spearmanr"] = spearman
    feats["spearmanr_top5"] = spearman_top

    # --- MSforID v1 (:333-371) ---
    abs_int_diff = (np.abs(block.m_q_int - block.m_l_int)
                    * block.valid_m).sum(axis=1)
    v1 = n_matched**4 / (
        np.maximum(block.n_q * block.n_l, 1)
        * np.maximum(abs_int_diff, _EPS) ** 0.25
    )
    feats["ms_for_id_v1"] = np.where(has_match, np.minimum(v1, 1000.0), 0.0)

    # --- MSforID v2 (:373-406) ---
    abs_mz_diff = (np.abs(block.m_q_mz - block.m_l_mz)
                   * block.valid_m).sum(axis=1)
    v2 = (n_matched**4 * (sum_q_int + 2 * sum_l_int) ** 1.25) / (
        (block.n_q + 2 * block.n_l) ** 2 + abs_int_diff + abs_mz_diff
    )
    feats["ms_for_id_v2"] = np.where(has_match, v2, 0.0)

    # --- entropy (:653-700) ---
    q_ent = _masked_entropy(block.q_int, block.q_peak_valid)
    l_ent = _masked_entropy(block.l_int, block.l_peak_valid)
    q_ent_w = _weighted_entropy(block.q_int, block.q_peak_valid)
    l_ent_w = _weighted_entropy(block.l_int, block.l_peak_valid)
    # Merged spectrum: matched pairs summed, unmatched from both sides.
    merged = np.concatenate(
        [
            (block.m_q_int + block.m_l_int) / 2,
            np.where(block.q_unmatched, block.q_int, 0.0) / 2,
            np.where(block.l_unmatched, block.l_int, 0.0) / 2,
        ],
        axis=1,
    )
    merged_mask = np.concatenate(
        [block.valid_m, block.q_unmatched, block.l_unmatched], axis=1
    )
    m_ent = _masked_entropy(merged, merged_mask)
    m_ent_w = _weighted_entropy(merged, merged_mask)
    feats["entropy_unweighted"] = np.where(
        has_match, 1 - (2 * m_ent - q_ent - l_ent) / np.log(4), 0.0
    )
    feats["entropy_weighted"] = np.where(
        has_match, 1 - (2 * m_ent_w - q_ent_w - l_ent_w) / np.log(4), 0.0
    )

    # --- Scribe fragmentation accuracy (:628-651) ---
    def scribe(m_q, m_l, l_unmatched_mask, has):
        denom = ((m_q - m_l) ** 2).sum(axis=1) + np.where(
            l_unmatched_mask, block.l_int, 0.0
        ).__pow__(2).sum(axis=1)
        close_zero = np.isclose(denom, 0.0)
        with np.errstate(divide="ignore"):
            val = np.where(close_zero, 10.0, np.log(_safe_div(
                1.0, denom, fill=np.inf)))
        return np.where(has, val, 0.0)

    feats["scribe_fragment_acc"] = scribe(
        block.m_q_int, block.m_l_int, block.l_unmatched, has_match
    )
    feats["scribe_fragment_acc_top5"] = scribe(
        top.m_q_int, top.m_l_int, top.l_unmatched, has_match_top
    )

    # --- distances (:408-489) ---
    sum_uq = np.where(block.q_unmatched, block.q_int, 0.0).sum(axis=1)
    sum_ul = np.where(block.l_unmatched, block.l_int, 0.0).sum(axis=1)
    feats["manhattan"] = np.where(
        has_match, abs_int_diff + sum_uq + sum_ul, np.inf
    )
    feats["euclidean"] = np.where(
        has_match,
        np.sqrt(
            ((block.m_q_int - block.m_l_int) ** 2
             * block.valid_m).sum(axis=1)
            + (np.where(block.q_unmatched, block.q_int, 0.0) ** 2).sum(
                axis=1)
            + (np.where(block.l_unmatched, block.l_int, 0.0) ** 2).sum(
                axis=1)
        ),
        np.inf,
    )
    max_diff = np.max(
        np.abs(block.m_q_int - block.m_l_int) * block.valid_m, axis=1
    )
    max_uq = np.max(np.where(block.q_unmatched, block.q_int, 0.0), axis=1)
    max_ul = np.max(np.where(block.l_unmatched, block.l_int, 0.0), axis=1)
    feats["chebyshev"] = np.where(
        has_match, np.maximum(max_diff, np.maximum(max_uq, max_ul)), np.inf
    )

    # --- Pearson (:491-516): [matched_q, 0s] vs [matched_l, unmatched_l] ---
    k = block.q_int.shape[1]
    x_full = np.concatenate([block.m_q_int, np.zeros((b, k))], axis=1)
    y_full = np.concatenate(
        [block.m_l_int, np.where(block.l_unmatched, block.l_int, 0.0)],
        axis=1,
    )
    mask_full = np.concatenate([block.valid_m, block.l_unmatched], axis=1)
    pearson = _pearson_rows(x_full, y_full, mask_full)
    feats["pearsonr"] = np.where(has_match, pearson, 0.0)
    x_top = np.concatenate([top.m_q_int, np.zeros((b, k))], axis=1)
    y_top = np.concatenate(
        [top.m_l_int, np.where(top.l_unmatched, block.l_int, 0.0)], axis=1
    )
    mask_top = np.concatenate([top.valid_m, top.l_unmatched], axis=1)
    pearson_top = _pearson_rows(x_top, y_top, mask_top)
    feats["pearsonr_top5"] = np.where(has_match_top, pearson_top, 0.0)

    # --- Bray-Curtis (:545-572) ---
    sum_abs_plus = (np.abs(block.m_q_int + block.m_l_int)
                    * block.valid_m).sum(axis=1)
    feats["braycurtis"] = np.where(
        has_match,
        _safe_div(
            abs_int_diff + sum_uq + sum_ul,
            sum_abs_plus + sum_uq + sum_ul,
        ),
        1.0,
    )

    # --- Canberra (:574-599) ---
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.abs(block.m_q_int - block.m_l_int) / (
            block.m_q_int + block.m_l_int
        )
    ratio = np.nan_to_num(np.where(block.valid_m, ratio, 0.0))
    feats["canberra"] = np.where(
        has_match,
        ratio.sum(axis=1)
        + (block.q_unmatched & (block.q_int != 0)).sum(axis=1)
        + (block.l_unmatched & (block.l_int != 0)).sum(axis=1),
        np.inf,
    )

    # --- Ruzicka (:601-626) ---
    min_sum = (np.minimum(block.m_q_int, block.m_l_int)
               * block.valid_m).sum(axis=1)
    max_sum = (np.maximum(block.m_q_int, block.m_l_int)
               * block.valid_m).sum(axis=1)
    feats["ruzicka"] = np.where(
        has_match, _safe_div(min_sum, max_sum + sum_uq + sum_ul), 0.0
    )
    return feats


def _spearman_ssm(m_q, m_l, unmatched_l):
    """Spearman correlation for one SSM
    (spectrum_similarity.py:518-543)."""
    x = np.concatenate([m_q, np.zeros_like(unmatched_l)])
    y = np.concatenate([m_l, unmatched_l])
    if len(x) < 2:
        return 0.0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        corr = scipy.stats.spearmanr(x, y)[0]
    return corr if not math.isnan(corr) else 0.0
