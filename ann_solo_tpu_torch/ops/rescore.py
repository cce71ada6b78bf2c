"""Exact per-query best candidate under greedy shifted-dot scoring.

Port of `ann_solo_tpu/ops/rescore.py`: a cheap upper bound on every
(query, candidate) pair's greedy score (stage 1: kernel B4 on the card,
`ops/stage1_cuda.py`, its plain PyTorch version `stage1_bounds_plain` on
the CPU), then the greedy kernel on each query's top-t candidates by
bound with an optimality certificate (stage 2), escalating t0 -> top_t ->
all C candidates for the queries whose certificate fails.  The
certificate keeps the result exact: the winner is always the true greedy
argmax over the candidate row; among exact score ties the first
candidate in bound order wins.  The bounds' sum over query peaks runs in
one stated order on both devices, so that order is the same on the card
and on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ann_solo_tpu_torch.ops import stage1_cuda
from ann_solo_tpu_torch.ops.shifted_dot import TWO_THIRDS
from ann_solo_tpu_torch.ops.shifted_dot_cuda import (
    PAIR_BLOCK,
    gather_pair_scores,
    pad_peaks,
)
from ann_solo_tpu_torch.ops.topk import topk_desc_nan_last
from ann_solo_tpu_torch.utils.profiling import (
    NO_SPAN,
    profiler,
    to_device,
    to_host,
)

# The factored bound's product order q * (mult * c) can round one ulp
# below stage 2's (mult * q) * c per term; inflating by 1 + 2^-20 keeps
# the certificate sound.
BOUND_INFLATION = 1.0 + 2.0 ** -20
_GREEDY_CHUNK = 8192  # pairs per full-C greedy call
# Entries of one (pairs, K, K) block of the plain stage 1 at most: wide
# peak rows (K = 300: 90,000 entries a pair) take fewer pairs a block.
_PLAIN_BLOCK_ENTRIES = 1 << 28


@torch.no_grad()
def stage1_bounds_plain(
    q_mz, q_int, q_prec, lib_mz, lib_int, lib_ann, lib_prec,
    cand_ids,  # (B, C) int, -1 = invalid
    fragment_mz_tolerance: float, num_shifts: int, allow_shift: bool,
    c_chunk: int,
):
    """Per-pair upper bound ub = sum_i max_j score(i, j) for the (B, C)
    matrix (-inf for invalid candidates), the plain version of kernel B4.
    The row max factorizes (score = mult * q_int[i] * c_int[j], q_int >=
    0), so no (P, K, K) product is formed: per shift one compare against
    the m/z differences and a row max of the multiplier-weighted candidate
    intensities.  The sum over query peaks is taken in a stated order,
    i = 0, 1, ..., K - 1 from +0.0, which the kernel follows.  Only the
    valid pairs are computed, B * `c_chunk` at a time (fewer where a
    block would pass `_PLAIN_BLOCK_ENTRIES`): window rows are mostly
    padding past their window's end."""
    b, c = cand_ids.shape
    dev = q_mz.device
    f32 = torch.float32
    flat_ids = cand_ids.reshape(-1)
    pairs = torch.nonzero(flat_ids >= 0).flatten()
    tol = torch.tensor(fragment_mz_tolerance, dtype=f32, device=dev)
    chg = float(num_shifts - 1 if allow_shift else 1)
    zero = torch.zeros((), dtype=f32, device=dev)
    out = torch.full((b * c,), float("-inf"), dtype=f32, device=dev)
    width = max(q_mz.shape[1], lib_mz.shape[1])
    step = max(1, min(b * c_chunk,
                      _PLAIN_BLOCK_ENTRIES // max(1, width * width)))
    for start in range(0, pairs.shape[0], step):
        flat = pairs[start:start + step]
        rows = flat // c
        ids = flat_ids.index_select(0, flat)
        qm, qi, cm, ci, ca = pad_peaks(
            q_mz.index_select(0, rows), q_int.index_select(0, rows),
            lib_mz.index_select(0, ids), lib_int.index_select(0, ids),
            lib_ann.index_select(0, ids),
        )
        prec_diff = (
            q_prec.index_select(0, rows) - lib_prec.index_select(0, ids)
        ) * chg
        diff0 = qm[:, :, None] - cm[:, None, :]  # (P, K, K)
        vmax = torch.where(diff0.abs() <= tol, ci[:, None, :], zero).amax(2)
        if allow_shift and num_shifts > 1:
            shifted = (prec_diff.abs() >= tol)[:, None, None]
            for s in range(1, num_shifts):
                mult = torch.where(
                    ca == s, 1.0, torch.where(ca == 0, TWO_THIRDS, 0.0)
                ).to(f32)
                cterm = (mult * ci)[:, None, :]
                s_t = torch.tensor(float(s), dtype=f32, device=dev)
                offset = (prec_diff / s_t)[:, None, None]
                within = ((diff0 - offset).abs() <= tol) & shifted
                vmax = torch.maximum(
                    vmax, torch.where(within, cterm, zero).amax(2)
                )
        terms = qi * vmax
        ub = torch.zeros(terms.shape[0], dtype=f32, device=dev)
        for i in range(terms.shape[1]):
            ub = ub + terms[:, i]
        out[flat] = ub * BOUND_INFLATION
    return out.view(b, c)


def _stage1_bounds(
    q_mz, q_int, q_prec, lib_mz, lib_int, lib_ann, lib_prec,
    cand_ids,  # (B, C) int64, -1 = invalid
    fragment_mz_tolerance: float, num_shifts: int, allow_shift: bool,
    c_chunk: int,
):
    """Stage 1 routed by the tensors' device: CUDA tensors launch kernel B4
    on the whole matrix at once (`c_chunk` unused) or raise, CPU tensors
    take `stage1_bounds_plain`.  Traced as ``rescore.bounds``."""
    tracer = profiler.tracer
    with tracer.span("rescore.bounds") if tracer else NO_SPAN:
        if q_mz.device.type == "cuda":
            return stage1_cuda.stage1_bounds(
                *(t.contiguous() for t in (
                    q_mz, q_int, q_prec, lib_mz, lib_int, lib_ann, lib_prec,
                    cand_ids)),
                fragment_mz_tolerance, num_shifts, allow_shift,
            )
        if q_mz.device.type != "cpu":
            raise ValueError(f"stage 1: unsupported device {q_mz.device}")
        return stage1_bounds_plain(
            q_mz, q_int, q_prec, lib_mz, lib_int, lib_ann, lib_prec,
            cand_ids, fragment_mz_tolerance, num_shifts, allow_shift,
            c_chunk,
        )


@torch.no_grad()
def _stage2_dense(
    q_mz, q_int, q_prec, lib_mz, lib_int, lib_ann, lib_prec,
    ub,  # (B, C) stage-1 bounds
    cand_ids,  # (B, C)
    t: int,
    fragment_mz_tolerance: float, num_shifts: int, allow_shift: bool,
):
    """Greedy-score every query's top-`t` candidates by bound; winner by
    argmax (first maximum), certified when it reaches the t-th bound.
    A NaN bound (a non-finite intensity) makes its pair invalid here; the
    bounds are ranked as `lax.top_k` ranks them, but with every NaN last
    (`topk_desc_nan_last`), where the reference on the CPU ranks the NaN
    that inf * 0 makes, so the finite bounds compete for the t places.

    Returns (best_idx (B,), best_score (B,), cert (B,) bool, n_cands (B,)).
    """
    b, c = cand_ids.shape
    dev = cand_ids.device
    ub_sel, pos = topk_desc_nan_last(ub, t)  # (B, T)
    ids_sel = torch.gather(cand_ids, 1, pos)
    n_cands = (cand_ids >= 0).sum(1).to(torch.int32)
    pq = torch.arange(b, device=dev).repeat_interleave(t)
    pc = ids_sel.reshape(-1)
    valid = (pc >= 0) & (ub_sel.reshape(-1) > float("-inf"))
    n_pair = b * t
    n_pad = -(-n_pair // PAIR_BLOCK) * PAIR_BLOCK
    if n_pad != n_pair:
        pq = F.pad(pq, (0, n_pad - n_pair))
        pc = F.pad(pc, (0, n_pad - n_pair), value=-1)
        valid = F.pad(valid, (0, n_pad - n_pair))
    scores = gather_pair_scores(
        q_mz, q_int, q_prec, lib_mz, lib_int, lib_ann, lib_prec,
        pq, pc.clamp(0, lib_mz.shape[0] - 1), valid,
        fragment_mz_tolerance, num_shifts, allow_shift,
    )[:n_pair].view(b, t)
    best_t = scores.argmax(1)  # first maximum: highest bound rank wins ties
    best_score = scores.gather(1, best_t[:, None])[:, 0]
    best_idx = ids_sel.gather(1, best_t[:, None])[:, 0]
    has = n_cands > 0
    best_idx = torch.where(has, best_idx, -1)
    best_score = torch.where(has, best_score, float("-inf"))
    # Every non-selected candidate's bound is <= the smallest selected one.
    t_th = ub_sel.amin(1)
    cert = (best_score >= t_th) | ~torch.isfinite(t_th) | ~has
    return best_idx, best_score, cert, n_cands


@torch.no_grad()
def _greedy_pairs_chunked(
    q_mz, q_int, q_prec, lib_mz, lib_int, lib_ann, lib_prec,
    pair_q: np.ndarray, pair_c: np.ndarray,
    fragment_mz_tolerance, num_shifts, allow_shift,
) -> np.ndarray:
    """Greedy scores of arbitrary (query, candidate) pairs in fixed
    `_GREEDY_CHUNK` pieces (the last padded with invalid pairs)."""
    dev = q_mz.device
    n = pair_q.shape[0]
    out = np.empty(n, np.float32)
    for start in range(0, n, _GREEDY_CHUNK):
        pq = pair_q[start:start + _GREEDY_CHUNK]
        pc = pair_c[start:start + _GREEDY_CHUNK]
        m = len(pq)
        if m < _GREEDY_CHUNK:
            pq = np.pad(pq, (0, _GREEDY_CHUNK - m))
            pc = np.pad(pc, (0, _GREEDY_CHUNK - m), constant_values=-1)
        pq_d = to_device(pq, dev, torch.int64)
        pc_d = to_device(pc, dev, torch.int64)
        scores = gather_pair_scores(
            q_mz, q_int, q_prec, lib_mz, lib_int, lib_ann, lib_prec,
            pq_d, pc_d.clamp(0, lib_mz.shape[0] - 1), pc_d >= 0,
            fragment_mz_tolerance, num_shifts, allow_shift,
        )
        out[start:start + m] = to_host(scores[:m]).numpy()
    return out


@torch.no_grad()
def rescore_candidate_matrix(
    q_mz, q_int, q_prec,  # (B, K), (B, K), (B,) float32 on the device
    lib_mz, lib_int, lib_ann, lib_prec,  # library block on the device
    cand_ids,  # (B, C) candidate rows, -1 = invalid
    fragment_mz_tolerance: float,
    num_shifts: int,
    allow_shift: bool,
    c_chunk: int = 0,
    top_t: int = 32,
    t0: int = 8,
):
    """Exact per-query best candidate (see the module docstring).

    Returns NumPy (best_idx (B,) int64, best_score (B,) float64,
    n_candidates (B,) int32), like the JAX function.  Traced as
    ``rescore.bounds``, a ``rescore.tier`` span a stage-2 tier (its `t`
    and rows; the rows also counted as ``rescore.t<t>.rows``) and
    ``rescore.full`` (the greedy over all C, its rows counted as
    ``rescore.full.rows``).
    """
    b, c = cand_ids.shape
    if c_chunk <= 0:
        c_chunk = max(8, min(c, 65536 // max(b, 1)))
    cand = torch.as_tensor(cand_ids, device=q_mz.device).to(torch.int64)
    ub = _stage1_bounds(
        q_mz, q_int, q_prec, lib_mz, lib_int, lib_ann, lib_prec, cand,
        fragment_mz_tolerance, num_shifts, allow_shift, min(c_chunk, c),
    )
    t = min(max(1, t0), c)
    with _tier(t, b):
        outs = _stage2_dense(
            q_mz, q_int, q_prec, lib_mz, lib_int, lib_ann, lib_prec, ub,
            cand, t, fragment_mz_tolerance, num_shifts, allow_shift,
        )
        best_idx, best_score, cert, n_cands = _to_numpy(*outs)
    failures = np.nonzero(~cert)[0]
    t_mid = min(top_t, c)
    if len(failures) and t < t_mid:
        # Tier 2: stage 2 at the wider `top_t` on the failed rows only.
        with _tier(t_mid, len(failures)):
            rows = to_device(failures, q_mz.device)
            outs2 = _stage2_dense(
                q_mz[rows], q_int[rows], q_prec[rows],
                lib_mz, lib_int, lib_ann, lib_prec,
                ub[rows], cand[rows], t_mid,
                fragment_mz_tolerance, num_shifts, allow_shift,
            )
            idx2, score2, cert2, _ = _to_numpy(*outs2)
        best_idx[failures] = idx2
        best_score[failures] = score2
        cert[failures] = cert2
        failures = failures[~cert2]
    if len(failures) and t_mid < c:
        # Full greedy over all C candidates for the residual failures.
        tracer = profiler.tracer
        if tracer is not None:
            tracer.count("rescore.full.rows", len(failures))
        with tracer.span("rescore.full", rows=len(failures)) if tracer \
                else NO_SPAN:
            cand_fail = cand[to_device(failures, cand.device)]
            cand_fail = to_host(cand_fail).numpy()
            pair_q = np.repeat(failures, c)
            pair_c = cand_fail.reshape(-1)
            scores = _greedy_pairs_chunked(
                q_mz, q_int, q_prec, lib_mz, lib_int, lib_ann, lib_prec,
                pair_q, pair_c, fragment_mz_tolerance, num_shifts,
                allow_shift,
            ).reshape(len(failures), c)
        f_best = np.argmax(scores, axis=1)
        f_rows = np.arange(len(failures))
        best_idx[failures] = cand_fail[f_rows, f_best]
        best_score[failures] = scores[f_rows, f_best]
    return best_idx, best_score, n_cands


def _tier(t: int, rows: int):
    """The span of a stage-2 tier at `t` over `rows` query rows, counted
    as ``rescore.t<t>.rows``, while tracing is on."""
    tracer = profiler.tracer
    if tracer is None:
        return NO_SPAN
    tracer.count(f"rescore.t{t}.rows", rows)
    return tracer.span("rescore.tier", t=t, rows=rows)


def _to_numpy(best_idx, best_score, cert, n_cands):
    return (
        to_host(best_idx).numpy().astype(np.int64),
        to_host(best_score).numpy().astype(np.float64),
        to_host(cert).numpy(),
        to_host(n_cands).numpy(),
    )
