"""Rescore stage 1 (kernel B4's plain version and its CPU route) vs JAX.

Inputs are made with NumPy from a seed by `chip_smoke.synth_stage1` (the
generator of chip_smoke's phase 3d, at small sizes) and fed to both
packages.  The plain version must:

* agree with the JAX `_stage1_bounds` (run on the CPU) at rtol 1e-6, with
  the same -inf cells: the JAX bound sums over query peaks in XLA's own
  order, the port in the order it states;
* be sound: every valid pair's bound >= its greedy score;
* equal, bit for bit, a NumPy float32 computation that sums the terms
  sequentially, i = 0, 1, ..., K - 1 from +0.0 (the stated order);
* equal, bit for bit, a NumPy emulation of the kernel's own work split:
  the branch rule (positive peaks a prefix of the row, finite and
  non-decreasing m/z), the range search with the plain version's float32
  expression over that prefix, the dense loop over every peak for other
  rows, and the sum of the terms that can differ from +-0 in query-peak
  order, on the main path's layouts (a zero tail), peaks at the windows'
  float32 edges, duplicated m/z, shuffled rows and non-finite m/z;
* equal, bit for bit, a NumPy emulation of the kernel's wide branch (any
  Kq and Kc: a warp a pair, the row staged in chunks of at most
  WIDE_STAGE peaks, the branch rule checked chunk by chunk, runs of
  consecutive query peaks a lane searched by binary lifting and the
  reach from the last edge with the same test, the walk or the dense
  loop, the +-0 terms skipped and the others summed in query-peak
  order), on the same cases and at Kc = 257, 300 and 600, Kq up to 300,
  also staged in chunks of 7 to 128 peaks; with its search test mutated
  (>= tol) it differs on the edge case.  The plain version also agrees
  with JAX at Kc = 257 and 600, Kq = 50 and 300.

The rows the main path builds (`preprocess_batch`, `build_store`, the
bench's library) all take the kernel's range search.  CPU tensors never
reach the kernel's wrapper, and the wrapper module imports and refuses
CPU tensors without CUDA.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ann_solo_tpu.ops.rescore import _stage1_bounds as jax_stage1
from ann_solo_tpu_torch import bench, synthdata
from ann_solo_tpu_torch.config import config as torch_config
from ann_solo_tpu_torch.io import store
from ann_solo_tpu_torch.models.preprocess import (
    PreprocessParams,
    preprocess_batch,
)
from ann_solo_tpu_torch.models.spectrum import pack_spectra
from ann_solo_tpu_torch.ops import rescore as pt_rescore
from ann_solo_tpu_torch.ops import stage1_cuda
from ann_solo_tpu_torch.ops.shifted_dot import shifted_dot_scores

F32 = np.float32


def _chip_smoke():
    """`chip_smoke.py` (repo root) as a module, for its generator."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# (B, C, library rows, Kq, Kc, charge, allow_shift, candidate rows,
# share of queries with their row's own precursor, c_chunk, fragment
# tolerance).  A tolerance of 0.5 gives random candidates matching peaks
# too; "bench_k50" keeps the bench's 0.04.
CASES = {
    "shifts_1": (12, 24, 64, 20, 20, 0, True, "bench", 0.25, 8, 0.5),
    "shifts_2": (12, 24, 64, 20, 20, 1, True, "bench", 0.25, 8, 0.5),
    "shifts_3": (12, 24, 64, 20, 20, 2, True, "bench", 0.25, 8, 0.5),
    "shifts_4": (12, 24, 64, 20, 20, 3, True, "bench", 0.25, 8, 0.5),
    "shifts_5": (12, 24, 64, 20, 20, 4, True, "bench", 0.25, 8, 0.5),
    "shifts_6": (8, 16, 64, 20, 20, 5, True, "bench", 0.25, 8, 0.5),
    "no_allow_shift": (12, 24, 64, 20, 20, 2, False, "bench", 0.25, 8, 0.5),
    "prec_within_tol": (12, 24, 64, 20, 20, 2, True, "bench", 1.0, 8, 0.5),
    "kq_gt_kc": (12, 24, 64, 30, 18, 2, True, "bench", 0.25, 8, 0.5),
    "kq_lt_kc": (12, 24, 64, 18, 70, 3, True, "bench", 0.25, 5, 0.5),
    "window": (16, 256, 400, 24, 24, 2, True, "window", 0.25, 64, 0.5),
    "bench_k50": (16, 40, 128, 50, 50, 2, True, "bench", 0.25, 16, 0.04),
    "k56_ragged_tile": (8, 70, 64, 56, 50, 2, True, "bench", 0.25, 70, 0.5),
    "kc_257": (6, 12, 64, 50, 257, 2, True, "bench", 0.25, 8, 0.5),
    "kc_257_kq_300": (4, 8, 64, 300, 257, 2, True, "bench", 0.25, 8, 0.5),
    "kc_600": (4, 8, 64, 50, 600, 2, True, "bench", 0.25, 8, 0.5),
    "kc_600_kq_300": (3, 8, 64, 300, 600, 2, True, "bench", 0.25, 8, 0.5),
}


# Cases of the kernel's split alone, as CASES plus the options of
# `synth_stage1`: preprocess's zero tail, peaks at the windows' float32
# edges (at tol = 2^-5 some exactly on them) with duplicated m/z, shuffled
# rows (the dense branch), non-finite m/z and precursors, NaN and +-inf
# intensities with and without shifts (the dense branch, NaN bounds),
# more query peaks than one pass takes (300 > WARPS * MAX_BLOCK), and a
# row whose width is a power of two (no +inf padding).
SPLIT_CASES = {
    "padded_tail": (16, 64, 128, 50, 50, 2, True, "bench", 0.25, 16, 0.04,
                    {"tail": True}),
    "window_tail": (16, 256, 400, 24, 24, 2, True, "window", 0.25, 64, 0.5,
                    {"tail": True}),
    "edge_at_tol": (16, 40, 64, 50, 50, 2, True, "bench", 0.25, 16, 0.03125,
                    {"edges": 0.03125}),
    "edge_c3": (16, 40, 64, 50, 50, 3, True, "bench", 0.25, 16, 0.04,
                {"edges": 0.04}),
    "duplicates": (16, 40, 64, 50, 50, 2, True, "bench", 0.25, 16, 0.5,
                   {"edges": 0.5}),
    "shuffled": (16, 64, 128, 20, 20, 2, True, "bench", 0.25, 16, 0.5,
                 {"shuffle": 0.3}),
    "nonfinite": (16, 64, 128, 20, 20, 2, True, "bench", 0.25, 16, 0.5,
                  {"nonfinite": True}),
    "intensities": (16, 64, 128, 20, 20, 2, True, "bench", 0.25, 16, 0.5,
                    {"intensities": True}),
    "intensities_noshift": (16, 64, 128, 20, 20, 2, False, "bench", 0.25,
                            16, 0.5, {"intensities": True}),
    "many_query_peaks": (4, 16, 32, 300, 40, 2, True, "bench", 0.25, 16,
                         0.5, {}),
    "full_pow2_row": (8, 32, 64, 40, 64, 2, True, "bench", 0.25, 16, 0.5,
                      {}),
}


# Cases of the wide branch's split alone: a row padded past MAX_PADDED
# with a quarter of the rows shuffled (both branch rules) or with
# non-finite intensities, and the zero tail at Kq = Kc = 300.
WIDE_SPLIT_CASES = {
    "kc_300_shuffled": (4, 16, 64, 50, 300, 2, True, "bench", 0.25, 8, 0.5,
                        {"shuffle": 0.3}),
    "k300_tail": (4, 12, 64, 300, 300, 3, True, "bench", 0.25, 8, 0.04,
                  {"tail": True}),
    "kc_300_intensities": (8, 16, 64, 50, 300, 2, True, "bench", 0.25, 8,
                           0.5, {"intensities": True}),
}


def _case(name):
    case = {**CASES, **SPLIT_CASES, **WIDE_SPLIT_CASES}[name]
    return case[:11], (case[11] if len(case) > 11 else {})


def _inputs(name, all_invalid_rows=()):
    (b, c, n_lib, kq, kc, charge, _, rows, close, _, _), opts = _case(name)
    rng = np.random.default_rng(sum(map(ord, name)))
    arrays = list(_chip_smoke().synth_stage1(
        rng, b, c, n_lib, kq, kc, charge, rows, close_prec=close, **opts))
    for r in all_invalid_rows:
        arrays[7][r] = -1
    return arrays


def _settings(name):
    (_, _, _, _, _, charge, shift, _, _, c_chunk, tol), _ = _case(name)
    return charge + 1, shift, c_chunk, tol


def _plain(arrays, num_shifts, shift, c_chunk, tol):
    return pt_rescore._stage1_bounds(
        *(torch.from_numpy(a) for a in arrays), tol, num_shifts, shift,
        c_chunk,
    ).numpy()


def _numpy_terms(q_mz, q_int, q_prec, l_mz, l_int, l_ann, l_prec, ids, rows,
                 num_shifts, shift, tol):
    """(P, Kq) float32 terms q_int[i] * vmax[i] of the listed pairs, at
    the unpadded widths, in NumPy."""
    qm, qi, cm, ci, ca = (q_mz[rows], q_int[rows], l_mz[ids], l_int[ids],
                          l_ann[ids])
    chg = F32(num_shifts - 1 if shift else 1)
    pd = (q_prec[rows] - l_prec[ids]) * chg
    diff0 = qm[:, :, None] - cm[:, None, :]
    vmax = np.where(np.abs(diff0) <= F32(tol), ci[:, None, :], F32(0)).max(2)
    if shift and num_shifts > 1:
        shifted = (np.abs(pd) >= F32(tol))[:, None, None]
        for s in range(1, num_shifts):
            mult = np.where(ca == s, F32(1), np.where(ca == 0, F32(2 / 3),
                                                      F32(0)))
            ct = (mult * ci)[:, None, :]
            off = (pd / F32(s))[:, None, None]
            within = (np.abs(diff0 - off) <= F32(tol)) & shifted
            vmax = np.maximum(vmax, np.where(within, ct, F32(0)).max(2))
    return qi * vmax


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax(name):
    num_shifts, shift, c_chunk, tol = _settings(name)
    arrays = _inputs(name, all_invalid_rows=(1,))
    exp = np.asarray(jax_stage1(
        *(jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a)
          for a in arrays),
        tol, num_shifts, shift, c_chunk,
    ))
    got = _plain(arrays, num_shifts, shift, c_chunk, tol)
    assert got.dtype == np.float32 and got.shape == arrays[7].shape
    np.testing.assert_array_equal(np.isneginf(got), arrays[7] < 0)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(exp))
    assert np.all(np.isneginf(got[1]))
    finite = np.isfinite(exp)
    assert finite.sum() > 0
    np.testing.assert_allclose(got[finite], exp[finite], rtol=1e-6)
    # The corpus really exercises the bound: many positive bounds.
    assert (got[finite] > 0).mean() > 0.2


@pytest.mark.parametrize("name", ["shifts_3", "shifts_5", "no_allow_shift",
                                  "kq_lt_kc", "window", "bench_k50"])
def test_plain_is_sound(name):
    """Every valid pair's bound is >= its greedy shifted-dot score."""
    num_shifts, shift, c_chunk, tol = _settings(name)
    arrays = _inputs(name)
    got = _plain(arrays, num_shifts, shift, c_chunk, tol)
    q_mz, q_int, q_prec, l_mz, l_int, l_ann, l_prec, cand = arrays
    rows, cols = np.nonzero(cand >= 0)
    ids = cand[rows, cols]
    t = torch.from_numpy
    k = max(q_mz.shape[1], l_mz.shape[1])

    def pad(a, value=0):
        return np.pad(a, ((0, 0), (0, k - a.shape[1])),
                      constant_values=value)

    scores = shifted_dot_scores(
        t(pad(q_mz[rows])), t(pad(q_int[rows])), t(pad(l_mz[ids])),
        t(pad(l_int[ids])), t(pad(l_ann[ids], -1)), t(q_prec[rows]),
        t(l_prec[ids]),
        torch.full((len(ids),), num_shifts - 1 if shift else 1,
                   dtype=torch.int32),
        torch.ones(len(ids), dtype=torch.bool), tol, num_shifts, shift,
    ).numpy()
    assert np.all(got[rows, cols] >= scores)
    assert (scores > 0).mean() > 0.2


@pytest.mark.parametrize("name", sorted(CASES))
def test_sum_order_is_sequential(name):
    """The plain bounds equal a NumPy float32 sequential sum of the same
    terms, exactly."""
    num_shifts, shift, c_chunk, tol = _settings(name)
    arrays = _inputs(name)
    got = _plain(arrays, num_shifts, shift, c_chunk, tol)
    cand = arrays[7]
    rows, cols = np.nonzero(cand >= 0)
    terms = _numpy_terms(*arrays[:7], cand[rows, cols], rows, num_shifts,
                         shift, tol)
    acc = np.zeros(len(rows), F32)
    for i in range(terms.shape[1]):
        acc = acc + terms[:, i]
    want = np.full(cand.shape, -np.inf, F32)
    want[rows, cols] = acc * F32(pt_rescore.BOUND_INFLATION)
    np.testing.assert_array_equal(got, want)


def _emulate_kernel(q_mz, q_int, q_prec, l_mz, l_int, l_ann, l_prec, cand,
                    num_shifts, shift, tol, maximum=np.maximum):
    """Kernel B4's work split in NumPy, all valid pairs at once.  The
    row is staged with +inf for the m/z of its peaks of finite intensity
    <= 0 and past Kc up to `padded_width(Kc)`.  The branch rule: a row
    whose intensities are finite and whose positive peaks are a prefix of
    it, with finite, non-decreasing m/z, takes the range search: per
    query peak and window
    a branchless binary search over log2(padded_width(Kc)) steps for the
    first staged peak with (q - c) - off <= tol, then, if that peak is
    below Kc and passes |(q - c) - off| <= tol, a walk taking the max
    while the test passes, stopping at the first failure or at Kc; any
    other row the dense loop over its Kc staged peaks.  Every max
    propagates NaN (`maximum`; np.fmax, which drops a NaN, is the
    mutation).  The shift windows only for pairs with
    |prec_diff| >= tol; the query peaks in passes of WARPS blocks of
    i_tile(Kq), each term q_int * vmax added in query-peak order unless
    vmax is 0 and q_int finite (a +-0 term)."""
    b, c = cand.shape
    kq, kc = q_mz.shape[1], l_mz.shape[1]
    tol = F32(tol)
    kcp = stage1_cuda.padded_width(kc)
    qb = stage1_cuda.i_tile(kq)
    n_shift = num_shifts - 1 if shift and num_shifts > 1 else 0
    chg = F32(num_shifts - 1 if shift else 1)
    rows, cols = np.nonzero(cand >= 0)
    ids = np.minimum(cand[rows, cols], len(l_mz) - 1)
    pairs = np.arange(len(ids))

    ci, ca = l_int[ids], l_ann[ids]
    pos = ci > 0
    with np.errstate(invalid="ignore"):
        fast = (~(pos[:, 1:] & ~pos[:, :-1]).any(1)
                & ~(pos[:, 1:] & ~(l_mz[ids][:, :-1] <= l_mz[ids][:, 1:]))
                .any(1) & (~pos | np.isfinite(l_mz[ids])).all(1)
                & np.isfinite(ci).all(1))
    cm = np.full((len(ids), kcp), np.inf, F32)
    cm[:, :kc] = np.where(pos | ~np.isfinite(ci), l_mz[ids], F32(np.inf))
    assert np.array_equal(fast, stage1_cuda.ascending_rows(
        torch.from_numpy(l_mz), torch.from_numpy(l_int)).numpy()[ids])

    pd = (q_prec[rows] - l_prec[ids]) * chg
    shifted = (n_shift > 0) & (np.abs(pd) >= tol)
    windows = [(np.zeros(len(ids), F32), np.ones(len(ids), bool), ci)]
    for s in range(1, n_shift + 1):
        mult = np.where(ca == s, F32(1), np.where(ca == 0, F32(2 / 3),
                                                  F32(0)))
        with np.errstate(invalid="ignore"):  # 0 * +-inf
            windows.append((pd / F32(s), shifted, mult * ci))
    acc = np.zeros(len(ids), F32)
    with np.errstate(invalid="ignore", over="ignore"):
        for i0 in range(0, kq, stage1_cuda.WARPS * qb):
            for g in range(stage1_cuda.WARPS):
                for i in range(i0 + g * qb, min(kq, i0 + (g + 1) * qb)):
                    q = q_mz[rows, i]
                    v = np.zeros(len(ids), F32)
                    for off, active, val in windows:
                        at = np.zeros(len(ids), np.int64)
                        step = kcp // 2
                        while step:
                            cc = cm[pairs, at + step - 1]
                            at += np.where((q - cc) - off > tol, step, 0)
                            step //= 2
                        walk = np.zeros(len(ids), F32)
                        alive = np.ones(len(ids), bool)
                        for k in range(kc):
                            j = np.minimum(at + k, kcp - 1)
                            alive &= (at + k < kc) & (
                                np.abs((q - cm[pairs, j]) - off) <= tol)
                            walk = np.where(alive, maximum(
                                walk, val[pairs, np.minimum(j, kc - 1)]),
                                walk)
                        hit = (np.abs((q[:, None] - cm[:, :kc])
                                      - off[:, None]) <= tol)
                        dense = maximum.reduce(
                            np.where(hit, val, F32(0)), axis=1,
                            initial=F32(0))
                        v = np.where(active, maximum(
                            v, np.where(fast, walk, dense)), v)
                    w = q_int[rows, i]
                    term = v != 0
                    term |= ~np.isfinite(w)
                    acc = np.where(term, acc + w * v, acc)
    out = np.full((b, c), -np.inf, F32)
    out[rows, cols] = acc * F32(pt_rescore.BOUND_INFLATION)
    return out, fast


def _emulate_wide(q_mz, q_int, q_prec, l_mz, l_int, l_ann, l_prec, cand,
                  num_shifts, shift, tol, search="gt", stage=None):
    """Kernel B4's wide branch in NumPy, all valid pairs at once: a pair's
    row staged in chunks of `stage` peaks (`stage1_cuda.wide_stage(Kc)`
    by default); the branch rule checked on each chunk (its intensities
    finite, its positive peaks a prefix of it, finite, non-decreasing:
    peak j against peak j - 1 of the chunk), and the search over that
    prefix, here as the chunk's m/z with +inf for a peak of finite
    intensity not > 0 (the same edges: +inf passes no test).
    The query peaks in blocks of at most 32 * WIDE_R, a run of
    consecutive peaks a lane; on a chunk that passes, per window (the
    shift windows only with |prec_diff| >= tol) the lower edge with the
    plain test (q - c) - off > tol: by binary lifting over the chunk for
    a run's first peak and after a peak whose m/z does not ascend, else
    three steps (4, 2, 1) from the previous peak's edge and the lifting
    from there when the test still holds at the edge (at most four shift
    windows; with more, the lifting from 0 for every peak); then the walk
    taking the max while |(q - c) - off| <= tol; on any other chunk every
    peak of it.  Every max propagates NaN.  vmax is the max over the
    chunks; the terms q_int * vmax
    are added in query-peak order from +0.0, the +-0 ones skipped.
    `search` "ge" is the mutation (q - c) - off >= tol."""
    b, c = cand.shape
    kq, kc = q_mz.shape[1], l_mz.shape[1]
    tol = F32(tol)
    stage = stage or stage1_cuda.wide_stage(kc)
    n_shift = num_shifts - 1 if shift and num_shifts > 1 else 0
    chg = F32(num_shifts - 1 if shift else 1)
    rows, cols = np.nonzero(cand >= 0)
    ids = np.minimum(cand[rows, cols], len(l_mz) - 1)
    mz, x, ann = l_mz[ids], l_int[ids], l_ann[ids]
    n_pairs = len(ids)
    pairs = np.arange(n_pairs)
    block = 32 * stage1_cuda.WIDE_R
    per = -(-kq // -(-kq // block)) if kq else 0
    run = -(-per // 32)
    with np.errstate(invalid="ignore", over="ignore"):
        pos = x > 0
        staged = np.where(pos | ~np.isfinite(x), mz, F32(np.inf))
        pd = (q_prec[rows] - l_prec[ids]) * chg
        shifted = (n_shift > 0) & (np.abs(pd) >= tol)
        windows = [(np.zeros(n_pairs, F32), np.ones(n_pairs, bool), x)]
        for s in range(1, n_shift + 1):
            mult = np.where(ann == s, F32(1), np.where(ann == 0, F32(2 / 3),
                                                       F32(0)))
            windows.append((pd / F32(s), shifted, mult * x))
        vmax = np.zeros((n_pairs, kq), F32)
        fast_rows = np.ones(n_pairs, bool)
        for j0 in range(0, kc, stage):
            j1 = min(kc, j0 + stage)
            ln = j1 - j0
            top = 1 << (ln.bit_length() - 1)
            cpos, cmz = pos[:, j0:j1], mz[:, j0:j1]
            prev_pos = np.pad(cpos[:, :-1], ((0, 0), (1, 0)),
                              constant_values=True)
            prev_mz = np.pad(cmz[:, :-1], ((0, 0), (1, 0)))
            first = np.arange(ln) == 0
            ok = prev_pos & (np.abs(cmz) < np.inf) & (first | (prev_mz <= cmz))
            fast = ~(cpos & ~ok).any(1) & np.isfinite(x[:, j0:j1]).all(1)
            fast_rows &= fast
            cm = staged[:, j0:j1]
            cols_k = np.arange(ln)
            for off, active, val in windows:
                cval = val[:, j0:j1]
                edge = np.zeros(n_pairs, np.int64)
                q_prev = np.full(n_pairs, np.nan, F32)
                for i in range(kq):
                    q = q_mz[rows, i]
                    g = (q[:, None] - cm) - off[:, None]
                    past = g > tol if search == "gt" else g >= tol

                    def test(at):
                        return (at < ln) & past[pairs, np.minimum(at, ln - 1)]

                    first_of_run = (i % per) % run == 0
                    reach = ((not first_of_run) & (q >= q_prev)
                             & (n_shift <= 4))
                    at = np.where(reach, edge, 0)
                    for step in (4, 2, 1):
                        at = np.where(reach & (at + step <= ln)
                                      & test(at + step - 1), at + step, at)
                    lift = ~reach | test(at)
                    step = top
                    while step:
                        at = np.where(lift & (at + step <= ln)
                                      & test(at + step - 1), at + step, at)
                        step //= 2
                    edge, q_prev = at, q
                    hit = np.abs(g) <= tol
                    from_edge = cols_k[None, :] >= at[:, None]
                    alive = from_edge & (np.cumsum(~hit & from_edge, 1) == 0)
                    walk = np.maximum.reduce(
                        np.where(alive, cval, F32(0)), axis=1,
                        initial=F32(0))
                    dense = np.maximum.reduce(np.where(hit, cval, F32(0)),
                                              axis=1, initial=F32(0))
                    vmax[:, i] = np.where(active, np.maximum(
                        vmax[:, i], np.where(fast, walk, dense)), vmax[:, i])
        acc = np.zeros(n_pairs, F32)
        for i in range(kq):
            term = q_int[rows, i] * vmax[:, i]
            acc = np.where(term != 0, acc + term, acc)
    out = np.full((b, c), -np.inf, F32)
    out[rows, cols] = acc * F32(pt_rescore.BOUND_INFLATION)
    return out, fast_rows


@pytest.mark.parametrize("name", ["shifts_1", "shifts_3", "shifts_6",
                                  "no_allow_shift", "prec_within_tol",
                                  "kq_lt_kc", "window", "bench_k50",
                                  "k56_ragged_tile", *SPLIT_CASES,
                                  "kc_257", "kc_600_kq_300",
                                  *WIDE_SPLIT_CASES])
def test_wide_branch_emulation_equals_plain(name):
    num_shifts, shift, c_chunk, tol = _settings(name)
    arrays = _inputs(name, all_invalid_rows=(0,))
    got, fast = _emulate_wide(*arrays, num_shifts, shift, tol)
    np.testing.assert_array_equal(
        got, _plain(arrays, num_shifts, shift, c_chunk, tol))
    if name in ("shuffled", "nonfinite", "kc_300_shuffled") or (
            "intensities" in name):
        assert 0 < fast.sum() < len(fast)
    else:
        assert fast.all()


@pytest.mark.parametrize("name,stage", [
    ("kc_257", 100), ("kc_600_kq_300", 128), ("kc_300_shuffled", 64),
    ("k300_tail", 96), ("edge_at_tol", 16), ("shuffled", 7),
    ("nonfinite", 8), ("window_tail", 10), ("shifts_6", 9),
    ("kc_300_intensities", 64),
])
def test_wide_branch_chunked_emulation_equals_plain(name, stage):
    """The wide branch with its rows staged in several chunks (a small
    stage forces it at these widths; on the card rows past WIDE_STAGE
    peaks are): the branch rule chunk by chunk, the searches and walks
    within each chunk, vmax their max; equal to the plain version bit for
    bit, and a shuffled row has chunks on both branches."""
    num_shifts, shift, c_chunk, tol = _settings(name)
    arrays = _inputs(name, all_invalid_rows=(0,))
    assert arrays[3].shape[1] > stage
    got, fast = _emulate_wide(*arrays, num_shifts, shift, tol, stage=stage)
    np.testing.assert_array_equal(
        got, _plain(arrays, num_shifts, shift, c_chunk, tol))
    if name in ("shuffled", "kc_300_shuffled"):
        assert 0 < fast.sum() < len(fast)


def test_wide_search_mutation_fails():
    """The wide branch's search with >= tol in place of the plain test's
    > tol skips the peaks exactly at the window's edge: the bounds
    differ on the edge case, so the test's form is load-bearing."""
    name = "edge_at_tol"
    num_shifts, shift, c_chunk, tol = _settings(name)
    arrays = _inputs(name)
    want = _plain(arrays, num_shifts, shift, c_chunk, tol)
    np.testing.assert_array_equal(
        _emulate_wide(*arrays, num_shifts, shift, tol)[0], want)
    got = _emulate_wide(*arrays, num_shifts, shift, tol, search="ge")[0]
    assert not np.array_equal(got, want)
    got = _emulate_wide(*arrays, num_shifts, shift, tol, search="ge",
                        stage=16)[0]
    assert not np.array_equal(got, want)


@pytest.mark.parametrize("name", ["shifts_1", "shifts_3", "shifts_6",
                                  "no_allow_shift", "prec_within_tol",
                                  "kq_lt_kc", "window", "bench_k50",
                                  "k56_ragged_tile", *SPLIT_CASES])
def test_kernel_split_emulation_equals_plain(name):
    num_shifts, shift, c_chunk, tol = _settings(name)
    arrays = _inputs(name, all_invalid_rows=(0,))
    got, fast = _emulate_kernel(*arrays, num_shifts, shift, tol)
    np.testing.assert_array_equal(
        got, _plain(arrays, num_shifts, shift, c_chunk, tol))
    # Each case takes the branch it was made for.
    if name in ("shuffled", "nonfinite") or "intensities" in name:
        assert 0 < fast.sum() < len(fast)
    else:
        assert fast.all()


@pytest.mark.parametrize("name", ["intensities", "intensities_noshift"])
def test_kernel_split_nan_mutation_fails(name):
    """NaN propagation bears load: with fmax (a NaN value dropped, the
    kernel's maxima before they propagated NaN) the emulation differs
    from the plain version, which has NaN bounds here, where the intact
    emulation agrees."""
    num_shifts, shift, c_chunk, tol = _settings(name)
    arrays = _inputs(name)
    want = _plain(arrays, num_shifts, shift, c_chunk, tol)
    assert np.isnan(want).any()
    np.testing.assert_array_equal(
        _emulate_kernel(*arrays, num_shifts, shift, tol)[0], want)
    got = _emulate_kernel(*arrays, num_shifts, shift, tol,
                          maximum=np.fmax)[0]
    assert not np.array_equal(got, want, equal_nan=True)


def test_edge_case_has_peaks_on_the_edges():
    """`edge_at_tol` really places candidate peaks whose direct difference
    is exactly +-tol in float32 (and others one ulp past it)."""
    arrays = _inputs("edge_at_tol")
    q_mz, l_mz, cand = arrays[0], arrays[3], arrays[7]
    tol = F32(_settings("edge_at_tol")[3])
    rows, cols = np.nonzero(cand >= 0)
    d = np.abs(q_mz[rows][:, :, None] - l_mz[cand[rows, cols]][:, None, :])
    assert (d == tol).sum() > 0
    assert ((d > tol) & (d < tol + F32(1e-3))).sum() > 0


@pytest.fixture
def torch_config_set():
    """The port's config singleton parsed with the CLI's defaults (the
    decoys read the fragment tolerance), restored afterwards."""
    saved = torch_config._namespace
    torch_config.parse(["lib.mgf", "queries.mgf", "out.mztab",
                        "--precursor_tolerance_mass", "20",
                        "--precursor_tolerance_mode", "ppm",
                        "--fragment_mz_tolerance", "0.02"])
    yield
    torch_config._namespace = saved


def test_main_path_rows_take_the_range_search(torch_config_set):
    """The library rows the main path builds are m/z-ascending with a zero
    tail: `preprocess_batch` on raw spectra, `build_store` on a small
    synthetic library (decoys included), and the bench's library."""
    rng = np.random.default_rng(7)
    _, spectra = synthdata.make_library(rng, n_peptides=40)
    params = PreprocessParams()  # the defaults: up to 50 peaks
    packed = pack_spectra(spectra)
    out = preprocess_batch(params, *(torch.from_numpy(a) for a in (
        packed.mz, packed.intensity, packed.ann_charge, packed.n_peaks,
        packed.precursor_mz, packed.precursor_charge)))
    assert bool((out.n_peaks < out.mz.shape[1]).any())  # a real zero tail
    assert bool(stage1_cuda.ascending_rows(out.mz, out.intensity).all())
    built = store.build_store(iter(spectra), "0" * 16, "lib.mgf", params,
                              torch.device("cpu"), add_decoys=True)
    assert built.n_spectra == 2 * len(spectra)
    assert bool(stage1_cuda.ascending_rows(
        torch.from_numpy(built.proc_mz),
        torch.from_numpy(built.proc_intensity)).all())
    lib_mz, lib_int, _, _ = bench.synth_library(rng, 512)
    assert bool(stage1_cuda.ascending_rows(
        torch.from_numpy(lib_mz), torch.from_numpy(lib_int)).all())


@pytest.mark.parametrize("mz,intensity,want", [
    ([1.0, 2.0, 2.0, 3.0], [1.0, 1.0, 1.0, 1.0], True),
    ([1.0, 3.0, 2.0, 0.0], [1.0, 1.0, 1.0, 0.0], False),
    ([1.0, 9.0, 2.0, 0.0], [1.0, 0.0, 1.0, 0.0], False),
    ([1.0, 2.0, 0.0, 0.0], [1.0, 1.0, 0.0, -1.0], True),
    ([1.0, np.nan, 3.0, 4.0], [1.0, 1.0, 1.0, 1.0], False),
    ([1.0, 2.0, np.nan, -5.0], [1.0, 1.0, 0.0, 0.0], True),
    ([1.0, 2.0, np.inf, 0.0], [1.0, 1.0, 1.0, 0.0], False),
    ([-np.inf, 2.0, 3.0, 0.0], [1.0, 1.0, 1.0, 0.0], False),
    ([5.0, 2.0, 3.0, 4.0], [np.nan, 1.0, 1.0, 1.0], False),
    ([0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0], True),
    ([1.0, 2.0, 3.0, 0.0], [1.0, 1.0, np.nan, 0.0], False),
    ([1.0, 2.0, 3.0, 0.0], [1.0, 1.0, -np.inf, 0.0], False),
    ([1.0, 2.0, 3.0, 0.0], [1.0, np.inf, 1.0, 0.0], False),
])
def test_ascending_rows(mz, intensity, want):
    """The branch rule: the intensities must be finite, and the peaks of
    positive intensity a prefix of the row (the zero tail after them is
    ignored) with finite, non-decreasing m/z."""
    got = stage1_cuda.ascending_rows(
        torch.tensor([mz], dtype=torch.float32),
        torch.tensor([intensity], dtype=torch.float32))
    assert got.tolist() == [want]


@pytest.mark.parametrize("kc,width", [(1, 1), (20, 32), (50, 64), (64, 64),
                                      (70, 128), (0, 1)])
def test_padded_width(kc, width):
    assert stage1_cuda.padded_width(kc) == width


def test_smem_bytes_and_limit(monkeypatch):
    """The wrapper's shared-memory count is the kernel's (53,244 bytes at
    K = 50: four blocks of eight warps fit an SM); widths past the staged
    branch's limits (its shared memory, a row padded past MAX_PADDED)
    take the wide branch, chosen without building or loading anything."""
    monkeypatch.setattr(stage1_cuda, "_library", lambda: pytest.fail(
        "the library was loaded"))
    assert stage1_cuda.smem_bytes(50, 50) == 53_244
    assert 4 * (stage1_cuda.smem_bytes(50, 50) + 1024) <= 233_472
    assert stage1_cuda.smem_bytes(50, 256) <= stage1_cuda.SMEM_LIMIT
    assert stage1_cuda.branch(50, 256) == "staged"
    assert stage1_cuda.branch(50, 50) == "staged"
    assert stage1_cuda.smem_bytes(300, 256) > stage1_cuda.SMEM_LIMIT
    assert stage1_cuda.branch(300, 256) == "wide"
    assert stage1_cuda.padded_width(257) > stage1_cuda.MAX_PADDED
    assert stage1_cuda.branch(50, 257) == "wide"
    for kq, kc in ((50, 300), (300, 300), (50, 1024), (100_000, 20)):
        assert stage1_cuda.branch(kq, kc) == "wide"


@pytest.mark.parametrize("kc,stage,span,blocks", [
    (257, 257, 304, 3), (300, 300, 348, 3), (1024, 480, 552, 2),
    (600, 480, 552, 2), (1, 1, 16, 3), (100_000, 480, 552, 2),
])
def test_wide_smem_bytes(kc, stage, span, blocks):
    """The wide branch's staging: a chunk of at most WIDE_STAGE peaks, each
    staged array its peaks and REACH words of padding, rounded up to 4,
    with four words skipped every 32 (a multiple of 4 words, so every
    array starts 16-byte aligned); a block's shared memory (two buffers
    of three arrays and a query block's vmax a warp) leaves three blocks
    an SM at Kc 257 and 300 and two at a full chunk (233,472 bytes an SM,
    1 KB reserved a block)."""
    assert stage1_cuda.wide_stage(kc) == stage
    assert stage1_cuda.wide_span(kc) == span and span % 4 == 0
    smem = stage1_cuda.wide_smem_bytes(kc)
    assert smem == 4 * stage1_cuda.WIDE_WARPS * (
        6 * span + 32 * stage1_cuda.WIDE_R)
    assert smem <= stage1_cuda.SMEM_LIMIT
    assert min(3, 233_472 // (smem + 1024)) == blocks


@pytest.mark.parametrize("kq,tile", [(50, 7), (20, 3), (32, 4), (56, 7),
                                     (128, 16), (7, 1), (1, 1), (300, 32),
                                     (0, 1)])
def test_i_tile(kq, tile):
    assert stage1_cuda.i_tile(kq) == tile


def test_cpu_tensors_never_reach_the_wrapper(monkeypatch):
    """The CPU route is the plain version: the wrapper, its library and its
    launch count are untouched, and the whole rescoring runs."""

    def refuse(*args, **kwargs):
        raise AssertionError("the CPU route reached the kernel")

    monkeypatch.setattr(stage1_cuda, "stage1_bounds", refuse)
    monkeypatch.setattr(stage1_cuda, "_library", refuse)
    before = stage1_cuda.LAUNCHES
    arrays = _inputs("shifts_3")
    t = torch.from_numpy
    best, score, n = pt_rescore.rescore_candidate_matrix(
        *(t(a) for a in arrays), 0.5, 3, True)
    assert stage1_cuda.LAUNCHES == before
    assert best.shape == score.shape == n.shape == (arrays[7].shape[0],)
    assert np.all(n == (arrays[7] >= 0).sum(1))


def test_wrapper_takes_cuda_tensors_only():
    """The wrapper imports without CUDA and raises on CPU tensors before
    building or loading anything."""
    arrays = [torch.from_numpy(a) for a in _inputs("shifts_3")]
    before = stage1_cuda.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        stage1_cuda.stage1_bounds(*arrays, 0.5, 3, True)
    assert stage1_cuda.LAUNCHES == before
    with pytest.raises(ValueError, match="unsupported device"):
        pt_rescore._stage1_bounds(
            *(a.to("meta") for a in arrays), 0.5, 3, True, 8)
