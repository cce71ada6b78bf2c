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
* equal, bit for bit, a NumPy emulation of the kernel's own work split
  (blocks of `THREADS` candidate slots, staged chunks of candidate peaks,
  query tiles of `i_tile(Kq)` peaks, unpadded widths).

CPU tensors never reach the kernel's wrapper, and the wrapper module
imports and refuses CPU tensors without CUDA.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ann_solo_tpu.ops.rescore import _stage1_bounds as jax_stage1
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
}


def _inputs(name, all_invalid_rows=()):
    b, c, n_lib, kq, kc, charge, _, rows, close, _, _ = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    arrays = list(_chip_smoke().synth_stage1(
        rng, b, c, n_lib, kq, kc, charge, rows, close_prec=close))
    for r in all_invalid_rows:
        arrays[7][r] = -1
    return arrays


def _settings(name):
    _, _, _, _, _, charge, shift, _, _, c_chunk, tol = CASES[name]
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
                    num_shifts, shift, tol):
    """Kernel B4's work split in NumPy: a block per (query row, tile of
    THREADS slots), leaving at once when the tile holds no valid id; the
    candidates' peaks staged in chunks of MAX_CHUNK; a thread's query
    peaks in tiles of i_tile(Kq), their maxima over every staged chunk,
    then the tile's terms added to the running sum in order; products 0
    for the shifted terms of a pair outside the shift condition."""
    b, c = cand.shape
    kq, kc = q_mz.shape[1], l_mz.shape[1]
    it = stage1_cuda.i_tile(kq)
    chunk = min(kc, stage1_cuda.MAX_CHUNK)
    n_shift = num_shifts - 1 if shift and num_shifts > 1 else 0
    chg = F32(num_shifts - 1 if shift else 1)
    out = np.full((b, c), -np.inf, F32)
    for row in range(b):
        for t0 in range(0, c, stage1_cuda.THREADS):
            ids = cand[row, t0:t0 + stage1_cuda.THREADS]
            valid = ids >= 0
            if not valid.any():
                continue
            ids = np.minimum(ids[valid], len(l_mz) - 1)
            pd = (q_prec[row] - l_prec[ids]) * chg
            shifted = np.abs(pd) >= F32(tol)
            offs = [pd / F32(s) for s in range(1, n_shift + 1)]
            acc = np.zeros(len(ids), F32)
            for i0 in range(0, kq, it):
                qm = q_mz[row, i0:i0 + it]
                vmax = np.zeros((len(ids), len(qm)), F32)
                for j0 in range(0, kc, chunk):
                    for j in range(j0, min(j0 + chunk, kc)):
                        cm, ci, ca = (l_mz[ids, j], l_int[ids, j],
                                      l_ann[ids, j])
                        d = qm[None, :] - cm[:, None]
                        hit = np.abs(d) <= F32(tol)
                        vmax = np.where(hit, np.maximum(vmax, ci[:, None]),
                                        vmax)
                        for s, off in enumerate(offs, start=1):
                            mult = np.where(ca == s, F32(1), np.where(
                                ca == 0, F32(2 / 3), F32(0)))
                            ct = np.where(shifted, mult * ci, F32(0))
                            hit = np.abs(d - off[:, None]) <= F32(tol)
                            vmax = np.where(
                                hit, np.maximum(vmax, ct[:, None]), vmax)
                for ii in range(len(qm)):
                    acc = acc + q_int[row, i0 + ii] * vmax[:, ii]
            slots = t0 + np.nonzero(valid)[0]
            out[row, slots] = acc * F32(pt_rescore.BOUND_INFLATION)
    return out


@pytest.mark.parametrize("name", ["shifts_1", "shifts_3", "shifts_6",
                                  "no_allow_shift", "prec_within_tol",
                                  "kq_lt_kc", "window", "bench_k50",
                                  "k56_ragged_tile"])
def test_kernel_split_emulation_equals_plain(name):
    num_shifts, shift, c_chunk, tol = _settings(name)
    arrays = _inputs(name, all_invalid_rows=(0,))
    got = _emulate_kernel(*arrays, num_shifts, shift, tol)
    np.testing.assert_array_equal(
        got, _plain(arrays, num_shifts, shift, c_chunk, tol))


@pytest.mark.parametrize("kq,tile", [(50, 10), (20, 10), (32, 16),
                                     (56, 8), (128, 16), (7, 8), (1, 8)])
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
