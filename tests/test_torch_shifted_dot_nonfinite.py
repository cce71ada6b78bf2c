"""Kernel B1 and the certificate on non-finite intensities, vs JAX.

A NaN, +inf or -inf intensity on a query or a candidate peak, on a peak
that matches a peak of the other side or on one that matches none, with
and without shifts, at a register width (K = 50) and a wide one (K =
300).  The port's `shifted_dot_full` (the kernel's CPU route,
the plain version) must give the JAX Pallas kernel's results (interpret
mode, K <= 128: the kernel takes no more) and the JAX XLA form's: totals
at the parity tests' rtol 2e-5, atol 1e-6 (NaN and +-inf equal) and the
same peak pairs.  Two rules decide these cases:

* without shifts the reference's entry is a select, ``(q_int if the m/z
  match else 0) * c_int`` (XLA rewrites its converted-predicate product
  so), never ``0 * inf``;
* a pair with a NaN entry takes nothing (the dense loop's first argmax
  is that NaN, which is not > 0).

`_register_kernel` emulates the CUDA register branch (compaction of the
positive entries with the NaN flag, the listed and the recomputing
greedy) in NumPy; it must equal the plain version bit for bit, and with
the flag dropped or the direct rule replaced by the product it must not.
The engine never reaches these cases: `preprocess_batch` leaves no
non-finite intensity (both packages agree).  Rescore stage 1 and the
certificate ladder agree with the JAX package on the same inputs.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ann_solo_tpu.models.preprocess import (
    PreprocessParams as JaxPreprocessParams,
    preprocess_batch as jax_preprocess,
)
from ann_solo_tpu.models.spectrum import Spectrum, pack_spectra
from ann_solo_tpu.ops.rescore import (
    _stage1_bounds as jax_stage1,
    rescore_candidate_matrix as jax_rescore,
)
from ann_solo_tpu.ops.shifted_dot import (
    shifted_dot_best_match as jax_best_match,
)
from ann_solo_tpu.ops.shifted_dot_pallas import (
    PAIR_BLOCK,
    shifted_dot_pallas_full,
)
from ann_solo_tpu_torch.models.preprocess import (
    PreprocessParams,
    preprocess_batch,
)
from ann_solo_tpu_torch.ops import rescore as pt_rescore
from ann_solo_tpu_torch.ops import shifted_dot as pt
from ann_solo_tpu_torch.ops.shifted_dot_cuda import pad_peaks, shifted_dot_full
from ann_solo_tpu_torch.ops.topk import stable_topk_desc, topk_desc_nan_last

from test_torch_rescore import _corpus
from test_torch_shifted_dot import ATOL, RTOL, _batch, _match_sets, _t

F32 = np.float32
VALUES = {"nan": np.nan, "inf": np.inf, "neg_inf": -np.inf}
FAR_MZ = F32(5000.0)  # past every peak, at every shift
CHARGE = 2
TOL = 0.02


def _nonfinite_batch(k, side, value, matched):
    """`_batch` pairs of width K (two zero peaks at the end) with a
    non-finite intensity on one peak of every third pair: a query or a
    candidate peak, moved onto a peak of the other side (`matched`) or to
    an m/z no peak of the other side matches at any shift."""
    n = PAIR_BLOCK if k <= 128 else 16
    arrays = [a.copy() for a in _batch(700 + k, n, k - 2, CHARGE,
                                       kq=k, kc=k, mods=(0.0, 16.0))]
    q_mz, q_int, c_mz, c_int = arrays[:4]
    rng = np.random.default_rng(k)
    rows = np.arange(1, n, 3)
    peak = rng.integers(0, k - 2, len(rows))
    other = rng.integers(0, k - 2, len(rows))
    mz, inten, other_mz = ((q_mz, q_int, c_mz) if side == "query"
                           else (c_mz, c_int, q_mz))
    inten[rows, peak] = F32(VALUES[value])
    mz[rows, peak] = other_mz[rows, other] if matched else FAR_MZ
    return arrays, rows


@pytest.mark.parametrize("k", [50, 300])
@pytest.mark.parametrize("matched", [False, True],
                         ids=["unmatched", "matched"])
@pytest.mark.parametrize("value", list(VALUES))
@pytest.mark.parametrize("side", ["query", "candidate"])
@pytest.mark.parametrize("allow_shift", [False, True],
                         ids=["noshift", "shift"])
def test_nonfinite_intensity_matches_jax(allow_shift, side, value, matched,
                                         k):
    arrays, rows = _nonfinite_batch(k, side, value, matched)
    num_shifts = CHARGE + 1
    args = (TOL, num_shifts, allow_shift)
    total, table = shifted_dot_full(*_t(arrays), *args)
    total = total.numpy()
    got_sets = _match_sets(table)
    if k <= 128:
        exp_total, exp_table = shifted_dot_pallas_full(
            *arrays, *args, interpret=True)
        np.testing.assert_allclose(total, np.asarray(exp_total).ravel(),
                                   rtol=RTOL, atol=ATOL)
        assert got_sets == _match_sets(np.asarray(exp_table)[:, :k])
    exp_total, exp_q, exp_c = (np.asarray(a) for a in jax_best_match(
        *arrays, *args))
    np.testing.assert_allclose(total, exp_total, rtol=RTOL, atol=ATOL)
    assert got_sets == [
        {(int(a), int(b)) for a, b in zip(q, c) if a >= 0}
        for q, c in zip(exp_q, exp_c)]
    # The plain greedy picks the same pairs in the same order.
    _, sel_q, sel_c = pt.shifted_dot_best_match(*_t(arrays), *args)
    np.testing.assert_array_equal(sel_q.numpy(), exp_q)
    np.testing.assert_array_equal(sel_c.numpy(), exp_c)
    # What the rules give: without shifts a query peak that matches
    # nothing leaves its pair's positive entries alone, and a matched
    # +inf query peak makes the total +inf; a NaN entry (every other
    # case with a NaN or a product with +-inf) takes nothing.
    edited = exp_total[rows]
    if side == "query" and not allow_shift and (
            not matched or value == "neg_inf"):
        assert np.isfinite(edited).all() and (edited > 0).all()
    elif side == "query" and not allow_shift and value == "inf":
        assert np.isposinf(edited).all()
    else:
        assert (edited == 0).all()


# --------------------------------------------------------------------- #
# The CUDA register branch (K <= 128), emulated in NumPy

# Positive entries the register kernel lists a pair (`kList` in the
# source); a pair with more recomputes its live entries at each step.
LIST_ENTRIES = 256
TWO_THIRDS = F32(2.0 / 3.0)


def _register_entries(arrays, tol, num_shifts, allow_shift, mutation):
    """(P, K, K) entries as `compact_positive` computes them: ``(mult *
    qi) * ci`` over each pair's active shifts, but the direct rule
    ``(hit ? qi : 0) * ci`` when the flags turn shifts off and the pair
    has a non-finite intensity (the generic path through `entry`)."""
    qm, qi, cm, ci, ca, qp, cp, chg = arrays
    tol = F32(tol)
    pd = (qp - cp) * chg.astype(F32)
    direct = not (allow_shift and num_shifts > 1)
    n_shift = np.where((not direct) & (np.abs(pd) >= tol),
                       np.minimum(num_shifts - 1, chg), 0)
    diff = qm[:, :, None] - cm[:, None, :]
    hit = np.abs(diff) <= tol
    select = np.where(hit, qi[:, :, None], F32(0)) * ci[:, None, :]
    bad = ~(np.isfinite(qi).all(1) & np.isfinite(ci).all(1))[:, None, None]
    mult = hit.astype(F32)
    for s in range(1, num_shifts):
        off = (pd / F32(s))[:, None, None]
        within = (np.abs(diff - off) <= tol) & (s <= n_shift)[:, None, None]
        m = np.where(ca == s, F32(1), np.where(ca == 0, TWO_THIRDS, F32(0)))
        mult = np.maximum(mult, np.where(within, m[:, None, :], F32(0)))
    product = (mult * qi[:, :, None]) * ci[:, None, :]
    if direct and mutation != "product":
        return np.where(bad, select, product)
    return product


def _register_kernel(arrays, tol, num_shifts, allow_shift,
                     cap=LIST_ENTRIES, mutation=None):
    """Kernel B1's register branch on NumPy pairs: (total (P,), match
    (P, K)) as the kernel computes them.  Compaction walks the entries
    in ascending flat order and lists the positive ones (at most `cap`);
    for a pair with a non-finite intensity it flags a NaN entry (a pair
    of finite intensities has none), and a flagged pair takes nothing.
    The greedy takes, at each step, the largest live entry (lowest flat
    index on ties, `v > best`, so NaN never wins), from the list or, past
    `cap`, from all entries recomputed, until it is not > 0.  `mutation`:
    "no_nan_flag" (the flag dropped) or "product" (no direct rule)."""
    p, k = arrays[0].shape
    with np.errstate(invalid="ignore", over="ignore"):
        v = _register_entries(arrays, tol, num_shifts, allow_shift,
                              mutation).reshape(p, k * k)
    total = np.zeros(p, F32)
    match = np.full((p, k), -1, np.int32)
    for q in range(p):
        flat = v[q]
        if np.isnan(flat).any() and mutation != "no_nan_flag":
            continue
        listed = np.nonzero(flat > 0)[0]
        pool = listed if len(listed) <= cap else np.arange(k * k)
        row_free = np.ones(k, bool)
        col_free = np.ones(k, bool)
        t = F32(0)
        for _ in range(k):
            live = pool[row_free[pool // k] & col_free[pool % k]]
            live = live[~np.isnan(flat[live])]
            if not len(live) or not flat[live].max() > 0:
                break
            e = live[np.argmax(flat[live])]  # the first maximum
            t = F32(t + flat[e])
            match[q, e // k] = e % k
            row_free[e // k] = col_free[e % k] = False
        total[q] = t
    return total, match


def _chip_smoke():
    """`chip_smoke.py` (repo root) as a module, for its pair generators."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _smoke_case(p, k, allow_shift, tol):
    """chip_smoke's "intensities" pairs at P pairs of K peaks."""
    cs = _chip_smoke()
    rng = np.random.default_rng(p + k + allow_shift)
    pairs = list(cs.synth_pairs(rng, p, k, k, CHARGE, False))
    cs.b1_variant(rng, pairs, "intensities", tol, CHARGE)
    padded = pad_peaks(*(torch.from_numpy(a) for a in pairs[:5]))
    return [a.numpy() for a in padded] + pairs[5:]


def _plain(arrays, tol, allow_shift):
    total, match = pt.shifted_dot_full_plain(
        *_t(arrays), tol, CHARGE + 1, allow_shift)
    return total.numpy(), match.numpy()


def _same(got, want):
    return (np.array_equal(got[0].view(np.uint32), want[0].view(np.uint32))
            and np.array_equal(got[1], want[1]))


# (name, pairs, K, allow_shift, tolerance, list entries): chip_smoke's
# k50_intensities, noshift_k50_intensities and dense_k50_intensities at
# 256 pairs, and a list of 4 entries (the recompute path at the stage-2
# tolerance).
REGISTER_CASES = {
    "k50_intensities": (256, 50, True, 0.04, LIST_ENTRIES),
    "noshift_k50_intensities": (256, 50, False, 0.04, LIST_ENTRIES),
    "dense_k50_intensities": (256, 50, True, 5000.0, LIST_ENTRIES),
    "noshift_k50_recompute": (256, 50, False, 0.04, 4),
}


@pytest.mark.parametrize("name", list(REGISTER_CASES))
def test_register_emulation_is_the_greedy(name):
    """The register branch's decomposition gives `shifted_dot_full_plain`'s
    totals and match tables bit for bit, with NaN pairs flagged and (for
    the dense case and a short list) the recompute path taken."""
    p, k, allow_shift, tol, cap = REGISTER_CASES[name]
    arrays = _smoke_case(p, k, allow_shift, tol)
    want = _plain(arrays, tol, allow_shift)
    scores = pt.pair_score_matrix(*_t(arrays), tol, CHARGE + 1, allow_shift)
    flat = scores.reshape(p, -1)
    assert bool(torch.isnan(flat).any(1).any())
    assert bool(((flat > 0).sum(1) > cap).any()) == (
        name.startswith("dense") or cap < LIST_ENTRIES)
    if not allow_shift:  # +inf totals, and non-finite peaks left alone
        bad_q = ~np.isfinite(arrays[1]).all(1)
        assert np.isposinf(want[0]).any()
        assert (bad_q & np.isfinite(want[0]) & (want[0] > 0)).any()
    assert _same(_register_kernel(arrays, tol, CHARGE + 1, allow_shift,
                                  cap), want)


@pytest.mark.parametrize("allow_shift", [False, True],
                         ids=["noshift", "shift"])
def test_register_emulation_on_parity_batches(allow_shift):
    """The emulation on the parity test's batches at K = 50 (their first
    48 pairs, 16 of them edited): every side, value and peak, listed and
    recomputed (a list of 8 entries)."""
    for side in ("query", "candidate"):
        for value in VALUES:
            for matched in (False, True):
                arrays, _ = _nonfinite_batch(50, side, value, matched)
                arrays = [a[:48] for a in arrays]
                want = _plain(arrays, TOL, allow_shift)
                for cap in (LIST_ENTRIES, 8):
                    got = _register_kernel(arrays, TOL, CHARGE + 1,
                                           allow_shift, cap)
                    assert _same(got, want), (side, value, matched, cap)


@pytest.mark.parametrize("mutation,name", [
    ("no_nan_flag", "k50_intensities"),
    ("no_nan_flag", "noshift_k50_recompute"),
    ("product", "noshift_k50_intensities"),
])
def test_register_mutation_fails(mutation, name):
    """The NaN flag and the direct rule bear load: with the flag dropped
    (on the listed and on the recompute path) or the product computed
    without shifts, the emulation differs from the plain version where
    the intact emulation agrees."""
    p, k, allow_shift, tol, cap = REGISTER_CASES[name]
    arrays = _smoke_case(p, k, allow_shift, tol)
    want = _plain(arrays, tol, allow_shift)
    args = (arrays, tol, CHARGE + 1, allow_shift, cap)
    assert _same(_register_kernel(*args), want)
    assert not _same(_register_kernel(*args, mutation=mutation), want)


def test_greedy_over_positives_flags_nan_pairs():
    """The plain walk over positive entries (the kernel's decomposition)
    takes nothing from a NaN pair, as the dense greedy does."""
    arrays = _smoke_case(256, 50, True, 0.04)
    scores = pt.pair_score_matrix(*_t(arrays), 0.04, CHARGE + 1, True)
    assert bool(torch.isnan(scores).flatten(1).any(1).any())
    for got, want in zip(pt.greedy_over_positives(scores),
                         pt.greedy_assignment(scores)):
        assert torch.equal(got, want)


# --------------------------------------------------------------------- #
# The engine never reaches these cases


@pytest.mark.parametrize("value", list(VALUES))
@pytest.mark.parametrize("kw", [
    dict(scaling="rank"),
    dict(scaling="sqrt", max_peaks_used=30),
    dict(scaling=None, resolution=1, min_intensity=0.0),
], ids=["rank", "sqrt", "resolution"])
def test_preprocess_leaves_no_nonfinite_intensity(kw, value):
    """A spectrum with a NaN or +inf intensity inside the m/z range comes
    out invalid from both `preprocess_batch`s (its noise floor is NaN or
    +inf, so no peak passes); a -inf peak is dropped by the floor.  No
    output intensity is non-finite, and the two packages agree."""
    rng = np.random.default_rng(17)
    spectra = []
    for i in range(12):
        mz = np.sort(rng.uniform(100.0, 1900.0, 60))
        intensity = rng.uniform(0.01, 1.0, 60)
        if i % 2:
            intensity[rng.integers(0, 60)] = VALUES[value]
        spectra.append(Spectrum(f"s{i}", 600.0, 2, mz, intensity))
    batch = pack_spectra(spectra)
    args = (batch.mz, batch.intensity, batch.ann_charge, batch.n_peaks,
            batch.precursor_mz, batch.precursor_charge)
    exp = jax_preprocess(JaxPreprocessParams(**kw), *args)
    got = preprocess_batch(PreprocessParams(**kw),
                           *(torch.from_numpy(a) for a in args))
    valid = got.is_valid.numpy()
    np.testing.assert_array_equal(valid, exp.is_valid)
    np.testing.assert_array_equal(got.n_peaks.numpy(), exp.n_peaks)
    np.testing.assert_array_equal(got.mz.numpy(), exp.mz)
    np.testing.assert_allclose(got.intensity.numpy(), exp.intensity,
                               atol=1e-6, rtol=0)
    assert np.isfinite(got.intensity.numpy()).all()
    assert valid[0::2].all()
    assert valid[1::2].all() if value == "neg_inf" else not valid[1::2].any()


# --------------------------------------------------------------------- #
# Rescore stage 1 (B4's plain version) and the certificate ladder
#
# A NaN bound makes its pair invalid in stage 2.  `lax.top_k` ranks a NaN
# by its sign bit: XLA on the CPU keeps an input NaN's sign and makes
# inf * 0 negative (ranked last), a CUDA card makes every NaN positive.
# The port ranks every NaN bound last, whatever its sign, so it equals
# the reference on inputs whose NaN carry the sign bit, and gives the
# same winners when the input NaN are positive.


def _nonfinite_corpus(seed, nan_sign=-1.0):
    """`test_torch_rescore`'s conflict corpus with NaN (of `nan_sign`)
    and +-inf intensities on a few query peaks (some moved past every
    library peak, some left where they match) and on a few library
    rows."""
    arrays, cand = _corpus(True, seed)
    q_mz, q_int, _, l_mz, l_int, _, _ = arrays
    rng = np.random.default_rng(seed)
    bad = np.array([np.copysign(np.nan, nan_sign), np.inf, -np.inf], F32)
    rows = rng.choice(q_int.shape[0], 9, replace=False)
    cols = rng.integers(0, q_int.shape[1], len(rows))
    q_int[rows, cols] = bad[np.arange(len(rows)) % 3]
    q_mz[rows[::2], cols[::2]] = FAR_MZ
    lib_rows = rng.choice(l_int.shape[0], 30, replace=False)
    l_int[lib_rows, rng.integers(0, l_int.shape[1], len(lib_rows))] = (
        bad[np.arange(len(lib_rows)) % 3])
    return arrays, cand


@pytest.mark.parametrize("allow_shift", [False, True],
                         ids=["noshift", "shift"])
def test_stage1_bounds_nonfinite_match_jax(allow_shift):
    """The bounds equal the JAX `_stage1_bounds`' where they are finite,
    and are NaN and +-inf in the same cells."""
    arrays, cand = _nonfinite_corpus(31)
    exp = np.asarray(jax_stage1(
        *(jnp.asarray(a) for a in arrays), jnp.asarray(cand),
        TOL, 3, allow_shift, 8))
    got = pt_rescore._stage1_bounds(
        *_t(arrays), torch.from_numpy(cand).long(), TOL, 3, allow_shift,
        8).numpy()
    assert np.isnan(got).any() and np.isposinf(got).any()
    np.testing.assert_allclose(got, exp, rtol=1e-6, atol=0)
    assert np.signbit(exp[np.isnan(exp)]).all()  # all ranked last


@pytest.mark.parametrize("allow_shift", [False, True],
                         ids=["noshift", "shift"])
@pytest.mark.parametrize("seed", [31, 37])
def test_rescore_nonfinite_matches_jax(seed, allow_shift):
    """The certificate ladder's winners, scores (+inf where a matched
    +inf query peak wins without shifts) and candidate counts equal the
    JAX `rescore_candidate_matrix`'s, and the port's are the same with
    the input NaN positive."""
    arrays, cand = _nonfinite_corpus(seed)
    kw = dict(top_t=4)
    exp_idx, exp_score, exp_n = jax_rescore(
        *(jnp.asarray(a) for a in arrays), jnp.asarray(cand),
        TOL, 3, allow_shift, use_pallas=False, **kw)
    assert np.isposinf(exp_score).any() == (not allow_shift)
    for nan_sign in (-1.0, 1.0):
        arrays, cand = _nonfinite_corpus(seed, nan_sign)
        got_idx, got_score, got_n = pt_rescore.rescore_candidate_matrix(
            *_t(arrays), torch.from_numpy(cand), TOL, 3, allow_shift, **kw)
        np.testing.assert_array_equal(got_idx, exp_idx)
        np.testing.assert_allclose(got_score, exp_score, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(got_n, exp_n)


def test_topk_desc_nan_last():
    """The rank of the bounds: IEEE total order (-0.0 below +0.0), every
    NaN last whatever its sign, ties to the lower index; without NaN and
    -0.0 the same as `stable_topk_desc`."""
    nan = np.float32(np.nan)
    x = torch.tensor([[1.0, nan, -np.inf, np.inf, -nan, 2.0, 0.0, -0.0,
                       2.0]])
    values, idx = topk_desc_nan_last(x, 9)
    assert idx.tolist() == [[3, 5, 8, 0, 6, 7, 2, 1, 4]]
    assert torch.equal(values[:, :7], x[:, [3, 5, 8, 0, 6, 7, 2]])
    y = torch.from_numpy(np.random.default_rng(3).integers(
        -4, 5, (6, 40)).astype(np.float32))
    for a, b in zip(topk_desc_nan_last(y, 17), stable_topk_desc(y, 17)):
        assert torch.equal(a, b)
