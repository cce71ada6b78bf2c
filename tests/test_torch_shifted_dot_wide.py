"""Kernel B1's wide branch (K > 128), emulated in NumPy on the CPU.

The CUDA kernel (`ann_solo_tpu_torch/csrc/shifted_dot.cu`,
`shifted_dot_greedy_wide_kernel`) cannot run here, so `_wide_kernel`
repeats its decomposition step by step: the branch rule
(`shifted_dot_cuda.search_pairs`), the binary search and walk of each
active m/z window over a sorted candidate row with the plain version's
own float32 tests, each passing peak evaluated once in the first window
it passes, the rank order (value desc, i asc, j asc) and one walk over
it, and past the on-chip list the overflow rule (each row's best live
entry, the argmax over rows, rescans of the rows whose best column was
taken).  Every case must equal `shifted_dot_full_plain` bit for bit;
each mutation of one rule must not.
"""

import numpy as np
import pytest
import torch

from ann_solo_tpu_torch.ops import shifted_dot as pt
from ann_solo_tpu_torch.ops import shifted_dot_cuda

F32 = np.float32
TWO_THIRDS = F32(2.0 / 3.0)
# Positive entries the kernel sorts on chip (`kWideList` in the source);
# a pair with more takes the overflow path.
LIST_ENTRIES = 1024


def _row_depth(k):
    """Entries a row the kernel's overflow path caches at K <= 1,638: as
    many as its 16 KB region holds beside 2 bytes a row (`wide_row_depth`
    in the source).  The picks do not depend on it."""
    return (16384 - 2 * k) // (8 * k)


def _chip_smoke():
    """`chip_smoke.py` (repo root) as a module, for its pair generators."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _entries(qm, qi, cm, ci, ca, off, n_shift, tol, direct):
    """entry(i, j) as the kernel computes it, elementwise; `off` has the
    shift offsets on its last axis (off[..., s - 1] = prec_diff / s);
    `direct`: the direct rule (no shifts), a select of q_int."""
    diff = qm - cm
    if direct:
        return np.where(np.abs(diff) <= tol, qi, F32(0)) * ci
    mult = (np.abs(diff) <= tol).astype(F32)
    for s in range(1, off.shape[-1] + 1):
        within = (np.abs(diff - off[..., s - 1]) <= tol) & (s <= n_shift)
        m = np.where(ca == s, F32(1), np.where(ca == 0, TWO_THIRDS, F32(0)))
        mult = np.maximum(mult, np.where(within, m, F32(0)))
    return (mult * qi) * ci


def _candidates(arrays, tol, num_shifts, allow_shift, mutation=None):
    """The (pair, i, j) the kernel evaluates: on the search rule each
    query peak of positive intensity walks the passing range of each
    active window, found by a binary search (all rows in lockstep),
    skipping peaks that pass an earlier window; a query peak of negative
    intensity and every row of a pair off the rule walk the whole row."""
    qm, qi, cm, ci, ca, qp, cp, chg = arrays
    p, k = qm.shape
    tol = F32(tol)
    search = shifted_dot_cuda.search_pairs(
        *(torch.from_numpy(a) for a in (qi, cm, ci)), float(tol)).numpy()
    n_pos = (ci > 0).sum(1)
    pd = (qp - cp) * chg.astype(F32)
    shifted = allow_shift and num_shifts > 1
    n_shift = np.where(shifted & (np.abs(pd) >= tol),
                       np.clip(chg, 0, num_shifts - 1), 0)
    off = pd[:, None] / np.arange(1, max(num_shifts, 2), dtype=F32)[None]
    pp = np.broadcast_to(np.arange(p)[:, None], (p, k))
    rows = search[:, None] & (qi > 0)
    got = []
    windows = 1 if mutation == "no_shifts" else int(n_shift.max()) + 1

    def g(j, w):
        d = qm - cm[pp, j]
        return d if w == 0 else d - off[:, w - 1][:, None]

    def passes_before(j, w):
        d = qm - cm[pp, j]
        hit = np.zeros(d.shape, bool) if w == 0 else np.abs(d) <= tol
        for s in range(1, w):
            hit |= np.abs(d - off[:, s - 1][:, None]) <= tol
        return hit

    for w in range(windows):
        edge = qm if w == 0 else qm - off[:, w - 1][:, None]
        if mutation == "rearranged":  # c >= (q - off) - tol, and + tol
            low, high = edge - tol, edge + tol

            def first(j):
                return cm[pp, j] >= low

            def inside(j):
                return cm[pp, j] <= high
        else:
            def first(j):
                return g(j, w) <= tol

            def inside(j):
                return g(j, w) >= -tol
        act = rows & (n_shift >= w)[:, None]
        lo = np.zeros((p, k), np.int64)
        n = np.where(act, n_pos[:, None], 0)
        while (n > 0).any():
            half = n >> 1
            ok = first(np.minimum(lo + half, k - 1))
            go = n > 0
            lo = np.where(go & ~ok, lo + half + 1, lo)
            n = np.where(go, np.where(ok, half, n - half - 1), 0)
        j = lo
        live = act & (j < n_pos[:, None])
        while live.any():
            jj = np.minimum(j, k - 1)
            live &= inside(jj)
            take = live & ~passes_before(jj, w)
            got.append(np.stack([pp[take], np.nonzero(take)[1], jj[take]]))
            j = j + 1
            live &= j < n_pos[:, None]
    dense = ~search[:, None] | (qi < 0)
    for pi, i in zip(*np.nonzero(dense)):
        got.append(np.stack([np.full(k, pi), np.full(k, i), np.arange(k)]))
    pij = np.concatenate(got, 1) if got else np.zeros((3, 0), np.int64)
    pi, i, j = pij
    direct = not shifted and mutation != "product"
    v = _entries(qm[pi, i], qi[pi, i], cm[pi, j], ci[pi, j], ca[pi, j],
                 off[pi], n_shift[pi], tol, direct)
    return pi, i, j, v


def _wide_kernel(arrays, tol, num_shifts, allow_shift, cap=None,
                 depth=None, mutation=None):
    """Kernel B1's wide branch on NumPy pairs: (total (P,), match (P, K))
    bit for bit as the kernel computes them.  `mutation` breaks one rule:
    "no_shifts" (the search drops the shift windows), "rearranged" (the
    window edges tested as c >= (q - off) - tol and c <= (q - off) + tol),
    "columns" (the walk ignores taken columns), "j_first" (ties broken by
    j before i), "j_desc" (ties in a row to the higher column),
    "no_rescan" (a row whose full cache runs out is dropped), "product"
    (no shifts, the entry a product instead of the direct rule's select).  `cap`
    and `depth` override the list's length and the overflow path's cache
    a row."""
    cap = LIST_ENTRIES if cap is None else cap
    p, k = arrays[0].shape
    depth = _row_depth(k) if depth is None else depth
    with np.errstate(invalid="ignore", over="ignore"):
        pi, i, j, v = _candidates(arrays, tol, num_shifts, allow_shift,
                                  mutation)
    total = np.zeros(p, F32)
    match = np.full((p, k), -1, np.int32)
    for q in range(p):
        at = pi == q
        if np.isnan(v[at]).any():  # the dense loop's argmax is NaN
            continue
        at &= v > 0
        ei, ej, ev = i[at], j[at], v[at]
        row_free = np.ones(k, bool)
        col_free = np.ones(k, bool)
        t = F32(0)
        if len(ev) <= cap:
            keys = {"j_first": (ei, ej, -ev),
                    "j_desc": (-ej, ei, -ev)}.get(mutation, (ej, ei, -ev))
            for e in np.lexsort(keys):
                if row_free[ei[e]] and (col_free[ej[e]]
                                        or mutation == "columns"):
                    t = F32(t + ev[e])
                    match[q, ei[e]] = ej[e]
                    row_free[ei[e]] = col_free[ej[e]] = False
        else:
            dense = np.full((k, k), -np.inf, F32)
            dense[ei, ej] = ev
            cache = [[] for _ in range(k)]  # a row's live entries, (v, j)

            def rescan(r):
                live = np.nonzero(col_free & (dense[r] > 0))[0]
                top = np.lexsort((live, -dense[r, live]))[:depth]
                cache[r] = [(dense[r, live[e]], live[e]) for e in top]
                full[r] = len(cache[r]) == depth

            full = np.zeros(k, bool)
            for r in range(k):
                rescan(r)
            while any(cache):
                bi = min((r for r in range(k) if cache[r]),
                         key=lambda r: (-cache[r][0][0], r))
                bv, bj = cache[bi][0]
                t = F32(t + bv)
                match[q, bi] = bj
                col_free[bj] = False
                cache[bi] = []
                for r in range(k):
                    if cache[r] and cache[r][0][1] == bj:
                        while cache[r] and not col_free[cache[r][0][1]]:
                            cache[r].pop(0)
                        if (not cache[r] and full[r]
                                and mutation != "no_rescan"):
                            rescan(r)
        total[q] = t
    return total, match


def _case(name):
    """(NumPy arrays padded to one width, tolerance, num_shifts,
    allow_shift) of a named case, made by chip_smoke's generators; the
    "noshift" cases run without shifts."""
    cs = _chip_smoke()
    p, kq, kc, charge, ties, tol, variant = {
        "k129_ties": (48, 129, 129, 2, True, 0.04, None),
        "k129_ties_c3": (24, 129, 129, 3, True, 0.04, None),
        "k300": (32, 300, 300, 2, False, 0.04, None),
        "k300_tail": (24, 300, 200, 2, False, 0.04, None),
        "shuffled": (32, 160, 160, 2, False, 0.04, "shuffled"),
        "nonfinite": (48, 160, 160, 3, False, 2.0 ** -5, "nonfinite"),
        "edges": (48, 160, 160, 2, False, 2.0 ** -5, "edges"),
        "intensities": (48, 140, 140, 2, False, 0.04, "intensities"),
        "noshift_intensities": (48, 140, 140, 2, False, 0.04,
                                "intensities"),
        "dense_k150": (4, 150, 150, 2, False, 5000.0, None),
        "dense_skew": (4, 150, 150, 2, False, 5000.0, "skew"),
        "dense_few": (4, 160, 160, 2, False, 5000.0, "few"),
    }[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    pairs = list(cs.synth_pairs(rng, p, kq, kc, charge, ties))
    if variant:
        cs.b1_variant(rng, pairs, variant, tol, charge)
    padded = shifted_dot_cuda.pad_peaks(
        *(torch.from_numpy(a) for a in pairs[:5]))
    arrays = [a.numpy() for a in padded] + pairs[5:]
    return arrays, tol, charge + 1, not name.startswith("noshift")


def _plain(arrays, tol, num_shifts, allow_shift):
    total, match = pt.shifted_dot_full_plain(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays),
        tol, num_shifts, allow_shift)
    return total.numpy(), match.numpy()


def _same(got, want):
    return (np.array_equal(got[0].view(np.uint32), want[0].view(np.uint32))
            and np.array_equal(got[1], want[1]))


# (case, list entries, cached entries a row): K just past the register
# branch with ties, K = 300, the engine's zero tails (Kq 300 against Kc
# 200), a quarter of the candidate rows shuffled (the dense rule),
# non-finite m/z and precursors with window-edge peaks, peaks at the
# float32 window edges, non-finite and negative intensities (NaN entries,
# gaps; without shifts also +inf entries, the direct rule), every entry
# positive (the overflow path), every row preferring
# the same column in turn (also with one cached entry a row: a rescan
# each step), 40 positive peaks a side (1,600 entries on 40 rows and
# columns, the search rule on the overflow path), and a list too short for K = 129 (the overflow path on the
# search rule, also with two cached entries a row).
@pytest.mark.parametrize("name,cap,depth", [
    ("k129_ties", None, None), ("k300", None, None),
    ("k300_tail", None, None), ("shuffled", None, None),
    ("nonfinite", None, None), ("edges", None, None),
    ("intensities", None, None), ("noshift_intensities", None, None),
    ("dense_k150", None, None),
    ("dense_skew", None, None), ("dense_skew", None, 1),
    ("dense_few", None, None),
    ("k129_ties_c3", 16, None), ("k129_ties_c3", 16, 2),
], ids=["k129_ties", "k300", "k300_tail", "shuffled", "nonfinite", "edges",
        "intensities", "noshift_intensities", "dense_k150", "dense_skew",
        "dense_skew_depth1", "dense_few", "k129_overflow",
        "k129_overflow_depth2"])
def test_wide_emulation_is_the_greedy(name, cap, depth):
    """The wide kernel's decomposition gives `shifted_dot_full_plain`'s
    totals and match tables bit for bit, with both rules and (for the
    dense and overflow cases) the overflow path taken as stated."""
    arrays, tol, num_shifts, shift = _case(name)
    want = _plain(arrays, tol, num_shifts, shift)
    got = _wide_kernel(arrays, tol, num_shifts, shift, cap, depth)
    search = shifted_dot_cuda.search_pairs(
        *(torch.from_numpy(arrays[a]) for a in (1, 2, 3)), tol).numpy()
    if name in ("shuffled", "nonfinite") or name.endswith("intensities"):
        assert search.any() and not search.all()
    else:
        assert search.all()
    scores = pt.pair_score_matrix(
        *(torch.from_numpy(a) for a in arrays), tol, num_shifts, shift)
    n_pos = (scores > 0).sum((1, 2)).numpy()
    limit = LIST_ENTRIES if cap is None else cap
    if name.startswith("dense") or cap is not None:
        assert (n_pos > limit).any()
    else:
        assert 0 < n_pos.max() <= limit
    if name.endswith("intensities"):
        assert torch.isnan(scores).any() and (want[0] == 0).any()
    if name == "noshift_intensities":  # +inf entries listed and taken
        assert np.isposinf(want[0]).any()
    assert _same(got, want)


@pytest.mark.parametrize("mutation,name,depth", [
    ("no_shifts", "k300", None), ("rearranged", "edges", None),
    ("columns", "k300", None), ("j_desc", "k129_ties", None),
    ("no_rescan", "dense_skew", 2), ("product", "noshift_intensities", None),
])
def test_wide_mutation_fails(mutation, name, depth):
    """Each rule is load-bearing: the emulation with it broken (the shift
    windows dropped, the window edges tested by a rearranged expression,
    the walk blind to taken columns, ties in a row to the higher column,
    a row dropped when its full cache runs out, the product for the
    direct rule) differs from the plain version on a case where the
    intact emulation agrees."""
    arrays, tol, num_shifts, shift = _case(name)
    want = _plain(arrays, tol, num_shifts, shift)
    assert _same(_wide_kernel(arrays, tol, num_shifts, shift, depth=depth),
                 want)
    assert not _same(_wide_kernel(arrays, tol, num_shifts, shift,
                                  depth=depth, mutation=mutation), want)


def test_wide_tie_order_across_rows_is_free():
    """Ties broken by j before i give the same picks, totals and tables:
    entries that share a row are ordered by j and entries that share a
    column by i under either rule, and the greedy's picks depend only on
    the order of entries that conflict; the taken entries of one value
    add the same float32 sum in any order.  (So this mutation cannot
    fail; the tie rule within a row, `j_desc` above, is the one that
    bears load.)"""
    arrays, tol, num_shifts, _ = _case("k129_ties")
    want = _plain(arrays, tol, num_shifts, True)
    scores = pt.pair_score_matrix(
        *(torch.from_numpy(a) for a in arrays), tol, num_shifts, True)
    pos = scores[scores > 0]
    assert len(torch.unique(pos)) < len(pos)  # ties compete
    assert _same(
        _wide_kernel(arrays, tol, num_shifts, True, mutation="j_first"),
        want)


def test_search_pairs_rule():
    """The branch rule: positive candidate peaks a prefix with finite,
    non-decreasing m/z (equal m/z allowed; the tail's m/z, even NaN, and
    its intensities <= 0 do not count),
    every intensity of the pair finite, and a finite tolerance."""
    f = torch.tensor
    mz = f([[1.0, 2.0, 2.0, 3.0], [1.0, 3.0, 2.0, 0.0],
            [1.0, 2.0, 0.0, 5.0], [1.0, 2.0, 3.0, 4.0],
            [1.0, float("nan"), 3.0, 4.0], [1.0, float("inf"), 0.0, 0.0],
            [4.0, 5.0, 0.0, 9.0], [1.0, 2.0, 3.0, 4.0],
            [1.0, 3.0, float("nan"), 0.5]])
    inten = f([[1.0, 1.0, 1.0, 1.0], [1.0, 1.0, 1.0, 0.0],
               [1.0, 1.0, 0.0, 1.0], [1.0, 1.0, -1.0, 0.0],
               [1.0, 1.0, 0.0, 0.0], [1.0, 1.0, 0.0, 0.0],
               [1.0, 1.0, 0.0, float("nan")], [1.0, 1.0, 1.0, 1.0],
               [1.0, 1.0, 0.0, 0.0]])
    q_int = torch.ones(9, 4)
    q_int[7, 2] = float("inf")
    got = shifted_dot_cuda.search_pairs(q_int, mz, inten, 0.02)
    assert got.tolist() == [True, False, False, True, False, False, False,
                            False, True]
    assert not shifted_dot_cuda.search_pairs(
        q_int[:1], mz[:1], inten[:1], float("inf")).any()
    # The rows the engine builds: preprocess's sorted peaks, zero tail.
    arrays, tol, _, _ = _case("k300_tail")
    assert shifted_dot_cuda.search_pairs(
        *(torch.from_numpy(arrays[a]) for a in (1, 2, 3)), tol).all()

