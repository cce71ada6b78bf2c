"""The probe path's selection (kernel B5's plain version and its routing)
and the full scan's card route, vs the JAX package.

Inputs are made with NumPy from a seed and fed to both packages.

* (a) `ops.canonical_select.canonical_select_plain` equals, bit for bit,
  the JAX tail of `_ivf_probe_scan_tile` (`_canonical_topk` on 16-bit
  keys, the id gather, `_dedup_topk`, `_pad_topk`): ties at the threshold
  key, rows with every lane masked, fewer finite lanes than k_sel, both
  copies of an id inside the selection and across its edge, no dedup,
  k_sel above the lane count, more than 65,536 lanes (where JAX takes
  `lax.top_k` on int16 keys), and more than 4,096 lanes selected (k_sel
  4,097 and 8,192, and k_sel = n on a 16,384-lane row: the kernel's wide
  branch).
* (b) A NumPy emulation of the kernel's own algorithm (pass 1 keys each
  lane once into the on-chip key array at lane + the row's misalignment,
  its other positions holding junk, with the high-byte histogram; passes
  2 and 3 over that array, or over the row keyed again for the long-row
  branch: the low-byte histogram with the threshold searches from the top
  bin, then the compaction in lane order, chunk by chunk, each thread's
  first tie rank and slot from the sums of the counts at and above the
  threshold over the threads before it; the sort network of 32-bit
  words with its register and shared-memory strides; the decode; the
  dedup through the hash table, inserts in a shuffled order, and the
  prefix count of the kept ranks) equals the plain version on those
  cases and on random rows, on every branch and under several insert
  orders.  The wide branch's split: 64-bit words key << 32 | (2^32 - 1 -
  lane), the bitonic network with its strides below the 8,192-word tile
  on tiles and the larger ones over the whole workspace, the dedup table
  of 2 * m slots in device memory (shuffled inserts), the kept ranks
  placed 512 a step.  The same emulation with the tie rule mutated (the
  last lanes at the threshold instead of the first), the dedup's (each
  id's last rank) or the wide words' lane order (descending) does not.
  The wrapper's `plan` gives every phase 3e shape its branch and shared
  memory as the kernel's header states them.
* (c) The full scan's card route (each query's probed lists through B2,
  then B5) run on CPU tensors through their plain versions, against the
  port's plain full scan and the JAX `_ivf_search_fullscan`: >= 99.9% of
  (id, score) lanes equal, every 16-bit key within one step, no duplicate
  ids, and rows identical wherever the two f32 sums give the same keys.
  The same at 4,096 candidates of x2 storage (k_sel 8,192 lanes, the
  wide branch on the card).
* (d) Routing: CPU tensors never reach the wrapper or its library, the
  wrapper refuses CPU tensors, its limits raise and its plan picks the
  wide branch before anything is built, `search_device` keeps the plain
  full scan on the CPU, and the import rules of `test_torch_imports.py`
  cover the new modules.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ann_solo_tpu.index import ivf as jivf
from ann_solo_tpu_torch.index import ivf as pivf
from ann_solo_tpu_torch.ops import canonical_select as psel
from ann_solo_tpu_torch.ops import select_cuda
from ann_solo_tpu_torch.ops.ivf_probe import ivf_probe_scan_plain

from test_ivf import IvfConfig, _clustered_vectors
from test_torch_ivf import _port

F32 = np.float32


# (name, rows, L, P, cap, k_sel, k, redundant, options)
CASES = {
    "ties": (6, 32, 8, 16, 40, 24, True, {"levels": 4}),
    "ties_x1": (6, 32, 8, 16, 24, 24, False, {"levels": 4}),
    "all_masked": (5, 32, 8, 16, 40, 24, True, {"masked_rows": (0, 3)}),
    "few_finite": (5, 32, 8, 16, 40, 24, True, {"finite": 0.15}),
    "copies": (6, 16, 8, 16, 48, 24, True, {"copies": True,
                                             "levels": 16}),
    "not_redundant": (6, 32, 8, 16, 24, 24, False, {}),
    "x1_k_sel_above_k": (6, 32, 8, 16, 40, 24, False, {}),
    "k_sel_above_n": (4, 16, 4, 8, 80, 24, True, {"copies": True}),
    "wide": (2, 96, 70, 1000, 300, 150, True, {"copies": True,
                                               "levels": 64}),
    "bench_like": (3, 512, 64, 96, 1024, 512, True, {"copies": True,
                                                     "levels": 256}),
    "odd": (5, 40, 7, 13, 48, 24, True, {"copies": True, "levels": 16}),
    "k_4097": (2, 64, 32, 160, 4097, 4097, False, {"levels": 64}),
    "k_8192": (2, 128, 64, 256, 8192, 4096, True, {"copies": True,
                                                   "levels": 64}),
    "k_all_16384": (2, 128, 64, 256, 16384, 8192, True, {"copies": True,
                                                         "levels": 4}),
}
# The cases whose selection passes MAX_SEL (the kernel's wide branch).
WIDE_CASES = ("k_4097", "k_8192", "k_all_16384")


def _case(name, seed=0):
    """(flat, probe_ids, padded_ids, k_sel, k, redundant) as NumPy arrays.

    padded_ids: each list's slots hold ids, about 10% empty (-1); with
    "copies" every id sits in two slots of different lists, as redundant
    storage places it, and both copies carry the same score (stored copies
    are bit-identical).  Scores are a per-(row, id) draw on `levels`
    values (ties at every key) or continuous, with 30% of the ids masked
    (the window), rows in "masked_rows" all -inf, and with "finite" only
    that share of the ids finite."""
    b, l, p, cap, k_sel, k, redundant, opts = CASES[name]
    rng = np.random.default_rng(1000 + seed)
    slots = l * cap
    if opts.get("copies"):
        n_ids = slots // 2
        ids = np.concatenate([rng.permutation(n_ids), rng.permutation(n_ids)])
        ids = np.pad(ids, (0, slots - len(ids)), constant_values=-1)
    else:
        n_ids = slots
        ids = rng.permutation(n_ids)
    ids = np.where(rng.random(slots) < 0.1, -1, ids).astype(np.int32)
    padded_ids = ids.reshape(l, cap)
    probe_ids = np.sort(np.argsort(rng.random((b, l)), axis=1)[:, :p],
                        axis=1).astype(np.int64)
    levels = opts.get("levels")
    if levels:
        per_id = (0.3 + rng.integers(0, levels, (b, n_ids)) / 512.0)
    else:
        per_id = rng.normal(0.5, 0.2, (b, n_ids))
    per_id = per_id.astype(F32)
    keep = rng.random((b, n_ids)) < opts.get("finite", 0.7)
    per_id = np.where(keep, per_id, F32(-np.inf))
    lane_ids = padded_ids[probe_ids].reshape(b, p * cap)
    flat = np.where(lane_ids >= 0, np.take_along_axis(
        per_id, np.maximum(lane_ids, 0), axis=1), F32(-np.inf))
    for row in opts.get("masked_rows", ()):
        flat[row] = -np.inf
    return flat.astype(F32), probe_ids, padded_ids, k_sel, k, redundant


def _jax_tail(flat, probe_ids, padded_ids, k_sel, k, redundant):
    """The JAX package's selection after its probe scan
    (`ann_solo_tpu/index/ivf.py:1282-1291`)."""
    cap = padded_ids.shape[1]
    k_eff = min(k_sel, flat.shape[1])
    top_scores, pos = jivf._canonical_topk(jnp.asarray(flat), k_eff,
                                           cast=True)
    lp = pos // cap
    slot = pos - lp * cap
    lists = jnp.take_along_axis(jnp.asarray(probe_ids), lp, axis=1)
    top_ids = jnp.where(top_scores > -jnp.inf,
                        jnp.asarray(padded_ids)[lists, slot], -1)
    if redundant or k_eff > k:
        top_scores, top_ids = jivf._dedup_topk(top_scores, top_ids, k)
    s, i = jivf._pad_topk(top_scores, top_ids, k)
    return np.asarray(s), np.asarray(i)


def _plain(flat, probe_ids, padded_ids, k_sel, k, redundant):
    s, i = psel.canonical_select_plain(
        torch.from_numpy(flat), torch.from_numpy(probe_ids),
        torch.from_numpy(padded_ids), k_sel, k, redundant)
    return s.numpy(), i.numpy()


def _assert_same(got, want):
    (gs, gi), (ws, wi) = got, want
    assert gs.shape == ws.shape and gi.shape == wi.shape
    np.testing.assert_array_equal(gs.view(np.uint32), ws.view(np.uint32))
    np.testing.assert_array_equal(gi, wi)


# --------------------------------------------------------------------- #
# (a) the plain chain against the JAX tail


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_tail(name):
    args = _case(name)
    got = _plain(*args)
    _assert_same(got, _jax_tail(*args))
    s, i = got
    assert s.dtype == np.float32 and i.dtype == np.int32
    assert s.shape == (args[0].shape[0], args[4])


def test_cases_have_what_they_are_named_for():
    """The cases exercise what their names say: ties cut by the selection,
    all-masked rows, fewer finite lanes than k_sel, an id with one copy
    inside the selection and one outside it, more than 65,536 lanes."""
    flat, probe, ids, k_sel, k, red = _case("ties_x1")
    keys = -np.sort(-pivf._key16(torch.from_numpy(flat)).numpy(), axis=1)
    kth = keys[:, k_sel - 1:k_sel]
    cut = (keys == kth).sum(1) > (keys[:, :k_sel] == kth).sum(1)
    assert cut.mean() >= 0.5
    flat, *_ = _case("all_masked")
    assert np.isneginf(flat[0]).all() and np.isneginf(flat[3]).all()
    flat, _, _, k_sel, _, _ = _case("few_finite")
    assert (np.isfinite(flat).sum(1) < k_sel).any()
    flat, probe, ids, k_sel, k, red = _case("copies")
    lane_ids = ids[probe].reshape(flat.shape)
    _, pos = pivf.canonical_topk(pivf._key16(torch.from_numpy(flat)), k_sel)
    sel = np.take_along_axis(lane_ids, pos.numpy(), axis=1)
    split = False
    for r in range(len(flat)):
        inside = set(sel[r][sel[r] >= 0])
        twice = {i for i in inside if (sel[r] == i).sum() == 2}
        once = {i for i in inside if (lane_ids[r] == i).sum() == 2} - twice
        split |= bool(twice) and bool(once)
    assert split
    assert _case("k_sel_above_n")[0].shape[1] < CASES["k_sel_above_n"][4]
    assert _case("wide")[0].shape[1] > 65536
    assert _case("odd")[0].shape[1] % 4 != 0  # rows start unaligned
    for name in WIDE_CASES:
        flat, _, _, k_sel, _, _ = _case(name)
        assert min(k_sel, flat.shape[1]) > select_cuda.MAX_SEL
    assert CASES["k_all_16384"][4] == _case("k_all_16384")[0].shape[1]


# --------------------------------------------------------------------- #
# (b) the kernel's algorithm, emulated in NumPy

STEPS = 2  # the kernel's kSteps: steps of eight positions a thread a chunk
EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)


def _key16_np(x):
    u = x.view(np.uint32).astype(np.int64)
    b16 = ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFFFFFF) >> 16
    return np.where(u >= 0x80000000, 0xFFFF - b16, b16 | 0x8000)


def _key16_to_f32_np(key):
    b16 = np.where(key < 0x8000, 0xFFFF - key, key - 0x8000)
    return (b16.astype(np.uint32) << 16).view(F32)


def _find_bin(hist, need):
    """The kernel's warp search: lane j holds bins 255 - 8j .. 248 - 8j,
    an inclusive scan of the lane sums from the top, the first lane whose
    scan reaches `need`, then its walk down its eight bins."""
    desc = hist[::-1].reshape(32, 8)
    incl = np.cumsum(desc.sum(1))
    lane = int(np.argmax(incl >= need))
    cum = incl[lane] - desc[lane].sum()
    for j in range(8):
        if cum + desc[lane, j] >= need:
            return 255 - 8 * lane - j, int(cum)
        cum += desc[lane, j]
    raise AssertionError("need above the histogram's total")


def _sort_desc(words):
    """The kernel's `sort_desc<E>`: a descending bitonic network on 32-bit
    words, E = 2, 4 or 8 words a thread and 32 * E a warp's tile.  Strides
    below E are a thread's pairs and strides of a tile's span and above
    pairs in shared memory (compare-exchange); the strides between are
    shuffles, where each word keeps the max or the min of itself and its
    partner lane's word."""
    w = words.copy()
    ms = len(w)
    per = 2 if ms <= 1024 else ms // 512
    span = 32 * per
    assert ms >= span and ms & (ms - 1) == 0
    pos = np.arange(ms)
    size = 2
    while size <= ms:
        stride = size >> 1
        while stride:
            if per <= stride < span:
                other = w[pos ^ stride]
                keep_max = ((pos & stride) == 0) == ((pos & size) == 0)
                w = np.where(keep_max, np.maximum(w, other),
                             np.minimum(w, other))
            else:
                q = np.arange(ms // 2)
                lo = 2 * q - (q & (stride - 1))
                hi = lo + stride
                a, b = w[lo], w[hi]
                swap = np.where((lo & size) == 0, a < b, a > b)
                w[lo], w[hi] = np.where(swap, b, a), np.where(swap, a, b)
            stride >>= 1
        size <<= 1
    return w


def _sort_desc_wide(words):
    """The wide branch's `sort_desc_wide`: the descending bitonic network
    on 64-bit words in the kernel's order of stages: every size up to the
    tile S = min(m, TILE_WORDS) on each tile, then for each larger size
    its strides of S and above over the whole workspace and its smaller
    strides on each tile (whose pairs never leave a tile); each pair's
    direction set by its position in the workspace."""
    w = words.copy()
    m = len(w)
    tile = min(m, select_cuda.TILE_WORDS)
    q = np.arange(m // 2)

    def stage(size, stride, on_tiles):
        lo = 2 * q - (q & (stride - 1))
        hi = lo + stride
        if on_tiles:
            assert (lo // tile == hi // tile).all()
        a, b = w[lo], w[hi]
        swap = np.where((lo & size) == 0, a < b, a > b)
        w[lo], w[hi] = np.where(swap, b, a), np.where(swap, a, b)

    size = 2
    while size <= m:
        stride = size >> 1
        while stride:
            stage(size, stride, stride < tile)
            stride >>= 1
        size <<= 1
    return w


def _dedup_keep(ident, words, rng, rule="least"):
    """The kernel's dedup table: 2 * words slots of an id and a rank, a
    multiplicative hash and linear probing; the inserts in an order drawn
    from `rng` (the threads' order is free), CAS claiming a slot for an
    id and min keeping its least rank (the mutation "most": max).  A rank
    is kept where its id's slot holds it."""
    slots = 2 * words
    shift = 32 - (slots.bit_length() - 1)
    table = np.full(slots, EMPTY, np.uint64)
    pick = np.minimum if rule == "least" else np.maximum

    def home(i):
        return ((int(i) * 0x9E3779B1) & 0xFFFFFFFF) >> shift

    for r in rng.permutation(len(ident)):
        i = int(ident[r])
        if i < 0:
            continue
        word = np.uint64((i << 32) | int(r))
        h = home(i)
        while table[h] != EMPTY and int(table[h]) >> 32 != i:
            h = (h + 1) & (slots - 1)
        table[h] = word if table[h] == EMPTY else pick(table[h], word)
    keep = np.zeros(len(ident), bool)
    for r, i in enumerate(ident):
        if i >= 0:
            h = home(i)
            while int(table[h]) >> 32 != int(i):
                h = (h + 1) & (slots - 1)
            keep[r] = int(table[h]) & 0xFFFFFFFF == r
    return keep


def _emulate_row(x, probe, padded_ids, k_sel, k, redundant, rng, off=0,
                 branch="on_chip", tie_rule="first", dedup_rule="least",
                 lane_rule="asc"):
    """One row through the kernel's steps: pass 1 keys each lane once
    (into the on-chip key array at position lane + off, whose other
    positions hold whatever shared memory held) and counts the high
    bytes; passes 2 and 3 read the key array ("on_chip", "wide") or key
    the row again ("long_row", "wide_long_row") in steps of eight
    positions.  The wide branches then sort 64-bit words in the
    workspace (`_sort_desc_wide`; `lane_rule` "desc" is the mutation
    that orders a key's lanes descending) and dedup through a table of 2
    * m slots."""
    n = len(x)
    l, cap = padded_ids.shape
    k_eff = min(k_sel, n)
    out_s = np.full(k, -np.inf, F32)
    out_i = np.full(k, -1, np.int32)
    if k_eff == 0:
        return out_s, out_i
    lane_keys = _key16_np(x)
    steps8 = (off + n + 7) // 8
    width = 8 * steps8
    valid = np.zeros(width, bool)
    valid[off:off + n] = True
    wide = branch.startswith("wide")
    keys_on_chip = branch in ("on_chip", "wide")
    if keys_on_chip:
        on_chip = rng.integers(0, 1 << 16, (n + 3 + 7) // 8 * 8)
        on_chip[off:off + n] = lane_keys
        assert len(on_chip) >= width

    def read():
        if keys_on_chip:
            return on_chip[:width]
        keys = np.zeros(width, np.int64)
        keys[off:off + n] = _key16_np(x)
        return keys

    high, above = _find_bin(np.bincount(lane_keys >> 8, minlength=256),
                            k_eff)
    need = k_eff - above
    keys = read()
    in_high = valid & ((keys >> 8) == high)
    low, above2 = _find_bin(np.bincount(keys[in_high] & 0xFF,
                                        minlength=256), need)
    thresh = (high << 8) | low
    ties = need - above2
    # Pass 3 in chunks of 512 threads, thread t the chunk's STEPS steps
    # from t * STEPS: the ties taken by rank, each taken lane to its rank
    # in lane order; each thread's tie count and first slot equal the
    # kernel's, which come from the sums of the counts at and above the
    # threshold over the threads before it (its packed scan).
    keys = read()
    threads = select_cuda.THREADS
    per = 8 * STEPS
    chunks = -(-steps8 // (threads * STEPS))
    pad = per * chunks * threads - width
    keys8 = np.pad(keys, (0, pad)).reshape(chunks, threads, per)
    valid8 = np.pad(valid, (0, pad)).reshape(chunks, threads, per)
    at_t = valid8 & (keys8 == thresh)
    above_t = valid8 & (keys8 > thresh)
    if wide:
        words_n = select_cuda.sort_width(k_eff)
        words = np.zeros(words_n, np.uint64)  # the pad words are 0
    else:
        words_n = max(select_cuda.sort_width(k_eff), select_cuda.MIN_WORDS)
        words = np.zeros(words_n, np.uint32)
    lanes = rng.integers(0, n, words_n)
    n_ties = int(at_t.sum())
    tie_base = slot_base = 0
    for ch in range(chunks):
        eq, gt = at_t[ch].sum(1), above_t[ch].sum(1)
        eq_before = np.cumsum(eq) - eq
        rank = tie_base + np.cumsum(at_t[ch]).reshape(-1, per) - at_t[ch]
        if tie_rule == "first":
            take_tie = at_t[ch] & (rank < ties)
        else:  # the mutation: the last lanes at the threshold
            take_tie = at_t[ch] & (rank >= n_ties - ties)
        take = above_t[ch] | take_tie
        flat_take = take.reshape(-1)
        slot = (slot_base + np.cumsum(flat_take) - flat_take).reshape(-1, per)
        if tie_rule == "first":
            # The kernel's first tie rank and first slot of each thread.
            can = np.clip(ties - (tie_base + eq_before), 0, eq)
            np.testing.assert_array_equal(take_tie.sum(1), can)
            first = slot_base + (np.cumsum(gt) - gt) + np.clip(
                ties - tie_base, 0, eq_before)
            np.testing.assert_array_equal(
                np.cumsum(take.sum(1)) - take.sum(1) + slot_base, first)
        at = slot[take]
        taken = (per * (ch * threads + np.nonzero(take)[0])
                 + np.nonzero(take)[1] - off)
        if wide:
            low = 0xFFFFFFFF - taken if lane_rule == "asc" else taken
            words[at] = ((keys8[ch][take].astype(np.uint64) << np.uint64(32))
                         | low.astype(np.uint64))
        else:
            words[at] = (keys8[ch][take] << 16) | (0xFFFF - at)
            lanes[at] = taken
        slot_base += int(take.sum())
        tie_base += int(eq.sum())
    assert slot_base == k_eff
    if wide:
        words = _sort_desc_wide(words)[:k_eff]
        low = (words & np.uint64(0xFFFFFFFF)).astype(np.int64)
        lane = 0xFFFFFFFF - low if lane_rule == "asc" else low
        score = _key16_to_f32_np((words >> np.uint64(32)).astype(np.int64))
    else:
        words = _sort_desc(words)[:k_eff]
        lane = lanes[0xFFFF - (words & 0xFFFF)].astype(np.int64)
        score = _key16_to_f32_np((words >> 16).astype(np.int64))
    rank = lane // cap
    lists = probe[rank]
    ok = (score > -np.inf) & (lists >= 0) & (lists < l)
    ident = np.where(ok, padded_ids[np.clip(lists, 0, l - 1),
                                    lane - rank * cap], -1).astype(np.int32)
    if not (redundant or k_eff > k):
        out_s[:k_eff], out_i[:k_eff] = score, ident
        return out_s, out_i
    kept = np.nonzero(_dedup_keep(ident, words_n, rng, dedup_rule))[0][:k]
    out_s[:len(kept)], out_i[:len(kept)] = score[kept], ident[kept]
    return out_s, out_i


def _emulate(flat, probe_ids, padded_ids, k_sel, k, redundant, seed=5,
             **rules):
    """Every row; row r starts at lane r * n of a 16-byte aligned block,
    so its misalignment is r * n mod 4 lanes."""
    rng = np.random.default_rng(seed)
    n = flat.shape[1]
    rows = [_emulate_row(flat[r], probe_ids[r], padded_ids, k_sel, k,
                         redundant, rng, off=r * n % 4, **rules)
            for r in range(len(flat))]
    return (np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows]))


# Every case on the branches the kernel gives its width, and on the wide
# branch (which takes any width) too.
EMULATED = [(name, branch) for name in sorted(CASES)
            for branch in (("wide", "wide_long_row") if name in WIDE_CASES
                           else ("on_chip", "long_row", "wide"))]


@pytest.mark.parametrize("name,branch", EMULATED)
def test_kernel_emulation_equals_plain(name, branch):
    args = _case(name)
    _assert_same(_emulate(*args, branch=branch), _plain(*args))


@pytest.mark.parametrize("seed", range(8))
def test_kernel_emulation_equals_plain_random(seed):
    """Random shapes (rows starting at every misalignment), tie
    densities, masks and dedup settings, on both branches."""
    rng = np.random.default_rng(seed)
    b, l = int(rng.integers(1, 4)), int(rng.integers(4, 40))
    p, cap = int(rng.integers(1, l + 1)), int(rng.integers(1, 40))
    n = p * cap
    k = int(rng.integers(1, 80))
    k_sel = int(rng.integers(1, 2 * k + 2))
    redundant = bool(rng.integers(0, 2)) or k_sel > min(k, n)
    ids = rng.integers(-1, l * cap // 2 + 1, (l, cap)).astype(np.int32)
    probe = np.sort(np.argsort(rng.random((b, l)), axis=1)[:, :p],
                    axis=1).astype(np.int64)
    levels = int(rng.choice([2, 16, 1000]))
    flat = (rng.integers(0, levels, (b, n)) / levels - 0.5).astype(F32)
    flat = np.where(rng.random((b, n)) < rng.random(), F32(-np.inf), flat)
    args = (flat, probe, ids, k_sel, k, redundant)
    want = _plain(*args)
    for branch in ("on_chip", "long_row", "wide", "wide_long_row"):
        _assert_same(_emulate(*args, seed=seed, branch=branch), want)


@pytest.mark.parametrize("seed", range(4))
def test_dedup_table_order_free(seed):
    """The dedup table's result does not depend on the order the inserts
    run in: several orders, one answer, the plain version's; in shared
    memory and, on the wide branch, in device memory (8,192 lanes
    selected, a table of 16,384 slots)."""
    args = _case("copies", seed=seed)
    want = _plain(*args)
    for order in range(3):
        _assert_same(_emulate(*args, seed=100 * seed + order), want)
    args = _case("k_8192", seed=seed)
    want = _plain(*args)
    for order in range(2):
        _assert_same(_emulate(*args, seed=100 * seed + order,
                              branch="wide"), want)


def test_tie_rule_mutation_fails():
    """Taking the last lanes at the threshold key instead of the first
    changes the result: the emulation's tie rule is load-bearing (the
    lanes at the threshold key reach the output without dedup)."""
    args = _case("ties_x1")
    with pytest.raises(AssertionError):
        _assert_same(_emulate(*args, tie_rule="last"), _plain(*args))


def test_dedup_rule_mutation_fails():
    """Keeping each id's last rank (atomicMax) instead of its first
    changes the result: the table's min is load-bearing."""
    args = _case("copies")
    with pytest.raises(AssertionError):
        _assert_same(_emulate(*args, dedup_rule="most"), _plain(*args))


@pytest.mark.parametrize("name", ["ties_x1", "k_all_16384"])
def test_wide_lane_order_mutation_fails(name):
    """The wide words order a key's lanes ascending through 2^32 - 1 -
    lane; the lane itself (descending) changes the result where ties are
    selected: that half of the word is load-bearing."""
    args = _case(name)
    want = _plain(*args)
    _assert_same(_emulate(*args, branch="wide"), want)
    with pytest.raises(AssertionError):
        _assert_same(_emulate(*args, branch="wide", lane_rule="desc"), want)


def _select_cases():
    """chip_smoke.py's SELECT_CASES (phase 3e's shapes) by name."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return {case[0]: case for case in module.SELECT_CASES}


@pytest.mark.parametrize("k_eff,width", [(1, 1), (2, 2), (3, 4),
                                         (1024, 1024), (1025, 2048),
                                         (4096, 4096)])
def test_sort_width_and_plan(k_eff, width):
    """The sort's width, and the shared memory of a bench row (49,152
    lanes) with k_eff selected: 98,320 bytes of keys beside 8 bytes a
    word of at least 128 words, the dedup table inside the key area."""
    assert select_cuda.sort_width(k_eff) == width
    branch, smem = select_cuda.plan(49152, k_eff)
    assert branch == "on_chip"
    assert smem == 98_320 + 8 * max(width, select_cuda.MIN_WORDS)
    assert smem + select_cuda.STATIC_RESERVE <= 232_448


# The plan of each phase 3e case, as the kernel's header states it.
PLANS = {
    "bench_k512": ("on_chip", 106_512), "bench_k1024": ("on_chip", 114_704),
    "tile_2m": ("on_chip", 114_704), "tile_2m_x1": ("on_chip", 106_512),
    "stream_8m": ("on_chip", 204_816), "engine": ("on_chip", 57_360),
    "ties": ("on_chip", 106_512), "masked": ("on_chip", 106_512),
    "long_row": ("long_row", 49_152), "k_max": ("on_chip", 131_088),
    "odd": ("on_chip", 86_896),
    "k_4097": ("wide", 99_344), "k_wide": ("wide", 99_344),
    "k_all": ("wide", 132_112), "long_k16384": ("wide_long_row", 66_560),
    "k_lanes_max": ("wide_long_row", 66_560),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_of_each_select_case(name):
    """Every phase 3e shape but long_row keeps its keys on chip within
    the 232,448 bytes a block may use; long_row (196,608 lanes at m
    2,048) takes the long-row branch; the bench's rows leave room for two
    blocks an SM (233,472 bytes, 1 KB reserved a block), on the wide
    branch too; more than MAX_SEL lanes selected take the wide branch,
    keys on chip beside nothing but the histogram (the sort's tile takes
    their area after pass 3), long_k16384's 196,608 lanes and
    k_lanes_max's 2^22 without them."""
    _, _, _, p, cap, k_sel, _, _, _ = _select_cases()[name]
    n = p * cap
    plan = select_cuda.plan(n, min(k_sel, n))
    assert plan == PLANS[name]
    assert plan[1] + select_cuda.STATIC_RESERVE <= 232_448
    if name in ("bench_k512", "bench_k1024", "odd", "k_wide"):
        assert 2 * (plan[1] + select_cuda.STATIC_RESERVE + 1024) <= 233_472


def test_plan_long_rows():
    """Rows too long for shared memory take the long-row branch: 2^22
    lanes, 196,608 at m 2,048; the last on-chip length at m 1,024."""
    assert select_cuda.plan(select_cuda.MAX_LANES, 4096) == (
        "long_row", 16 * 4096 + 8 * 4096)
    assert select_cuda.plan(196_608, 2048)[0] == "long_row"
    # 2 * round_up(n + 3, 8) + 8,192 + 256 <= 232,448 up to n = 111,997.
    assert select_cuda.plan(111_997, 1024) == ("on_chip", 232_192)
    assert select_cuda.plan(111_998, 1024)[0] == "long_row"
    # The wide branch: 2 * round_up(n + 3, 8) + 1,024 + 256 <= 232,448 up
    # to n = 115,581; every row of up to 2^22 lanes in 66,560 bytes.
    assert select_cuda.plan(115_581, 8192) == ("wide", 232_192)
    assert select_cuda.plan(115_582, 8192) == ("wide_long_row", 66_560)
    assert select_cuda.plan(select_cuda.MAX_LANES, select_cuda.MAX_LANES) \
        == ("wide_long_row", 66_560)
    assert select_cuda.plan(5000, 4097) == ("wide", 66_560)


@pytest.mark.parametrize("b,k_eff,sms,grid", [
    (4096, 8192, 132, 264), (256, 65536, 132, 256), (3, 4097, 132, 3),
    (64, 1 << 22, 132, 10), (1, 1 << 22, 132, 1), (4096, 1 << 20, 132, 42),
])
def test_wide_grid(b, k_eff, sms, grid):
    """The wide branch's blocks: two an SM, no more than the rows, and a
    workspace of 24 bytes a sort word a block within WORK_BUDGET (1 GiB:
    ten blocks at 2^22 lanes selected)."""
    assert select_cuda.wide_grid(b, k_eff, sms) == grid
    words = select_cuda.sort_width(k_eff)
    assert grid == 1 or grid * 24 * words <= select_cuda.WORK_BUDGET


# --------------------------------------------------------------------- #
# (c) the full scan's card route, run on CPU tensors


def _small_jax_index(storage, seed=43):
    """L 64, cap 16, D 64, num_probe 8, x2 SOAR: the fullscan regime."""
    rng = np.random.default_rng(seed)
    n = 340
    vectors = _clustered_vectors(rng, n=n, d=64, n_clusters=16)
    prec = rng.uniform(400, 1200, n).astype(F32)
    index = jivf.IvfIndex.build(
        vectors, IvfConfig(num_list=64, num_probe=8), precursor_mz=prec,
        storage_dtype=storage, redundancy=2,
    )
    rows = rng.choice(n, 256)
    queries = vectors[rows] + 0.1 * rng.normal(size=(256, 64)).astype(F32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    q_prec = prec[rows] + rng.normal(0, 20, 256).astype(F32)
    return index, queries.astype(F32), q_prec.astype(F32)


def _lanes_equal(a, b):
    (ai, as_), (bi, bs) = a, b
    return float(((ai == bi) & (as_.view(np.uint32) == bs.view(np.uint32)))
                 .mean())


def _route_on_cpu(monkeypatch):
    """Make CPU tensors take the card route; count the selections."""
    calls = {"select": 0, "k_sel": []}
    real = pivf.canonical_select

    def counted(*args, **kwargs):
        calls["select"] += 1
        calls["k_sel"].append(args[3])
        return real(*args, **kwargs)

    def refuse(*args, **kwargs):
        raise AssertionError("the card route ran the plain full scan")

    monkeypatch.setattr(pivf, "canonical_select", counted)
    monkeypatch.setattr(pivf, "_fullscan_scans_probed_lists",
                        lambda device, dtype: dtype != torch.float32)
    monkeypatch.setattr(pivf, "_ivf_search_fullscan", refuse)
    return calls


@pytest.mark.parametrize("storage", ["int8", "bf16"])
@pytest.mark.parametrize("tol_val,tol_mode", [(0.0, "Da"), (150.0, "Da")])
def test_card_route_on_cpu_matches_fullscan(monkeypatch, storage, tol_val,
                                            tol_mode):
    import ml_dtypes

    jstorage = {"int8": np.int8, "bf16": ml_dtypes.bfloat16}[storage]
    index, queries, q_prec = _small_jax_index(jstorage)
    k = 24
    port = _port(index)
    assert port.padded_vectors.shape == (64, 16, 64)
    assert port.regime(k) == "fullscan" and port.num_probe == 8
    q_t, qp_t = torch.from_numpy(queries), torch.from_numpy(q_prec)
    kwargs = dict(q_prec=qp_t, charge=2.0, tol_val=tol_val,
                  tol_mode=tol_mode)
    plain = [a.numpy() for a in port.search_device(q_t, k, **kwargs)]
    e_ids, e_s = index.search_device(queries, k, q_prec=q_prec, charge=2.0,
                                     tol_val=tol_val, tol_mode=tol_mode)
    jax_out = [np.asarray(e_ids), np.asarray(e_s)]
    calls = _route_on_cpu(monkeypatch)
    route = [a.numpy() for a in port.search_device(q_t, k, **kwargs)]
    assert calls["select"] == 1  # one super-tile of 256 queries
    for ids in route[0]:
        row = ids[ids >= 0]
        assert len(np.unique(row)) == len(row)
    for other in (plain, jax_out):
        assert _lanes_equal(route, other) >= 0.999
        keys = [pivf._key16(torch.tensor(s)).numpy()
                for s in (route[1], other[1])]
        assert np.abs(keys[0] - keys[1]).max() <= 1
    # Rows whose lane scores give the same keys in both sums are
    # identical.
    blocks = port._blocks()
    probe = pivf._probe_lists(q_t, port.centroids, 8)
    flat_b2 = ivf_probe_scan_plain(*blocks[:4], q_t, qp_t, 2.0, probe,
                                   tol_val, tol_mode)
    q_bf16 = q_t.to(torch.bfloat16).to(torch.float32)
    full = (q_bf16 @ port.scan_block().T) * port.padded_scales.reshape(1, -1)
    lanes = (probe[:, :, None] * 16 + torch.arange(16)).reshape(256, -1)
    flat_fs = torch.where(torch.isneginf(flat_b2), float("-inf"),
                          full.gather(1, lanes))
    agree = (pivf._key16(flat_b2) == pivf._key16(flat_fs)).all(1).numpy()
    assert agree.mean() >= 0.5
    for a, b in zip(route, plain):
        np.testing.assert_array_equal(a[agree], b[agree])


def test_card_route_on_cpu_at_4096_candidates(monkeypatch):
    """The card route at 4,096 candidates of x2 storage: k_sel 8,192 of a
    query's 48 probed lists (the wide branch on the card), on CPU tensors
    through the plain versions, against the port's plain full scan and
    the JAX package's search: >= 99.9% of (id, score) lanes equal, every
    16-bit key within one step, no duplicate ids."""
    rng = np.random.default_rng(47)
    n, d, k = 6000, 32, 4096
    vectors = _clustered_vectors(rng, n=n, d=d, n_clusters=32)
    prec = rng.uniform(400, 1200, n).astype(F32)
    index = jivf.IvfIndex.build(
        vectors, IvfConfig(num_list=64, num_probe=48), precursor_mz=prec,
        storage_dtype=np.int8, redundancy=2,
    )
    rows = rng.choice(n, 32)
    queries = vectors[rows] + 0.1 * rng.normal(size=(32, d)).astype(F32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    q_prec = (prec[rows] + rng.normal(0, 20, 32)).astype(F32)
    port = _port(index)
    l, cap, _ = port.padded_vectors.shape
    assert port.regime(k) == "fullscan" and port.num_probe == 48
    assert min(48, l) * cap > 2 * k > select_cuda.MAX_SEL
    q_t, qp_t = torch.from_numpy(queries.astype(F32)), torch.from_numpy(q_prec)
    kwargs = dict(q_prec=qp_t, charge=2.0, tol_val=600.0, tol_mode="Da")
    plain = [a.numpy() for a in port.search_device(q_t, k, **kwargs)]
    e_ids, e_s = index.search_device(queries.astype(F32), k, q_prec=q_prec,
                                     charge=2.0, tol_val=600.0,
                                     tol_mode="Da")
    jax_out = [np.asarray(e_ids), np.asarray(e_s)]
    calls = _route_on_cpu(monkeypatch)
    route = [a.numpy() for a in port.search_device(q_t, k, **kwargs)]
    assert calls["select"] == 1 and calls["k_sel"] == [2 * k]
    assert route[0].shape == (32, k)
    assert (route[0] >= 0).sum(1).min() > select_cuda.MAX_SEL // 4
    for ids in route[0]:
        row = ids[ids >= 0]
        assert len(np.unique(row)) == len(row)
    for other in (plain, jax_out):
        assert _lanes_equal(route, other) >= 0.999
        keys = [pivf._key16(torch.tensor(s)).numpy()
                for s in (route[1], other[1])]
        assert np.abs(keys[0] - keys[1]).max() <= 1


# --------------------------------------------------------------------- #
# (d) routing


def _refuse_the_wrapper(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the kernel's wrapper")

    monkeypatch.setattr(select_cuda, "canonical_select", refuse)
    monkeypatch.setattr(select_cuda, "_library", refuse)


def test_cpu_tensors_never_reach_the_wrapper(monkeypatch):
    """The plain full scan, the probe path (`_FULLSCAN_TRANSIENT = 0`) and
    the routing function all stay off the wrapper and its library on the
    CPU, and the launch count does not move."""
    _refuse_the_wrapper(monkeypatch)
    before = select_cuda.LAUNCHES
    rng = np.random.default_rng(2)
    vectors = torch.from_numpy(_clustered_vectors(rng, n=600, d=32,
                                                  n_clusters=8))
    index = pivf.IvfIndex.build(
        vectors, IvfConfig(num_list=32, num_probe=8), device="cpu",
        storage_dtype=torch.int8, redundancy=2)
    assert index.regime(16) == "fullscan"
    full = index.search_device(vectors[:40], 16)
    monkeypatch.setattr(pivf, "_FULLSCAN_TRANSIENT", 0)
    assert index.regime(16) == "probe"
    probe = index.search_device(vectors[:40], 16)
    assert _lanes_equal([a.numpy() for a in full],
                        [a.numpy() for a in probe]) >= 0.999
    args = _case("copies")
    psel.canonical_select(*(torch.from_numpy(a) for a in args[:3]),
                          *args[3:])
    assert select_cuda.LAUNCHES == before


def test_wrapper_takes_cuda_tensors_only():
    """The wrapper imports without CUDA and raises on CPU tensors before
    building or loading anything; the routing refuses other devices."""
    flat, probe, ids, k_sel, k, red = (
        torch.from_numpy(a) if isinstance(a, np.ndarray) else a
        for a in _case("ties"))
    before = select_cuda.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        select_cuda.canonical_select(flat, probe, ids, k_sel, k, red)
    assert select_cuda.LAUNCHES == before
    with pytest.raises(ValueError, match="unsupported device"):
        psel.canonical_select(flat.to("meta"), probe.to("meta"),
                              ids.to("meta"), k_sel, k, red)


@pytest.mark.parametrize("n,k_sel,k,outcome", [
    (select_cuda.MAX_LANES + 1, 16, 16, "MAX_LANES"),
    (0, 16, 16, "MAX_LANES"),
    (49152, select_cuda.MAX_SEL + 1, 2048, "wide"),
    (49152, 0, 16, "k_sel = 0"),
    (49152, 16, -1, "k = -1"),
])
def test_limits_raise(n, k_sel, k, outcome):
    """Outside the kernel's limits (lanes a row, k_sel < 1, k < 0) the
    wrapper raises ValueError naming the limit; a selection of more than
    MAX_SEL lanes is no limit: its plan is the wide branch."""
    if outcome == "wide":
        k_eff = select_cuda.check_limits(n, k_sel, k)
        assert k_eff == k_sel
        assert select_cuda.plan(n, k_eff)[0] == "wide"
        return
    with pytest.raises(ValueError, match=outcome):
        select_cuda.check_limits(n, k_sel, k)


def test_limits_raise_before_the_library_loads(monkeypatch):
    """Beyond a limit the wrapper raises ValueError naming it before the
    library is built or loaded; at every selection width it passes k_eff
    on and its plan picks the branch without the library (the wide one
    above MAX_SEL, up to k_sel = n = MAX_LANES)."""
    monkeypatch.setattr(select_cuda, "_check", lambda *a: None)
    monkeypatch.setattr(select_cuda, "_library", lambda: pytest.fail(
        "the library was loaded"))
    flat = torch.empty((0, 512 * 96))
    probe = torch.empty((0, 512), dtype=torch.int64)
    ids = torch.empty((4096, 96), dtype=torch.int32)
    with pytest.raises(ValueError, match="k_sel = 0"):
        select_cuda.canonical_select(flat, probe, ids, 0, 2048, True)
    s, i = select_cuda.canonical_select(flat, probe, ids,
                                        select_cuda.MAX_SEL + 1, 2048, True)
    assert s.shape == i.shape == (0, 2048)
    s, i = select_cuda.canonical_select(flat, probe, ids, 1024, 512, True)
    assert s.shape == i.shape == (0, 512)
    assert select_cuda.check_limits(49152, select_cuda.MAX_SEL, 2048) == \
        select_cuda.MAX_SEL
    assert select_cuda.check_limits(100, 4096, 50) == 100
    for n, k_sel, branch in ((49152, 8192, "wide"),
                             (196_608, 16_384, "wide_long_row"),
                             (select_cuda.MAX_LANES, select_cuda.MAX_LANES,
                              "wide_long_row")):
        k_eff = select_cuda.check_limits(n, k_sel, 4096)
        assert k_eff == k_sel
        assert select_cuda.plan(n, k_eff)[0] == branch


def test_search_device_keeps_the_plain_full_scan_on_cpu(monkeypatch):
    """On the CPU the fullscan regime runs `_ivf_search_fullscan`; the rule
    sends CUDA tensors with int8/bf16 storage to the probe path and f32
    storage never."""
    calls = {"full": 0}
    real = pivf._ivf_search_fullscan

    def counted(*args, **kwargs):
        calls["full"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(pivf, "_ivf_search_fullscan", counted)
    monkeypatch.setattr(pivf.IvfIndex, "_search_probe", lambda *a: (
        pytest.fail("the CPU took the probe path")))
    rng = np.random.default_rng(3)
    vectors = torch.from_numpy(_clustered_vectors(rng, n=400, d=16,
                                                  n_clusters=8))
    for dtype in (torch.int8, torch.bfloat16, torch.float32):
        index = pivf.IvfIndex.build(
            vectors, IvfConfig(num_list=16, num_probe=4), device="cpu",
            storage_dtype=dtype, redundancy=2)
        assert index.regime(8) == "fullscan"
        index.search_device(vectors[:10], 8)
    assert calls["full"] == 3
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert pivf._fullscan_scans_probed_lists(cuda, torch.int8)
    assert pivf._fullscan_scans_probed_lists(cuda, torch.bfloat16)
    assert not pivf._fullscan_scans_probed_lists(cuda, torch.float32)
    assert not pivf._fullscan_scans_probed_lists(cpu, torch.int8)


def test_breakdown_cuts_apply_to_the_source():
    """`tools/select_breakdown.py` finds each of its cut points once in the
    kernel's source, in stage order."""
    from ann_solo_tpu_torch.tools import select_breakdown as sb

    source = (sb._build.CSRC_DIR / "canonical_select.cu").read_text()
    at = []
    for name, _, code in sb.CUTS:
        cut = sb.cut_source(source, name)
        assert len(cut) == len(source) + len(code)
        at.append(cut.index(code))
    assert at == sorted(at)
    with pytest.raises(ValueError, match="marker"):
        sb.cut_source(source.replace("// Pass 3:", "// pass 3:"), "pass2")


def test_import_rules_cover_the_new_modules():
    import os

    import test_torch_imports

    for path in ("ann_solo_tpu_torch/ops/select_cuda.py",
                 "ann_solo_tpu_torch/ops/canonical_select.py",
                 "ann_solo_tpu_torch/tools/select_breakdown.py"):
        assert path in test_torch_imports._SOURCES
        assert not [m for m in test_torch_imports._imported_modules(path)
                    if m.split(".")[0] in
                    test_torch_imports._NOT_ON_THE_GPU_MACHINE]
    assert os.path.isfile(os.path.join(
        test_torch_imports.REPO, "ann_solo_tpu_torch", "csrc",
        "canonical_select.cu"))
