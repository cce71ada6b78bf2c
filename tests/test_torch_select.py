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
  orders.  The wide branch: passes 1-3 on one block or over random tile
  splits of the row (the tiles' histograms added in shuffled orders,
  each tile's first tie rank and slot from the scan), items key << 32 |
  lane in lane order, the stable counting sort on the key (two 8-bit
  digits; warps ranking their segments; blocks and stores in shuffled
  orders), and the dedup: up to ROW_TAIL items on one block (claims wave
  by wave in rank order), else a table of 2 * m slots in device memory,
  the kept ranks placed by tile scans.  The same emulation with the tie
  rule mutated (the last lanes at the threshold instead of the first),
  the dedup's (each id's last rank) or an unstable digit pass (a warp's
  lanes of one digit ranked from the last) does not.  The wrapper's
  `plan` and `wide_grid` give every phase 3e shape its branch, shared
  memory, rows a group and tiles a row as the kernel computes them.
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


def _sort_wide(items, rng, rule="stable", tile=None, threads=None):
    """The wide branch's canonical order of its items (key << 32 | lane,
    in lane order): two counting passes of an 8-bit digit of the key, the
    low byte first, each bucket order descending.  A pass counts each
    tile of `tile` items (ITEM_TILE; the whole row when one block of
    ROW_TAIL_THREADS sorts it), scans the counts over the tiles (each
    tile's start in each bucket), then scatters each tile, its blocks in a
    shuffled order: the block's warps each take a segment of whole rounds
    of 32 items, count
    its digits, start each digit at the tile's start plus the counts of
    the warps before, and place a round's items at the running start of
    their digit plus their rank among the round's lanes of that digit.
    `rule` "unstable" is the mutation that ranks a round's lanes of one
    digit from the last (lane descending)."""
    k_eff = len(items)
    tile = tile or select_cuda.ITEM_TILE
    warps = (threads or select_cuda.THREADS) // 32
    n_tiles = -(-k_eff // tile)
    for shift in (32, 40):
        digit = ((items >> np.uint64(shift)) & np.uint64(0xFF)).astype(
            np.int64)
        counts = np.stack([np.bincount(digit[t * tile:(t + 1) * tile],
                                       minlength=256)
                           for t in range(n_tiles)])
        total = counts.sum(0)
        start = np.cumsum(total[::-1])[::-1] - total  # digit 255 first
        tile_start = start + np.cumsum(counts, 0) - counts
        out = np.full(k_eff, EMPTY, np.uint64)
        for t in rng.permutation(n_tiles):
            lo, hi = t * tile, min(k_eff, (t + 1) * tile)
            seg = -(-(hi - lo) // (32 * warps)) * 32
            run = tile_start[t].copy()
            segs = [(min(hi, lo + w * seg), min(hi, lo + (w + 1) * seg))
                    for w in range(warps)]
            runs = []
            for s0, s1 in segs:  # each warp's start in each bucket
                runs.append(run.copy())
                run += np.bincount(digit[s0:s1], minlength=256)
            for w in rng.permutation(warps):
                s0, s1 = segs[w]
                for r0 in range(s0, s1, 32):
                    d = digit[r0:min(s1, r0 + 32)]
                    same = d[:, None] == d[None, :]
                    lower = np.tri(len(d), k=-1, dtype=bool)
                    rank = (same & (lower if rule == "stable"
                                    else lower.T)).sum(1)
                    at = runs[w][d] + rank
                    assert (out[at] == EMPTY).all()
                    out[at] = items[r0:r0 + len(d)]
                    runs[w] += np.bincount(d, minlength=256)
        assert (out != EMPTY).all()
        items = out
    return items


def _split_select(lane_keys, k_eff, n_tiles, rng):
    """Passes 1-3 of a row split over blocks: tiles of round_up(ceil(n /
    n_tiles), 8) lanes; the tiles' high-byte histograms added in a
    shuffled order; each tile's low-byte histogram within the high bin and
    its count above it; the scan's threshold, ties and each tile's first
    tie rank and first slot; each tile's compaction in rounds of THREADS
    threads of 8 consecutive lanes (a thread's first tie rank and slot
    from the packed scan of its round), its blocks in a shuffled order.
    Returns the items key << 32 | lane in lane order."""
    n = len(lane_keys)
    width = -(-(-(-n // n_tiles)) // 8) * 8
    spans = [(lo, min(n, lo + width)) for lo in range(0, n, width)]
    hist = np.zeros(256, np.int64)
    for t in rng.permutation(len(spans)):
        lo, hi = spans[t]
        hist += np.bincount(lane_keys[lo:hi] >> 8, minlength=256)
    high, above = _find_bin(hist, k_eff)
    need = k_eff - above
    lows, above_bin = [], []
    for lo, hi in spans:
        keys = lane_keys[lo:hi]
        lows.append(np.bincount(keys[keys >> 8 == high] & 0xFF,
                                minlength=256))
        above_bin.append(int((keys >> 8 > high).sum()))
    low, above2 = _find_bin(np.sum(lows, 0), need)
    thresh, ties = (high << 8) | low, need - above2
    eq = np.array([h[low] for h in lows])
    gt = np.array([a + h[low + 1:].sum() for a, h in zip(above_bin, lows)])
    tie_first = np.cumsum(eq) - eq
    slot_first = np.cumsum(gt) - gt + np.minimum(ties, tie_first)
    items = np.full(k_eff, EMPTY, np.uint64)
    per = 8 * select_cuda.THREADS
    for t in rng.permutation(len(spans)):
        lo, hi = spans[t]
        tie_base, slot_base = int(tie_first[t]), int(slot_first[t])
        for j0 in range(lo, hi, per):
            keys = lane_keys[j0:min(hi, j0 + per)]
            keys8 = np.pad(keys, (0, per - len(keys)),
                           constant_values=-1).reshape(-1, 8)
            at_t, above_t = keys8 == thresh, keys8 > thresh
            eq_c, gt_c = at_t.sum(1), above_t.sum(1)
            eq_before = np.cumsum(eq_c) - eq_c
            gt_before = np.cumsum(gt_c) - gt_c
            can = np.clip(ties - (tie_base + eq_before), 0, eq_c)
            take = above_t | (at_t & (np.cumsum(at_t, 1) <= can[:, None]))
            first = (slot_base + gt_before
                     + np.clip(ties - tie_base, 0, eq_before))
            slot = first[:, None] + np.cumsum(take, 1) - take
            lanes = (j0 + np.arange(per)).reshape(-1, 8)
            assert (items[slot[take]] == EMPTY).all()
            items[slot[take]] = ((keys8[take].astype(np.uint64)
                                  << np.uint64(32))
                                 | lanes[take].astype(np.uint64))
            slot_base += int(gt_c.sum()) + min(max(ties - tie_base, 0),
                                               int(eq_c.sum()))
            tie_base += int(eq_c.sum())
    assert (items != EMPTY).all()
    lane = (items & np.uint64(0xFFFFFFFF)).astype(np.int64)
    assert (np.diff(lane) > 0).all()  # lane order
    return items


def _wide_place(kept, rng, row_tail=False):
    """The wide branch's placing of the kept ranks.  Over tiles of
    ITEM_TILE ranks: each tile's kept count (its blocks in a shuffled
    order), the exclusive scan over the tiles, then a block scan of runs
    of ITEM_TILE / THREADS ranks a thread within a tile.  On one block a
    row (`row_tail`): waves of ROW_TAIL_THREADS consecutive ranks, one a
    thread, a block scan a wave after the kept ranks of the waves before.
    Returns
    the kept ranks in output order."""
    threads = select_cuda.THREADS
    out = np.full(int(kept.sum()), -1, np.int64)
    if row_tail:
        threads = select_cuda.ROW_TAIL_THREADS
        base = 0
        for r0 in range(0, len(kept), threads):
            wave = kept[r0:r0 + threads]
            pos = base + np.cumsum(wave) - wave
            out[pos[wave]] = r0 + np.nonzero(wave)[0]
            base += int(wave.sum())
        assert (out >= 0).all()
        return out
    tile = select_cuda.ITEM_TILE
    per = tile // threads
    n_tiles = -(-len(kept) // tile)
    counts = np.zeros(n_tiles, np.int64)
    for t in rng.permutation(n_tiles):
        counts[t] = kept[t * tile:(t + 1) * tile].sum()
    base = np.cumsum(counts) - counts
    for t in rng.permutation(n_tiles):
        runs = np.pad(kept[t * tile:(t + 1) * tile], (0, tile))[:tile]
        runs = runs.reshape(-1, per)
        run = runs.sum(1)
        pos = base[t] + (np.cumsum(run) - run)[:, None] + np.cumsum(
            runs, 1) - runs
        ranks = (t * tile + np.arange(tile)).reshape(-1, per)
        out[pos[runs]] = ranks[runs]
    assert (out >= 0).all()
    return out


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


def _wave_dedup_keep(ident, words, rng, rule="least"):
    """The row tail's dedup: 2 * words slots, the same hash and probing;
    the ranks in waves of ROW_TAIL_THREADS in rank order, each wave's
    claims in an order drawn from `rng`: a CAS claims a free slot and the
    claimer stores its rank; after the wave's barrier an id that found its
    slot taken in this wave lowers the slot's rank to its own where lower
    (the mutation "most": raises it).  A rank is kept where its slot holds
    it."""
    slots = 2 * words
    shift = 32 - (slots.bit_length() - 1)
    ids = np.full(slots, -1, np.int64)
    ranks = np.zeros(slots, np.int64)
    keep_slot = np.full(len(ident), -1, np.int64)
    threads = select_cuda.ROW_TAIL_THREADS
    for r0 in range(0, len(ident), threads):
        lost = []
        for r in r0 + rng.permutation(min(threads, len(ident) - r0)):
            i = int(ident[r])
            if i < 0:
                continue
            h = ((i * 0x9E3779B1) & 0xFFFFFFFF) >> shift
            while ids[h] not in (-1, i):
                h = (h + 1) & (slots - 1)
            if ids[h] == -1:
                ids[h], ranks[h] = i, r
            else:
                lost.append((r, h))
            keep_slot[r] = h
        for r, h in lost:
            if (r < ranks[h]) == (rule == "least") and ranks[h] >= r0:
                ranks[h] = r
    return (keep_slot >= 0) & (ranks[np.maximum(keep_slot, 0)]
                               == np.arange(len(ident)))


def _emulate_row(x, probe, padded_ids, k_sel, k, redundant, rng, off=0,
                 branch="on_chip", tie_rule="first", dedup_rule="least",
                 digit_rule="stable", tiles=2):
    """One row through the kernel's steps: pass 1 keys each lane once
    (into the on-chip key array at position lane + off, whose other
    positions hold whatever shared memory held) and counts the high
    bytes; passes 2 and 3 read the key array ("on_chip", "wide") or key
    the row again ("long_row", "wide_long_row") in steps of eight
    positions; "wide_split" runs passes 1-3 over `tiles` tiles of the row
    (`_split_select`).  The wide branches leave their items key << 32 |
    lane in lane order, sort them by the key (`_sort_wide`; `digit_rule`
    "unstable" is the mutation), decode each rank's id once and dedup
    through a table of the least power of two >= 2 * k_eff slots, then
    place the kept ranks (`_wide_place`): up to ROW_TAIL items on one
    block a row, else in tiles of ITEM_TILE."""
    n = len(x)
    l, cap = padded_ids.shape
    k_eff = min(k_sel, n)
    out_s = np.full(k, -np.inf, F32)
    out_i = np.full(k, -1, np.int32)
    if k_eff == 0:
        return out_s, out_i
    lane_keys = _key16_np(x)
    wide = branch.startswith("wide")
    if branch == "wide_split":
        words = _split_select(lane_keys, k_eff, tiles, rng)
    else:
        words, lanes = _fused_passes(x, lane_keys, k_eff, rng, off, branch,
                                     tie_rule)
    # Up to ROW_TAIL items one block sorts and places a row's.
    tile = k_eff if k_eff <= select_cuda.ROW_TAIL else None
    if wide:
        words = _sort_wide(words, rng, digit_rule, tile,
                           tile and select_cuda.ROW_TAIL_THREADS)
        lane = (words & np.uint64(0xFFFFFFFF)).astype(np.int64)
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
    if wide and tile is not None:
        keep = _wave_dedup_keep(ident, select_cuda.sort_width(k_eff), rng,
                                dedup_rule)
    else:
        keep = _dedup_keep(ident, select_cuda.sort_width(k_eff) if wide else
                           max(select_cuda.sort_width(k_eff),
                               select_cuda.MIN_WORDS), rng, dedup_rule)
    kept = (_wide_place(keep, rng, row_tail=tile is not None) if wide
            else np.nonzero(keep)[0])
    kept = kept[:k]
    out_s[:len(kept)], out_i[:len(kept)] = score[kept], ident[kept]
    return out_s, out_i


def _fused_passes(x, lane_keys, k_eff, rng, off, branch, tie_rule):
    """Passes 1-3 of a row on one block: the words of the taken lanes in
    lane order (key << 16 | (0xffff - slot) beside a slot -> lane array,
    at least MIN_WORDS of them, the pad words 0; the wide branches: k_eff
    items key << 32 | lane and no array)."""
    n = len(x)
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
        words = np.zeros(k_eff, np.uint64)
    else:
        words_n = max(select_cuda.sort_width(k_eff), select_cuda.MIN_WORDS)
        words = np.zeros(words_n, np.uint32)
    lanes = rng.integers(0, n, len(words))
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
            words[at] = ((keys8[ch][take].astype(np.uint64) << np.uint64(32))
                         | taken.astype(np.uint64))
        else:
            words[at] = (keys8[ch][take] << 16) | (0xFFFF - at)
            lanes[at] = taken
        slot_base += int(take.sum())
        tie_base += int(eq.sum())
    assert slot_base == k_eff
    return words, lanes


def _emulate(flat, probe_ids, padded_ids, k_sel, k, redundant, seed=5,
             **rules):
    """Every row; row r starts at lane r * n of a 16-byte aligned block,
    so its misalignment is r * n mod 4 lanes; "wide_split" splits each
    row into a random count of tiles (2 to 9, tiles of at least 8
    lanes)."""
    rng = np.random.default_rng(seed)
    n = flat.shape[1]
    rows = [_emulate_row(flat[r], probe_ids[r], padded_ids, k_sel, k,
                         redundant, rng, off=r * n % 4,
                         tiles=int(rng.integers(2, min(10, -(-n // 8)) + 1)),
                         **rules)
            for r in range(len(flat))]
    return (np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows]))


# Every case on the branches the kernel gives its width, and on the wide
# branch (which takes any width) too, a row on one block and split.
EMULATED = [(name, branch) for name in sorted(CASES)
            for branch in (("wide", "wide_long_row", "wide_split")
                           if name in WIDE_CASES
                           else ("on_chip", "long_row", "wide",
                                 "wide_split"))]


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
    for branch in ("on_chip", "long_row", "wide", "wide_long_row",
                   "wide_split"):
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
    for order, branch in enumerate(("wide", "wide_split")):
        _assert_same(_emulate(*args, seed=100 * seed + order,
                              branch=branch), want)


def test_tie_rule_mutation_fails():
    """Taking the last lanes at the threshold key instead of the first
    changes the result: the emulation's tie rule is load-bearing (the
    lanes at the threshold key reach the output without dedup)."""
    args = _case("ties_x1")
    with pytest.raises(AssertionError):
        _assert_same(_emulate(*args, tie_rule="last"), _plain(*args))


@pytest.mark.parametrize("name,branch", [("copies", "on_chip"),
                                         ("k_8192", "wide")])
def test_dedup_rule_mutation_fails(name, branch):
    """Keeping each id's last rank (atomicMax) instead of its first
    changes the result: the table's min is load-bearing, in the first
    kernel and in the wide row tail's waves."""
    args = _case(name)
    _assert_same(_emulate(*args, branch=branch), _plain(*args))
    with pytest.raises(AssertionError):
        _assert_same(_emulate(*args, branch=branch, dedup_rule="most"),
                     _plain(*args))


@pytest.mark.parametrize("name", ["ties_x1", "k_all_16384"])
def test_wide_lane_order_mutation_fails(name):
    """The wide branch's digit passes must be stable: a key's lanes stay
    ascending only because each pass keeps equal digits in order.  A
    scatter that ranks a warp's lanes of one digit from the last (ties
    broken by lane descending) changes the result where ties are
    selected, on one block and split."""
    args = _case(name)
    want = _plain(*args)
    for branch in ("wide", "wide_split"):
        _assert_same(_emulate(*args, branch=branch), want)
        with pytest.raises(AssertionError):
            _assert_same(_emulate(*args, branch=branch,
                                  digit_rule="unstable"), want)


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
    "k_all": ("wide", 132_112), "long_k16384": ("wide_long_row", 1_024),
    "k_lanes_max": ("wide_long_row", 1_024),
}
# Rows a group and tiles a row of the wide cases on the H100's 132 SMs:
# a row on one block while the rows fill about two blocks an SM, else
# split; every case's rows in one group.
WIDE_GRIDS = {
    "k_4097": (1024, 1), "k_wide": (4096, 1), "k_all": (256, 2),
    "long_k16384": (256, 2), "k_lanes_max": (2, 132),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_of_each_select_case(name):
    """Every phase 3e shape but long_row keeps its keys on chip within
    the 232,448 bytes a block may use; long_row (196,608 lanes at m
    2,048) takes the long-row branch; the bench's rows leave room for two
    blocks an SM (233,472 bytes, 1 KB reserved a block), on the wide
    branch too; more than MAX_SEL lanes selected take the wide branch,
    keys on chip beside nothing but the histogram, long_k16384's 196,608
    lanes and k_lanes_max's 2^22 without them (the histogram alone); the
    wide cases' groups and tiles (`WIDE_GRIDS`) keep each case's rows in
    one group, split k_all's, long_k16384's and k_lanes_max's rows and
    keep k_4097's and k_wide's on one block each."""
    _, b, _, p, cap, k_sel, _, _, _ = _select_cases()[name]
    n = p * cap
    plan = select_cuda.plan(n, min(k_sel, n))
    assert plan == PLANS[name]
    assert plan[1] + select_cuda.STATIC_RESERVE <= 232_448
    if name in ("bench_k512", "bench_k1024", "odd", "k_wide"):
        assert 2 * (plan[1] + select_cuda.STATIC_RESERVE + 1024) <= 233_472
    if name in WIDE_GRIDS:
        assert select_cuda.wide_grid(b, n, min(k_sel, n), 132) == \
            WIDE_GRIDS[name]


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
    # to n = 115,581; every longer row of up to 2^22 lanes in 1,024 bytes.
    assert select_cuda.plan(115_581, 8192) == ("wide", 232_192)
    assert select_cuda.plan(115_582, 8192) == ("wide_long_row", 1_024)
    assert select_cuda.plan(select_cuda.MAX_LANES, select_cuda.MAX_LANES) \
        == ("wide_long_row", 1_024)
    assert select_cuda.plan(5000, 4097) == ("wide", 11_040)


@pytest.mark.parametrize("b,n,k_eff,sms,grid", [
    (4096, 49152, 8192, 132, (4096, 1)), (256, 65536, 65536, 132, (256, 2)),
    (3, 5000, 4097, 132, (3, 2)), (64, 1 << 22, 1 << 22, 132, (10, 27)),
    (1, 1 << 22, 1 << 22, 132, (1, 264)), (2, 1 << 22, 1 << 22, 132,
                                           (2, 132)),
    (4096, 1 << 20, 1 << 20, 132, (41, 7)), (1, 8192, 8192, 132, (1, 2)),
])
def test_wide_grid(b, n, k_eff, sms, grid):
    """The wide branch's groups and tiles: as many rows a group as the
    1 GiB WORK_BUDGET holds at `wide_row_words` a row (ten at 2^22 lanes
    selected), and a row split into tiles of a multiple of 8 lanes, at
    least MIN_TILE, over about two blocks an SM when the group's rows are
    fewer (1 once they fill them)."""
    group, tiles = select_cuda.wide_grid(b, n, k_eff, sms)
    assert (group, tiles) == grid
    row = 8 * select_cuda.wide_row_words(n, k_eff)
    assert group == 1 or group * row <= select_cuda.WORK_BUDGET
    assert tiles <= min(-(-n // select_cuda.MIN_TILE),
                        max(1, -(-2 * sms // group)))


def test_wide_row_words():
    """A row's share of the wide workspace, as the kernel lays it out:
    k_eff items (even), the least power of two >= 2 * k_eff table slots,
    and the meta area (the head, 260 ints a lane tile of MIN_TILE, 256
    counts and a kept count an item tile of ITEM_TILE, rounded to 4)."""
    # k_wide: 8,192 items, 16,384 slots, 528 + 260 * 12 + 256 * 2 + 4.
    assert select_cuda.wide_row_words(49152, 8192) == \
        8192 + 16384 + (528 + 3120 + 512 + 4) // 2
    assert select_cuda.wide_row_words(4097, 4097) == \
        4098 + 16384 + (528 + 260 * 2 + 256 * 2 + 4) // 2
    big = select_cuda.wide_row_words(1 << 22, 1 << 22)
    assert big == (1 << 22) + (1 << 23) + (528 + 260 * 1024 + 257 * 1024) // 2
    assert 2 * 8 * big <= select_cuda.WORK_BUDGET


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
