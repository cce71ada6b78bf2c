"""IVF (inverted file) index in PyTorch: build and search.

Port of `ann_solo_tpu/index/ivf.py`, build and every search regime but
the voting budget:

* **Build** (`IvfIndex.build`): spherical k-means on a FAISS-style
  subsample, top-A centroid choices, the sort-based balanced fill of
  capped lists (`plan_assignments`, optional SOAR-ranked second copy),
  and the gather into one dense (L, cap, D) block; int8 storage is SQ8
  (per-row scale max|v| / 127, round half to even).
  `IvfIndex.build_streaming` builds the same index from a row accessor
  without the (N, D) source block (`fetch_rows_blocked`,
  `plan_assignments_device`, `_pack_group`); `load_or_build` takes it
  when that block would exceed `_STREAM_BUILD_SOURCE_BYTES`.
* **Search** (`IvfIndex.search_device`), every regime ranking by the same
  canonical order (16-bit bf16 key desc, global position asc; exact f32
  scores for f32 storage) and deduplicating redundant copies:
  - full scan (`_ivf_search_fullscan`): a 128-query tile's probed-list
    union covers the library and the (T, L, cap) f32 score block fits
    512 MB; every list is scanned and the probe set is a selection mask;
  - chunked regimes (`IvfIndex._search_chunked`), in super-tiles of up
    to 1,024 queries:
    - probe path (`_ivf_probe_scan_tile`): int8/bf16 storage within B2's
      lane bound; each query scans only its own probed lists through
      kernel B2 (`ops/ivf_probe_cuda.py`); exact, no certificates;
    - fused chunked scan (`_ivf_chunked_scan_tile`): int8/bf16 shapes
      beyond that bound where `chunked_pallas_supported` holds; each
      query's 8 best lists scanned exactly (B2), the cold tail through
      kernel B3 (`ops/ivf_scan_cuda.py`), with truncation certificates;
    - plain chunked scan (`_ivf_search_chunked`): f32 storage and the
      other shapes, pooled-max group selection with a tie certificate;
    flagged queries are repaired through the per-query oracle;
  - per-query oracle (`_ivf_search_perquery`): non-covering libraries
    too large for the chunked regimes, and the reference the others are
    tested against.
  The JAX package's voting-budget regime is not ported: its
  degenerate-tile rule picks between the chunked regimes and the oracle.

* **Host search** (`IvfIndex.search`, `search_with_scores`): NumPy in and
  out over `search_device`; `bruteforce_search` is the exact top-k oracle
  that recall is measured against.

* **Files** (`IvfIndex.save`, `load`, `load_or_build`,
  `ivf_index_filename`): one ``.ivf.npz`` per charge beside the library
  (NumPy's own format, no pickle; the JAX package's stem, never its
  ``.ivf.h5`` name), stamped with the fingerprint of the store content it
  was built from and rebuilt when that differs.

Placement and selection are bit-for-bit those of the JAX package given the
same inputs: stable sorts wherever the JAX code relies on `lax.top_k` or a
stable argsort, and no float atomics.
"""

from __future__ import annotations

import logging
import math
import os
import time
import zipfile
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ann_solo_tpu_torch.device import resolve_device, synchronize
from ann_solo_tpu_torch.io.files import write_npz_atomically
from ann_solo_tpu_torch.models.vectorize import (
    VectorizeParams,
    device_tables,
    vectorize_batch,
)
from ann_solo_tpu_torch.ops.ivf_probe import probe_scan_supported
from ann_solo_tpu_torch.ops.ivf_probe import window_mask as _window_mask
from ann_solo_tpu_torch.ops.ivf_probe_cuda import ivf_probe_scan
from ann_solo_tpu_torch.ops.ivf_scan import (
    _KEY_NEG_INF as _KEY16_NINF,
    _U32,
    _key16,
    _key16_to_f32,
    canonical_topk,
    chunked_pallas_supported,
    hot_list_count,
    ivf_chunked_scan_select,
)
from ann_solo_tpu_torch.ops.kmeans import (
    assign_topk_blocked,
    soar_round2_choices,
    spherical_kmeans,
)
from ann_solo_tpu_torch.ops.topk import stable_topk_desc

logger = logging.getLogger(__name__)

_TILE_Q = 128  # queries per search tile
_FULLSCAN_TRANSIENT = 1 << 29  # bytes of the (T, L, cap) f32 score block
_CHUNK_TQ = 1024  # queries per chunked-regime super-tile
_PROBE_BLOCK_BYTES = 1 << 29  # bytes of a super-tile's (tq, P*cap) f32 block
_CHUNK_TRANSIENT = 1 << 28  # bytes of the plain chunked scan's chunk block
_CHUNK_SCORE_BYTES = 4 << 30  # bytes of its stacked (B, L*cap) score block
_PERQUERY_GATHER_BYTES = 1 << 30  # bytes of an oracle group's gathered rows
_FILL_SLACK = 1.5  # list capacity = slack * mean list size
_N_CHOICES = 4  # spill candidates per vector (nearest centroids)
_TRAIN_POINTS_PER_CENTROID = 256  # FAISS subsampling rule
# `load_or_build` builds through `build_streaming` when the f32 source block
# (n * hash_len * 4 bytes) would exceed this (the JAX package's value).
_STREAM_BUILD_SOURCE_BYTES = 4 << 30
# Rows per accessor call of `build_streaming`: a multiple of
# `assign_topk_blocked`'s 16,384-row block, so the choices are computed in
# the in-memory build's matrix-product shapes.
_STREAM_BLOCK = 1 << 18


# --------------------------------------------------------------------- #
# Build


_STORAGE_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32,
                   "int8": torch.int8}


def ivf_index_filename(
    library_filename: str, config_hash: str, charge: int,
    index_dtype: str = "bf16", redundancy: int = 2,
    soar_lambda: float = 0.0,
) -> str:
    """Per-charge index path: the JAX package's stem (index-only settings
    -- storage dtype, redundant assignment, SOAR weight -- key the file
    name rather than the shared store hash, so switching them rebuilds
    just the index) with this package's own extension."""
    base = os.path.splitext(library_filename)[0]
    suffix = "" if index_dtype == "bf16" else f"_{index_dtype}"
    if redundancy != 1:
        suffix += f"_x{redundancy}"
    if soar_lambda > 0.0 and redundancy > 1:
        suffix += f"_soar{soar_lambda:g}"
    return f"{base}_{config_hash[:7]}_{charge}{suffix}.ivf.npz"


def _fill_lists(choices: torch.Tensor, used: torch.Tensor, num_list: int,
                cap: int):
    """Place each vector in its best-ranked list with a free slot.

    Round ``a`` tries every unplaced vector's ``a``-th choice; contenders
    for one list keep their row order (stable sort) and the first
    ``cap - used`` are accepted.  Returns (list, slot) per vector (-1 =
    unplaced) and the per-list fill counts.  Counts come from sorted-run
    boundaries, not atomics.
    """
    n, a_max = choices.shape
    dev = choices.device
    placed_list = torch.full((n,), -1, dtype=torch.int64, device=dev)
    placed_pos = torch.full((n,), -1, dtype=torch.int64, device=dev)
    iota = torch.arange(n, device=dev)
    lists = torch.arange(num_list + 1, device=dev)
    for a in range(a_max):
        cand = torch.where(placed_list < 0, choices[:, a], num_list)
        sorted_cand, order = torch.sort(cand, stable=True)
        starts = torch.searchsorted(sorted_cand, lists)  # (L + 1,)
        pos_in_seg = iota - starts[sorted_cand]
        safe_cand = sorted_cand.clamp_max(num_list - 1)
        slot = used[safe_cand] + pos_in_seg
        accept = (sorted_cand < num_list) & (slot < cap)
        placed_list[order] = torch.where(accept, sorted_cand,
                                         placed_list[order])
        placed_pos[order] = torch.where(accept, slot, placed_pos[order])
        counts = torch.diff(
            torch.cat([starts, starts.new_tensor([n])])
        )[:num_list]
        used = used + torch.minimum(counts, (cap - used).clamp_min(0))
    return placed_list, placed_pos, used


def _place_anywhere(placed_list: np.ndarray, placed_pos: np.ndarray,
                    used: np.ndarray, cap: int) -> np.ndarray:
    """Host fallback for primary copies whose every choice was full: the
    unplaced rows (list -1) take free slots of the emptiest lists, in row
    order.  Writes `placed_list` / `placed_pos` in place; returns the
    updated per-list fill counts."""
    unplaced = np.nonzero(placed_list < 0)[0]
    used = used.copy()
    free_slots = []
    for list_id in np.argsort(used):
        free_slots.extend((list_id, pos) for pos in range(used[list_id], cap))
        if len(free_slots) >= len(unplaced):
            break
    if len(free_slots) < len(unplaced):
        raise RuntimeError("IVF capacity exhausted; raise _FILL_SLACK")
    for row, (list_id, pos) in zip(unplaced, free_slots):
        placed_list[row] = list_id
        placed_pos[row] = pos
        used[list_id] += 1
    logger.debug("IVF spill fallback placed %d vectors", len(unplaced))
    return used


def plan_assignments(choices, num_list: int, cap: int, r_eff: int,
                     round_choices=None):
    """Balanced (optionally redundant) list placement for every vector.

    `r_eff` rounds of `_fill_lists`, each masking prior rounds' lists out
    of the ranking; round r >= 1 ranks by round_choices[r - 1] when given
    (the SOAR override).  Primary copies that overflow every choice go to
    any free slot (host pass, rare); later copies are best-effort.
    Returns (flat_slot (R*N,), row_ids (R*N,), spilled, round_lists) as
    NumPy arrays, like the JAX function.
    """
    choices = torch.as_tensor(choices).to(torch.int64)
    dev = choices.device
    n = choices.shape[0]
    primary = choices[:, 0].cpu().numpy()
    used = torch.zeros((num_list,), dtype=torch.int64, device=dev)
    all_slots, round_lists = [], []
    spilled = 0
    for r in range(r_eff):
        if (
            r >= 1
            and round_choices is not None
            and round_choices[r - 1] is not None
        ):
            override = torch.as_tensor(round_choices[r - 1]).to(
                device=dev, dtype=torch.int64
            )
            for placed in round_lists:
                placed_d = torch.as_tensor(placed, device=dev)
                override = torch.where(
                    override == placed_d[:, None], num_list, override
                )
            choices = override
        placed_list, placed_pos, used = _fill_lists(
            choices, used, num_list, cap
        )
        placed_list = placed_list.cpu().numpy().copy()
        placed_pos = placed_pos.cpu().numpy().copy()
        unplaced = np.nonzero(placed_list < 0)[0]
        if len(unplaced) and r == 0:
            used = torch.as_tensor(_place_anywhere(
                placed_list, placed_pos, used.cpu().numpy(), cap
            ), device=dev)
        elif len(unplaced):
            logger.debug(
                "IVF redundancy round %d dropped %d copies", r, len(unplaced)
            )
        if r == 0:
            spilled = int(np.sum(placed_list != primary))
        all_slots.append(np.where(
            placed_list >= 0, placed_list.astype(np.int64) * cap + placed_pos,
            -1,
        ))
        round_lists.append(placed_list.astype(np.int32))
        if r + 1 < r_eff:
            placed_d = torch.as_tensor(placed_list, device=dev)
            choices = torch.where(
                choices == placed_d[:, None], num_list, choices
            )
    flat_slot = np.concatenate(all_slots)
    row_ids = np.tile(np.arange(n, dtype=np.int32), r_eff)
    return flat_slot, row_ids, spilled, round_lists


def plan_assignments_device(choices, num_list: int, cap: int, r_eff: int,
                            round_choices=None):
    """`plan_assignments` without its (N,)-sized host round trips (the JAX
    `plan_assignments_device`): the same rounds, masking and fallback, and
    the same placement, returned as the device slot -> row table.

    Only the unplaced and spilled counts cross to the host, and the (N,)
    arrays of the all-choices-full fallback when that count is nonzero.
    Returns (ids_flat (L * cap,) int32 on the choices' device, -1 = empty
    slot; spilled).
    """
    ch = torch.as_tensor(choices).to(torch.int64)
    dev = ch.device
    n = ch.shape[0]
    primary = ch[:, 0]
    used = torch.zeros((num_list,), dtype=torch.int64, device=dev)
    total = num_list * cap
    # One slot past the table takes the rows a round left unplaced.
    ids_flat = torch.full((total + 1,), -1, dtype=torch.int32, device=dev)
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    placed_rounds = []
    spilled = 0
    for r in range(r_eff):
        if (
            r >= 1
            and round_choices is not None
            and round_choices[r - 1] is not None
        ):
            override = torch.as_tensor(round_choices[r - 1]).to(
                device=dev, dtype=torch.int64
            )
            for placed in placed_rounds:
                override = torch.where(
                    override == placed[:, None], num_list, override
                )
            ch = override
        placed_list, placed_pos, used = _fill_lists(ch, used, num_list, cap)
        if r == 0:
            if int((placed_list < 0).sum()):
                pl = placed_list.cpu().numpy().copy()
                pp = placed_pos.cpu().numpy().copy()
                used = torch.as_tensor(
                    _place_anywhere(pl, pp, used.cpu().numpy(), cap),
                    device=dev)
                placed_list = torch.as_tensor(pl, device=dev)
                placed_pos = torch.as_tensor(pp, device=dev)
            spilled = int((placed_list != primary).sum())
        flat = torch.where(placed_list >= 0, placed_list * cap + placed_pos,
                           total)
        ids_flat[flat] = iota
        placed_rounds.append(placed_list)
        if r + 1 < r_eff:
            ch = torch.where(ch == placed_list[:, None], num_list, ch)
    return ids_flat[:total], spilled


def fetch_rows_blocked(get_rows, idx, block: int = 1 << 16) -> torch.Tensor:
    """Rows `idx` through a streaming-build accessor, fetched in calls of
    exactly `block` rows and copied into one preallocated output.

    The tail block is padded by repeating the last index and the padding
    rows are dropped as the block is copied (accessors are pure functions
    of the row index, `IvfIndex.build_streaming`'s contract).  The parts
    are never concatenated, which would hold the result twice."""
    idx = torch.as_tensor(idx).to(torch.int64)
    n_rows = idx.shape[0]
    if n_rows <= block:
        return get_rows(idx)
    n_pad = -(-n_rows // block) * block
    if n_pad != n_rows:
        padded = idx[-1:].repeat(n_pad)
        padded[:n_rows] = idx
        idx = padded
    out = None
    for start in range(0, n_pad, block):
        part = get_rows(idx[start:start + block])
        if out is None:
            out = torch.empty((n_rows,) + tuple(part.shape[1:]),
                              dtype=part.dtype, device=part.device)
        stop = min(start + block, n_rows)
        out[start:stop] = part[:stop - start]
        del part
    return out


def train_subsample(get_rows, n: int, num_list: int, seed: int,
                    train_rows_cap: int, device) -> torch.Tensor:
    """The streaming builds' k-means rows: min(n, L * 256,
    `train_rows_cap`) rows drawn by ``np.random.RandomState(seed + 1)``,
    sorted (`build`'s FAISS-style subsample whenever the cap does not
    bind), fetched through `get_rows` in `_STREAM_BLOCK`-row calls."""
    sub_cap = min(n, num_list * _TRAIN_POINTS_PER_CENTROID, train_rows_cap)
    if sub_cap < n:
        sub_idx = np.sort(np.random.RandomState(seed + 1).choice(
            n, size=sub_cap, replace=False))
    else:
        sub_idx = np.arange(n)
    return fetch_rows_blocked(
        get_rows, torch.as_tensor(sub_idx, device=device),
        block=_STREAM_BLOCK,
    )


def _store_rows(rows: torch.Tensor, storage_dtype: torch.dtype):
    """(stored rows, scales or None) of (C, D) float32 `rows`: the SQ8
    arithmetic that both packers share.  int8 storage quantizes per row,
    scale = max|v| / 127, q = round(v / scale) (half to even); XLA compiles
    the reference's ``/ 127.0`` to a multiply by the float32 reciprocal,
    and the same multiply keeps the scales bit-identical.  Float storage
    casts the rows (scale 1, returned as None)."""
    if storage_dtype != torch.int8:
        return rows.to(storage_dtype), None
    inv127 = torch.tensor(
        np.float32(1.0) / np.float32(127.0), dtype=torch.float32,
        device=rows.device,
    )
    scale = rows.abs().amax(1) * inv127
    q = torch.round(rows / scale.clamp_min(1e-30)[:, None])
    return q.to(torch.int8), scale


@torch.no_grad()
def _pack_lists(vectors, flat_slot, row_ids, num_list: int, cap: int,
                storage_dtype: torch.dtype):
    """Scatter row ids into slots, then gather rows into (L, cap, D).

    Returns (ids_flat (L*cap,) int32, packed (L, cap, D), scales (L, cap)
    float32; all ones for float storage); rows stored by `_store_rows`."""
    n, d = vectors.shape
    dev = vectors.device
    total = num_list * cap
    flat_slot = torch.as_tensor(flat_slot, device=dev).to(torch.int64)
    row_ids = torch.as_tensor(row_ids, device=dev).to(torch.int32)
    keep = flat_slot >= 0
    ids_flat = torch.full((total,), -1, dtype=torch.int32, device=dev)
    ids_flat[flat_slot[keep]] = row_ids[keep]  # slots are distinct
    packed = torch.empty((total, d), dtype=storage_dtype, device=dev)
    scales = torch.ones((total,), dtype=torch.float32, device=dev)
    chunk = min(total, 1 << 20)
    for start in range(0, total, chunk):
        ids_chunk = ids_flat[start:start + chunk].to(torch.int64)
        safe = ids_chunk.clamp(0, n - 1)
        gathered = torch.where(
            (ids_chunk >= 0)[:, None], vectors[safe].to(torch.float32), 0.0
        )
        stored, scale = _store_rows(gathered, storage_dtype)
        packed[start:start + chunk] = stored
        if scale is not None:
            scales[start:start + chunk] = scale
    return (
        ids_flat,
        packed.view(num_list, cap, d),
        scales.view(num_list, cap),
    )


@torch.no_grad()
def _pack_group(packed, scales, src, valid, g0: int) -> None:
    """Store one list group in place (the JAX `_pack_group`): the
    (G * cap, D) source rows `src` of lists g0 .. g0 + G - 1, `valid`
    False on empty slots (whose rows may hold anything), go through
    `_store_rows` into the preallocated (L, cap, D) block and its
    scales."""
    _, cap, d = packed.shape
    rows = torch.where(valid[:, None], src.to(torch.float32), 0.0)
    stored, scale = _store_rows(rows, packed.dtype)
    g = rows.shape[0] // cap
    packed[g0:g0 + g] = stored.view(g, cap, d)
    if scale is not None:
        scales[g0:g0 + g] = scale.view(g, cap)


def _pack_prec(precursor_mz, ids_flat, num_list: int, cap: int):
    """(L, cap) float32 precursor m/z of each slot (0 on empty slots, and
    everywhere without `precursor_mz`)."""
    if precursor_mz is None:
        return torch.zeros((num_list, cap), device=ids_flat.device)
    prec = torch.as_tensor(precursor_mz).to(device=ids_flat.device,
                                            dtype=torch.float32)
    safe = ids_flat.to(torch.int64).clamp(0, prec.shape[0] - 1)
    return torch.where(ids_flat >= 0, prec[safe], 0.0).view(num_list, cap)


def resolve_num_list(num_list: int, n: int) -> int:
    """``num_list <= 0`` selects ~13*sqrt(n) rounded to a power of two,
    clamped to [16, 65536]; a positive value wins."""
    if num_list > 0:
        return int(num_list)
    target = 13.0 * math.sqrt(max(n, 1))
    exp = max(4, int(round(math.log2(max(target, 16.0)))))
    return int(min(1 << exp, 65536))


def resolve_num_probe(num_probe: int, num_list: int) -> int:
    """``num_probe <= 0`` selects num_list / 8 clamped to [512, 2048] and
    never above num_list; a positive value wins."""
    if num_probe > 0:
        return int(num_probe)
    return int(min(max(512, num_list // 8), 2048, max(num_list, 1)))


def ivf_build_params(n: int, num_list: int, redundancy: int,
                     soar_lambda: float = 0.0):
    """(r_eff, cap, n_choices) of a build."""
    r_eff = max(1, min(redundancy, num_list))
    cap = max(8, int(-(-_FILL_SLACK * r_eff * n / num_list // 8) * 8))
    n_choices = min(max(_N_CHOICES, r_eff + 2), num_list)
    if soar_lambda > 0.0 and r_eff >= 2:
        n_choices = min(max(n_choices, 16), num_list)
    return r_eff, cap, n_choices


def _build_settings(config, n: int, redundancy: Optional[int]):
    """(num_list, soar_lambda, r_eff, cap, n_choices) of a build of `n`
    rows: `config.num_list` resolved, `redundancy` (None: the config's
    `ivf_redundancy`, else 2) and the SOAR weight."""
    num_list = resolve_num_list(int(config.num_list), n)
    if redundancy is None:
        try:
            redundancy = int(config.ivf_redundancy)
        except (KeyError, AttributeError):
            redundancy = 2
    soar_lambda = resolve_soar_lambda(config)
    return (num_list, soar_lambda) + ivf_build_params(
        n, num_list, redundancy, soar_lambda)


def resolve_soar_lambda(config) -> float:
    """SOAR weight for the secondary copy (0 disables; default 1.0)."""
    try:
        return float(config.soar_lambda)
    except (KeyError, AttributeError, TypeError, ValueError):
        return 1.0


def soar_round_choices(vectors, centroids, choices, r_eff, soar_lambda):
    """Per-round candidate overrides for `plan_assignments` (or None):
    with SOAR on and R >= 2 the second round is SOAR-ranked; later rounds
    keep the plain rank order."""
    if soar_lambda <= 0.0 or r_eff < 2:
        return None
    second = soar_round2_choices(
        vectors, centroids, choices, float(soar_lambda)
    )
    return [second] + [None] * (r_eff - 2) if r_eff > 2 else [second]


# --------------------------------------------------------------------- #
# Search


def _dedup_topk(scores, ids, k: int):
    """Unique-id top-k over lanes in canonical order ((B, K') -> (B, k)):
    each id keeps its first lane, lane order preserved."""
    q, ks = ids.shape
    ids_s, rank_s = torch.sort(ids, dim=1, stable=True)
    first = torch.cat(
        [torch.ones_like(ids_s[:, :1], dtype=torch.bool),
         ids_s[:, 1:] != ids_s[:, :-1]],
        dim=1,
    ) & (ids_s >= 0)
    kept = torch.where(first, rank_s, ks)  # ks sorts last
    kept = torch.sort(kept, dim=1).values[:, :min(k, ks)]
    valid = kept < ks
    safe = torch.where(valid, kept, 0)
    out_s = torch.where(valid, scores.gather(1, safe), float("-inf"))
    out_i = torch.where(valid, ids.gather(1, safe), -1)
    return out_s, out_i


def _pad_topk(scores, ids, k: int):
    """Right-pad (B, K') top-k outputs to width k with -inf / -1."""
    k_eff = scores.shape[1]
    if k_eff >= k:
        return scores[:, :k], ids[:, :k]
    pad = (0, k - k_eff)
    return (
        F.pad(scores, pad, value=float("-inf")),
        F.pad(ids, pad, value=-1),
    )


def _canonical_topk_keys(keys: torch.Tensor, k_sel: int):
    """Canonical top-k (key desc, position asc) over (T, n) 16-bit keys:
    the bf16-rounded scores and their lane positions."""
    top, pos = canonical_topk(keys, k_sel)
    return _key16_to_f32(top), pos


def _probe_lists(queries, centroids, p: int) -> torch.Tensor:
    """Each query's top-`p` coarse lists by the f32 dot (lower list id
    first on ties, as `lax.top_k`), sorted ascending: lanes gathered in
    this order are in global position order, the canonical tie-break."""
    coarse = queries @ centroids.T
    return torch.sort(stable_topk_desc(coarse, p)[1], dim=1).values


@torch.no_grad()
def _ivf_search_fullscan(
    scan_block,  # (L*cap, D) float32 scan operand (dequantized storage)
    padded_ids,  # (L, cap) int32, -1 = padding
    padded_prec,  # (L, cap) float32
    padded_scales,  # (L, cap) float32
    centroids,  # (L, D) float32
    queries,  # (B, D) float32, B % _TILE_Q == 0
    q_prec,  # (B,) float32
    charge: float,
    num_probe: int,
    k: int,
    k_scan: int,  # entries selected before dedup (R * k)
    tol_val: float,
    tol_mode: str,
    redundant: bool,
    cast: bool,  # bf16/int8 storage: bf16 queries, 16-bit keys
):
    """Full-library tile scan (JAX `_ivf_search_fullscan`).

    Each 128-query tile scores every list as one matrix product; per-query
    ``nprobe`` semantics are purely the selection mask (the query's top
    `num_probe` coarse lists, taken with lower list ids first on ties),
    so nothing can drop.  Lanes are gathered in ascending probe-list
    order, making lane order the global-position tie-break."""
    l, cap = padded_ids.shape
    b = queries.shape[0]
    p = min(num_probe, l)
    k_sel = min(k_scan, p * cap)
    scales_flat = padded_scales.reshape(1, l * cap)
    out_s, out_i = [], []
    for start in range(0, b, _TILE_Q):
        qt = queries[start:start + _TILE_Q]
        qpt = q_prec[start:start + _TILE_Q]
        t = qt.shape[0]
        probe_ids = _probe_lists(qt, centroids, p)
        # Exact bf16 x bf16 products accumulated in f32 (int8 and bf16
        # storage values are exact in f32; TF32 is off).
        q_scan = qt.to(torch.bfloat16).to(torch.float32) if cast else qt
        scores = (q_scan @ scan_block.T) * scales_flat  # (T, L*cap)
        sel = scores.view(t, l, cap).gather(
            1, probe_ids[:, :, None].expand(t, p, cap)
        )  # (T, P, cap)
        if cast:
            sel = _key16(sel)  # elementwise: after the gather is cheaper
        ids_g = padded_ids[probe_ids]  # (T, P, cap)
        mask = ids_g >= 0
        if tol_val > 0:
            mask &= _window_mask(
                qpt[:, None, None], padded_prec[probe_ids], charge,
                tol_val, tol_mode,
            )
        if cast:
            flat = torch.where(mask, sel, _KEY16_NINF).view(t, p * cap)
            top_s, pos = _canonical_topk_keys(flat, k_sel)
        else:
            flat = torch.where(mask, sel, float("-inf")).view(t, p * cap)
            top_s, pos = stable_topk_desc(flat, k_sel)
        top_i = ids_g.view(t, p * cap).gather(1, pos)
        top_i = torch.where(top_s > float("-inf"), top_i, -1)
        if redundant or k_sel > k:
            top_s, top_i = _dedup_topk(top_s, top_i, k)
        top_s, top_i = _pad_topk(top_s, top_i, k)
        out_s.append(top_s)
        out_i.append(top_i)
    return torch.cat(out_s), torch.cat(out_i)


@torch.no_grad()
def _ivf_search_perquery(
    padded_vectors,  # (L, cap, D) int8/bfloat16/float32
    padded_ids,  # (L, cap) int32, -1 = padding
    padded_prec,  # (L, cap) float32
    padded_scales,  # (L, cap) float32
    centroids,  # (L, D) float32
    queries,  # (B, D) float32
    q_prec,  # (B,) float32
    charge: float,
    num_probe: int,
    k: int,
    k_scan: int,  # entries selected before dedup (R * k)
    tol_val: float,
    tol_mode: str,
    redundant: bool,
):
    """Exact per-query probe scan (JAX `_ivf_search_perquery`): the
    oracle of the probe path, and the regime of f32 storage beyond the
    full scan.

    Each query gathers its own top-`num_probe` lists in ascending id
    order, scores them as bf16(q) . storage accumulated in f32 (the f32
    query for f32 storage) times the slot scale, masks empty and
    out-of-window slots, and takes the canonical top-k (16-bit keys for
    int8/bf16 storage, exact f32 scores otherwise).  Queries go in
    groups whose gathered rows fit `_PERQUERY_GATHER_BYTES`; the results
    do not depend on the group size."""
    l, cap, d = padded_vectors.shape
    b = queries.shape[0]
    p = min(num_probe, l)
    k_eff = min(k_scan, p * cap)
    cast = padded_vectors.dtype != torch.float32
    probe_ids = _probe_lists(queries, centroids, p)
    q_scan = queries.to(torch.bfloat16).to(torch.float32) if cast else queries
    per_query = p * cap * d * (padded_vectors.element_size() + 4)
    group = max(1, _PERQUERY_GATHER_BYTES // per_query)
    out_s, out_i = [], []
    for start in range(0, b, group):
        probes = probe_ids[start:start + group]
        g = probes.shape[0]
        vecs = padded_vectors[probes].to(torch.float32)  # (G, P, cap, D)
        scores = torch.einsum("gd,gpcd->gpc", q_scan[start:start + g], vecs)
        scores = scores * padded_scales[probes]
        ids = padded_ids[probes]  # (G, P, cap)
        mask = ids >= 0
        if tol_val > 0:
            mask &= _window_mask(
                q_prec[start:start + g, None, None], padded_prec[probes],
                charge, tol_val, tol_mode,
            )
        flat = torch.where(mask, scores, float("-inf")).view(g, p * cap)
        if cast:
            top_s, pos = _canonical_topk_keys(_key16(flat), k_eff)
        else:
            top_s, pos = stable_topk_desc(flat, k_eff)
        top_i = ids.view(g, p * cap).gather(1, pos)
        out_s.append(top_s)
        out_i.append(torch.where(top_s > float("-inf"), top_i, -1))
    scores, ids = torch.cat(out_s), torch.cat(out_i)
    if redundant or k_eff > k:
        scores, ids = _dedup_topk(scores, ids, k)
    return _pad_topk(scores, ids, k)


@torch.no_grad()
def _ivf_probe_scan_tile(
    padded_vectors,  # (L, cap, D) int8/bfloat16
    padded_ids,  # (L, cap) int32
    padded_prec,  # (L, cap) float32
    padded_scales,  # (L, cap) float32
    centroids,  # (L, D) float32
    queries,  # (B, D) float32, contiguous
    q_prec,  # (B,) float32, contiguous
    charge: float,
    num_probe: int,
    k: int,
    k_scan: int,
    tol_val: float,
    tol_mode: str,
    redundant: bool,
):
    """Exact probe-gather scan of one super-tile (JAX
    `_ivf_probe_scan_tile`), the big-library select path.

    Kernel B2 writes every probed slot's masked score in (probe rank,
    slot) lane order, which with ascending probe ids is the oracle's lane
    order; the same canonical top-k and dedup then run on it, so the
    results are `_ivf_search_perquery`'s with no certificates and no
    repair."""
    l, cap, _ = padded_vectors.shape
    p = min(num_probe, l)
    k_eff = min(k_scan, p * cap)
    probe_ids = _probe_lists(queries, centroids, p)
    flat = ivf_probe_scan(
        padded_vectors, padded_ids, padded_prec, padded_scales, queries,
        q_prec, charge, probe_ids, tol_val, tol_mode,
    )  # (B, P * cap) f32, -inf masked
    top_s, pos = _canonical_topk_keys(_key16(flat), k_eff)
    del flat
    rank = pos // cap
    lists = probe_ids.gather(1, rank)
    top_i = padded_ids[lists, pos - rank * cap]
    top_i = torch.where(top_s > float("-inf"), top_i, -1)
    if redundant or k_eff > k:
        top_s, top_i = _dedup_topk(top_s, top_i, k)
    return _pad_topk(top_s, top_i, k)


@torch.no_grad()
def _ivf_chunked_scan_tile(
    padded_vectors,  # (L, cap, D) int8/bfloat16
    padded_ids,  # (L, cap) int32
    padded_prec,  # (L, cap) float32
    padded_scales,  # (L, cap) float32
    centroids,  # (L, D) float32
    queries,  # (B, D) float32, contiguous
    q_prec,  # (B,) float32, contiguous
    charge: float,
    num_probe: int,
    k: int,
    k_scan: int,
    tol_val: float,
    tol_mode: str,
    redundant: bool,
):
    """Fused chunked scan of one super-tile (JAX `_ivf_chunked_pallas_tile`).

    The query's top `hot_list_count` coarse lists go to the exact hot scan,
    the rest to kernel B3; each half is sorted ascending (canonical lane
    order).  Returns (scores, ids, flags): flagged queries may differ from
    `_ivf_search_perquery` and are repaired by the caller; the others
    equal it (its canonical order, its dedup)."""
    l, cap, _ = padded_vectors.shape
    p = min(num_probe, l)
    probe_ranked = stable_topk_desc(queries @ centroids.T, p)[1]
    h = hot_list_count(p)
    hot_ids = torch.sort(probe_ranked[:, :h], dim=1).values if h else None
    cold_ids = torch.sort(probe_ranked[:, h:], dim=1).values
    run_s, flat_pos, inexact = ivf_chunked_scan_select(
        padded_vectors, padded_ids, padded_prec, padded_scales, queries,
        q_prec, charge, cold_ids, p - h, k_scan, tol_val, tol_mode,
        hot_ids=hot_ids,
    )
    k_eff = run_s.shape[1]
    # Lanes of -inf score may carry any position: clamp before the lookup.
    safe = flat_pos.clamp(0, l * cap - 1)
    run_i = torch.where(run_s > float("-inf"), padded_ids.view(-1)[safe], -1)
    if redundant or k_eff > k:
        run_s, run_i = _dedup_topk(run_s, run_i, k)
    out_s, out_i = _pad_topk(run_s, run_i, k)
    return out_s, out_i, inexact


def _tie_unsafe(pool_vals, kept_vals):
    """Boundary-tie detector of the group selection (JAX `_tie_unsafe`): a
    query is flagged when more groups than were kept hold the kept
    boundary value (an excluded group could hold an entry that ties into
    the top-k)."""
    boundary = kept_vals[:, -1:]
    finite = torch.isfinite(boundary)
    n_at = ((pool_vals == boundary) & finite).sum(1)
    n_kept_at = ((kept_vals == boundary) & finite).sum(1)
    return n_at > n_kept_at


def _total_order_key(x: torch.Tensor) -> torch.Tensor:
    """int64 key of float32 values in IEEE total order (-0.0 < 0.0), the
    order `lax.sort` gives floats."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)


@torch.no_grad()
def _ivf_search_chunked(
    padded_vectors,  # (L, cap, D) int8/bfloat16/float32
    padded_ids,  # (L, cap) int32, -1 = padding
    padded_prec,  # (L, cap) float32
    padded_scales,  # (L, cap) float32
    centroids,  # (L, D) float32
    queries,  # (B, D) float32
    q_prec,  # (B,) float32
    charge: float,
    num_probe: int,
    k: int,
    k_scan: int,  # entries selected before dedup (R * k)
    pool_g: int,  # rows max-pooled per group
    list_chunk: int,  # lists scanned per chunk
    tol_val: float,
    tol_mode: str,
    redundant: bool = True,
):
    """Plain chunked full-library scan with pooled-max group selection
    (JAX `_ivf_search_chunked`): the regime of f32 storage and of the
    int8/bf16 shapes the fused kernel does not take.

    Pass A scores `list_chunk` lists at a time (one matrix product; the
    last chunk is clamped to the library's end and its re-read lists are
    masked), keeps every masked score in storage precision (bf16 for
    int8/bf16 storage, f32 otherwise) and each `pool_g`-slot group's max.
    The top-k_run groups by max contain every top-k_run entry; two pooling
    levels keep each selection narrow.  Only an exact tie at a group
    boundary can break that, which `_tie_unsafe` flags.  The final sort is
    canonical: score desc (total order), true flat position asc.
    Returns (scores, ids, flags)."""
    l, cap, d = padded_vectors.shape
    b = queries.shape[0]
    dev = queries.device
    p = min(num_probe, l)
    g = pool_g
    while cap % g:
        g -= 1  # largest divisor of cap <= pool_g
    c_lists = min(list_chunk, l)
    n_chunks = -(-l // c_lists)
    k_run = min(k_scan, p * cap)
    cast = padded_vectors.dtype != torch.float32
    score_dtype = torch.bfloat16 if cast else torch.float32
    npl = cap // g
    inner = c_lists * cap
    n_groups = n_chunks * c_lists * npl
    neg = float("-inf")

    probe_ids = stable_topk_desc(queries @ centroids.T, p)[1]
    probed = torch.zeros((b, l), dtype=torch.bool, device=dev)
    probed.scatter_(1, probe_ids, True)
    q_scan = queries.to(torch.bfloat16).to(torch.float32) if cast else queries
    fresh_iota = torch.arange(c_lists, device=dev)
    scores_st = torch.empty((n_chunks, b, inner), dtype=score_dtype,
                            device=dev)
    pooled = torch.empty((b, n_chunks, c_lists * npl), dtype=score_dtype,
                         device=dev)
    for c in range(n_chunks):
        start = min(c * c_lists, l - c_lists)
        lists = slice(start, start + c_lists)
        vecs = padded_vectors[lists].reshape(inner, d).to(torch.float32)
        s = (q_scan @ vecs.T).view(b, c_lists, cap) * padded_scales[lists]
        fresh = (start + fresh_iota) >= c * c_lists
        mask = ((padded_ids[lists] >= 0)[None] & probed[:, lists, None]
                & fresh[None, :, None])
        if tol_val > 0:
            mask &= _window_mask(q_prec[:, None, None],
                                 padded_prec[lists][None], charge, tol_val,
                                 tol_mode)
        s = torch.where(mask, s.to(score_dtype), neg)
        scores_st[c] = s.view(b, inner)
        pooled[:, c] = s.view(b, c_lists * npl, g).amax(-1)
        del s, mask
    pooled = pooled.view(b, n_groups)

    g2 = 32  # level-2 pooling keeps each selection narrow
    n_g2 = -(-n_groups // g2)
    pooled2 = F.pad(pooled, (0, n_g2 * g2 - n_groups), value=neg).view(
        b, n_g2, g2).amax(-1)
    inexact = torch.zeros((b,), dtype=torch.bool, device=dev)
    if k_run < n_g2:
        v2, i2 = stable_topk_desc(pooled2, k_run)
        inexact |= _tie_unsafe(pooled2, v2)
        # Level-2 padding lanes are -inf, not clamped copies of a real
        # group (a copy could be selected twice and surface duplicates).
        g1_raw = (i2[:, :, None] * g2
                  + torch.arange(g2, device=dev)).view(b, k_run * g2)
        g1_pos = g1_raw.clamp_max(n_groups - 1)
        g1_vals = torch.where(g1_raw < n_groups, pooled.gather(1, g1_pos),
                              neg)
    else:
        g1_pos = torch.arange(n_groups, device=dev).expand(b, n_groups)
        g1_vals = pooled
    if k_run < g1_vals.shape[1]:
        v1, i1 = stable_topk_desc(g1_vals, k_run)
        sel_groups = g1_pos.gather(1, i1)
        inexact |= _tie_unsafe(pooled, v1)
    else:
        sel_groups = g1_pos

    # Members of the chosen groups, in the chunk-stacked space; true flat
    # positions account for the clamped last chunk.
    n_members = sel_groups.shape[1] * g
    member = (sel_groups[:, :, None] * g
              + torch.arange(g, device=dev)).reshape(b, n_members)
    chunk_idx = member // inner
    inner_idx = member - chunk_idx * inner
    member_pos = ((chunk_idx * c_lists).clamp_max(l - c_lists) * cap
                  + inner_idx)
    member_s = scores_st[chunk_idx, torch.arange(b, device=dev)[:, None],
                         inner_idx]
    del scores_st
    k_eff = min(k_run, n_members)
    # Canonical order: score desc in total order, then position asc, as
    # one int64 per lane (equal values are the same (score, position)).
    packed = (_total_order_key(member_s) * (1 << 32)
              + (_U32 - member_pos))
    lane = torch.topk(packed, k_eff, dim=1, sorted=True).indices
    run_s = member_s.gather(1, lane).to(torch.float32)
    run_pos = member_pos.gather(1, lane)
    run_s = torch.where(torch.isfinite(run_s), run_s, neg)
    run_i = torch.where(run_s > neg, padded_ids.view(-1)[run_pos], -1)
    if redundant or k_eff > k:
        run_s, run_i = _dedup_topk(run_s, run_i, k)
    out_s, out_i = _pad_topk(run_s, run_i, k)
    return out_s, out_i, inexact


def chunked_scan_params(l: int, cap: int, num_probe: int, k_scan: int,
                        b: int):
    """(pool_g, list_chunk) of `_ivf_search_chunked`: 32-slot pooling
    groups, and chunks whose (B, C, cap) f32 score block fits
    `_CHUNK_TRANSIENT`, preferring a divisor of L close below."""
    pool_g = 32
    c_max = max(1, _CHUNK_TRANSIENT // (max(b, 1) * cap * 4))
    list_chunk = min(l, c_max)
    if l % list_chunk:
        for c in range(list_chunk, list_chunk // 2, -1):
            if l % c == 0:
                list_chunk = c
                break
    return pool_g, list_chunk


class HostSearch:
    """`search` and `search_with_scores` over `search_device`: NumPy in
    and out (the JAX `IvfIndex.search` signature; `ShardedIvfIndex`
    shares it)."""

    def search(self, queries, k: int, num_probe: Optional[int] = None,
               q_prec=None, charge: float = 1.0, tol_val: float = 0.0,
               tol_mode: str = "Da") -> np.ndarray:
        """Top-k neighbor row ids per query ((B, k) int32, -1 padded),
        in query order.  When `tol_val` > 0, the precursor window (|q - l|
        * charge <= tol in Da mode, ppm otherwise) is fused into the scan
        mask."""
        ids, _ = self.search_with_scores(queries, k, num_probe, q_prec,
                                         charge, tol_val, tol_mode)
        return ids

    def search_with_scores(self, queries, k: int,
                           num_probe: Optional[int] = None, q_prec=None,
                           charge: float = 1.0, tol_val: float = 0.0,
                           tol_mode: str = "Da"):
        """Like `search`, also returning the (B, k) float32 scores."""
        ids, scores = self.search_device(queries, k, num_probe, q_prec,
                                         charge, tol_val, tol_mode)
        return ids.cpu().numpy(), scores.cpu().numpy()


class IvfIndex(HostSearch):
    """Inverted-file index over one charge partition, on one device."""

    def __init__(
        self,
        centroids: torch.Tensor,  # (L, D) float32
        padded_vectors: torch.Tensor,  # (L, cap, D) int8/bfloat16/float32
        padded_ids: torch.Tensor,  # (L, cap) int32
        num_probe: int,
        padded_prec: torch.Tensor,  # (L, cap) float32, 0 = no window
        padded_scales: torch.Tensor,  # (L, cap) float32, 1 unless int8
        redundancy: int = 1,
        store_fp: Optional[str] = None,
    ):
        # Fingerprint of the store content the lists' ids point into.
        self.store_fp = store_fp
        self.centroids = centroids.to(torch.float32)
        self.padded_vectors = padded_vectors
        self.padded_ids = padded_ids.to(torch.int32)
        self.num_probe = resolve_num_probe(
            int(num_probe), padded_vectors.shape[0]
        )
        self.redundancy = max(1, int(redundancy))
        self.padded_prec = padded_prec.to(torch.float32)
        self.padded_scales = padded_scales.to(torch.float32)
        self._scan_block = None
        # Queries the last chunked-regime search repaired (0 on the
        # probe path, which is exact).
        self._last_chunked_flagged = 0

    @property
    def device(self) -> torch.device:
        return self.padded_vectors.device

    @property
    def num_list(self) -> int:
        return self.padded_vectors.shape[0]

    def scan_block(self) -> torch.Tensor:
        """(L*cap, D) float32 copy of the list block for the scan product
        (cached; int8 and bf16 values convert exactly)."""
        if self._scan_block is None:
            l, cap, d = self.padded_vectors.shape
            self._scan_block = self.padded_vectors.reshape(l * cap, d).to(
                torch.float32
            )
        return self._scan_block

    @classmethod
    @torch.no_grad()
    def build(
        cls,
        vectors: torch.Tensor,  # (N, D) float32 unit vectors
        config,  # num_list, num_probe[, ivf_redundancy, soar_lambda]
        precursor_mz=None,
        seed: int = 42,
        storage_dtype: torch.dtype = torch.bfloat16,
        redundancy: Optional[int] = None,
        centroids=None,
        device=None,
    ) -> "IvfIndex":
        """Train the quantizer and pack balanced lists on `device` (the
        JAX `IvfIndex.build`; passing ``centroids`` skips training)."""
        device = resolve_device(device)
        vectors = torch.as_tensor(vectors).to(device=device,
                                              dtype=torch.float32)
        n = vectors.shape[0]
        num_list, soar_lambda, r_eff, cap, n_choices = _build_settings(
            config, n, redundancy)
        logger.info(
            "Train IVF index: %d vectors, %d lists (cap %d, x%d)",
            n, num_list, cap, r_eff,
        )
        if centroids is None:
            centroids, _ = spherical_kmeans(
                vectors, num_list, seed=seed,
                max_points_per_centroid=_TRAIN_POINTS_PER_CENTROID,
            )
        centroids = torch.as_tensor(centroids).to(device=device,
                                                  dtype=torch.float32)
        choices = assign_topk_blocked(vectors, centroids, n_choices)
        round_choices = soar_round_choices(
            vectors, centroids, choices, r_eff, soar_lambda
        )
        flat_slot, row_ids, _, _ = plan_assignments(
            choices, num_list, cap, r_eff, round_choices=round_choices
        )
        ids_flat, padded_vectors, padded_scales = _pack_lists(
            vectors, flat_slot, row_ids, num_list, cap, storage_dtype
        )
        return cls(
            centroids, padded_vectors, ids_flat.view(num_list, cap),
            int(config.num_probe),
            _pack_prec(precursor_mz, ids_flat, num_list, cap),
            padded_scales, redundancy=r_eff,
        )

    @classmethod
    @torch.no_grad()
    def build_streaming(
        cls,
        get_rows,  # (M,) int64 row ids on `device` -> (M, d) rows there
        n: int,
        d: int,
        config,  # num_list, num_probe[, ivf_redundancy, soar_lambda]
        precursor_mz=None,
        seed: int = 42,
        storage_dtype: torch.dtype = torch.int8,
        redundancy: Optional[int] = None,
        centroids=None,
        group_bytes: int = 1 << 30,
        train_rows_cap: int = 1 << 21,
        device=None,
    ) -> "IvfIndex":
        """Build without ever holding the (n, d) source block (the JAX
        `IvfIndex.build_streaming`).

        Device memory holds the packed (L, cap, D) block, one list group's
        source rows and the training subsample:

        1. k-means on a subsample fetched through `fetch_rows_blocked` in
           `_STREAM_BLOCK`-row calls: min(n, L * 256, `train_rows_cap`)
           rows drawn by ``np.random.RandomState(seed + 1)``, the rows of
           `build`'s FAISS-style subsample whenever `train_rows_cap` does
           not bind;
        2. top-A choices (and SOAR second-round choices) per
           `_STREAM_BLOCK`-row block, in `build`'s matrix-product shapes;
        3. the balanced capped placement on the device
           (`plan_assignments_device`);
        4. list groups of about `group_bytes` (source rows in f32 plus
           stored rows): each group's rows are fetched again, stored by
           `_store_rows` and written into the preallocated block
           (`_pack_group`).

        `get_rows` returns the rows of arbitrary indices; an index may be
        -1 (an empty slot), whose row may hold anything: the packer masks
        it.  It must be a pure function of the row index.  Placement and
        storage are byte-identical to `build` with the same seed whenever
        `train_rows_cap` does not bind.  The JAX package lane-pads D to a
        multiple of 128 for indexes beyond its full-scan bound; that
        padding serves TPU tiling and is not ported.
        """
        device = resolve_device(device)
        num_list, soar_lambda, r_eff, cap, n_choices = _build_settings(
            config, n, redundancy)
        logger.info(
            "Streaming IVF build: %d vectors, %d lists (cap %d, x%d)",
            n, num_list, cap, r_eff,
        )
        if centroids is None:
            sub = train_subsample(get_rows, n, num_list, seed,
                                  train_rows_cap, device)
            centroids, _ = spherical_kmeans(sub, num_list, seed=seed)
            del sub
        centroids = torch.as_tensor(centroids).to(device=device,
                                                  dtype=torch.float32)

        ch_parts, soar_parts = [], []
        for start in range(0, n, _STREAM_BLOCK):
            rows = get_rows(torch.arange(start, min(start + _STREAM_BLOCK, n),
                                         device=device))
            ch = assign_topk_blocked(rows, centroids, n_choices)
            ch_parts.append(ch)
            rc = soar_round_choices(rows, centroids, ch, r_eff, soar_lambda)
            if rc is not None:
                soar_parts.append(rc[0])
            del rows
        choices = torch.cat(ch_parts)
        del ch_parts
        round_choices = None
        if soar_parts:
            round_choices = [torch.cat(soar_parts)] + [None] * (r_eff - 2)
            del soar_parts
        ids_flat, spilled = plan_assignments_device(
            choices, num_list, cap, r_eff, round_choices=round_choices
        )
        del choices, round_choices
        logger.debug(
            "IVF lists: cap=%d fill=%.2f spilled=%d (%.2f%%)",
            cap, r_eff * n / (num_list * cap), spilled,
            100.0 * spilled / max(n, 1),
        )

        itemsize = torch.empty((), dtype=storage_dtype).element_size()
        group_lists = max(1, int(group_bytes // (cap * d * (4 + itemsize))))
        while num_list % group_lists:
            group_lists -= 1
        packed = torch.zeros((num_list, cap, d), dtype=storage_dtype,
                             device=device)
        scales = torch.ones((num_list, cap), dtype=torch.float32,
                            device=device)
        for g0 in range(0, num_list, group_lists):
            idx = ids_flat[g0 * cap:(g0 + group_lists) * cap]
            _pack_group(packed, scales, get_rows(idx.to(torch.int64)),
                        idx >= 0, g0)
        return cls(
            centroids, packed, ids_flat.view(num_list, cap),
            int(config.num_probe),
            _pack_prec(precursor_mz, ids_flat, num_list, cap), scales,
            redundancy=r_eff,
        )

    @classmethod
    @torch.no_grad()
    def load_or_build(
        cls, filename: str, lib, config, store_fp: Optional[str] = None,
        device=None, stage_seconds: Optional[Dict[str, float]] = None,
        notes: Optional[Dict[str, object]] = None,
    ) -> "IvfIndex":
        """Load a persisted index, or vectorize the charge block and build
        one, and save it (the JAX `IvfIndex.load_or_build`).

        `lib` holds the charge block's processed peaks (`mz`, `intensity`,
        `n_peaks`, `precursor_mz`, `n_spectra`; or the same on the device
        as `lib.block`).  `store_fp` identifies the store content the
        index was built from; a persisted index with a different
        fingerprint rebuilds, and so does one without any when the caller
        has one: the file name only encodes the settings hash, and ids of
        an index built from other store content point at the wrong
        spectra.  With `stage_seconds` given, "index load" seconds, or
        "index build" and "index write" seconds, are added to it; with
        `notes` given, a build sets ``notes["build"]``.

        The build is `build_streaming` ("streaming"), re-vectorizing the
        requested rows on the device the peaks live on, when the f32
        source block (n * hash_len * 4 bytes) would exceed
        `_STREAM_BUILD_SOURCE_BYTES`; else `build` on the vectorized
        block ("in memory").  Vectorization is deterministic per row, so
        both give the same index.  Not ported: the JAX package's
        one-resident-index eviction (one card holds every charge's index).
        """
        device = resolve_device(device)
        seconds = stage_seconds if stage_seconds is not None else {}

        def add(name, t0):
            synchronize(device)
            seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0

        if os.path.isfile(filename):
            try:
                t0 = time.perf_counter()
                index = cls.load(filename, int(config.num_probe), device)
                if store_fp is None or index.store_fp == store_fp:
                    add("index load", t0)
                    return index
                logger.warning(
                    "ANN index %s was built from different store "
                    "content (%s != %s); rebuilding",
                    os.path.basename(filename), index.store_fp, store_fp,
                )
                del index
            except (OSError, ValueError, KeyError, EOFError,
                    zipfile.BadZipFile) as e:
                logger.warning("Failed to load ANN index %s: %s", filename, e)
        logger.warning(
            "Missing ANN index for %s; building", os.path.basename(filename)
        )
        t0 = time.perf_counter()
        vparams = VectorizeParams.from_config(config)
        tables = device_tables(vparams, device)
        try:
            dtype_name = str(config.index_dtype)
        except (KeyError, AttributeError):
            dtype_name = "bf16"
        block = getattr(lib, "block", lib)
        mz, intensity, n_peaks = (
            torch.as_tensor(a).to(device)
            for a in (block.mz, block.intensity, lib.n_peaks))
        n, d = int(lib.n_spectra), int(vparams.hash_len)
        build_kw = dict(
            precursor_mz=np.asarray(lib.precursor_mz, np.float32),
            storage_dtype=_STORAGE_DTYPES[dtype_name], device=device,
        )
        if n * d * 4 > _STREAM_BUILD_SOURCE_BYTES:
            def get_rows(idx):
                rows = idx.clamp(0, n - 1)
                return vectorize_batch(vparams, tables, mz[rows],
                                       intensity[rows], n_peaks[rows])

            build = "streaming"
            index = cls.build_streaming(get_rows, n, d, config, **build_kw)
        else:
            step = 8192
            vectors = torch.cat([
                vectorize_batch(vparams, tables, mz[s:s + step],
                                intensity[s:s + step], n_peaks[s:s + step])
                for s in range(0, n, step)
            ])
            build = "in memory"
            index = cls.build(vectors, config, **build_kw)
            del vectors
        if notes is not None:
            notes["build"] = build
        index.store_fp = store_fp
        add("index build", t0)
        t0 = time.perf_counter()
        index.save(filename)
        add("index write", t0)
        return index

    def save(self, filename: str) -> None:
        """Write the index: the five arrays, each downloaded once, the
        redundancy and, when set, the store fingerprint.  bf16 vectors
        travel as their 16-bit patterns under `padded_vectors_bf16`.  The
        file appears under its name only when complete."""
        vectors = self.padded_vectors.cpu()
        if vectors.dtype == torch.bfloat16:
            arrays = {"padded_vectors_bf16":
                      vectors.view(torch.int16).numpy().view(np.uint16)}
        else:
            arrays = {"padded_vectors": vectors.numpy()}
        arrays["centroids"] = self.centroids.cpu().numpy()
        arrays["padded_ids"] = self.padded_ids.cpu().numpy()
        arrays["padded_prec"] = self.padded_prec.cpu().numpy()
        arrays["padded_scales"] = self.padded_scales.cpu().numpy()
        arrays["redundancy"] = np.asarray(self.redundancy, np.int64)
        if self.store_fp is not None:
            arrays["store_fp"] = np.asarray(str(self.store_fp))
        write_npz_atomically(filename, arrays)

    @classmethod
    def load(cls, filename: str, num_probe: int, device=None) -> "IvfIndex":
        """Read an index written by `save` straight onto `device`."""
        device = resolve_device(device)
        with np.load(filename, allow_pickle=False) as f:
            if "padded_vectors_bf16" in f:
                vectors = torch.from_numpy(
                    f["padded_vectors_bf16"].view(np.int16)
                ).view(torch.bfloat16)
            else:
                vectors = torch.from_numpy(f["padded_vectors"])
            return cls(
                torch.from_numpy(f["centroids"]).to(device),
                vectors.to(device),
                torch.from_numpy(f["padded_ids"]).to(device),
                num_probe,
                torch.from_numpy(f["padded_prec"]).to(device),
                torch.from_numpy(f["padded_scales"]).to(device),
                redundancy=int(f["redundancy"]),
                store_fp=(str(f["store_fp"][()]) if "store_fp" in f
                          else None),
            )

    @torch.no_grad()
    def search_device(
        self,
        queries,
        k: int,
        num_probe: Optional[int] = None,
        q_prec=None,
        charge: float = 1.0,
        tol_val: float = 0.0,
        tol_mode: str = "Da",
    ):
        """Top-k neighbor ids and scores per query ((B, k) int32 ids, -1
        padded; (B, k) float32 scores), as tensors on the index device.

        Regimes, in the JAX package's order: the full scan where a tile's
        probe union covers the library and its score block fits; else the
        chunked regimes of `_search_chunked` (kernel B2's probe path, kernel
        B3, or the plain chunked scan) where the union covers the library;
        where it does not (the JAX package's voting regime, not ported),
        its degenerate-tile rule: `_search_chunked` when the probe path
        applies or the library has at most num_probe * `_CHUNK_TQ` lists,
        else the per-query oracle."""
        num_probe = int(num_probe or self.num_probe)
        dev = self.device
        queries = torch.as_tensor(queries).to(
            device=dev, dtype=torch.float32).contiguous()
        b = queries.shape[0]
        if b == 0:
            return (
                torch.zeros((0, k), dtype=torch.int32, device=dev),
                torch.zeros((0, k), dtype=torch.float32, device=dev),
            )
        if q_prec is None:
            q_prec = torch.zeros(b, device=dev)
            tol_val = 0.0
        q_prec = torch.as_tensor(q_prec).to(
            device=dev, dtype=torch.float32).contiguous()
        dtype = self.padded_vectors.dtype
        args = (float(charge), num_probe, k, self.redundancy * k,
                float(tol_val), tol_mode, self.redundancy > 1)
        regime = self.regime(k, num_probe)
        if regime == "fullscan":
            b_pad = -(-b // _TILE_Q) * _TILE_Q
            if b_pad != b:
                queries = F.pad(queries, (0, 0, 0, b_pad - b))
                q_prec = F.pad(q_prec, (0, b_pad - b))
            scores, ids = _ivf_search_fullscan(
                self.scan_block(), self.padded_ids, self.padded_prec,
                self.padded_scales, self.centroids, queries, q_prec, *args,
                dtype != torch.float32,
            )
            return ids[:b].to(torch.int32), scores[:b]
        if regime == "perquery":
            scores, ids = _ivf_search_perquery(*self._blocks(), queries,
                                               q_prec, *args)
        else:
            scores, ids = self._search_chunked(queries, q_prec, *args)
        return ids.to(torch.int32), scores

    def regime(self, k: int, num_probe: Optional[int] = None) -> str:
        """The regime `search_device` takes for top-`k` at `num_probe`:
        "fullscan", "probe" (kernel B2), "fused" (kernel B3), "chunked"
        (the plain chunked scan) or "perquery" (the oracle)."""
        num_probe = int(num_probe or self.num_probe)
        l, cap, d = self.padded_vectors.shape
        dtype = self.padded_vectors.dtype
        union_covers = l <= num_probe * _TILE_Q
        if union_covers and l * cap * 4 * _TILE_Q <= _FULLSCAN_TRANSIENT:
            return "fullscan"
        if probe_scan_supported(l, cap, num_probe, dtype):
            return "probe"
        if not (union_covers or l <= num_probe * _CHUNK_TQ):
            return "perquery"
        if chunked_pallas_supported(l, cap, d, num_probe,
                                    self.redundancy * k, dtype):
            return "fused"
        return "chunked"

    def _blocks(self):
        return (self.padded_vectors, self.padded_ids, self.padded_prec,
                self.padded_scales, self.centroids)

    def _search_chunked(self, queries, q_prec, charge: float,
                        num_probe: int, k: int, k_scan: int, tol_val: float,
                        tol_mode: str, redundant: bool):
        """Big-library search over super-tiles (JAX `_search_chunked`).

        The probe path (kernel B2, `_ivf_probe_scan_tile`) where
        `probe_scan_supported` holds: exact by construction, super-tiles
        of up to `_CHUNK_TQ` queries whose (tq, P * cap) f32 block fits
        `_PROBE_BLOCK_BYTES`.  Else kernel B3 (`_ivf_chunked_scan_tile`)
        where `chunked_pallas_supported` holds, in `_CHUNK_TQ`-query
        super-tiles.  Else the plain chunked scan (`_ivf_search_chunked`),
        in power-of-two super-tiles of at least 128 queries whose stacked
        score block fits `_CHUNK_SCORE_BYTES`.  The last two carry
        certificates: one host download of the flags, then the flagged
        queries are repaired through the per-query oracle; their count is
        kept in ``_last_chunked_flagged``."""
        l, cap, d = self.padded_vectors.shape
        dtype = self.padded_vectors.dtype
        b = queries.shape[0]
        use_probe = probe_scan_supported(l, cap, num_probe, dtype)
        use_fused = not use_probe and chunked_pallas_supported(
            l, cap, d, num_probe, k_scan, dtype)
        if use_probe:
            lanes = min(num_probe, l) * cap
            tq = min(_CHUNK_TQ, max(1, _PROBE_BLOCK_BYTES // (lanes * 4)))
        elif use_fused:
            tq = _CHUNK_TQ
        else:
            score_bytes = 4 if dtype == torch.float32 else 2
            tq = min(_CHUNK_TQ,
                     max(128, _CHUNK_SCORE_BYTES // (l * cap * score_bytes)))
            tq = 1 << (max(128, tq).bit_length() - 1)  # floor to pow2
        out_s, out_i, flags = [], [], []
        for start in range(0, b, tq):
            qt = queries[start:start + tq]
            qpt = q_prec[start:start + tq]
            if use_probe:
                s, i = _ivf_probe_scan_tile(
                    *self._blocks(), qt, qpt, charge, num_probe, k, k_scan,
                    tol_val, tol_mode, redundant,
                )
            elif use_fused:
                s, i, f = _ivf_chunked_scan_tile(
                    *self._blocks(), qt, qpt, charge, num_probe, k, k_scan,
                    tol_val, tol_mode, redundant,
                )
                flags.append(f)
            else:
                pool_g, list_chunk = chunked_scan_params(
                    l, cap, num_probe, k_scan, qt.shape[0])
                s, i, f = _ivf_search_chunked(
                    *self._blocks(), qt, qpt, charge, num_probe, k, k_scan,
                    pool_g, list_chunk, tol_val, tol_mode, redundant,
                )
                flags.append(f)
            out_s.append(s)
            out_i.append(i)
        out_s, out_i = torch.cat(out_s), torch.cat(out_i)
        if use_probe:
            self._last_chunked_flagged = 0
            return out_s, out_i
        rows = torch.nonzero(torch.cat(flags).cpu()).flatten()  # one download
        self._last_chunked_flagged = len(rows)
        if len(rows):
            logger.debug("IVF chunked-scan certificate flagged %d/%d "
                         "queries; per-query repair", len(rows), b)
            rows = rows.to(queries.device)
            r_s, r_i = _ivf_search_perquery(
                *self._blocks(), queries[rows], q_prec[rows], charge,
                num_probe, k, k_scan, tol_val, tol_mode, redundant,
            )
            out_s[rows] = r_s
            out_i[rows] = r_i.to(out_i.dtype)
        return out_s, out_i


@torch.no_grad()
def bruteforce_search(library_vectors, queries, k: int, block: int = 16384,
                      device=None) -> np.ndarray:
    """Exact max-inner-product top-k ((B, min(k, n)) int32 row ids; the
    JAX `bruteforce_search`, the oracle of recall measurements).

    f32 products of the queries with blocks of `block` library rows on
    `device` (None = the GPU), TF32 off; each block merges into the running
    top-k by the stable top-k, so equal scores keep the lower row id, as
    `lax.top_k` keeps them."""
    device = resolve_device(device)
    queries = torch.as_tensor(np.asarray(queries, np.float32), device=device)
    n = library_vectors.shape[0]
    k = min(k, n)
    b = queries.shape[0]
    top_scores = torch.full((b, k), float("-inf"), device=device)
    top_ids = torch.full((b, k), -1, dtype=torch.int32, device=device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for start in range(0, n, block):
            chunk = torch.as_tensor(
                np.asarray(library_vectors[start:start + block], np.float32),
                device=device)
            scores = queries @ chunk.T
            ids = torch.arange(start, start + chunk.shape[0],
                               dtype=torch.int32, device=device)
            top_scores, pos = stable_topk_desc(
                torch.cat([top_scores, scores], dim=1), k)
            top_ids = torch.cat([top_ids, ids[None, :].expand(b, -1)],
                                dim=1).gather(1, pos)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return top_ids.cpu().numpy()
