"""IVF (inverted file) index in PyTorch: build and search.

Port of `ann_solo_tpu/index/ivf.py` up to the big-library probe path:

* **Build** (`IvfIndex.build`): spherical k-means on a FAISS-style
  subsample, top-A centroid choices, the sort-based balanced fill of
  capped lists (`plan_assignments`, optional SOAR-ranked second copy),
  and the gather into one dense (L, cap, D) block; int8 storage is SQ8
  (per-row scale max|v| / 127, round half to even).
* **Search** (`IvfIndex.search_device`), every regime ranking by the same
  canonical order (16-bit bf16 key desc, global position asc; exact f32
  scores for f32 storage) and deduplicating redundant copies:
  - full scan (`_ivf_search_fullscan`): a 128-query tile's probed-list
    union covers the library and the (T, L, cap) f32 score block fits
    512 MB; every list is scanned and the probe set is a selection mask;
  - probe path (`IvfIndex._search_chunked`, `_ivf_probe_scan_tile`):
    bigger libraries with int8/bf16 storage, covering or not; each query
    scans only its own probed lists through kernel B2
    (`ops/ivf_probe_cuda.py`) in super-tiles of up to 1,024 queries;
  - per-query oracle (`_ivf_search_perquery`): f32 storage beyond the
    full scan, and the reference the probe path is tested against.
  The JAX package's voting-budget regime is not ported (the probe path
  gives the same results); int8/bf16 shapes beyond B2's lane bound, which
  the JAX package sends to its fused chunked kernel, raise until kernel
  B3 is ported.

Placement and selection are bit-for-bit those of the JAX package given the
same inputs: stable sorts wherever the JAX code relies on `lax.top_k` or a
stable argsort, and no float atomics.
"""

from __future__ import annotations

import logging
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ann_solo_tpu_torch.device import resolve_device
from ann_solo_tpu_torch.ops.ivf_probe import probe_scan_supported
from ann_solo_tpu_torch.ops.ivf_probe import window_mask as _window_mask
from ann_solo_tpu_torch.ops.ivf_probe_cuda import ivf_probe_scan
from ann_solo_tpu_torch.ops.kmeans import (
    assign_topk_blocked,
    soar_round2_choices,
    spherical_kmeans,
)
from ann_solo_tpu_torch.ops.topk import stable_topk_desc

logger = logging.getLogger(__name__)

_TILE_Q = 128  # queries per search tile
_FULLSCAN_TRANSIENT = 1 << 29  # bytes of the (T, L, cap) f32 score block
_CHUNK_TQ = 1024  # queries per probe-path super-tile
_PROBE_BLOCK_BYTES = 1 << 29  # bytes of a super-tile's (tq, P*cap) f32 block
_PERQUERY_GATHER_BYTES = 1 << 30  # bytes of an oracle group's gathered rows
_FILL_SLACK = 1.5  # list capacity = slack * mean list size
_N_CHOICES = 4  # spill candidates per vector (nearest centroids)
_TRAIN_POINTS_PER_CENTROID = 256  # FAISS subsampling rule
_KEY16_NINF = 0x7F  # _key16(-inf): below every finite score's key
_U32 = 0xFFFFFFFF


# --------------------------------------------------------------------- #
# Build


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
            used_np = used.cpu().numpy().copy()
            order = np.argsort(used_np)
            free_slots = []
            for list_id in order:
                free_slots.extend(
                    (list_id, pos) for pos in range(used_np[list_id], cap)
                )
                if len(free_slots) >= len(unplaced):
                    break
            if len(free_slots) < len(unplaced):
                raise RuntimeError("IVF capacity exhausted; raise _FILL_SLACK")
            for row, (list_id, pos) in zip(unplaced, free_slots):
                placed_list[row] = list_id
                placed_pos[row] = pos
                used_np[list_id] += 1
            used = torch.as_tensor(used_np, device=dev)
            logger.debug("IVF spill fallback placed %d vectors", len(unplaced))
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


@torch.no_grad()
def _pack_lists(vectors, flat_slot, row_ids, num_list: int, cap: int,
                storage_dtype: torch.dtype):
    """Scatter row ids into slots, then gather rows into (L, cap, D).

    Returns (ids_flat (L*cap,) int32, packed (L, cap, D), scales (L, cap)
    float32; all ones for float storage).  int8 storage quantizes per row:
    scale = max|v| / 127, q = round(v / scale) (half to even)."""
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
    # XLA compiles the reference's ``max|v| / 127.0`` to a multiply by the
    # float32 reciprocal; the same multiply keeps the scales bit-identical.
    inv127 = torch.tensor(
        np.float32(1.0) / np.float32(127.0), dtype=torch.float32, device=dev
    )
    chunk = min(total, 1 << 20)
    for start in range(0, total, chunk):
        ids_chunk = ids_flat[start:start + chunk].to(torch.int64)
        safe = ids_chunk.clamp(0, n - 1)
        gathered = torch.where(
            (ids_chunk >= 0)[:, None], vectors[safe].to(torch.float32), 0.0
        )
        if storage_dtype == torch.int8:
            scale = gathered.abs().amax(1) * inv127
            q = torch.round(gathered / scale.clamp_min(1e-30)[:, None])
            packed[start:start + chunk] = q.to(torch.int8)
            scales[start:start + chunk] = scale
        else:
            packed[start:start + chunk] = gathered.to(storage_dtype)
    return (
        ids_flat,
        packed.view(num_list, cap, d),
        scales.view(num_list, cap),
    )


def _pack_prec(prec, ids_flat, num_list: int, cap: int):
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


def _key16(s: torch.Tensor) -> torch.Tensor:
    """Monotone 16-bit sort key of f32 scores (int64 values in [0, 65535]).

    Key equality is bf16 round-to-nearest-even equality.  Computed on the
    uint32 bit pattern in int64 (`ivf_scan_pallas.py::_key16` works on
    int32 with logical shifts; torch's shifts on int32 are arithmetic).
    """
    u = s.contiguous().view(torch.int32).to(torch.int64) & _U32
    rne = (u + 0x7FFF + ((u >> 16) & 1)) & _U32
    b16 = rne >> 16
    return torch.where(u >= 0x80000000, 0xFFFF - b16, b16 | 0x8000)


def _key16_to_f32(k16: torch.Tensor) -> torch.Tensor:
    """Inverse of `_key16`: the bf16-rounded score value as float32."""
    b16 = torch.where(k16 < 0x8000, 0xFFFF - k16, k16 - 0x8000)
    bits = b16.to(torch.int64) << 16
    bits = torch.where(bits >= 0x80000000, bits - (1 << 32), bits)
    return bits.to(torch.int32).view(torch.float32)


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
    """Canonical top-k (key desc, position asc) over (T, n) 16-bit keys.

    Key and reversed position pack into one int64, so the canonical order
    is plain numeric order and every packed value is distinct: `topk` of
    distinct values has one answer, whatever its tie rule."""
    n = keys.shape[1]
    pos_rev = torch.arange(n - 1, -1, -1, device=keys.device)
    packed = (keys << 32) | pos_rev[None, :]
    top = torch.topk(packed, min(k_sel, n), dim=1, sorted=True).values
    pos = (n - 1) - (top & _U32)
    return _key16_to_f32(top >> 32), pos


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


class IvfIndex:
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
    ):
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
        num_list = resolve_num_list(int(config.num_list), n)
        if redundancy is None:
            try:
                redundancy = int(config.ivf_redundancy)
            except (KeyError, AttributeError):
                redundancy = 2
        soar_lambda = resolve_soar_lambda(config)
        r_eff, cap, n_choices = ivf_build_params(
            n, num_list, redundancy, soar_lambda
        )
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
        if precursor_mz is not None:
            prec = torch.as_tensor(precursor_mz).to(device=device,
                                                    dtype=torch.float32)
            padded_prec = _pack_prec(prec, ids_flat, num_list, cap)
        else:
            padded_prec = torch.zeros((num_list, cap), device=device)
        return cls(
            centroids, padded_vectors, ids_flat.view(num_list, cap),
            int(config.num_probe), padded_prec, padded_scales,
            redundancy=r_eff,
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
        probe path (kernel B2) where `probe_scan_supported` holds; else,
        for f32 storage, the per-query oracle.  Other int8/bf16 shapes
        raise NotImplementedError (kernel B3 is not ported)."""
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
        l, cap, _ = self.padded_vectors.shape
        dtype = self.padded_vectors.dtype
        args = (float(charge), num_probe, k, self.redundancy * k,
                float(tol_val), tol_mode, self.redundancy > 1)
        union_covers = l <= num_probe * _TILE_Q
        if union_covers and l * cap * 4 * _TILE_Q <= _FULLSCAN_TRANSIENT:
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
        if probe_scan_supported(l, cap, num_probe, dtype):
            scores, ids = self._search_chunked(queries, q_prec, *args)
        elif dtype == torch.float32:
            scores, ids = _ivf_search_perquery(*self._blocks(), queries,
                                               q_prec, *args)
        else:
            p = min(num_probe, l)
            raise NotImplementedError(
                f"{p} probes x cap {cap} = {p * cap} lanes per query exceed "
                "the probe path's bound; the JAX package scans such "
                f"{dtype} indexes with kernel B3 (ROADMAP B3), which is not "
                "ported yet"
            )
        return ids.to(torch.int32), scores

    def _blocks(self):
        return (self.padded_vectors, self.padded_ids, self.padded_prec,
                self.padded_scales, self.centroids)

    def _search_chunked(self, queries, q_prec, charge: float,
                        num_probe: int, k: int, k_scan: int, tol_val: float,
                        tol_mode: str, redundant: bool):
        """Big-library search through the probe path (JAX
        `_search_chunked` with the probe-gather kernel): super-tiles of
        up to `_CHUNK_TQ` queries, fewer where the (tq, P * cap) f32
        score block would pass `_PROBE_BLOCK_BYTES`.  Exact by
        construction: no certificates, no repair."""
        l, cap, _ = self.padded_vectors.shape
        lanes = min(num_probe, l) * cap
        tq = min(_CHUNK_TQ, max(1, _PROBE_BLOCK_BYTES // (lanes * 4)))
        out_s, out_i = [], []
        for start in range(0, queries.shape[0], tq):
            s, i = _ivf_probe_scan_tile(
                *self._blocks(), queries[start:start + tq],
                q_prec[start:start + tq], charge, num_probe, k, k_scan,
                tol_val, tol_mode, redundant,
            )
            out_s.append(s)
            out_i.append(i)
        return torch.cat(out_s), torch.cat(out_i)
