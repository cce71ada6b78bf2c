"""Fused chunked IVF scan + selection (kernel B3): plain version, support
rules and the selection that follows the kernel.

The counterpart of `ann_solo_tpu/ops/ivf_scan_pallas.py`.  The library's
lists are cut into chunks of C lists (C * cap <= 2,048 slots).  For each
(query, chunk) the kernel scores every slot, bf16(q) . storage
accumulated in float32 times the slot scale; masks the slot unless its
list is in the query's cold probe set, its id is valid and it lies in the
precursor window; packs the score's 16-bit key and the inverted slot into
one int32 (``key16 << pos_bits | (cw - 1 - slot)``, distinct by
construction); keeps the top `M_RANKS` of each `SG`-slot supergroup and
writes one `LANES`-lane row: the chunk's top `CK` survivors descending,
each supergroup's `M_RANKS`-th value, then -1 pads.

`ivf_chunked_scan_select` finishes on those rows: the pigeonhole chunk
choice, a canonical top-k over the chosen rows, the exact scan of each
query's hot lists (kernel B2), the canonical merge and the two truncation
certificates.  Queries whose certificate fires are repaired by the caller
through the per-query oracle.

The CUDA kernel that replaces the TPU kernel is `csrc/ivf_chunked_scan.cu`
(wrapper `ops/ivf_scan_cuda.py`); `ivf_chunked_scan_rows_plain` is what it
is tested against and what CPU tensors run.  The kernel scores only the
(query, chunk) pairs of the probe set, walking `chunk_query_lists`, and
writes `unprobed_row` everywhere else.  `SG`, `M_RANKS`, `CK` and
`HOT_LISTS` keep the JAX package's values: they define the row format and
the certificates, so both packages give the same rows.
"""

from __future__ import annotations

import torch

from ann_solo_tpu_torch.ops.ivf_probe import window_mask
from ann_solo_tpu_torch.ops.ivf_probe_cuda import ivf_probe_scan

SG = 256  # supergroup width (slots) of the first selection level
M_RANKS = 24  # candidates kept per supergroup
CK = 96  # candidates kept per (query, chunk)
LANES = 128  # output lanes per (query, chunk)
HOT_LISTS = 8  # per-query lists scanned exactly outside the kernel
_NEG = -1  # packed sentinel below every real candidate
_KEY_NEG_INF = 127  # _key16(-inf); every finite score's key is above it
_U32 = 0xFFFFFFFF
# Bytes of the plain version's float32 score block per step.
_PLAIN_BLOCK_BYTES = 1 << 28


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


def canonical_topk(keys: torch.Tensor, k: int):
    """(keys, lanes) of the top-k of (T, n) integer keys in [-1, 2^31 - 2],
    larger key first and the lower lane first among equal keys (the tie
    order of `lax.top_k`).  Key and reversed lane pack into one int64, so
    every packed value is distinct and `topk` has one answer."""
    n = keys.shape[1]
    lane_rev = torch.arange(n - 1, -1, -1, device=keys.device)
    packed = ((keys.to(torch.int64) + 1) << 32) | lane_rev[None, :]
    top = torch.topk(packed, min(k, n), dim=1, sorted=True).values
    return (top >> 32) - 1, (n - 1) - (top & _U32)


def _pick_chunk_lists(l: int, cap: int) -> int:
    """Lists per chunk: C * cap <= 2048 slots, C divides L."""
    c = 1
    for cand in (16, 8, 4, 2):
        if l % cand == 0 and cand * cap <= 2048:
            c = cand
            break
    return c


def hot_list_count(p: int) -> int:
    """Hot (exactly scanned) lists per query for a probe count ``p``: a
    query's best coarse lists hold far more of its top-k than the kernel's
    per-supergroup and per-chunk budgets, so they are scanned exactly and
    only the cold tail goes through the kernel.  Small probe counts keep
    every list in the kernel."""
    return HOT_LISTS if p >= 2 * HOT_LISTS else 0


def chunked_pallas_supported(l: int, cap: int, d: int, num_probe: int,
                             k_scan: int, dtype: torch.dtype) -> bool:
    """Whether the fused chunked scan covers this operating point (the JAX
    package's rule, name kept); otherwise the plain chunked scan runs.
    float32 storage keeps exact float32 scores there."""
    if dtype == torch.float32:
        return False
    if cap % 128 or cap <= 0:
        return False
    c = _pick_chunk_lists(l, cap)
    cw = c * cap
    if cw % SG or cw > 4096:
        return False
    npc = cw // SG
    if CK + npc > LANES:
        return False
    p = min(num_probe, l)
    h = hot_list_count(p)
    n_chunks = l // c
    if (p - h) * CK + h * cap < k_scan:
        return False  # cannot surface k_scan candidates
    if (cw - 1).bit_length() + 16 > 31:
        return False  # packed key16 | pos must fit an int32
    return n_chunks >= 2


def chunk_layout(l: int, cap: int):
    """(C, cw, npc, n_chunks, pos_bits) of an (L, cap) list block; raises
    ValueError where the row format cannot hold it."""
    c = _pick_chunk_lists(l, cap)
    cw = c * cap
    npc = cw // SG
    pos_bits = (cw - 1).bit_length()
    if cw % SG or cw > 4096 or CK + npc > LANES or pos_bits + 16 > 31:
        raise ValueError(f"chunked scan: L = {l}, cap = {cap} gives a "
                         f"chunk of {cw} slots, outside the row format")
    return c, cw, npc, l // c, pos_bits


def unprobed_row(l: int, cap: int, device=None) -> torch.Tensor:
    """(LANES,) int32 row of a (query, chunk) that the query does not
    probe: every score is -inf (key `_KEY_NEG_INF`), so each supergroup
    keeps its lowest `M_RANKS` slots, the chunk the first `CK` of those,
    and the row depends on the layout alone.  Kernel B3 writes it for
    every pair outside the probe set without scanning."""
    _, cw, npc, _, pos_bits = chunk_layout(l, cap)
    neg = _KEY_NEG_INF << pos_bits
    row = torch.full((LANES,), _NEG, dtype=torch.int32, device=device)
    k_top = min(CK, npc * M_RANKS)
    lane = torch.arange(k_top, device=device)
    slot = (lane // M_RANKS) * SG + lane % M_RANKS
    row[:k_top] = (neg | (cw - 1 - slot)).to(torch.int32)
    g = torch.arange(npc, device=device)
    row[CK:CK + npc] = (neg | (cw - 1 - (g * SG + M_RANKS - 1))).to(
        torch.int32)
    return row


def chunk_query_lists(probed, c: int):
    """Each chunk's probing queries: ``(lists, counts)``, (n_chunks, B)
    and (n_chunks,) int32, where row j of ``lists`` starts with the
    ``counts[j]`` queries (ascending) that probe any of chunk j's ``c``
    lists in the (B, L) ``probed`` bitmap.  The rest of the row holds
    the other queries; kernel B3 reads only the first ``counts[j]``."""
    b, l = probed.shape
    hit = probed.view(b, l // c, c).amax(dim=2).T  # (n_chunks, B)
    lists = torch.sort(hit, dim=1, descending=True, stable=True).indices
    counts = (hit != 0).sum(dim=1, dtype=torch.int32)
    return lists.to(torch.int32).contiguous(), counts


@torch.no_grad()
def ivf_chunked_scan_rows_plain(
    padded_vectors,  # (L, cap, D) int8 | bfloat16
    padded_ids,  # (L, cap) int32, -1 = empty slot
    padded_prec,  # (L, cap) float32
    padded_scales,  # (L, cap) float32
    queries,  # (B, D) float32
    q_prec,  # (B,) float32
    charge: float,
    probed,  # (B, L) uint8: 1 where the list is in the query's cold set
    tol_val: float,
    tol_mode: str,
):
    """(B, n_chunks, LANES) int32 rows of `ivf_scan_pallas.py::_scan_kernel`.

    A matrix product per block of chunks (TF32 off; every bf16 x storage
    product is exact in float32), the mask, the packed keys, then `topk`
    per supergroup and per chunk (packed values are distinct, so `topk`
    has one answer).  Blocks of chunks bound the float32 score block to
    `_PLAIN_BLOCK_BYTES`."""
    l, cap, d = padded_vectors.shape
    b = queries.shape[0]
    dev = queries.device
    c, cw, npc, n_chunks, pos_bits = chunk_layout(l, cap)
    q = queries.to(torch.bfloat16).to(torch.float32)
    vectors = padded_vectors.reshape(l * cap, d)
    ids = padded_ids.reshape(l * cap)
    prec = padded_prec.reshape(l * cap)
    scales = padded_scales.reshape(l * cap)
    inv_pos = (cw - 1) - torch.arange(cw, dtype=torch.int32, device=dev)
    n_surv = npc * M_RANKS
    k_top = min(CK, n_surv)
    out = torch.full((b, n_chunks, LANES), _NEG, dtype=torch.int32,
                     device=dev)
    step = max(1, _PLAIN_BLOCK_BYTES // max(1, b * cw * 4))
    for j0 in range(0, n_chunks, step):
        nb = min(step, n_chunks - j0)
        rows = slice(j0 * cw, (j0 + nb) * cw)
        s = (q @ vectors[rows].to(torch.float32).T) * scales[rows]
        ok = (ids[rows] >= 0)[None, :] & probed[:, j0 * c:(j0 + nb) * c].to(
            torch.bool).repeat_interleave(cap, dim=1)
        if tol_val > 0:
            ok &= window_mask(q_prec[:, None], prec[rows][None, :], charge,
                              tol_val, tol_mode)
        key = _key16(torch.where(ok, s, float("-inf"))).to(torch.int32)
        del s, ok
        packed = (key << pos_bits) | inv_pos.repeat(nb)[None, :]
        del key
        top1 = torch.topk(packed.view(b, nb, npc, SG), M_RANKS, dim=-1,
                          sorted=True).values  # (B, nb, npc, M)
        del packed
        top2 = torch.topk(top1.reshape(b, nb, n_surv), k_top, dim=-1,
                          sorted=True).values
        out[:, j0:j0 + nb, :k_top] = top2
        out[:, j0:j0 + nb, CK:CK + npc] = top1[..., M_RANKS - 1]
    return out


def _hot_scan(padded_vectors, padded_ids, padded_prec, padded_scales,
              queries, q_prec, charge: float, hot_ids, k_hot: int,
              tol_val: float, tol_mode: str):
    """Exact canonical scan of each query's hot lists (the JAX `_hot_scan`).

    Kernel B2 scores the (B, H * cap) hot lanes (ids ascending, so lane
    order is global-position order); the canonical top-`k_hot` of their
    16-bit keys follows.  Returns (keys, flat positions), (B, k_hot)
    int64 each; under-filled lanes carry keys <= `_KEY_NEG_INF`."""
    cap = padded_vectors.shape[1]
    flat = ivf_probe_scan(
        padded_vectors, padded_ids, padded_prec, padded_scales, queries,
        q_prec, charge, hot_ids, tol_val, tol_mode,
    )
    keys, lane = canonical_topk(_key16(flat), k_hot)
    rank = lane // cap
    pos = hot_ids.to(torch.int64).gather(1, rank) * cap + (lane - rank * cap)
    return keys, pos


@torch.no_grad()
def ivf_chunked_scan_select(
    padded_vectors,  # (L, cap, D) int8/bfloat16
    padded_ids,  # (L, cap) int32; the JAX function takes ids >= 0 as int8
    padded_prec,  # (L, cap) float32
    padded_scales,  # (L, cap) float32
    queries,  # (B, D) float32, contiguous
    q_prec,  # (B,) float32, contiguous
    charge: float,
    probe_ids,  # (B, P) COLD probed list ids
    num_probe: int,  # cold probe count P
    k_scan: int,
    tol_val: float,
    tol_mode: str,
    hot_ids=None,  # (B, H) hot list ids, ascending, disjoint from the cold
    scan_rows=None,  # rows function; default the kernel's wrapper
):
    """Fused chunked scan + exact selection with the hot-list hybrid
    (`ivf_scan_pallas.py::ivf_chunked_scan_select`).

    Returns ``(scores, flat_pos, flags)``: (B, k_eff) float32 scores at
    bf16-key precision, (B, k_eff) int64 flat positions (list * cap +
    slot; lanes of -inf score carry arbitrary positions, computed as the
    JAX function computes them) and (B,) bool certificate flags.
    ``scan_rows`` replaces `ivf_scan_cuda.ivf_chunked_scan_rows`, so that
    a check can finish the plain version's rows the same way."""
    if scan_rows is None:
        from ann_solo_tpu_torch.ops.ivf_scan_cuda import (
            ivf_chunked_scan_rows as scan_rows,
        )
    l, cap, _ = padded_vectors.shape
    b = queries.shape[0]
    dev = queries.device
    c, cw, npc, n_chunks, pos_bits = chunk_layout(l, cap)
    p_sel = min(num_probe, l, n_chunks)
    pos_mask = (1 << pos_bits) - 1

    probed = torch.zeros((b, l), dtype=torch.uint8, device=dev)
    probed.scatter_(1, probe_ids.to(torch.int64), 1)
    out3 = scan_rows(
        padded_vectors, padded_ids, padded_prec, padded_scales, queries,
        q_prec, charge, probed, tol_val, tol_mode,
    )
    # Pigeonhole chunk choice: a query's <= P cold lists lie in <= P
    # chunks, so the top-P chunks by their best candidate (lane 0) hold
    # every finite candidate.  Ascending chunk ids make the gathered lanes
    # chunk-major, so a stable top-k over the bare keys is the canonical
    # (key desc, global position asc) order.
    _, chunk_sel = canonical_topk(out3[:, :, 0], p_sel)
    chunk_sel = torch.sort(chunk_sel, dim=1).values  # (B, P)
    blk = out3.gather(
        1, chunk_sel[:, :, None].expand(b, p_sel, LANES)
    ).to(torch.int64)  # (B, P, LANES)
    del out3
    cands = blk[:, :, :CK].reshape(b, p_sel * CK)
    cand_keys = torch.where(cands > _NEG, cands >> pos_bits, _NEG)
    k_cold = min(k_scan, p_sel * CK)
    key_c, p_idx = canonical_topk(cand_keys, k_cold)
    run_packed = cands.gather(1, p_idx)
    pos_in = (cw - 1) - (run_packed & pos_mask)
    chunk_id = chunk_sel.gather(1, p_idx // CK)
    pos_c = chunk_id * cw + pos_in

    if hot_ids is not None:
        # Canonical merge of the exact hot top-k and the cold top-k: hot
        # and cold positions are disjoint, so the merged prefix is the
        # canonical top-k_eff over the whole probe set.  (key + 1, 2^31 -
        # 1 - pos) pack into one int64 (positions of sentinel lanes may
        # be negative but stay above -2^15).
        k_hot = min(k_scan, hot_ids.shape[1] * cap)
        key_h, pos_h = _hot_scan(
            padded_vectors, padded_ids, padded_prec, padded_scales, queries,
            q_prec, charge, hot_ids, k_hot, tol_val, tol_mode,
        )
        k_eff = min(k_scan, k_cold + k_hot)
        keys = torch.cat([key_c, key_h], dim=1)
        pos = torch.cat([pos_c, pos_h], dim=1)
        packed = ((keys + 1) << 32) | ((2 ** 31 - 1) - pos)
        top = torch.topk(packed, k_eff, dim=1, sorted=True).values
        key_o = (top >> 32) - 1
        flat_pos = (2 ** 31 - 1) - (top & _U32)
    else:
        key_o, flat_pos = key_c, pos_c
    scores = torch.where(key_o > _KEY_NEG_INF, _key16_to_f32(key_o),
                         float("-inf"))

    # Truncation certificates at (key, position) granularity against the
    # merged boundary: a candidate can be lost only at a chunk's CK cut or
    # a supergroup's M cut, and the first victim of a cut sits after its
    # last survivor, so a cut reaches into the kept set only when that
    # survivor sits strictly before the boundary.
    kb = key_o[:, -1:]
    pb = flat_pos[:, -1:]

    def crosses(last, base):
        key = torch.where(last > _NEG, last >> pos_bits, _NEG)
        pos = base * cw + ((cw - 1) - (last & pos_mask))
        return ((last > _NEG) & (key > _KEY_NEG_INF)
                & ((key > kb[..., None]) | ((key == kb[..., None])
                                            & (pos < pb[..., None]))))

    flags = crosses(blk[:, :, CK - 1:CK], chunk_sel[:, :, None]).any(2).any(1)
    flags |= crosses(blk[:, :, CK:CK + npc],
                     chunk_sel[:, :, None]).any(2).any(1)
    return scores, flat_pos, flags
