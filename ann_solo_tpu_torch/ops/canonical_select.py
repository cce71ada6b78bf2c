"""The probe path's selection: canonical top-k, ids and dedup (kernel B5's
plain version and its routing).

After the probe-gather scan (kernel B2) writes each query's (P * cap)
masked scores in (probe rank, slot) lane order, the selection takes the
canonical top-k on 16-bit keys (key descending, lane ascending), maps each
lane to its library id and, with redundant storage or more lanes selected
than asked, keeps each id's first lane (`dedup_topk`), then pads to k
(`pad_topk`).  This is the XLA tail of the JAX package's
`_ivf_probe_scan_tile` (`ann_solo_tpu/index/ivf.py:1282-1291`; its
`_canonical_topk`, `_dedup_topk` and `_pad_topk`), which reaches no
Pallas kernel.

`canonical_select` routes by the tensors' device, never by a fallback:
CPU tensors take `canonical_select_plain`, CUDA tensors launch kernel B5
(`ops/select_cuda.py`, source `csrc/canonical_select.cu`) or raise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ann_solo_tpu_torch.ops import select_cuda
from ann_solo_tpu_torch.ops.ivf_scan import _key16, _key16_to_f32, canonical_topk


def dedup_topk(scores, ids, k: int):
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


def pad_topk(scores, ids, k: int):
    """Right-pad (B, K') top-k outputs to width k with -inf / -1."""
    k_eff = scores.shape[1]
    if k_eff >= k:
        return scores[:, :k], ids[:, :k]
    pad = (0, k - k_eff)
    return (
        F.pad(scores, pad, value=float("-inf")),
        F.pad(ids, pad, value=-1),
    )


@torch.no_grad()
def canonical_select_plain(flat, probe_ids, padded_ids, k_sel: int, k: int,
                           redundant: bool):
    """((B, k) float32 scores, (B, k) int32 ids) of the canonical
    selection over (B, P * cap) masked scores `flat`.

    The top min(k_sel, n) lanes by (16-bit key desc, lane asc), scores
    decoded from their keys; lane j's id is padded_ids[probe_ids[b, j //
    cap], j % cap], -1 where the decoded score is not above -inf or the
    probe id lies outside [0, L) (the scan writes -inf there); with
    `redundant` or more lanes than k, each id's first lane (ids of -1
    dropped); padded with -inf / -1."""
    l, cap = padded_ids.shape
    k_eff = min(k_sel, flat.shape[1])
    top, pos = canonical_topk(_key16(flat), k_eff)
    top_s = _key16_to_f32(top)
    rank = pos // cap
    lists = probe_ids.gather(1, rank)
    listed = (lists >= 0) & (lists < l)
    top_i = padded_ids[lists.clamp(0, l - 1), pos - rank * cap]
    top_i = torch.where((top_s > float("-inf")) & listed, top_i, -1)
    if redundant or k_eff > k:
        top_s, top_i = dedup_topk(top_s, top_i, k)
    return pad_topk(top_s, top_i, k)


def canonical_select(flat, probe_ids, padded_ids, k_sel: int, k: int,
                     redundant: bool):
    """The selection routed by the tensors' device: CUDA tensors launch
    kernel B5 or raise, CPU tensors take `canonical_select_plain`."""
    if flat.device.type == "cuda":
        return select_cuda.canonical_select(flat, probe_ids, padded_ids,
                                            k_sel, k, redundant)
    if flat.device.type != "cpu":
        raise ValueError(f"canonical select: unsupported device "
                         f"{flat.device}")
    return canonical_select_plain(flat, probe_ids, padded_ids, k_sel, k,
                                  redundant)
