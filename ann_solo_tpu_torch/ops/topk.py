"""Top-k with `jax.lax.top_k`'s tie order, for the ports of its callers."""

from __future__ import annotations

import torch


def stable_topk_desc(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of each row, equal
    values in ascending index order, as `lax.top_k` orders them.
    `torch.topk` promises no order among equal values, so this sorts.
    The results are copies: a view would keep the whole sorted row alive
    (callers collect many blocks' results)."""
    values, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return values[:, :k].contiguous(), idx[:, :k].contiguous()


def topk_desc_nan_last(x: torch.Tensor, k: int):
    """`stable_topk_desc` for float32 rows that may hold NaN, in
    `lax.top_k`'s IEEE total order (-inf < ... < -0.0 < +0.0 < ... <
    +inf, equal keys in ascending index order) with every NaN last,
    whatever its sign.  `lax.top_k` ranks a NaN by its sign bit, which
    the device sets: inf * 0 is -NaN on the CPU (ranked last there) and
    +NaN on a CUDA card, so the rank is fixed here instead.  On rows
    without NaN or -0.0 it equals `stable_topk_desc`."""
    bits = x.contiguous().view(torch.int32)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)  # ascending as the order
    key = torch.where(torch.isnan(x), torch.iinfo(torch.int32).min, key)
    idx = torch.sort(key, dim=1, descending=True, stable=True).indices
    idx = idx[:, :k].contiguous()
    return x.gather(1, idx), idx
