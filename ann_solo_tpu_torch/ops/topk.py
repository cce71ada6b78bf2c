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
