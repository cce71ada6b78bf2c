"""The collectives of the sharded search, as one process runs them.

The JAX package's `shard_map` bodies end in `all_gather` and `psum` over
the list axes.  Here the body is a Python loop over the mesh's
coordinates and each collective is a gather onto one device in a fixed
shard order: the merge's tie order and the sum's rounding depend on that
order, never on which device finished first.  Work queued on distinct
CUDA devices overlaps because launches are asynchronous; no threads.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Sequence

import torch


@contextlib.contextmanager
def on_device(device: torch.device) -> Iterator[None]:
    """Make `device` CUDA's current device for the block (kernels launched
    through ctypes run on the current device); a no-op on the CPU."""
    if device.type == "cuda":
        with torch.cuda.device(device):
            yield
    else:
        yield


def all_gather(parts: Sequence[torch.Tensor],
               device: torch.device) -> torch.Tensor:
    """(S, ...) stack of the shards' equal-shaped results on `device`, in
    the given (row-major shard) order."""
    return torch.stack([p.to(device) for p in parts])


def psum(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """Sum of the shards' results on `device`, added in the given shard
    order (callers copy the sum to the devices that need it)."""
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total
