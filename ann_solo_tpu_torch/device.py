"""Device selection: CUDA unless a caller asks for the CPU by name."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def require_cuda() -> torch.device:
    """The first CUDA device; raises when PyTorch sees no GPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "ann_solo_tpu_torch needs a CUDA GPU (torch.cuda.is_available() "
            "is False); pass device='cpu' (the CLI's --no_gpu) to run the "
            "plain PyTorch versions on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device: DeviceLike) -> torch.device:
    """`device` as a torch.device; None means the GPU (see `require_cuda`).

    The CPU is used only when a caller names it explicitly.
    """
    if device is None:
        return require_cuda()
    device = torch.device(device)
    if device.type == "cuda":
        require_cuda()
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


def synchronize(device: Optional[torch.device]) -> None:
    """Wait for queued work on `device` (a no-op on the CPU)."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
