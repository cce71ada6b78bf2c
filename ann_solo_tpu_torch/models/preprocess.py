"""Batched spectrum preprocessing in PyTorch.

Port of `ann_solo_tpu/models/preprocess.py` (reference
ann_solo/spectrum.py:57-119 `process_spectrum`): m/z range restriction,
optional resolution rounding with duplicate merging, precursor-peak
removal, noise floor + top-N filtering, rank or sqrt scaling, L2
normalization and compaction, as masked ops over a padded (B, P) block
with the same validity gates after every destructive step.
`PreprocessParams` is re-declared because its JAX module imports jax.

Sorts are stable (ties keep lane order, as the JAX argsorts do), the
resolution merge sums runs in lane order without float atomics, and
divisions by constants multiply by the float32 reciprocal, as the compiled
JAX reference does.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ann_solo_tpu_torch.io.masses import NEUTRON, PROTON


class PreprocessParams(NamedTuple):
    """Static preprocessing hyperparameters (the JAX package's fields)."""

    min_peaks: int = 10
    min_mz_range: float = 250.0
    min_mz: float = 11.0
    max_mz: float = 2010.0
    resolution: Optional[int] = None
    remove_precursor: bool = False
    remove_precursor_tolerance: float = 0.0
    min_intensity: float = 0.01
    max_peaks_used: int = 50
    scaling: Optional[str] = "rank"
    max_removal_charge: int = 16

    @classmethod
    def from_config(cls, config, is_library: bool) -> "PreprocessParams":
        return cls(
            min_peaks=config.min_peaks,
            min_mz_range=float(config.min_mz_range),
            min_mz=float(config.min_mz),
            max_mz=float(config.max_mz),
            resolution=config.resolution,
            remove_precursor=bool(config.remove_precursor),
            remove_precursor_tolerance=float(
                config.remove_precursor_tolerance
            ),
            min_intensity=float(config.min_intensity),
            max_peaks_used=(
                config.max_peaks_used_library
                if is_library
                else config.max_peaks_used
            ),
            scaling=config.scaling,
        )


@dataclasses.dataclass
class ProcessedBatch:
    """Preprocessed spectra: compacted, scaled, normalized peak blocks."""

    mz: torch.Tensor  # (B, K) float32, ascending per row, 0-padded
    intensity: torch.Tensor  # (B, K) float32, L2-normalized, 0-padded
    ann_charge: torch.Tensor  # (B, K) int32
    n_peaks: torch.Tensor  # (B,) int32
    precursor_mz: torch.Tensor  # (B,) float32
    precursor_charge: torch.Tensor  # (B,) int32
    is_valid: torch.Tensor  # (B,) bool


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _recip(c: np.float32) -> float:
    """float32 reciprocal of a constant divisor.  XLA compiles the JAX
    reference's ``x / constant`` to ``x * (1 / constant)``; multiplying by
    the same reciprocal keeps the outputs bit-identical to it."""
    return float(np.float32(1.0) / np.float32(c))


def _check_valid(valid, mz, min_peaks, min_mz_range):
    """Quality gate (reference spectrum.py:14-36)."""
    count = valid.sum(1)
    mn = torch.where(valid, mz, float("inf")).amin(1)
    mx = torch.where(valid, mz, float("-inf")).amax(1)
    return (count >= min_peaks) & ((mx - mn) >= min_mz_range)


def _peak_rank_desc(intensity, valid):
    """0-based rank of each peak by descending intensity (stable ties)."""
    key = torch.where(valid, intensity, float("-inf"))
    order = torch.sort(-key, dim=1, stable=True).indices
    # The inverse permutation: rank[order[r]] = r.
    return torch.argsort(order, dim=1).to(torch.int32)


def _merge_runs(int_s, val_s, same):
    """Per-lane sum of the run that starts at the lane (lane order).

    Lanes are m/z sorted, so each run of equal rounded m/z is contiguous;
    lane l accumulates lanes l, l+1, ... while they stay in its run,
    summing 0 + a_l + a_{l+1} + ... in the order the JAX segment sum
    adds them.  Only each run's first lane is kept by the caller."""
    b, p = int_s.shape
    lane = torch.arange(p, device=int_s.device)[None, :]
    run_start = torch.where(~same, lane, 0).cummax(1).values
    max_len = int((lane - run_start + 1).max()) if p else 0
    vals = torch.where(val_s, int_s, 0.0)
    acc = torch.zeros_like(vals)
    in_run = torch.ones_like(same)
    for d in range(max_len):
        shifted = torch.nn.functional.pad(vals[:, d:], (0, d))
        if d:
            step = torch.nn.functional.pad(same[:, d:], (0, d))
            in_run = in_run & step
        acc = acc + torch.where(in_run, shifted, 0.0)
    return acc


@torch.no_grad()
def preprocess_batch(
    params: PreprocessParams,
    mz: torch.Tensor,  # (B, P) float32, m/z sorted per row, padded
    intensity: torch.Tensor,  # (B, P)
    ann_charge: torch.Tensor,  # (B, P) int
    n_peaks: torch.Tensor,  # (B,)
    precursor_mz: torch.Tensor,  # (B,)
    precursor_charge: torch.Tensor,  # (B,)
) -> ProcessedBatch:
    """Run the full preprocessing pipeline on a padded batch, in the step
    order and with the validity gates of the reference."""
    b, p = mz.shape
    dev = mz.device
    f32 = torch.float32
    mz = mz.to(f32)
    intensity = intensity.to(f32)
    ann_charge = ann_charge.to(torch.int32)
    precursor_mz = precursor_mz.to(dev)
    precursor_charge = precursor_charge.to(dev)
    lane = torch.arange(p, device=dev)[None, :]
    valid = lane < n_peaks.to(dev)[:, None]

    # 1) Restrict the m/z range (inclusive bounds).
    valid &= (mz >= params.min_mz) & (mz <= params.max_mz)
    is_valid = _check_valid(valid, mz, params.min_peaks, params.min_mz_range)

    # 2) Optional resolution rounding with intensity summing.
    if params.resolution is not None:
        scale = np.float32(10.0 ** params.resolution)
        mz = torch.round(mz * _f32(scale, mz)) * _f32(_recip(scale), mz)
        key = torch.where(valid, mz, float("inf"))
        order = torch.sort(key, dim=1, stable=True).indices
        mz_s = mz.gather(1, order)
        int_s = intensity.gather(1, order)
        ann_s = ann_charge.gather(1, order)
        val_s = valid.gather(1, order)
        same = torch.cat(
            [torch.zeros((b, 1), dtype=torch.bool, device=dev),
             (mz_s[:, 1:] == mz_s[:, :-1]) & val_s[:, 1:] & val_s[:, :-1]],
            dim=1,
        )
        keep = val_s & ~same
        merged = _merge_runs(int_s, val_s, same)
        mz, intensity, ann_charge = (
            mz_s, torch.where(keep, merged, 0.0), ann_s
        )
        valid = keep
        is_valid &= _check_valid(
            valid, mz, params.min_peaks, params.min_mz_range
        )

    # 3) Remove peaks around the precursor m/z (isotopes 0..2 at every
    #    reduced charge 1..precursor_charge).
    if params.remove_precursor:
        prec_charge = precursor_charge.clamp_min(1).to(f32)
        neutral = (precursor_mz.to(f32) - _f32(PROTON, mz)) * prec_charge
        near = torch.zeros_like(valid)
        for c in range(1, params.max_removal_charge + 1):
            active = (_f32(float(c), mz) <= prec_charge)[:, None]
            for iso in range(3):
                target = (
                    (neutral + _f32(iso * NEUTRON, mz))
                    * _f32(_recip(np.float32(c)), mz)
                    + _f32(PROTON, mz)
                )[:, None]
                near |= active & (
                    (mz - target).abs() <= params.remove_precursor_tolerance
                )
        valid &= ~near
        is_valid &= _check_valid(
            valid, mz, params.min_peaks, params.min_mz_range
        )

    # 4) Intensity filtering: relative noise floor + top-N peaks.
    max_int = torch.where(valid, intensity, float("-inf")).amax(1)
    valid &= intensity > params.min_intensity * max_int[:, None]
    rank = _peak_rank_desc(intensity, valid)
    valid &= rank < params.max_peaks_used
    is_valid &= _check_valid(valid, mz, params.min_peaks, params.min_mz_range)

    # 5) Intensity scaling.
    if params.scaling in ("sqrt", "root"):
        intensity = torch.sqrt(intensity.clamp_min(0.0))
    elif params.scaling == "rank":
        rank = _peak_rank_desc(intensity, valid)
        intensity = (params.max_peaks_used - rank).to(f32)
    elif params.scaling is not None:
        raise ValueError(f"Unknown scaling: {params.scaling}")

    # 6) L2 normalization over the remaining peaks.
    intensity = torch.where(valid, intensity, 0.0)
    norm = torch.sqrt((intensity * intensity).sum(1, keepdim=True))
    intensity = intensity / norm.clamp_min(1e-30)

    # 7) Compact: surviving peaks to the front, sorted by m/z.
    k = params.max_peaks_used
    key = torch.where(valid, mz, float("inf"))
    order = torch.sort(key, dim=1, stable=True).indices[:, :k]
    out_valid = valid.gather(1, order)
    out_mz = torch.where(out_valid, mz.gather(1, order), 0.0)
    out_int = torch.where(out_valid, intensity.gather(1, order), 0.0)
    out_ann = torch.where(out_valid, ann_charge.gather(1, order), 0)
    out_n = valid.sum(1).to(torch.int32)
    return ProcessedBatch(
        mz=out_mz,
        intensity=out_int,
        ann_charge=out_ann.to(torch.int32),
        n_peaks=out_n.clamp_max(k),
        precursor_mz=precursor_mz.to(f32),
        precursor_charge=precursor_charge.to(torch.int32),
        is_valid=is_valid,
    )
