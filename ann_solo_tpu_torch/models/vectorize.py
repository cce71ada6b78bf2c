"""Feature-hashed spectrum vectorization in PyTorch.

Port of `ann_solo_tpu/models/vectorize.py` (reference
ann_solo/spectrum.py:122-214).  The bin -> bucket table comes from the
port's copy of the MurmurHash3 table (`ops/murmur.py`); the float64-exact
bin-edge thresholds are the same NumPy computation as the JAX package's,
copied too.  Peaks accumulate into their buckets one peak column
at a time in lane order, as the JAX version does: no scatter-add, whose
CUDA atomics would sum in a run-dependent order and change last ulps that
int8 quantization and the 16-bit scan keys can expose.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ann_solo_tpu_torch.ops.murmur import hash_bin_table


@functools.lru_cache(maxsize=None)
def get_dim(
    min_mz: float, max_mz: float, bin_size: float
) -> Tuple[int, float, float]:
    """Number of mass bins and the true (start, end) mass-range boundaries
    (bit-identical to the reference `get_dim`, spectrum.py:122-143)."""
    min_mz, max_mz = float(min_mz), float(max_mz)
    start_dim = min_mz - min_mz % bin_size
    end_dim = max_mz + bin_size - max_mz % bin_size
    return round((end_dim - start_dim) / bin_size), start_dim, end_dim


class VectorizeTables(NamedTuple):
    """bucket (n_bins,) int: mass bin -> hashed bucket; thresholds
    (n_bins + 1,) float32: thresholds[i] is the smallest float32 m/z whose
    reference float64 bin index ``floor((m - start) // bin_size)`` is >= i.
    NumPy arrays from `VectorizeParams.tables()`, tensors from
    `device_tables`."""

    bucket: object
    thresholds: object


class VectorizeParams(NamedTuple):
    """Static vectorization hyperparameters."""

    min_mz: float = 11.0
    max_mz: float = 2010.0
    bin_size: float = 0.04
    hash_len: int = 800

    @classmethod
    def from_config(cls, config) -> "VectorizeParams":
        return cls(
            min_mz=float(config.min_mz),
            max_mz=float(config.max_mz),
            bin_size=float(config.bin_size),
            hash_len=int(config.hash_len),
        )

    @property
    def n_bins(self) -> int:
        return get_dim(self.min_mz, self.max_mz, self.bin_size)[0]

    @property
    def min_bound(self) -> float:
        return get_dim(self.min_mz, self.max_mz, self.bin_size)[1]

    def bin_to_hash(self) -> np.ndarray:
        """(n_bins,) int32 table: mass bin -> hashed bucket."""
        return hash_bin_table(self.n_bins, self.hash_len, seed=42)

    def tables(self) -> VectorizeTables:
        """Bucket table + exact float64 bin-edge tables (host, cached)."""
        return _tables_cached(self)


@functools.lru_cache(maxsize=None)
def _tables_cached(params: VectorizeParams) -> VectorizeTables:
    n_bins, start, _ = get_dim(
        params.min_mz, params.max_mz, params.bin_size
    )
    bs = float(params.bin_size)
    idx = np.arange(n_bins + 1, dtype=np.float64)
    approx = (start + idx * bs).astype(np.float32)
    # The f32 transition point of the reference's f64 floor-div lies
    # within a couple of f32 ulps of the approximate edge; probe the f32
    # neighbourhood and take the smallest candidate reaching bin i.
    cands = [approx]
    lo_c, hi_c = approx, approx
    for _ in range(3):
        lo_c = np.nextafter(lo_c, np.float32(-np.inf), dtype=np.float32)
        hi_c = np.nextafter(hi_c, np.float32(np.inf), dtype=np.float32)
        cands.extend([lo_c, hi_c])
    cands = np.stack(cands, axis=1)  # (n_bins + 1, 7) float32
    ref_bin = np.floor((cands.astype(np.float64) - start) // bs)
    reaches = ref_bin >= idx[:, None]
    if not reaches.any(axis=1).all():
        raise RuntimeError("f32 edge probe window too narrow")
    thresholds = np.where(reaches, cands, np.float32(np.inf)).min(
        axis=1
    ).astype(np.float32)
    return VectorizeTables(params.bin_to_hash(), thresholds)


@functools.lru_cache(maxsize=None)
def _device_tables_cached(params: VectorizeParams, device: str):
    host = _tables_cached(params)
    return VectorizeTables(
        torch.as_tensor(host.bucket.astype(np.int64), device=device),
        torch.as_tensor(host.thresholds, device=device),
    )


def device_tables(params: VectorizeParams, device) -> VectorizeTables:
    """`params.tables()` as tensors on `device` (uploaded once)."""
    return _device_tables_cached(params, str(torch.device(device)))


@torch.no_grad()
def vectorize_batch(
    params: VectorizeParams,
    tables: VectorizeTables,  # from `device_tables`, on the input's device
    mz: torch.Tensor,  # (B, K) float32, padded
    intensity: torch.Tensor,  # (B, K) float32, 0 on padded lanes
    n_peaks: torch.Tensor,  # (B,) valid peak counts
    norm: bool = True,
) -> torch.Tensor:
    """(B, hash_len) float32 hashed (unit-norm when `norm`) vectors."""
    b, k = mz.shape
    dev = mz.device
    f32 = torch.float32
    n_bins = params.n_bins
    lane = torch.arange(k, device=dev)[None, :]
    valid = lane < n_peaks.to(dev)[:, None]
    mz = mz.to(f32)
    intensity = intensity.to(f32)
    # f32 estimate of the reference's float64 bin index, corrected against
    # the exact edges.  Clamped in float before the integer conversion
    # (the JAX version clamps the same range after it).
    raw = torch.floor(
        (mz - torch.tensor(params.min_bound, dtype=f32, device=dev))
        / torch.tensor(params.bin_size, dtype=f32, device=dev)
    )
    base = raw.clamp(-1, n_bins).to(torch.int64)
    thresholds = tables.thresholds
    below = mz < thresholds[base.clamp(0, n_bins)]
    above = mz >= thresholds[(base + 1).clamp(0, n_bins)]
    bin_idx = base - below.to(torch.int64) + above.to(torch.int64)
    in_range = valid & (bin_idx >= 0) & (bin_idx < n_bins)
    bucket = tables.bucket[bin_idx.clamp(0, n_bins - 1)]
    weight = torch.where(in_range, intensity, 0.0)
    buckets_iota = torch.arange(params.hash_len, device=dev)[None, :]
    vectors = torch.zeros((b, params.hash_len), dtype=f32, device=dev)
    for peak in range(k):
        onehot = bucket[:, peak:peak + 1] == buckets_iota  # (B, H)
        vectors = vectors + torch.where(
            onehot, weight[:, peak:peak + 1], 0.0
        )
    if norm:
        norms = torch.sqrt((vectors * vectors).sum(1, keepdim=True))
        vectors = vectors / norms.clamp_min(1e-30)
    return vectors

