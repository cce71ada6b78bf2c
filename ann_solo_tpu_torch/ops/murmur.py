"""MurmurHash3 (x86, 32-bit) bin -> bucket table, in NumPy.

The port's own copy of `ann_solo_tpu/ops/murmur.py`'s bulk hash (the
JAX package stays the reference; `tests/test_torch_imports.py` holds the
two tables equal).  The reference (ann_solo/spectrum.py:147-163) hashes
the *string* of each mass bin index with ``mmh3.hash(str(bin_idx), 42,
signed=False) % hash_len``; `hash_bin_table` precomputes that for every
bin once on the host.
"""

from __future__ import annotations

import functools

import numpy as np

_C1 = 0xCC9E2D51
_C2 = 0x1B873593


def _rotl32(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def murmur3_32_bulk(keys: np.ndarray, seed: int = 0) -> np.ndarray:
    """Vectorized MurmurHash3_x86_32 over many byte-string keys.

    Parameters
    ----------
    keys : np.ndarray
        Object array (or list) of `bytes` keys.
    seed : int
        Hash seed.

    Returns
    -------
    np.ndarray
        uint32 hashes, same length as `keys`.
    """
    keys = np.asarray(keys, object)
    out = np.zeros(len(keys), np.uint32)
    lengths = np.asarray([len(k) for k in keys], np.int64)
    # Group keys by length so each group is a dense (n, length) byte matrix.
    for length in np.unique(lengths):
        idx = np.nonzero(lengths == length)[0]
        buf = np.zeros((len(idx), int(length)), np.uint8)
        for row, i in enumerate(idx):
            buf[row] = np.frombuffer(keys[i], np.uint8)
        out[idx] = _murmur3_32_fixed_len(buf, seed)
    return out


def _murmur3_32_fixed_len(buf: np.ndarray, seed: int) -> np.ndarray:
    """Hash an (n, length) uint8 matrix of equal-length keys."""
    n, length = buf.shape
    c1 = np.uint32(_C1)
    c2 = np.uint32(_C2)
    h = np.full(n, seed, np.uint32)
    nblocks = length // 4
    with np.errstate(over="ignore"):
        for i in range(nblocks):
            block = buf[:, 4 * i : 4 * i + 4].astype(np.uint32)
            k = (
                block[:, 0]
                | (block[:, 1] << np.uint32(8))
                | (block[:, 2] << np.uint32(16))
                | (block[:, 3] << np.uint32(24))
            )
            k = k * c1
            k = _rotl32(k, 15)
            k = k * c2
            h ^= k
            h = _rotl32(h, 13)
            h = h * np.uint32(5) + np.uint32(0xE6546B64)
        tail = buf[:, nblocks * 4 :].astype(np.uint32)
        ntail = length - nblocks * 4
        if ntail > 0:
            k = np.zeros(n, np.uint32)
            if ntail >= 3:
                k ^= tail[:, 2] << np.uint32(16)
            if ntail >= 2:
                k ^= tail[:, 1] << np.uint32(8)
            k ^= tail[:, 0]
            k = k * c1
            k = _rotl32(k, 15)
            k = k * c2
            h ^= k
        h ^= np.uint32(length)
        h ^= h >> np.uint32(16)
        h = h * np.uint32(0x85EBCA6B)
        h ^= h >> np.uint32(13)
        h = h * np.uint32(0xC2B2AE35)
        h ^= h >> np.uint32(16)
    return h


@functools.lru_cache(maxsize=None)
def hash_bin_table(n_bins: int, hash_len: int, seed: int = 42) -> np.ndarray:
    """Precompute the bin-index -> hashed-bucket lookup table.

    Reproduces ``mmh3.hash(str(bin_idx), 42, signed=False) % hash_len``
    (reference ann_solo/spectrum.py:163) for all bin indices in
    ``[0, n_bins)``.

    Returns an int32 array of shape (n_bins,) mapping each mass bin to its
    hashed vector index.
    """
    keys = np.asarray([str(i).encode("ascii") for i in range(n_bins)], object)
    hashes = murmur3_32_bulk(keys, seed)
    return (hashes % np.uint32(hash_len)).astype(np.int32)
