"""Carry index and library state between NumPy (or the JAX package) and
the PyTorch package.

`ivf_index_from_numpy` takes the arrays of a JAX `IvfIndex` (each passed
through `np.asarray`), or the datasets of its ``.ivf.h5`` file with the
`store_fp` attribute, so both packages can search the very same index;
`to_numpy` is the inverse.  `store_from_numpy` takes the datasets and
attributes of a JAX ``.store.h5`` file.  Reading those files (h5py) is the
caller's business: this package never imports it.  bfloat16 arrays travel
as their raw 16-bit patterns: an ml_dtypes bfloat16 array is accepted as
is (read through a 16-bit integer view), and `to_numpy` returns bf16
storage as uint16 bits, which `arr.view(ml_dtypes.bfloat16)` turns back
into a bfloat16 array.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ann_solo_tpu_torch.device import DeviceLike, resolve_device
from ann_solo_tpu_torch.index.ivf import IvfIndex
from ann_solo_tpu_torch.io.store import (
    COLUMN_DTYPES,
    STRING_COLUMNS,
    SpectralLibraryStore,
)
from ann_solo_tpu_torch.search import LibraryBlock


def _tensor(arr, device: torch.device):
    # A writable copy: tensors must not alias (possibly read-only) caller
    # memory, which they would on the CPU.
    arr = np.array(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(
            device
        )
    return torch.from_numpy(arr).to(device)


def ivf_index_from_numpy(
    centroids, padded_vectors, padded_ids, padded_prec, padded_scales,
    num_probe: int, redundancy: int, device: DeviceLike,
    store_fp: Optional[str] = None,
) -> IvfIndex:
    """An `IvfIndex` on `device` from host arrays of the same layout,
    stamped with the fingerprint of the store content it was built from
    when one is given."""
    device = resolve_device(device)
    return IvfIndex(
        _tensor(centroids, device).to(torch.float32),
        _tensor(padded_vectors, device),
        _tensor(padded_ids, device).to(torch.int32),
        int(num_probe),
        _tensor(padded_prec, device).to(torch.float32),
        _tensor(padded_scales, device).to(torch.float32),
        redundancy=int(redundancy),
        store_fp=None if store_fp is None else str(store_fp),
    )


def to_numpy(index: IvfIndex) -> Dict[str, object]:
    """The index's arrays and settings on the host (bf16 as uint16 bits)."""
    vecs = index.padded_vectors.cpu()
    if vecs.dtype == torch.bfloat16:
        vecs_np = vecs.view(torch.int16).numpy().view(np.uint16)
    else:
        vecs_np = vecs.numpy()
    return {
        "centroids": index.centroids.cpu().numpy(),
        "padded_vectors": vecs_np,
        "padded_ids": index.padded_ids.cpu().numpy(),
        "padded_prec": index.padded_prec.cpu().numpy(),
        "padded_scales": index.padded_scales.cpu().numpy(),
        "num_probe": index.num_probe,
        "redundancy": index.redundancy,
        "store_fp": index.store_fp,
    }


def store_from_numpy(columns: Mapping[str, object],
                     meta: Mapping[str, object]) -> SpectralLibraryStore:
    """A `SpectralLibraryStore` from host columns under this package's
    column names (`identifiers`, `peptides`, `precursor_mz`, ...,
    `peak_*`, `proc_*`), each cast to the store's dtype, and the
    attributes `config_hash`, `source_filename`, `source_version` and
    `source_fingerprint` (the last two default to "null")."""
    out = {name: np.array(columns[name], dtype)
           for name, dtype in COLUMN_DTYPES.items()}
    for name in STRING_COLUMNS:
        strings = np.empty(len(columns[name]), object)
        strings[:] = [s.decode("utf-8") if isinstance(s, bytes) else str(s)
                      for s in columns[name]]
        out[name] = strings
    return SpectralLibraryStore(
        out, str(meta["config_hash"]), str(meta["source_filename"]),
        str(meta.get("source_version", "null")),
        str(meta.get("source_fingerprint", "null")),
    )


def library_from_numpy(mz, intensity, ann_charge, precursor_mz,
                       device: DeviceLike) -> LibraryBlock:
    """Library peak blocks on `device` (precursor m/z as float32, like
    `_ChargeLibrary.device_arrays`)."""
    device = resolve_device(device)
    return LibraryBlock(
        _tensor(np.asarray(mz, np.float32), device),
        _tensor(np.asarray(intensity, np.float32), device),
        _tensor(np.asarray(ann_charge, np.int32), device),
        _tensor(np.asarray(precursor_mz, np.float32), device),
    )
