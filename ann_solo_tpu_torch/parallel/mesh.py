"""Device meshes for the library-sharded search (the port of
`ann_solo_tpu/parallel/mesh.py`).

A mesh is a grid of torch devices with named axes: ``('dp', 'lib')``, or
``('dcn', 'dp', 'lib')`` for a multi-slice layout.  Library lists shard
over the list axes (``'lib'``, and ``'dcn'`` where present) and query
batches over ``'dp'``.  One process drives every device of the mesh, as
the JAX package's single controller does and as FAISS's ``IndexShards``
drives several GPUs: a collective is a loop over the mesh's coordinates
(`parallel/collectives.py`).

A device may appear more than once: ``[torch.device("cpu")] * 8`` is an
8-shard mesh for the tests, ``[torch.device("cuda", 0)] * 4`` a 4-shard
mesh on one card (NCCL refuses two ranks on one GPU; one process has no
such limit).  The default devices are every CUDA device; without CUDA a
mesh is refused, never made of CPU devices in their place.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ann_solo_tpu_torch.device import require_cuda


def _normalize(device) -> torch.device:
    """`device` as a torch.device with its CUDA index filled in, so equal
    devices compare (and hash) equal."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """An array of torch devices in the mesh's shape, with axis names
    (the subset of `jax.sharding.Mesh` the port uses)."""

    def __init__(self, devices: Sequence[torch.device], shape: Tuple[int, ...],
                 axis_names: Tuple[str, ...]):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} does not match axes "
                             f"{axis_names}")
        flat = np.empty(len(devices), dtype=object)
        for i, device in enumerate(devices):
            flat[i] = _normalize(device)
        self.devices = flat.reshape(shape)
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis sizes by name, as `jax.sharding.Mesh.shape`."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {list(self.devices.ravel())})"


def _device_list(devices) -> List[torch.device]:
    """The caller's devices, or every CUDA device (raises without one)."""
    if devices is not None:
        return [_normalize(d) for d in devices]
    require_cuda()
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Tuple[str, str] = ("dp", "lib"),
    dp_size: Optional[int] = None,
    devices=None,
) -> Mesh:
    """A (dp, lib) mesh over the first `n_devices` devices.

    `dp` carries data-parallel query batches, `lib` library shards.  By
    default dp is the largest power of two that keeps lib >= dp, so large
    libraries get the most shards.  `devices` defaults to every CUDA
    device and may repeat a device."""
    devices = _device_list(devices)
    if n_devices is None:
        n_devices = len(devices)
    if len(devices) < n_devices:
        raise ValueError(
            f"Requested {n_devices} devices but only {len(devices)} are "
            "available"
        )
    devices = devices[:n_devices]
    if dp_size is None:
        dp_size = 1
        while (
            dp_size * 2 <= n_devices
            and n_devices % (dp_size * 2) == 0
            and (n_devices // (dp_size * 2)) >= dp_size * 2
        ):
            dp_size *= 2
    if n_devices % dp_size != 0:
        raise ValueError(
            f"dp_size={dp_size} does not divide n_devices={n_devices}"
        )
    return Mesh(devices, (dp_size, n_devices // dp_size), axis_names)


def make_multislice_mesh(
    n_slices: int,
    devices_per_slice: Optional[int] = None,
    dp_size: int = 1,
    devices=None,
) -> Mesh:
    """A ('dcn', 'dp', 'lib') mesh: `n_slices` slices of
    `devices_per_slice` devices, taken slice-major from `devices` (every
    CUDA device by default).  Lists shard over ('dcn', 'lib'), so the
    per-shard top-k merge crosses the slice boundary once per query."""
    devices = _device_list(devices)
    if devices_per_slice is None:
        devices_per_slice = max(1, len(devices) // n_slices)
    n = n_slices * devices_per_slice
    if len(devices) < n:
        raise ValueError(
            f"need {n} devices for {n_slices} x {devices_per_slice}, "
            f"have {len(devices)}"
        )
    if devices_per_slice % dp_size != 0:
        raise ValueError("dp_size must divide devices_per_slice")
    return Mesh(devices[:n],
                (n_slices, dp_size, devices_per_slice // dp_size),
                ("dcn", "dp", "lib"))


def pad_to_multiple(
    array: np.ndarray, multiple: int, axis: int = 0, fill=0
) -> np.ndarray:
    """Pad `axis` up to a multiple (shard-evenly helper)."""
    size = array.shape[axis]
    target = -(-size // multiple) * multiple
    if target == size:
        return array
    pad_widths = [(0, 0)] * array.ndim
    pad_widths[axis] = (0, target - size)
    return np.pad(array, pad_widths, constant_values=fill)


def list_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The axes lists shard over: ('dcn', 'lib') on multi-slice meshes,
    ('lib',) otherwise."""
    return tuple(a for a in ("dcn", "lib") if a in mesh.axis_names)


def n_list_shards(mesh: Mesh) -> int:
    n = 1
    for a in list_axes(mesh):
        n *= mesh.shape[a]
    return n


def replica_devices(mesh: Mesh) -> List[List[torch.device]]:
    """``[dp][shard]``: each dp replica's devices in list-shard order, the
    shard index flattened row-major over the list axes (list shard i holds
    the i-th contiguous range of lists)."""
    names = mesh.axis_names
    la = list_axes(mesh)
    out = [[None] * n_list_shards(mesh) for _ in range(mesh.shape["dp"])]
    for idx in np.ndindex(mesh.devices.shape):
        shard = 0
        for a in la:
            shard = shard * mesh.shape[a] + idx[names.index(a)]
        out[idx[names.index("dp")]][shard] = mesh.devices[idx]
    return out
