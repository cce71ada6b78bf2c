"""The probe-gather IVF scan CUDA kernel (B2): wrapper and launch count.

Replaces the TPU kernel `ann_solo_tpu/ops/ivf_probe_pallas.py::
_probe_scan_kernel` (entry `ivf_probe_scan`).  The kernel source is
`ann_solo_tpu_torch/csrc/ivf_probe_scan.cu`, its plain PyTorch version
`ops/ivf_probe.py::ivf_probe_scan_plain`.

On the H100 the scan is bound by device-memory bytes: the probed lists'
rows read once, and the (B, P * cap) float32 score block written.  The
kernel is list-major: the wrapper inverts the probe table into each
list's entries (`ops/ivf_probe.py::list_probe_entries`) and counts each
list's work items (passes of up to 32 entries times tiles of 256 slots)
on the device, with no host synchronisation; one pass over a list's rows
scores all its entries on the tensor cores.

Routing is decided by the tensors, never by a fallback: CPU tensors take
the plain version, CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ann_solo_tpu_torch.ops import _build
from ann_solo_tpu_torch.ops.ivf_probe import (
    ivf_probe_scan_plain,
    list_probe_entries,
)

_STORAGE_CODE = {torch.int8: 0, torch.bfloat16: 1}

# Kernel launches in this process; reset by whoever wants to count.
LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = _build.load("ivf_probe_scan")
    lib.ivf_probe_scan.restype = ctypes.c_int
    lib.ivf_probe_scan.argtypes = (
        [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 10
        + [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + [ctypes.c_int]
        + [ctypes.c_void_p]
    )
    lib.ivf_probe_scan_error_string.restype = ctypes.c_char_p
    lib.ivf_probe_scan_error_string.argtypes = [ctypes.c_int]
    for name in ("entries_per_pass", "slots_per_item"):
        fn = getattr(lib, f"ivf_probe_scan_{name}")
        fn.restype, fn.argtypes = ctypes.c_int, []
    lib.ivf_probe_scan_padded_dim.restype = ctypes.c_int
    lib.ivf_probe_scan_padded_dim.argtypes = [ctypes.c_int]
    lib.ivf_probe_scan_smem_bytes.restype = ctypes.c_longlong
    lib.ivf_probe_scan_smem_bytes.argtypes = [ctypes.c_int]
    lib.ivf_probe_scan_resident_blocks.restype = ctypes.c_int
    lib.ivf_probe_scan_resident_blocks.argtypes = [ctypes.c_int]
    return lib


def _check(vectors, ids, prec, scales, queries, q_prec, probe_ids,
           tol_mode: str):
    tensors = (vectors, ids, prec, scales, queries, q_prec, probe_ids)
    device = vectors.device
    if any(t.device != device for t in tensors):
        raise ValueError("ivf_probe_scan: tensors on different devices")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"ivf_probe_scan: unsupported device {device}")
    if vectors.dtype not in _STORAGE_CODE:
        raise TypeError("ivf_probe_scan: storage must be int8 or bfloat16")
    for name, t, dtypes in (
        ("padded_ids", ids, (torch.int32,)),
        ("padded_prec", prec, (torch.float32,)),
        ("padded_scales", scales, (torch.float32,)),
        ("queries", queries, (torch.float32,)),
        ("q_prec", q_prec, (torch.float32,)),
        ("probe_ids", probe_ids, (torch.int32, torch.int64)),
    ):
        if t.dtype not in dtypes:
            raise TypeError(f"ivf_probe_scan: {name} must be {dtypes}")
    for name, t in (("padded_vectors", vectors), ("padded_ids", ids),
                    ("padded_prec", prec), ("padded_scales", scales),
                    ("queries", queries), ("q_prec", q_prec),
                    ("probe_ids", probe_ids)):
        if not t.is_contiguous():
            raise ValueError(f"ivf_probe_scan: {name} must be contiguous")
    if vectors.dim() != 3:
        raise ValueError("ivf_probe_scan: padded_vectors must be (L, cap, D)")
    l, cap, d = vectors.shape
    for t in (ids, prec, scales):
        if t.shape != (l, cap):
            raise ValueError("ivf_probe_scan: list arrays must be (L, cap)")
    if queries.dim() != 2 or queries.shape[1] != d:
        raise ValueError("ivf_probe_scan: queries must be (B, D)")
    b = queries.shape[0]
    if q_prec.shape != (b,):
        raise ValueError("ivf_probe_scan: q_prec must be (B,)")
    if probe_ids.dim() != 2 or probe_ids.shape[0] != b:
        raise ValueError("ivf_probe_scan: probe_ids must be (B, P)")
    if tol_mode not in ("Da", "ppm"):
        raise ValueError(f"ivf_probe_scan: unknown tol_mode {tol_mode!r}")


@torch.no_grad()
def _launch(vectors, ids, prec, scales, queries, q_prec, charge: float,
            probe_ids, tol_val: float, tol_mode: str):
    global LAUNCHES
    l, cap, d = vectors.shape
    b, p = probe_ids.shape
    if b * p >= 1 << 31:
        raise ValueError("ivf_probe_scan: B * P must be < 2^31")
    lib = _library()
    entries, starts, counts = list_probe_entries(probe_ids, l)
    # Work items: passes of up to `per_pass` entries a list, times the
    # slot tiles of a list; list L holds the entries of invalid ids.
    per_pass = lib.ivf_probe_scan_entries_per_pass()
    n_tiles = -(-cap // lib.ivf_probe_scan_slots_per_item())
    ends = torch.cumsum((counts + per_pass - 1) // per_pass * n_tiles, 0,
                        dtype=torch.int32)
    q_bf16 = torch.empty((b, lib.ivf_probe_scan_padded_dim(d)),
                         dtype=torch.bfloat16, device=vectors.device)
    out = torch.empty((b, p * cap), dtype=torch.float32, device=vectors.device)
    stream = torch.cuda.current_stream(vectors.device).cuda_stream
    err = lib.ivf_probe_scan(
        vectors.data_ptr(), _STORAGE_CODE[vectors.dtype], ids.data_ptr(),
        prec.data_ptr(), scales.data_ptr(), queries.data_ptr(),
        q_prec.data_ptr(), entries.data_ptr(), starts.data_ptr(),
        ends.data_ptr(), q_bf16.data_ptr(), out.data_ptr(),
        l, cap, d, b, p, float(charge), float(tol_val),
        int(tol_mode == "ppm"), stream,
    )
    if err != 0:
        msg = lib.ivf_probe_scan_error_string(err).decode()
        raise RuntimeError(f"ivf_probe_scan launch failed: {msg} ({err})")
    LAUNCHES += 1
    return out


def ivf_probe_scan(
    padded_vectors, padded_ids, padded_prec, padded_scales, queries, q_prec,
    charge: float, probe_ids, tol_val: float, tol_mode: str,
):
    """(B, P * cap) float32 masked scores of every probed slot, the
    `ivf_probe_pallas.py::ivf_probe_scan` contract (see
    `ivf_probe_scan_plain`); every slot of a probe id outside [0, L) is
    -inf."""
    _check(padded_vectors, padded_ids, padded_prec, padded_scales, queries,
           q_prec, probe_ids, tol_mode)
    if padded_vectors.device.type == "cpu":
        return ivf_probe_scan_plain(
            padded_vectors, padded_ids, padded_prec, padded_scales, queries,
            q_prec, charge, probe_ids, tol_val, tol_mode,
        )
    return _launch(
        padded_vectors, padded_ids, padded_prec, padded_scales, queries,
        q_prec, charge, probe_ids, tol_val, tol_mode,
    )
