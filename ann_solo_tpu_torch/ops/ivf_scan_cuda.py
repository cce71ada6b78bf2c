"""The fused chunked IVF scan CUDA kernel (B3): wrapper and launch count.

Replaces the TPU kernel `ann_solo_tpu/ops/ivf_scan_pallas.py::_scan_kernel`
(entry `ivf_chunked_scan_select`).  The kernel source is
`ann_solo_tpu_torch/csrc/ivf_chunked_scan.cu`, its plain PyTorch version
`ops/ivf_scan.py::ivf_chunked_scan_rows_plain`; the selection that
follows the rows is `ops/ivf_scan.py::ivf_chunked_scan_select`.

On the H100 the function is bound by memory: the list rows read once
and the (B, n_chunks, 128) int32 rows written.  The kernel scores only
the (query, chunk) pairs of the probe set, on the tensor cores, walking
each chunk's list of probing queries (`ops/ivf_scan.py::
chunk_query_lists`, built here in PyTorch); every other row is the
layout's constant row (`ops/ivf_scan.py::unprobed_row`), which a fill
kernel of the same source writes first.  Scores never leave shared
memory.

Routing is decided by the tensors, never by a fallback: CPU tensors take
the plain version, CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ann_solo_tpu_torch.ops import _build
from ann_solo_tpu_torch.ops.ivf_scan import (
    LANES,
    chunk_layout,
    chunk_query_lists,
    ivf_chunked_scan_rows_plain,
)

_STORAGE_CODE = {torch.int8: 0, torch.bfloat16: 1}

# Kernel launches in this process; reset by whoever wants to count.
LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = _build.load("ivf_chunked_scan")
    lib.ivf_chunked_scan.restype = ctypes.c_int
    lib.ivf_chunked_scan.argtypes = (
        [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 11
        + [ctypes.c_int] * 6 + [ctypes.c_float] * 2 + [ctypes.c_int]
        + [ctypes.c_void_p]
    )
    lib.ivf_chunked_scan_error_string.restype = ctypes.c_char_p
    lib.ivf_chunked_scan_error_string.argtypes = [ctypes.c_int]
    lib.ivf_chunked_scan_padded_dim.restype = ctypes.c_int
    lib.ivf_chunked_scan_padded_dim.argtypes = [ctypes.c_int]
    lib.ivf_chunked_scan_queries_per_pass.restype = ctypes.c_int
    lib.ivf_chunked_scan_queries_per_pass.argtypes = []
    lib.ivf_chunked_scan_smem_bytes.restype = ctypes.c_longlong
    lib.ivf_chunked_scan_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.ivf_chunked_scan_resident_blocks.restype = ctypes.c_int
    lib.ivf_chunked_scan_resident_blocks.argtypes = [ctypes.c_int] * 3
    return lib


def _check(vectors, ids, prec, scales, queries, q_prec, probed,
           tol_mode: str):
    tensors = (vectors, ids, prec, scales, queries, q_prec, probed)
    device = vectors.device
    if any(t.device != device for t in tensors):
        raise ValueError("ivf_chunked_scan: tensors on different devices")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"ivf_chunked_scan: unsupported device {device}")
    if vectors.dtype not in _STORAGE_CODE:
        raise TypeError("ivf_chunked_scan: storage must be int8 or bfloat16")
    for name, t, dtype in (
        ("padded_ids", ids, torch.int32),
        ("padded_prec", prec, torch.float32),
        ("padded_scales", scales, torch.float32),
        ("queries", queries, torch.float32),
        ("q_prec", q_prec, torch.float32),
        ("probed", probed, torch.uint8),
    ):
        if t.dtype != dtype:
            raise TypeError(f"ivf_chunked_scan: {name} must be {dtype}")
    for name, t in (("padded_vectors", vectors), ("padded_ids", ids),
                    ("padded_prec", prec), ("padded_scales", scales),
                    ("queries", queries), ("q_prec", q_prec),
                    ("probed", probed)):
        if not t.is_contiguous():
            raise ValueError(f"ivf_chunked_scan: {name} must be contiguous")
    if vectors.dim() != 3:
        raise ValueError("ivf_chunked_scan: padded_vectors must be (L, cap, D)")
    l, cap, d = vectors.shape
    for t in (ids, prec, scales):
        if t.shape != (l, cap):
            raise ValueError("ivf_chunked_scan: list arrays must be (L, cap)")
    if queries.dim() != 2 or queries.shape[1] != d:
        raise ValueError("ivf_chunked_scan: queries must be (B, D)")
    b = queries.shape[0]
    if q_prec.shape != (b,):
        raise ValueError("ivf_chunked_scan: q_prec must be (B,)")
    if probed.shape != (b, l):
        raise ValueError("ivf_chunked_scan: probed must be (B, L)")
    if tol_mode not in ("Da", "ppm"):
        raise ValueError(f"ivf_chunked_scan: unknown tol_mode {tol_mode!r}")
    chunk_layout(l, cap)


@torch.no_grad()
def _launch(vectors, ids, prec, scales, queries, q_prec, charge: float,
            probed, tol_val: float, tol_mode: str):
    global LAUNCHES
    l, cap, d = vectors.shape
    b = queries.shape[0]
    c, _, _, n_chunks, pos_bits = chunk_layout(l, cap)
    lib = _library()
    lists, counts = chunk_query_lists(probed, c)
    # Work items: passes of up to `per_pass` probing queries a chunk.
    per_pass = lib.ivf_chunked_scan_queries_per_pass()
    ends = torch.cumsum((counts + per_pass - 1) // per_pass, 0,
                        dtype=torch.int32)
    q_bf16 = torch.empty((b, lib.ivf_chunked_scan_padded_dim(d)),
                         dtype=torch.bfloat16, device=vectors.device)
    out = torch.empty((b, n_chunks, LANES), dtype=torch.int32,
                      device=vectors.device)
    stream = torch.cuda.current_stream(vectors.device).cuda_stream
    err = lib.ivf_chunked_scan(
        vectors.data_ptr(), _STORAGE_CODE[vectors.dtype], ids.data_ptr(),
        prec.data_ptr(), scales.data_ptr(), queries.data_ptr(),
        q_prec.data_ptr(), probed.data_ptr(), lists.data_ptr(),
        counts.data_ptr(), ends.data_ptr(), q_bf16.data_ptr(),
        out.data_ptr(),
        l, cap, c, d, b, pos_bits, float(charge), float(tol_val),
        int(tol_mode == "ppm"), stream,
    )
    if err != 0:
        msg = lib.ivf_chunked_scan_error_string(err).decode()
        raise RuntimeError(f"ivf_chunked_scan launch failed: {msg} ({err})")
    LAUNCHES += 1
    return out


def ivf_chunked_scan_rows(
    padded_vectors, padded_ids, padded_prec, padded_scales, queries, q_prec,
    charge: float, probed, tol_val: float, tol_mode: str,
):
    """(B, n_chunks, 128) int32 rows of the fused chunked scan (see
    `ivf_chunked_scan_rows_plain`); ``probed`` is the (B, L) uint8 bitmap
    of each query's cold probe set."""
    _check(padded_vectors, padded_ids, padded_prec, padded_scales, queries,
           q_prec, probed, tol_mode)
    if padded_vectors.device.type == "cpu":
        return ivf_chunked_scan_rows_plain(
            padded_vectors, padded_ids, padded_prec, padded_scales, queries,
            q_prec, charge, probed, tol_val, tol_mode,
        )
    return _launch(
        padded_vectors, padded_ids, padded_prec, padded_scales, queries,
        q_prec, charge, probed, tol_val, tol_mode,
    )
