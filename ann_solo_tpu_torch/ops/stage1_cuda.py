"""The rescore stage-1 CUDA kernel (B4): wrapper and launch count.

Replaces `ann_solo_tpu/ops/rescore.py::_stage1_bounds`, XLA code of the
reference (no Pallas kernel): the certificate's upper bound on the greedy
score of every (query, candidate) pair of a (B, C) candidate matrix.  The
kernel source is `ann_solo_tpu_torch/csrc/stage1_bounds.cu`, its plain
PyTorch version `ops/rescore.py::stage1_bounds_plain`.

On the H100 the function is bound by float operations: Kq * Kc compares
a pair for each shift.  The kernel takes the whole matrix in one launch,
one block per query row and `THREADS` candidate slots, one thread a
candidate, with the candidates' peaks staged in shared memory and the
query peaks in registers, `i_tile(kq)` of them at a time.  Nothing but
one float a pair reaches device memory, and invalid slots (-1) read no
peaks.  The sum over query peaks runs in the order the plain version
states, so the two agree bit for bit.

Routing is decided by the tensors, never by a fallback: `_stage1_bounds`
sends CPU tensors to the plain version and CUDA tensors here, where the
kernel launches or the call raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ann_solo_tpu_torch.ops import _build

# The kernel's work split, as in `csrc/stage1_bounds.cu`: candidate slots
# a block, candidate peaks staged in shared memory at once, and the query
# peak tiles a thread may hold.
THREADS = 64
MAX_CHUNK = 64
I_TILES = (16, 10, 8)

# Kernel launches in this process; reset by whoever wants to count.
LAUNCHES = 0


def i_tile(kq: int) -> int:
    """Query peaks a thread holds at once: the tile of `I_TILES` that
    wastes the fewest lanes on the ragged last tile (ties to the larger)."""
    return min(I_TILES, key=lambda t: (-(-kq // t) * t, -t))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = _build.load("stage1_bounds")
    lib.stage1_bounds.restype = ctypes.c_int
    lib.stage1_bounds.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.stage1_bounds_error_string.restype = ctypes.c_char_p
    lib.stage1_bounds_error_string.argtypes = [ctypes.c_int]
    return lib


def _check(q_mz, q_int, q_prec, lib_mz, lib_int, lib_ann, lib_prec,
           cand_ids):
    tensors = (q_mz, q_int, q_prec, lib_mz, lib_int, lib_ann, lib_prec,
               cand_ids)
    device = q_mz.device
    if device.type != "cuda":
        raise ValueError(f"stage1_bounds: the kernel takes CUDA tensors, "
                         f"not {device}")
    if any(t.device != device for t in tensors):
        raise ValueError("stage1_bounds: tensors on different devices")
    for name, t, dtype, dim in (
        ("q_mz", q_mz, torch.float32, 2), ("q_int", q_int, torch.float32, 2),
        ("q_prec", q_prec, torch.float32, 1),
        ("lib_mz", lib_mz, torch.float32, 2),
        ("lib_int", lib_int, torch.float32, 2),
        ("lib_ann", lib_ann, torch.int32, 2),
        ("lib_prec", lib_prec, torch.float32, 1),
        ("cand_ids", cand_ids, torch.int64, 2),
    ):
        if t.dtype != dtype:
            raise TypeError(f"stage1_bounds: {name} must be {dtype}")
        if t.dim() != dim:
            raise ValueError(f"stage1_bounds: {name} must have {dim} dims")
        if not t.is_contiguous():
            raise ValueError(f"stage1_bounds: {name} must be contiguous")
    b = cand_ids.shape[0]
    if q_mz.shape != q_int.shape or q_mz.shape[0] != b \
            or q_prec.shape != (b,):
        raise ValueError("stage1_bounds: query arrays must be (B, Kq), "
                         "(B, Kq), (B,) with B the candidate rows")
    n = lib_mz.shape[0]
    if lib_int.shape != lib_mz.shape or lib_ann.shape != lib_mz.shape \
            or lib_prec.shape != (n,) or n < 1:
        raise ValueError("stage1_bounds: library arrays must be (N, Kc) "
                         "x 3 and (N,), N >= 1")


@torch.no_grad()
def stage1_bounds(q_mz, q_int, q_prec, lib_mz, lib_int, lib_ann, lib_prec,
                  cand_ids, fragment_mz_tolerance: float, num_shifts: int,
                  allow_shift: bool):
    """(B, C) float32 upper bounds of the greedy scores (-inf where
    `cand_ids` is negative), computed by kernel B4 in one launch.  Every
    tensor on one CUDA device, contiguous; query and library peak widths
    may differ."""
    global LAUNCHES
    _check(q_mz, q_int, q_prec, lib_mz, lib_int, lib_ann, lib_prec,
           cand_ids)
    b, c = cand_ids.shape
    out = torch.empty((b, c), dtype=torch.float32, device=q_mz.device)
    if b == 0 or c == 0:
        return out
    lib = _library()
    kq, kc = q_mz.shape[1], lib_mz.shape[1]
    stream = torch.cuda.current_stream(q_mz.device).cuda_stream
    err = lib.stage1_bounds(
        q_mz.data_ptr(), q_int.data_ptr(), q_prec.data_ptr(),
        lib_mz.data_ptr(), lib_int.data_ptr(), lib_ann.data_ptr(),
        lib_prec.data_ptr(), cand_ids.data_ptr(), out.data_ptr(),
        b, c, kq, kc, lib_mz.shape[0], float(fragment_mz_tolerance),
        int(num_shifts), int(bool(allow_shift)), i_tile(kq), stream,
    )
    if err != 0:
        msg = lib.stage1_bounds_error_string(err).decode()
        raise RuntimeError(f"stage1_bounds launch failed: {msg} ({err})")
    LAUNCHES += 1
    return out
