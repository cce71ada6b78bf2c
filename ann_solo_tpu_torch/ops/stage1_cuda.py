"""The rescore stage-1 CUDA kernel (B4): wrapper, launch count and the
plain helpers that mirror its work split.

Replaces `ann_solo_tpu/ops/rescore.py::_stage1_bounds`, XLA code of the
reference (no Pallas kernel): the certificate's upper bound on the greedy
score of every (query, candidate) pair of a (B, C) candidate matrix.  The
kernel source is `ann_solo_tpu_torch/csrc/stage1_bounds.cu`, its plain
PyTorch version `ops/rescore.py::stage1_bounds_plain`.

The first port compared all Kq x Kc peak pairs for each window and
already issued at about a third of the card's FP32 rate, so the work had
to shrink.  The kernel searches instead:

* the branch rule (`ascending_rows`): a row whose intensities are
  finite and whose peaks of positive intensity are a prefix of it, with
  finite, non-decreasing m/z, takes the range search over that prefix;
  any other row the dense loop over all its peaks, as a per-thread branch
  of the same kernel.  Leaving out a peak of finite intensity <= 0 is
  exact: it never raises a maximum that starts at +0.  Every max
  propagates NaN, as the plain version's do, so a NaN window value that
  passes its test (a NaN intensity, or 0 * +-inf) makes the bound NaN.
  The rows the main path builds (`preprocess_batch`, the store, the
  bench's library) all take the range search;
* the range search: for query peak i and window w (direct, or shift s
  when |prec_diff| >= tol) the passing peaks of an ascending row are one
  contiguous range, because fl(q - c) does not increase as c grows and
  fl(y - off) does not decrease as y grows.  The range's first peak is
  found with the plain version's own f32 expression: a branchless binary
  search over the row padded with +inf to `padded_width(Kc)` (at most
  `MAX_PADDED`), or, while a thread's query peaks ascend, three steps
  from the previous peak's edge over the next `REACH` peaks.  A walk
  takes the max while that test passes; the max is exact in any order;
* a persistent grid walks work items of (query row, `SLOTS` candidate
  slots): lane = slot, each of the `WARPS` warps a block of `i_tile(Kq)`
  query peaks (at most `MAX_BLOCK` a pass).  cp.async copies the next
  item's rows while the current one is searched; an item without a
  valid id writes -inf and stages nothing.  `smem_bytes` is a block's
  shared memory (at most `SMEM_LIMIT`);
* the sum over query peaks runs i = 0, 1, ..., Kq - 1 from +0.0, the
  order the plain version states: warp 0 adds the terms the warps marked
  as possibly non-zero, in order; the others are +-0 and change nothing;
* any other width (`branch`: a row padded past `MAX_PADDED` peaks, or
  more shared memory than `SMEM_LIMIT`) takes the wide branch, a second
  kernel: a warp a pair, `WIDE_WARPS` a block, each pair's row staged in
  the warp's shared memory by cp.async in chunks of at most `WIDE_STAGE`
  peaks, double-buffered (the next chunk or pair arrives while the
  current one is searched); the branch rule checked once a chunk as its
  m/z become the staged m/z; the lanes on runs of consecutive query
  peaks (at most `WIDE_R` a lane a block), each edge searched over
  shared memory, from the previous peak's edge while the peaks ascend;
  the terms added in query-peak order, the +-0 ones skipped (exact).
  `wide_smem_bytes(Kc)` is a block's shared memory.

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
# a work item (one a lane), warps a block (one query block each), query
# peaks a thread at most a pass (bits of its mask), and the shared memory
# one block may use on the H100.
SLOTS = 32
WARPS = 8
MAX_BLOCK = 32
SMEM_LIMIT = 232_448
MAX_PADDED = 256  # the binary search's steps: 8
REACH = 8  # peaks searched from the previous query peak's edge
# The wide branch: pairs a block (a warp each), query peaks a lane a query
# block at most, peaks a staged chunk at most.
WIDE_WARPS = 8
WIDE_R = 8
WIDE_STAGE = 480

# Kernel launches in this process; reset by whoever wants to count.
LAUNCHES = 0


def i_tile(kq: int) -> int:
    """Query peaks a thread holds a pass: Kq split over the warps, at
    least 1 and at most `MAX_BLOCK` (more peaks take more passes)."""
    return min(MAX_BLOCK, max(1, -(-kq // WARPS)))


def padded_width(kc: int) -> int:
    """The staged row's width for the binary search: the least power of
    two >= Kc (and >= 1), +inf past the row's kept peaks."""
    return 1 << max(0, kc - 1).bit_length()


def smem_bytes(kq: int, kc: int) -> int:
    """Dynamic shared memory of one block, as the kernel computes it: the
    raw stage (3 Kc peak rows of SLOTS + 1 words, the slots' and the
    query's precursors), the query row twice, and per slot the staged row
    (padded width + REACH + 2 Kc words), the warps' vmax and masks, the
    row's flag and precursor difference, and the scan's rows."""
    per_slot = (padded_width(kc) + REACH + 2 * kc + WARPS * i_tile(kq)
                + WARPS + 2 + 2 * WARPS)
    return 4 * (3 * kc * (SLOTS + 1) + SLOTS + 1 + 4 * kq + SLOTS * per_slot)


def wide_stage(kc: int) -> int:
    """Peaks of the wide branch's staged chunk: the whole row up to
    `WIDE_STAGE` (at least 1)."""
    return max(1, min(kc, WIDE_STAGE))


def wide_span(kc: int) -> int:
    """4-byte words of one staged array of the wide branch: the chunk's
    peaks and `REACH` words of +inf padding, rounded up to 4, with four
    words skipped every 32 (the kernel's bank swizzle)."""
    n = (wide_stage(kc) + REACH + 3) // 4 * 4
    return n + 4 * -(-n // 32)


def wide_smem_bytes(kc: int) -> int:
    """Dynamic shared memory of a wide block: a warp's two buffers of a
    chunk's m/z, intensity and annotation, and a query block's running
    vmax."""
    return 4 * WIDE_WARPS * (6 * wide_span(kc) + 32 * WIDE_R)


def branch(kq: int, kc: int) -> str:
    """The kernel's branch at these widths: "staged" (rows staged in
    shared memory, searched over `padded_width(Kc)` <= `MAX_PADDED`) while
    the row's padded width and `smem_bytes` fit, else "wide"."""
    if padded_width(kc) > MAX_PADDED or smem_bytes(kq, kc) > SMEM_LIMIT:
        return "wide"
    return "staged"


def ascending_rows(lib_mz: torch.Tensor, lib_int: torch.Tensor):
    """(N,) bool: the kernel's branch rule for each library row.  True
    (range search) when its intensities are finite, its peaks of positive
    intensity are a prefix of the row (none follows a peak of intensity
    <= 0) and their m/z are finite and non-decreasing; False (dense loop)
    else."""
    pos = lib_int > 0
    after_gap = pos[:, 1:] & ~pos[:, :-1]
    descent = pos[:, 1:] & ~(lib_mz[:, :-1] <= lib_mz[:, 1:])
    return (~after_gap.any(1) & ~descent.any(1)
            & (~pos | torch.isfinite(lib_mz)).all(1)
            & torch.isfinite(lib_int).all(1))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = _build.load("stage1_bounds")
    lib.stage1_bounds.restype = ctypes.c_int
    lib.stage1_bounds.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.stage1_bounds_occupancy.restype = ctypes.c_int
    lib.stage1_bounds_occupancy.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
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
    if n > 2 ** 31 - 1:
        raise ValueError("stage1_bounds: at most 2^31 - 1 library rows")


@torch.no_grad()
def stage1_bounds(q_mz, q_int, q_prec, lib_mz, lib_int, lib_ann, lib_prec,
                  cand_ids, fragment_mz_tolerance: float, num_shifts: int,
                  allow_shift: bool):
    """(B, C) float32 upper bounds of the greedy scores (-inf where
    `cand_ids` is negative), computed by kernel B4 in one launch (the
    branch of `branch(Kq, Kc)`).  Every tensor on one CUDA device,
    contiguous; query and library peak widths may differ, and any width
    runs."""
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
        int(num_shifts), int(bool(allow_shift)), stream,
    )
    if err != 0:
        msg = lib.stage1_bounds_error_string(err).decode()
        raise RuntimeError(f"stage1_bounds launch failed: {msg} ({err})")
    LAUNCHES += 1
    return out


def occupancy(kq: int, kc: int):
    """(dynamic shared memory bytes, blocks of the two-shift instance an
    SM) of a launch at these widths, as the runtime reports them: for
    logs.  Needs the card."""
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    err = _library().stage1_bounds_occupancy(kq, kc, ctypes.byref(smem),
                                             ctypes.byref(blocks))
    if err != 0:
        msg = _library().stage1_bounds_error_string(err).decode()
        raise RuntimeError(f"stage1_bounds occupancy: {msg} ({err})")
    return smem.value, blocks.value
