"""The canonical select CUDA kernel (B5): wrapper, limits and launch count.

Replaces the XLA selection that follows the probe-gather scan in the
reference (`ann_solo_tpu/index/ivf.py::_canonical_topk`, `:673`, and
`_canonical_topk_u16`, `:719`; the tail of `_ivf_probe_scan_tile`,
`:1211`; no Pallas kernel): the canonical top-k on 16-bit keys, the
lane-to-id map and the unique-id dedup, in one launch.  The kernel
source is `ann_solo_tpu_torch/csrc/canonical_select.cu`, its plain
PyTorch version `ops/canonical_select.py::canonical_select_plain`, which
it equals bit for bit.

The kernel is bound by device-memory bytes: the (B, n) float32 lanes read
once and the (B, k) outputs written.  Its first pass reads each row from
device memory once, 16 bytes a thread a load with four in flight, and
keeps a 16-bit key a lane in shared memory; the low-byte histogram, the
tie count and the compaction then read those keys.  The compacted lanes
stay in lane order, so the canonical order is one descending sort of
32-bit words (a bitonic network whose strides below a warp's span run in
registers), and the dedup keeps each id's least rank through a hash table
in shared memory (integer CAS and min).  `plan(n, k_eff)` gives the
branch and the dynamic shared memory: one block a row with the keys on
chip while they fit (`SMEM_LIMIT`; every row of the main path, two
blocks an SM at the bench's 49,152 lanes), else the long-row branch of
the same kernel, whose passes each read the row from device memory.

More than `MAX_SEL` lanes selected (the open level at 4,096 candidates
x2, k_sel 8,192) take the wide branch: a sequence of launches over a
device-memory workspace this wrapper allocates (`wide_row_words` a row,
`wide_grid` rows a group).  Passes 1-3 leave a row's selected lanes as
key << 32 | lane in lane order, one block a row ("wide", "wide_long_row":
the same code as the first kernel), or, with too few rows to fill the
SMs, a row split into tiles over about two blocks an SM (integer atomics
and a scan kernel join the tiles' counts).  The canonical order is then
a stable counting sort by the 16-bit key, two passes of 8 bits, each
bucket order descending; each rank's id is decoded once, and the dedup
keeps each id's least rank through a 64-bit hash table (CAS, then
atomicMin); a scan places the kept ranks.  Up to `ROW_TAIL` lanes selected
(4,096 candidates x2) one block a row does the sort and the dedup in
shared memory; more take kernels over tiles of the items, the table in the
workspace.

Routing is decided by the tensors, never by a fallback:
`ops/canonical_select.py::canonical_select` sends CPU tensors to the plain
version and CUDA tensors here, where the kernel launches or the call
raises; this wrapper refuses CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ann_solo_tpu_torch.ops import _build

# The kernel's limits, as in `csrc/canonical_select.cu`: threads a block,
# the largest selection (lanes before dedup) of the on-chip sort, lanes a
# row (`ops/ivf_probe.py::MAX_PROBE_LANES`); the shared memory a block may
# use on the H100, the part of it the kernel's static arrays may take, and
# the least count of sort words (their area holds a 1 KB histogram
# first).  The wide branch: its histogram's bytes, the least lanes of a
# tile of a split row, the items a block of its sort and tail, the most
# items of a row sorted and deduplicated on one block in shared memory and
# that block's threads, the ints of a lane tile's entry and the fixed head
# of a row's meta area, and the
# device memory its workspace may take in one launch (it bounds the rows
# of a group).
THREADS = 512
MAX_SEL = 4096
MAX_LANES = 1 << 22
SMEM_LIMIT = 232_448
STATIC_RESERVE = 256
MIN_WORDS = 128
HIST_BYTES = 1024
MIN_TILE = 4096
ITEM_TILE = 4096
ROW_TAIL = 8192
ROW_TAIL_THREADS = 1024
TILE_INTS = 260
META_HEAD = 528
WORK_BUDGET = 1 << 30
# `plan`'s branches by the code the kernel's `canonical_select_plan` gives.
BRANCHES = ("long_row", "on_chip", "wide", "wide_long_row")

# Kernel launches in this process; reset by whoever wants to count.
LAUNCHES = 0


def sort_width(k_eff: int) -> int:
    """The sort's width before its floor: the least power of two >= k_eff
    (>= 1)."""
    return 1 << max(0, k_eff - 1).bit_length()


def plan(n: int, k_eff: int) -> tuple:
    """(branch, dynamic shared memory bytes) of a row of n lanes with k_eff
    selected, as the kernel's `make_plan` computes them.  Up to `MAX_SEL`:
    "on_chip" keeps 2 * round_up(n + 3, 8) bytes of keys (the dedup table
    of 16 bytes a word takes the same area later) beside 8 bytes a sort
    word, while that and `STATIC_RESERVE` fit `SMEM_LIMIT`; else
    "long_row", the table and the words only.  Above it, for a row on one
    block (`wide_grid`'s tiles = 1): "wide", the keys and the histogram,
    while they fit; else "wide_long_row", the histogram alone."""
    keys = 2 * ((n + 3 + 7) // 8 * 8)
    if k_eff > MAX_SEL:
        if keys + HIST_BYTES + STATIC_RESERVE <= SMEM_LIMIT:
            return "wide", keys + HIST_BYTES
        return "wide_long_row", HIST_BYTES
    words = max(sort_width(k_eff), MIN_WORDS)
    table = 16 * words
    on_chip = max(keys, table) + 8 * words
    if on_chip + STATIC_RESERVE <= SMEM_LIMIT:
        return "on_chip", on_chip
    return "long_row", table + 8 * words


def wide_row_words(n: int, k_eff: int) -> int:
    """8-byte words of a row's share of the wide branch's workspace, as
    the kernel's `wide_layout` computes them: its items (k_eff rounded up
    to even), its table (the least power of two >= 2 * k_eff slots) and
    its meta area (ints: the fixed head, `TILE_INTS` a lane tile of at
    least `MIN_TILE` lanes, 256 counts and one kept count an item tile of
    `ITEM_TILE`)."""
    tiles_max = -(-n // MIN_TILE)
    item_tiles = -(-k_eff // ITEM_TILE)
    meta = (META_HEAD + TILE_INTS * tiles_max + 256 * item_tiles
            + (item_tiles + 3) // 4 * 4)
    return (k_eff + 1) // 2 * 2 + sort_width(2 * k_eff) + meta // 2


def wide_grid(b: int, n: int, k_eff: int, sms: int) -> tuple:
    """(rows a group, tiles a row) of the wide branch for b rows of n
    lanes, k_eff selected, on a card of `sms` SMs: as many rows a group as
    `WORK_BUDGET` holds (at least one), and tiles enough for about two
    blocks an SM over the group's rows (1 while the rows fill them; tiles
    of at least `MIN_TILE` lanes, a multiple of 8 each), as the kernel's
    `wide_tiles` computes them."""
    group = max(1, min(b, WORK_BUDGET // (8 * wide_row_words(n, k_eff))))
    tiles = max(1, min(-(-n // MIN_TILE), -(-2 * sms // group)))
    tile_lanes = -(-(-(-n // tiles)) // 8) * 8
    return group, -(-n // tile_lanes)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = _build.load("canonical_select")
    lib.canonical_select.restype = ctypes.c_int
    lib.canonical_select.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.canonical_select_wide.restype = ctypes.c_int
    lib.canonical_select_wide.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.canonical_select_plan.restype = ctypes.c_int
    lib.canonical_select_plan.argtypes = (
        [ctypes.c_longlong, ctypes.c_int]
        + [ctypes.POINTER(ctypes.c_int)] * 3)
    lib.canonical_select_error_string.restype = ctypes.c_char_p
    lib.canonical_select_error_string.argtypes = [ctypes.c_int]
    return lib


def occupancy(n: int, k_sel: int) -> tuple:
    """(branch, dynamic shared memory bytes, blocks an SM) of the built
    kernel on the current CUDA device for rows of n lanes, k_sel selected:
    the kernel's own plan and `cudaOccupancyMaxActiveBlocksPerMultiprocessor`
    (builds the library; the card only)."""
    k_eff = check_limits(n, k_sel, 0)
    lib = _library()
    branch, smem, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = lib.canonical_select_plan(n, k_eff, ctypes.byref(branch),
                                    ctypes.byref(smem), ctypes.byref(blocks))
    if err != 0:
        msg = lib.canonical_select_error_string(err).decode()
        raise RuntimeError(f"canonical_select_plan failed: {msg} ({err})")
    return BRANCHES[branch.value], smem.value, blocks.value


def check_limits(n: int, k_sel: int, k: int) -> int:
    """k_eff = min(k_sel, n) after checking the kernel's limits: 1 <= n <=
    `MAX_LANES`, k_sel >= 1, k >= 0.  Every k_eff runs (above `MAX_SEL`
    on the wide branch)."""
    if not 1 <= n <= MAX_LANES:
        raise ValueError(f"canonical_select: {n} lanes a row; the kernel "
                         f"takes 1 to MAX_LANES = {MAX_LANES}")
    if k_sel < 1:
        raise ValueError(f"canonical_select: k_sel = {k_sel} lanes before "
                         "dedup; at least 1")
    if k < 0:
        raise ValueError(f"canonical_select: k = {k} < 0")
    return min(k_sel, n)


def _check(flat, probe_ids, padded_ids):
    device = flat.device
    if device.type != "cuda":
        raise ValueError(f"canonical_select: the kernel takes CUDA tensors, "
                         f"not {device}")
    if probe_ids.device != device or padded_ids.device != device:
        raise ValueError("canonical_select: tensors on different devices")
    for name, t, dtypes in (
        ("flat", flat, (torch.float32,)),
        ("probe_ids", probe_ids, (torch.int32, torch.int64)),
        ("padded_ids", padded_ids, (torch.int32,)),
    ):
        if t.dtype not in dtypes:
            raise TypeError(f"canonical_select: {name} must be {dtypes}")
        if t.dim() != 2:
            raise ValueError(f"canonical_select: {name} must have 2 dims")
    b, n = flat.shape
    l, cap = padded_ids.shape
    if probe_ids.shape[0] != b or n != probe_ids.shape[1] * cap:
        raise ValueError("canonical_select: flat must be (B, P * cap) for "
                         "probe_ids (B, P) and padded_ids (L, cap)")
    if l < 1 or l >= 1 << 31 or b >= 1 << 31:
        raise ValueError("canonical_select: 1 <= L < 2^31 and B < 2^31")


@torch.no_grad()
def canonical_select(flat, probe_ids, padded_ids, k_sel: int, k: int,
                     redundant: bool):
    """((B, k) float32 scores, (B, k) int32 ids): kernel B5 on CUDA
    tensors in one launch (the branch of `plan`), `canonical_select_plain`'s
    result bit for bit.
    `flat` (B, P * cap) float32, `probe_ids` (B, P) int32/int64,
    `padded_ids` (L, cap) int32, all on one CUDA device."""
    global LAUNCHES
    _check(flat, probe_ids, padded_ids)
    b, n = flat.shape
    l, cap = padded_ids.shape
    k_eff = check_limits(n, k_sel, k)
    dedup = bool(redundant) or k_eff > k
    out_s = torch.empty((b, k), dtype=torch.float32, device=flat.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=flat.device)
    if b == 0 or k == 0:
        return out_s, out_i
    flat = flat.contiguous()
    probe = probe_ids.to(torch.int64).contiguous()
    ids = padded_ids.contiguous()
    lib = _library()
    stream = torch.cuda.current_stream(flat.device).cuda_stream
    if plan(n, k_eff)[0].startswith("wide"):
        sms = torch.cuda.get_device_properties(
            flat.device).multi_processor_count
        grid = wide_grid(b, n, k_eff, sms)[0]
        work = torch.empty(grid * wide_row_words(n, k_eff),
                           dtype=torch.int64, device=flat.device)
        err = lib.canonical_select_wide(
            flat.data_ptr(), probe.data_ptr(), ids.data_ptr(),
            out_s.data_ptr(), out_i.data_ptr(), work.data_ptr(), b,
            probe.shape[1], l, cap, k_eff, k, int(dedup), grid, stream,
        )
    else:
        err = lib.canonical_select(
            flat.data_ptr(), probe.data_ptr(), ids.data_ptr(),
            out_s.data_ptr(), out_i.data_ptr(), b, probe.shape[1], l, cap,
            k_eff, k, int(dedup), stream,
        )
    if err != 0:
        msg = lib.canonical_select_error_string(err).decode()
        raise RuntimeError(f"canonical_select launch failed: {msg} ({err})")
    LAUNCHES += 1
    return out_s, out_i
