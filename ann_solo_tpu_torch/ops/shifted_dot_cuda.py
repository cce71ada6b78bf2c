"""The greedy shifted-dot CUDA kernel: wrapper, launch count, dispatchers.

Replaces the TPU kernel `ann_solo_tpu/ops/shifted_dot_pallas.py::_kernel`
(and its entry `shifted_dot_pallas_full`); the dispatchers
`gather_pair_scores` and `shifted_dot_best_match_auto` are the
counterparts of the JAX ones in the same file.  The kernel source is
`ann_solo_tpu_torch/csrc/shifted_dot.cu`.

On the H100 the function is bound by the float operations that build
each pair's K x K match matrix, not by HBM.  One warp scores one pair and
never stores the matrix: it compacts the positive entries (a few dozen a
pair) into a list in shared memory and runs the greedy over that list
(`ops/shifted_dot.py::greedy_over_positives` is the same walk in plain
PyTorch, for the tests).

Routing is decided by the tensors, never by a fallback: CPU tensors take
the plain PyTorch version (`ops/shifted_dot.py`), CUDA tensors launch the
kernel at every K or raise.  The port drops the JAX package's width rule
on purpose (more than 128 peaks take its XLA path,
`shifted_dot_pallas.py:336-338`): that rule exists for the TPU's VMEM,
which holds the kernel's K x K blocks, and nothing on this card needs it.
Above `MAX_KERNEL_PEAKS` (`branch`) the kernel's wide branch
takes the pair: a block a pair, a query peak a thread; a pair on the
search rule (`search_pairs`: the rows the engine builds) finds each query
peak's passing candidate peaks by a binary search in each m/z window of
its sorted row instead of walking all K x K entries, and the greedy runs
in shared memory (a rank sort of the positive entries and one warp's
walk, or each row's best live entries when they overflow the list); the
same picks in the same order, where the plain version would build the
whole K x K matrix step by step.  Past the shared memory (about K =
8,500) the pair's state lives in a device-memory workspace allocated
here, sized by the kernel's library; `wide_plan` reports the layout.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ann_solo_tpu_torch.ops import _build
from ann_solo_tpu_torch.ops.shifted_dot import shifted_dot_full_plain
from ann_solo_tpu_torch.ops.stage1_cuda import ascending_rows
from ann_solo_tpu_torch.utils.profiling import profiler

# Peaks a pair of the register branch; more take the wide branch.
MAX_KERNEL_PEAKS = 128
# Pair-count granularity of the JAX call sites (the Pallas PAIR_BLOCK).
# The kernel itself takes any pair count.
PAIR_BLOCK = 128

# Kernel launches in this process; reset by whoever wants to count.
LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = _build.load("shifted_dot")
    lib.shifted_dot_greedy.restype = ctypes.c_int
    lib.shifted_dot_greedy.argtypes = [ctypes.c_void_p] * 11 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.shifted_dot_workspace_bytes.restype = ctypes.c_size_t
    lib.shifted_dot_workspace_bytes.argtypes = [ctypes.c_int] * 3
    lib.shifted_dot_wide_plan.restype = ctypes.c_int
    lib.shifted_dot_wide_plan.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
    lib.shifted_dot_error_string.restype = ctypes.c_char_p
    lib.shifted_dot_error_string.argtypes = [ctypes.c_int]
    return lib


def branch(k: int) -> str:
    """The kernel's branch for pairs of K peaks: "registers" (a lane holds
    its candidate columns) up to `MAX_KERNEL_PEAKS`, else "wide"."""
    return "registers" if k <= MAX_KERNEL_PEAKS else "wide"


WIDE_PLAN_KEYS = ("threads", "smem_bytes", "workspace_bytes",
                  "blocks_per_sm", "list_entries", "row_depth")


def wide_plan(k: int, num_shifts: int) -> dict:
    """The built wide kernel's launch at K peaks, as its library plans it
    (`shifted_dot_wide_plan`, the card only): threads a block (a query
    peak a thread, in whole warps, at most 1,024), dynamic shared memory
    a block (0 when the state is in the workspace), workspace bytes a
    pair, blocks an SM, the positive entries the list sorts on chip and
    the entries the overflow path caches a row."""
    lib = _library()
    plan = (ctypes.c_longlong * len(WIDE_PLAN_KEYS))()
    err = lib.shifted_dot_wide_plan(k, num_shifts, plan)
    if err != 0:
        msg = lib.shifted_dot_error_string(err).decode()
        raise RuntimeError(f"shifted_dot_wide_plan failed: {msg} ({err})")
    return dict(zip(WIDE_PLAN_KEYS, plan))


def search_pairs(q_int, c_mz, c_int, fragment_mz_tolerance: float):
    """(P,) bool: the wide kernel's branch rule for each pair.  True (the
    m/z windows are searched) when the candidate row takes B4's rule
    (`stage1_cuda.ascending_rows`: finite intensities, the peaks of
    positive intensity a prefix of the row with finite, non-decreasing
    m/z), the query's intensities are finite too (so no entry is NaN)
    and so is the tolerance; False (the dense walk over all K x K
    entries) else.  The kernel checks the same rule on the rows it
    stages."""
    tol = torch.tensor(fragment_mz_tolerance, dtype=torch.float32)
    return (ascending_rows(c_mz, c_int) & torch.isfinite(q_int).all(1)
            & bool(torch.isfinite(tol)))


@torch.no_grad()
def _launch(q_mz, q_int, c_mz, c_int, c_ann, q_prec, c_prec, charge,
            tol: float, num_shifts: int, allow_shift: bool):
    global LAUNCHES
    lib = _library()
    p, k = q_mz.shape
    total = torch.empty(p, dtype=torch.float32, device=q_mz.device)
    match = torch.empty((p, k), dtype=torch.int32, device=q_mz.device)
    n_work = lib.shifted_dot_workspace_bytes(p, k, num_shifts)
    work = (torch.empty(n_work, dtype=torch.uint8, device=q_mz.device)
            if n_work else None)
    stream = torch.cuda.current_stream(q_mz.device).cuda_stream
    err = lib.shifted_dot_greedy(
        q_mz.data_ptr(), q_int.data_ptr(), c_mz.data_ptr(), c_int.data_ptr(),
        c_ann.data_ptr(), q_prec.data_ptr(), c_prec.data_ptr(),
        charge.data_ptr(), total.data_ptr(), match.data_ptr(),
        None if work is None else work.data_ptr(), p, k, tol, num_shifts,
        int(bool(allow_shift)), stream,
    )
    if err != 0:
        msg = lib.shifted_dot_error_string(err).decode()
        raise RuntimeError(f"shifted_dot_greedy launch failed: {msg} ({err})")
    LAUNCHES += 1
    return total, match


def _check(q_mz, q_int, c_mz, c_int, c_ann, q_prec, c_prec, charge):
    tensors = (q_mz, q_int, c_mz, c_int, c_ann, q_prec, c_prec, charge)
    device = q_mz.device
    if any(t.device != device for t in tensors):
        raise ValueError("shifted_dot_full: tensors on different devices")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"shifted_dot_full: unsupported device {device}")
    for name, t, dtype in (
        ("q_mz", q_mz, torch.float32), ("q_int", q_int, torch.float32),
        ("c_mz", c_mz, torch.float32), ("c_int", c_int, torch.float32),
        ("c_ann", c_ann, torch.int32), ("q_prec", q_prec, torch.float32),
        ("c_prec", c_prec, torch.float32), ("charge", charge, torch.int32),
    ):
        if t.dtype != dtype:
            raise TypeError(f"shifted_dot_full: {name} must be {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"shifted_dot_full: {name} must be contiguous")
    if q_mz.dim() != 2:
        raise ValueError("shifted_dot_full: peak arrays must be (P, K)")
    for t in (q_int, c_mz, c_int, c_ann):
        if t.shape != q_mz.shape:
            raise ValueError("shifted_dot_full: peak arrays differ in shape")
    for t in (q_prec, c_prec, charge):
        if t.shape != q_mz.shape[:1]:
            raise ValueError("shifted_dot_full: per-pair arrays must be (P,)")


def shifted_dot_full(
    q_mz, q_int, c_mz, c_int, c_ann, q_prec_mz, c_prec_mz, charge,
    fragment_mz_tolerance: float, num_shifts: int, allow_shift: bool,
):
    """Pair scores and greedy peak matches.

    Returns (total (P,) float32, match (P, K) int32) where match[p, i] is
    the candidate peak assigned to query peak i (-1 = unmatched): the
    `shifted_dot_pallas_full` contract.  Both sides must have the same
    peak width K (pad the narrower one, as the dispatchers below do).
    While tracing is on, each call is counted (``b1.launches``,
    ``b1.pairs``).
    """
    _check(q_mz, q_int, c_mz, c_int, c_ann, q_prec_mz, c_prec_mz, charge)
    tracer = profiler.tracer
    if tracer is not None:
        tracer.count("b1.launches")
        tracer.count("b1.pairs", q_mz.shape[0])
    if q_mz.device.type == "cpu":
        return shifted_dot_full_plain(
            q_mz, q_int, c_mz, c_int, c_ann, q_prec_mz, c_prec_mz, charge,
            fragment_mz_tolerance, num_shifts, allow_shift,
        )
    return _launch(
        q_mz, q_int, c_mz, c_int, c_ann, q_prec_mz, c_prec_mz, charge,
        float(fragment_mz_tolerance), int(num_shifts), allow_shift,
    )


def pad_peaks(qm, qi, cm, ci, ca):
    """Pad query or candidate peak blocks to one common width (query and
    library max_peaks settings may differ); padded candidate peaks carry
    annotation -1 and every padded peak has zero intensity."""
    k = max(qm.shape[1], cm.shape[1])
    if qm.shape[1] < k:
        pad = (0, k - qm.shape[1])
        qm, qi = F.pad(qm, pad), F.pad(qi, pad)
    if cm.shape[1] < k:
        pad = (0, k - cm.shape[1])
        cm, ci = F.pad(cm, pad), F.pad(ci, pad)
        ca = F.pad(ca, pad, value=-1)
    return qm, qi, cm, ci, ca


def gather_pair_scores(
    q_mz, q_int, q_prec,  # (B, K), (B, K), (B,) device-resident queries
    lib_mz, lib_int, lib_ann, lib_prec,  # device-resident library block
    pair_q, pair_c, pair_valid,  # (P,) pair indices + validity
    fragment_mz_tolerance: float, num_shifts: int, allow_shift: bool,
):
    """Gather (query, candidate) pairs on the device and score them.

    The engine partitions by charge, so the per-pair charge is
    num_shifts - 1 with shifts on (1 without).  Invalid pairs -> -inf.
    """
    charge = torch.full(
        pair_q.shape, num_shifts - 1 if allow_shift else 1,
        dtype=torch.int32, device=pair_q.device,
    )
    qm, qi, cm, ci, ca = pad_peaks(
        q_mz.index_select(0, pair_q), q_int.index_select(0, pair_q),
        lib_mz.index_select(0, pair_c), lib_int.index_select(0, pair_c),
        lib_ann.index_select(0, pair_c),
    )
    total, _ = shifted_dot_full(
        qm, qi, cm, ci, ca,
        q_prec.index_select(0, pair_q), lib_prec.index_select(0, pair_c),
        charge, fragment_mz_tolerance, num_shifts, allow_shift,
    )
    return torch.where(pair_valid, total, float("-inf"))


def shifted_dot_best_match_auto(
    q_mz, q_int, c_mz, c_int, c_ann, q_prec_mz, c_prec_mz, charge,
    fragment_mz_tolerance: float, num_shifts: int, allow_shift: bool,
):
    """Scores + (match_q, match_c) peak pairs of gathered pairs.

    Returns (total (P,), match_q (P, K), match_c (P, K)), -1 padded, in
    query-peak order (the JAX dispatcher's kernel-path layout).
    """
    qm, qi, cm, ci, ca = pad_peaks(q_mz, q_int, c_mz, c_int, c_ann)
    total, match = shifted_dot_full(
        qm, qi, cm, ci, ca, q_prec_mz, c_prec_mz, charge,
        fragment_mz_tolerance, num_shifts, allow_shift,
    )
    lanes = torch.arange(match.shape[1], dtype=torch.int32,
                         device=match.device)
    match_q = torch.where(match >= 0, lanes[None, :], -1)
    return total, match_q, match
