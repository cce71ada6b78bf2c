"""The traced run: spans around the calls into each layer, the arguments
of each B2 and B4 launch, the rows of each rescoring tier, and what the
profiler's trace says.

Spans and records come from the benchmark's own files: while
`instrumented` is open, the calls that `ann_open_search_batch` makes into
its layers (vectorize, select, rescore, matches) run inside
`torch.profiler.record_function` spans named ``bench.<layer>``; the B2
and B4 wrappers are wrapped to keep a reference to their arguments; and
rescoring's stage-2 calls (at t0 = 8 candidates, then at 32 for the rows
whose certificate failed) and its greedy over all C candidates (the rows
that failed again) are wrapped to count their rows.  The work of each
launch is counted from those after the traced window (`work.py`), so no
counting runs on the card inside it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from benchmark import work

SPAN_PREFIX = "bench."
WINDOW_SPAN = SPAN_PREFIX + "window"
# Kernel names (a substring of each) of the launches whose work is counted.
B2_KERNELS = ("probe_scan_kernel", "prep_queries_kernel")
B2_MAIN_KERNEL = "probe_scan_kernel"
B4_KERNELS = ("stage1_bounds",)


@dataclasses.dataclass
class Recorder:
    """Arguments of the B2 and B4 launches made while instrumented."""

    b2: List[tuple] = dataclasses.field(default_factory=list)
    b4: List[tuple] = dataclasses.field(default_factory=list)
    tiers: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)  # (rows, t) of each stage-2 call
    full: List[np.ndarray] = dataclasses.field(
        default_factory=list)  # query rows of each all-C greedy's pairs


def _spanned(name: str, fn):
    @functools.wraps(fn)
    def call(*args, **kwargs):
        with torch.profiler.record_function(SPAN_PREFIX + name):
            return fn(*args, **kwargs)
    return call


@contextlib.contextmanager
def instrumented(recorder: Recorder):
    """Spans around the layers' calls and records of the B2 and B4
    launches, undone on exit."""
    from ann_solo_tpu_torch import search
    from ann_solo_tpu_torch.index import ivf
    from ann_solo_tpu_torch.ops import rescore, stage1_cuda

    saved = [(search, "vectorize_batch"), (search, "rescore_candidate_matrix"),
             (search, "best_pair_matches"), (ivf.IvfIndex, "search_device"),
             (ivf, "ivf_probe_scan"), (stage1_cuda, "stage1_bounds"),
             (rescore, "_stage2_dense"), (rescore, "_greedy_pairs_chunked")]
    originals = [getattr(owner, name) for owner, name in saved]
    b2, b4, stage2, full = originals[4:8]

    @functools.wraps(b2)
    def b2_recorded(vectors, ids, prec, scales, queries, q_prec, charge,
                    probe_ids, *rest):
        recorder.b2.append((tuple(vectors.shape), vectors.element_size(),
                            probe_ids))
        return b2(vectors, ids, prec, scales, queries, q_prec, charge,
                  probe_ids, *rest)

    @functools.wraps(b4)
    def b4_recorded(q_mz, q_int, q_prec, lib_mz, lib_int, lib_ann, lib_prec,
                    cand_ids, tol, num_shifts, allow_shift):
        recorder.b4.append((q_mz, q_int, q_prec, lib_mz, lib_int, lib_prec,
                            cand_ids, tol, num_shifts, allow_shift))
        return b4(q_mz, q_int, q_prec, lib_mz, lib_int, lib_ann, lib_prec,
                  cand_ids, tol, num_shifts, allow_shift)

    @functools.wraps(stage2)
    def stage2_counted(*args):
        cand_ids, t = args[8], args[9]
        recorder.tiers.append((int(cand_ids.shape[0]), int(t)))
        return stage2(*args)

    @functools.wraps(full)
    def full_counted(*args):
        recorder.full.append(args[7])
        return full(*args)

    replacements = [_spanned(layer, fn) for layer, fn in zip(
        ("vectorize", "rescore", "matches", "select"), originals[:4])]
    replacements += [b2_recorded, b4_recorded, stage2_counted, full_counted]
    try:
        for (owner, name), new in zip(saved, replacements):
            setattr(owner, name, new)
        yield recorder
    finally:
        for (owner, name), old in zip(saved, originals):
            setattr(owner, name, old)


@dataclasses.dataclass
class TraceRecord:
    """What a per-layer metric's reader reads.  Times in seconds; trace
    intervals in microseconds on the profiler's clock."""

    n_batches: int  # batches of the measured window
    stage_seconds: Dict[str, float]  # the window's totals by stage
    measured_s: float = 0.0  # host seconds of the measured window
    traced_batches: int = 0  # batches of the traced window
    window_s: float = 0.0  # host seconds of the traced window
    device_ops: List[Tuple[str, float, float]] = dataclasses.field(
        default_factory=list)  # (name, start, end) in the traced window
    labelled: Optional[tuple] = None  # `read_profile` of the labelling pass
    b2_work: List[Tuple[float, float]] = dataclasses.field(
        default_factory=list)  # (bytes, operations) a launch
    b4_work: List[Tuple[float, float]] = dataclasses.field(
        default_factory=list)
    tiers: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)  # (rows, t) of each stage-2 call
    full_rows: int = 0  # rows rescored over all C candidates

    def kernel_seconds(self, names) -> Tuple[float, int]:
        """Summed device seconds of the operations whose name holds one of
        `names`, and their count."""
        hit = [(s, e) for n, s, e in self.device_ops
               if any(k in n for k in names)]
        return sum(e - s for s, e in hit) / 1e6, len(hit)

    def count_kernels(self, name: str) -> int:
        return sum(name in n for n, _, _ in self.device_ops)


def union(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_seconds(record: TraceRecord) -> float:
    """Seconds in which an operation ran on the device: the union of the
    traced window's device operations."""
    return sum(e - s for s, e in union(
        (s, e) for _, s, e in record.device_ops)) / 1e6


def read_profile(prof) -> Tuple[Optional[Tuple[float, float]],
                                List[Tuple[str, float, float]],
                                List[Tuple[str, float, float]]]:
    """(the window span, device operations, host layer spans) of a
    finished `torch.profiler.profile`.  Device operations are kernels,
    copies and sets; the device-side copies of user annotations are
    left out."""
    from torch.autograd import DeviceType

    window, device, spans = None, [], []
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or \
                    e.name.startswith(SPAN_PREFIX):
                continue
            device.append((e.name, start, end))
        elif e.name == WINDOW_SPAN:
            window = (start, end)
        elif e.name.startswith(SPAN_PREFIX):
            spans.append((e.name[len(SPAN_PREFIX):], start, end))
    return window, device, spans


def count_work(recorder: Recorder, record: TraceRecord) -> None:
    for shape, elem, probe_ids in recorder.b2:
        record.b2_work.append(work.b2_work(shape, elem, probe_ids))
    for args in recorder.b4:
        record.b4_work.append(work.b4_work(*args))
    record.tiers = list(recorder.tiers)
    record.full_rows = sum(len(np.unique(q)) for q in recorder.full)


def breakdown(record: TraceRecord, top: int = 10) -> dict:
    """The device operations that took most time in the traced window, and
    the idle time of the labelling pass by the host span it fell in (the
    innermost ``bench.<layer>`` span around the gap's middle, else
    "harness")."""
    by_op: Dict[str, float] = {}
    for name, s, e in record.device_ops:
        by_op[name[:120]] = by_op.get(name[:120], 0.0) + (e - s) / 1e6
    by_span: Dict[str, float] = {}
    window, ops, spans = record.labelled or (None, [], [])
    if window is not None:
        w0, w1 = window
        gaps, at = [], w0
        for s, e in union((max(s, w0), min(e, w1)) for _, s, e in ops
                          if e > w0 and s < w1):
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if w1 > at:
            gaps.append((at, w1))
        for g0, g1 in gaps:
            mid = (g0 + g1) / 2
            inside = [(e - s, name) for name, s, e in spans
                      if s <= mid <= e]
            label = min(inside)[1] if inside else "harness"
            by_span[label] = by_span.get(label, 0.0) + (g1 - g0) / 1e6

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                ][:top]
    return {"device_ops": ranked(by_op), "idle_gaps": ranked(by_span)}
