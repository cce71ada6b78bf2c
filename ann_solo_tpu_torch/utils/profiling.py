"""Stage timing for the search engine (the port of
`ann_solo_tpu/utils/profiling.py`'s `StageProfiler`).

Each stage's wall seconds accumulate under its name.  When a CUDA device
is set, it is synchronized as a stage ends, so the seconds include the
queued device work of that stage.  `count` tallies events that take no
time (which path a batch took); `notes` holds facts a run reports (an
index's shape).  `device_trace` writes a torch.profiler trace of a block
when a trace directory is set (``ANN_SOLO_TORCH_TRACE_DIR``).
"""

from __future__ import annotations

import collections
import contextlib
import logging
import os
import time
from typing import Dict, Iterator, Optional

import torch

from ann_solo_tpu_torch.device import synchronize

logger = logging.getLogger(__name__)


class StageProfiler:
    """Accumulates wall-clock time per named pipeline stage."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = collections.defaultdict(float)
        self.counts: Dict[str, int] = collections.defaultdict(int)
        self.notes: Dict[str, object] = {}
        self.device: Optional[torch.device] = None

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            synchronize(self.device)
            self.totals[name] += time.perf_counter() - start
            self.counts[name] += 1

    def add(self, name: str, seconds: float) -> None:
        """Account `seconds` measured elsewhere to stage `name`."""
        self.totals[name] += seconds
        self.counts[name] += 1

    def count(self, name: str) -> None:
        self.counts[name] += 1

    def summary(self) -> str:
        if not self.totals:
            return "no stages recorded"
        total = sum(self.totals.values())
        parts = []
        for name, seconds in sorted(
            self.totals.items(), key=lambda kv: -kv[1]
        ):
            parts.append(
                f"{name}: {seconds:.2f}s ({100 * seconds / total:.0f}%, "
                f"n={self.counts[name]})"
            )
        return "; ".join(parts)

    def log_summary(self, prefix: str = "search profile") -> None:
        logger.info("%s: %s", prefix, self.summary())

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
        self.notes.clear()


# Process-wide profiler used by the search engine.
profiler = StageProfiler()


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str] = None) -> Iterator[None]:
    """Optionally capture a torch.profiler trace around a block.

    Enabled when `trace_dir` or ``ANN_SOLO_TORCH_TRACE_DIR`` is set: the
    block runs under `torch.profiler.profile` (CPU activity, and CUDA
    activity where PyTorch sees a GPU) and its Chrome trace is written to
    ``trace_{n:05d}.json`` in the directory, `n` one more than the traces
    already there.  A no-op otherwise.
    """
    trace_dir = trace_dir or os.environ.get("ANN_SOLO_TORCH_TRACE_DIR")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    n = sum(name.startswith("trace_") and name.endswith(".json")
            for name in os.listdir(trace_dir))
    prof.export_chrome_trace(os.path.join(trace_dir, f"trace_{n:05d}.json"))
