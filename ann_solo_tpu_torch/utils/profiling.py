"""Stage timing for the search engine (the port of
`ann_solo_tpu/utils/profiling.py`'s `StageProfiler`).

Each stage's wall seconds accumulate under its name.  When a CUDA device
is set, it is synchronized as a stage ends, so the seconds include the
queued device work of that stage.  `count` tallies events that take no
time (which path a batch took); `notes` holds facts a run reports (an
index's shape).
"""

from __future__ import annotations

import collections
import contextlib
import logging
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
