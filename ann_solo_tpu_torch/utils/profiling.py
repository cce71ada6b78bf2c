"""Stage timing and tracing for the search engine (the port of
`ann_solo_tpu/utils/profiling.py`'s `StageProfiler`, with a tracer).

Each stage's wall seconds accumulate under its name.  When a CUDA device
is set, it is synchronized as a stage ends, so the seconds include the
queued device work of that stage.  `count` tallies events that take no
time (which path a batch took); `notes` holds facts a run reports (an
index's shape).  `device_trace` writes a torch.profiler trace of a block
when a trace directory is set (``ANN_SOLO_TORCH_TRACE_DIR``).

The tracer (`Tracer`, `profiler.tracer`) records the batch path from
inside: spans at each layer boundary and counters, grouped by batch (a batch is one tree of spans: one
`ann_open_search_batch` call under its root span ``batch``).  It is off
by default, and then every span or counter site costs one attribute
check (`profiler.tracer is None`) and allocates nothing.  It is on inside
`profiler.tracing()`, and for each `ann_open_search_batch` call made
while a `torch.profiler` profile is active (`profiler.follow_profiler`),
so that whoever profiles the program gets its spans.  While on, each
span keeps its name, its start and end in `time.perf_counter_ns`, its
parent and its attributes; while a profile is active each span is also a
`torch.profiler.record_function` range named ``ann_solo.<name>``, on the
profiler's clock beside the operations it launches (a profile that does
not record the host's activity keeps nothing of it).  Spans never
synchronize the device.  Finished batches are kept, at most
`Tracer.MAX_BATCHES`, until `profiler.take()` takes them.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import os
import time
from typing import Dict, Iterator, List, Optional

import torch

from ann_solo_tpu_torch.device import synchronize

logger = logging.getLogger(__name__)

SPAN_PREFIX = "ann_solo."  # of each span's record_function range


def _profiling() -> bool:
    """Whether a torch.profiler (autograd profiler) profile is active."""
    return torch._C._autograd._profiler_enabled()


class _NoSpan:
    """The span of a site while tracing is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


NO_SPAN = _NoSpan()


@dataclasses.dataclass
class Span:
    name: str
    start_ns: int
    end_ns: int
    parent: int  # index of the parent span in its batch, -1 for the root
    attrs: Dict[str, object]

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


@dataclasses.dataclass
class BatchTrace:
    """The spans (in start order) and counters of one traced batch: numbers
    and names only, so that a kept batch holds no tensor."""

    batch_id: int
    spans: List[Span] = dataclasses.field(default_factory=list)
    counters: Dict[str, int] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(int))

    def seconds(self, *names: str) -> float:
        """Summed seconds of the spans named `names`."""
        return sum(s.seconds for s in self.spans if s.name in names)


class _SpanContext:
    __slots__ = ("tracer", "span", "index", "range")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self.tracer = tracer
        self.span = Span(name, 0, 0, -1, attrs)
        self.range = None

    def __enter__(self) -> Span:
        tracer = self.tracer
        if tracer._batch is None:
            tracer._batch = BatchTrace(tracer._next_id)
            tracer._next_id += 1
        batch = tracer._batch
        self.span.parent = tracer._open[-1] if tracer._open else -1
        self.index = len(batch.spans)
        batch.spans.append(self.span)
        tracer._open.append(self.index)
        if _profiling():
            self.range = torch.autograd.profiler.record_function(
                SPAN_PREFIX + self.span.name)
            self.range.__enter__()
        self.span.start_ns = time.perf_counter_ns()
        return self.span

    def __exit__(self, *exc) -> bool:
        self.span.end_ns = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        tracer = self.tracer
        tracer._open.pop()
        if not tracer._open:
            tracer._finish()
        return False


class Tracer:
    """Spans and counters of the traced batches."""

    MAX_BATCHES = 256

    def __init__(self) -> None:
        self.batches: collections.deque = collections.deque(
            maxlen=self.MAX_BATCHES)
        # Each counter summed over every traced batch since `reset`.
        self.totals: Dict[str, int] = collections.Counter()
        self._batch: Optional[BatchTrace] = None
        self._open: List[int] = []
        self._next_id = 0

    def span(self, name: str, **attrs) -> _SpanContext:
        """A span of the current batch (a new batch when none is open);
        `with` gives the `Span`, whose `attrs` may be added to."""
        return _SpanContext(self, name, attrs)

    def count(self, name: str, n: int = 1) -> None:
        """Add `n` to the current batch's counter `name`."""
        if self._batch is not None:
            self._batch.counters[name] += n
        self.totals[name] += n

    def annotate(self, key: str, value) -> None:
        """Set an attribute of the current batch's root span."""
        if self._batch is not None and self._batch.spans:
            self._batch.spans[0].attrs[key] = value

    def _finish(self) -> None:
        self.batches.append(self._batch)
        self._batch = None

    def take(self) -> List[BatchTrace]:
        out = list(self.batches)
        self.batches.clear()
        return out

    def reset(self) -> None:
        self.batches.clear()
        self.totals.clear()


class _FollowedBatch:
    """A batch traced because a torch.profiler profile is active: the
    tracer is on for the batch alone."""

    __slots__ = ("profiler", "inner")

    def __init__(self, profiler: "StageProfiler", inner: _SpanContext):
        self.profiler, self.inner = profiler, inner

    def __enter__(self) -> Span:
        self.profiler.tracer = self.profiler._tracer
        return self.inner.__enter__()

    def __exit__(self, *exc) -> bool:
        try:
            return self.inner.__exit__(*exc)
        finally:
            self.profiler.tracer = None


class Stages:
    """The stages of one call, run one after another: each stage is a
    span of the tracer's, and with `seconds` given the device is
    synchronized as each stage ends and the stage's wall seconds, since
    the previous stage's end (the first: since this object was made),
    are added to `seconds[name]`."""

    __slots__ = ("device", "seconds", "clock", "name", "inner")

    def __init__(self, device, seconds: Optional[Dict[str, float]]):
        self.device, self.seconds = device, seconds
        self.clock = time.perf_counter()
        self.name, self.inner = "", None

    def __call__(self, name: str) -> "Stages":
        self.name = name
        return self

    def __enter__(self) -> None:
        tracer = profiler.tracer
        if tracer is not None:
            self.inner = tracer.span(self.name)
            self.inner.__enter__()

    def __exit__(self, *exc) -> bool:
        try:
            if exc[0] is None and self.seconds is not None:
                tracer = profiler.tracer
                with tracer.span("sync") if tracer else NO_SPAN:
                    synchronize(self.device)
                now = time.perf_counter()
                self.seconds[self.name] = (self.seconds.get(self.name, 0.0)
                                           + now - self.clock)
                self.clock = now
        finally:
            if self.inner is not None:
                self.inner.__exit__(*exc)
                self.inner = None
        return False


class StageProfiler:
    """Accumulates wall-clock time per named pipeline stage, and holds the
    tracer (`tracer`: None while tracing is off)."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = collections.defaultdict(float)
        self.counts: Dict[str, int] = collections.defaultdict(int)
        self.notes: Dict[str, object] = {}
        self.device: Optional[torch.device] = None
        self.tracer: Optional[Tracer] = None
        # Trace each batch run while a torch.profiler profile is active.
        self.follow_profiler = True
        self._tracer = Tracer()
        self._depth = 0

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        start = time.perf_counter()
        tracer = self.tracer
        with tracer.span(name) if tracer else NO_SPAN:
            try:
                yield
            finally:
                with tracer.span("sync") if tracer else NO_SPAN:
                    synchronize(self.device)
                self.totals[name] += time.perf_counter() - start
                self.counts[name] += 1

    def add(self, name: str, seconds: float) -> None:
        """Account `seconds` measured elsewhere to stage `name`."""
        self.totals[name] += seconds
        self.counts[name] += 1

    def count(self, name: str, n: int = 1) -> None:
        self.counts[name] += n
        if self.tracer is not None:
            self.tracer.count(name, n)

    @contextlib.contextmanager
    def tracing(self) -> Iterator[Tracer]:
        """Tracing on inside the block (blocks may nest)."""
        self._depth += 1
        self.tracer = self._tracer
        try:
            yield self._tracer
        finally:
            self._depth -= 1
            if not self._depth:
                self.tracer = None

    def batch(self, queries: int, charge: int):
        """The root span of one batch: a span of the tracer's while it is
        on; while it is off, and a torch.profiler profile is active and
        `follow_profiler` set, the tracer is on for this batch; else
        `NO_SPAN`."""
        if self.tracer is not None:
            return self.tracer.span("batch", queries=queries, charge=charge)
        if self.follow_profiler and _profiling():
            return _FollowedBatch(self, self._tracer.span(
                "batch", queries=queries, charge=charge))
        return NO_SPAN

    def take(self) -> List[BatchTrace]:
        """The finished traced batches, removed from the tracer."""
        return self._tracer.take()

    def summary(self) -> str:
        parts = []
        total = sum(self.totals.values()) or 1.0
        for name, seconds in sorted(
            self.totals.items(), key=lambda kv: -kv[1]
        ):
            parts.append(
                f"{name}: {seconds:.2f}s ({100 * seconds / total:.0f}%, "
                f"n={self.counts[name]})"
            )
        parts += [f"{name}: n={n}" for name, n in sorted(self.counts.items())
                  if name not in self.totals]
        if self._tracer.totals:
            parts.append("traced " + ", ".join(
                f"{name} {n}" for name, n in sorted(
                    self._tracer.totals.items())))
        return "; ".join(parts) if parts else "no stages recorded"

    def log_summary(self, prefix: str = "search profile") -> None:
        logger.info("%s: %s", prefix, self.summary())

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
        self.notes.clear()
        self._tracer.reset()


# Process-wide profiler used by the search engine.
profiler = StageProfiler()


def span(name: str):
    """A span named `name` while tracing is on, else `NO_SPAN`."""
    tracer = profiler.tracer
    return NO_SPAN if tracer is None else tracer.span(name)


def to_host(tensor: torch.Tensor) -> torch.Tensor:
    """`tensor.cpu()`: the batch path's one way to copy a tensor to the
    host.  While tracing is on, the copy is a ``host_copy`` span (the
    host waits there for the device's queue to drain) with its bytes,
    and counted (``host_copies``, ``host_bytes``)."""
    tracer = profiler.tracer
    if tracer is None:
        return tensor.cpu()
    n_bytes = tensor.numel() * tensor.element_size()
    with tracer.span("host_copy", bytes=n_bytes):
        out = tensor.cpu()
    tracer.count("host_copies")
    tracer.count("host_bytes", n_bytes)
    return out


def to_device(array, device, dtype=None) -> torch.Tensor:
    """`torch.as_tensor(array, dtype=dtype, device=device)`, counted while
    tracing is on where the data crosses from the host to a CUDA device
    (``device_copies``, ``device_bytes``)."""
    out = torch.as_tensor(array, dtype=dtype, device=device)
    tracer = profiler.tracer
    if tracer is not None and out.device.type == "cuda" and not (
            isinstance(array, torch.Tensor) and array.device == out.device):
        tracer.count("device_copies")
        tracer.count("device_bytes", out.numel() * out.element_size())
    return out


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str] = None) -> Iterator[None]:
    """Optionally capture a torch.profiler trace around a block.

    Enabled when `trace_dir` or ``ANN_SOLO_TORCH_TRACE_DIR`` is set: the
    block runs under `torch.profiler.profile` (CPU activity, and CUDA
    activity where PyTorch sees a GPU) with the tracer on, so the trace
    carries the program's ``ann_solo.`` spans, and its Chrome trace is
    written to ``trace_{n:05d}.json`` in the directory, `n` one more than
    the traces already there.  A no-op otherwise.
    """
    trace_dir = trace_dir or os.environ.get("ANN_SOLO_TORCH_TRACE_DIR")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof, profiler.tracing():
        yield
    os.makedirs(trace_dir, exist_ok=True)
    n = sum(name.startswith("trace_") and name.endswith(".json")
            for name in os.listdir(trace_dir))
    prof.export_chrome_trace(os.path.join(trace_dir, f"trace_{n:05d}.json"))
