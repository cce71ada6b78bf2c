"""The program's own trace of a traced run, and a check of what it costs.

The port's tracer (`ann_solo_tpu_torch.utils.profiling`) traces every
batch that `ann_open_search_batch` runs while a `torch.profiler` profile
is active, so both passes of `harness.trace` leave their batches with it:
spans by name (``matches.rows``, ``host_copy``, ``sync``, ...) and
counters (``host_copies``, ...).  `batches(record)` takes them from the
program once a run and keeps the first `record.traced_batches` (the pass
that traces the device alone) as each span name's seconds and each
counter.  A program without the tracer, or a traced pass with no device
operation (the CPU stand-in of the tests, where no copy crosses to a
host), gives nothing.

Run as a script on the card, it checks one cell's traced passes with the
program's tracing on and off:

    python3 benchmark/program_trace.py --workload <cell> --seed <n> \\
        [--batches 24] [--rounds 2]

- the device operations of each pass, by name and count a batch, with the
  tracer off and on (the existing metrics read these);
- the cost of tracing: ms a batch of the device-only pass, off and on,
  alternated over `--rounds` rounds, and the microseconds a span costs;
- the labelling pass's idle seconds by the innermost program span around
  each gap (``ann_solo.<name>``, on the profiler's clock);
- the host's synchronizations of one batch under
  `torch.cuda.set_sync_debug_mode("warn")`, by the program's line that
  made them.

It prints one JSON line.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time
import traceback
import warnings
from typing import Dict, List

# The record the batches were last taken for, and them.
_taken: list = [None, []]


def _summary(batch) -> dict:
    seconds: Dict[str, float] = collections.defaultdict(float)
    for s in batch.spans:
        seconds[s.name] += (s.end_ns - s.start_ns) / 1e9
    return {"seconds": dict(seconds), "counters": dict(batch.counters)}


def batches(record) -> List[dict]:
    """The program's batches of the device-only traced pass, as numbers;
    [] where there are none to read."""
    if _taken[0] is not record:
        try:
            from ann_solo_tpu_torch.utils.profiling import profiler
        except ImportError:
            profiler = None
        take = getattr(profiler, "take", None)
        got = [b for b in (take() if take else [])
               if b.spans and b.spans[0].name == "batch"]
        n = record.traced_batches
        _taken[:] = [record, [_summary(b) for b in got[:n]]
                     if n and len(got) >= n and record.device_ops else []]
    return _taken[1]


def mean_seconds(record, *names: str):
    """Mean seconds a batch in the spans named `names`; None where the
    program's trace has none of them."""
    got = batches(record)
    if not got or not any(n in b["seconds"] for b in got for n in names):
        return None
    return sum(b["seconds"].get(n, 0.0) for b in got
               for n in names) / len(got)


def mean_counter(record, name: str):
    """Mean of counter `name` a batch; None where nothing was traced."""
    got = batches(record)
    if not got:
        return None
    return sum(b["counters"].get(name, 0) for b in got) / len(got)


# The check on the card.


def _ops_by_name(device_ops, n_batches: int) -> Dict[str, float]:
    count = collections.Counter(name for name, _, _ in device_ops)
    return {name: c / n_batches for name, c in sorted(count.items())}


def _leaf_idle(prof, prefix: str) -> Dict[str, float]:
    """Idle seconds of a profile's device, by the innermost host span
    named with `prefix` around each gap's middle (else "outside")."""
    from torch.autograd import DeviceType

    from benchmark import tracing

    window, ops, spans = None, [], []
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False) and not \
                    e.name.startswith((prefix, tracing.SPAN_PREFIX)):
                ops.append((start, end))
        elif e.name == tracing.WINDOW_SPAN:
            window = (start, end)
        elif e.name.startswith(prefix):
            spans.append((e.name[len(prefix):], start, end))
    out: Dict[str, float] = collections.defaultdict(float)
    if window is None:
        return {}
    w0, w1 = window
    at = w0
    gaps = []
    for s, e in tracing.union((max(s, w0), min(e, w1)) for s, e in ops
                              if e > w0 and s < w1):
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if w1 > at:
        gaps.append((at, w1))
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        inside = [(e - s, name) for name, s, e in spans if s <= mid <= e]
        out[min(inside)[1] if inside else "outside"] += (g1 - g0) / 1e6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _sync_sites(cell, root: str, card) -> Dict[str, int]:
    """The program's lines that synchronized the host with the device in
    one batch (with stage seconds, as the window runs it)."""
    import torch

    sites: Dict[str, int] = collections.defaultdict(int)
    shown = warnings.showwarning

    def show(message, category, filename, lineno, file=None, line=None):
        frames = [f for f in traceback.extract_stack()
                  if "ann_solo_tpu_torch" in f.filename]
        where = (f"{os.path.relpath(frames[-1].filename, root)}:"
                 f"{frames[-1].lineno} {frames[-1].name}" if frames
                 else "outside the program")
        sites[f"{where}: {str(message).splitlines()[0][:80]}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            cell.search(cell.pool[0], {})
            card.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            warnings.showwarning = shown
    return dict(sites)


def _span_cost(profiler, device_only, both, n: int = 35 * 24 * 25) -> dict:
    """Microseconds a span site costs: tracing off; on; on under a
    profile of the device alone; on under one of the host too.  Spans
    come as a traced pass has them: batches of 35 (a root and 34
    leaves), taken every 24 batches."""
    from ann_solo_tpu_torch.utils.profiling import span
    from torch.profiler import profile

    def off():
        t = time.perf_counter()
        for _ in range(n):
            with span("sync"):
                pass
        return 1e6 * (time.perf_counter() - t) / n

    def on():
        with profiler.tracing() as tracer:
            t = time.perf_counter()
            for i in range(n // 35):
                with tracer.span("batch"):
                    for _ in range(34):
                        with tracer.span("sync"):
                            pass
                if i % 24 == 23:
                    profiler.take()
            seconds = time.perf_counter() - t
        profiler.take()
        return 1e6 * seconds / n

    out = {"off": off(), "on": on()}
    with profile(activities=device_only):
        out["on_device_profile"] = on()
    with profile(activities=both):
        out["on_host_profile"] = on()
    return out


def main(argv=None, root=None, card=None) -> int:
    """The check of one cell (`root`: the checkout; `card`: the platform,
    `harness.Card` by default)."""
    from torch.profiler import ProfilerActivity

    from ann_solo_tpu_torch.utils.profiling import SPAN_PREFIX, profiler
    from benchmark import harness, tracing, workload

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--batches", type=int, default=24)
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args(argv)
    spec = workload.load_spec(root)
    entry = workload.find_cell(spec, args.workload)
    cfg = workload.load_config(root, spec, entry["config"])
    traffic = workload.load_traffic(root, entry["traffic"])
    card = card or harness.Card()
    cell = harness.set_up(cfg, traffic, args.seed, card)
    device_only = card.activities()
    both = sorted({ProfilerActivity.CPU, *device_only}, key=int)
    out = {"workload": args.workload, "seed": args.seed,
           "card": card.info().get("power_limit"),
           "batches": args.batches}

    def passes(follow: bool, activities, n: int):
        profiler.follow_profiler = follow
        try:
            profiler.take()
            prof, seconds = harness._profiled(cell, card, n, activities,
                                              tracing.Recorder())
            return prof, seconds, profiler.take()
        finally:
            profiler.follow_profiler = True

    ms = {"off": [], "on": []}
    ops = {"off": [], "on": []}
    for _ in range(args.rounds):
        for mode in ("off", "on"):
            prof, seconds, traced = passes(mode == "on", device_only,
                                           args.batches)
            ms[mode].append(1e3 * seconds / args.batches)
            ops[mode].append(_ops_by_name(tracing.read_profile(prof)[1],
                                          args.batches))
            if mode == "on":
                program = traced[:args.batches]
    out["device_pass_ms_a_batch"] = ms
    rounds = ops["off"] + ops["on"]
    out["device_ops_same"] = all(r == rounds[0] for r in rounds)
    out["device_ops_off_rounds_same"] = all(r == ops["off"][0]
                                            for r in ops["off"])
    out["device_ops_differ"] = {
        name: {m: [r.get(name, 0) for r in ops[m]] for m in ops}
        for name in sorted({k for r in rounds for k in r})
        if len({r.get(name, 0) for r in rounds}) > 1}
    out["span_us"] = _span_cost(profiler, device_only, both)
    names = sorted({s.name for b in program for s in b.spans})
    out["program_ms_a_batch"] = {
        name: 1e3 * sum(b.seconds(name) for b in program) / len(program)
        for name in names}
    counters = sorted({k for b in program for k in b.counters})
    out["program_counters_a_batch"] = {
        k: sum(b.counters.get(k, 0) for b in program) / len(program)
        for k in counters}
    out["program_counters_by_batch"] = {
        k: [b.counters.get(k, 0) for b in program]
        for k in ("host_copies", "rescore.t32.rows", "rescore.full.rows")}
    labels = {}
    for mode in ("off", "on"):
        prof, seconds, _ = passes(mode == "on", both,
                                  harness.LABEL_BATCHES)
        window, device, spans = tracing.read_profile(prof)
        labels[mode] = {
            "ms_a_batch": 1e3 * seconds / harness.LABEL_BATCHES,
            "ops": _ops_by_name(device, harness.LABEL_BATCHES),
            "bench_spans": collections.Counter(n for n, _, _ in spans),
        }
        if mode == "on":
            out["idle_s_by_program_span"] = _leaf_idle(prof, SPAN_PREFIX)
            out["idle_s_by_bench_span"] = _leaf_idle(prof,
                                                     tracing.SPAN_PREFIX)
    out["label_pass_ms_a_batch"] = {m: labels[m]["ms_a_batch"]
                                    for m in labels}
    out["label_ops_same"] = labels["off"]["ops"] == labels["on"]["ops"]
    out["label_bench_spans_same"] = (labels["off"]["bench_spans"]
                                     == labels["on"]["bench_spans"])
    out["sync_sites"] = _sync_sites(cell, root, card)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[0] = ROOT
    rc = main(root=ROOT)
    print(f"program_trace seconds: {time.perf_counter() - t0:.1f}",
          file=sys.stderr)
    sys.exit(rc)
