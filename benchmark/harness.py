"""One run of one cell: set-up, the measured window, the traced window,
the check, and the result line.

The window is a closed loop with one client, as the engine's open level
runs: the next batch of the pool goes to
`ann_open_search_batch` when the previous batch's answers are on the
host, with a stage-seconds dict passed as the engine passes one (the
device is synchronised at each stage's end).  Batches are started while
the window's seconds last; the window ends when the last one is back.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import os
import resource
import statistics
import subprocess
import sys
import time
import types
from typing import Dict, List, Optional

import numpy as np

from benchmark import check, tracing, workload
from benchmark.workload import BENCH_DIR

# Module names no process of the benchmark may hold once the window has
# closed (top-level names, compared whole).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "ann_solo_tpu")
TRACE_BATCHES = 24  # batches of the traced window
LABEL_BATCHES = 8  # batches of the pass that labels idle gaps by host span
VECTORIZE_ROWS = 65536  # library rows a vectorize call in set-up
KEEP_PER_BATCH = 16  # answers a batch keeps for the check's sample
STAGES = ("vectorize", "select", "rescore", "matches")


def parse_args(argv):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN_MODULES))


def load_reader(root: str, metric: str):
    """The `read(record)` function of a per-layer metric's file."""
    path = os.path.join(root, BENCH_DIR, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(spec: dict, cell: str, kind: str) -> List[dict]:
    """The cell's end-to-end or per-layer metrics."""
    return [m for m in spec[kind]
            if cell in m.get("workloads", [cell])]


def power_limit() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return proc.stdout.strip() or None


class Card:
    """The CUDA card a run measures: each batch timed by CUDA events
    around it, and the result line's `device`."""

    device = "cuda"

    @staticmethod
    def activities():
        """The profiler's activities that trace the device."""
        from torch.profiler import ProfilerActivity

        return [ProfilerActivity.CUDA]

    def mark(self):
        import torch

        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    @staticmethod
    def elapsed_ms(start, stop) -> float:
        return start.elapsed_time(stop)

    def synchronize(self) -> None:
        import torch

        torch.cuda.synchronize()

    def free(self) -> None:
        import torch

        torch.cuda.empty_cache()

    def info(self) -> dict:
        import torch

        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1,
                "memory_peak_bytes": torch.cuda.max_memory_allocated(),
                "power_limit": power_limit()}


class HostWatch:
    """What the host did over a stretch of the run: this process's CPU
    seconds, and the collections of Python's garbage collector and their
    seconds."""

    def __init__(self):
        self.gc_seconds, self._gc_start = 0.0, None
        gc.callbacks.append(self._on_gc)
        self.start = self._read()

    def _on_gc(self, phase, info):
        if phase == "start":
            self._gc_start = time.perf_counter()
        elif self._gc_start is not None:
            self.gc_seconds += time.perf_counter() - self._gc_start

    @staticmethod
    def _read():
        usage = resource.getrusage(resource.RUSAGE_SELF)
        return (usage.ru_utime + usage.ru_stime,
                sum(s["collections"] for s in gc.get_stats()))

    def report(self, wall: float) -> str:
        gc.callbacks.remove(self._on_gc)
        cpu, collections = (b - a for a, b in zip(self.start, self._read()))
        return (f"{cpu:.3f} cpu s of {wall:.3f}, {collections} gc "
                f"collections in {self.gc_seconds:.3f} s")


@dataclasses.dataclass
class Cell:
    """A cell's set-up: the program's objects and the inputs."""

    cfg: dict
    traffic: dict
    lib: workload.Library
    pool: list
    search: object  # (batch, stage seconds) -> the entry's answers
    state: list  # the program's objects, freed before the check
    keep: dict  # "rows" whose candidates the select keeps, "cands" them


def set_up(cfg: dict, traffic: dict, seed: int, platform) -> Cell:
    import torch

    from ann_solo_tpu_torch.index.ivf import IvfIndex
    from ann_solo_tpu_torch.models.vectorize import (
        VectorizeParams,
        device_tables,
        vectorize_batch,
    )
    from ann_solo_tpu_torch.search import (
        LibraryBlock,
        OpenSearchParams,
        ann_open_search_batch,
    )

    dev = torch.device(platform.device)
    marks = [time.perf_counter()]

    def mark():
        platform.synchronize()
        marks.append(time.perf_counter())

    gen = torch.Generator(device=dev)
    gen.manual_seed(check.seed_key(seed))
    mark()
    lib = workload.make_library(gen, cfg, dev)
    mark()
    params = OpenSearchParams(
        vectorize=VectorizeParams(
            float(cfg["min_mz"]), float(cfg["max_mz"]),
            float(cfg["bin_size"]), int(cfg["hash_len"])),
        num_candidates=int(cfg["num_candidates"]),
        precursor_tolerance_mass_open=float(
            cfg["precursor_tolerance_mass_open"]),
        precursor_tolerance_mode_open=str(
            cfg["precursor_tolerance_mode_open"]),
        fragment_mz_tolerance=float(cfg["fragment_mz_tolerance"]),
        allow_peak_shifts=bool(cfg["allow_peak_shifts"]),
    )
    n, k = lib.mz.shape
    tables = device_tables(params.vectorize, dev)
    n_peaks = torch.full((n,), k, dtype=torch.int32, device=dev)
    vectors = torch.cat([
        vectorize_batch(params.vectorize, tables,
                        lib.mz[s:s + VECTORIZE_ROWS],
                        lib.intensity[s:s + VECTORIZE_ROWS],
                        n_peaks[s:s + VECTORIZE_ROWS])
        for s in range(0, n, VECTORIZE_ROWS)])
    mark()
    settings = types.SimpleNamespace(
        num_list=int(cfg["num_list"]), num_probe=int(cfg["num_probe"]),
        ivf_redundancy=int(cfg["ivf_redundancy"]),
        soar_lambda=float(cfg["soar_lambda"]))
    storage = {"int8": torch.int8, "bf16": torch.bfloat16,
               "f32": torch.float32}[cfg["index_dtype"]]
    index = IvfIndex.build(vectors, settings,
                           precursor_mz=lib.prec.to(torch.float32),
                           storage_dtype=storage, device=dev)
    del vectors, n_peaks
    keep = {"rows": None, "last": 0, "cands": None}

    def select(*args, **kwargs):
        # The select's candidates of the rows the check keeps: one gather
        # on the device, read once the window has closed.  Looked up on
        # the class, so that the traced run's span around it holds.
        ids, scores = type(index).search_device(index, *args, **kwargs)
        if keep["rows"] is not None and ids.shape[0] > keep["last"]:
            keep["cands"] = ids.index_select(0, keep["rows"])
        return ids, scores

    index.search_device = select
    mark()
    block = LibraryBlock(lib.mz, lib.intensity, lib.ann,
                         lib.prec.to(torch.float32))
    pool = workload.make_pool(gen, lib, cfg, traffic)
    mark()
    q_n = np.full(int(traffic["batch"]), k, np.int32)
    charge = int(cfg["charge"])

    def search(batch, stages):
        return ann_open_search_batch(
            index, block, batch.mz, batch.intensity, torch.from_numpy(q_n),
            batch.prec, charge, params, stage_seconds=stages)

    # The warm-up gathers kept rows' candidates too, as the window does,
    # so that no kernel of the window is loaded inside it.
    keep.update(rows=torch.arange(KEEP_PER_BATCH, device=dev),
                last=KEEP_PER_BATCH - 1)
    for i in range(int(traffic["warmup_batches"])):
        search(pool[i % len(pool)], {})
    keep.update(rows=None, cands=None)
    mark()
    steps = np.diff(marks)
    log("set-up seconds: device start {:.3f}, library {:.3f}, vectorize "
        "{:.3f}, IVF build {:.3f}, pool {:.3f}, warm-up {:.3f}".format(*steps))
    return Cell(cfg, traffic, lib, pool, search, [index, block], keep)


@dataclasses.dataclass
class Window:
    n_batches: int
    seconds: float
    batch_ms: List[float]
    stage_seconds: Dict[str, float]
    failed: int
    answers: List[check.Answer]


def measure(cell: Cell, seed: int, seconds: float, platform) -> Window:
    """The closed loop over the pool for `seconds`, each batch timed by
    the platform's marks around it."""
    import torch

    dev = cell.lib.mz.device
    pool, b = cell.pool, int(cell.traffic["batch"])
    stages: Dict[str, float] = {}
    per_batch: List[List[float]] = []
    answers: List[check.Answer] = []
    marks, failed, k = [], 0, 0
    watch = HostWatch()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while k == 0 or time.perf_counter() < deadline:
        i = k % len(pool)
        rows = check.keep_rows(seed, k, b, KEEP_PER_BATCH)
        # The device is idle here: the previous batch's answers are back.
        cell.keep.update(rows=torch.as_tensor(rows, device=dev),
                         last=int(rows.max()), cands=None)
        start = platform.mark()
        out = cell.search(pool[i], stages)
        stop = platform.mark()
        marks.append((start, stop))
        per_batch.append([stages.get(s, 0.0) for s in STAGES])
        failed += int(np.count_nonzero(out[0] < 0))
        check.keep(answers, out, i, rows, cell.keep["cands"])
        k += 1
    platform.synchronize()
    window_s = time.perf_counter() - t0
    cell.keep.update(rows=None, cands=None)
    batch_ms = [platform.elapsed_ms(s, e) for s, e in marks]
    ms = np.asarray(batch_ms)
    log(f"window host: {watch.report(window_s)}")
    log(f"window: {k} batches in {window_s:.3f} s; batch ms mean "
        f"{ms.mean():.3f}, median {np.median(ms):.3f}, max {ms.max():.3f}, "
        f"first {np.round(ms[:4], 3).tolist()}; stage seconds {stages}")
    steps = 1e3 * np.diff(np.asarray([[0.0] * len(STAGES)] + per_batch),
                          axis=0)
    log("window stage ms a batch (p10 / median / p90): " + ", ".join(
        f"{s} {np.percentile(steps[:, j], 10):.3f} / "
        f"{np.median(steps[:, j]):.3f} / {np.percentile(steps[:, j], 90):.3f}"
        for j, s in enumerate(STAGES)))
    thirds = np.array_split(ms, 3)
    log("window batch ms mean by third: " + ", ".join(
        f"{t.mean():.3f}" for t in thirds if len(t)))
    return Window(k, window_s, batch_ms, stages, failed, answers)


def _profiled(cell: Cell, platform, n_batches: int, activities,
              recorder: tracing.Recorder):
    """`n_batches` batches under the profiler with the spans and launch
    records of `tracing.instrumented`; (profile, host seconds)."""
    import torch
    from torch.profiler import profile

    with tracing.instrumented(recorder), profile(
            activities=activities) as prof:
        with torch.profiler.record_function(tracing.WINDOW_SPAN):
            platform.synchronize()
            t0 = time.perf_counter()
            for i in range(n_batches):
                cell.search(cell.pool[i % len(cell.pool)], {})
            platform.synchronize()
            seconds = time.perf_counter() - t0
    return prof, seconds


def trace(cell: Cell, platform, n_batches: int) -> tracing.TraceRecord:
    """The traced window: `n_batches` batches with the device's activity
    alone traced (busy time, kernel times, launch records), then
    `LABEL_BATCHES` more with the host's too, whose spans label the
    device's idle gaps.  The first pass leaves the host's own events out,
    so the profiler's host cost does not count as idle time."""
    from torch.profiler import ProfilerActivity

    device_only = platform.activities()
    recorder = tracing.Recorder()
    prof, seconds = _profiled(cell, platform, n_batches, device_only,
                              recorder)
    _, device_ops, _ = tracing.read_profile(prof)
    labels, label_s = _profiled(
        cell, platform, LABEL_BATCHES,
        sorted({ProfilerActivity.CPU, *device_only}, key=int),
        tracing.Recorder())
    log(f"traced: {n_batches} batches in {seconds:.3f} s with the device "
        f"traced, {LABEL_BATCHES} in {label_s:.3f} s with the host too")
    record = tracing.TraceRecord(0, {}, 0.0, n_batches, seconds, device_ops,
                                 tracing.read_profile(labels))
    tracing.count_work(recorder, record)
    return record


def run_cell(root: str, workload_name: str, seed: int, seconds: float,
             traced: bool, platform, t_start: float) -> dict:
    """Set-up, window, traced window and check of one cell; the result
    line's object."""
    spec = workload.load_spec(root)
    entry = workload.find_cell(spec, workload_name)
    cfg = workload.load_config(root, spec, entry["config"])
    traffic = workload.load_traffic(root, entry["traffic"])
    limits = workload.load_limits(root, workload_name)
    log(f"set-up seconds before the cell's own: "
        f"{time.perf_counter() - t_start:.3f}")
    cell = set_up(cfg, traffic, seed, platform)
    setup_s = time.perf_counter() - t_start
    win = measure(cell, seed, seconds, platform)
    result = {"correct": False, "attempted": win.n_batches * int(
        traffic["batch"]), "failed": win.failed}
    if traced:
        record = trace(cell, platform, TRACE_BATCHES)
        record.n_batches, record.stage_seconds = win.n_batches, \
            win.stage_seconds
        record.measured_s = win.seconds
        values = {}
        for m in cell_metrics(spec, workload_name, "per_layer"):
            value = load_reader(root, m["name"])(record)
            if value is not None:
                values[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = values
        result["breakdown"] = tracing.breakdown(record)
    else:
        e2e = {
            "queries_per_s": win.n_batches * int(traffic["batch"])
            / win.seconds,
            "batch_ms_p95": statistics.quantiles(
                win.batch_ms, n=20, method="inclusive")[-1]
            if len(win.batch_ms) > 1 else win.batch_ms[0],
            "setup_s": setup_s,
        }
        result["metrics"] = {
            m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
            for m in cell_metrics(spec, workload_name, "end_to_end")}
    result["device"] = platform.info()
    if traced:
        result["device"].update(busy_s=tracing.busy_seconds(record),
                                window_s=record.window_s)
    # The program's state goes before the reference runs.
    del cell.state[:], cell.search
    platform.free()
    t_check = time.perf_counter()
    numbers = check.compare(check.draw_sample(seed, win.answers,
                                              int(limits["sample"])),
                            cell.pool, cell.lib, cfg, seed,
                            int(limits["rescore_sample"]))
    result["correct"] = check.verdict(numbers, limits["limits"])
    log(f"run seconds: {time.perf_counter() - t_start:.3f} (set-up "
        f"{setup_s:.3f}, check {time.perf_counter() - t_check:.3f})")
    result["checks"] = {
        name: {"value": numbers[name], "limit": limit}
        for name, limit in limits["limits"].items()}
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse_args(argv)
    import torch

    spec = workload.load_spec(workload.ROOT)
    entry = workload.find_cell(spec, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(entry["chips"]):
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(workload.ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), Card(), t_start)
    found = forbidden_modules()
    if found:
        print(f"the run imported {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
