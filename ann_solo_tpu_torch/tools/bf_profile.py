"""Stage breakdown of the brute-force (bf) cascade on a QUALITY workdir.

The port of the repo's `tools/bf_profile.py`.  One bf search over the
first N queries of a workdir that `quality.py` wrote (`library.splib`,
`queries.mgf`), with the JAX tool's settings, attributes wall time to:

* window rescoring (`SpectralLibrary._rescore_window_ranges`), the std
  and the open level apart, with each level's calls and (query, library
  row) pairs;
* best-pair match extraction (`search.best_pair_matches`), calls and
  pairs;
* everything else (IO, preprocessing, SSM assembly, FDR).

With ``--trace DIR`` the search runs a second time with every rescoring
call under `utils.profiling.device_trace` (one Chrome trace a call in
DIR), and the device time of the traces is summed by kernel: the greedy
shifted-dot kernel B1 and the stage-1 bound kernel B4 against every
other kernel inside rescoring (stage 2's selection, plain PyTorch).  The
profiler slows what it traces: take shares from the traced run, seconds
from the untraced one.

    python -m ann_solo_tpu_torch.tools.bf_profile <workdir> [n_queries]
        [--trace DIR] [--no_gpu]

The sliced queries are written to `<workdir>/bf_profile_queries.mgf`.
Runs on the CUDA GPU and raises without one, unless ``--no_gpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import logging
import os
import sys
import time
from typing import Dict, Optional

import numpy as np

B1_KERNEL = "shifted_dot_greedy_kernel"  # csrc/shifted_dot.cu
B4_KERNEL = "stage1_bounds_kernel"  # csrc/stage1_bounds.cu
# Chrome-trace categories of device activity.
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class Settings:
    """The JAX tool's search settings (its class `P`)."""

    open_tolerance = 300.0
    model = "none"
    num_list = 0
    num_probe = 256
    num_candidates = 1024
    index_dtype = "bf16"
    fdr = 0.01

    def __init__(self, no_gpu: bool = False):
        self.no_gpu = no_gpu


def slice_queries(src: str, dst: str, n_queries: int) -> int:
    """Copy the first `n_queries` spectra of the MGF file `src` to `dst`;
    returns how many were copied."""
    n_copied, block = 0, []
    with open(src) as fin, open(dst, "w") as fout:
        for line in fin:
            block.append(line)
            if line.startswith("END IONS"):
                fout.writelines(block)
                block = []
                n_copied += 1
                if n_copied >= n_queries:
                    break
    return n_copied


@contextlib.contextmanager
def _instrumented(stats: Dict[str, list]):
    """The search module with window rescoring, best-pair matches and the
    cascade levels wrapped: seconds, calls and pairs accumulate in
    `stats` under "<level> window_rescore" and "best_pair_matches"."""
    from ann_solo_tpu_torch import search

    lib_cls = search.SpectralLibrary
    orig_win = lib_cls._rescore_window_ranges
    orig_cascade = lib_cls._search_cascade
    orig_match = search.best_pair_matches
    level = ["std"]

    def add(name, seconds, pairs):
        entry = stats.setdefault(name, [0.0, 0, 0])
        entry[0] += seconds
        entry[1] += 1
        entry[2] += pairs

    def cascade(self, query_spectra, mode):
        level[0] = mode
        return orig_cascade(self, query_spectra, mode)

    def window(self, q_mz, q_int, q_prec, lib, lo, hi, charge):
        t0 = time.perf_counter()
        out = orig_win(self, q_mz, q_int, q_prec, lib, lo, hi, charge)
        # Host arrays come back: the device work is done.
        add(f"{level[0]} window_rescore", time.perf_counter() - t0,
            int(np.sum(np.asarray(hi) - np.asarray(lo))))
        return out

    def matches(lib, q_mz, q_int, q_prec, rows, cand_idx, charge, params):
        t0 = time.perf_counter()
        out = orig_match(lib, q_mz, q_int, q_prec, rows, cand_idx, charge,
                         params)
        add("best_pair_matches", time.perf_counter() - t0, len(rows))
        return out

    lib_cls._rescore_window_ranges = window
    lib_cls._search_cascade = cascade
    search.best_pair_matches = matches
    try:
        yield
    finally:
        lib_cls._rescore_window_ranges = orig_win
        lib_cls._search_cascade = orig_cascade
        search.best_pair_matches = orig_match


def _search(lib_path: str, query_path: str, device, stats):
    """One bf search through the port's engine; (init seconds, search
    seconds, SSMs, the stage profiler's totals)."""
    from ann_solo_tpu_torch.search import SpectralLibrary
    from ann_solo_tpu_torch.utils.profiling import profiler

    profiler.reset()
    with _instrumented(stats):
        t0 = time.perf_counter()
        library = SpectralLibrary(lib_path, device=device)
        t_init = time.perf_counter() - t0
        try:
            t0 = time.perf_counter()
            ssms = library.search(query_path)
            t_search = time.perf_counter() - t0
        finally:
            library.shutdown()
    return t_init, t_search, len(ssms), dict(profiler.totals)


def kernel_seconds(trace_dir: str) -> Dict[str, float]:
    """Device seconds by kernel name summed over the Chrome traces
    (`trace_*.json`) in `trace_dir`."""
    by_name: Dict[str, float] = {}
    for path in sorted(glob.glob(os.path.join(trace_dir, "trace_*.json"))):
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATEGORIES:
                by_name[e["name"]] = (by_name.get(e["name"], 0.0)
                                      + e.get("dur", 0.0) / 1e6)
    return by_name


def profile(workdir: str, n_queries: int = 2048, no_gpu: bool = False,
            trace_dir: Optional[str] = None) -> dict:
    """The breakdown as a dict (on the GPU, or the CPU with `no_gpu`);
    with `trace_dir`, also the traced run's device seconds of B1, of B4
    and of the other kernels inside rescoring."""
    from ann_solo_tpu_torch.config import config
    from ann_solo_tpu_torch.quality import _cli_args

    query_path = os.path.join(workdir, "bf_profile_queries.mgf")
    n_copied = slice_queries(os.path.join(workdir, "queries.mgf"),
                             query_path, n_queries)
    lib_path = os.path.join(workdir, "library.splib")
    device = "cpu" if no_gpu else None
    config.parse(_cli_args(lib_path, query_path, "unused", "bf",
                           Settings(no_gpu)))
    stats: Dict[str, list] = {}
    t_init, t_search, n_ssms, totals = _search(lib_path, query_path, device,
                                               stats)
    out = {
        "n_queries": n_copied,
        "init_sec": t_init,
        "search_sec": t_search,
        "n_ssms": n_ssms,
        "legs": {name: {"sec": sec, "calls": calls, "pairs": pairs}
                 for name, (sec, calls, pairs) in stats.items()},
        "stages_sec": {name: totals[name] for name in totals
                       if name.endswith("window rescoring")},
        "other_sec": t_search - sum(v[0] for v in stats.values()),
    }
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        for old in glob.glob(os.path.join(trace_dir, "trace_*.json")):
            os.remove(old)
        previous = os.environ.get("ANN_SOLO_TORCH_TRACE_DIR")
        os.environ["ANN_SOLO_TORCH_TRACE_DIR"] = trace_dir
        try:
            traced_stats: Dict[str, list] = {}
            _, t_traced, _, _ = _search(lib_path, query_path, device,
                                        traced_stats)
        finally:
            if previous is None:
                del os.environ["ANN_SOLO_TORCH_TRACE_DIR"]
            else:
                os.environ["ANN_SOLO_TORCH_TRACE_DIR"] = previous
        by_name = kernel_seconds(trace_dir)
        b1 = sum(v for k, v in by_name.items() if B1_KERNEL in k)
        b4 = sum(v for k, v in by_name.items() if B4_KERNEL in k)
        total = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        out["trace"] = {
            "dir": trace_dir,
            "n_traces": len(glob.glob(os.path.join(trace_dir,
                                                   "trace_*.json"))),
            "search_sec_traced": t_traced,
            "device_sec": total,
            "b1_sec": b1,
            "b4_sec": b4,
            "other_kernels_sec": total - b1 - b4,
            "b1_share": b1 / total if total else None,
            "b4_share": b4 / total if total else None,
            "top_kernels_sec": [[k[:90], v] for k, v in top],
        }
    return out


def print_table(out: dict) -> None:
    """The JAX tool's table, the window leg split by level."""
    print(f"\ninit(store load): {out['init_sec']:.1f}s")
    t_search, n = out["search_sec"], out["n_queries"]
    print(f"search total: {t_search:.1f}s for {n} queries "
          f"({n / t_search:.0f} q/s), {out['n_ssms']} SSMs")
    for name, leg in out["legs"].items():
        rate = leg["pairs"] / leg["sec"] / 1e6 if leg["sec"] else 0.0
        print(f"  {name:<22} {leg['sec']:7.1f}s  calls={leg['calls']:<4d} "
              f"pairs={leg['pairs'] / 1e6:8.1f}M  ({rate:.2f}M pairs/s)")
    print(f"  {'other (IO/host/FDR)':<22} {out['other_sec']:7.1f}s")
    if "trace" in out:
        tr = out["trace"]
        print(f"traced rescoring ({tr['n_traces']} traces): device "
              f"{tr['device_sec']:.3f}s, B1 {tr['b1_sec']:.3f}s "
              f"({100 * (tr['b1_share'] or 0):.3g}%), B4 {tr['b4_sec']:.3f}s "
              f"({100 * (tr['b4_share'] or 0):.3g}%), other kernels "
              f"{tr['other_kernels_sec']:.3f}s")


def main(args=None) -> int:
    parser = argparse.ArgumentParser(
        description="Stage breakdown of the bf cascade on a QUALITY workdir")
    parser.add_argument("workdir", nargs="?", default=".quality_r04")
    parser.add_argument("n_queries", nargs="?", type=int, default=2048)
    parser.add_argument("--trace", default=None, metavar="DIR",
                        help="also trace each rescoring call into DIR "
                        "(its trace_*.json files are replaced) and sum the "
                        "kernels' device time")
    parser.add_argument("--no_gpu", action="store_true",
                        help="run on the CPU (the kernels' plain versions)")
    parsed = parser.parse_args(args)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    out = profile(parsed.workdir, parsed.n_queries, parsed.no_gpu,
                  parsed.trace)
    print(f"{out['n_queries']} queries sliced", file=sys.stderr)
    print_table(out)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
