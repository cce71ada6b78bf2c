"""Where kernel B5's time goes: cut-down builds of its source, timed on
one card in one process.

Each cut is a copy of `csrc/canonical_select.cu` that returns after one
stage of a row (pass 1 with the first radix search, pass 2 with the
second, the compaction of pass 3, the sort, the id gather, the dedup
table's inserts), after writing, or maybe writing, one value that
depends on every thread's work in that stage, so the compiler keeps the
stage.  The copies are compiled with the package's nvcc flags into
`build/kernels/select_breakdown/` and launched through the kernel's C
entry point on the same inputs as the full kernel, which is checked
against `canonical_select_plain` first.  A cut's time less the one
before it is what that stage adds to the kernel's time (a block that
returns early also frees its SM for the next row's loads sooner, so the
differences are a stage's share of the whole, not its time alone).

    python -m ann_solo_tpu_torch.tools.select_breakdown [--reps N]

Prints one line a case and cut, and one JSON line.  The card only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from ann_solo_tpu_torch.ops import _build, select_cuda
from ann_solo_tpu_torch.ops.canonical_select import (
    canonical_select,
    canonical_select_plain,
)

# (name, text in the source, code put before it).
CUTS = (
    ("pass1", "  for (int i = tid; i < kBins; i += kThreads) hist[i] = 0;\n"
              "  __syncthreads();\n\n  // Passes 2 and 3",
     "  if (tid == 0) out_i[0] = (int)high + need;\n  return;\n"),
    ("pass2", "  // Pass 3: the taken lanes to their slots",
     "  if (tid == 0) out_i[0] = (int)thresh + ties;\n  return;\n"),
    ("pass3", "  // Canonical order: key descending",
     "  __syncthreads();\n  if (tid == 0) out_i[0] = words[0] + words[1];\n"
     "  return;\n"),
    ("sort", "  // Each thread decodes a run of ranks",
     "  if (tid == 0) out_i[0] = words[0];\n  return;\n"),
    ("gather", "  if (!p.dedup) {  // k_eff <= k here\n#pragma unroll\n"
               "    for (int c = 0; c < 8; ++c) {",
     "  {\n    int sum = 0;\n"
     "    for (int c = 0; c < 8; ++c) sum += ident[c];\n"
     "    if (sum == 0x7fffffff) out_i[0] = sum;\n  }\n  return;\n"),
    ("insert", "  unsigned kept = 0u;\n#pragma unroll\n"
               "  for (int c = 0; c < 8; ++c) {",
     "  if (tid == 0) out_i[0] = table_ranks[0];\n  return;\n"),
)

# (name, B, L, P, cap, k_sel, k, redundant): the bench's rows and phase
# 10b's, as chip_smoke.py's SELECT_CASES has them.
CASES = (
    ("bench_k512", 4096, 4096, 512, 96, 1024, 512, True),
    ("stream_8m", 1024, 16384, 128, 768, 1024, 1024, False),
)


def cut_source(source: str, name: str) -> str:
    """The kernel source that returns after stage `name`."""
    for cut, marker, code in CUTS:
        if cut == name:
            if source.count(marker) != 1:
                raise ValueError(f"select_breakdown: the marker of {name} "
                                 "is not once in the source")
            at = source.index(marker)
            if name == "pass1":  # after the histogram reset's barrier
                at += marker.index("\n\n") + 1
            return source[:at] + code + source[at:]
    raise KeyError(name)


def _build_cut(name: str, source: str):
    out_dir = _build.BUILD_DIR / "select_breakdown"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / f"{name}.cu"
    src.write_text(source)
    lib = out_dir / f"lib{name}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    dll.canonical_select.restype = ctypes.c_int
    dll.canonical_select.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    return name, dll


def _inputs(gen, dev, b, l, p, cap, redundant):
    """Rows like the bench's: every id in two slots (x2) or one, 10% of
    the slots empty, 30% of the lanes masked, 257 score levels."""
    slots = l * cap
    if redundant:
        half = slots // 2
        ids = torch.cat([torch.randperm(half, generator=gen, device=dev),
                         torch.randperm(slots - half, generator=gen,
                                        device=dev) % half])
    else:
        ids = torch.randperm(slots, generator=gen, device=dev)
    empty = torch.rand(slots, generator=gen, device=dev) < 0.1
    padded = torch.where(empty, -1, ids).to(torch.int32).view(l, cap)
    probe = torch.sort(torch.rand((b, l), generator=gen, device=dev)
                       .topk(p, dim=1).indices, dim=1).values
    score = 0.2 + torch.randint(0, 257, (b, p * cap), generator=gen,
                                device=dev) / 512.0
    keep = torch.rand((b, p * cap), generator=gen, device=dev) >= 0.3
    lane_ids = padded[probe].view(b, p * cap)
    flat = torch.where((lane_ids >= 0) & keep, score.float(), float("-inf"))
    return flat.contiguous(), probe.contiguous(), padded


def _time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("select_breakdown: needs a CUDA device")
    dev = torch.device("cuda")
    source = (_build.CSRC_DIR / "canonical_select.cu").read_text()
    names = [name for name, _, _ in CUTS]
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(pool.map(lambda n: _build_cut(n, cut_source(source, n)),
                             names))
    gen = torch.Generator(device=dev)
    gen.manual_seed(2027)
    out = {"device": torch.cuda.get_device_name(0), "cases": {}}
    for name, b, l, p, cap, k_sel, k, redundant in CASES:
        flat, probe, padded = _inputs(gen, dev, b, l, p, cap, redundant)
        args_ = (flat, probe, padded, k_sel, k, redundant)
        got, want = canonical_select(*args_), canonical_select_plain(*args_)
        if not (torch.equal(got[0].view(torch.int32),
                            want[0].view(torch.int32))
                and torch.equal(got[1], want[1])):
            raise AssertionError(f"select_breakdown: B5 != plain at {name}")
        k_eff = select_cuda.check_limits(p * cap, k_sel, k)
        dedup = int(redundant or k_eff > k)
        out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
        out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
        times = {}
        for cut in names:
            lib = libs[cut]

            def launch(lib=lib):
                err = lib.canonical_select(
                    flat.data_ptr(), probe.data_ptr(), padded.data_ptr(),
                    out_s.data_ptr(), out_i.data_ptr(), b, p, l, cap, k_eff,
                    k, dedup, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"select_breakdown: {cut} failed "
                                       f"({err})")
            times[cut] = _time_ms(launch, args.reps)
        times["whole"] = _time_ms(lambda: canonical_select(*args_),
                                  args.reps)
        out["cases"][name] = times
        before = 0.0
        for cut, ms in times.items():
            print(f"{name} {cut}: {ms:.4f} ms (+{ms - before:.4f})",
                  flush=True)
            before = ms
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
