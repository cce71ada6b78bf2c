"""Kernel B1 timed on the card, for comparisons (wide cases by default).

Runs `shifted_dot_cuda.shifted_dot_full` on cases of `chip_smoke.py`'s
phase 3 (`KERNEL_CASES`, its pair generators; by default the wide
branch's, K > 128, and any of the register branch's by name), checks
each against `shifted_dot_full_plain` bit for bit, and times it two
ways: a call through the wrapper (`time_ms`, the host's launch
included) and the kernel alone, its calls captured in a CUDA graph
(`time_graph_ms`).  Options:

* ``--root DIR`` imports `ann_solo_tpu_torch` from another checkout (a
  parent commit unpacked with ``git archive``, say), so that two
  versions are timed on the same cases by the same clocks; the cases and
  the timers are always this checkout's;
* ``--no_list`` builds this checkout's `csrc/shifted_dot.cu` with the
  on-chip list turned off (its cap 0), so that every pair with a
  positive entry takes the overflow path, and routes the wrapper's
  launches through that build.

    python ann_solo_tpu_torch/tools/b1_wide_ab.py [--root DIR] [--no_list]
        [--cases k129,k300,...] [--reps 20]

Prints one JSON line: the card's name and power limit, the variant and
each case's shape and times.  Needs the CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
DEFAULT_CASES = ("k129", "k300", "k1024", "dense_k200", "k300_chunk")
# The line of the source that sets the list's cap, and the no-list build's.
LIST_CAP = ("const int list_cap = !kGlobal || k <= kWideKeyPeaks ? "
            "kWideList : 0;")
NO_LIST_CAP = "const int list_cap = 0;"


def _chip_smoke():
    """This checkout's `chip_smoke.py` as a module."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _route_no_list(shifted_dot_cuda):
    """Build the source with the list's cap 0 into `build/kernels/ab/` and
    make the wrapper load that library."""
    from ann_solo_tpu_torch.ops import _build

    source = (_build.CSRC_DIR / "shifted_dot.cu").read_text()
    if source.count(LIST_CAP) != 1:
        raise SystemExit(f"b1_wide_ab: the source has no line {LIST_CAP!r}")
    out = _build.BUILD_DIR / "ab"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / "shifted_dot_no_list.cu"
    cu.write_text(source.replace(LIST_CAP, NO_LIST_CAP))
    so = out / "libshifted_dot_no_list.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"b1_wide_ab: nvcc failed:\n{proc.stderr}")
    library = ctypes.CDLL(str(so))
    load = _build.load
    _build.load = lambda name: library if name == "shifted_dot" else load(name)
    shifted_dot_cuda._library.cache_clear()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(REPO))
    parser.add_argument("--no_list", action="store_true")
    parser.add_argument("--cases", default=",".join(DEFAULT_CASES))
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))

    import numpy as np
    import torch

    from ann_solo_tpu_torch.ops import shifted_dot_cuda

    cs = _chip_smoke()
    if args.no_list:
        _route_no_list(shifted_dot_cuda)
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    cases = {c[0]: c for c in cs.KERNEL_CASES}
    out = []
    for name in args.cases.split(","):
        _, p, kq, kc, charge, shift, ties, tol, *rest = cases[name]
        rng = np.random.default_rng(sum(map(ord, name)))
        pairs = cs.synth_pairs(rng, p, kq, kc, charge, ties)
        if rest:
            cs.b1_variant(rng, pairs, rest[0], tol, charge)
        arrays = [torch.from_numpy(a).to(dev) for a in pairs]
        padded = shifted_dot_cuda.pad_peaks(*arrays[:5])
        call = (*padded, *arrays[5:], tol, charge + 1, shift)
        k = padded[0].shape[1]
        total, match = shifted_dot_cuda.shifted_dot_full(*call)
        want_total, want_match = cs.b1_plain(
            call, max(1, cs.PLAIN_PAIR_ENTRIES // (k * k)))
        if not (torch.equal(total.view(torch.int32),
                            want_total.view(torch.int32))
                and torch.equal(match, want_match)):
            raise SystemExit(f"b1_wide_ab: {name} differs from the plain "
                             "version")
        out.append({
            "name": name, "pairs": p, "k": k,
            "call_ms": cs.time_ms(
                lambda: shifted_dot_cuda.shifted_dot_full(*call), dev,
                args.reps),
            "kernel_ms": cs.time_graph_ms(
                lambda: shifted_dot_cuda.shifted_dot_full(*call), dev,
                args.reps),
        })
    print(json.dumps({"device": smi, "root": args.root,
                      "no_list": args.no_list, "cases": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
