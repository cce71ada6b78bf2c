"""Run one cell of `BENCHMARK.json` on the card and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout.  `setup_s` counts from the start of this
script (the interpreter's own start, some tens of milliseconds, is left
out) to the window's.  The program's kernel builds stay inside
the checkout: the port's nvcc outputs in `build/kernels/` (its own fixed
path), and PyTorch's and Triton's caches, should anything use them, in
`build/torch_extensions/` and `build/triton/`.
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
sys.path[0] = ROOT

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
