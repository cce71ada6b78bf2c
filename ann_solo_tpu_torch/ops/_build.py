"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each kernel source under `ann_solo_tpu_torch/csrc/` has a plain C entry
point, so it compiles in seconds without PyTorch's headers.  The shared
library lands in `build/kernels/` at the root of the checkout, named by a
hash of the source, the shared headers and the flags, so an edited source
rebuilds and an unchanged one is reused.  Nothing here runs at import time.
Each build and each load is counted (`utils.profiling.profiler.count`:
``kernel built <name>``, ``kernel loaded <name>``), so that one inside a
traced batch shows in its counters.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

from ann_solo_tpu_torch.utils.profiling import profiler

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

# No fast-math: the kernels' divisions must be IEEE quotients.
# -fmad=false keeps products and sums separately rounded, as in PyTorch's
# elementwise kernels that the plain versions run.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    for candidate in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if candidate and os.path.isfile(candidate):
            return candidate
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    """Where the shared library for `csrc/<name>.cu` is (or will be) built:
    keyed by the source, the shared headers `csrc/*.cuh` and the flags."""
    source = (CSRC_DIR / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(
        source + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def ensure_built(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless a library of this source exists."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu:\n{proc.stdout}\n{proc.stderr}"
        )
    out.with_suffix(".ptxas").write_text(proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    profiler.count(f"kernel built {name}")
    return out


def _kernel_name(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled symbol
    (`_Z[N]<len><name>...`): the length-prefixed name that ends in
    "kernel", then its integer template arguments, e.g.
    "stage1_bounds_kernelILi16ELi2EE"."""
    m = re.match(r"_ZN?", mangled)
    at = m.end() if m else len(mangled)
    while at < len(mangled) and mangled[at].isdigit():
        digits = re.match(r"\d+", mangled[at:]).group()
        at += len(digits)
        ident = mangled[at:at + int(digits)]
        at += int(digits)
        if ident.endswith("kernel"):
            args = re.match(r"I(?:L[^E]*E)+E", mangled[at:])
            return ident + (args.group() if args else "")
    return mangled


def ptxas_report(name: str) -> list:
    """One line per kernel of the last build of `csrc/<name>.cu`: its
    registers and spills as `ptxas -v` reported them (empty if the
    library was built elsewhere)."""
    path = library_path(name).with_suffix(".ptxas")
    if not path.exists():
        return []
    lines, kernel, spills = [], None, ""
    for line in path.read_text().splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            kernel = _kernel_name(entry.group(1))
            spills = ""
        elif kernel and "spill" in line:
            spills = line.strip()
        elif kernel and "Used" in line and "registers" in line:
            lines.append(f"{kernel}: {line.split(':', 1)[1].strip()}; "
                         f"{spills}")
            kernel = None
    return lines


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library for `csrc/<name>.cu` (built on first use)."""
    library = ctypes.CDLL(str(ensure_built(name)))
    profiler.count(f"kernel loaded {name}")
    return library
