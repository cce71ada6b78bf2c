"""Build the native C++ library parsers with g++ and load them with ctypes.

The sources under `ann_solo_tpu_torch/csrc/native/` are the JAX package's
parsers (`native/*.cpp`, `native/mmap_guard.h`), kept here byte for byte.
Each compiles at first use, never at import, into `build/native/` at the
root of the checkout, named by a hash of its source, `mmap_guard.h` and the
flags: an edited source rebuilds, an unchanged one is reused.  The library
is written under a temporary name and renamed into place, so concurrent
processes never load a partial file.

Each parser exposes a columnar C interface: ``<prefix>_parse(path)``
returns a handle, ``<prefix>_num_spectra`` / ``_num_peaks`` its sizes, one
accessor per column, and ``<prefix>_free`` releases it.  `load_parser`
declares those signatures from a column table and `parse_columns` copies
the columns out as NumPy arrays (character buffers as raw bytes, which the
caller slices by the parser's byte offsets before decoding).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE_DIR = PACKAGE_DIR / "csrc" / "native"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "native"
CXX = "g++"
# The JAX package's native/Makefile flags; no -march=native, so a library
# built on one host runs on another.
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")

# (column, NumPy dtype or None for a character buffer, length): length is
# "n" (one per spectrum), "n+1" (offsets), "peaks" or "bytes" (the
# buffer's length from ``<prefix>_<column>_len``).
Columns = Sequence[Tuple[str, Optional[type], str]]

# name -> the loaded library, or None once it failed to build or load.
_loaded: Dict[str, Optional[ctypes.CDLL]] = {}


def library_path(name: str) -> Path:
    """Where `csrc/native/<name>.cpp` is (or will be) built."""
    digest = hashlib.sha256(
        (SOURCE_DIR / f"{name}.cpp").read_bytes()
        + (SOURCE_DIR / "mmap_guard.h").read_bytes()
        + " ".join(CXX_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def ensure_built(name: str) -> Path:
    """Compile `csrc/native/<name>.cpp` unless a library of this source
    exists; raises RuntimeError when the compiler fails or is missing."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(SOURCE_DIR / f"{name}.cpp")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"{CXX} failed for {name}.cpp: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{CXX} failed for {name}.cpp:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: no process loads a partial file
    return out


def _ctype(dtype) -> type:
    return ctypes.c_char if dtype is None else np.ctypeslib.as_ctypes_type(
        np.dtype(dtype))


def load_parser(name: str, prefix: str,
                columns: Columns) -> Optional[ctypes.CDLL]:
    """The parser library `name` with its C interface declared, built on
    first use; None when it cannot be built or loaded (one WARNING per
    parser and process: the caller then reads with the Python reader)."""
    if name not in _loaded:
        try:
            lib = ctypes.CDLL(str(ensure_built(name)))

            def declare(suffix, restype, argtype=ctypes.c_void_p):
                fn = getattr(lib, f"{prefix}_{suffix}")
                fn.restype, fn.argtypes = restype, [argtype]

            declare("parse", ctypes.c_void_p, ctypes.c_char_p)
            declare("free", None)
            declare("num_spectra", ctypes.c_int64)
            declare("num_peaks", ctypes.c_int64)
            for column, dtype, length in columns:
                declare(column, ctypes.POINTER(_ctype(dtype)))
                if length == "bytes":
                    declare(f"{column}_len", ctypes.c_int64)
        except (RuntimeError, OSError, AttributeError) as e:
            logger.warning("Native parser %s unavailable (%s); using the "
                           "Python reader", name, e)
            lib = None
        _loaded[name] = lib
    return _loaded[name]


def parse_columns(lib: ctypes.CDLL, prefix: str, columns: Columns,
                  filename: str) -> Dict[str, object]:
    """Parse `filename` in one native pass and copy every column out:
    NumPy arrays, and ``bytes`` for character buffers; ``n`` is the
    number of spectra."""
    def call(suffix):
        return getattr(lib, f"{prefix}_{suffix}")(handle)

    handle = getattr(lib, f"{prefix}_parse")(os.fsencode(filename))
    if not handle:
        raise IOError(f"Failed to parse {filename}")
    try:
        n = call("num_spectra")
        lengths = {"n": n, "n+1": n + 1, "peaks": call("num_peaks")}
        out: Dict[str, object] = {"n": n}
        for column, dtype, length in columns:
            if length == "bytes":
                out[column] = ctypes.string_at(call(column),
                                               call(f"{column}_len"))
            elif lengths[length] == 0:
                out[column] = np.zeros(0, dtype)
            else:
                out[column] = np.ctypeslib.as_array(
                    call(column), shape=(lengths[length],)
                ).astype(dtype, copy=True)
    finally:
        call("free")
    return out
