"""File helpers shared by the library store and the index."""

from __future__ import annotations

import os
from typing import Dict

import numpy as np


def write_npz_atomically(filename: str, arrays: Dict[str, np.ndarray]) -> None:
    """`np.savez` (uncompressed, no pickle) under a temporary name in the
    target's directory, then `os.replace`: a run that is cut leaves no
    half-written file under the real name, and no temporary file."""
    tmp = f"{filename}.tmp{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, filename)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
