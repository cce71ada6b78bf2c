"""ctypes bindings for the native C++ .splib parser
(`csrc/native/splib_parser.cpp`).

The port's counterpart of `ann_solo_tpu/io/splib_native.py`: all spectra
of a .splib file decoded in one native pass into packed columns, built at
first use (`io/_native_build.py`).  Callers check `available()` and
otherwise read with `splib.read_splib`, whose spectra these equal.
Peptides are sliced from the raw bytes by the parser's byte offsets and
then decoded.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from ann_solo_tpu_torch.io import _native_build
from ann_solo_tpu_torch.models.spectrum import Spectrum

_COLUMNS = (
    ("identifiers", np.uint32, "n"),
    ("precursor_mz", np.float64, "n"),
    ("precursor_charge", np.int32, "n"),
    ("is_decoy", np.uint8, "n"),
    ("peptide_offsets", np.int64, "n+1"),
    ("peptide_chars", None, "bytes"),
    ("peak_offsets", np.int64, "n+1"),
    ("mz", np.float32, "peaks"),
    ("intensity", np.float32, "peaks"),
    ("ann_type", np.uint8, "peaks"),
    ("ann_index", np.int16, "peaks"),
    ("ann_charge", np.uint8, "peaks"),
)


def _lib():
    return _native_build.load_parser("splib_parser", "splib", _COLUMNS)


def available() -> bool:
    return _lib() is not None


def read_splib_native(filename: str) -> Iterator[Spectrum]:
    """Read all spectra via the native parser (the contract of
    `splib.read_splib`)."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("the native parser is unavailable; check "
                           "available() first")
    c = _native_build.parse_columns(lib, "splib", _COLUMNS, filename)
    pep_off, peak_off = c["peptide_offsets"], c["peak_offsets"]
    for i in range(c["n"]):
        lo, hi = peak_off[i], peak_off[i + 1]
        yield Spectrum(
            identifier=str(int(c["identifiers"][i])),
            precursor_mz=float(c["precursor_mz"][i]),
            precursor_charge=int(c["precursor_charge"][i]),
            mz=c["mz"][lo:hi],
            intensity=c["intensity"][lo:hi],
            ann_type=c["ann_type"][lo:hi],
            ann_index=c["ann_index"][lo:hi],
            ann_charge=c["ann_charge"][lo:hi],
            peptide=c["peptide_chars"][pep_off[i]:pep_off[i + 1]].decode(
                "utf-8", "replace"),
            is_decoy=bool(c["is_decoy"][i]),
        )
