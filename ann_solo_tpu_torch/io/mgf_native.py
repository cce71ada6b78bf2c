"""ctypes bindings for the native C++ MGF parser
(`csrc/native/mgf_parser.cpp`).

The port's counterpart of `ann_solo_tpu/io/mgf_native.py`: all spectra of
an MGF file decoded in one native pass into packed columns, built at first
use (`io/_native_build.py`).  Callers check `available()` and otherwise
read with `mgf.read_mgf_python`, whose spectra these equal.  Titles and
sequences are sliced from the raw bytes by the parser's byte offsets and
then decoded, so a non-ASCII title reads as the Python reader reads it.
"""

from __future__ import annotations

import logging
import math
from typing import Iterator

import numpy as np

from ann_solo_tpu_torch.io import _native_build
from ann_solo_tpu_torch.models.spectrum import Spectrum

logger = logging.getLogger(__name__)

_COLUMNS = (
    ("precursor_mz", np.float64, "n"),
    ("precursor_charge", np.int32, "n"),
    ("retention_time", np.float64, "n"),
    ("is_decoy", np.uint8, "n"),
    ("title_offsets", np.int64, "n+1"),
    ("title_chars", None, "bytes"),
    ("seq_offsets", np.int64, "n+1"),
    ("seq_chars", None, "bytes"),
    ("peak_offsets", np.int64, "n+1"),
    ("mz", np.float64, "peaks"),
    ("intensity", np.float64, "peaks"),
)


def _lib():
    return _native_build.load_parser("mgf_parser", "mgf", _COLUMNS)


def available() -> bool:
    return _lib() is not None


def read_mgf_native(filename: str) -> Iterator[Spectrum]:
    """Read all spectra via the native parser (the contract of
    `mgf.read_mgf_python`: TITLE -> SCAN -> block index identifiers,
    spectra without a valid precursor m/z skipped with a warning, SEQ
    converted to ProForma)."""
    from ann_solo_tpu_torch.io.mgf import mgf_seq_to_proforma

    lib = _lib()
    if lib is None:
        raise RuntimeError("the native parser is unavailable; check "
                           "available() first")
    c = _native_build.parse_columns(lib, "mgf", _COLUMNS, filename)
    title_off, seq_off, peak_off = (
        c["title_offsets"], c["seq_offsets"], c["peak_offsets"])
    for i in range(c["n"]):
        identifier = c["title_chars"][title_off[i]:title_off[i + 1]].decode(
            "utf-8", "replace") or str(i + 1)
        if not c["precursor_mz"][i] > 0:
            logger.warning(
                "Skipping spectrum %s without a valid precursor m/z in %s",
                identifier, filename,
            )
            continue
        lo, hi = peak_off[i], peak_off[i + 1]
        charge, rt = c["precursor_charge"][i], c["retention_time"][i]
        spectrum = Spectrum(
            identifier=identifier,
            precursor_mz=float(c["precursor_mz"][i]),
            precursor_charge=int(charge) if charge != 0 else None,
            mz=c["mz"][lo:hi],
            intensity=c["intensity"][lo:hi],
            retention_time=float(rt) if not math.isnan(rt) else None,
            index=i + 1,
            is_decoy=bool(c["is_decoy"][i]),
        )
        seq = c["seq_chars"][seq_off[i]:seq_off[i + 1]]
        if seq:
            spectrum.peptide = mgf_seq_to_proforma(
                seq.decode("utf-8", "replace"))
        yield spectrum
