"""Format dispatch for library and query files.

The port's copy of `ann_solo_tpu/io/reader.py`, dispatching to the
Python readers only (the native parsers are not ported yet).

Counterpart to the reference's reader facade (ann_solo/reader.py:262-287,
914-938).
"""

from __future__ import annotations

import logging
import os
from typing import Iterator, List

from ann_solo_tpu_torch.models.spectrum import Spectrum

logger = logging.getLogger(__name__)

FASTA_UNSUPPORTED = (
    "FASTA spectral libraries are not supported by ann_solo_tpu_torch: "
    "their spectra are predicted by a remote Prosit server; convert the "
    "library to .splib, .sptxt or .mgf first"
)


def verify_extension(supported_extensions: List[str], filename: str) -> None:
    """Check the file exists and has a supported extension
    (reference reader.py:631-654)."""
    _, ext = os.path.splitext(os.path.basename(filename))
    if ext.lower() not in supported_extensions:
        logger.error("Unrecognized file format: %s", filename)
        raise FileNotFoundError(
            f"Unrecognized file format (supported file formats: "
            f"{', '.join(supported_extensions)})"
        )
    elif not os.path.isfile(filename):
        logger.error("File not found: %s", filename)
        raise FileNotFoundError(f"File {filename} does not exist")


def read_library_file(filename: str) -> Iterator[Spectrum]:
    """Read all spectra from a spectral library file (the Python readers).

    A FASTA library is refused: the JAX package predicts its spectra
    through a remote Prosit server, which this package does not port.
    """
    ext = os.path.splitext(os.path.basename(filename))[1].lower()
    if ext == ".splib":
        from ann_solo_tpu_torch.io.splib import read_splib

        yield from read_splib(filename)
    elif ext == ".sptxt":
        from ann_solo_tpu_torch.io.splib import read_sptxt

        yield from read_sptxt(filename)
    elif ext == ".mgf":
        from ann_solo_tpu_torch.io.mgf import read_mgf

        yield from read_mgf(filename)
    elif ext == ".fasta":
        raise ValueError(FASTA_UNSUPPORTED)
    else:
        raise FileNotFoundError(f"Unsupported library format: {ext}")


def read_query_file(filename: str) -> Iterator[Spectrum]:
    """Read all query spectra from an mgf / mzML / mzXML file."""
    verify_extension([".mgf", ".mzml", ".mzxml"], filename)
    ext = os.path.splitext(os.path.basename(filename))[1].lower()
    if ext == ".mgf":
        from ann_solo_tpu_torch.io.mgf import read_mgf

        yield from read_mgf(filename)
    elif ext == ".mzml":
        from ann_solo_tpu_torch.io.mzml import read_mzml

        yield from read_mzml(filename)
    elif ext == ".mzxml":
        from ann_solo_tpu_torch.io.mzml import read_mzxml

        yield from read_mzxml(filename)
