"""Format dispatch for library and query files.

The port's copy of `ann_solo_tpu/io/reader.py`: .splib, .sptxt and .mgf
files go through the native C++ parsers when they build (`io/*_native.py`),
else through the Python readers, after one WARNING; a .fasta library is
digested and its spectra predicted locally (`io/fasta.py`).  Which one
read the library and the query file is recorded in the profiler's notes
(``notes["library reader"]``, ``notes["query reader"]``: "native" or
"python").

Counterpart to the reference's reader facade (ann_solo/reader.py:262-287,
914-938).
"""

from __future__ import annotations

import logging
import os
from typing import Iterator, List

from ann_solo_tpu_torch.models.spectrum import Spectrum
from ann_solo_tpu_torch.utils.profiling import profiler

logger = logging.getLogger(__name__)


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


def _read(filename: str, role: str, native, read_native,
          read_python) -> Iterator[Spectrum]:
    """`read_native` when the `native` parser module builds and loads,
    else `read_python`; records which in ``notes[f"{role} reader"]``."""
    use_native = native is not None and native.available()
    profiler.notes[f"{role} reader"] = "native" if use_native else "python"
    yield from (read_native if use_native else read_python)(filename)


def read_library_file(filename: str, config=None) -> Iterator[Spectrum]:
    """Read/generate all spectra from a spectral library or FASTA file
    (a FASTA file's digestion and charges from `config`; None: the
    package's config singleton)."""
    from ann_solo_tpu_torch.io import (
        fasta,
        mgf,
        mgf_native,
        splib,
        splib_native,
        sptxt_native,
    )

    ext = os.path.splitext(os.path.basename(filename))[1].lower()
    if ext == ".splib":
        yield from _read(filename, "library", splib_native,
                         splib_native.read_splib_native, splib.read_splib)
    elif ext == ".sptxt":
        yield from _read(filename, "library", sptxt_native,
                         sptxt_native.read_sptxt_native, splib.read_sptxt)
    elif ext == ".mgf":
        yield from _read(filename, "library", mgf_native,
                         mgf_native.read_mgf_native, mgf.read_mgf_python)
    elif ext == ".fasta":
        if config is None:
            from ann_solo_tpu_torch.config import config
        yield from _read(filename, "library", None, None,
                         lambda name: fasta.read_fasta(name, config))
    else:
        raise FileNotFoundError(f"Unsupported library format: {ext}")


def read_query_file(filename: str) -> Iterator[Spectrum]:
    """Read all query spectra from an mgf / mzML / mzXML file."""
    from ann_solo_tpu_torch.io import mgf, mgf_native, mzml

    verify_extension([".mgf", ".mzml", ".mzxml"], filename)
    ext = os.path.splitext(os.path.basename(filename))[1].lower()
    if ext == ".mgf":
        yield from _read(filename, "query", mgf_native,
                         mgf_native.read_mgf_native, mgf.read_mgf_python)
    elif ext == ".mzml":
        yield from _read(filename, "query", None, None, mzml.read_mzml)
    elif ext == ".mzxml":
        yield from _read(filename, "query", None, None, mzml.read_mzxml)
