"""MGF (Mascot Generic Format) reader/writer.

The port's copy of `ann_solo_tpu/io/mgf.py`; `tests/test_torch_engine_io.py`
holds it equal.

Self-contained replacement for the reference's pyteomics.mgf usage
(ann_solo/reader.py:868-911 `read_mgf`), including MassIVE-KB-style
sequence-to-ProForma conversion for library MGF files.
"""

from __future__ import annotations

import logging
import re
from typing import Iterator, Optional

import numpy as np

from ann_solo_tpu_torch.models.spectrum import Spectrum

logger = logging.getLogger(__name__)


def _leading_substitute_pattern(match: re.Match) -> str:
    """N-terminal / unlocalized modification rewriting
    (reference reader.py:814-834)."""
    if match.group(1) and match.group(2):
        return "[{}]?[{}]-{:s}".format(
            match.group(1), match.group(2), match.group(3)
        )
    elif match.group(1):
        return "[{}]-{}".format(match.group(1), match.group(3))
    else:
        return match.group(0)


def mgf_seq_to_proforma(peptide: str) -> str:
    """Convert a MassIVE-KB MGF SEQ= value to ProForma
    (reference reader.py:837-866)."""
    within = r"([A-Z])([+-]?\d+\.\d+)"
    formatted = re.sub(within, r"\1[\2]", peptide)
    leading = r"([+-]?[\d.]+)([+-]?[\d.]+)?([A-Za-z]+)"
    return re.sub(leading, _leading_substitute_pattern, formatted)


def read_mgf(filename: str) -> Iterator[Spectrum]:
    """Read all spectra from an MGF file.

    Mirrors the reference `read_mgf` (reader.py:868-911): identifier from
    TITLE (or SCAN), precursor from PEPMASS/CHARGE, optional RTINSECONDS,
    SEQ (library MGFs), and a DECOY flag.  Dispatches to the native C++
    one-pass parser (`mgf_native`) when it builds; `read_mgf_python` is
    the fallback and the parity oracle.
    """
    from ann_solo_tpu_torch.io import mgf_native

    if mgf_native.available():
        yield from mgf_native.read_mgf_native(filename)
        return
    yield from read_mgf_python(filename)


def read_mgf_python(filename: str) -> Iterator[Spectrum]:
    """Pure-Python MGF reader (reference semantics; see `read_mgf`)."""
    with open(filename) as f_in:
        index = 0
        params = {}
        mz, intensity = [], []
        in_ions = False
        for raw_line in f_in:
            line = raw_line.strip()
            if not line:
                continue
            if line == "BEGIN IONS":
                in_ions = True
                params, mz, intensity = {}, [], []
            elif line == "END IONS":
                index += 1
                try:
                    spectrum = _build_spectrum(params, mz, intensity,
                                               index)
                except (ValueError, IndexError) as e:
                    # Malformed spectra are skipped with a warning, like
                    # the reference query readers (reader.py:683-687).
                    logger.warning(
                        "Skipping malformed spectrum %s in %s: %s",
                        params.get("title", index), filename, e,
                    )
                else:
                    if spectrum.precursor_mz > 0:
                        yield spectrum
                    else:
                        logger.warning(
                            "Skipping spectrum %s without a valid "
                            "precursor m/z in %s",
                            params.get("title", index), filename,
                        )
                in_ions = False
            elif in_ions:
                if "=" in line and not line[0].isdigit():
                    key, value = line.split("=", 1)
                    params[key.strip().lower()] = value.strip()
                else:
                    fields = line.split()
                    if len(fields) >= 2:
                        try:
                            peak_mz = float(fields[0])
                            peak_int = float(fields[1])
                        except ValueError:
                            continue  # non-numeric line: skip (native
                            # parser behavior)
                        mz.append(peak_mz)
                        intensity.append(peak_int)


def _build_spectrum(params, mz, intensity, index: int) -> Spectrum:
    identifier = params.get("title", params.get("scan", str(index)))
    pepmass = params.get("pepmass", "0")
    precursor_mz = float(pepmass.split()[0])
    retention_time = (
        float(params["rtinseconds"]) if "rtinseconds" in params else None
    )
    precursor_charge: Optional[int] = None
    if "charge" in params:
        try:
            charge_str = params["charge"].split()[0].rstrip("+")
            sign = -1 if charge_str.endswith("-") else 1
            precursor_charge = sign * int(charge_str.rstrip("-"))
        except (ValueError, IndexError):
            # Unparsable charge keeps the spectrum with charge unknown
            # (the engine then duplicates it for charges 2/3), matching
            # the native parser.
            precursor_charge = None
    spectrum = Spectrum(
        identifier=identifier,
        precursor_mz=precursor_mz,
        precursor_charge=precursor_charge,
        mz=np.asarray(mz, np.float64),
        intensity=np.asarray(intensity, np.float64),
        retention_time=retention_time,
        index=index,
        is_decoy="decoy" in params,
    )
    if "seq" in params:
        spectrum.peptide = mgf_seq_to_proforma(params["seq"])
    return spectrum


def write_mgf(spectra, filename: str) -> None:
    """Write spectra to an MGF file (used by tests and library exports)."""
    with open(filename, "w") as f_out:
        for spectrum in spectra:
            f_out.write("BEGIN IONS\n")
            f_out.write(f"TITLE={spectrum.identifier}\n")
            f_out.write(f"PEPMASS={spectrum.precursor_mz}\n")
            if spectrum.precursor_charge is not None:
                f_out.write(f"CHARGE={spectrum.precursor_charge}+\n")
            if spectrum.retention_time is not None:
                f_out.write(f"RTINSECONDS={spectrum.retention_time}\n")
            if spectrum.peptide is not None:
                f_out.write(f"SEQ={spectrum.peptide}\n")
            if spectrum.is_decoy:
                f_out.write("DECOY=1\n")
            for mz, intensity in zip(spectrum.mz, spectrum.intensity):
                f_out.write(f"{mz} {intensity}\n")
            f_out.write("END IONS\n")
