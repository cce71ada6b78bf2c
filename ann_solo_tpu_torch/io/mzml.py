"""mzML and mzXML query-file readers.

Self-contained replacements for the reference's pyteomics.mzml / mzxml
readers (ann_solo/reader.py:659-811), built on xml.etree iterparse with
base64/zlib binary-array decoding.  Only MS2 spectra are yielded; malformed
spectra are skipped with a warning (same policy as the reference).

The port's copy of `ann_solo_tpu/io/mzml.py` (the port imports nothing of
the JAX package); `tests/test_torch_engine_io.py` holds it equal.
"""

from __future__ import annotations

import base64
import logging
import re
import zlib
from typing import Iterator, Optional
from xml.etree import ElementTree

import numpy as np

from ann_solo_tpu_torch.models.spectrum import Spectrum

logger = logging.getLogger(__name__)

_MZML_NS = "{http://psi.hupo.org/ms/mzml}"

# PSI-MS controlled-vocabulary accessions.
_CV_MS_LEVEL = "MS:1000511"
_CV_MZ_ARRAY = "MS:1000514"
_CV_INTENSITY_ARRAY = "MS:1000515"
_CV_F64 = "MS:1000523"
_CV_F32 = "MS:1000521"
_CV_ZLIB = "MS:1000574"
_CV_NO_COMPRESSION = "MS:1000576"
_CV_SELECTED_MZ = "MS:1000744"
_CV_CHARGE = "MS:1000041"
_CV_POSSIBLE_CHARGE = "MS:1000633"
_CV_SCAN_START = "MS:1000016"


def _decode_binary(
    text: str, dtype: np.dtype, compressed: bool
) -> np.ndarray:
    raw = base64.b64decode(text)
    if compressed:
        raw = zlib.decompress(raw)
    return np.frombuffer(raw, dtype)


def _cv_params(element) -> dict:
    return {
        cv.get("accession"): cv.get("value", "")
        for cv in element.iter(f"{_MZML_NS}cvParam")
    }


def read_mzml(filename: str) -> Iterator[Spectrum]:
    """Yield MS2 spectra from an mzML file (reference reader.py:659-740)."""
    for _, element in ElementTree.iterparse(filename):
        if element.tag != f"{_MZML_NS}spectrum":
            continue
        try:
            spectrum = _parse_mzml_spectrum(element)
            if spectrum is not None:
                yield spectrum
        except (ValueError, KeyError) as e:
            logger.warning(
                "Failed to read spectrum %s: %s", element.get("id"), e
            )
        element.clear()


def _parse_mzml_spectrum(element) -> Optional[Spectrum]:
    top_cv = {
        cv.get("accession"): cv.get("value", "")
        for cv in element.findall(f"{_MZML_NS}cvParam")
    }
    if int(top_cv.get(_CV_MS_LEVEL, -1)) != 2:
        return None
    spectrum_id = element.get("id", "")
    if "scan=" in spectrum_id:
        scan_nr = spectrum_id[spectrum_id.find("scan=") + 5 :].split()[0]
    elif "index=" in spectrum_id:
        scan_nr = spectrum_id[spectrum_id.find("index=") + 6 :].split()[0]
    else:
        raise ValueError("Failed to parse scan/index number")
    # mzML scan numbers are usually numeric, but our own writer (and some
    # converters) emit arbitrary identifier strings -- keep them as-is.
    try:
        scan_nr = int(scan_nr)
    except ValueError:
        pass
    index = int(element.get("index", -1))

    mz_array = intensity_array = None
    for binary_elem in element.iter(f"{_MZML_NS}binaryDataArray"):
        cv = _cv_params(binary_elem)
        dtype = np.float64 if _CV_F64 in cv else np.float32
        compressed = _CV_ZLIB in cv
        binary = binary_elem.find(f"{_MZML_NS}binary")
        data = _decode_binary(binary.text or "", dtype, compressed)
        if _CV_MZ_ARRAY in cv:
            mz_array = data
        elif _CV_INTENSITY_ARRAY in cv:
            intensity_array = data
    if mz_array is None or intensity_array is None:
        raise ValueError("Missing binary data arrays")

    retention_time = None
    for scan in element.iter(f"{_MZML_NS}scan"):
        cv = _cv_params(scan)
        if _CV_SCAN_START in cv:
            retention_time = float(cv[_CV_SCAN_START])
            break

    precursor_mz, precursor_charge = None, None
    for ion in element.iter(f"{_MZML_NS}selectedIon"):
        cv = _cv_params(ion)
        if _CV_SELECTED_MZ in cv:
            precursor_mz = float(cv[_CV_SELECTED_MZ])
        if _CV_CHARGE in cv:
            precursor_charge = int(cv[_CV_CHARGE])
        elif _CV_POSSIBLE_CHARGE in cv:
            precursor_charge = int(cv[_CV_POSSIBLE_CHARGE])
        break
    if precursor_mz is None:
        raise ValueError("Missing precursor m/z")

    return Spectrum(
        identifier=str(scan_nr),
        precursor_mz=precursor_mz,
        precursor_charge=precursor_charge,
        mz=mz_array,
        intensity=intensity_array,
        retention_time=retention_time,
        index=index,
    )


def read_mzxml(filename: str) -> Iterator[Spectrum]:
    """Yield MS2 spectra from an mzXML file (reference reader.py:742-811)."""
    for _, element in ElementTree.iterparse(filename):
        if not element.tag.endswith("}scan") and element.tag != "scan":
            continue
        try:
            spectrum = _parse_mzxml_scan(element)
            if spectrum is not None:
                yield spectrum
        except (ValueError, KeyError) as e:
            logger.warning(
                "Failed to read spectrum %s: %s", element.get("num"), e
            )
        element.clear()


def _parse_mzxml_scan(element) -> Optional[Spectrum]:
    if int(element.get("msLevel", -1)) != 2:
        return None
    ns = element.tag[: element.tag.find("}") + 1]
    scan_nr = int(element.get("num"))
    retention_time = None
    rt = element.get("retentionTime")
    if rt is not None:
        m = re.match(r"PT([0-9.]+)S", rt)
        retention_time = float(m.group(1)) if m else float(rt)
    precursor_elem = element.find(f"{ns}precursorMz")
    if precursor_elem is None:
        raise ValueError("Missing precursor")
    precursor_mz = float(precursor_elem.text)
    charge = precursor_elem.get("precursorCharge")
    precursor_charge = int(charge) if charge is not None else None
    peaks_elem = element.find(f"{ns}peaks")
    if peaks_elem is None:
        raise ValueError("Missing peaks")
    dtype = (
        ">f8" if peaks_elem.get("precision", "32") == "64" else ">f4"
    )
    raw = base64.b64decode(peaks_elem.text or "")
    if peaks_elem.get("compressionType") == "zlib":
        raw = zlib.decompress(raw)
    data = np.frombuffer(raw, dtype)
    mz_array = np.ascontiguousarray(data[0::2]).astype(np.float64)
    intensity_array = np.ascontiguousarray(data[1::2]).astype(np.float64)
    return Spectrum(
        identifier=str(scan_nr),
        precursor_mz=precursor_mz,
        precursor_charge=precursor_charge,
        mz=mz_array,
        intensity=intensity_array,
        retention_time=retention_time,
        index=scan_nr,
    )


def write_mzml(spectra, filename: str) -> None:
    """Write a minimal valid mzML file (used by round-trip tests)."""
    lines = [
        '<?xml version="1.0" encoding="utf-8"?>',
        '<mzML xmlns="http://psi.hupo.org/ms/mzml" version="1.1.0">',
        f'<run id="run1"><spectrumList count="{len(spectra)}">',
    ]
    for i, s in enumerate(spectra):
        mz_b64 = base64.b64encode(
            zlib.compress(np.asarray(s.mz, np.float64).tobytes())
        ).decode()
        int_b64 = base64.b64encode(
            zlib.compress(np.asarray(s.intensity, np.float64).tobytes())
        ).decode()
        charge_param = (
            f'<cvParam accession="{_CV_CHARGE}" name="charge state" '
            f'value="{s.precursor_charge}"/>'
            if s.precursor_charge is not None
            else ""
        )
        rt_param = (
            f'<cvParam accession="{_CV_SCAN_START}" name="scan start time" '
            f'value="{s.retention_time}"/>'
            if s.retention_time is not None
            else ""
        )
        lines.append(
            f'<spectrum index="{i}" id="scan={s.identifier}" '
            f'defaultArrayLength="{len(s.mz)}">'
            f'<cvParam accession="{_CV_MS_LEVEL}" name="ms level" '
            f'value="2"/>'
            f"<scanList count=\"1\"><scan>{rt_param}</scan></scanList>"
            '<precursorList count="1"><precursor>'
            '<selectedIonList count="1"><selectedIon>'
            f'<cvParam accession="{_CV_SELECTED_MZ}" '
            f'name="selected ion m/z" value="{s.precursor_mz}"/>'
            f"{charge_param}"
            "</selectedIon></selectedIonList></precursor></precursorList>"
            '<binaryDataArrayList count="2">'
            "<binaryDataArray>"
            f'<cvParam accession="{_CV_F64}" name="64-bit float"/>'
            f'<cvParam accession="{_CV_ZLIB}" name="zlib compression"/>'
            f'<cvParam accession="{_CV_MZ_ARRAY}" name="m/z array"/>'
            f"<binary>{mz_b64}</binary></binaryDataArray>"
            "<binaryDataArray>"
            f'<cvParam accession="{_CV_F64}" name="64-bit float"/>'
            f'<cvParam accession="{_CV_ZLIB}" name="zlib compression"/>'
            f'<cvParam accession="{_CV_INTENSITY_ARRAY}" '
            f'name="intensity array"/>'
            f"<binary>{int_b64}</binary></binaryDataArray>"
            "</binaryDataArrayList></spectrum>"
        )
    lines.append("</spectrumList></run></mzML>")
    with open(filename, "w") as f_out:
        f_out.write("\n".join(lines))


def write_mzxml(spectra, filename: str) -> None:
    """Write a minimal valid mzXML file (used by round-trip tests)."""
    lines = [
        '<?xml version="1.0" encoding="utf-8"?>',
        '<mzXML xmlns="http://sashimi.sourceforge.net/schema_revision/'
        'mzXML_3.2">',
        '<msRun scanCount="%d">' % len(spectra),
    ]
    for s in spectra:
        interleaved = np.empty(2 * len(s.mz), ">f8")
        interleaved[0::2] = s.mz
        interleaved[1::2] = s.intensity
        peaks_b64 = base64.b64encode(interleaved.tobytes()).decode()
        charge_attr = (
            f' precursorCharge="{s.precursor_charge}"'
            if s.precursor_charge is not None
            else ""
        )
        rt_attr = (
            f' retentionTime="PT{s.retention_time}S"'
            if s.retention_time is not None
            else ""
        )
        lines.append(
            f'<scan num="{s.identifier}" msLevel="2" '
            f'peaksCount="{len(s.mz)}"{rt_attr}>'
            f'<precursorMz{charge_attr}>{s.precursor_mz}</precursorMz>'
            f'<peaks precision="64" byteOrder="network" '
            f'contentType="m/z-int" compressionType="none" '
            f'compressedLen="0">{peaks_b64}</peaks></scan>'
        )
    lines.append("</msRun></mzXML>")
    with open(filename, "w") as f_out:
        f_out.write("\n".join(lines))
