"""SpectraST .splib (binary) and .sptxt (text) spectral-library parsers.

Replaces the reference's Cython/mmap SplibParser (ann_solo/parsers.pyx) and
the regex sptxt reader (ann_solo/reader.py:300-436) with a self-contained
NumPy/mmap implementation.  A native C++ fast path (see native/) can be
plugged in transparently for large libraries.

.splib binary layout (as decoded by parsers.pyx:89-160):
  header:  8 bytes, one text line, uint32 n_lines, n_lines text lines
  per spectrum:
    uint32 identifier
    text line  "Name: X.PEPTIDE.X/charge ..."
    float64 precursor m/z
    text line  (status)
    uint32 num_peaks
    num_peaks x (float64 mz, float64 intensity, annotation line, info line)
    final text line; contains " Remark=DECOY_" for decoy spectra

The port's copy of `ann_solo_tpu/io/splib.py` (the port imports nothing of
the JAX package); `tests/test_torch_engine_io.py` holds it equal.
"""

from __future__ import annotations

import io
import mmap
import re
from typing import Iterator, Optional, Tuple

import numpy as np

from ann_solo_tpu_torch.models.spectrum import ION_TYPE_CODES, Spectrum


def parse_annotation(raw: bytes) -> Tuple[int, int, int]:
    """Parse a SpectraST peak annotation (parsers.pyx:163-186).

    Returns (ion_type_code, ion_index, charge); charge -1 marks peaks that
    do not correspond to a/b/y ions or carry modified-ion markers.
    """
    if not raw:
        return 0, -1, -1
    ion_type = chr(raw[0])
    if ion_type not in ("a", "b", "y"):
        return 0, -1, -1
    m = re.match(rb"^.(\d+)", raw)
    if m is None:
        return 0, -1, -1
    ion_index = int(m.group(1))
    rest = raw[1 + len(m.group(1)):]
    if rest.startswith(b"/"):
        charge = 1
    elif rest.startswith(b"^"):
        m2 = re.match(rb"\^(\d+)", rest)
        charge = int(m2.group(1)) if m2 else -1
    else:
        charge = -1
    return ION_TYPE_CODES[ion_type], ion_index, charge


class SplibParser:
    """Sequential reader over an mmap'ed .splib file."""

    def __init__(self, filename: str):
        self._file = open(filename, "rb")
        self._mmap = mmap.mmap(
            self._file.fileno(), 0, access=mmap.ACCESS_READ
        )
        self._size = len(self._mmap)
        self._pos = 0

    def close(self) -> None:
        self._mmap.close()
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _read_u32(self) -> int:
        value = int.from_bytes(self._mmap[self._pos : self._pos + 4],
                               "little")
        self._pos += 4
        return value

    def _read_f64(self) -> float:
        value = np.frombuffer(
            self._mmap, np.float64, count=1, offset=self._pos
        )[0]
        self._pos += 8
        return float(value)

    def _read_line(self) -> bytes:
        end = self._mmap.find(b"\n", self._pos)
        if end < 0:
            end = self._size - 1
        line = self._mmap[self._pos : end + 1]
        self._pos = end + 1
        return line

    def seek_first_spectrum(self) -> None:
        self._pos = 8
        self._read_line()
        for _ in range(self._read_u32()):
            self._read_line()

    def read_spectrum(self, offset: Optional[int] = None) -> Tuple[
        Spectrum, int
    ]:
        if offset is not None and offset >= 0:
            self._pos = offset
        if self._pos >= self._size:
            raise StopIteration
        spectrum_offset = self._pos
        identifier = self._read_u32()
        name = self._read_line()
        peptide_start = name.find(b".") + 1
        peptide_end = name.find(b".", peptide_start)
        peptide = name[peptide_start:peptide_end].decode()
        charge_start = name.find(b"/", peptide_end) + 1
        m = re.match(rb"(\d+)", name[charge_start:])
        precursor_charge = int(m.group(1))
        precursor_mz = self._read_f64()
        self._read_line()  # status
        num_peaks = self._read_u32()
        mz = np.empty(num_peaks, np.float32)
        intensity = np.empty(num_peaks, np.float32)
        ann_type = np.zeros(num_peaks, np.uint8)
        ann_index = np.zeros(num_peaks, np.int16)
        ann_charge = np.zeros(num_peaks, np.int16)
        for i in range(num_peaks):
            mz[i] = self._read_f64()
            intensity[i] = self._read_f64()
            ion_type, ion_index, charge = parse_annotation(self._read_line())
            self._read_line()  # peak info
            if charge != -1:
                ann_type[i] = ion_type
                ann_index[i] = ion_index
                ann_charge[i] = charge
        is_decoy = b" Remark=DECOY_" in self._read_line()
        spectrum = Spectrum(
            identifier=str(identifier),
            precursor_mz=precursor_mz,
            precursor_charge=precursor_charge,
            mz=mz,
            intensity=intensity,
            ann_type=ann_type,
            ann_index=ann_index,
            ann_charge=np.where(ann_charge > 0, ann_charge, 0).astype(
                np.uint8
            ),
            peptide=peptide,
            is_decoy=is_decoy,
        )
        return spectrum, spectrum_offset


def read_splib(filename: str) -> Iterator[Spectrum]:
    """Iterate all spectra in a .splib file."""
    with SplibParser(filename) as parser:
        parser.seek_first_spectrum()
        while True:
            try:
                spectrum, _ = parser.read_spectrum()
            except StopIteration:
                return
            yield spectrum


def write_splib(spectra, filename: str) -> None:
    """Write spectra to a .splib binary file (for tests / round-trips)."""
    with open(filename, "wb") as f_out:
        f_out.write(b"\x01\x00\x00\x00\x00\x00\x00\x00")  # 8-byte header
        f_out.write(b"preamble\n")
        f_out.write((1).to_bytes(4, "little"))
        f_out.write(b"generated by ann_solo_tpu\n")
        from ann_solo_tpu_torch.models.spectrum import ION_TYPE_NAMES

        for spectrum in spectra:
            f_out.write(int(spectrum.identifier).to_bytes(4, "little"))
            f_out.write(
                f"Name: X.{spectrum.peptide}.X/"
                f"{spectrum.precursor_charge}\n".encode()
            )
            f_out.write(
                np.float64(spectrum.precursor_mz).tobytes()
            )
            f_out.write(b"Status: Normal\n")
            f_out.write(int(spectrum.n_peaks).to_bytes(4, "little"))
            for i in range(spectrum.n_peaks):
                f_out.write(np.float64(spectrum.mz[i]).tobytes())
                f_out.write(np.float64(spectrum.intensity[i]).tobytes())
                if (
                    spectrum.ann_type is not None
                    and spectrum.ann_type[i] > 0
                ):
                    ion = ION_TYPE_NAMES[int(spectrum.ann_type[i])]
                    idx = int(spectrum.ann_index[i])
                    charge = int(spectrum.ann_charge[i])
                    if charge == 1:
                        f_out.write(f"{ion}{idx}/0.002\n".encode())
                    else:
                        f_out.write(f"{ion}{idx}^{charge}/0.002\n".encode())
                else:
                    f_out.write(b"?\n")
                f_out.write(b"0 0|\n")
            remark = b" Remark=DECOY_\n" if spectrum.is_decoy else b"\n"
            f_out.write(b"Comment:" + remark)


def write_sptxt(spectra, filename: str) -> None:
    """Write spectra as a SpectraST .sptxt text library.

    Inverse of `read_sptxt` (round-trip tested): ProForma bracket
    modifications become a Comment Mods= list, annotations become
    ion/index/charge peak labels, decoys a DECOY remark.
    """
    from ann_solo_tpu_torch.models.spectrum import ION_TYPE_NAMES

    with open(filename, "w") as f_out:
        for spectrum in spectra:
            peptide = spectrum.peptide or ""
            plain, mods = [], []
            pos = -1
            i = 0
            while i < len(peptide):
                if peptide[i] == "[":
                    end = peptide.index("]", i)
                    mods.append(
                        f"{pos},{plain[-1] if plain else '-'},"
                        f"{peptide[i + 1:end]}"
                    )
                    i = end + 1
                else:
                    plain.append(peptide[i])
                    pos += 1
                    i += 1
            seq = "".join(plain)
            mods_str = (
                f"{len(mods)}/" + "/".join(mods) if mods else "0"
            )
            charge = spectrum.precursor_charge or 0
            f_out.write(f"Name: {seq}/{charge}\n")
            f_out.write(f"LibID: {spectrum.identifier}\n")
            f_out.write(f"PrecursorMZ: {spectrum.precursor_mz:.4f}\n")
            remark = " Remark=DECOY_" if spectrum.is_decoy else ""
            f_out.write(
                f"Comment: Spec=Consensus Mods={mods_str}{remark}\n"
            )
            f_out.write(f"NumPeaks: {spectrum.n_peaks}\n")
            for j in range(spectrum.n_peaks):
                if (
                    spectrum.ann_type is not None
                    and spectrum.ann_charge is not None
                    and spectrum.ann_charge[j] > 0
                    and int(spectrum.ann_type[j]) in ION_TYPE_NAMES
                ):
                    ion = ION_TYPE_NAMES[int(spectrum.ann_type[j])]
                    idx = int(spectrum.ann_index[j])
                    chg = int(spectrum.ann_charge[j])
                    ann = (
                        f"{ion}{idx}/0.002" if chg == 1
                        else f"{ion}{idx}^{chg}/0.002"
                    )
                else:
                    ann = "?"
                f_out.write(
                    f"{spectrum.mz[j]:.4f}\t{spectrum.intensity[j]:.4f}"
                    f"\t{ann}\n"
                )
            f_out.write("\n")


_SPTXT_NAME = re.compile(
    rb"(?<![a-zA-Z])Name:\s?(?:(?!((?<![a-zA-Z])Name:\s?)).|\n)*",
    re.IGNORECASE,
)


def _sptxt_seq_to_proforma(peptide: str, modifications) -> str:
    """Insert Mods= entries as bracketed ProForma modifications
    (reference reader.py:300-322)."""
    if not modifications:
        return peptide
    chars = list(peptide)
    for shift, modification in enumerate(modifications):
        idx, _aa, name = modification.split(",")
        chars.insert(int(idx) + shift + 1, f"[{name}]")
    return "".join(chars)


def _parse_sptxt_spectrum(identifier: int, raw: str) -> Spectrum:
    """Parse one sptxt entry (reference reader.py:324-394)."""
    tokens = re.split(
        r"Num\s?Peaks:\s?[0-9]+\n", raw.strip(), flags=re.IGNORECASE
    )
    metadata, peaks_text = tokens[0], tokens[1]
    is_decoy = bool(re.search("decoy", metadata, re.IGNORECASE))
    first = metadata.split("\n", 1)[0].split("/")
    peptide = first[0].split(" ")[-1].strip()
    charge = int(re.match(r"\d+", first[1].strip()).group(0))
    m = re.search(r"PrecursorMZ:\s?[0-9]+\.[0-9]+", metadata, re.IGNORECASE)
    if not m:
        m = re.search(r"Parent=\s?[0-9]+\.[0-9]+", metadata, re.IGNORECASE)
    precursor_mz = float(re.search(r"[0-9]+\.[0-9]+", m.group(0)).group(0))
    mods_match = re.search(r"Mods=.+?(?=[\s\n])", metadata, re.IGNORECASE)
    modifications = (
        str(mods_match.group(0)).split("/")[1:] if mods_match else None
    )
    mz, intensity = [], []
    ann_type, ann_index, ann_charge = [], [], []
    for line in io.StringIO(peaks_text.strip()):
        fields = line.rstrip("\n").split("\t")
        if len(fields) < 2:
            continue
        mz.append(float(fields[0]))
        intensity.append(float(fields[1]))
        if len(fields) >= 3:
            ion, idx, chg = parse_annotation(fields[2].encode())
        else:
            ion, idx, chg = 0, -1, -1
        ann_type.append(ion if chg != -1 else 0)
        ann_index.append(idx if chg != -1 else 0)
        ann_charge.append(chg if chg != -1 else 0)
    return Spectrum(
        identifier=str(identifier),
        precursor_mz=precursor_mz,
        precursor_charge=charge,
        mz=np.asarray(mz),
        intensity=np.asarray(intensity),
        ann_type=np.asarray(ann_type, np.uint8),
        ann_index=np.asarray(ann_index, np.int16),
        ann_charge=np.asarray(ann_charge, np.uint8),
        peptide=_sptxt_seq_to_proforma(peptide, modifications),
        is_decoy=is_decoy,
    )


def read_sptxt(filename: str) -> Iterator[Spectrum]:
    """Iterate all spectra in a SpectraST .sptxt text library."""
    with open(filename, "rb") as f_in:
        data = mmap.mmap(f_in.fileno(), 0, access=mmap.ACCESS_READ).read()
    for identifier, match in enumerate(_SPTXT_NAME.finditer(data), 1):
        raw = "\n".join(match.group(0).decode("utf-8").splitlines())
        yield _parse_sptxt_spectrum(identifier, raw)
