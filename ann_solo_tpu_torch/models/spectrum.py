"""Spectrum data model.

Replaces the reference's per-object `MsmsSpectrum` (spectrum_utils) with two
forms:

* `Spectrum` -- a lightweight host-side container used at I/O boundaries
  (readers, writers, decoy generation).
* `SpectrumBatch` / `ProcessedBatch` -- padded, fixed-shape array batches that
  flow through the jitted TPU pipeline.  Ragged peak lists become
  `(batch, max_peaks)` arrays with validity derived from per-row peak counts;
  this is the idiomatic TPU layout (static shapes, masked lanes).

Reference counterparts: ann_solo/spectrum.py:57-271.

The port's copy of `ann_solo_tpu/models/spectrum.py` (the port imports nothing of
the JAX package); `tests/test_torch_engine_io.py` holds it equal.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np

# Ion-type byte codes used in columnar annotation storage
# (mirrors reader.py:599-629 in the reference).
ION_TYPE_CODES: Dict[str, int] = {
    "a": 1, "b": 2, "c": 3, "x": 4, "y": 5, "z": 6,
    "I": 7, "m": 8, "p": 9, "r": 10,
}
ION_TYPE_NAMES: Dict[int, str] = {v: k for k, v in ION_TYPE_CODES.items()}


@dataclasses.dataclass
class Spectrum:
    """A single MS/MS spectrum (host side)."""

    identifier: str
    precursor_mz: float
    precursor_charge: Optional[int]
    mz: np.ndarray
    intensity: np.ndarray
    retention_time: Optional[float] = None
    # Columnar peak annotations (parallel to mz/intensity):
    #   ion type code (0 = unannotated), ion index, fragment charge (0 = ?).
    ann_type: Optional[np.ndarray] = None
    ann_index: Optional[np.ndarray] = None
    ann_charge: Optional[np.ndarray] = None
    peptide: Optional[str] = None
    is_decoy: bool = False
    index: int = -1

    def __post_init__(self) -> None:
        self.mz = np.asarray(self.mz, np.float64)
        self.intensity = np.asarray(self.intensity, np.float64)
        order = np.argsort(self.mz, kind="stable")
        if not np.array_equal(order, np.arange(len(order))):
            self.mz = self.mz[order]
            self.intensity = self.intensity[order]
            for field in ("ann_type", "ann_index", "ann_charge"):
                arr = getattr(self, field)
                if arr is not None:
                    setattr(self, field, np.asarray(arr)[order])

    @property
    def n_peaks(self) -> int:
        return len(self.mz)

    def annotation_charges(self) -> np.ndarray:
        """Per-peak annotation charge (0 if unannotated), uint8.

        Mirrors the extraction in the reference Cython bridge
        (spectrum_match.pyx:73-85).
        """
        if self.ann_charge is None:
            return np.zeros(self.n_peaks, np.uint8)
        return np.asarray(self.ann_charge, np.uint8)


@dataclasses.dataclass
class SpectrumBatch:
    """A padded batch of raw spectra ready for device preprocessing."""

    mz: np.ndarray  # (B, P) float32
    intensity: np.ndarray  # (B, P) float32
    ann_charge: np.ndarray  # (B, P) uint8
    n_peaks: np.ndarray  # (B,) int32
    precursor_mz: np.ndarray  # (B,) float32
    precursor_charge: np.ndarray  # (B,) int32

    @property
    def batch_size(self) -> int:
        return self.mz.shape[0]


def pack_spectra(
    spectra,
    pad_to: Optional[int] = None,
    pad_multiple: int = 64,
) -> SpectrumBatch:
    """Pack host spectra into a padded `SpectrumBatch`.

    The peak axis is padded to `pad_to` (or the next multiple of
    `pad_multiple` above the longest spectrum) so repeated calls reuse a
    small set of compiled shapes.
    """
    n = len(spectra)
    max_p = max((s.n_peaks for s in spectra), default=1)
    if pad_to is None:
        pad_to = max(pad_multiple, -(-max_p // pad_multiple) * pad_multiple)
    elif pad_to < max_p:
        raise ValueError(f"pad_to={pad_to} < longest spectrum {max_p}")
    mz = np.zeros((n, pad_to), np.float32)
    intensity = np.zeros((n, pad_to), np.float32)
    ann_charge = np.zeros((n, pad_to), np.uint8)
    n_peaks = np.zeros(n, np.int32)
    precursor_mz = np.zeros(n, np.float32)
    precursor_charge = np.zeros(n, np.int32)
    for i, s in enumerate(spectra):
        k = s.n_peaks
        mz[i, :k] = s.mz
        intensity[i, :k] = s.intensity
        ann_charge[i, :k] = s.annotation_charges()
        n_peaks[i] = k
        precursor_mz[i] = s.precursor_mz
        precursor_charge[i] = 0 if s.precursor_charge is None \
            else s.precursor_charge
    return SpectrumBatch(
        mz, intensity, ann_charge, n_peaks, precursor_mz, precursor_charge
    )


class SpectrumSpectrumMatch:
    """A match between a query spectrum and a library spectrum.

    Reference counterpart: ann_solo/spectrum.py:217-271.  Peak data are the
    *processed* peak arrays used for scoring.
    """

    __slots__ = (
        "query_spectrum", "library_spectrum", "peak_matches",
        "search_engine_score", "q", "num_candidates",
    )

    def __init__(
        self,
        query_spectrum: Spectrum,
        library_spectrum: Optional[Spectrum] = None,
        peak_matches: Optional[np.ndarray] = None,
        search_engine_score: float = math.nan,
        q: float = math.nan,
        num_candidates: int = 0,
    ):
        self.query_spectrum = query_spectrum
        self.library_spectrum = library_spectrum
        self.peak_matches = peak_matches
        self.search_engine_score = search_engine_score
        self.q = q
        self.num_candidates = num_candidates

    @property
    def sequence(self):
        return (self.library_spectrum.peptide
                if self.library_spectrum is not None else None)

    @property
    def query_identifier(self):
        return self.query_spectrum.identifier

    @property
    def query_index(self):
        return self.query_spectrum.index

    @property
    def library_identifier(self):
        return (self.library_spectrum.identifier
                if self.library_spectrum is not None else None)

    @property
    def retention_time(self):
        return self.query_spectrum.retention_time

    @property
    def charge(self):
        return self.query_spectrum.precursor_charge

    @property
    def exp_mass_to_charge(self):
        return self.query_spectrum.precursor_mz

    @property
    def calc_mass_to_charge(self):
        return (self.library_spectrum.precursor_mz
                if self.library_spectrum is not None else None)

    @property
    def is_decoy(self):
        return (self.library_spectrum.is_decoy
                if self.library_spectrum is not None else None)
