"""Shuffle-and-reposition decoy generation
(reference: ann_solo/decoy_generator.py).

Creates a decoy spectrum from a real library spectrum by shuffling the
peptide sequence (keeping tryptic residues K/R/P and the C-terminal residue
in place, requiring <= 0.7 sequence similarity over 10 attempts), carrying
modifications to their shuffled positions, and repositioning annotated
fragment peaks to the decoy peptide's theoretical m/z while preserving each
peak's original mass error.

The port's copy of `ann_solo_tpu/decoy.py` (the port imports nothing of
the JAX package); `tests/test_torch_engine_io.py` holds it equal.
"""

from __future__ import annotations

from difflib import ndiff
from typing import Dict, List, Tuple

import numpy as np

from ann_solo_tpu_torch.config import config
from ann_solo_tpu_torch.io import masses
from ann_solo_tpu_torch.models.spectrum import ION_TYPE_CODES, Spectrum

_ION_NAME = {v: k for k, v in ION_TYPE_CODES.items()}


def _shuffle(
    peptide_sequence: str,
    excluded_residues: Tuple[str, ...] = ("K", "R", "P"),
    max_similarity: float = 0.7,
) -> Tuple[str, Dict[int, int]]:
    """Shuffle a peptide, fixing excluded residues and the last position.

    Returns the shuffled sequence and the old->new position mapping
    (reference decoy_generator.py:10-65).
    """
    seq = list(peptide_sequence)
    fixed = {
        i for i, aa in enumerate(seq[:-1]) if aa in excluded_residues
    }
    fixed.add(len(seq) - 1)
    movable = [i for i in range(len(seq)) if i not in fixed]

    best_similarity, best_shuffled, best_perm = 1.0, peptide_sequence, list(
        range(len(seq))
    )
    for _ in range(10):
        permuted = list(np.random.permutation(movable))
        full_perm = [
            permuted.pop(0) if i not in fixed else i
            for i in range(len(seq))
        ]
        shuffled = "".join(seq[p] for p in full_perm)
        edit_distance = sum(
            1 for x in ndiff(list(shuffled), seq) if x[0] != " "
        )
        similarity = 1 - edit_distance / len(seq)
        if similarity <= max_similarity:
            return shuffled, {full_perm[i]: i for i in range(len(seq))}
        elif similarity < best_similarity:
            best_similarity, best_shuffled, best_perm = (
                similarity, shuffled, full_perm
            )
    return best_shuffled, {best_perm[i]: i for i in range(len(seq))}


def _annotate_peaks(
    spectrum: Spectrum,
    theoretical: Dict[str, float],
    fragment_mz_tolerance: float,
    fragment_tol_mode: str,
) -> List[str]:
    """Assign each peak the closest theoretical fragment within tolerance.

    Stands in for spectrum_utils' annotate_proforma
    (decoy_generator.py:107-109): returns one annotation label (or "") per
    peak.
    """
    labels = sorted(theoretical)
    theo_mz = np.asarray([theoretical[label] for label in labels])
    order = np.argsort(theo_mz)
    theo_mz = theo_mz[order]
    labels = [labels[i] for i in order]
    annotations: List[str] = []
    for mz in spectrum.mz:
        pos = np.searchsorted(theo_mz, mz)
        best_label, best_diff = "", np.inf
        for j in (pos - 1, pos):
            if 0 <= j < len(theo_mz):
                diff = abs(theo_mz[j] - mz)
                tol = (
                    fragment_mz_tolerance
                    if fragment_tol_mode == "Da"
                    else fragment_mz_tolerance * mz / 1e6
                )
                if diff <= tol and diff < best_diff:
                    best_label, best_diff = labels[j], diff
        annotations.append(best_label)
    return annotations


def shuffle_and_reposition(spectrum: Spectrum) -> Spectrum:
    """Create a decoy spectrum from a real spectrum
    (reference decoy_generator.py:93-185)."""
    if not spectrum.peptide:
        raise ValueError(
            f"Cannot generate a decoy for unidentified spectrum "
            f"{spectrum.identifier}"
        )
    proteoform = masses.parse_proforma(spectrum.peptide)
    max_charge = max(int(spectrum.precursor_charge or 1), 1)
    target_frags = masses.theoretical_fragments(
        proteoform, "abpy", max_charge, neutral_losses=True
    )
    annotations = _annotate_peaks(
        spectrum,
        target_frags,
        float(config.fragment_mz_tolerance),
        str(config.fragment_tol_mode),
    )

    shuffled_seq, mapping = _shuffle(proteoform.sequence)
    decoy_mods = {}
    for pos, mass in proteoform.mods.items():
        if pos in (-1, len(proteoform.sequence)):
            decoy_mods[pos] = mass
        else:
            decoy_mods[mapping[pos]] = mass
    decoy_proteoform = masses.Proteoform(shuffled_seq, decoy_mods)
    decoy_frags = masses.theoretical_fragments(
        decoy_proteoform, "abpy", max_charge, neutral_losses=True
    )

    mz_shuffled = np.array(spectrum.mz, np.float64)
    ann_type = np.zeros(spectrum.n_peaks, np.uint8)
    ann_index = np.zeros(spectrum.n_peaks, np.int16)
    ann_charge = np.zeros(spectrum.n_peaks, np.uint8)
    for i, label in enumerate(annotations):
        if not label:
            continue
        ion, charge_str = label.split("^")
        ion_type = ion[0]
        idx_digits = ""
        for ch in ion[1:]:
            if ch.isdigit():
                idx_digits += ch
            else:
                break
        ann_type[i] = ION_TYPE_CODES.get(ion_type, 0)
        ann_index[i] = int(idx_digits) if idx_digits else 0
        ann_charge[i] = int(charge_str)
        # Reposition, preserving the original mass error
        # (decoy_generator.py:162-166).
        if label in decoy_frags:
            mz_shuffled[i] = decoy_frags[label] + (
                spectrum.mz[i] - target_frags[label]
            )
    order = np.argsort(mz_shuffled, kind="stable")
    decoy = Spectrum(
        identifier=f"DECOY_{spectrum.identifier}",
        precursor_mz=spectrum.precursor_mz,
        precursor_charge=spectrum.precursor_charge,
        mz=mz_shuffled[order],
        intensity=np.asarray(spectrum.intensity)[order],
        ann_type=ann_type[order],
        ann_index=ann_index[order],
        ann_charge=ann_charge[order],
        peptide=decoy_proteoform.to_proforma(),
        is_decoy=True,
    )
    return decoy
