"""FASTA-derived predicted spectral libraries
(reference: ann_solo/reader.py:941-1020).

The port of `ann_solo_tpu/io/fasta.py`: reads protein sequences, digests
them in silico and predicts target and decoy spectra for the resulting
peptides.  The reference predicts them through a remote Koina/Prosit
server, which the JAX package calls through `ann_solo_tpu/prosit.py`
(koinapy, pandas and the network); this package has no such client and
goes straight to the JAX package's deterministic local fragment-ion
predictor -- b/y ions with mobile-proton-flavored intensity heuristics --
after one WARNING, as the JAX package does when Koina is unavailable.
"""

from __future__ import annotations

import logging
from typing import Iterator, List

import numpy as np

from ann_solo_tpu_torch.decoy import _shuffle
from ann_solo_tpu_torch.io import masses
from ann_solo_tpu_torch.models.spectrum import ION_TYPE_CODES, Spectrum

logger = logging.getLogger(__name__)


def read_fasta_proteins(filename: str) -> List[str]:
    """Protein sequences from a FASTA file."""
    proteins: List[str] = []
    current: List[str] = []
    with open(filename) as f_in:
        for line in f_in:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if current:
                    proteins.append("".join(current))
                current = []
            else:
                current.append(line)
    if current:
        proteins.append("".join(current))
    return proteins


def _predicted_spectrum(
    peptide: str,
    charge: int,
    identifier: str,
    is_decoy: bool,
) -> Spectrum:
    """Deterministic local b/y-ion prediction (the Prosit stand-in)."""
    proteoform = masses.parse_proforma(peptide)
    frags = masses.theoretical_fragments(
        proteoform, "by", max_charge=min(charge, 2)
    )
    mz, intensity = [], []
    ann_type, ann_index, ann_charge = [], [], []
    n = len(proteoform.sequence)
    for label, frag_mz in sorted(frags.items(), key=lambda kv: kv[1]):
        ion, chg = label.split("^")
        idx = int(ion[1:])
        # Mid-sequence fragments are most intense (simple HCD prior).
        rel = idx / n
        base = np.exp(-(((rel - 0.5) / 0.35) ** 2))
        if ion[0] == "y":
            base *= 1.4  # y ions dominate tryptic HCD spectra
        if int(chg) > 1:
            base *= 0.35
        mz.append(frag_mz)
        intensity.append(base)
        ann_type.append(ION_TYPE_CODES[ion[0]])
        ann_index.append(idx)
        ann_charge.append(int(chg))
    return Spectrum(
        identifier=identifier,
        precursor_mz=proteoform.precursor_mz(charge),
        precursor_charge=charge,
        mz=np.asarray(mz),
        intensity=np.asarray(intensity),
        ann_type=np.asarray(ann_type, np.uint8),
        ann_index=np.asarray(ann_index, np.int16),
        ann_charge=np.asarray(ann_charge, np.uint8),
        peptide=peptide,
        is_decoy=is_decoy,
    )


def read_fasta(filename: str, config) -> Iterator[Spectrum]:
    """Generate target + decoy predicted spectra from a FASTA file.

    Mirrors the reference pipeline (reader.py:941-1020): digest -> enumerate
    (peptide, charge, collision energy) -> predict targets -> shuffle
    peptides -> predict decoys.
    """
    proteins = read_fasta_proteins(filename)
    peptides = sorted(
        set().union(
            *[
                masses.cleave(
                    protein, config.protease, config.missed_cleavages
                )
                for protein in proteins
            ]
        )
    )
    logger.info(
        "Digested %d proteins into %d peptides", len(proteins),
        len(peptides),
    )
    jobs: List[tuple] = []
    for collision_energy in config.collision_energies:
        for charge in range(
            config.min_precursor_charge, config.max_precursor_charge + 1
        ):
            for peptide in peptides:
                jobs.append((peptide, charge, collision_energy))

    logger.warning(
        "Prosit/Koina prediction unavailable (ann_solo_tpu_torch has no "
        "remote prediction client); using the local fragment-ion predictor"
    )
    for i, (peptide, charge, _ce) in enumerate(jobs):
        yield _predicted_spectrum(peptide, charge, str(i), False)
    for i, (peptide, charge, _ce) in enumerate(jobs):
        decoy_peptide, _ = _shuffle(peptide)
        yield _predicted_spectrum(
            decoy_peptide, charge, f"DECOY_{i}", True
        )
