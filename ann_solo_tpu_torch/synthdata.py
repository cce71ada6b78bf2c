"""Synthetic peptide spectrum factories (tests + quality benchmarks).

Mirrors the reference test strategy (SURVEY.md §4): simulated b/y-ion
spectra of known peptides with real mass math, written to real file
formats.  The JAX package's quality benchmark and `chip_smoke.py` build
iPRG2012-style corpora from these factories: a large spectral library,
noisy unmodified query observations, and modified queries whose mass
shifts follow a realistic PTM frequency profile.

The port's copy of `ann_solo_tpu/synthdata.py` (the port imports nothing of
the JAX package); `tests/test_torch_engine_io.py` holds it equal.
"""

from __future__ import annotations

import numpy as np

from ann_solo_tpu_torch.io import masses
from ann_solo_tpu_torch.models.spectrum import ION_TYPE_CODES, Spectrum

AMINO_ACIDS = "ACDEFGHIKLMNPQRSTVWY"

# Common open-modification mass deltas with approximate relative
# frequencies (the iPRG2012 mass-difference histogram profile,
# reference notebooks/iprg2012_fdr.ipynb): oxidation, deamidation,
# carbamidomethyl, acetyl, phospho, methyl, water/ammonia loss, ...
MOD_MASSES = np.asarray(
    [15.994915, 0.984016, 57.021464, 42.010565, 79.966331,
     14.015650, -18.010565, -17.026549, 28.031300, 156.101111]
)
MOD_WEIGHTS = np.asarray(
    [0.25, 0.15, 0.12, 0.10, 0.10, 0.08, 0.08, 0.06, 0.04, 0.02]
)
MOD_WEIGHTS = MOD_WEIGHTS / MOD_WEIGHTS.sum()


def random_peptide(rng, min_len=9, max_len=14) -> str:
    length = rng.integers(min_len, max_len + 1)
    residues = [AMINO_ACIDS[i]
                for i in rng.integers(0, len(AMINO_ACIDS), length - 1)]
    return "".join(residues) + ("K" if rng.random() < 0.5 else "R")


def peptide_spectrum(
    peptide: str,
    charge: int,
    identifier: str,
    rng,
    is_decoy: bool = False,
) -> Spectrum:
    """A b/y-ion spectrum of a peptide with annotations."""
    proteoform = masses.parse_proforma(peptide)
    frags = masses.theoretical_fragments(
        proteoform, "by", max_charge=min(charge, 2)
    )
    mz, intensity = [], []
    ann_type, ann_index, ann_charge = [], [], []
    for label, frag_mz in sorted(frags.items(), key=lambda kv: kv[1]):
        if not (120.0 <= frag_mz <= 1800.0):
            continue
        ion, chg = label.split("^")
        mz.append(frag_mz)
        intensity.append(float(rng.uniform(0.05, 1.0)))
        ann_type.append(ION_TYPE_CODES[ion[0]])
        ann_index.append(int(ion[1:]))
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


def noisy_query(
    spectrum: Spectrum,
    rng,
    identifier: str,
    mz_jitter: float = 0.003,
    drop_frac: float = 0.1,
    n_noise_peaks: int = 4,
) -> Spectrum:
    """A query observation of a library spectrum: jitter + dropout + noise."""
    keep = rng.random(spectrum.n_peaks) > drop_frac
    if keep.sum() < 10:
        keep[:] = True
    mz = spectrum.mz[keep] + rng.normal(0, mz_jitter, keep.sum())
    intensity = spectrum.intensity[keep] * rng.uniform(
        0.7, 1.3, keep.sum()
    )
    noise_mz = rng.uniform(150, 1500, n_noise_peaks)
    noise_int = rng.uniform(0.05, 0.3, n_noise_peaks)
    return Spectrum(
        identifier=identifier,
        precursor_mz=spectrum.precursor_mz
        + rng.normal(0, 0.002 / spectrum.precursor_charge),
        precursor_charge=spectrum.precursor_charge,
        mz=np.concatenate([mz, noise_mz]),
        intensity=np.concatenate([intensity, noise_int]),
        retention_time=float(rng.uniform(10, 90)),
    )


def modified_query(
    peptide: str,
    library_spectrum: Spectrum,
    rng,
    identifier: str,
    mod_mass: float = 15.994915,
) -> Spectrum:
    """A query of the peptide carrying `mod_mass` on a middle residue.

    Fragment peaks containing the modified residue shift by mod_mass /
    fragment charge; the precursor shifts by mod_mass / precursor charge.
    Open search with the shifted dot product should still match it to the
    unmodified library spectrum.
    """
    charge = library_spectrum.precursor_charge
    mod_pos = len(peptide) // 2
    mz = np.array(library_spectrum.mz, np.float64)
    for i in range(library_spectrum.n_peaks):
        ion_type = int(library_spectrum.ann_type[i])
        ion_index = int(library_spectrum.ann_index[i])
        frag_charge = max(int(library_spectrum.ann_charge[i]), 1)
        if ion_type == ION_TYPE_CODES["b"]:
            contains_mod = ion_index > mod_pos
        elif ion_type == ION_TYPE_CODES["y"]:
            contains_mod = ion_index > (len(peptide) - 1 - mod_pos)
        else:
            contains_mod = False
        if contains_mod:
            mz[i] = mz[i] + mod_mass / frag_charge
    base = Spectrum(
        identifier=identifier,
        precursor_mz=library_spectrum.precursor_mz + mod_mass / charge,
        precursor_charge=charge,
        mz=mz,
        intensity=np.array(library_spectrum.intensity),
    )
    return noisy_query(base, rng, identifier, n_noise_peaks=2)


def make_library(rng, n_peptides=80, charges=(2, 3)):
    """A synthetic spectral library: one spectrum per (peptide, charge)."""
    peptides = []
    seen = set()
    while len(peptides) < n_peptides:
        peptide = random_peptide(rng)
        if peptide not in seen:
            seen.add(peptide)
            peptides.append(peptide)
    spectra = []
    for i, peptide in enumerate(peptides):
        charge = charges[i % len(charges)]
        spectra.append(
            peptide_spectrum(peptide, charge, str(i + 1), rng)
        )
    return peptides, spectra


def random_mod_mass(rng) -> float:
    """Sample a modification mass from the realistic PTM profile."""
    return float(rng.choice(MOD_MASSES, p=MOD_WEIGHTS))


def make_corpus(
    rng,
    n_peptides: int,
    n_queries: int,
    charges=(2, 3),
    frac_modified: float = 0.35,
    frac_foreign: float = 0.05,
):
    """An iPRG2012-style benchmark corpus.

    Returns (library_spectra, query_spectra, truth) where truth maps each
    query identifier to its source peptide (None for foreign queries,
    which have no library counterpart and should be rejected by FDR).
    """
    peptides, library = make_library(rng, n_peptides, charges)
    queries = []
    truth = {}
    n_foreign = int(n_queries * frac_foreign)
    n_modified = int(n_queries * frac_modified)
    n_unmod = n_queries - n_foreign - n_modified
    rows = rng.integers(0, len(library), n_unmod)
    for i, row in enumerate(rows):
        qid = f"q_unmod_{i}"
        queries.append(noisy_query(library[row], rng, qid))
        truth[qid] = peptides[row]
    rows = rng.integers(0, len(library), n_modified)
    for i, row in enumerate(rows):
        qid = f"q_mod_{i}"
        queries.append(
            modified_query(
                peptides[row], library[row], rng, qid,
                mod_mass=random_mod_mass(rng),
            )
        )
        truth[qid] = peptides[row]
    seen = set(peptides)
    for i in range(n_foreign):
        while True:
            foreign = random_peptide(rng)
            if foreign not in seen:
                seen.add(foreign)
                break
        spectrum = peptide_spectrum(
            foreign, charges[i % len(charges)], f"q_foreign_{i}", rng
        )
        qid = f"q_foreign_{i}"
        queries.append(noisy_query(spectrum, rng, qid))
        truth[qid] = None
    rng.shuffle(queries)
    return library, queries, truth
