"""Peptide mass math and minimal ProForma handling.

Replaces the reference's dependency on pyteomics.mass / spectrum_utils
(proforma parsing, theoretical fragment generation) with a small
self-contained implementation.  Monoisotopic masses follow CODATA/Unimod
values used across proteomics tooling.

The port's copy of `ann_solo_tpu/io/masses.py` (the port imports nothing of
the JAX package); `tests/test_torch_engine_io.py` holds it equal.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Tuple

# Monoisotopic residue masses (Da).
AA_MASS: Dict[str, float] = {
    "G": 57.02146372057,
    "A": 71.03711378471,
    "S": 87.03202840427,
    "P": 97.05276384885,
    "V": 99.06841391299,
    "T": 101.04767846841,
    "C": 103.00918478471,
    "L": 113.08406397713,
    "I": 113.08406397713,
    "N": 114.04292744114,
    "D": 115.02694302383,
    "Q": 128.05857750528,
    "K": 128.09496301399,
    "E": 129.04259308797,
    "M": 131.04048491299,
    "H": 137.05891185845,
    "F": 147.06841391299,
    "R": 156.10111102359,
    "Y": 163.06332853255,
    "W": 186.07931294985,
    "U": 150.95363508471,  # selenocysteine
    "O": 237.14772686528,  # pyrrolysine
}

H2O = 18.0105646863
PROTON = 1.00727646677
CO = 27.99491461956
NH3 = 17.02654910101
NEUTRON = 1.00335483507  # C13 - C12 isotope spacing

# Common (Unimod) modification names -> monoisotopic delta mass.
MOD_MASS: Dict[str, float] = {
    "carbamidomethyl": 57.02146,
    "cam": 57.02146,
    "oxidation": 15.99491,
    "phospho": 79.96633,
    "phosphorylation": 79.96633,
    "acetyl": 42.01057,
    "acetylation": 42.01057,
    "methyl": 14.01565,
    "dimethyl": 28.03130,
    "trimethyl": 42.04695,
    "deamidation": 0.98402,
    "deamidated": 0.98402,
    "pyro-glu": -17.02655,
    "gln->pyro-glu": -17.02655,
    "glu->pyro-glu": -18.01056,
    "carbamyl": 43.00581,
    "tmt6plex": 229.16293,
    "itraq4plex": 144.10207,
    "icat-c": 227.12601,
    "propionamide": 71.03711,
}


@dataclasses.dataclass
class Proteoform:
    """A parsed ProForma peptidoform: bare sequence + positional mod masses.

    `mods` maps a residue position to a summed modification delta mass.
    Position -1 denotes an N-terminal modification; `len(sequence)` denotes a
    C-terminal modification.
    """

    sequence: str
    mods: Dict[int, float] = dataclasses.field(default_factory=dict)

    @property
    def mass(self) -> float:
        """Monoisotopic neutral peptide mass (Da)."""
        return (
            sum(AA_MASS[aa] for aa in self.sequence)
            + sum(self.mods.values())
            + H2O
        )

    def precursor_mz(self, charge: int) -> float:
        return (self.mass + charge * PROTON) / charge

    def to_proforma(self) -> str:
        """Serialize back to a ProForma-style string."""
        parts: List[str] = []
        if -1 in self.mods:
            parts.append(f"[{_fmt_mod(self.mods[-1])}]-")
        for i, aa in enumerate(self.sequence):
            parts.append(aa)
            if i in self.mods:
                parts.append(f"[{_fmt_mod(self.mods[i])}]")
        if len(self.sequence) in self.mods:
            parts.append(f"-[{_fmt_mod(self.mods[len(self.sequence)])}]")
        return "".join(parts)


def _fmt_mod(mass: float) -> str:
    return f"{mass:+.9g}"


_MOD_TOKEN = re.compile(r"\[([^\[\]]*)\]")


def _mod_mass(token: str) -> float:
    """Resolve a bracketed modification token to a delta mass."""
    token = token.strip()
    # Numeric deltas ("+57.02146", "-17.027", "42").
    try:
        return float(token)
    except ValueError:
        pass
    # "UNIMOD:35"-style or named mods, possibly "name:value".
    lowered = token.lower()
    if lowered in MOD_MASS:
        return MOD_MASS[lowered]
    if ":" in token:
        tail = token.rsplit(":", 1)[1]
        try:
            return float(tail)
        except ValueError:
            lowered_tail = tail.lower()
            if lowered_tail in MOD_MASS:
                return MOD_MASS[lowered_tail]
    raise ValueError(f"Unknown modification: {token!r}")


def parse_proforma(peptide: str) -> Proteoform:
    """Parse a (simple) ProForma peptidoform string.

    Supports bare sequences, `X[+42.01]` positional mods, `[+42.01]-PEPTIDE`
    N-terminal mods, `PEPTIDE-[+42.01]` C-terminal mods, and named mods from
    the built-in table.  (Reference counterpart: spectrum_utils.proforma,
    used by ann_solo/decoy_generator.py:111.)
    """
    mods: Dict[int, float] = {}
    seq_chars: List[str] = []
    i = 0
    n = len(peptide)
    # N-terminal modification(s): one or more leading [..] groups ending in -.
    while i < n and peptide[i] == "[":
        match = _MOD_TOKEN.match(peptide, i)
        if match is None:
            raise ValueError(f"Unbalanced modification bracket in {peptide!r}")
        mods[-1] = mods.get(-1, 0.0) + _mod_mass(match.group(1))
        i = match.end()
        if i < n and peptide[i] == "-":
            i += 1
    while i < n:
        ch = peptide[i]
        if ch == "-" and i + 1 < n and peptide[i + 1] == "[":
            # C-terminal modification.
            match = _MOD_TOKEN.match(peptide, i + 1)
            if match is None:
                raise ValueError(
                    f"Unbalanced modification bracket in {peptide!r}"
                )
            pos = len(seq_chars)
            mods[pos] = mods.get(pos, 0.0) + _mod_mass(match.group(1))
            i = match.end()
        elif ch == "[":
            match = _MOD_TOKEN.match(peptide, i)
            if match is None:
                raise ValueError(
                    f"Unbalanced modification bracket in {peptide!r}"
                )
            pos = len(seq_chars) - 1
            mods[pos] = mods.get(pos, 0.0) + _mod_mass(match.group(1))
            i = match.end()
        elif ch.isalpha():
            seq_chars.append(ch.upper())
            i += 1
        else:
            raise ValueError(f"Unexpected character {ch!r} in {peptide!r}")
    return Proteoform("".join(seq_chars), mods)


def peptide_mass(peptide: str) -> float:
    """Monoisotopic neutral mass of a (possibly modified) peptide string."""
    return parse_proforma(peptide).mass


def precursor_mz(peptide: str, charge: int) -> float:
    return parse_proforma(peptide).precursor_mz(charge)


def theoretical_fragments(
    proteoform: Proteoform,
    ion_types: str = "by",
    max_charge: int = 1,
    neutral_losses: bool = False,
) -> Dict[str, float]:
    """Compute theoretical fragment m/z values.

    Returns a dict keyed by annotation label ``{ion}{index}[±loss]^{charge}``
    (e.g. ``"b2^1"``, ``"y3-H2O^2"``, ``"p^2"``) to fragment m/z.  Mirrors
    the role of spectrum_utils.fragment_annotation.get_theoretical_fragments
    (used by ann_solo/decoy_generator.py:118-137).
    """
    seq = proteoform.sequence
    mods = proteoform.mods
    n = len(seq)
    residue = [AA_MASS[aa] + mods.get(i, 0.0) for i, aa in enumerate(seq)]
    nterm_mod = mods.get(-1, 0.0)
    cterm_mod = mods.get(n, 0.0)
    # Prefix sums of residue masses.
    prefix = [0.0]
    for m in residue:
        prefix.append(prefix[-1] + m)
    total = prefix[-1] + nterm_mod + cterm_mod + H2O

    losses: List[Tuple[str, float]] = [("", 0.0)]
    if neutral_losses:
        losses += [("-H2O", H2O), ("-NH3", NH3)]

    out: Dict[str, float] = {}
    for charge in range(1, max_charge + 1):
        for loss_label, loss in losses:
            for i in range(1, n):
                # N-terminal fragments (a/b ions span residues [0, i)).
                b_neutral = prefix[i] + nterm_mod
                y_neutral = total - prefix[i] - nterm_mod
                if "b" in ion_types:
                    out[f"b{i}{loss_label}^{charge}"] = (
                        b_neutral - loss + charge * PROTON
                    ) / charge
                if "a" in ion_types:
                    out[f"a{i}{loss_label}^{charge}"] = (
                        b_neutral - CO - loss + charge * PROTON
                    ) / charge
                if "y" in ion_types:
                    out[f"y{i}{loss_label}^{charge}"] = (
                        (total - prefix[n - i] - nterm_mod)
                        - loss
                        + charge * PROTON
                    ) / charge
                del y_neutral
            if "p" in ion_types:
                out[f"p{loss_label}^{charge}"] = (
                    total - loss + charge * PROTON
                ) / charge
    return out


_CLEAVAGE_RULES: Dict[str, str] = {
    # Simplified expasy rules (pyteomics.parser.expasy_rules equivalents).
    "trypsin": r"([KR](?=[^P]))",
    "trypsin/p": r"([KR])",
    "lys-c": r"(K(?=[^P]))",
    "arg-c": r"(R(?=[^P]))",
    "chymotrypsin": r"([FYWL](?=[^P]))",
    "glu-c": r"(E(?=[^P]))",
}


def cleave(
    sequence: str,
    protease: str = "trypsin",
    missed_cleavages: int = 2,
    min_length: int = 6,
    max_length: int = 50,
) -> List[str]:
    """In-silico protein digestion (pyteomics.parser.cleave equivalent)."""
    rule = _CLEAVAGE_RULES.get(protease.lower())
    if rule is None:
        raise ValueError(f"Unsupported protease: {protease}")
    sites = [0]
    for match in re.finditer(rule, sequence):
        sites.append(match.start() + 1)
    sites.append(len(sequence))
    peptides = set()
    for i in range(len(sites) - 1):
        for j in range(i + 1, min(i + 2 + missed_cleavages, len(sites))):
            pep = sequence[sites[i] : sites[j]]
            if min_length <= len(pep) <= max_length and all(
                aa in AA_MASS for aa in pep
            ):
                peptides.add(pep)
    return sorted(peptides)


def mass_diff(mz1: float, mz2: float, mode_is_da: bool) -> float:
    """Mass difference in Da or ppm (spectrum_utils.utils.mass_diff)."""
    return mz1 - mz2 if mode_is_da else (mz1 - mz2) / mz2 * 10**6
