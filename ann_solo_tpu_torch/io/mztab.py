"""mzTab 1.0 output writer and readers (reference: ann_solo/writer.py,
reader.py:1023-1055).

The port's copy of `ann_solo_tpu/io/mztab.py`, with an SSM reader that
needs no pandas (`read_mztab_ssms` returns an `SsmTable`): the software
name and columns stay ANN-SoLo-TPU's, so each package's readers, `eval`
and `plot` read the other's files.

Every result file embeds the full search configuration in its metadata
section, making outputs self-describing (and re-parseable by the plotting
CLI), exactly like the reference.
"""

from __future__ import annotations

import logging
import os
import pathlib
import re
from typing import AnyStr, Dict, List, Pattern, Union

import numpy as np

logger = logging.getLogger(__name__)


def natural_sort_key(
    s: str, _nsre: Pattern[AnyStr] = re.compile("([0-9]+)")
) -> List[Union[str, int]]:
    """Natural sorting of mixed alphanumeric strings
    (reference writer.py:16-37)."""
    return [
        int(text) if text.isdigit() else text.lower()
        for text in re.split(_nsre, s)
    ]


def write_mztab(
    identifications, filename: str, lib_version: str, config,
    query_filename: str = None,
) -> str:
    """Write SSMs to an mzTab file (reference writer.py:40-150).

    `query_filename` overrides the config value in the metadata block
    (multi-file fan-out runs write one mzTab per query file).
    """
    from ann_solo_tpu_torch import __version__

    if query_filename is None:
        query_filename = config.query_filename
    if os.path.splitext(filename)[1].lower() != ".mztab":
        filename += ".mztab"
    logger.info("Save identifications to file %s", filename)

    metadata = [
        ("mzTab-version", "1.0.0"),
        ("mzTab-mode", "Summary"),
        ("mzTab-type", "Identification"),
        ("mzTab-ID", f"ANN-SoLo-TPU_{filename}"),
        ("title", f'ANN-SoLo-TPU identification file "{filename}"'),
        (
            "description",
            f'Identification results of file '
            f'"{os.path.split(query_filename)[1]}" against spectral '
            f'library file '
            f'"{os.path.split(config.spectral_library_filename)[1]}"',
        ),
        ("software[1]", f"[MS, MS:1001456, ANN-SoLo-TPU, {__version__}]"),
        (
            "psm_search_engine_score[1]",
            "[MS, MS:1001143, search engine specific score for PSMs,]",
        ),
        (
            "psm_search_engine_score[2]",
            "[MS, MS:1002354, PSM-level q-value,]",
        ),
        ("ms_run[1]-format", "[MS, MS:1001062, Mascot MGF file,]"),
        (
            "ms_run[1]-location",
            pathlib.Path(os.path.abspath(query_filename)).as_uri(),
        ),
        (
            "ms_run[1]-id_format",
            "[MS, MS:1000774, multiple peak list nativeID format,]",
        ),
        (
            "fixed_mod[1]",
            "[MS, MS:1002453, No fixed modifications searched,]",
        ),
        (
            "variable_mod[1]",
            "[MS, MS:1002454, No variable modifications searched,]",
        ),
        (
            "false_discovery_rate",
            f"[MS, MS:1002350, PSM-level global FDR, {config.fdr}]",
        ),
    ]
    config_keys = [
        "resolution", "min_mz", "max_mz", "remove_precursor",
        "remove_precursor_tolerance", "min_intensity", "min_peaks",
        "min_mz_range", "max_peaks_used", "max_peaks_used_library",
        "scaling", "precursor_tolerance_mass", "precursor_tolerance_mode",
        "precursor_tolerance_mass_open", "precursor_tolerance_mode_open",
        "fragment_mz_tolerance", "allow_peak_shifts", "fdr",
        "fdr_min_group_size", "mode",
    ]
    if config.mode == "ann":
        config_keys.extend(
            ["bin_size", "hash_len", "num_candidates", "num_list",
             "num_probe"]
        )
    for i, key in enumerate(config_keys):
        metadata.append(
            (f"software[1]-setting[{i}]", f"{key} = {config[key]}")
        )

    with open(filename, "w") as f_out:
        for m in metadata:
            f_out.write("\t".join(["MTD"] + list(m)) + "\n")
        f_out.write(
            "\t".join(
                [
                    "PSH", "sequence", "PSM_ID", "accession", "unique",
                    "database", "database_version", "search_engine",
                    "search_engine_score[1]", "search_engine_score[2]",
                    "modifications", "retention_time", "charge",
                    "exp_mass_to_charge", "calc_mass_to_charge",
                    "spectra_ref", "pre", "post", "start", "end",
                    "opt_ms_run[1]_cv_MS:1003062_spectrum_index",
                    "opt_ms_run[1]_cv_MS:1002217_decoy_peptide",
                    "opt_ms_run[1]_num_candidates",
                ]
            )
            + "\n"
        )
        for ssm in sorted(
            identifications,
            key=lambda s: natural_sort_key(str(s.query_identifier)),
        ):
            f_out.write(
                "\t".join(
                    [
                        "PSM",
                        ("null" if ssm.sequence is None
                         else str(ssm.sequence)),
                        str(ssm.query_identifier),
                        "null",
                        "null",
                        pathlib.Path(
                            os.path.abspath(
                                config.spectral_library_filename
                            )
                        ).as_uri(),
                        lib_version,
                        "[MS, MS:1001456, ANN-SoLo-TPU,]",
                        str(ssm.search_engine_score),
                        str(ssm.q),
                        "null",
                        str(ssm.retention_time),
                        str(ssm.charge),
                        str(ssm.exp_mass_to_charge),
                        str(ssm.calc_mass_to_charge),
                        f"ms_run[1]:index={ssm.query_index}",
                        "null",
                        "null",
                        "null",
                        "null",
                        str(ssm.library_identifier),
                        f"{ssm.is_decoy:d}",
                    ]
                )
                + "\n"
            )
    return filename


# The strings `pandas.read_csv` reads as missing by default.
_NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null",
})
_INT = re.compile(r"[+-]?[0-9]+")
_FLOAT = re.compile(r"([+-]?)([0-9]*)(?:\.([0-9]*))?(?:[eE]([+-]?[0-9]+))?")
_POW10 = [float(f"1e{i}") for i in range(309)]
DECOY_COLUMN = "opt_ms_run[1]_cv_MS:1002217_decoy_peptide"


class SsmTable:
    """The PSM section of an mzTab file: `index` holds the PSM_IDs as
    written, in file order, and `columns` one NumPy array per other header
    name, typed as `pandas.read_csv` types it (int64, float64 with NaN for
    missing values, else an object array of strings with None for them);
    the decoy column is bool."""

    def __init__(self, index: List[str], columns: Dict[str, np.ndarray]):
        self.index = index
        self.columns = columns

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, name: str) -> np.ndarray:
        return self.columns[name]

    def select(self, mask) -> "SsmTable":
        """The rows where the bool array `mask` holds."""
        mask = np.asarray(mask, bool)
        return SsmTable(
            [qid for qid, keep in zip(self.index, mask) if keep],
            {name: col[mask] for name, col in self.columns.items()},
        )


def _pandas_float(text: str) -> float:
    """`text` as `pandas.read_csv` parses a float by default (its C
    tokenizer's `precise_xstrtod`): up to 17 significant digits summed in
    float64, then one multiply or divide by a power of ten.  It can be one
    ulp from Python's correctly rounded `float(text)`.  Spellings such as
    "inf" go to `float`, which raises on what is no number."""
    m = _FLOAT.fullmatch(text)
    if m is None or not (m.group(2) or m.group(3)):
        return float(text)
    sign, whole, frac, exp = m.groups()
    number, digits, exponent = 0.0, 0, 0
    for c in whole:
        if digits < 17:
            number = number * 10.0 + (ord(c) - 48)
            digits += 1
        else:
            exponent += 1
    for c in (frac or "")[:max(17 - digits, 0)]:
        number = number * 10.0 + (ord(c) - 48)
        exponent -= 1
    if sign == "-":
        number = -number
    exponent += int(exp or 0)
    if exponent > 308:
        return float(text)
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -616:
        return 0.0
    if exponent < -308:
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _typed_column(values: List[str]) -> np.ndarray:
    """A column of strings as `pandas.read_csv` infers its type: int64,
    else float64 (missing values NaN; a column missing everywhere too),
    else strings (missing values None)."""
    present = [v for v in values if v not in _NA_VALUES]
    if all(_INT.fullmatch(v) for v in present) \
            and len(present) == len(values):
        return np.asarray([int(v) for v in values], np.int64)
    try:
        if any("_" in v for v in present):
            raise ValueError(values)
        return np.asarray([_pandas_float(v) if v not in _NA_VALUES
                           else np.nan for v in values], np.float64)
    except ValueError:
        col = np.empty(len(values), object)
        col[:] = [None if v in _NA_VALUES else v for v in values]
        return col


def read_mztab_ssms(filename: str) -> SsmTable:
    """Read SSMs from an mzTab file (reference reader.py:1023-1055): the
    rows after the PSH header line, keyed by PSM_ID.  Unlike pandas, a
    numeric PSM_ID stays the string written ("007", not 7)."""
    from ann_solo_tpu_torch.io.reader import verify_extension

    verify_extension([".mztab"], filename)
    with open(filename) as f_in:
        lines = f_in.read().splitlines()
    start = next(i for i, line in enumerate(lines)
                 if line.split("\t", 1)[0] == "PSH")
    header = lines[start].split("\t")
    rows = [line.split("\t") for line in lines[start + 1:] if line]
    # A short row's missing trailing fields are missing values (the
    # writer leaves the last header column, num_candidates, out).
    fields = {name: [row[j] if j < len(row) else "" for row in rows]
              for j, name in enumerate(header)}
    columns = {name: _typed_column(values)
               for name, values in fields.items()
               if name not in ("PSH", "PSM_ID")}
    columns[DECOY_COLUMN] = columns[DECOY_COLUMN].astype(bool)
    return SsmTable(fields["PSM_ID"], columns)


def read_mztab_metadata(filename: str) -> dict:
    """Read the MTD section (settings) from an mzTab file
    (used by the plotting CLI to reconstruct the search config,
    reference plot_ssm.py:59-75)."""
    settings = {}
    with open(filename) as f_in:
        for line in f_in:
            if not line.startswith("MTD"):
                continue
            fields = line.rstrip("\n").split("\t")
            if len(fields) >= 3 and fields[1].startswith(
                "software[1]-setting"
            ):
                key, value = fields[2].split(" = ", 1)
                settings[key] = None if value == "None" else value
    return settings
