"""mzTab 1.0 output writer and metadata reader (reference:
ann_solo/writer.py, reader.py:1023-1055).

The port's copy of `ann_solo_tpu/io/mztab.py` without the pandas SSM
reader: the software name and columns stay ANN-SoLo-TPU's, so the JAX
package's `read_mztab_ssms`, `eval` and `plot` read this package's files.

Every result file embeds the full search configuration in its metadata
section, making outputs self-describing (and re-parseable by the plotting
CLI), exactly like the reference.
"""

from __future__ import annotations

import logging
import os
import pathlib
import re
from typing import AnyStr, List, Pattern, Union

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
