"""Result-file statistics (the reference's notebooks-style evaluation).

The port of `ann_solo_tpu/eval.py` over `io.mztab.SsmTable` in place of a
pandas DataFrame: SSM counts at an FDR threshold, modified/unmodified
splits, and mass-difference histograms for open-search results, as a
library and a CLI.

    python -m ann_solo_tpu_torch.eval result.mztab [--fdr 0.01]
    python -m ann_solo_tpu_torch.eval quality [quality options]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Optional

import numpy as np

from ann_solo_tpu_torch.io.mztab import (
    DECOY_COLUMN,
    SsmTable,
    read_mztab_ssms,
)


def confident_targets(ssms: SsmTable, fdr: float) -> SsmTable:
    """Target SSMs with q-value (search_engine_score[2]) below `fdr`."""
    targets = ssms.select(~ssms[DECOY_COLUMN])
    q = targets["search_engine_score[2]"].astype(float)
    return targets.select(q < fdr)


def _mass_diff(ssms: SsmTable) -> np.ndarray:
    return (
        ssms["exp_mass_to_charge"].astype(float)
        - ssms["calc_mass_to_charge"].astype(float)
    ) * ssms["charge"].astype(float)


def ssm_stats(
    ssms: SsmTable,
    fdr: float = 0.01,
    tol_mass: float = 0.1,
) -> Dict:
    """Summary statistics over an mzTab SSM table.

    `tol_mass` separates unmodified SSMs (|mass diff| <= tol) from modified
    ones, as the reference notebooks do for open searches.  Unique peptides
    count distinct sequences, missing ones not counted (pandas' `nunique`).
    """
    n_targets = int((~ssms[DECOY_COLUMN]).sum())
    confident = confident_targets(ssms, fdr)
    n_unmodified = int((np.abs(_mass_diff(confident)) <= tol_mass).sum())
    return {
        "n_ssms": len(ssms),
        "n_targets": n_targets,
        "n_decoy_matches": len(ssms) - n_targets,
        "fdr_threshold": fdr,
        "n_confident": len(confident),
        "n_unmodified": n_unmodified,
        "n_modified": len(confident) - n_unmodified,
        "n_unique_peptides": len(
            {s for s in confident["sequence"]
             if s is not None and s == s}  # None or NaN: missing
        ),
    }


def mass_diff_histogram(
    ssms: SsmTable,
    fdr: float = 0.01,
    bin_width: float = 0.01,
    min_mass: Optional[float] = None,
    max_mass: Optional[float] = None,
):
    """Histogram of precursor mass differences of confident SSMs
    (the open-search modification profile)."""
    mass_diff = _mass_diff(confident_targets(ssms, fdr))
    if min_mass is None:
        min_mass = float(np.floor(mass_diff.min())) if len(mass_diff) \
            else -1.0
    if max_mass is None:
        max_mass = float(np.ceil(mass_diff.max())) if len(mass_diff) \
            else 1.0
    bins = np.arange(min_mass, max_mass + bin_width, bin_width)
    hist, edges = np.histogram(mass_diff, bins=bins)
    return hist, edges


def main(args=None) -> int:
    parser = argparse.ArgumentParser(
        description="Summarize an ANN-SoLo-TPU mzTab result file "
        "(or run the full quality benchmark: "
        "`... eval quality [options]`, see ann_solo_tpu_torch.quality)"
    )
    parser.add_argument("mztab_filename")
    parser.add_argument("--fdr", type=float, default=0.01)

    argv = list(sys.argv[1:] if args is None else args)
    if argv and argv[0] == "quality":
        # Full bf-vs-ann quality benchmark on a synthetic ground-truth
        # corpus (IDs@FDR, accuracy, ANN candidate recall curve).
        from ann_solo_tpu_torch.quality import main as quality_main

        return quality_main(argv[1:])
    parsed = parser.parse_args(argv)
    ssms = read_mztab_ssms(parsed.mztab_filename)
    print(json.dumps(ssm_stats(ssms, parsed.fdr), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
