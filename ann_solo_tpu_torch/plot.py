"""Mirror-plot CLI for a single SSM (reference: ann_solo/plot_ssm.py).

The port of `ann_solo_tpu/plot.py`.  Reconstructs the search configuration
from an mzTab result file's metadata, re-runs the exact peak matching for
one query spectrum against its library match (`ssm_matches`: the greedy
shifted dot through kernel B1 on the GPU, its plain version on the CPU),
and renders a mirror plot (`mirror_plot`: query on top, library below,
matched peaks highlighted; needs matplotlib, imported there only).

    python -m ann_solo_tpu_torch.plot result.mztab QUERY_ID [--no_gpu]
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import List, NamedTuple, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)


class SsmMatch(NamedTuple):
    """One SSM of an mzTab file with its peaks matched again."""

    query: object  # Spectrum, preprocessed
    library: object  # Spectrum, from the store, processed
    peak_matches: np.ndarray  # (M, 2) [query peak, library peak]
    score: float  # the shifted-dot score of the pair
    title: str


def mirror_plot(
    query_spectrum,
    library_spectrum,
    peak_matches: Optional[np.ndarray],
    title: str,
    out_filename: str,
) -> None:
    """Render the mirror plot to a PNG (spectrum_utils.plot.mirror
    equivalent)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 5))
    matched_q = set()
    matched_l = set()
    if peak_matches is not None:
        matched_q = {int(i) for i, _ in peak_matches}
        matched_l = {int(j) for _, j in peak_matches}
    q_int = query_spectrum.intensity / max(
        query_spectrum.intensity.max(), 1e-30
    )
    l_int = library_spectrum.intensity / max(
        library_spectrum.intensity.max(), 1e-30
    )
    for i, (mz, intensity) in enumerate(zip(query_spectrum.mz, q_int)):
        color = "#b2182b" if i in matched_q else "#888888"
        ax.vlines(mz, 0, intensity, colors=color, linewidth=1.0)
    for j, (mz, intensity) in enumerate(zip(library_spectrum.mz, l_int)):
        color = "#2166ac" if j in matched_l else "#bbbbbb"
        ax.vlines(mz, 0, -intensity, colors=color, linewidth=1.0)
    ax.axhline(0, color="black", linewidth=0.8)
    ax.set_xlabel("m/z")
    ax.set_ylabel("intensity (query above, library below)")
    ax.set_title(title)
    ax.set_ylim(-1.05, 1.05)
    fig.tight_layout()
    fig.savefig(out_filename, dpi=300, bbox_inches="tight")
    plt.close(fig)


def _search_config(mztab_filename: str, database: str):
    """Parse the search configuration recorded in the mzTab metadata into
    the config singleton; returns (library file, query file)."""
    from ann_solo_tpu_torch.config import config
    from ann_solo_tpu_torch.io.mztab import read_mztab_metadata

    settings = read_mztab_metadata(mztab_filename)
    # Recover library + query filenames from the MTD description URIs.
    lib_filename = str(database)
    if lib_filename.startswith("file://"):
        lib_filename = lib_filename[len("file://"):]
    query_filename = None
    with open(mztab_filename) as f_in:
        for line in f_in:
            if line.startswith("MTD\tms_run[1]-location"):
                query_filename = line.strip().split("\t")[2]
                if query_filename.startswith("file://"):
                    query_filename = query_filename[len("file://"):]
                break

    args_list = [
        lib_filename, query_filename or "", "dummy.mztab",
        "--precursor_tolerance_mass",
        settings.get("precursor_tolerance_mass", "20"),
        "--precursor_tolerance_mode",
        settings.get("precursor_tolerance_mode", "ppm"),
        "--fragment_mz_tolerance",
        settings.get("fragment_mz_tolerance", "0.02"),
        "--mode", settings.get("mode", "ann"),
    ]
    for key in (
        "min_mz", "max_mz", "min_intensity", "min_peaks", "min_mz_range",
        "max_peaks_used", "max_peaks_used_library", "scaling", "bin_size",
        "hash_len",
    ):
        if settings.get(key) is not None:
            args_list.extend([f"--{key}", settings[key]])
    if settings.get("allow_peak_shifts") == "True":
        args_list.append("--allow_peak_shifts")
    config.parse(args_list)
    return lib_filename, query_filename


@torch.no_grad()
def ssm_matches(mztab_filename: str, query_ids: List[str],
                device=None) -> List[SsmMatch]:
    """The SSMs of `query_ids` in an mzTab file, each query spectrum
    preprocessed and matched against its library spectrum again (reference
    plot_ssm.py:35-141): both padded to K = max(query peaks, library
    peaks), scored by the greedy shifted dot on `device` (None = the GPU),
    the matches in the greedy's selection order."""
    from ann_solo_tpu_torch.config import config
    from ann_solo_tpu_torch.device import resolve_device
    from ann_solo_tpu_torch.io import reader as io_reader
    from ann_solo_tpu_torch.io.mztab import read_mztab_ssms
    from ann_solo_tpu_torch.io.store import open_or_build_store
    from ann_solo_tpu_torch.models.preprocess import (
        PreprocessParams,
        preprocess_batch,
    )
    from ann_solo_tpu_torch.models.spectrum import pack_spectra
    from ann_solo_tpu_torch.ops.shifted_dot_cuda import (
        shifted_dot_best_match_auto,
    )
    from ann_solo_tpu_torch.search import (
        _open_search_params,
        _selection_order,
    )

    dev = resolve_device(device)
    ssms = read_mztab_ssms(mztab_filename)
    position = {}  # the first row of each PSM_ID
    for i, qid in enumerate(ssms.index):
        position.setdefault(qid, i)
    for qid in query_ids:
        if qid not in position:
            raise ValueError(f"Query {qid} not present in the mzTab file")
    lib_filename, query_filename = _search_config(
        mztab_filename, ssms["database"][position[query_ids[0]]])

    # Load the query spectra.
    wanted = set(query_ids)
    queries = {}
    for spectrum in io_reader.read_query_file(query_filename):
        qid = str(spectrum.identifier)
        if qid in wanted and qid not in queries:
            if spectrum.precursor_charge is None:
                spectrum.precursor_charge = int(
                    ssms["charge"][position[qid]])
            queries[qid] = spectrum
    for qid in query_ids:
        if qid not in queries:
            raise ValueError(f"Query {qid} not found in {query_filename}")

    # The library spectra come from the store.
    params = PreprocessParams.from_config(config, is_library=True)
    store = open_or_build_store(lib_filename, config, params, dev)
    qparams = PreprocessParams.from_config(config, is_library=False)
    search_params = _open_search_params(config)
    lib_column = ssms["opt_ms_run[1]_cv_MS:1003062_spectrum_index"]
    out = []
    for qid in query_ids:
        row = position[qid]
        lib_row = np.nonzero(store.identifiers == str(lib_column[row]))[0]
        if len(lib_row) == 0:
            raise ValueError("Library spectrum not found in the store")
        library_spectrum = store.get_spectrum(int(lib_row[0]),
                                              processed=True)

        # Preprocess the query and recompute the peak matches.
        query_spectrum = queries[qid]
        packed = pack_spectra([query_spectrum])
        processed = preprocess_batch(
            qparams, *(torch.from_numpy(a).to(dev) for a in (
                packed.mz, packed.intensity, packed.ann_charge,
                packed.n_peaks, packed.precursor_mz,
                packed.precursor_charge,
            ))
        )
        n = int(processed.n_peaks[0])
        query_spectrum.mz = processed.mz[0, :n].cpu().numpy().astype(
            np.float64)
        query_spectrum.intensity = processed.intensity[0, :n].cpu().numpy(
        ).astype(np.float64)

        nl = library_spectrum.n_peaks
        k = max(n, nl)
        pair = np.zeros((5, 1, k), np.float32)
        pair[0, 0, :n] = query_spectrum.mz
        pair[1, 0, :n] = query_spectrum.intensity
        pair[2, 0, :nl] = library_spectrum.mz
        pair[3, 0, :nl] = library_spectrum.intensity
        pair[4, 0, :nl] = library_spectrum.annotation_charges()
        qm, qi, cm, ci = (torch.from_numpy(a).to(dev) for a in pair[:4])
        ca = torch.from_numpy(pair[4].astype(np.int32)).to(dev)
        charge = int(library_spectrum.precursor_charge)
        q_prec = torch.tensor([query_spectrum.precursor_mz],
                              dtype=torch.float32, device=dev)
        c_prec = torch.tensor([library_spectrum.precursor_mz],
                              dtype=torch.float32, device=dev)
        charges = torch.tensor([charge], dtype=torch.int32, device=dev)
        total, _, match = shifted_dot_best_match_auto(
            qm, qi, cm, ci, ca, q_prec, c_prec, charges,
            search_params.fragment_mz_tolerance,
            search_params.num_shifts(charge),
            search_params.allow_peak_shifts,
        )
        match_q, match_c = _selection_order(
            qm, qi, cm, ci, ca, q_prec, c_prec, charges, match,
            search_params, charge)
        match_q = match_q[0].cpu().numpy()
        match_c = match_c[0].cpu().numpy()
        sel = match_q >= 0
        peak_matches = np.column_stack([match_q[sel], match_c[sel]])

        mass_delta = (
            float(ssms["exp_mass_to_charge"][row])
            - float(ssms["calc_mass_to_charge"][row])
        ) * int(ssms["charge"][row])
        title = (
            f"{library_spectrum.peptide}  "
            f"Δm = {mass_delta:+.3f} Da  "
            f"score = {float(ssms['search_engine_score[1]'][row]):.3f}"
        )
        out.append(SsmMatch(query_spectrum, library_spectrum, peak_matches,
                            float(total[0]), title))
    return out


def main(args=None) -> int:
    """Plot one SSM from an mzTab result file
    (reference plot_ssm.py:35-141)."""
    parser = argparse.ArgumentParser(
        description="Visualize a spectrum-spectrum match from an "
        "ANN-SoLo-TPU mzTab result file"
    )
    parser.add_argument("mztab_filename", help="mzTab identification file")
    parser.add_argument(
        "query_id", help="query spectrum identifier (PSM_ID)"
    )
    parser.add_argument("--no_gpu", action="store_true",
                        help="match on the CPU (the plain PyTorch version "
                        "of the kernel)")
    parsed = parser.parse_args(args)

    (match,) = ssm_matches(parsed.mztab_filename, [parsed.query_id],
                           device="cpu" if parsed.no_gpu else None)
    out_filename = (
        f"{os.path.splitext(parsed.mztab_filename)[0]}_"
        f"{parsed.query_id}.png"
    )
    mirror_plot(match.query, match.library, match.peak_matches, match.title,
                out_filename)
    logger.info("Saved mirror plot to %s", out_filename)
    print(out_filename)
    return 0


if __name__ == "__main__":
    sys.exit(main())
