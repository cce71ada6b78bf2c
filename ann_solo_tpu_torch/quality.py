"""Quality benchmark: cascade IDs@FDR and ANN recall on a synthetic corpus.

The port of `ann_solo_tpu/quality.py`.  The reference's quality story
rests on the iPRG2012 notebooks (notebooks/iprg2012_fdr.ipynb,
notebooks/iprg2012_num_candidates.ipynb); the real data is not
redistributable, so this module reproduces the *methodology* on a
generated corpus of known ground truth (`synthdata.make_corpus`): a large
b/y-ion spectral library, noisy unmodified queries, modified queries
following a realistic PTM mass profile, and foreign queries that FDR
control must reject.

Reported per mode (bf = brute-force cascade, ann = IVF-filtered cascade):
SSMs accepted at the FDR threshold, split unmodified / modified; the
ground-truth accuracy of accepted SSMs; the foreign-query leak rate.  And
the ANN-vs-brute-force candidate recall curve: the fraction of
brute-force-identified SSMs whose library match is among the top-k ANN
candidates, k in {1, 10, 100, num_candidates}.  The results JSON has the
JAX package's keys.

    python -m ann_solo_tpu_torch.quality --out QUALITY.json [--no_gpu]

Every search runs on the CUDA GPU, or on the CPU with ``--no_gpu``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import logging
import os
import sys
import tempfile
import time
from typing import Dict

import numpy as np
import torch

logger = logging.getLogger(__name__)


def _cli_args(lib, queries, out, mode, parsed):
    args = [
        lib, queries, out,
        "--precursor_tolerance_mass", "20",
        "--precursor_tolerance_mode", "ppm",
        "--precursor_tolerance_mass_open",
        str(parsed.open_tolerance),
        "--precursor_tolerance_mode_open", "Da",
        "--fragment_mz_tolerance", "0.02",
        "--allow_peak_shifts",
        "--min_mz_range", "200",
        "--min_peaks", "5",
        "--model", parsed.model,
        "--mode", mode,
        "--num_list", str(parsed.num_list),
        "--num_probe", str(parsed.num_probe),
        "--num_candidates", str(parsed.num_candidates),
        "--index_dtype", str(parsed.index_dtype),
        "--ivf_redundancy", str(getattr(parsed, "ivf_redundancy", 2)),
        "--soar_lambda", str(getattr(parsed, "soar_lambda", 1.0)),
        "--fdr", str(parsed.fdr),
        "--add_decoys",
    ]
    if getattr(parsed, "no_gpu", False):
        args.append("--no_gpu")
    return args


def _confident(path, parsed):
    from ann_solo_tpu_torch.eval import confident_targets
    from ann_solo_tpu_torch.io.mztab import read_mztab_ssms

    ssms = read_mztab_ssms(path)
    return ssms, confident_targets(ssms, parsed.fdr)


def _mztab_stats(path, truth, parsed) -> Dict:
    from ann_solo_tpu_torch.eval import ssm_stats

    ssms, confident = _confident(path, parsed)
    stats = ssm_stats(ssms, parsed.fdr)
    correct = sum(
        seq is not None and truth.get(qid) == seq
        for qid, seq in zip(confident.index, confident["sequence"])
    )
    foreign_accepted = sum(
        qid.startswith("q_foreign") for qid in confident.index
    )
    n_foreign = sum(1 for k in truth if truth[k] is None)
    stats.update(
        accuracy=(correct / len(confident)) if len(confident) else 0.0,
        n_correct=int(correct),
        foreign_leak_rate=(
            foreign_accepted / n_foreign if n_foreign else 0.0
        ),
        # Ground-truth false-discovery proportion among accepted SSMs:
        # the number the nominal q-value threshold claims to control.
        empirical_fdp=(
            round(1.0 - correct / len(confident), 5)
            if len(confident) else 0.0
        ),
    )
    return stats


def _bf_matches(path, parsed):
    """(query_id -> library identifier) of brute-force confident SSMs."""
    _, confident = _confident(path, parsed)
    col = confident["opt_ms_run[1]_cv_MS:1003062_spectrum_index"]
    return {qid: str(ident) for qid, ident in zip(confident.index, col)}


@torch.no_grad()
def _ann_recall_curve(lib_path, query_path, bf_matches, parsed):
    """% of brute-force SSMs whose match is in the top-k ANN candidates.

    Reproduces notebooks/iprg2012_num_candidates.ipynb: rank the bf match
    inside the ANN candidate list (precursor window fused, open-search
    tolerances) and report the cumulative recovery at each k.
    """
    from ann_solo_tpu_torch.config import config
    from ann_solo_tpu_torch.models.vectorize import (
        VectorizeParams,
        device_tables,
        vectorize_batch,
    )
    from ann_solo_tpu_torch.search import SpectralLibrary

    config.parse(
        _cli_args(lib_path, query_path, "unused.mztab", "ann", parsed)
    )
    library = SpectralLibrary(lib_path,
                              device="cpu" if parsed.no_gpu else None)
    queries = library._read_and_process_queries(query_path)
    # Library identifier -> store row.
    ident_to_row = {
        str(ident): row
        for row, ident in enumerate(library._store.identifiers)
    }
    ks = sorted({1, 10, 100, parsed.num_candidates})
    vparams = VectorizeParams.from_config(config)
    tables = device_tables(vparams, library.device)
    found_at = []
    for charge, spectra in queries.items():
        if charge not in library._ann_indexes:
            continue
        lib = library._get_charge_lib(charge)
        row_to_pos = {int(r): i for i, r in enumerate(lib.rows)}
        wanted = [
            (i, row_to_pos.get(
                ident_to_row.get(bf_matches.get(s.identifier, ""), -1),
                -1,
            ))
            for i, s in enumerate(spectra)
            if s.identifier in bf_matches
        ]
        wanted = [(i, pos) for i, pos in wanted if pos >= 0]
        if not wanted:
            continue
        rows = [i for i, _ in wanted]
        k_peaks = library._query_params.max_peaks_used
        q_mz = np.zeros((len(rows), k_peaks), np.float32)
        q_int = np.zeros((len(rows), k_peaks), np.float32)
        q_prec = np.zeros(len(rows), np.float32)
        n_peaks = np.zeros(len(rows), np.int32)
        for j, i in enumerate(rows):
            s = spectra[i]
            n = min(s.n_peaks, k_peaks)
            q_mz[j, :n] = s.mz[:n]
            q_int[j, :n] = s.intensity[:n]
            q_prec[j] = s.precursor_mz
            n_peaks[j] = n
        vectors = vectorize_batch(
            vparams, tables, *(torch.from_numpy(a).to(library.device)
                               for a in (q_mz, q_int, n_peaks)))
        cand = library._ann_indexes[charge].search(
            vectors, parsed.num_candidates,
            q_prec=q_prec, charge=float(charge),
            tol_val=float(parsed.open_tolerance), tol_mode="Da",
        )
        for j, (_, pos) in enumerate(wanted):
            hits = np.nonzero(cand[j] == pos)[0]
            found_at.append(int(hits[0]) + 1 if len(hits) else 10**9)
    library.shutdown()
    found_at = np.asarray(found_at)
    return {
        f"recall@{k}": (
            round(float((found_at <= k).mean()), 4) if len(found_at)
            else None
        )
        for k in ks
    } | {"n_bf_ssms_checked": int(len(found_at))}


def main(args=None) -> int:
    parser = argparse.ArgumentParser(
        description="ANN-SoLo-TPU quality benchmark on a synthetic corpus "
        "(the PyTorch port)"
    )
    parser.add_argument("--out", default="QUALITY.json")
    parser.add_argument("--workdir", default=None)
    parser.add_argument("--n-peptides", type=int, default=50000)
    parser.add_argument("--n-queries", type=int, default=10000)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--fdr", type=float, default=0.01)
    parser.add_argument("--model", default="none",
                        choices=["none", "rf", "svm"])
    parser.add_argument("--open-tolerance", type=float, default=300.0)
    parser.add_argument("--num_list", type=int, default=0,
                        help="0 = the shipped size-aware auto default")
    parser.add_argument("--num_probe", type=int, default=512,
                        help="the shipped default")
    parser.add_argument("--num_candidates", type=int, default=512,
                        help="the shipped default")
    parser.add_argument("--index_dtype", default="int8",
                        choices=["bf16", "f32", "int8"],
                        help="IVF list storage precision for the ann pass "
                        "(int8 = the shipped default)")
    parser.add_argument("--ivf_redundancy", type=int, default=2,
                        help="stored copies per vector (the shipped x2)")
    parser.add_argument("--soar_lambda", type=float, default=1.0)
    parser.add_argument("--skip-bf", action="store_true",
                        help="skip the brute-force pass (and the recall "
                        "curve) for quick smoke runs")
    parser.add_argument("--reuse-bf", action="store_true",
                        help="reuse an existing bf.mztab in --workdir "
                        "instead of re-running the brute-force pass (the "
                        "bf result does not depend on the index settings); "
                        "refused when the corpus fingerprint differs")
    parser.add_argument("--reuse-corpus", action="store_true",
                        help="skip corpus generation when --workdir "
                        "already holds library.splib / queries.mgf / "
                        "truth.json; the files are trusted as-is")
    parser.add_argument("--no_gpu", action="store_true",
                        help="run every search on the CPU (the plain "
                        "PyTorch versions of the kernels)")
    parsed = parser.parse_args(args)

    logging.basicConfig(
        level=logging.INFO, stream=sys.stderr,
        format="{asctime} {levelname} {module}.{funcName} : {message}",
        style="{",
    )
    workdir = parsed.workdir or tempfile.mkdtemp(prefix="annsolo_quality_")
    os.makedirs(workdir, exist_ok=True)

    from ann_solo_tpu_torch import rndm

    rndm.set_seeds()
    from ann_solo_tpu_torch import cli
    from ann_solo_tpu_torch.io.mgf import write_mgf
    from ann_solo_tpu_torch.io.splib import write_splib
    from ann_solo_tpu_torch.synthdata import make_corpus

    rng = np.random.default_rng(parsed.seed)
    t0 = time.perf_counter()
    lib_path = os.path.join(workdir, "library.splib")
    query_path = os.path.join(workdir, "queries.mgf")
    truth_path = os.path.join(workdir, "truth.json")
    reuse_corpus = (
        parsed.reuse_corpus
        and all(os.path.isfile(p)
                for p in (lib_path, query_path, truth_path))
    )
    if reuse_corpus:
        logger.info("Reusing corpus files in %s", workdir)
        with open(truth_path) as f:
            truth = json.load(f)
        library = queries = None
        n_library = parsed.n_peptides  # make_library: 1 spectrum each
        n_queries = len(truth)
    else:
        logger.info(
            "Generating corpus: %d peptides x 2 charges, %d queries",
            parsed.n_peptides, parsed.n_queries,
        )
        library, queries, truth = make_corpus(
            rng, parsed.n_peptides, parsed.n_queries
        )
        n_library, n_queries = len(library), len(queries)
        write_splib(library, lib_path)
        write_mgf(queries, query_path)

    # --reuse-bf guard: bf.mztab is only comparable to THIS corpus.
    # Generation is seeded but parameter-dependent (--n-peptides /
    # --n-queries / --seed), and a mismatch is silent: the same file names
    # and seed with another --n-peptides pair other queries.  The
    # fingerprint pins (identifier, charge, precursor) of every library
    # and query spectrum.
    fp_path = os.path.join(workdir, "corpus_fp.txt")
    bf_path = os.path.join(workdir, "bf.mztab")
    if not reuse_corpus:
        corpus_fp = hashlib.md5(
            b"".join(
                f"{s.identifier}:{s.precursor_charge}:"
                f"{s.precursor_mz:.4f}".encode()
                for s in list(library) + list(queries)
            )
        ).hexdigest()
        if parsed.reuse_bf and os.path.isfile(bf_path):
            recorded = None
            if os.path.isfile(fp_path):
                with open(fp_path) as f:
                    recorded = f.read().strip()
            if recorded != corpus_fp:
                parser.error(
                    f"--reuse-bf: bf.mztab in {workdir} was built from "
                    f"a different corpus (fingerprint {recorded} != "
                    f"{corpus_fp}); re-run without --reuse-bf or match "
                    "the original --n-peptides/--n-queries/--seed"
                )
        with open(fp_path, "w") as f:
            f.write(corpus_fp + "\n")
        # The ground truth, for offline diagnostics next to the mzTabs.
        with open(truth_path, "w") as f:
            json.dump(truth, f)
    t_corpus = time.perf_counter() - t0
    logger.info(
        "Corpus: %d library spectra, %d queries (%.1fs)",
        n_library, n_queries, t_corpus,
    )

    results = {
        "corpus": {
            "n_library_spectra": n_library,
            # --add_decoys interleaves one shuffled decoy per target, so
            # the searched library holds twice this many spectra.
            "n_library_spectra_with_decoys": 2 * n_library,
            "n_queries": n_queries,
            "n_foreign": sum(1 for v in truth.values() if v is None),
            "seed": parsed.seed,
        },
        "config": {
            "fdr": parsed.fdr,
            "model": parsed.model,
            "open_tolerance_da": parsed.open_tolerance,
            "num_list": parsed.num_list,
            "num_probe": parsed.num_probe,
            "num_candidates": parsed.num_candidates,
            "index_dtype": parsed.index_dtype,
        },
    }
    modes = ["ann"] if parsed.skip_bf else ["bf", "ann"]
    for mode in modes:
        out_path = os.path.join(workdir, f"{mode}.mztab")
        reused = (
            mode == "bf" and parsed.reuse_bf and os.path.isfile(out_path)
        )
        t0 = time.perf_counter()
        if not reused:
            cli.main(
                _cli_args(lib_path, query_path, out_path, mode, parsed)
            )
        elapsed = time.perf_counter() - t0
        stats = _mztab_stats(out_path, truth, parsed)
        stats["search_seconds"] = None if reused else round(elapsed, 1)
        if reused:
            stats["reused_bf_mztab"] = True
        results[mode] = stats
        logger.info("%s: %s", mode, json.dumps(stats))
    if not parsed.skip_bf:
        results["ann_vs_bf_ids_ratio"] = round(
            results["ann"]["n_confident"]
            / max(results["bf"]["n_confident"], 1),
            4,
        )
        bf_matches = _bf_matches(bf_path, parsed)
        results["ann_candidate_recall"] = _ann_recall_curve(
            lib_path, query_path, bf_matches, parsed
        )
    with open(parsed.out, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
