"""Foreign-query FDR leak diagnostic on a QUALITY workdir.

The port of the repo's `tools/fdr_leak_diag.py`, reading the mzTab files
without pandas (`io.mztab.read_mztab_ssms`).  For each of `bf.mztab` and
`ann.mztab` present, with the ground truth of `truth.json`:

1. **Calibration curve**: the ground-truth false-discovery proportion
   among accepted target SSMs, and the share of foreign queries
   accepted, at nominal q-value thresholds 0.005-0.1.  Target-decoy
   competition estimates the FDR as decoy wins over target wins above
   the threshold; a curve above y = x means the decoys under-model the
   scores of incorrect matches.
2. **Score distributions**: the decoy-win scores against the foreign
   queries' target-win scores (percentiles), and P(a foreign target win
   beats a random decoy win): 0.5 when the two are exchangeable, as
   target-decoy competition assumes.

    python -m ann_solo_tpu_torch.tools.fdr_leak_diag <workdir> [fdr]

Writes `<workdir>/fdr_leak_diag.json` (the JAX tool's keys) and prints
it.  Host code only: no device is used.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

DECOY = "opt_ms_run[1]_cv_MS:1002217_decoy_peptide"


def diagnose(workdir: str, fdr: float = 0.01) -> dict:
    from ann_solo_tpu_torch.io.mztab import read_mztab_ssms

    with open(os.path.join(workdir, "truth.json")) as f:
        truth = json.load(f)
    out = {}
    for mode in ("bf", "ann"):
        path = os.path.join(workdir, f"{mode}.mztab")
        if not os.path.isfile(path):
            continue
        ssms = read_mztab_ssms(path)
        is_decoy = np.asarray(ssms[DECOY], bool)
        q = np.asarray(ssms["search_engine_score[2]"], float)
        score = np.asarray(ssms["search_engine_score[1]"], float)
        qid = ssms.index
        is_foreign = np.array([truth.get(i, "") is None for i in qid])
        correct = np.array([
            seq is not None and truth.get(i, "") == seq
            for i, seq in zip(qid, ssms["sequence"])
        ])

        curve = []
        for thr in (0.005, 0.01, 0.02, 0.05, 0.1):
            acc = ~is_decoy & (q < thr)
            n = int(acc.sum())
            fdp = float((~correct[acc]).mean()) if n else 0.0
            leak = float(is_foreign[acc].sum() / max(is_foreign.sum(), 1))
            curve.append({
                "nominal_q": thr, "n_accepted": n,
                "empirical_fdp": round(fdp, 4),
                "foreign_leak_rate": round(leak, 4),
            })

        dec_scores = score[is_decoy]
        foreign_tgt = score[is_foreign & ~is_decoy]
        qs = [50, 75, 90, 95, 99]
        quant = {
            "decoy_win_score": {
                f"p{p}": round(float(np.percentile(dec_scores, p)), 4)
                for p in qs
            } if len(dec_scores) else {},
            "foreign_target_win_score": {
                f"p{p}": round(float(np.percentile(foreign_tgt, p)), 4)
                for p in qs
            } if len(foreign_tgt) else {},
            "n_decoy_wins": int(is_decoy.sum()),
            "n_foreign_target_wins": int((is_foreign & ~is_decoy).sum()),
        }
        if len(dec_scores) and len(foreign_tgt):
            sample = np.random.default_rng(0).choice(
                dec_scores, size=min(len(dec_scores), 5000), replace=False)
            f = np.sort(foreign_tgt)
            dominance = float(np.mean(np.searchsorted(f, sample) / len(f)))
            quant["p_foreign_beats_decoy"] = round(1.0 - dominance, 4)
        out[mode] = {"calibration": curve, "scores": quant}
    return out


def main(args=None) -> int:
    args = sys.argv[1:] if args is None else list(args)
    workdir = args[0]
    fdr = float(args[1]) if len(args) > 1 else 0.01
    result = diagnose(workdir, fdr)
    out_path = os.path.join(workdir, "fdr_leak_diag.json")
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result, indent=1))
    print(f"written: {out_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
