"""The check's readings for a cell, on the card, in one process.

For each seed: the cell's set-up and a short window at its own load, then
the compared numbers of the program's answers (the lower readings) and
of the control's (`check.control_answers`: the reference in the
program's place, its entries in bfloat16; the upper readings).  ``--fault escalation`` plants a fault under the timed path
first: every stage-2 certificate reads as held, so rescoring keeps the
best of the first tier's 8 candidates and never escalates.  The
benchmark's own runs never run this.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 \\
        --seconds 3 [--fault escalation]

Prints one JSON line a seed and a last line with the largest program
reading and the smallest control reading of each number.
"""

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

from benchmark import check, harness, workload  # noqa: E402


@contextlib.contextmanager
def planted(fault: str):
    """The program with `fault` planted under the timed path."""
    if fault == "none":
        yield
        return
    from ann_solo_tpu_torch.ops import rescore

    real = rescore._stage2_dense

    def certified(*args):
        best_idx, best_score, cert, n_cands = real(*args)
        return best_idx, best_score, cert | True, n_cands

    rescore._stage2_dense = certified
    try:
        yield
    finally:
        rescore._stage2_dense = real


def readings(root: str, name: str, seed: int, seconds: float, platform,
             fault: str) -> dict:
    spec = workload.load_spec(root)
    entry = workload.find_cell(spec, name)
    cfg = workload.load_config(root, spec, entry["config"])
    traffic = workload.load_traffic(root, entry["traffic"])
    limits = workload.load_limits(root, name)
    with planted(fault):
        cell = harness.set_up(cfg, traffic, seed, platform)
        win = harness.measure(cell, seed, seconds, platform)
    del cell.state[:], cell.search
    platform.free()
    sample = check.draw_sample(seed, win.answers, int(limits["sample"]))
    args = (cell.pool, cell.lib, cfg, seed, int(limits["rescore_sample"]))
    t0 = time.perf_counter()
    row = {"seed": seed, "fault": fault, "batches": win.n_batches,
           "sample": len(sample), "program": check.compare(sample, *args)}
    row["reference_s"] = time.perf_counter() - t0
    row["modified_source_missed"] = check.compare(
        sample, *args, source_kinds=("modified",))["source_missed"]
    row["control"] = check.compare(
        check.control_answers(sample, cell.pool, cell.lib, cfg), *args)
    return row


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--fault", choices=("none", "escalation"),
                        default="none")
    args = parser.parse_args(argv)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        row = readings(ROOT, args.workload, seed, args.seconds,
                       harness.Card(), args.fault)
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({
        "workload": args.workload, "fault": args.fault, "seeds": len(rows),
        "program_max": {n: max(r["program"][n] for r in rows)
                        for n in check.NUMBERS},
        "control_min": {n: min(r["control"][n] for r in rows)
                        for n in check.NUMBERS},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
