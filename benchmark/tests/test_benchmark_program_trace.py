"""The program's own trace against the benchmark's wrappers on the CPU:
the same rows a rescoring tier as the `tracing.Recorder`, the three metrics
read from the program's spans and counters, and the traced passes'
device list and breakdown unchanged by the program's tracing."""

import json
import os

import pytest
import torch

from benchmark import harness, program_trace, tracing
from benchmark.tests.conftest import (
    TINY_CELL,
    HostStandIn,
    tiny_config,
    tiny_traffic,
)

SEED = 3_000_000_019
N = 3  # batches of the device-only pass
PROGRAM_METRICS = {"matches_loop_ms", "host_wait_ms", "host_copies"}


@pytest.fixture
def program():
    from ann_solo_tpu_torch.utils.profiling import profiler

    profiler.take()
    yield profiler
    profiler.follow_profiler = True
    profiler.take()


def _every_certificate_fails(monkeypatch):
    """Stage 2 reports every certificate failed, so each batch runs both
    tiers and the greedy over all its candidates."""
    from ann_solo_tpu_torch.ops import rescore

    real = rescore._stage2_dense

    def failed(*args):
        best_idx, best_score, cert, n_cands = real(*args)
        return best_idx, best_score, cert & False, n_cands

    monkeypatch.setattr(rescore, "_stage2_dense", failed)


def test_program_tier_rows_equal_the_recorders(program, monkeypatch):
    monkeypatch.setattr(harness, "LABEL_BATCHES", 1)
    _every_certificate_fails(monkeypatch)
    cfg = tiny_config()
    cfg["num_candidates"] = 64  # tier 2 at 32, then all 64
    cell = harness.set_up(cfg, tiny_traffic(), SEED, HostStandIn())
    program.take()
    record = harness.trace(cell, HostStandIn(), N)
    batches = program.take()[:N]
    tiers = sorted({t for _, t in record.tiers})
    assert tiers == [8, 32]
    for t in tiers:
        assert sum(b.counters[f"rescore.t{t}.rows"] for b in batches) == \
            sum(rows for rows, tt in record.tiers if tt == t)
    assert sum(b.counters["rescore.full.rows"] for b in batches) == \
        record.full_rows == 64 * N
    # 4 host copies a tier, 2 in the matches, and for the greedy over all
    # C the candidates' copy and one a chunk of 8,192 pairs.
    assert [b.counters["host_copies"] for b in batches] == [4 + 4 + 2 + 2] * N


def test_traced_line_carries_the_program_metrics(tiny_root, program,
                                                 monkeypatch):
    real = tracing.read_profile

    def planted(prof):
        # One device operation in each pass, as a run on the card has.
        window, device, spans = real(prof)
        return window, device + [("planted", 0.0, 1.0)], spans

    monkeypatch.setattr(tracing, "read_profile", planted)
    out = harness.run_cell(tiny_root, TINY_CELL, SEED, 0.3, True,
                           HostStandIn(), 0.0)
    metrics = out["metrics"]
    assert PROGRAM_METRICS <= set(metrics)
    assert metrics["host_copies"]["unit"] == "copies"
    # 6 copies a batch, 4 more in each batch whose rows ran the second
    # tier (32 candidates: none goes further).
    copies = metrics["host_copies"]["value"]
    n = harness.TRACE_BATCHES
    assert any(copies == pytest.approx(6 + 4 * k / n) for k in range(n + 1))
    assert (copies > 6) == (metrics["rescore_t32_pct"]["value"] > 0)
    assert 0 < metrics["matches_loop_ms"]["value"] < \
        metrics["matches_ms"]["value"]
    assert metrics["host_wait_ms"]["value"] > 0
    json.dumps(out)


def test_readers_find_nothing_without_a_program_trace(program):
    record = tracing.TraceRecord(
        n_batches=4, stage_seconds={}, traced_batches=N,
        device_ops=[("k", 0.0, 1.0)])
    for name in sorted(PROGRAM_METRICS):
        assert harness.load_reader(harness.workload.ROOT, name)(record) \
            is None
    assert program_trace.batches(record) == []


def _passes(cell, follow: bool, program):
    program.follow_profiler = follow
    try:
        return harness.trace(cell, HostStandIn(), N), program.take()
    finally:
        program.follow_profiler = True


def test_device_list_and_breakdown_do_not_move_with_program_tracing(
        program):
    cell = harness.set_up(tiny_config(), tiny_traffic(), SEED, HostStandIn())
    off, none = _passes(cell, False, program)
    on, traced = _passes(cell, True, program)
    assert none == [] and len(traced) == N + harness.LABEL_BATCHES
    assert [n for n, _, _ in off.device_ops] == \
        [n for n, _, _ in on.device_ops]
    for a, b in ((off.labelled, on.labelled),):
        assert (a[0] is None) == (b[0] is None)
        assert [n for n, _, _ in a[1]] == [n for n, _, _ in b[1]]
        assert [n for n, _, _ in a[2]] == [n for n, _, _ in b[2]]
    assert off.tiers == on.tiers and off.b4_work == on.b4_work
    assert off.b2_work == on.b2_work
    brk_off, brk_on = tracing.breakdown(off), tracing.breakdown(on)
    assert [n for n, _ in brk_off["device_ops"]] == \
        [n for n, _ in brk_on["device_ops"]]
    assert {n for n, _ in brk_off["idle_gaps"]} <= \
        {"harness", "vectorize", "select", "rescore", "matches"}
    assert {n for n, _ in brk_on["idle_gaps"]} <= \
        {"harness", "vectorize", "select", "rescore", "matches"}


@pytest.mark.chip
def test_program_trace_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    import subprocess
    import sys

    from benchmark.tests.conftest import REPO

    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "benchmark", "program_trace.py"),
         "--workload", "iprg2012_c2_131k.self", "--seed", str(SEED),
         "--batches", "4", "--rounds", "1"],
        capture_output=True, text=True, cwd=REPO, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["device_ops_same"] and out["label_ops_same"]
