"""Kernel work counts against hand counts, and the readers' arithmetic."""

import pytest
import torch

from benchmark import harness, tracing, work
from benchmark.tests.conftest import REPO


def test_b2_work_hand_count():
    # 3 queries probing lists {0, 2}, {2, 5}, {-1, 4} of 6 lists (cap 4,
    # D 8, int8): lists 0, 2, 4, 5 read once; the invalid id is not.
    probe = torch.tensor([[0, 2], [2, 5], [-1, 4]], dtype=torch.int64)
    n_bytes, ops = work.b2_work((6, 4, 8), 1, probe)
    lists = 4 * 4 * (8 * 1 + 12)
    queries = 3 * 8 * 4 + 3 * 4
    table = 6 * 8
    out = 3 * 2 * 4 * 4
    assert n_bytes == lists + queries + table + out
    assert ops == 2 * 3 * 2 * 4 * 8


def test_b4_work_hand_count():
    # Kq = Kc = 2; library row 1 has a zero-intensity tail (1 kept peak)
    # and row 2 descends (walked densely); charge 2 with shifts, tol 0.5.
    q_mz = torch.tensor([[100.0, 200.0]])
    q_int = torch.tensor([[0.6, 0.8]])
    q_prec = torch.tensor([500.0])
    lib_mz = torch.tensor([[100.0, 300.0], [150.0, 0.0], [400.0, 120.0]])
    lib_int = torch.tensor([[0.5, 0.5], [1.0, 0.0], [0.7, 0.7]])
    lib_prec = torch.tensor([500.0, 490.0, 520.0])
    cand = torch.tensor([[0, 1, 2, -1]])
    n_bytes, ops = work.b4_work(q_mz, q_int, q_prec, lib_mz, lib_int,
                                lib_prec, cand, 0.5, 3, True)
    # Row 0: |prec_diff| = 0 < tol -> the direct window only: (2 + 2) * 2.
    # Row 1: prec_diff 20 -> two shift windows: (2 + 1) * (2 + 3 * 2).
    # Row 2: dense, prec_diff 40: 2 * 2 * (2 + 2 * 2).
    # Then 2 Kq = 4 operations a valid pair.
    assert ops == 8 + 24 + 24 + 3 * 4
    assert n_bytes == 2 * 8 + 4 + 4 * 8 + 3 * (2 * 12 + 4) + 4 * 4


def test_least_seconds_takes_the_larger_bound():
    assert work.least_seconds(3.35e12, 0.0, 1.0) == pytest.approx(1.0)
    assert work.least_seconds(0.0, 2 * work.BF16_FLOPS,
                              work.BF16_FLOPS) == pytest.approx(2.0)


def _record(**kw):
    base = dict(n_batches=4, stage_seconds={"vectorize": 0.02,
                                            "select": 0.04,
                                            "rescore": 0.06,
                                            "matches": 0.08},
                measured_s=2e-3, traced_batches=2, window_s=1.5e-3)
    base.update(kw)
    return tracing.TraceRecord(**base)


def test_readers():
    ops = [("void probe_scan_kernel<signed char>", 0.0, 100.0),
           ("prep_queries_kernel", 100.0, 150.0),
           ("void stage1_bounds_kernel<2>", 200.0, 400.0),
           ("elementwise", 350.0, 500.0)]
    b2 = [(0.0, 0.5 * 150e-6 * work.BF16_FLOPS)]  # half the B2 time
    b4 = [(3.35e12 * 50e-6, 0.0)]  # a quarter of the B4 time
    record = _record(device_ops=ops, b2_work=b2, b4_work=b4)
    read = {name: harness.load_reader(REPO, name)(record) for name in (
        "vectorize_ms", "select_ms", "rescore_ms", "matches_ms",
        "b2_roofline_pct", "b4_roofline_pct", "device_idle_pct")}
    assert read["vectorize_ms"] == pytest.approx(5.0)
    assert read["matches_ms"] == pytest.approx(20.0)
    assert read["b2_roofline_pct"] == pytest.approx(50.0)
    assert read["b4_roofline_pct"] == pytest.approx(25.0)
    # Busy: [0, 150] and [200, 500], 225 us a traced batch, of 500 us a
    # batch in the measured window.
    assert read["device_idle_pct"] == pytest.approx(55.0)


def test_tier_readers():
    # Two batches of 100 rows: 30 and 10 fail the first tier, 4 and 0 the
    # second.
    record = _record(tiers=[(100, 8), (30, 32), (100, 8), (10, 32)],
                     full_rows=4)
    t32 = harness.load_reader(REPO, "rescore_t32_pct")(record)
    full = harness.load_reader(REPO, "rescore_full_pct")(record)
    assert t32 == pytest.approx(20.0) and full == pytest.approx(2.0)
    assert harness.load_reader(REPO, "rescore_t32_pct")(_record()) is None


def test_readers_find_nothing_without_their_launches():
    record = _record(n_batches=0, stage_seconds={}, measured_s=0.0)
    for name in ("vectorize_ms", "b2_roofline_pct", "b4_roofline_pct",
                 "device_idle_pct", "rescore_full_pct"):
        assert harness.load_reader(REPO, name)(record) is None
    # A B2 launch counted that the trace does not hold: nothing, not 0.
    record = _record(device_ops=[("probe_scan_kernel", 0.0, 10.0)],
                     b2_work=[(1.0, 1.0), (1.0, 1.0)])
    assert harness.load_reader(REPO, "b2_roofline_pct")(record) is None


def test_breakdown_labels_idle_gaps_by_host_span():
    ops = [("k1", 0.0, 100.0), ("k2", 300.0, 400.0)]
    spans = [("matches", 90.0, 350.0), ("select", 400.0, 900.0)]
    out = tracing.breakdown(_record(device_ops=ops,
                                    labelled=((0.0, 1000.0), ops, spans)))
    assert out["device_ops"] == [["k1", 1e-4], ["k2", 1e-4]]
    assert out["idle_gaps"] == [["select", 6e-4], ["matches", 2e-4]]
