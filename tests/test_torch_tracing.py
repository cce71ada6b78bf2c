"""The port's tracer (`ann_solo_tpu_torch/utils/profiling.py`) on the
batch path, on the CPU: off by default and free of `record_function`
calls, spans nested by batch, the stage seconds unchanged, counters equal
to what the rescoring tiers and the host copies really did, and the
spans on the profiler's clock around the operations they launch."""

import dataclasses
import gc
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from ann_solo_tpu_torch.convert import library_from_numpy
from ann_solo_tpu_torch.index import ivf
from ann_solo_tpu_torch.models.vectorize import (
    VectorizeParams,
    device_tables,
    vectorize_batch,
)
from ann_solo_tpu_torch.ops import rescore
from ann_solo_tpu_torch.search import OpenSearchParams, ann_open_search_batch
from ann_solo_tpu_torch.utils import profiling
from ann_solo_tpu_torch.utils.profiling import NO_SPAN, profiler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ("vectorize", "select", "rescore", "matches")
LEAVES = ("host_copy", "sync")
N_LIB, N_Q, K, CHARGE = 2048, 64, 50, 2


@dataclasses.dataclass
class _Cell:
    """A tiny open-search cell on the CPU: the index, two query batches
    and the search of one batch."""

    index: ivf.IvfIndex
    pool: list
    search: object  # (batch, stage seconds) -> the batch's answers


def _library(rng):
    mz = np.sort(rng.uniform(101.0, 1500.0, (N_LIB, K)), 1).astype(
        np.float32)
    intensity = rng.uniform(0.1, 1.0, (N_LIB, K)).astype(np.float32)
    intensity /= np.linalg.norm(intensity, axis=1, keepdims=True)
    ann = rng.integers(0, CHARGE + 1, (N_LIB, K)).astype(np.int32)
    prec = np.sort(rng.uniform(400.0, 1200.0, N_LIB))
    return mz, intensity, ann, prec


def _batch(rng, mz, intensity, prec):
    """Noised copies of `N_Q` distinct library rows."""
    rows = rng.choice(N_LIB, N_Q, replace=False)
    q_mz = mz[rows] + rng.normal(0, 0.005, (N_Q, K)).astype(np.float32)
    q_int = np.abs(intensity[rows]
                   + rng.normal(0, 0.02, (N_Q, K)).astype(np.float32))
    q_int /= np.linalg.norm(q_int, axis=1, keepdims=True)
    q_prec = prec[rows] + rng.normal(0, 0.002, N_Q)
    return types.SimpleNamespace(mz=np.sort(q_mz, axis=1), intensity=q_int,
                                 prec=q_prec)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread a test worker, as in `test_torch_fdr_models.py`."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cell():
    """2,048 library rows in 32 lists (8 probed, int8), 64-query batches,
    32 candidates a query, +-300 Da."""
    rng = np.random.default_rng(3_000_000_019)
    mz, intensity, ann, prec = _library(rng)
    vec = VectorizeParams(11.0, 2010.0, 0.04, 800)
    n_peaks = torch.full((N_LIB,), K, dtype=torch.int32)
    vectors = vectorize_batch(vec, device_tables(vec, "cpu"),
                              torch.from_numpy(mz),
                              torch.from_numpy(intensity), n_peaks)
    settings = types.SimpleNamespace(num_list=32, num_probe=8,
                                     ivf_redundancy=1, soar_lambda=1.0)
    index = ivf.IvfIndex.build(vectors, settings,
                               precursor_mz=prec.astype(np.float32),
                               storage_dtype=torch.int8, device="cpu")
    lib = library_from_numpy(mz, intensity, ann, prec, "cpu")
    params = OpenSearchParams(vectorize=vec, num_candidates=32,
                              precursor_tolerance_mass_open=300.0)
    q_n = torch.full((N_Q,), K, dtype=torch.int32)

    def search(batch, stages):
        return ann_open_search_batch(
            index, lib, batch.mz, batch.intensity, q_n, batch.prec, CHARGE,
            params, stage_seconds=stages)

    return _Cell(index, [_batch(rng, mz, intensity, prec) for _ in range(2)],
                 search)


@pytest.fixture(autouse=True)
def clean_profiler():
    profiler.take()
    yield
    assert profiler.tracer is None
    profiler.take()


def _children(batch, i):
    return [s for s in batch.spans if s.parent == i]


def _raise(*args, **kwargs):
    raise AssertionError("record_function called")


def test_tracing_off_records_nothing_and_calls_no_record_function(
        cell, monkeypatch):
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    assert profiler.tracer is None
    assert profiling.span("select.probe") is NO_SPAN
    assert profiler.batch(64, 2) is NO_SPAN
    cell.search(cell.pool[0], {})
    cell.search(cell.pool[1], None)
    assert profiler.take() == []
    # On without a profile: spans are kept, still no record_function.
    with profiler.tracing():
        cell.search(cell.pool[0], {})
    assert len(profiler.take()) == 1


def test_spans_nest_by_batch(cell):
    with profiler.tracing():
        for i in range(2):
            cell.search(cell.pool[i], {})
    batches = profiler.take()
    assert [b.batch_id for b in batches] == [batches[0].batch_id,
                                            batches[0].batch_id + 1]
    for b in batches:
        root = b.spans[0]
        assert root.name == "batch" and root.parent == -1
        assert root.attrs["queries"] == 64 and root.attrs["charge"] == 2
        assert root.attrs["regime"] == "fullscan"
        assert [s.name for s in _children(b, 0)] == list(STAGES)
        for i, s in enumerate(b.spans[1:], 1):
            parent = b.spans[s.parent]
            assert 0 <= s.parent < i
            assert parent.start_ns <= s.start_ns <= s.end_ns <= \
                parent.end_ns
            if s.name in LEAVES:
                assert _children(b, i) == []
        matches = [s.name for s in _children(b,
            [s.name for s in b.spans].index("matches"))]
        assert matches == ["matches.pairs", "host_copy", "host_copy",
                           "matches.rows", "sync"]
        assert b.counters["queries"] == 64


def test_stage_seconds_keep_their_names_and_syncs(cell):
    seconds_off, seconds_on = {}, {}
    cell.search(cell.pool[0], seconds_off)
    with profiler.tracing():
        cell.search(cell.pool[0], seconds_on)
        cell.search(cell.pool[0], None)
    assert list(seconds_off) == list(STAGES) == list(seconds_on)
    assert all(v > 0 for v in seconds_on.values())
    with_seconds, without = profiler.take()
    # A sync a stage with stage seconds, none without: spans never sync.
    assert [with_seconds.spans[s.parent].name for s in with_seconds.spans
            if s.name == "sync"] == list(STAGES)
    assert not any(s.name == "sync" for s in without.spans)
    # The stage seconds run from one stage's end to the next.
    total = with_seconds.seconds(*STAGES)
    assert sum(seconds_on.values()) >= total * 0.99


def _escalation_arrays():
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_torch_rescore import _escalation_corpus

    arrays, cand = _escalation_corpus()
    return [torch.from_numpy(a) for a in arrays], torch.from_numpy(cand)


def test_tier_counters_equal_the_rows_each_tier_receives(monkeypatch):
    from ann_solo_tpu_torch.ops import shifted_dot_cuda

    arrays, cand = _escalation_arrays()
    seen = {"tiers": [], "full": [], "b1": []}
    stage2, full = rescore._stage2_dense, rescore._greedy_pairs_chunked
    b1 = shifted_dot_cuda.shifted_dot_full

    def b1_seen(*args, **kwargs):
        seen["b1"].append(int(args[0].shape[0]))
        return b1(*args, **kwargs)

    def stage2_seen(*args):
        seen["tiers"].append((int(args[8].shape[0]), int(args[9])))
        return stage2(*args)

    def full_seen(*args):
        seen["full"].append(len(np.unique(args[7])))
        return full(*args)

    monkeypatch.setattr(rescore, "_stage2_dense", stage2_seen)
    monkeypatch.setattr(rescore, "_greedy_pairs_chunked", full_seen)
    monkeypatch.setattr(shifted_dot_cuda, "shifted_dot_full", b1_seen)
    with profiler.tracing() as tracer, tracer.span("batch"):
        rescore.rescore_candidate_matrix(*arrays, cand, 0.02, 3, True,
                                         top_t=8, t0=4)
    (b,) = profiler.take()
    # The corpus escalates through both tiers to all C candidates.
    assert [t for _, t in seen["tiers"]] == [4, 8] and seen["full"]
    for rows, t in seen["tiers"]:
        assert b.counters[f"rescore.t{t}.rows"] == rows
    assert b.counters["rescore.full.rows"] == sum(seen["full"])
    tiers = [s for s in b.spans if s.name == "rescore.tier"]
    assert [(s.attrs["rows"], s.attrs["t"]) for s in tiers] == seen["tiers"]
    full_span = next(s for s in b.spans if s.name == "rescore.full")
    assert full_span.attrs["rows"] == sum(seen["full"])
    # B1's launches (a tier each, a full-C chunk each) and their pairs.
    assert len(seen["b1"]) > 2
    assert b.counters["b1.launches"] == len(seen["b1"])
    assert b.counters["b1.pairs"] == sum(seen["b1"])


def test_host_copies_count_every_copy_to_the_host(cell, monkeypatch):
    calls = []
    real_cpu = torch.Tensor.cpu

    def counted(self, *args, **kwargs):
        calls.append(self.numel())
        return real_cpu(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "cpu", counted)
    with profiler.tracing():
        cell.search(cell.pool[0], {})
    (b,) = profiler.take()
    assert len(calls) == b.counters["host_copies"] == 6
    assert sum(s.name == "host_copy" for s in b.spans) == len(calls)
    assert b.counters["host_bytes"] == sum(
        s.attrs["bytes"] for s in b.spans if s.name == "host_copy")


def test_matches_reach_the_host_as_one_block(cell):
    """The batch's matches: two copies (the counts, then Sigma M pairs of
    16 bytes), a mapping of every answered row in row order that survives
    the engine's merge and the benchmark's `check.keep`, and the counter
    ``matches.pairs_out``."""
    from benchmark import check

    batch = types.SimpleNamespace(**vars(cell.pool[0]))
    batch.prec = batch.prec.copy()
    batch.prec[7] = 5000.0  # no library row in its window: no answer
    with profiler.tracing():
        out = cell.search(batch, {})
    (b,) = profiler.take()
    best, _, _, matches = out
    rows = np.nonzero(best >= 0)[0]
    assert best[7] == -1 and len(rows) == N_Q - 1
    assert list(matches) == rows.tolist() and len(matches) == len(rows)
    assert 7 not in matches and matches.get(7) is None
    pairs = sum(len(matches[r]) for r in rows)
    assert b.counters["matches.pairs_out"] == pairs > N_Q
    i = [s.name for s in b.spans].index("matches")
    copied = [s.attrs["bytes"] for s in b.spans
              if s.name == "host_copy" and s.parent == i]
    assert copied == [4 * len(rows), 16 * pairs]
    # The engine's merge of a part's rows at offset `lo`.
    lo = 4096
    merged = {}
    merged.update({row + lo: m for row, m in matches.items()})
    assert list(merged) == (rows + lo).tolist()
    for r in rows:
        m = merged[int(r) + lo]
        assert m.dtype == np.int64 and m.ndim == 2 and m.shape[1] == 2
        assert m.flags.c_contiguous
        np.testing.assert_array_equal(m, matches[r])
    # The benchmark's check keeps answers through `.get` and np.asarray.
    answers = []
    kept = [0, 7, 31, N_Q - 1]
    check.keep(answers, out, 0, np.asarray(kept))
    assert [a.row for a in answers] == kept
    for a in answers:
        want = matches[a.row] if a.row != 7 else np.zeros((0, 2))
        np.testing.assert_array_equal(a.matches, want)
        assert a.matches.shape == (len(want), 2)


def test_select_counts_its_regime_and_spans_its_steps(cell, monkeypatch):
    monkeypatch.setattr(ivf, "_FULLSCAN_TRANSIENT", 0)
    with profiler.tracing():
        cell.search(cell.pool[0], {})
    (b,) = profiler.take()
    assert b.spans[0].attrs["regime"] == "probe"
    assert b.counters["select.regime.probe"] == 1
    select = [s.name for s in b.spans
              if b.spans[s.parent].name == "select"]
    assert select == ["select.probe", "select.scan", "select.select", "sync"]


def _tensors_in(obj, seen=None):
    """The tensors `obj` reaches through its references."""
    seen = set() if seen is None else seen
    if id(obj) in seen or isinstance(obj, (str, bytes, int, float, type)):
        return []
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return [obj]
    return [t for ref in gc.get_referents(obj)
            for t in _tensors_in(ref, seen)]


def test_traced_batches_hold_no_tensor(cell, monkeypatch):
    monkeypatch.setattr(ivf, "_FULLSCAN_TRANSIENT", 0)  # B2's probe path
    with profiler.tracing():
        cell.search(cell.pool[0], {})
    batches = list(profiler._tracer.batches)
    assert len(batches) == 1 and len(batches[0].spans) > 20
    assert _tensors_in(batches) == []
    assert _tensors_in(profiler._tracer) == []
    profiler.take()


def test_spans_lie_around_their_operations_on_the_profilers_clock(cell):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cell.search(cell.pool[0], {})
    assert profiler.tracer is None  # on for the profiled batch alone
    (b,) = profiler.take()
    events = [e for e in prof.events() if e.device_type.name == "CPU"]
    spans = sorted((e for e in events
                    if e.name.startswith(profiling.SPAN_PREFIX)),
                   key=lambda e: e.time_range.start)
    assert [e.name for e in spans] == [
        profiling.SPAN_PREFIX + s.name for s in b.spans]
    inside = {id(e): 0 for e in spans}
    for e in events:
        if not e.name.startswith("aten::"):
            continue
        parent = e.cpu_parent
        while parent is not None:
            if id(parent) in inside:
                inside[id(parent)] += 1
                assert parent.time_range.start <= e.time_range.start
                assert e.time_range.end <= parent.time_range.end
            parent = parent.cpu_parent
    by_name = {}
    for e in spans:
        by_name[e.name] = by_name.get(e.name, 0) + inside[id(e)]
    for name in ("batch", "vectorize", "select", "rescore.bounds",
                 "matches.pairs"):
        assert by_name[profiling.SPAN_PREFIX + name] > 0, name
    # Every operation launched inside the batch is under its root span.
    root = spans[0]
    for e in events:
        if e.name.startswith("aten::") and e.cpu_parent is None:
            assert not (root.time_range.start < e.time_range.start
                        < root.time_range.end), e.name


def test_following_the_profiler_can_be_turned_off(cell, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(profiler, "follow_profiler", False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cell.search(cell.pool[0], {})
    assert profiler.take() == []
    assert not any(e.name.startswith(profiling.SPAN_PREFIX)
                   for e in prof.events())


def test_device_trace_carries_the_program_spans(cell, tmp_path):
    with profiling.device_trace(str(tmp_path)):
        cell.search(cell.pool[0], {})
    trace = json.loads((tmp_path / "trace_00000.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert {"ann_solo.batch", "ann_solo.matches.rows",
            "ann_solo.host_copy"} <= names
    assert len(profiler.take()) == 1


def test_summary_prints_counts_and_traced_counters():
    saved = (dict(profiler.totals), dict(profiler.counts))
    profiler.reset()
    try:
        profiler.add("open vectorize", 2.0)
        profiler.count("open level charge 2: ivf select")
        assert profiler.summary() == (
            "open vectorize: 2.00s (100%, n=1); "
            "open level charge 2: ivf select: n=1")
        with profiler.tracing() as tracer:
            with tracer.span("batch"):
                tracer.count("host_copies", 3)
                profiler.count("kernel loaded shifted_dot")
        assert profiler.summary() == (
            "open vectorize: 2.00s (100%, n=1); "
            "kernel loaded shifted_dot: n=1; "
            "open level charge 2: ivf select: n=1; "
            "traced host_copies 3, kernel loaded shifted_dot 1")
        (b,) = profiler.take()
        assert b.counters == {"host_copies": 3,
                              "kernel loaded shifted_dot": 1}
    finally:
        profiler.reset()
        profiler.totals.update(saved[0])
        profiler.counts.update(saved[1])


def test_span_and_counter_sites_allocate_nothing_while_off():
    def sites(n):
        for _ in range(n):
            with profiling.span("select.probe"):
                pass
            with profiler.batch(64, 2):
                pass
            tracer = profiler.tracer
            if tracer is not None:
                tracer.count("queries", 64)

    sites(10)
    before = sys.getallocatedblocks()
    sites(10000)
    assert sys.getallocatedblocks() - before < 100
