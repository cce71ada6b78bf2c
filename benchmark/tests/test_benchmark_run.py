"""A run end to end on the CPU: the result line's keys, the refusal
without a card, the import guard, and faults planted under the timed path
that the check must catch."""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import REPO, TINY_CELL, HostStandIn

SEED = 3_000_000_019


def test_end_to_end_line_has_the_contract_keys(tiny_root):
    out = harness.run_cell(tiny_root, TINY_CELL, SEED, 0.3, False,
                           HostStandIn(), 0.0)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(out["metrics"]) == {"queries_per_s", "batch_ms_p95",
                                   "setup_s"}
    for metric in out["metrics"].values():
        assert set(metric) == {"value", "unit"} and metric["value"] > 0
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert out["attempted"] % 64 == 0 and out["failed"] == 0
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


def test_traced_line_has_per_layer_metrics_and_breakdown(tiny_root):
    out = harness.run_cell(tiny_root, TINY_CELL, SEED, 0.3, True,
                           HostStandIn(), 0.0)
    assert list(out)[-1] == "checks"
    # On the CPU no kernel runs: the stage and tier metrics read, the
    # device's metrics find nothing and are left out.
    assert set(out["metrics"]) == {"vectorize_ms", "select_ms",
                                   "rescore_ms", "matches_ms",
                                   "rescore_t32_pct", "rescore_full_pct"}
    # 32 candidates: the second tier takes them all, no row goes further.
    assert 0 <= out["metrics"]["rescore_t32_pct"]["value"] <= 100
    assert out["metrics"]["rescore_full_pct"]["value"] == 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["device"]["window_s"] > 0 and out["device"]["busy_s"] == 0
    assert out["correct"] is True


def test_run_without_a_card_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "benchmark", "run.py"),
         "--workload", "iprg2012_c2_131k.self", "--seed", "1", "--seconds",
         "1", "--trace", "0"],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_import_guard(monkeypatch):
    assert harness.forbidden_modules() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "ann_solo_tpu_torch_extra",
                        types.ModuleType("ann_solo_tpu_torch_extra"))
    assert "ann_solo_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ann_solo_tpu.search",
                        types.ModuleType("ann_solo_tpu.search"))
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client",
                        types.ModuleType("jaxlib.xla_client"))
    found = harness.forbidden_modules()
    assert "ann_solo_tpu" in found and "jaxlib" in found


def test_a_cpu_run_imports_no_jax(tiny_root):
    """In a process of its own: a run, then the guard."""
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "from benchmark import harness;"
        "from benchmark.tests.conftest import HostStandIn;"
        "harness.run_cell(sys.argv[2], sys.argv[3], 5, 0.2, True,"
        " HostStandIn(), 0.0);"
        "import ann_solo_tpu_torch;"
        "print(harness.forbidden_modules())")
    proc = subprocess.run([sys.executable, "-c", code, REPO, tiny_root,
                           TINY_CELL], capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def _broken(monkeypatch, fault):
    from ann_solo_tpu_torch import search
    from ann_solo_tpu_torch.ops import rescore

    if fault == "rescore_second_best":
        # Every fourth query gets the second best of its candidates, with
        # that candidate's own exact score (and so its own matches).
        real_rescore = search.rescore_candidate_matrix

        def second_best(*args):
            best, score, n_cands = real_rescore(*args)
            rows = torch.arange(0, len(best), 4)
            cands = args[7].clone()
            won = torch.as_tensor(best[rows.numpy()]).to(cands.dtype)
            cands[rows] = torch.where(cands[rows] == won[:, None], -1,
                                      cands[rows])
            best2, score2, _ = real_rescore(*args[:7], cands, *args[8:])
            best, score = best.copy(), score.copy()
            best[rows.numpy()] = best2[rows.numpy()]
            score[rows.numpy()] = score2[rows.numpy()]
            return best, score, n_cands

        monkeypatch.setattr(search, "rescore_candidate_matrix", second_best)
        return
    real = search.ann_open_search_batch

    def broken(index, lib, q_mz, q_int, q_n, q_prec, charge, params,
               stage_seconds=None):
        if fault == "half_batch":
            # Half of the batch left out: only the first half searched.
            half = q_mz.shape[0] // 2
            best, score, n_cands, matches = real(
                index, lib, q_mz[:half], q_int[:half], q_n[:half],
                q_prec[:half], charge, params, stage_seconds)
            pad = q_mz.shape[0] - half
            return (np.concatenate([best, np.full(pad, -1)]),
                    np.concatenate([score, np.full(pad, -np.inf)]),
                    np.concatenate([n_cands, np.zeros(pad, n_cands.dtype)]),
                    matches)
        best, score, n_cands, matches = real(
            index, lib, q_mz, q_int, q_n, q_prec, charge, params,
            stage_seconds)
        best, matches = best.copy(), dict(matches)
        if fault == "row_altered":
            # Every fourth answer names the next library row.
            n = lib.mz.shape[0]
            best[::4] = np.where(best[::4] >= 0, (best[::4] + 1) % n, -1)
        elif fault == "match_altered":
            for row in list(matches)[::4]:
                m = matches[row].copy()
                if len(m):
                    m[0, 1] = (m[0, 1] + 1) % q_mz.shape[1]
                matches[row] = m
        return best, score, n_cands, matches

    monkeypatch.setattr(search, "ann_open_search_batch", broken)


@pytest.mark.parametrize("fault", ["half_batch", "row_altered",
                                   "match_altered", "rescore_second_best"])
def test_faults_under_the_timed_path_make_the_run_incorrect(
        tiny_root, monkeypatch, fault):
    _broken(monkeypatch, fault)
    out = harness.run_cell(tiny_root, TINY_CELL, SEED, 0.3, False,
                           HostStandIn(), 0.0)
    assert out["correct"] is False
    if fault == "rescore_second_best":
        checks = out["checks"]
        assert checks["score_gap"]["value"] == 0.0
        assert checks["rescore_missed"]["value"] > \
            checks["rescore_missed"]["limit"]


@pytest.mark.chip
def test_a_short_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "benchmark", "run.py"),
         "--workload", "iprg2012_c2_131k.self", "--seed", str(SEED),
         "--seconds", "2", "--trace", "1"],
        capture_output=True, text=True, cwd=REPO, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0
    assert {"b2_roofline_pct", "b4_roofline_pct",
            "device_idle_pct"} <= set(out["metrics"])
