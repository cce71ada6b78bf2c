"""The port's diagnostics (`ann_solo_tpu_torch.tools`) against the repo's
`tools/bf_profile.py`, `tools/probe_diag.py` and `tools/fdr_leak_diag.py`,
and `utils.profiling.device_trace`.

One QUALITY workdir is made on the CPU by the port's `quality.main`
(2,000 peptides, 400 queries); each JAX tool (imported by path) and its
port read it.  `bf_profile` (first 100 queries): the same window-rescoring
calls and pairs at each cascade level and the same best-pair calls and
pairs.  `probe_diag`: the port searches the JAX tool's own bf16 indexes
(carried over by `convert.ivf_index_from_numpy`), so the probed-list
recalls are equal at every depth and ordering.  `fdr_leak_diag`: equal
JSON.  `device_trace`: a no-op without a directory, one trace a block
with one, and the engine's PSM lines are the same with the trace switched
on.
"""

import importlib.util
import json
import os
import re

import numpy as np
import pytest
import torch

import ann_solo_tpu.search as jax_search
from ann_solo_tpu_torch import quality
from ann_solo_tpu_torch.cli import main as torch_cli
from ann_solo_tpu_torch.convert import ivf_index_from_numpy
from ann_solo_tpu_torch.index.ivf import IvfIndex
from ann_solo_tpu_torch.tools import bf_profile, fdr_leak_diag, probe_diag
from ann_solo_tpu_torch.utils.profiling import device_trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PROFILED = 100


def _tool(name):
    """A script of the repo's `tools/` as a module (imported by path)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread a test worker, as in `test_torch_fdr_models.py`."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def jax_single_device(monkeypatch):
    monkeypatch.setattr(jax_search.SpectralLibrary, "_make_library_mesh",
                        staticmethod(lambda: None))


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A QUALITY workdir written by the port on the CPU."""
    path = tmp_path_factory.mktemp("quality_workdir")
    assert quality.main([
        "--n-peptides", "2000", "--n-queries", "400", "--seed", "42",
        "--model", "none", "--num_probe", "256", "--num_candidates", "1024",
        "--index_dtype", "int8", "--workdir", str(path),
        "--out", str(path / "quality.json"), "--no_gpu"]) == 0
    for name in ("library.splib", "queries.mgf", "truth.json", "bf.mztab",
                 "ann.mztab"):
        assert (path / name).is_file()
    return path


def _psm_lines(path):
    with open(path) as f:
        return [line for line in f if line.startswith("PSM\t")]


def test_bf_profile_equals_jax(workdir, jax_single_device, monkeypatch,
                               tmp_path, capsys):
    """Per level and in all, the JAX tool's window-rescoring and
    best-pair calls and pairs."""
    tool = _tool("bf_profile")
    # The JAX tool slices the queries into a fixed path; keep it here.
    sliced = str(tmp_path / "bf_profile_queries.mgf")
    fixed = "/tmp/bf_profile_queries.mgf"
    monkeypatch.setattr(tool, "open", lambda path, *a, **k: open(
        sliced if path == fixed else path, *a, **k), raising=False)
    search = jax_search.SpectralLibrary.search
    monkeypatch.setattr(jax_search.SpectralLibrary, "search",
                        lambda self, path: search(
                            self, sliced if path == fixed else path))
    # Count the JAX engine's calls by level, under the tool's own timers.
    level, counted = ["std"], {}
    cascade = jax_search.SpectralLibrary._search_cascade
    window = jax_search.SpectralLibrary._rescore_window_ranges
    matches = jax_search.SpectralLibrary._best_pair_matches

    def count(name, pairs):
        entry = counted.setdefault(name, [0, 0])
        entry[0] += 1
        entry[1] += int(pairs)

    def counting_cascade(self, query_spectra, mode):
        level[0] = mode
        return cascade(self, query_spectra, mode)

    def counting_window(self, q_mz, q_int, q_prec, lib, lo, hi, charge):
        count(f"{level[0]} window_rescore", np.sum(hi - lo))
        return window(self, q_mz, q_int, q_prec, lib, lo, hi, charge)

    def counting_matches(self, q_mz, q_int, q_prec, lib, rows, cand_idx,
                         charge):
        count("best_pair_matches", len(rows))
        return matches(self, q_mz, q_int, q_prec, lib, rows, cand_idx,
                       charge)

    monkeypatch.setattr(jax_search.SpectralLibrary, "_search_cascade",
                        counting_cascade)
    monkeypatch.setattr(jax_search.SpectralLibrary, "_rescore_window_ranges",
                        counting_window)
    monkeypatch.setattr(jax_search.SpectralLibrary, "_best_pair_matches",
                        counting_matches)
    assert tool.main(str(workdir), N_PROFILED) == 0
    printed = capsys.readouterr().out
    calls = {name: int(n) for name, n in re.findall(
        r"^\s+(\w+)\s+[\d.]+s\s+calls=(\d+)", printed, re.M)}
    assert calls["window_rescore"] == sum(
        v[0] for k, v in counted.items() if k.endswith("window_rescore"))
    assert calls["best_pair_matches"] == counted["best_pair_matches"][0]

    out = bf_profile.profile(str(workdir), N_PROFILED, no_gpu=True)
    assert out["n_queries"] == N_PROFILED
    got = {name: [leg["calls"], leg["pairs"]]
           for name, leg in out["legs"].items()}
    assert got == counted
    assert got["std window_rescore"][1] > 0
    assert got["open window_rescore"][1] > 0
    assert set(out["stages_sec"]) == {"std window rescoring",
                                      "open window rescoring"}
    assert (workdir / "bf_profile_queries.mgf").read_text() == \
        open(sliced).read()


def test_kernel_seconds_split(tmp_path):
    """Device events of the traces summed by name; CPU events left out."""
    events = [
        {"ph": "X", "cat": "kernel", "name": "void shifted_dot_greedy_kernel"
         "<float>(float const*)", "dur": 300.0},
        {"ph": "X", "cat": "kernel", "name": "elementwise_kernel",
         "dur": 600.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "dur": 100.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "dur": 5000.0},
    ]
    for i in range(2):
        (tmp_path / f"trace_{i:05d}.json").write_text(
            json.dumps({"traceEvents": events}))
    by_name = bf_profile.kernel_seconds(str(tmp_path))
    assert by_name == pytest.approx({
        "void shifted_dot_greedy_kernel<float>(float const*)": 6e-4,
        "elementwise_kernel": 1.2e-3, "Memcpy DtoH": 2e-4})


def test_probe_diag_equals_jax(workdir, jax_single_device, monkeypatch,
                               capsys):
    tool = _tool("probe_diag")
    indexes = {}
    shutdown = jax_search.SpectralLibrary.shutdown

    def keep_indexes(self):
        for charge, idx in self._ann_indexes.items():
            indexes[charge] = [np.asarray(a) for a in (
                idx.centroids, idx.padded_vectors, idx.padded_ids,
                idx.padded_prec, idx.padded_scales)] + [
                idx.num_probe, idx.redundancy]
        shutdown(self)

    monkeypatch.setattr(jax_search.SpectralLibrary, "shutdown", keep_indexes)
    assert tool.main(str(workdir)) == 0
    printed = capsys.readouterr().out
    assert set(indexes) == {2, 3}

    def jax_index(filename, lib, config, store_fp=None, device=None,
                  stage_seconds=None, notes=None):
        charge = int(re.search(r"_[0-9a-f]{7}_(\d+)",
                               os.path.basename(filename)).group(1))
        index = ivf_index_from_numpy(*indexes[charge], device, store_fp)
        index.save(filename)  # the engine reports the file's size
        return index

    monkeypatch.setattr(IvfIndex, "load_or_build", staticmethod(jax_index))
    out = probe_diag.diagnose(str(workdir), no_gpu=True)
    n_checked = int(re.search(r"n_checked=(\d+)", printed).group(1))
    assert out["n_checked"] == n_checked > 0
    for name in probe_diag.ORDERINGS:
        row = re.search(rf"^{name}\s+([\d. ]+)$", printed, re.M).group(1)
        want = [float(v) for v in row.split()]
        got = [out["recall"][name][f"p<={p}"] for p in probe_diag.PROBES]
        assert [round(v, 4) for v in got] == want, name


def test_fdr_leak_diag_equals_jax(workdir):
    tool = _tool("fdr_leak_diag")
    want = tool.diagnose(str(workdir))
    got = fdr_leak_diag.diagnose(str(workdir))
    assert set(got) == {"bf", "ann"}
    assert json.dumps(got) == json.dumps(want)
    assert fdr_leak_diag.main([str(workdir)]) == 0
    assert json.loads((workdir / "fdr_leak_diag.json").read_text()) == want


def test_device_trace_off_is_a_no_op(tmp_path, monkeypatch):
    monkeypatch.delenv("ANN_SOLO_TORCH_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with device_trace():
        torch.ones(3).add_(1)
    assert os.listdir(tmp_path) == []


def test_device_trace_writes_numbered_traces(tmp_path, monkeypatch):
    monkeypatch.delenv("ANN_SOLO_TORCH_TRACE_DIR", raising=False)
    trace_dir = tmp_path / "traces"
    for _ in range(2):
        with device_trace(str(trace_dir)):
            torch.ones(8).mul_(2.0).sum()
    assert sorted(os.listdir(trace_dir)) == ["trace_00000.json",
                                             "trace_00001.json"]
    trace = json.loads((trace_dir / "trace_00001.json").read_text())
    assert any("mul" in e.get("name", "") for e in trace["traceEvents"])
    monkeypatch.setenv("ANN_SOLO_TORCH_TRACE_DIR", str(trace_dir))
    with device_trace():
        torch.ones(2).sum()
    assert len(os.listdir(trace_dir)) == 3


def test_engine_lines_unchanged_by_the_trace(workdir, tmp_path, monkeypatch):
    """The CLI in ann mode (std level by window rescoring, open level by
    `ann_open_search_batch`) writes the same PSM lines with the trace on,
    one trace for each rescoring call."""
    settings = bf_profile.Settings(no_gpu=True)
    settings.index_dtype = "int8"  # the quality run's index files
    monkeypatch.delenv("ANN_SOLO_TORCH_TRACE_DIR", raising=False)
    lines = {}
    for name in ("off", "on"):
        if name == "on":
            monkeypatch.setenv("ANN_SOLO_TORCH_TRACE_DIR",
                               str(tmp_path / "traces"))
        out = str(tmp_path / f"{name}.mztab")
        assert torch_cli(quality._cli_args(
            str(workdir / "library.splib"), str(workdir / "queries.mgf"),
            out, "ann", settings)) == 0
        lines[name] = _psm_lines(out)
    assert lines["on"] == lines["off"]
    assert len(lines["on"]) > 0
    traces = os.listdir(tmp_path / "traces")
    assert len(traces) >= 4  # both levels, both charges
