"""The port's `bench` and `scale_demo` against the repo's root scripts.

`bench.py` and `scale_demo.py` are imported by path and run on the CPU at
small sizes (their constants or command lines cut down); the port runs
the same sizes with ``device="cpu"`` / ``--no_gpu`` from the same seeds.
The bench's synthetic library and query batches must be equal bit for
bit, its JSON line must carry the script's keys less the TPU-only ones,
and the statistics that do not depend on the k-means' float rounding
must be equal; the two hit rates agree within one query.  `make_gen_rows`
is held to the JAX generator at 1e-6 (`log` and `cos` differ in the last
ulps between XLA and PyTorch) and to itself in two fetch orders.
"""

import importlib.util
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ann_solo_tpu.ops.rescore as jax_rescore
import ann_solo_tpu.utils.jax_cache as jax_cache
from ann_solo_tpu_torch import bench, scale_demo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPU_ONLY_KEYS = {"mxu_mfu_estimate", "warmup_compile_sec",
                 "compile_stall_detected"}


def _script(name):
    """A root script of the repo as a module (imported by path)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(REPO, f"{name}.py"))
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


def _last_json_line(text):
    return json.loads(text.strip().splitlines()[-1])


def test_bench_equals_jax(monkeypatch, capsys):
    jax_bench = _script("bench")
    sizes = {"N_LIBRARY": 4096, "N_QUERIES": 256, "N_BATCHES": 2,
             "NUM_PROBE": 16}
    for name, value in sizes.items():
        monkeypatch.setattr(jax_bench, name, value)
    # Nothing written outside the test's directories.
    monkeypatch.setattr(jax_cache, "enable_persistent_cache", lambda: None)
    calls = []
    real = jax_rescore.rescore_candidate_matrix

    def recording(q_mz, q_int, q_prec, lib_mz, lib_int, lib_ann, lib_prec,
                  *args):
        calls.append([np.asarray(a) for a in (
            q_mz, q_int, q_prec, lib_mz, lib_int, lib_ann, lib_prec)])
        return real(q_mz, q_int, q_prec, lib_mz, lib_int, lib_ann, lib_prec,
                    *args)

    monkeypatch.setattr(jax_rescore, "rescore_candidate_matrix", recording)
    jax_bench.main()
    want = _last_json_line(capsys.readouterr().out)

    out = bench.run(n_library=4096, n_queries=256, n_batches=2,
                    num_probe=16, device="cpu")
    got = out["result"]

    # The same library and query batches, bit for bit.
    lib_mz, lib_int, lib_ann, lib_prec = out["lib_arrays"]
    for got_arr, want_arr in zip(
            (lib_mz, lib_int, lib_ann, lib_prec.astype(np.float32)),
            calls[-1][3:]):
        np.testing.assert_array_equal(got_arr, want_arr)
    seen = {tuple(a.tobytes() for a in call[:3]) for call in calls}
    for _, q_mz, q_int, q_prec in out["batches"]:
        assert (q_mz.tobytes(), q_int.tobytes(),
                q_prec.astype(np.float32).tobytes()) in seen

    assert set(got) == set(want) - TPU_ONLY_KEYS
    for key in ("num_list", "index_dtype", "num_candidates",
                "ref_default_num_candidates", "hit_rate_gate",
                "hit_rate_gate_passed"):
        assert got[key] == want[key], key
    assert round(got["index_bytes_per_vector"], 1) == \
        want["index_bytes_per_vector"]
    assert set(got["stages_sec_per_batch"]) == \
        set(want["stages_sec_per_batch"])
    # The JAX line rounds hit rates to 3 decimals.
    for key in ("self_match_hit_rate", "ref_default_self_match_hit_rate"):
        assert abs(got[key] - want[key]) <= 1.0 / 256 + 5e-4, key
    assert got["metric"].startswith(
        "iPRG2012-scale open-search throughput on cpu")


def test_gen_rows_equals_jax():
    jax_scale = _script("scale_demo")
    n = 1 << 20
    rows = np.concatenate([[0, 1, n - 1],
                           np.random.default_rng(3).integers(0, n, 61)])
    want = np.asarray(jax_scale.make_gen_rows(n)(
        jnp.asarray(rows, jnp.int32)))
    gen = scale_demo.make_gen_rows(n, torch.device("cpu"))
    got = gen(torch.from_numpy(rows)).numpy()
    assert got.shape == want.shape == (len(rows), scale_demo.D)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)
    # Clamped like the JAX generator.
    np.testing.assert_array_equal(
        gen(torch.tensor([-1, n, n + 5])).numpy(),
        gen(torch.tensor([0, n - 1, n - 1])).numpy())


def test_gen_rows_independent_of_fetch_order():
    gen = scale_demo.make_gen_rows(5000, torch.device("cpu"))
    rows = torch.from_numpy(
        np.random.default_rng(4).permutation(5000)[:700])
    order = torch.randperm(len(rows), generator=torch.Generator().manual_seed(
        5))
    one = gen(rows)
    other = torch.empty_like(one)
    other[order] = gen(rows[order])
    assert torch.equal(one, other)
    assert torch.equal(gen(rows[:1]), one[:1])


def test_scale_demo_default_equals_jax(tmp_path, monkeypatch, capsys):
    args = ["--n", "16384", "--num-list", "64", "--num-probe", "8",
            "--n-queries", "64"]
    jax_scale = _script("scale_demo")
    monkeypatch.setattr(sys, "argv", ["scale_demo.py", *args, "--out",
                                      str(tmp_path / "jax.json")])
    assert jax_scale.main() == 0
    assert scale_demo.main(args + ["--out", str(tmp_path / "torch.json"),
                                   "--no_gpu"]) == 0
    printed = _last_json_line(capsys.readouterr().out)
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "torch.json").read_text())
    assert printed == got
    assert set(got) == set(want)
    for key in ("num_list", "n_vectors", "dims", "num_probe", "redundancy",
                "streaming_build", "certificate_repairs_per_batch"):
        assert got[key] == want[key], key
    assert round(got["index_bytes_per_vector"], 1) == \
        want["index_bytes_per_vector"]
    assert abs(got["source_in_top_candidates"]
               - want["source_in_top_candidates"]) <= 1.0 / 64
    assert got["extrapolation"]["per_chip_int8_capacity_vectors"] is None


@pytest.mark.parametrize("extra", [["--streaming"], ["--sharded-gpu"],
                                   ["--sharded", "--multislice"]])
def test_scale_demo_modes_on_the_cpu(tmp_path, extra):
    """The other points run on the CPU and find each query's source."""
    out = tmp_path / "scale.json"
    assert scale_demo.main(["--n", "8192", "--num-list", "64",
                            "--num-probe", "8", "--n-queries", "32",
                            "--out", str(out), "--no_gpu", *extra]) == 0
    result = json.loads(out.read_text())
    assert result["n_vectors"] == 8192
    assert result["source_in_top_candidates"] >= 0.95
    if "--sharded" in extra:
        assert result["lib_shards"] == 8
        assert result["per_shard_block_bytes"] * 8 == \
            result["global_block_bytes"]


def test_entry_points_need_cuda_unless_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.run(n_library=64, n_queries=16, n_batches=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        scale_demo.main(["--n", "64", "--out", str(tmp_path / "s.json")])
