"""The port's harnesses against the JAX package's: `bruteforce_search`,
`IvfIndex.search`, the QUALITY harness (`quality.main`, both legs and the
recall curve, and its corpus-fingerprint guard) and the SWEEP harness
(`sweep.main`, the spectrum and the Gaussian-vector modes).

The JAX package runs on the CPU (its engine on one device, as
`test_torch_engine_cli.py` runs it); the port with ``--no_gpu`` or
``device="cpu"``.  Both make their inputs from the same seeds.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ann_solo_tpu.search as jax_search
from ann_solo_tpu import quality as jax_quality
from ann_solo_tpu import sweep as jax_sweep
from ann_solo_tpu.index import ivf as jivf
from ann_solo_tpu_torch import quality, sweep
from ann_solo_tpu_torch.convert import ivf_index_from_numpy
from ann_solo_tpu_torch.index import ivf as pivf

from test_ivf import IvfConfig, _clustered_vectors


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's engine on the CPU runs many small torch ops; under a
    test runner with several workers their thread pools fight over the
    cores (a 3 s quality run took minutes), as in
    `test_torch_fdr_models.py`.  One thread per worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def jax_single_device(monkeypatch):
    monkeypatch.setattr(jax_search.SpectralLibrary, "_make_library_mesh",
                        staticmethod(lambda: None))


# --------------------------------------------------------------------- #
# bruteforce_search, IvfIndex.search


def _unit(rng, n, d):
    v = rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


@pytest.mark.parametrize("case", ["random", "ties", "k_over_n"])
def test_bruteforce_search_equals_jax(case):
    """The same ids as the JAX oracle: on random unit vectors over
    several row blocks, on exact small-integer data where most scores tie
    (ties to the lower row id, within and across blocks), and with k > n
    (k = n columns)."""
    rng = np.random.default_rng(17)
    if case == "random":
        lib, queries, k, block = _unit(rng, 3000, 64), _unit(rng, 40, 64), \
            50, 1024
    elif case == "ties":
        distinct = rng.integers(-2, 3, (6, 16)).astype(np.float32)
        lib = distinct[rng.integers(0, 6, 700)]
        queries = rng.integers(-2, 3, (30, 16)).astype(np.float32)
        k, block = 64, 128
    else:
        lib, queries, k, block = _unit(rng, 20, 32), _unit(rng, 9, 32), \
            32, 16384
    want = jivf.bruteforce_search(lib, queries, k, block=block)
    got = pivf.bruteforce_search(lib, queries, k, block=block, device="cpu")
    assert got.dtype == np.int32
    assert got.shape == want.shape == (len(queries), min(k, len(lib)))
    np.testing.assert_array_equal(got, want)


def test_bruteforce_search_needs_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pivf.bruteforce_search(np.eye(4, dtype=np.float32),
                               np.eye(4, dtype=np.float32), 2)


@pytest.mark.parametrize("window", [False, True])
def test_ivf_search_equals_jax(window):
    """`IvfIndex.search` / `search_with_scores` (NumPy in and out) on a
    JAX-built index carried over with `convert.py`: ids and scores equal
    the JAX `IvfIndex.search`'s, with and without a precursor window."""
    rng = np.random.default_rng(29)
    vectors = _clustered_vectors(rng, n=2000)
    prec = rng.uniform(400, 1200, len(vectors)).astype(np.float32)
    index = jivf.IvfIndex.build(jnp.asarray(vectors), IvfConfig(32, 4),
                                precursor_mz=prec)
    port = ivf_index_from_numpy(
        np.asarray(index.centroids), np.asarray(index.padded_vectors),
        np.asarray(index.padded_ids), np.asarray(index.padded_prec),
        np.asarray(index.padded_scales), index.num_probe, index.redundancy,
        "cpu")
    queries = vectors[rng.choice(len(vectors), 60, replace=False)]
    kwargs = {}
    if window:
        kwargs = dict(q_prec=rng.uniform(400, 1200, 60).astype(np.float32),
                      charge=2.0, tol_val=10.0, tol_mode="Da")
    want = index.search(queries, 20, num_probe=6, **kwargs)
    got = port.search(queries, 20, num_probe=6, **kwargs)
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, want)
    w_ids, w_scores = index.search_with_scores(queries, 20, **kwargs)
    g_ids, g_scores = port.search_with_scores(queries, 20, **kwargs)
    np.testing.assert_array_equal(g_ids, w_ids)
    np.testing.assert_array_equal(g_scores, w_scores)
    if window:
        assert (got == -1).any()  # the window excludes candidates


# --------------------------------------------------------------------- #
# quality


QUALITY_ARGS = ["--n-peptides", "320", "--n-queries", "100", "--seed",
                "5", "--num_probe", "16", "--num_candidates", "64",
                "--fdr", "0.05"]


def _without_seconds(results):
    return {key: ({k: v for k, v in value.items() if k != "search_seconds"}
                  if isinstance(value, dict) else value)
            for key, value in results.items()}


def test_quality_main_equals_jax(tmp_path, jax_single_device):
    """Both legs and the recall curve on a 320-peptide corpus: the
    results JSON equals the JAX `quality.main`'s but for the legs'
    `search_seconds`, and the files hold the same corpus."""
    out = {}
    for name, main, extra in (("jax", jax_quality.main, []),
                              ("torch", quality.main, ["--no_gpu"])):
        workdir = tmp_path / name
        assert main(QUALITY_ARGS + extra + [
            "--workdir", str(workdir),
            "--out", str(tmp_path / f"{name}.json")]) == 0
        out[name] = json.loads((tmp_path / f"{name}.json").read_text())
        assert (workdir / "truth.json").is_file()
    got, want = out["torch"], out["jax"]
    assert set(got) == set(want)
    assert set(got["bf"]) == set(want["bf"])
    assert _without_seconds(got) == _without_seconds(want)
    assert got["bf"]["n_confident"] > 0
    assert got["ann_candidate_recall"]["n_bf_ssms_checked"] == \
        got["bf"]["n_confident"]
    assert (tmp_path / "torch" / "corpus_fp.txt").read_text() == \
        (tmp_path / "jax" / "corpus_fp.txt").read_text()


def test_quality_reuse_corpus_and_bf(tmp_path, jax_single_device):
    """--reuse-corpus reads library, queries and truth from the workdir;
    --reuse-bf keeps bf.mztab: the statistics of the fresh run, the bf leg
    marked reused and unmeasured."""
    args = QUALITY_ARGS + ["--workdir", str(tmp_path / "w"), "--no_gpu"]
    assert quality.main(args + ["--out", str(tmp_path / "a.json")]) == 0
    assert quality.main(args + ["--reuse-corpus", "--reuse-bf", "--out",
                                str(tmp_path / "b.json")]) == 0
    a = json.loads((tmp_path / "a.json").read_text())
    b = json.loads((tmp_path / "b.json").read_text())
    assert b["bf"].pop("reused_bf_mztab") is True
    assert b["bf"]["search_seconds"] is None
    assert _without_seconds(a) == _without_seconds(b)


def _guard_run(workdir, out, n_peptides, extra=()):
    """`tests/test_quality_guard.py::_run`, on the CPU."""
    return quality.main([
        "--workdir", str(workdir), "--out", str(out),
        "--n-peptides", str(n_peptides), "--n-queries", "30", "--skip-bf",
        "--no_gpu", *extra,
    ])


def test_reuse_bf_refuses_changed_corpus(tmp_path):
    workdir = tmp_path / "wd"
    assert _guard_run(workdir, tmp_path / "q1.json", 64) == 0
    fp1 = (workdir / "corpus_fp.txt").read_text().strip()
    assert fp1
    (workdir / "bf.mztab").write_text("MTD\tdummy\n")
    # Same parameters: the fingerprint matches, the run goes on.
    assert _guard_run(workdir, tmp_path / "q2.json", 64,
                      ("--reuse-bf",)) == 0
    assert (workdir / "corpus_fp.txt").read_text().strip() == fp1
    # Other corpus parameters: the guard refuses, the fingerprint stays.
    with pytest.raises(SystemExit):
        _guard_run(workdir, tmp_path / "q3.json", 96, ("--reuse-bf",))
    assert (workdir / "corpus_fp.txt").read_text().strip() == fp1


def test_corpus_fp_written_on_fresh_run(tmp_path):
    workdir = tmp_path / "wd2"
    assert _guard_run(workdir, tmp_path / "q.json", 64) == 0
    assert (workdir / "corpus_fp.txt").is_file()


def test_quality_needs_cuda_without_no_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        quality.main(["--workdir", str(tmp_path), "--out",
                      str(tmp_path / "q.json"), "--n-peptides", "64",
                      "--n-queries", "30", "--skip-bf"])


# --------------------------------------------------------------------- #
# sweep


def test_spectrum_sweep_equals_jax(tmp_path, jax_single_device):
    """`tests/test_sweep.py`'s inputs: the bf ceiling and every grid
    point's IDs, accuracy and ratio to bf equal the JAX sweep's."""
    args = ["--spectrum", "--n-peptides", "60", "--n-queries", "40",
            "--num-list", "8", "--num-probe", "2", "4",
            "--num_candidates", "16", "--fdr", "0.05", "--seed", "3"]
    out = {}
    for name, main, extra in (("jax", jax_sweep.main, []),
                              ("torch", sweep.main, ["--no_gpu"])):
        assert main(args + extra + [
            "--workdir", str(tmp_path / name),
            "--out", str(tmp_path / f"{name}.json")]) == 0
        out[name] = json.loads((tmp_path / f"{name}.json").read_text())
    got, want = out["torch"], out["jax"]
    assert got["corpus"] == want["corpus"]
    assert got["config"] == want["config"]
    assert _without_seconds({"bf": got["bf_ceiling"]}) == \
        _without_seconds({"bf": want["bf_ceiling"]})
    assert got["bf_ceiling"]["n_confident"] > 0
    assert len(got["grid"]) == len(want["grid"]) == 2
    for g, w in zip(got["grid"], want["grid"]):
        for key in ("num_list", "num_probe", "scan_fraction", "ids_at_fdr",
                    "accuracy", "ids_vs_bf_ratio"):
            assert g[key] == w[key], key
    assert (tmp_path / "torch" / "ann_8_4.mztab").is_file()


def test_gaussian_sweep_equals_jax(tmp_path):
    """The default mode at n = 4,096 unit Gaussian vectors: the same
    corpus, and every recall@k of every grid point equal to the JAX
    sweep's (both build the index from the same k-means, bit for bit on
    the CPU)."""
    args = ["--n", "4096", "--n-queries", "64", "--num-list", "64", "128",
            "--num-probe", "4", "16", "--k", "64", "--seed", "11"]
    out = {}
    for name, main, extra in (("jax", jax_sweep.main, []),
                              ("torch", sweep.main, ["--no_gpu"])):
        assert main(args + extra + [
            "--out", str(tmp_path / f"{name}.json")]) == 0
        out[name] = json.loads((tmp_path / f"{name}.json").read_text())
    got, want = out["torch"], out["jax"]
    assert got["corpus"] == want["corpus"]
    assert len(got["grid"]) == len(want["grid"]) == 4
    for g, w in zip(got["grid"], want["grid"]):
        recalls = {k: v for k, v in w.items() if k.startswith("recall@")}
        assert sorted(recalls) == sorted(k for k in g if
                                         k.startswith("recall@"))
        for key, value in recalls.items():
            assert g[key] == value, (g["num_list"], g["num_probe"], key)
    # More probes never lose recall at a fixed num_list.
    for a, b in zip(got["grid"][::2], got["grid"][1::2]):
        assert b["recall@64"] >= a["recall@64"]
