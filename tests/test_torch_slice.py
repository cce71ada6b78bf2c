"""The whole PyTorch open-search slice vs the JAX `bench.py` path.

Same NumPy-made library and queries (the bench's synthetic generator at a
4,096-spectrum library, K = 50 peaks, hash_len 800, int8 x2 SOAR IVF with
auto num_list and num_probe 512, charge 2, +-500 Da, fragment tolerance
0.04).  Each package builds its own index from its own vectors; best ids
must agree on >= 99% of queries, and the peak matches of agreeing best
pairs must be the same sets.  An import guard runs the slice, the streaming
build and the native readers in a process where jax, ml_dtypes, sklearn,
pandas and h5py cannot be imported.
"""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import torch

from ann_solo_tpu.index.ivf import IvfIndex as JaxIvfIndex
from ann_solo_tpu.models.vectorize import (
    VectorizeParams as JaxVectorizeParams,
    vectorize_batch as jax_vectorize,
)
from ann_solo_tpu.ops.rescore import rescore_candidate_matrix as jax_rescore
from ann_solo_tpu.ops.shifted_dot import shifted_dot_best_match
from ann_solo_tpu_torch.convert import library_from_numpy
from ann_solo_tpu_torch.index.ivf import IvfIndex
from ann_solo_tpu_torch.models.vectorize import (
    VectorizeParams,
    device_tables,
    vectorize_batch,
)
from ann_solo_tpu_torch.search import OpenSearchParams, ann_open_search_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_LIB, N_Q, K, HASH_LEN, CHARGE = 4096, 128, 50, 800, 2
FRAG_TOL, OPEN_TOL, N_CAND, BIN_SIZE = 0.04, 500.0, 512, 0.04


class BenchConfig:
    num_list = 0
    num_probe = 512
    ivf_redundancy = 2

    def __getitem__(self, key):
        return getattr(self, key)


def _synth(rng, n):
    """bench.py's `synth_processed`."""
    mz = np.sort(rng.uniform(101.0, 1500.0, (n, K)).astype(np.float32), 1)
    intensity = rng.uniform(0.1, 1.0, (n, K)).astype(np.float32)
    intensity /= np.linalg.norm(intensity, axis=1, keepdims=True)
    ann = rng.integers(0, CHARGE + 1, (n, K)).astype(np.int32)
    prec = rng.uniform(400.0, 1200.0, n).astype(np.float64)
    order = np.argsort(prec, kind="stable")
    return mz[order], intensity[order], ann[order], prec[order]


def _queries(rng, lib_mz, lib_int, lib_prec):
    rows = rng.choice(N_LIB, N_Q, replace=False)
    q_mz = lib_mz[rows] + rng.normal(0, 0.005, (N_Q, K)).astype(np.float32)
    q_int = np.abs(
        lib_int[rows] + rng.normal(0, 0.02, (N_Q, K)).astype(np.float32)
    )
    q_int /= np.linalg.norm(q_int, axis=1, keepdims=True)
    q_prec = lib_prec[rows] + rng.normal(0, 0.002, N_Q)
    return rows, np.sort(q_mz, axis=1), q_int, q_prec


def test_slice_matches_jax_bench_path():
    rng = np.random.default_rng(42)
    lib_mz, lib_int, lib_ann, lib_prec = _synth(rng, N_LIB)
    rows, q_mz, q_int, q_prec = _queries(rng, lib_mz, lib_int, lib_prec)
    lib_n = np.full(N_LIB, K, np.int32)
    q_n = np.full(N_Q, K, np.int32)
    prec32 = lib_prec.astype(np.float32)

    # JAX: bench.py's run_batch (vectorize -> select -> rescore).
    jparams = JaxVectorizeParams(11.0, 2010.0, BIN_SIZE, HASH_LEN)
    jtables = jparams.device_tables()
    jindex = JaxIvfIndex.build(
        jax_vectorize(jparams, jtables, lib_mz, lib_int, lib_n),
        BenchConfig(), precursor_mz=prec32, storage_dtype=np.int8,
    )
    cand, _ = jindex.search_device(
        jax_vectorize(jparams, jtables, q_mz, q_int, q_n), N_CAND,
        q_prec=q_prec.astype(np.float32), charge=float(CHARGE),
        tol_val=OPEN_TOL, tol_mode="Da",
    )
    exp_idx, exp_score, exp_n = jax_rescore(
        jnp.asarray(q_mz), jnp.asarray(q_int),
        jnp.asarray(q_prec, jnp.float32),
        jnp.asarray(lib_mz), jnp.asarray(lib_int), jnp.asarray(lib_ann),
        jnp.asarray(prec32), cand, FRAG_TOL, CHARGE + 1, True, False,
    )

    # The port, on the CPU: its own vectors, index and search.
    params = VectorizeParams(11.0, 2010.0, BIN_SIZE, HASH_LEN)
    lib_vectors = vectorize_batch(
        params, device_tables(params, "cpu"), torch.from_numpy(lib_mz),
        torch.from_numpy(lib_int), torch.from_numpy(lib_n),
    )
    index = IvfIndex.build(
        lib_vectors, BenchConfig(), precursor_mz=prec32,
        storage_dtype=torch.int8, device="cpu",
    )
    assert index.num_list == jindex.num_list == 1024
    lib = library_from_numpy(lib_mz, lib_int, lib_ann, lib_prec, "cpu")
    got_idx, got_score, got_n, matches = ann_open_search_batch(
        index, lib, q_mz, q_int, q_n, q_prec, CHARGE,
        OpenSearchParams(
            vectorize=params, num_candidates=N_CAND,
            precursor_tolerance_mass_open=OPEN_TOL,
            fragment_mz_tolerance=FRAG_TOL,
        ),
    )
    assert got_idx.shape == got_score.shape == (N_Q,)
    same = got_idx == exp_idx
    assert same.mean() >= 0.99
    np.testing.assert_allclose(got_score[same], exp_score[same], rtol=1e-5)
    assert np.mean(got_idx == rows) >= 0.95  # the bench's self-match gate
    assert np.all(np.abs(got_n - exp_n) <= 0.01 * N_CAND)

    # Peak matches of the best pairs vs the JAX greedy on the same pairs.
    hit = np.nonzero(got_idx >= 0)[0]
    c = got_idx[hit]
    _, exp_q, exp_c = shifted_dot_best_match(
        q_mz[hit], q_int[hit], lib_mz[c], lib_int[c], lib_ann[c],
        q_prec[hit].astype(np.float32), prec32[c],
        np.full(len(hit), CHARGE, np.int32), FRAG_TOL, CHARGE + 1, True,
    )
    exp_q, exp_c = np.asarray(exp_q), np.asarray(exp_c)
    for j, row in enumerate(hit):
        got = {tuple(m) for m in matches[int(row)].tolist()}
        exp = {(int(a), int(b)) for a, b in zip(exp_q[j], exp_c[j]) if a >= 0}
        assert got == exp, f"query {row}"


GUARD = textwrap.dedent("""
    import sys
    for name in ("jax", "jaxlib", "ml_dtypes", "sklearn", "pandas", "h5py"):
        sys.modules[name] = None  # any import of these now fails
    import pkgutil
    import numpy as np
    import torch
    import ann_solo_tpu_torch
    for mod in pkgutil.walk_packages(ann_solo_tpu_torch.__path__,
                                     "ann_solo_tpu_torch."):
        __import__(mod.name)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    from ann_solo_tpu_torch.convert import library_from_numpy
    from ann_solo_tpu_torch.index.ivf import IvfIndex
    from ann_solo_tpu_torch.models.preprocess import (
        PreprocessParams, preprocess_batch)
    from ann_solo_tpu_torch.models.vectorize import (
        VectorizeParams, device_tables, vectorize_batch)
    from ann_solo_tpu_torch.search import (
        OpenSearchParams, ann_open_search_batch)

    rng = np.random.default_rng(0)
    n, k = 512, 16
    mz = np.sort(rng.uniform(101, 1500, (n, k)).astype(np.float32), 1)
    inten = rng.uniform(0.1, 1, (n, k)).astype(np.float32)
    ann = rng.integers(0, 3, (n, k)).astype(np.int32)
    prec = np.sort(rng.uniform(400, 1200, n)).astype(np.float32)
    vp = VectorizeParams(hash_len=64)
    vec = vectorize_batch(vp, device_tables(vp, "cpu"), torch.from_numpy(mz),
                          torch.from_numpy(inten), torch.full((n,), k))
    class Cfg:
        num_list = 32
        num_probe = 8
    index = IvfIndex.build(vec, Cfg(), precursor_mz=prec,
                           storage_dtype=torch.int8, device="cpu")
    lib = library_from_numpy(mz, inten, ann, prec, "cpu")
    raw = preprocess_batch(
        PreprocessParams(max_peaks_used=k, min_peaks=5),
        torch.from_numpy(mz[:64]), torch.from_numpy(inten[:64]),
        torch.from_numpy(ann[:64]), torch.full((64,), k),
        torch.from_numpy(prec[:64]), torch.full((64,), 2))
    best, score, n_c, matches = ann_open_search_batch(
        index, lib, raw.mz, raw.intensity, raw.n_peaks, prec[:64], 2,
        OpenSearchParams(vectorize=vp, num_candidates=32))
    assert best.shape == (64,) and (best >= 0).all()
    assert np.isfinite(score).all() and len(matches) == 64
    # The chunked regimes: kernel B3's plain version with its selection,
    # and the plain chunked scan (probe path switched off).
    from ann_solo_tpu_torch.index import ivf
    from ann_solo_tpu_torch.ops import ivf_probe, ivf_scan, ivf_scan_cuda
    assert ivf_scan_cuda.LAUNCHES == 0
    blk = IvfIndex(torch.zeros(8, 64), torch.ones(8, 128, 64,
                   dtype=torch.int8), torch.arange(8 * 128).view(8, 128),
                   4, torch.zeros(8, 128), torch.ones(8, 128))
    q = torch.from_numpy(rng.normal(size=(4, 64)).astype(np.float32))
    s, pos, flags = ivf_scan.ivf_chunked_scan_select(
        *blk._blocks()[:4], q, torch.zeros(4), 1.0,
        torch.tensor([[0, 5]] * 4), 2, 16, 0.0, "Da")
    assert s.shape == pos.shape == (4, 16) and flags.shape == (4,)
    ivf._FULLSCAN_TRANSIENT = 0
    ivf_probe.MAX_PROBE_LANES = 0
    ids, _ = index.search_device(vec[:8], 4)
    assert ids.shape == (8, 4) and (ids >= 0).all()
    # The streaming build gives the in-memory build's index.
    streamed = IvfIndex.build_streaming(
        lambda idx: vec[idx.clamp(0, n - 1)], n, 64, Cfg(),
        precursor_mz=prec, storage_dtype=torch.int8, device="cpu")
    for name in ("centroids", "padded_ids", "padded_vectors",
                 "padded_scales", "padded_prec"):
        assert torch.equal(getattr(streamed, name), getattr(index, name))
    # The native readers build and read each library format.
    import os
    import tempfile
    from ann_solo_tpu_torch.io import mgf, reader, splib
    from ann_solo_tpu_torch.synthdata import make_corpus
    from ann_solo_tpu_torch.utils.profiling import profiler
    corpus, _, _ = make_corpus(rng, 30, 10)
    with tempfile.TemporaryDirectory() as tmp:
        for ext, write in ((".splib", splib.write_splib),
                           (".sptxt", splib.write_sptxt),
                           (".mgf", mgf.write_mgf)):
            path = os.path.join(tmp, "lib" + ext)
            write(corpus, path)
            assert len(list(reader.read_library_file(path))) == 30
            assert profiler.notes["library reader"] == "native", ext
    assert sys.modules["jax"] is None
    print("guard ok", float((best == np.arange(64)).mean()))
""")


def test_import_guard_slice_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", GUARD], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "guard ok" in proc.stdout


GUARD_CLI = textwrap.dedent("""
    import sys
    for name in ("jax", "jaxlib", "ml_dtypes", "sklearn", "pandas", "h5py"):
        sys.modules[name] = None  # any import of these now fails
    import os
    import tempfile
    import numpy as np
    from ann_solo_tpu_torch.cli import main
    from ann_solo_tpu_torch.io.mgf import write_mgf
    from ann_solo_tpu_torch.io.splib import write_splib
    from ann_solo_tpu_torch.synthdata import make_corpus

    tmp = tempfile.mkdtemp()
    library, queries, truth = make_corpus(np.random.default_rng(3), 40, 30)
    write_splib(library, os.path.join(tmp, "lib.splib"))
    write_mgf(queries, os.path.join(tmp, "q.mgf"))
    out = os.path.join(tmp, "out.mztab")
    assert main([
        os.path.join(tmp, "lib.splib"), os.path.join(tmp, "q.mgf"), out,
        "--precursor_tolerance_mass", "20",
        "--precursor_tolerance_mode", "ppm",
        "--precursor_tolerance_mass_open", "300",
        "--precursor_tolerance_mode_open", "Da",
        "--fragment_mz_tolerance", "0.02", "--allow_peak_shifts",
        "--min_mz_range", "200", "--min_peaks", "5", "--model", "none",
        "--mode", "ann", "--num_list", "8", "--num_probe", "4",
        "--num_candidates", "16", "--fdr", "0.05", "--add_decoys",
        "--no_gpu",
    ]) == 0
    psm = [line.split("\\t") for line in open(out) if line.startswith("PSM")]
    correct = sum(truth[row[2]] == row[1] for row in psm)
    assert len(psm) >= 25 and correct >= 20, (len(psm), correct)
    # The run wrote the store and index files; a second run, with the
    # linear SVM, reads them back.
    from ann_solo_tpu_torch.utils.profiling import profiler
    assert profiler.notes["store"]["source"] == "built"
    assert sum(n.endswith(".store.npz") for n in os.listdir(tmp)) == 1
    assert sum(n.endswith(".ivf.npz") for n in os.listdir(tmp)) >= 1
    out_svm = os.path.join(tmp, "svm.mztab")
    assert main([
        os.path.join(tmp, "lib.splib"), os.path.join(tmp, "q.mgf"), out_svm,
        "--precursor_tolerance_mass", "20",
        "--precursor_tolerance_mode", "ppm",
        "--precursor_tolerance_mass_open", "300",
        "--precursor_tolerance_mode_open", "Da",
        "--fragment_mz_tolerance", "0.02", "--allow_peak_shifts",
        "--min_mz_range", "200", "--min_peaks", "5", "--model", "svm",
        "--mode", "ann", "--num_list", "8", "--num_probe", "4",
        "--num_candidates", "16", "--fdr", "0.05", "--add_decoys",
        "--no_gpu",
    ]) == 0
    assert profiler.notes["store"]["source"] == "loaded"
    assert "library read" not in profiler.totals
    assert profiler.totals["std FDR model"] > 0
    svm = [line.split("\\t") for line in open(out_svm)
           if line.startswith("PSM")]
    assert {row[2] for row in svm} == {row[2] for row in psm}
    # The post-search tools read the result without pandas.
    from ann_solo_tpu_torch import quality, sweep  # noqa: F401
    from ann_solo_tpu_torch.eval import ssm_stats
    from ann_solo_tpu_torch.io.mztab import read_mztab_ssms
    from ann_solo_tpu_torch.plot import ssm_matches
    assert ssm_stats(read_mztab_ssms(out), 0.05)["n_ssms"] == len(psm)
    target = next(row[2] for row in psm if row[21].strip() == "0")
    (match,) = ssm_matches(out, [target], device="cpu")
    assert len(match.peak_matches) > 0
    for name in ("jax", "sklearn", "pandas", "h5py"):
        assert sys.modules[name] is None
    print("cli guard ok", len(psm), correct)
""")


def test_import_guard_cli_search_runs_without_jax():
    """The CLI imports and searches to a written mzTab with jax, jaxlib,
    ml_dtypes, sklearn, pandas and h5py unimportable: a first run that
    writes the store and index files, a second with ``--model svm`` that
    reads them; then `eval` and `plot` read the result."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", GUARD_CLI], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "cli guard ok" in proc.stdout
