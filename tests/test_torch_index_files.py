"""The port's IVF index files (`IvfIndex.save`, `load`, `load_or_build`,
`ivf_index_filename`) on the CPU.

A saved and loaded index searches exactly like the one in memory (int8,
bf16 and f32 storage).  An index the JAX package built and saved to its
``.ivf.h5`` is read here with h5py, carried through `convert.py`, saved and
loaded by the port, and must return the JAX search's (ids, scores) under
`test_torch_ivf.py`'s tolerance (>= 99.9% of lanes equal, any other score
one bf16 key step away).  The fingerprint rule is the JAX package's strict
one, case for case with `tests/test_staleness.py`.
"""

import itertools
import os

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ann_solo_tpu.index import ivf as jivf
from ann_solo_tpu.ops.ivf_scan_pallas import _key16 as jax_key16
from ann_solo_tpu_torch.convert import ivf_index_from_numpy, to_numpy
from ann_solo_tpu_torch.index import ivf as pivf

from test_ivf import IvfConfig, _clustered_vectors

_STORAGE = {"int8": torch.int8, "bf16": torch.bfloat16, "f32": torch.float32}


def _queries(rng, vectors, prec, n_q=128):
    queries = vectors[rng.choice(len(vectors), n_q, replace=False)]
    queries = queries + 0.05 * rng.normal(size=queries.shape).astype(
        np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    q_prec = prec[rng.choice(len(vectors), n_q)] + rng.normal(
        0, 5, n_q).astype(np.float32)
    return queries.astype(np.float32), q_prec.astype(np.float32)


@pytest.mark.parametrize("storage", ["int8", "bf16", "f32"])
def test_saved_and_loaded_index_searches_identically(tmp_path, storage):
    rng = np.random.default_rng(17)
    vectors = _clustered_vectors(rng, n=2000, d=48, n_clusters=16)
    prec = rng.uniform(400, 1200, 2000).astype(np.float32)
    index = pivf.IvfIndex.build(
        torch.from_numpy(vectors), IvfConfig(num_list=32, num_probe=6),
        precursor_mz=prec, storage_dtype=_STORAGE[storage], redundancy=2,
        device="cpu",
    )
    index.store_fp = "1234:abcd"
    path = str(tmp_path / f"c2_{storage}.ivf.npz")
    index.save(path)
    assert os.listdir(tmp_path) == [os.path.basename(path)]  # no temp file
    loaded = pivf.IvfIndex.load(path, 6, "cpu")
    assert loaded.store_fp == "1234:abcd"
    assert loaded.redundancy == index.redundancy == 2
    assert loaded.num_probe == index.num_probe
    for name in ("centroids", "padded_vectors", "padded_ids", "padded_prec",
                 "padded_scales"):
        a, b = getattr(loaded, name), getattr(index, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name
    queries, q_prec = _queries(rng, vectors, prec)
    kwargs = dict(q_prec=torch.from_numpy(q_prec), charge=2.0,
                  tol_val=300.0, tol_mode="Da")
    want = index.search_device(torch.from_numpy(queries), 40, **kwargs)
    got = loaded.search_device(torch.from_numpy(queries), 40, **kwargs)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    # The file holds plain arrays only: it loads without pickle.
    with np.load(path, allow_pickle=False) as f:
        assert ("padded_vectors_bf16" in f) == (storage == "bf16")


@pytest.mark.parametrize("storage", ["int8", "bf16"])
def test_jax_index_file_through_convert_and_the_ports_files(tmp_path,
                                                            storage):
    import ml_dtypes

    jstorage = {"int8": np.int8, "bf16": ml_dtypes.bfloat16}[storage]
    rng = np.random.default_rng(41)
    vectors = _clustered_vectors(rng, n=3000, d=48, n_clusters=16)
    prec = rng.uniform(400, 1200, 3000).astype(np.float32)
    jindex = jivf.IvfIndex.build(
        vectors, IvfConfig(num_list=32, num_probe=6), precursor_mz=prec,
        storage_dtype=jstorage, redundancy=2,
    )
    jindex.store_fp = "77:feed"
    h5_path = str(tmp_path / "c2.ivf.h5")
    jindex.save(h5_path)
    with h5py.File(h5_path, "r") as f:
        if "padded_vectors_bf16" in f:
            stored = f["padded_vectors_bf16"][()].view(ml_dtypes.bfloat16)
        else:
            stored = f["padded_vectors"][()]
        port = ivf_index_from_numpy(
            f["centroids"][()], stored, f["padded_ids"][()],
            f["padded_prec"][()], f["padded_scales"][()], 6,
            int(f.attrs["redundancy"]), "cpu", store_fp=f.attrs["store_fp"],
        )
    assert to_numpy(port)["store_fp"] == "77:feed"
    path = str(tmp_path / "c2.ivf.npz")
    port.save(path)
    loaded = pivf.IvfIndex.load(path, 6, "cpu")
    assert loaded.store_fp == "77:feed"
    queries, q_prec = _queries(rng, vectors, prec, 256)
    k = 40
    e_ids, e_s = jindex.search_device(
        queries, k, q_prec=q_prec, charge=2.0, tol_val=300.0, tol_mode="Da")
    e_ids, e_s = np.asarray(e_ids), np.asarray(e_s)
    g_ids, g_s = loaded.search_device(
        torch.from_numpy(queries), k, q_prec=torch.from_numpy(q_prec),
        charge=2.0, tol_val=300.0, tol_mode="Da")
    g_ids, g_s = g_ids.numpy(), g_s.numpy()
    assert ((g_ids == e_ids) & (g_s == e_s)).mean() >= 0.999
    gk = pivf._key16(torch.from_numpy(g_s)).numpy()
    ek = np.asarray(jax_key16(jnp.asarray(e_s)))
    assert np.all(np.abs(gk - ek) <= 1)


class _Lib:
    """A charge block on the host (`tests/test_staleness.py`'s)."""

    def __init__(self, rng):
        self.mz = np.sort(
            rng.uniform(100, 1500, (64, 8)).astype(np.float32), 1)
        self.intensity = np.abs(rng.standard_normal((64, 8))).astype(
            np.float32)
        self.n_peaks = np.full(64, 8, np.int32)
        self.precursor_mz = rng.uniform(400, 1200, 64).astype(np.float64)
        self.n_spectra = 64


class _Cfg:
    num_list = 4
    num_probe = 2
    index_dtype = "bf16"
    ivf_redundancy = 1
    min_mz, max_mz, bin_size, hash_len = 11.0, 2010.0, 0.04, 32
    scaling = "rank"

    def __getitem__(self, key):
        return getattr(self, key)


def _strip_fingerprint(path):
    with np.load(path, allow_pickle=False) as f:
        arrays = {name: f[name] for name in f.files if name != "store_fp"}
    np.savez(path, **arrays)


def test_index_rebuilds_on_store_fingerprint_change(tmp_path, caplog):
    """The six cases of `tests/test_staleness.py::
    test_ivf_rebuilds_on_store_fp_change`, and an unreadable file."""
    lib, cfg = _Lib(np.random.default_rng(3)), _Cfg()
    path = str(tmp_path / "c2.ivf.npz")
    stages = {}
    idx1 = pivf.IvfIndex.load_or_build(path, lib, cfg, store_fp="fp_A",
                                       device="cpu", stage_seconds=stages)
    assert idx1.store_fp == "fp_A"  # 1: built and stamped
    assert set(stages) == {"index build", "index write"}

    stages = {}
    idx2 = pivf.IvfIndex.load_or_build(path, lib, cfg, store_fp="fp_A",
                                       device="cpu", stage_seconds=stages)
    assert set(stages) == {"index load"}  # 2: same fingerprint, loaded
    assert torch.equal(idx1.padded_ids, idx2.padded_ids)
    assert torch.equal(idx1.padded_vectors, idx2.padded_vectors)

    with caplog.at_level("WARNING"):
        stages = {}
        idx3 = pivf.IvfIndex.load_or_build(path, lib, cfg, store_fp="fp_B",
                                           device="cpu", stage_seconds=stages)
    assert idx3.store_fp == "fp_B"  # 3: changed fingerprint, rebuilt
    assert "index build" in stages and "index load" not in stages
    assert "different store content (fp_A != fp_B)" in caplog.text
    assert pivf.IvfIndex.load(path, 2, "cpu").store_fp == "fp_B"  # 4

    _strip_fingerprint(path)  # 5: a file without any: rebuilt (strict)
    assert pivf.IvfIndex.load(path, 2, "cpu").store_fp is None
    stages = {}
    idx5 = pivf.IvfIndex.load_or_build(path, lib, cfg, store_fp="fp_C",
                                       device="cpu", stage_seconds=stages)
    assert idx5.store_fp == "fp_C" and "index build" in stages

    _strip_fingerprint(path)  # 6: no expected fingerprint: accepted as is
    stages = {}
    idx6 = pivf.IvfIndex.load_or_build(path, lib, cfg, device="cpu",
                                       stage_seconds=stages)
    assert idx6.store_fp is None and set(stages) == {"index load"}

    with open(path, "r+b") as f:  # cut short: warned about and rebuilt
        f.truncate(os.path.getsize(path) // 2)
    caplog.clear()
    with caplog.at_level("WARNING"):
        idx7 = pivf.IvfIndex.load_or_build(path, lib, cfg, store_fp="fp_D",
                                           device="cpu")
    assert "Failed to load ANN index" in caplog.text
    assert idx7.store_fp == "fp_D"
    assert pivf.IvfIndex.load(path, 2, "cpu").store_fp == "fp_D"
    assert os.listdir(tmp_path) == ["c2.ivf.npz"]


@pytest.mark.parametrize("index_dtype,redundancy,soar_lambda", list(
    itertools.product(["bf16", "int8", "f32"], [1, 2, 3], [0.0, 1.0, 0.25])))
def test_index_filename_has_the_jax_stem(index_dtype, redundancy,
                                         soar_lambda):
    args = ("/data/lib.v2.splib", "0123456789abcdef", 3, index_dtype,
            redundancy, soar_lambda)
    got, want = pivf.ivf_index_filename(*args), jivf.ivf_index_filename(*args)
    assert want.endswith(".ivf.h5") and got.endswith(".ivf.npz")
    assert got[:-len(".ivf.npz")] == want[:-len(".ivf.h5")]
