"""The port's streaming IVF build against its in-memory build and the JAX
package's streaming build.

`IvfIndex.build_streaming` (accessor-fetched rows, device-resident
placement, list groups stored into a preallocated block) must give an
index byte-identical to `IvfIndex.build` with the same seed: centroids,
ids, stored vectors (as bytes), scales and precursors, for int8, bf16 and
f32 storage, with the pack forced through many small groups and when the
FAISS-style training subsample binds.  On the same NumPy inputs and
centroids it must also equal the JAX package's `build_streaming` (the two
packages' k-means agree at 1e-5, not bit for bit, so the centroids are
given).  The JAX `test_streaming_lane_padded_block` has no counterpart:
the port does not lane-pad D, a padding that serves TPU tiling.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ann_solo_tpu.index import ivf as jivf
from ann_solo_tpu_torch.index import ivf as pivf
from ann_solo_tpu_torch.ops.kmeans import spherical_kmeans

from test_streaming_build import IvfConfig, _vectors

_DTYPES = {"int8": (torch.int8, np.int8),
           "bf16": (torch.bfloat16, ml_dtypes.bfloat16),
           "f32": (torch.float32, np.float32)}


def _get_rows(vectors, calls=None):
    n = vectors.shape[0]

    def get_rows(idx):
        if calls is not None:
            calls.append(int(idx.shape[0]))
        return torch.from_numpy(vectors[np.clip(idx.numpy(), 0, n - 1)])

    return get_rows


def _arrays(index):
    """The five arrays of an index of either package, as NumPy (stored
    vectors as their bytes)."""
    vec = index.padded_vectors
    if isinstance(vec, torch.Tensor):
        if vec.dtype == torch.bfloat16:
            vec = vec.view(torch.int16)
        vec, conv = vec.numpy(), (lambda t: np.asarray(t))
    else:
        vec, conv = np.asarray(vec), np.asarray
    return {
        "centroids": conv(index.centroids),
        "padded_ids": conv(index.padded_ids),
        "padded_vectors": vec.view(np.uint8),
        "padded_scales": conv(index.padded_scales),
        "padded_prec": conv(index.padded_prec),
    }


def _assert_identical(a, b):
    assert a.redundancy == b.redundancy
    got, want = _arrays(a), _arrays(b)
    for name in want:
        assert got[name].shape == want[name].shape, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("storage", ["int8", "bf16", "f32"])
def test_streaming_matches_in_memory(storage):
    """x2 SOAR (the config's defaults), the pack in groups of one list."""
    dt = _DTYPES[storage][0]
    rng = np.random.default_rng(11)
    vectors = _vectors(rng, n=4000, d=64)
    prec = rng.uniform(300.0, 1800.0, size=4000).astype(np.float32)
    config = IvfConfig(num_list=16, num_probe=8)
    built = pivf.IvfIndex.build(
        torch.from_numpy(vectors), config, precursor_mz=prec, seed=7,
        storage_dtype=dt, device="cpu")
    streamed = pivf.IvfIndex.build_streaming(
        _get_rows(vectors), 4000, 64, config, precursor_mz=prec, seed=7,
        storage_dtype=dt, group_bytes=1 << 16, device="cpu")
    assert streamed.redundancy == 2
    _assert_identical(streamed, built)


def test_streaming_matches_when_train_subsample_binds():
    """num_list * 256 < n: both builds train on the same FAISS-style
    subsample."""
    rng = np.random.default_rng(5)
    vectors = _vectors(rng, n=3000, d=48, n_clusters=8)
    config = IvfConfig(num_list=8, num_probe=4)
    assert 8 * 256 < 3000
    built = pivf.IvfIndex.build(
        torch.from_numpy(vectors), config, seed=3, storage_dtype=torch.int8,
        device="cpu")
    streamed = pivf.IvfIndex.build_streaming(
        _get_rows(vectors), 3000, 48, config, seed=3, device="cpu")
    _assert_identical(streamed, built)


def test_streaming_train_rows_cap():
    """`train_rows_cap` below num_list * 256: k-means runs on the sorted
    ``RandomState(seed + 1)`` draw of that many rows, fetched in fixed
    blocks, and the rest of the build is `build`'s from those
    centroids."""
    rng = np.random.default_rng(8)
    vectors = _vectors(rng, n=2000, d=32, n_clusters=8)
    config = IvfConfig(num_list=8, num_probe=4)
    calls = []
    streamed = pivf.IvfIndex.build_streaming(
        _get_rows(vectors, calls), 2000, 32, config, seed=4,
        train_rows_cap=700, device="cpu")
    sub = np.sort(np.random.RandomState(5).choice(2000, 700, replace=False))
    cent, _ = spherical_kmeans(torch.from_numpy(vectors[sub]), 8, seed=4)
    assert calls[0] == 700  # one fetch of the subsample (block 2^18)
    built = pivf.IvfIndex.build(
        torch.from_numpy(vectors), config, seed=4, storage_dtype=torch.int8,
        centroids=cent, device="cpu")
    _assert_identical(streamed, built)


def _lib_and_config(rng, n=600, p=12):
    class Lib:
        mz = np.sort(rng.uniform(100, 1500, (n, p)).astype(np.float32), 1)
        intensity = np.abs(rng.standard_normal((n, p))).astype(np.float32)
        n_peaks = np.full(n, p, np.int32)
        precursor_mz = rng.uniform(400, 1200, n).astype(np.float64)
        n_spectra = n

    class Cfg:
        num_list = 8
        num_probe = 4
        index_dtype = "int8"
        ivf_redundancy = 2
        min_mz, max_mz, bin_size, hash_len = 11.0, 2010.0, 0.04, 64

    return Lib(), Cfg()


def test_load_or_build_streaming_switch(tmp_path, monkeypatch):
    """`load_or_build` streams exactly when n * hash_len * 4 exceeds the
    threshold (the JAX value, 4 GiB), re-vectorizing rows on demand, and
    the index is the in-memory build's."""
    assert pivf._STREAM_BUILD_SOURCE_BYTES == jivf._STREAM_BUILD_SOURCE_BYTES
    assert pivf._STREAM_BUILD_SOURCE_BYTES == 4 << 30
    lib, cfg = _lib_and_config(np.random.default_rng(9))
    source_bytes = 600 * 64 * 4
    made = {}
    for limit, want in ((source_bytes, "in memory"),
                        (source_bytes - 1, "streaming")):
        monkeypatch.setattr(pivf, "_STREAM_BUILD_SOURCE_BYTES", limit)
        notes, stages = {}, {}
        made[want] = pivf.IvfIndex.load_or_build(
            str(tmp_path / f"{limit}.ivf.npz"), lib, cfg, store_fp="fp",
            device="cpu", stage_seconds=stages, notes=notes)
        assert notes == {"build": want}
        assert set(stages) == {"index build", "index write"}
    _assert_identical(made["streaming"], made["in memory"])
    # A second call loads the file and builds nothing.
    notes, stages = {}, {}
    loaded = pivf.IvfIndex.load_or_build(
        str(tmp_path / f"{source_bytes - 1}.ivf.npz"), lib, cfg,
        store_fp="fp", device="cpu", stage_seconds=stages, notes=notes)
    assert notes == {} and set(stages) == {"index load"}
    _assert_identical(loaded, made["streaming"])


def test_streaming_search_matches_in_memory():
    rng = np.random.default_rng(2)
    vectors = _vectors(rng, n=2500, d=64)
    config = IvfConfig(num_list=16, num_probe=16)
    built = pivf.IvfIndex.build(
        torch.from_numpy(vectors), config, seed=1, storage_dtype=torch.int8,
        device="cpu")
    streamed = pivf.IvfIndex.build_streaming(
        _get_rows(vectors), 2500, 64, config, seed=1, device="cpu")
    queries = torch.from_numpy(vectors[rng.integers(0, 2500, 64)])
    ids_a, s_a = built.search_device(queries, 10)
    ids_b, s_b = streamed.search_device(queries, 10)
    assert torch.equal(ids_a, ids_b) and torch.equal(s_a, s_b)


@pytest.mark.parametrize(
    "n_rows,block", [(10, 4), (8, 4), (3, 8), (65, 16), (64, 16)]
)
def test_fetch_rows_blocked(n_rows, block, monkeypatch):
    """Equal to one accessor call on the same indices, every call but a
    lone short one exactly `block` rows, and the blocks copied into one
    output: nothing is concatenated."""
    calls = []

    def gen(idx):
        calls.append(int(idx.shape[0]))
        return idx[:, None].to(torch.float32) * torch.arange(
            5, dtype=torch.float32) + 1.0

    idx = np.arange(n_rows, dtype=np.int32)[::-1].copy()
    want = gen(torch.from_numpy(idx).to(torch.int64))
    calls.clear()

    def refuse(*args, **kwargs):
        raise AssertionError("fetch_rows_blocked concatenated its parts")

    monkeypatch.setattr(torch, "cat", refuse)
    monkeypatch.setattr(torch, "stack", refuse)
    got = pivf.fetch_rows_blocked(gen, idx, block=block)
    monkeypatch.undo()
    assert torch.equal(got, want)
    if n_rows > block:
        assert calls == [block] * -(-n_rows // block)
    else:
        assert calls == [n_rows]


def _skewed_choices(rng, n=600, num_list=16, a=4):
    base = rng.integers(0, 4, n)
    return np.stack([(base + j) % num_list for j in range(a)],
                    axis=1).astype(np.int32)


@pytest.mark.parametrize("soar", [False, True])
def test_plan_assignments_device_equals_host(soar):
    """The device slot table equals the scatter of `plan_assignments`'s
    placement and the JAX `plan_assignments_device`'s table, with the
    all-choices-full fallback (tight capacity) and x2 (SOAR-ranked or
    plain) second copies."""
    rng = np.random.default_rng(7)
    choices = _skewed_choices(rng)
    num_list, cap = 16, 48
    over = None
    if soar:
        over = [np.roll(choices, 1, axis=1)[:, :-1].astype(np.int32)]
    flat_slot, row_ids, spilled, _ = pivf.plan_assignments(
        torch.from_numpy(choices), num_list, cap, 2,
        None if over is None else [torch.from_numpy(over[0])])
    want = np.full(num_list * cap, -1, np.int32)
    keep = flat_slot >= 0
    want[flat_slot[keep]] = row_ids[keep]
    ids_flat, spilled_d = pivf.plan_assignments_device(
        torch.from_numpy(choices), num_list, cap, 2,
        None if over is None else [torch.from_numpy(over[0])])
    assert ids_flat.dtype == torch.int32
    np.testing.assert_array_equal(ids_flat.numpy(), want)
    assert spilled_d == spilled > 0
    jax_ids, jax_spilled = jivf.plan_assignments_device(
        choices, num_list, cap, 2, over)
    np.testing.assert_array_equal(ids_flat.numpy(), np.asarray(jax_ids))
    assert spilled_d == jax_spilled


@pytest.mark.parametrize("storage,num_list", [("int8", 16), ("bf16", 8),
                                              ("f32", 16)])
def test_build_streaming_equals_jax(storage, num_list):
    """The port's and the JAX package's `build_streaming` on the same
    NumPy rows, precursors and centroids: all five arrays identical (x2
    SOAR, the pack in small groups)."""
    dt_torch, dt_np = _DTYPES[storage]
    rng = np.random.default_rng(23)
    vectors = _vectors(rng, n=3000, d=64)
    prec = rng.uniform(300.0, 1800.0, size=3000).astype(np.float32)
    config = IvfConfig(num_list=num_list, num_probe=8)
    cent, _ = spherical_kmeans(torch.from_numpy(vectors), num_list, seed=3)
    cent = cent.numpy()

    def jax_rows(idx):
        return jnp.asarray(vectors[np.clip(np.asarray(idx), 0, 2999)])

    want = jivf.IvfIndex.build_streaming(
        jax_rows, 3000, 64, config, precursor_mz=prec, storage_dtype=dt_np,
        centroids=cent, group_bytes=1 << 18)
    got = pivf.IvfIndex.build_streaming(
        _get_rows(vectors), 3000, 64, config, precursor_mz=prec,
        storage_dtype=dt_torch, centroids=torch.from_numpy(cent),
        group_bytes=1 << 18, device="cpu")
    _assert_identical(got, want)
