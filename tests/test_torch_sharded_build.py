"""The port's born-sharded IVF build (`ShardedIvfIndex.build_sharded`,
`build_sharded_streaming`) vs the port's single-device builds and the JAX
package's sharded builds: the counterparts of `test_sharded_build.py`, on
its data.

Given the same centroids the born-sharded index is byte-identical to the
port's `IvfIndex.build` / `build_streaming` and to the JAX package's
`build_sharded` / `build_sharded_streaming` (ids, stored vectors as
bytes, scales, precursors); searches agree.  The k-means training split
over the mesh is held to the single-device build's recall within 0.1, as
the JAX test holds it (the shard sums add in another order).  Meshes as
in `test_torch_sharded_ivf.py`.
"""

import numpy as np
import pytest
import torch

from ann_solo_tpu.index import ivf as jivf
from ann_solo_tpu.index.ivf import bruteforce_search
from ann_solo_tpu.parallel import mesh as jmesh_mod
from ann_solo_tpu.parallel import sharded_ivf as jsh_mod
from ann_solo_tpu_torch.index import ivf as pivf
from ann_solo_tpu_torch.parallel.mesh import make_mesh, make_multislice_mesh
from ann_solo_tpu_torch.parallel.sharded_ivf import ShardedIvfIndex

from test_torch_sharded_ivf import (
    _CPU8,
    Cfg,
    _assert_same_arrays,
    _JaxArrays,
    _unsharded,
    _vectors,
)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8, dp_size=2, devices=_CPU8)  # (dp=2, lib=4)


@pytest.fixture(scope="module")
def jax_mesh():
    return jmesh_mod.make_mesh(8, dp_size=2)


def test_sharded_build_matches_single_device(mesh, jax_mesh):
    """Given the same centroids: the port's sharded build equals the
    port's `IvfIndex.build` and the JAX package's `build_sharded`, array
    for array; the searches agree."""
    rng = np.random.default_rng(17)
    vectors = _vectors(rng)
    prec = rng.uniform(400, 1200, len(vectors)).astype(np.float32)
    cfg = Cfg(num_list=16, num_probe=8)
    single = jivf.IvfIndex.build(vectors, cfg, precursor_mz=prec,
                                 storage_dtype=np.float32)
    cents = np.array(single.centroids)
    port = pivf.IvfIndex.build(
        torch.from_numpy(vectors), cfg, precursor_mz=prec,
        storage_dtype=torch.float32, centroids=torch.from_numpy(cents),
        device="cpu")
    sharded = ShardedIvfIndex.build_sharded(
        mesh, torch.from_numpy(vectors), cfg, precursor_mz=prec,
        storage_dtype=torch.float32, centroids=torch.from_numpy(cents))
    _assert_same_arrays(sharded, port)
    _assert_same_arrays(sharded, _JaxArrays(
        jsh_mod.ShardedIvfIndex.build_sharded(
            jax_mesh, vectors, cfg, precursor_mz=prec,
            storage_dtype=np.float32, centroids=cents)))
    assert sharded.redundancy == port.redundancy == 2
    assert set(sharded.build_seconds) == {"train", "assign", "plan", "pack",
                                          "place"}
    queries = vectors[rng.choice(len(vectors), 64, replace=False)]
    queries += 0.05 * rng.normal(size=queries.shape).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    np.testing.assert_array_equal(
        sharded.search(queries, 16, num_probe=16),
        _unsharded(port, queries, 16, num_probe=16)[0])


def test_sharded_kmeans_trains_comparable_quantizer(mesh):
    """Training split over the whole mesh: recall within 0.1 of the
    single-device build's (`test_sharded_build.py`'s bound)."""
    rng = np.random.default_rng(23)
    vectors = _vectors(rng, n=6000)
    cfg = Cfg(num_list=16, num_probe=6)
    k = 16
    queries = vectors[rng.choice(len(vectors), 200, replace=False)]
    queries += 0.05 * rng.normal(size=queries.shape).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    exact = bruteforce_search(vectors, queries, k)

    def recall(got):
        return np.mean([len(set(exact[i]) & set(got[i][got[i] >= 0])) / k
                        for i in range(len(queries))])

    single = pivf.IvfIndex.build(torch.from_numpy(vectors), cfg,
                                 storage_dtype=torch.float32, device="cpu")
    sharded = ShardedIvfIndex.build_sharded(
        mesh, torch.from_numpy(vectors), cfg, storage_dtype=torch.float32)
    r_single = recall(_unsharded(single, queries, k)[0])
    r_sharded = recall(sharded.search(queries, k))
    assert r_sharded > 0.6, r_sharded
    assert r_sharded >= r_single - 0.1, (r_single, r_sharded)


def test_multislice_born_sharded_build(jax_mesh):
    """A ('dcn', 'dp', 'lib') mesh of 8 distinct devices: lists shard
    over ('dcn', 'lib'); the build equals the single-device build; each
    device holds exactly the one shard block its (dcn, lib) coordinates
    name; the search agrees; training without centroids runs."""
    devices = [torch.device("cpu", i) for i in range(8)]
    mesh = make_multislice_mesh(2, 4, dp_size=2, devices=devices)
    rng = np.random.default_rng(37)
    vectors = _vectors(rng)
    prec = rng.uniform(400, 1200, len(vectors)).astype(np.float32)
    cfg = Cfg(num_list=16, num_probe=8)
    port = pivf.IvfIndex.build(torch.from_numpy(vectors), cfg,
                               precursor_mz=prec, storage_dtype=torch.float32,
                               device="cpu")
    sharded = ShardedIvfIndex.build_sharded(
        mesh, torch.from_numpy(vectors), cfg, precursor_mz=prec,
        storage_dtype=torch.float32, centroids=port.centroids)
    assert sharded.n_list_shards == 4 and sharded.dp == 2
    _assert_same_arrays(sharded, port)
    l_l = sharded.lists_per_shard
    by_device = {}
    for (s, device), block in sharded._blocks.items():
        by_device.setdefault(device, []).append((s, block))
    assert sorted(by_device, key=str) == sorted(devices, key=str)
    for device, held in by_device.items():
        assert len(held) == 1
        s, block = held[0]
        coords = np.argwhere(mesh.devices == device)[0]
        assert s == coords[0] * mesh.shape["lib"] + coords[2]
        assert torch.equal(block.ids, port.padded_ids[s * l_l:(s + 1) * l_l])
        assert block.vectors.nbytes * 4 == port.padded_vectors.nbytes
    queries = vectors[rng.choice(len(vectors), 64, replace=False)]
    queries += 0.05 * rng.normal(size=queries.shape).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    np.testing.assert_array_equal(
        sharded.search(queries, 16, num_probe=16),
        _unsharded(port, queries, 16, num_probe=16)[0])
    trained = ShardedIvfIndex.build_sharded(
        mesh, torch.from_numpy(vectors), cfg, precursor_mz=prec,
        storage_dtype=torch.float32)
    assert (trained.search(queries, 16, num_probe=16) >= 0).any()


def test_sharded_streaming_build_bounded_memory(mesh, jax_mesh):
    """Rows stream through the accessor in list-group fetches (never more
    than one group in flight), and the streamed index equals the port's
    `build_streaming` and the JAX package's `build_sharded_streaming`
    given the same centroids, int8 scales included."""
    import jax.numpy as jnp

    rng = np.random.default_rng(41)
    vectors = _vectors(rng, n=4000, d=64)
    prec = rng.uniform(400, 1200, len(vectors)).astype(np.float32)
    cfg = Cfg(num_list=16, num_probe=8)
    n, d = vectors.shape
    cents = np.array(jivf.IvfIndex.build(
        vectors, cfg, precursor_mz=prec, storage_dtype=np.int8).centroids)
    src = torch.from_numpy(vectors)
    stats = {"max_rows": 0, "calls": 0}

    def get_rows(idx):
        stats["max_rows"] = max(stats["max_rows"], len(idx))
        stats["calls"] += 1
        return src[idx.clamp(0, n - 1)]

    port = pivf.IvfIndex.build_streaming(
        get_rows, n, d, cfg, precursor_mz=prec, storage_dtype=torch.int8,
        centroids=torch.from_numpy(cents), device="cpu")
    cap = port.padded_ids.shape[1]
    group_bytes = 2 * cap * d * 8  # ~2 lists per group
    stats.update(max_rows=0, calls=0)
    streamed = ShardedIvfIndex.build_sharded_streaming(
        mesh, get_rows, n, d, cfg, precursor_mz=prec,
        storage_dtype=torch.int8, centroids=torch.from_numpy(cents),
        group_bytes=group_bytes)
    _assert_same_arrays(streamed, port)
    lists_per_group = max(1, group_bytes // (cap * d * (4 + 1)))
    assert stats["max_rows"] <= max(lists_per_group * cap, n), stats
    assert stats["calls"] > 16 // 2

    def jax_rows(idx):
        return jnp.asarray(vectors[np.clip(np.asarray(idx), 0, n - 1)])

    _assert_same_arrays(streamed, _JaxArrays(
        jsh_mod.ShardedIvfIndex.build_sharded_streaming(
            jax_mesh, jax_rows, n, d, cfg, precursor_mz=prec,
            storage_dtype=np.int8, centroids=cents,
            group_bytes=group_bytes)))
    q = vectors[rng.choice(n, 32, replace=False)]
    np.testing.assert_array_equal(streamed.search(q, 8),
                                  _unsharded(port, q, 8)[0])


def test_sharded_build_int8(mesh, jax_mesh):
    """SQ8 storage through the sharded build: per-row scales survive the
    per-shard packing."""
    rng = np.random.default_rng(31)
    vectors = _vectors(rng, n=2000)
    cfg = Cfg(num_list=8, num_probe=8, redundancy=1)
    single = pivf.IvfIndex.build(torch.from_numpy(vectors), cfg,
                                 storage_dtype=torch.int8, redundancy=1,
                                 device="cpu")
    sharded = ShardedIvfIndex.build_sharded(
        mesh, vectors, cfg, storage_dtype=torch.int8, redundancy=1,
        centroids=single.centroids)
    _assert_same_arrays(sharded, single)
    _assert_same_arrays(sharded, _JaxArrays(
        jsh_mod.ShardedIvfIndex.build_sharded(
            jax_mesh, vectors, cfg, storage_dtype=np.int8, redundancy=1,
            centroids=single.centroids.numpy())))
    queries = vectors[:32]
    np.testing.assert_array_equal(sharded.search(queries, 8),
                                  _unsharded(single, queries, 8)[0])
