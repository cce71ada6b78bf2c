"""The port's meshes, sharded masked top-k and k-means step
(`parallel/mesh.py`, `parallel/sharded.py`) vs the JAX package's
`tests/test_sharded.py`.

The port's meshes are made of 8 repeated CPU devices; the JAX package's
of the 8 virtual CPU devices `conftest.py` provides.  Mesh shapes equal
the JAX package's.  The sharded top-k equals the port's own single-device
selection bit for bit (every shard scores its rows with the same f32
products; the merge keeps the lower row on ties).  Against the JAX
package: the same ids on >= 99.9% of lanes and scores at atol 1e-6 (XLA's
f32 dot may sum in another order).  The k-means step: the host oracle and
the JAX step at atol 1e-5 (`test_sharded.py`'s tolerance; the shard sums
add in another order).
"""

import jax
import numpy as np
import pytest
import torch

from ann_solo_tpu.parallel import mesh as jmesh_mod
from ann_solo_tpu.parallel import sharded as jsharded
from ann_solo_tpu_torch.ops.topk import stable_topk_desc
from ann_solo_tpu_torch.parallel import mesh as mesh_mod
from ann_solo_tpu_torch.parallel.mesh import (
    make_mesh,
    make_multislice_mesh,
    pad_to_multiple,
    replica_devices,
)
from ann_solo_tpu_torch.parallel.sharded import (
    _masked_local_scores,
    sharded_kmeans_step,
    sharded_search_step,
    sharded_topk_search,
)

_CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8, devices=[_CPU] * 8)


@pytest.fixture(scope="module")
def jax_mesh():
    assert len(jax.devices("cpu")) >= 8, "conftest must force 8 CPU devices"
    return jmesh_mod.make_mesh(8)


def _library(rng, n=1024, d=64):
    vectors = rng.normal(size=(n, d)).astype(np.float32)
    vectors /= np.linalg.norm(vectors, axis=1, keepdims=True)
    prec = rng.uniform(400, 1200, n).astype(np.float32)
    return vectors, prec


@pytest.mark.parametrize("n,dp_size", [(8, None), (8, 1), (8, 4), (4, None),
                                       (2, 2), (1, None)])
def test_mesh_shape_equals_jax(n, dp_size):
    got = make_mesh(n, dp_size=dp_size, devices=[_CPU] * 8)
    want = jmesh_mod.make_mesh(n, dp_size=dp_size)
    assert got.shape == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names)
    assert got.size == n and got.devices.shape == want.devices.shape


@pytest.mark.parametrize("slices,per_slice,dp", [(2, 4, 1), (2, 4, 2),
                                                 (4, 2, 1)])
def test_multislice_mesh_shape_equals_jax(slices, per_slice, dp):
    got = make_multislice_mesh(slices, per_slice, dp_size=dp,
                               devices=[_CPU] * 8)
    want = jmesh_mod.make_multislice_mesh(slices, per_slice, dp_size=dp)
    assert got.shape == dict(want.shape)
    assert got.axis_names == ("dcn", "dp", "lib")


def test_replica_devices_are_row_major_over_the_list_axes():
    devices = [torch.device("cpu", i) for i in range(8)]
    mesh = make_multislice_mesh(2, 4, dp_size=2, devices=devices)
    grid = replica_devices(mesh)  # (dcn=2, dp=2, lib=2)
    assert [[d.index for d in row] for row in grid] == [[0, 1, 4, 5],
                                                        [2, 3, 6, 7]]


def test_make_mesh_raises_without_cuda(monkeypatch):
    """No CPU fallback: the default devices are CUDA's, and a mesh asking
    for more devices than it is given is refused."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh_mod.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh_mod.make_multislice_mesh(2)
    with pytest.raises(ValueError, match="only 2"):
        mesh_mod.make_mesh(8, devices=[_CPU] * 2)
    with pytest.raises(ValueError):
        mesh_mod.make_multislice_mesh(2, 4, devices=[_CPU] * 4)


def _single_device_topk(vectors, prec, queries, q_prec, k, charge, tol):
    scores = _masked_local_scores(
        torch.from_numpy(queries), torch.from_numpy(q_prec),
        torch.from_numpy(vectors), torch.from_numpy(prec), charge, tol)
    top_s, top_i = stable_topk_desc(scores, k)
    return torch.where(top_s > float("-inf"), top_i, -1).numpy(), \
        top_s.numpy()


@pytest.mark.parametrize("tol", [1e6, 10.0])
def test_sharded_topk_matches_single_device_and_jax(mesh, jax_mesh, tol):
    rng = np.random.default_rng(3)
    vectors, prec = _library(rng)
    queries, q_prec = _library(rng, n=64)
    k = 16
    ids, scores = sharded_topk_search(mesh, vectors, prec, queries, q_prec,
                                      k, charge=2.0, tol=tol)
    assert ids.dtype == torch.int32 and ids.shape == (64, k)
    ids, scores = ids.numpy(), scores.numpy()
    w_ids, w_s = _single_device_topk(vectors, prec, queries, q_prec, k,
                                     2.0, tol)
    np.testing.assert_array_equal(ids, w_ids)
    np.testing.assert_array_equal(scores, w_s)
    e_ids, e_s = jsharded.sharded_topk_search(
        jax_mesh, vectors, prec, queries, q_prec, k, charge=2.0, tol=tol)
    e_ids, e_s = np.asarray(e_ids), np.asarray(e_s)
    assert (ids == e_ids).mean() >= 0.999
    np.testing.assert_allclose(scores, e_s, atol=1e-6)


def test_sharded_topk_respects_precursor_window(mesh):
    rng = np.random.default_rng(4)
    vectors, prec = _library(rng)
    queries, q_prec = _library(rng, n=64)
    tol, charge = 10.0, 2.0
    ids, _ = sharded_topk_search(mesh, vectors, prec, queries, q_prec, 16,
                                 charge=charge, tol=tol)
    ids = ids.numpy()
    for i in range(len(queries)):
        for j in ids[i][ids[i] >= 0]:
            assert abs(q_prec[i] - prec[j]) * charge <= tol + 1e-3
    lonely_prec = np.full(len(queries), 5000.0, np.float32)
    ids2, _ = sharded_topk_search(mesh, vectors, prec, queries, lonely_prec,
                                  16, charge, tol)
    assert (ids2.numpy() == -1).all()


def test_sharded_kmeans_step_matches_host_and_jax(mesh, jax_mesh):
    rng = np.random.default_rng(5)
    vectors, _ = _library(rng, n=2048)
    centroids = vectors[:32].copy()
    new = sharded_kmeans_step(mesh, vectors, centroids).numpy()
    ids = np.argmax(vectors @ centroids.T, axis=1)
    sums = np.zeros_like(centroids)
    np.add.at(sums, ids, vectors)
    counts = np.bincount(ids, minlength=32).astype(np.float32)
    expected = np.where(counts[:, None] > 0,
                        sums / np.maximum(counts[:, None], 1.0), centroids)
    expected /= np.maximum(np.linalg.norm(expected, axis=1, keepdims=True),
                           1e-30)
    np.testing.assert_allclose(new, expected, atol=1e-5)
    jax_new = np.asarray(jsharded.sharded_kmeans_step(jax_mesh, vectors,
                                                      centroids))
    np.testing.assert_allclose(new, jax_new, atol=1e-5)


def test_sharded_kmeans_step_keeps_empty_clusters(mesh):
    """A centroid no row is nearest to stays as it was (rows in the
    positive orthant, that centroid in the negative one)."""
    rng = np.random.default_rng(8)
    vectors = np.abs(_library(rng, n=512, d=16)[0])
    centroids = np.concatenate([vectors[:4], -np.ones((1, 16), np.float32)
                                / 4.0])
    new = sharded_kmeans_step(mesh, vectors, centroids).numpy()
    np.testing.assert_array_equal(new[4], centroids[4])


def test_full_sharded_step_matches_jax(mesh, jax_mesh):
    rng = np.random.default_rng(6)
    vectors, prec = _library(rng, n=1024)
    queries, q_prec = _library(rng, n=64)
    centroids = vectors[:16].copy()
    ids, scores, new_centroids = sharded_search_step(
        mesh, vectors, prec, centroids, queries, q_prec, k=8, charge=2.0,
        tol=1e6)
    assert ids.shape == (64, 8) and new_centroids.shape == (16, 64)
    assert torch.isfinite(scores[ids >= 0]).all()
    e_ids, _, e_cent = jsharded.sharded_search_step(
        jax_mesh, vectors, prec, centroids, queries, q_prec, k=8,
        charge=2.0, tol=1e6)
    assert (ids.numpy() == np.asarray(e_ids)).mean() >= 0.999
    np.testing.assert_allclose(new_centroids.numpy(), np.asarray(e_cent),
                               atol=1e-5)


def test_pad_to_multiple_equals_jax():
    arr = np.arange(30, dtype=np.float64).reshape(10, 3)
    for multiple, axis, fill in ((8, 0, 0), (4, 1, -1), (5, 0, 0)):
        got = pad_to_multiple(arr, multiple, axis, fill)
        np.testing.assert_array_equal(
            got, jmesh_mod.pad_to_multiple(arr, multiple, axis, fill))
    padded = pad_to_multiple(np.ones((10, 3)), 8)
    assert padded.shape == (16, 3) and padded[10:].sum() == 0
