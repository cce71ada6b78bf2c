"""The port's list-sharded IVF index (`parallel/sharded_ivf.py`) vs the
port's unsharded index and the JAX package's sharded index.

The counterparts of `test_sharded_ivf.py`, `test_sharded_scale.py` and
`test_multislice.py`, on their data (those of `test_sharded_build.py` are
in `test_torch_sharded_build.py`).  The
port's meshes are made of 8 repeated CPU devices (distinct CPU device
objects where a test counts blocks per device); the JAX package's of its
8 virtual CPU devices.  JAX indexes are carried into the port by
`convert.ivf_index_from_numpy`.

Tolerances: none.  Wherever the JAX tests pin identity (sharded == single
device), the port's sharded search returns the port's unsharded ids and
scores bit for bit, and the JAX package's sharded ids and scores bit for
bit; born-sharded builds are byte-identical to the single-device builds
given the same centroids.  Only the sharded k-means training is compared
by recall (the shard sums add in another order, as the JAX test says).

The scale regimes are forced as `test_sharded_scale.py` forces them: the
full-scan bound `_FULLSCAN_TRANSIENT` set to 1 in both packages; the JAX
package's probe regime by ``ANN_SOLO_TPU_PROBE_PALLAS=force`` (Pallas in
interpret mode), the port's chunked regime by setting
`ops.ivf_probe.MAX_PROBE_LANES` below the probe width times cap.
"""

import ml_dtypes
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ann_solo_tpu.index import ivf as jivf
from ann_solo_tpu.index.ivf import bruteforce_search
from ann_solo_tpu.parallel import mesh as jmesh_mod
from ann_solo_tpu.parallel import sharded_ivf as jsh_mod
from ann_solo_tpu_torch.convert import ivf_index_from_numpy
from ann_solo_tpu_torch.index import ivf as pivf
from ann_solo_tpu_torch.ops import ivf_probe
from ann_solo_tpu_torch.parallel.mesh import make_mesh, make_multislice_mesh
from ann_solo_tpu_torch.parallel.sharded_ivf import (
    ShardedIvfIndex,
    multislice_ivf_search,
    sharded_ivf_search,
)

from test_ivf import IvfConfig, _clustered_vectors

_CPU8 = [torch.device("cpu")] * 8


class Cfg:
    def __init__(self, num_list, num_probe, redundancy=2):
        self.num_list = num_list
        self.num_probe = num_probe
        self.ivf_redundancy = redundancy

    def __getitem__(self, key):
        return getattr(self, key)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8, dp_size=2, devices=_CPU8)  # (dp=2, lib=4)


@pytest.fixture(scope="module")
def jax_mesh():
    return jmesh_mod.make_mesh(8, dp_size=2)


def _port(index):
    return ivf_index_from_numpy(
        np.asarray(index.centroids), np.asarray(index.padded_vectors),
        np.asarray(index.padded_ids), np.asarray(index.padded_prec),
        np.asarray(index.padded_scales), index.num_probe, index.redundancy,
        "cpu",
    )


def _assert_same(got, want):
    """(ids, scores) pairs equal bit for bit (NumPy or tensors)."""
    g_ids, g_s = (np.asarray(a) for a in got)
    w_ids, w_s = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(g_ids, w_ids)
    np.testing.assert_array_equal(g_s.view(np.uint32), w_s.view(np.uint32))


def _unsharded(index, q, k, **kw):
    ids, scores = index.search_device(torch.from_numpy(q), k, **{
        key: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
        for key, v in kw.items()})
    return ids.numpy(), scores.numpy()


def _corpus(rng, n=4096, d=128):
    v = rng.normal(size=(n, d)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v, rng.uniform(400, 1200, n).astype(np.float32)


@pytest.fixture()
def small_transient(monkeypatch):
    """`test_sharded_scale.py`'s fixture, in both packages."""
    for mod in (jivf, pivf):
        monkeypatch.setattr(mod, "_FULLSCAN_TRANSIENT", 1)
        monkeypatch.setattr(mod, "_CHUNK_TRANSIENT", 1 << 12)


# --------------------------------------------------------------------- #
# test_sharded_ivf.py: the full-scan regime


def test_sharded_ivf_full_probe_is_exact(mesh, jax_mesh):
    rng = np.random.default_rng(21)
    vectors = _clustered_vectors(rng, n=2048, d=64, n_clusters=16)
    index = jivf.IvfIndex.build(vectors, IvfConfig(num_list=16,
                                                   num_probe=16))
    queries = vectors[rng.choice(len(vectors), 64, replace=False)]
    k = 16
    port = _port(index)
    sharded = ShardedIvfIndex(mesh, port)
    assert not sharded.scale_regime and sharded.regime(k) == "fullscan"
    got = sharded_ivf_search(mesh, port, queries, k, num_probe=16)
    _assert_same(got, _unsharded(port, queries, k, num_probe=16))
    _assert_same(got, jsh_mod.sharded_ivf_search(jax_mesh, index, queries,
                                                 k, num_probe=16))
    ids = got[0]
    exact = bruteforce_search(vectors, queries, k)
    agree = [len(set(ids[i][ids[i] >= 0]) & set(exact[i])) / k
             for i in range(len(queries))]
    assert np.mean(agree) > 0.99


def test_sharded_ivf_partial_probe_recall(mesh, jax_mesh):
    rng = np.random.default_rng(22)
    vectors = _clustered_vectors(rng, n=4096, d=64, n_clusters=32)
    index = jivf.IvfIndex.build(vectors, IvfConfig(num_list=32,
                                                   num_probe=12))
    queries = vectors[rng.choice(len(vectors), 64, replace=False)]
    k = 16
    port = _port(index)
    got = sharded_ivf_search(mesh, port, queries, k)
    _assert_same(got, _unsharded(port, queries, k))
    _assert_same(got, jsh_mod.sharded_ivf_search(jax_mesh, index, queries,
                                                 k))
    exact = bruteforce_search(vectors, queries, k)
    recalls = [len(set(got[0][i][got[0][i] >= 0]) & set(exact[i])) / k
               for i in range(len(queries))]
    assert np.mean(recalls) > 0.75


def test_replica_search_equals_search_device(mesh):
    """Each dp replica alone returns its rows of the whole batch, on its
    own first device."""
    rng = np.random.default_rng(25)
    vectors = _clustered_vectors(rng, n=2048, d=32, n_clusters=16)
    port = pivf.IvfIndex.build(torch.from_numpy(vectors),
                               IvfConfig(num_list=16, num_probe=4),
                               device="cpu")
    sharded = ShardedIvfIndex(mesh, port)
    q = torch.from_numpy(vectors[:50])
    ids, scores = sharded.search_device(q, 8)
    assert ids.shape == (50, 8) and ids.dtype == torch.int32
    for d, rows in ((0, slice(0, 25)), (1, slice(25, 50))):
        view = sharded.replica(d)
        assert view.device == sharded.replica_device(d)
        r_ids, r_s = view.search_device(q[rows], 8)
        assert torch.equal(r_ids, ids[rows]) and torch.equal(r_s,
                                                             scores[rows])
    empty = sharded.search_device(q[:0], 8)
    assert empty[0].shape == (0, 8)


# --------------------------------------------------------------------- #
# test_sharded_scale.py: the scale regimes


def test_sharded_chunked_regime_identity(mesh, jax_mesh, small_transient,
                                         monkeypatch):
    """Chunked running-merge local scan, window fused, int8 storage, a
    non-128-aligned D."""
    rng = np.random.default_rng(5)
    v, prec = _corpus(rng, d=72)
    single = jivf.IvfIndex.build(v, Cfg(32, 12), precursor_mz=prec,
                                 storage_dtype=np.int8)
    port = _port(single)
    sharded = ShardedIvfIndex(mesh, port)
    monkeypatch.setattr(ivf_probe, "MAX_PROBE_LANES", 1)
    assert sharded.scale_regime and sharded.dim == 72  # no TPU padding
    regime, _, chunk_lists = sharded._regime_params(32, 12, 32)
    assert regime == "chunked" and chunk_lists < sharded.lists_per_shard
    q = v[rng.choice(len(v), 64, replace=False)]
    qp = prec[rng.choice(len(v), 64)]
    kw = dict(num_probe=12, q_prec=qp, charge=2.0, tol_val=300.0)
    got = sharded.search_with_scores(q, 16, **kw)
    _assert_same(got, _unsharded(port, q, 16, **kw))
    _assert_same(got, jsh_mod.ShardedIvfIndex(jax_mesh, single)
                 .search_with_scores(q, 16, **kw))


def test_sharded_probe_regime_identity(mesh, jax_mesh, small_transient,
                                       monkeypatch):
    """Probe-gather local scan (B2's plain version here; the Pallas kernel
    in interpret mode on the JAX side) at full width."""
    monkeypatch.setenv("ANN_SOLO_TPU_PROBE_PALLAS", "force")
    rng = np.random.default_rng(7)
    v, prec = _corpus(rng)
    single = jivf.IvfIndex.build(v, Cfg(32, 12), precursor_mz=prec,
                                 storage_dtype=np.int8)
    port = _port(single)
    sharded = ShardedIvfIndex(mesh, port)
    regime, w, _ = sharded._regime_params(32, 12, 32)
    # l_l = 8 <= num_probe here: full width, overflow impossible.
    assert regime == "probe" and w == min(12, sharded.lists_per_shard)
    q = v[rng.choice(len(v), 64, replace=False)]
    qp = prec[rng.choice(len(v), 64)]
    kw = dict(num_probe=12, q_prec=qp, charge=2.0, tol_val=300.0)
    got = sharded.search_with_scores(q, 16, **kw)
    assert sharded._last_overflow == 0
    _assert_same(got, _unsharded(port, q, 16, **kw))
    jsharded = jsh_mod.ShardedIvfIndex(jax_mesh, single)
    assert jsharded._regime_params(32, 12, 32)[0] == "probe"
    _assert_same(got, jsharded.search_with_scores(q, 16, **kw))


def test_sharded_probe_single_shard_fast_path(small_transient, monkeypatch):
    """One list shard: the coarse top-k is the compaction."""
    monkeypatch.setenv("ANN_SOLO_TPU_PROBE_PALLAS", "force")
    rng = np.random.default_rng(23)
    v, prec = _corpus(rng)
    single = jivf.IvfIndex.build(v, Cfg(32, 12), precursor_mz=prec,
                                 storage_dtype=np.int8)
    port = _port(single)
    mesh1 = make_mesh(2, dp_size=2, devices=_CPU8)  # lib axis of size 1
    sharded = ShardedIvfIndex(mesh1, port)
    assert sharded.n_list_shards == 1
    regime, w, _ = sharded._regime_params(32, 12, 32)
    assert regime == "probe" and w == 12
    q = v[rng.choice(len(v), 64, replace=False)]
    qp = prec[rng.choice(len(v), 64)]
    kw = dict(num_probe=12, q_prec=qp, charge=2.0, tol_val=300.0)
    got = sharded.search_with_scores(q, 16, **kw)
    assert sharded._last_overflow == 0
    _assert_same(got, _unsharded(port, q, 16, **kw))
    _assert_same(got, jsh_mod.ShardedIvfIndex(
        jmesh_mod.make_mesh(2, dp_size=2), single).search_with_scores(
            q, 16, **kw))


def test_sharded_probe_overflow_repair(mesh, jax_mesh, small_transient,
                                       monkeypatch):
    """Queries whose probed lists concentrate on one shard beyond the
    static width are flagged (as many as the JAX package flags) and
    repaired through the chunked regime: `test_sharded_scale.py`'s
    engineered corpus (shard 0's 32 centroids around one direction,
    width 16 < 24 probes)."""
    monkeypatch.setenv("ANN_SOLO_TPU_PROBE_PALLAS", "force")
    rng = np.random.default_rng(11)
    d, num_list = 128, 128
    u = np.zeros(d, np.float32)
    u[0] = 1.0
    cents = rng.normal(size=(num_list, d)).astype(np.float32)
    cents[:32] = u + 0.05 * rng.normal(size=(32, d)).astype(np.float32)
    cents /= np.linalg.norm(cents, axis=1, keepdims=True)
    v = cents[np.arange(4096) % num_list]
    v = v + 0.1 * rng.normal(size=v.shape).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v = v.astype(np.float32)
    prec = rng.uniform(400, 1200, len(v)).astype(np.float32)
    single = jivf.IvfIndex.build(v, Cfg(num_list, 24), precursor_mz=prec,
                                 storage_dtype=np.int8, centroids=cents)
    port = _port(single)
    sharded = ShardedIvfIndex(mesh, port)
    regime, w, _ = sharded._regime_params(16, 24, 32)
    assert regime == "probe" and w == 16 < 24
    chunked = []
    scan = ShardedIvfIndex._scan

    def spy(self, d_, queries, *args):
        chunked.append(args[-3])
        return scan(self, d_, queries, *args)

    monkeypatch.setattr(ShardedIvfIndex, "_scan", spy)
    q = np.concatenate([v[:16], v[2000:2016]])
    qp = np.concatenate([prec[:16], prec[2000:2016]])
    kw = dict(num_probe=24, q_prec=qp, charge=2.0, tol_val=500.0)
    got = sharded.search_with_scores(q, 16, **kw)
    assert sharded._last_overflow > 0 and "chunked" in chunked
    _assert_same(got, _unsharded(port, q, 16, **kw))
    jsharded = jsh_mod.ShardedIvfIndex(jax_mesh, single)
    _assert_same(got, jsharded.search_with_scores(q, 16, **kw))
    assert sharded._last_overflow == jsharded._last_overflow


class _Float32Shapes(TorchDispatchMode):
    """Shapes of every float32 tensor an operation returns."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor) and t.dtype == torch.float32:
                self.shapes.append(tuple(t.shape))
        return out


def test_sharded_no_fullblock_transient(mesh, small_transient, monkeypatch):
    """No float32 tensor of the chunked regime spans a shard's whole
    L_l * cap lanes; its widest score block is (B_l, C * cap)."""
    rng = np.random.default_rng(13)
    v, prec = _corpus(rng)
    port = _port(jivf.IvfIndex.build(v, Cfg(32, 12), precursor_mz=prec,
                                     storage_dtype=np.int8))
    sharded = ShardedIvfIndex(mesh, port)
    l_l, cap, d = sharded.lists_per_shard, sharded.cap, sharded.dim
    monkeypatch.setattr(ivf_probe, "MAX_PROBE_LANES", 1)
    monkeypatch.setattr(pivf, "_CHUNK_TRANSIENT", 2 * cap * d * 4)
    regime, _, chunk_lists = sharded._regime_params(32, 12, 32)
    assert regime == "chunked" and chunk_lists == 2 < l_l
    q = torch.zeros((64, d))
    with _Float32Shapes() as log:
        sharded.search_device(q, 16, num_probe=12,
                              q_prec=torch.zeros(64), charge=2.0,
                              tol_val=300.0)
    assert not [s for s in log.shapes if l_l * cap in s]
    assert (32, chunk_lists * cap) in log.shapes
    assert not sharded._scan_blocks


def test_sharded_dedup_tie_boundary(mesh, jax_mesh):
    """Massive ties with x2 redundancy: every selection boundary is a tie;
    no id may drop or repeat."""
    rng = np.random.default_rng(17)
    d = 64
    base = rng.normal(size=(8, d)).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    v = np.repeat(base, 32, axis=0)  # 256 rows, 8 distinct values
    prec = np.tile(rng.uniform(400, 1200, 32).astype(np.float32), 8)
    single = jivf.IvfIndex.build(v, Cfg(8, 8, redundancy=2),
                                 precursor_mz=prec, storage_dtype=np.float32)
    port = _port(single)
    q = base[rng.choice(8, 32)]
    qp = prec[rng.choice(len(v), 32)]
    jsharded = jsh_mod.ShardedIvfIndex(jax_mesh, single)
    for tol in (0.0, 500.0):
        kw = dict(num_probe=8, q_prec=qp, charge=2.0, tol_val=tol)
        got = ShardedIvfIndex(mesh, port).search_with_scores(q, 16, **kw)
        _assert_same(got, _unsharded(port, q, 16, **kw))
        _assert_same(got, jsharded.search_with_scores(q, 16, **kw))
        for row in got[0]:
            real = row[row >= 0]
            assert len(set(real.tolist())) == len(real)
            assert len(real) == 16


# --------------------------------------------------------------------- #
# Helpers of the build tests (`test_torch_sharded_build.py`)


def _vectors(rng, n=4000, d=64, n_clusters=24):
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    v = centers[rng.integers(0, n_clusters, n)]
    v = v + 0.25 * rng.normal(size=(n, d)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v.astype(np.float32)


def _assert_same_arrays(sharded, index):
    """A sharded index's arrays equal an index's (port or JAX), bytes."""
    got = sharded.host_arrays()
    for name, want in (("vectors", index.padded_vectors),
                       ("ids", index.padded_ids),
                       ("prec", index.padded_prec),
                       ("scales", index.padded_scales)):
        g = got[name]
        if isinstance(want, torch.Tensor):
            assert g.dtype == want.dtype, name
            assert torch.equal(g.view(torch.uint8) if g.dtype.is_floating_point
                               else g, want.view(torch.uint8)
                               if want.dtype.is_floating_point else want), name
        else:
            want = np.asarray(want)
            if want.dtype == ml_dtypes.bfloat16:
                want = want.view(np.int16)
                g = g.view(torch.int16)
            np.testing.assert_array_equal(g.numpy().view(np.uint8),
                                          want.view(np.uint8), err_msg=name)


class _JaxArrays:
    """A JAX sharded index's global arrays under the port's names."""

    def __init__(self, index):
        self.padded_vectors = index.vectors_s
        self.padded_ids = index.ids_s
        self.padded_prec = index.prec_s
        self.padded_scales = index.scales_s


# --------------------------------------------------------------------- #
# test_multislice.py


@pytest.fixture(scope="module")
def ms_corpus():
    rng = np.random.default_rng(61)
    vectors = _clustered_vectors(rng, n=2048, d=64, n_clusters=16)
    prec = rng.uniform(400, 1200, len(vectors)).astype(np.float32)
    index = jivf.IvfIndex.build(vectors, IvfConfig(num_list=16, num_probe=8),
                                precursor_mz=prec)
    queries = vectors[rng.choice(len(vectors), 32, replace=False)]
    q_prec = prec[rng.choice(len(vectors), 32)]
    return index, queries, q_prec


def test_multislice_matches_single_slice(ms_corpus):
    index, queries, q_prec = ms_corpus
    port = _port(index)
    kw = dict(q_prec=q_prec, charge=2.0, tol_val=200.0)
    got = multislice_ivf_search(
        make_multislice_mesh(2, 4, dp_size=1, devices=_CPU8), port, queries,
        16, **kw)
    _assert_same(got, sharded_ivf_search(
        make_mesh(8, dp_size=1, devices=_CPU8), port, queries, 16, **kw))
    _assert_same(got, _unsharded(port, queries, 16, **kw))
    _assert_same(got, jsh_mod.multislice_ivf_search(
        jmesh_mod.make_multislice_mesh(2, 4, dp_size=1), index, queries, 16,
        **kw))


def test_multislice_dp_axis(ms_corpus):
    index, queries, q_prec = ms_corpus
    port = _port(index)
    kw = dict(q_prec=q_prec, charge=2.0, tol_val=200.0)
    mesh = make_multislice_mesh(2, 4, dp_size=2, devices=_CPU8)
    assert mesh.shape == {"dcn": 2, "dp": 2, "lib": 2}
    ids, scores = multislice_ivf_search(mesh, port, queries, 8, **kw)
    assert ids.shape == (32, 8)
    assert (ids >= 0).any(axis=1).all()
    _assert_same((ids, scores), _unsharded(port, queries, 8, **kw))
