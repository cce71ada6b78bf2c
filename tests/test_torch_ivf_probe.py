"""The port's big-library select path vs the JAX package.

Kernel B2's plain version against the Pallas kernel in interpret mode, the
per-query oracle, the probe path of `search_device` and its dispatch
(kernel B3's path and the plain chunked scan are in
`test_torch_ivf_scan.py`), and the open-search slice on a probe-path
index.  The JAX package takes its
probe path the way its own tests force it (`test_ivf_probe_pallas.py`):
`_FULLSCAN_TRANSIENT = 0`, `ANN_SOLO_TPU_PROBE_PALLAS=force`,
`ANN_SOLO_TPU_CHUNKED_PALLAS=0`.

Tolerances.  On exact data (storage integers, queries integers / 64, so
every partial sum is exact in f32 in any order) results are bit-identical.
On random data a score may differ by the f32 rounding of another
summation order, at most 2 * D * 2^-24 * sum_d |bf16(q_d) v_d| * scale;
after the 16-bit keys that is at most one key step, so >= 99.9% of
(id, score) lanes agree and every other lane is one key step away.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ann_solo_tpu.index import ivf as jivf
from ann_solo_tpu.ops.ivf_probe_pallas import ivf_probe_scan as jax_probe_scan
from ann_solo_tpu.ops.ivf_scan_pallas import _key16 as jax_key16
from ann_solo_tpu_torch.convert import ivf_index_from_numpy
from ann_solo_tpu_torch.index import ivf as pivf
from ann_solo_tpu_torch.ops import ivf_probe
from ann_solo_tpu_torch.ops.ivf_probe_cuda import ivf_probe_scan

from test_ivf import IvfConfig, _clustered_vectors

_STORAGE = {
    "int8": (np.int8, torch.int8),
    "bf16": (ml_dtypes.bfloat16, torch.bfloat16),
    "f32": (np.float32, torch.float32),
}


def _force_jax_probe(monkeypatch, index):
    monkeypatch.setattr(jivf, "_FULLSCAN_TRANSIENT", 0)
    monkeypatch.setenv("ANN_SOLO_TPU_PROBE_PALLAS", "force")
    monkeypatch.setenv("ANN_SOLO_TPU_CHUNKED_PALLAS", "0")
    index._device = None  # re-upload with the big-library layout


def _port(index):
    return ivf_index_from_numpy(
        np.asarray(index.centroids), np.asarray(index.padded_vectors),
        np.asarray(index.padded_ids), np.asarray(index.padded_prec),
        np.asarray(index.padded_scales), index.num_probe, index.redundancy,
        "cpu",
    )


def _count_probe_tiles(monkeypatch):
    calls = []
    tile = pivf._ivf_probe_scan_tile

    def spy(*args, **kwargs):
        calls.append(args[5].shape[0])
        return tile(*args, **kwargs)

    monkeypatch.setattr(pivf, "_ivf_probe_scan_tile", spy)
    return calls


def _assert_lanes_agree(g_ids, g_s, e_ids, e_s, keyed=True):
    """>= 99.9% of (id, score) lanes equal, every key16 within one step,
    no duplicate ids, the same candidate sets for >= 99% of queries."""
    assert g_ids.shape == e_ids.shape
    for i in range(len(g_ids)):
        row = g_ids[i][g_ids[i] >= 0]
        assert len(np.unique(row)) == len(row), f"query {i} has dups"
    assert ((g_ids == e_ids) & (g_s == e_s)).mean() >= 0.999
    if keyed:
        gk = pivf._key16(torch.from_numpy(g_s)).numpy()
        ek = np.asarray(jax_key16(jnp.asarray(e_s)))
        assert np.all(np.abs(gk - ek) <= 1)
    same_set = [
        set(g_ids[i][g_ids[i] >= 0]) == set(e_ids[i][e_ids[i] >= 0])
        for i in range(len(g_ids))
    ]
    assert np.mean(same_set) >= 0.99


# --------------------------------------------------------------------- #
# (1) The plain B2 vs the Pallas kernel (interpret mode)


def _scan_inputs(rng, storage, exact, l=16, cap=128, d=128, b=8, p=4):
    if exact:
        vals = rng.integers(-4, 5, (l, cap, d))
        vectors = (vals if storage == "int8" else vals / 8.0)
        scales = np.full((l, cap), 1.0 / 8.0, np.float32)
        queries = rng.integers(-32, 33, (b, d)) / 64.0
    else:
        if storage == "int8":
            vectors = rng.integers(-127, 128, (l, cap, d))
            scales = rng.uniform(0.5, 1.0, (l, cap)) / (127.0 * np.sqrt(d))
        else:
            vectors = rng.normal(size=(l, cap, d)) / np.sqrt(d)
            scales = np.ones((l, cap))
        queries = rng.normal(size=(b, d))
        queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    vectors = vectors.astype(_STORAGE[storage][0])
    ids = rng.integers(0, 10 * l * cap, (l, cap)).astype(np.int32)
    ids[rng.uniform(size=(l, cap)) < 0.2] = -1
    prec = np.where(ids >= 0, rng.uniform(400, 1200, (l, cap)), 0.0)
    q_prec = rng.uniform(400, 1200, b)
    probes = np.sort(
        np.stack([rng.choice(l, p, replace=False) for _ in range(b)]), 1
    ).astype(np.int32)
    return (vectors, ids, prec.astype(np.float32),
            scales.astype(np.float32), queries.astype(np.float32),
            q_prec.astype(np.float32), probes)


def _to_torch(arr):
    if arr.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


@pytest.mark.parametrize("storage", ["int8", "bf16"])
@pytest.mark.parametrize("tol_val,tol_mode", [(100.0, "Da"),
                                              (1e5, "ppm"), (0.0, "Da")])
@pytest.mark.parametrize("exact", [True, False])
def test_probe_scan_plain_matches_pallas(storage, tol_val, tol_mode, exact):
    rng = np.random.default_rng(5)
    vectors, ids, prec, scales, queries, q_prec, probes = _scan_inputs(
        rng, storage, exact
    )
    meta = np.concatenate(
        [prec, scales, (ids >= 0).astype(np.float32)], axis=1
    )
    want = np.asarray(jax_probe_scan(
        jnp.asarray(vectors), jnp.asarray(meta), jnp.asarray(queries),
        jnp.asarray(q_prec), jnp.float32(2.0), jnp.asarray(probes),
        tol_val, tol_mode, interpret=True,
    ))
    got = ivf_probe_scan(  # CPU tensors: the wrapper runs the plain version
        *(_to_torch(a) for a in (vectors, ids, prec, scales, queries,
                                 q_prec)),
        2.0, _to_torch(probes).to(torch.int64), tol_val, tol_mode,
    ).numpy()
    assert got.shape == want.shape == (8, 4 * 128)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    assert 0 < np.isneginf(got).mean() < 1
    if exact:
        np.testing.assert_array_equal(got, want)
        return
    finite = ~np.isneginf(want)
    qb = np.abs(queries.astype(ml_dtypes.bfloat16).astype(np.float64))
    v = np.abs(vectors.astype(np.float64))[probes]  # (B, P, cap, D)
    abs_sum = np.einsum("bd,bpcd->bpc", qb, v) * scales[probes]
    bound = 2 * 128 * 2.0 ** -24 * abs_sum.reshape(got.shape)
    assert np.all(np.abs(got[finite] - want[finite]) <= bound[finite])


def test_probe_scan_wrapper_checks():
    rng = np.random.default_rng(6)
    arrays = [_to_torch(a) for a in _scan_inputs(rng, "int8", True)]
    args = lambda a: (*a[:6], 2.0, a[6], 10.0, "Da")  # noqa: E731
    assert ivf_probe_scan(*args(arrays)).shape == (8, 512)
    bad = list(arrays)
    bad[0] = bad[0].to(torch.float32)
    with pytest.raises(TypeError, match="int8 or bfloat16"):
        ivf_probe_scan(*args(bad))
    bad = list(arrays)
    bad[4] = bad[4].t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        ivf_probe_scan(*args(bad))
    bad = list(arrays)
    bad[5] = bad[5][:3]
    with pytest.raises(ValueError, match="q_prec"):
        ivf_probe_scan(*args(bad))
    with pytest.raises(ValueError, match="tol_mode"):
        ivf_probe_scan(*arrays[:6], 2.0, arrays[6], 10.0, "mDa")


def test_probe_scan_supported_rules():
    assert ivf_probe.probe_scan_supported(4096, 768, 64, torch.int8)
    assert ivf_probe.probe_scan_supported(64, 200, 16, torch.bfloat16)
    assert not ivf_probe.probe_scan_supported(64, 200, 16, torch.float32)
    # p * cap <= 2^22 lanes, with p clamped to the list count.
    assert ivf_probe.probe_scan_supported(1 << 20, 1 << 12, 1024, torch.int8)
    assert not ivf_probe.probe_scan_supported(1 << 20, 1 << 12, 1025,
                                              torch.int8)
    assert ivf_probe.probe_scan_supported(1024, 1 << 12, 4096, torch.int8)


# --------------------------------------------------------------------- #
# (2) The per-query oracle vs the JAX one


def _exact_index(seed, redundancy, n=4000, d=128, l=64, prec=True):
    rng = np.random.default_rng(seed)
    vectors = (rng.integers(-4, 5, size=(n, d)) / 8.0).astype(np.float32)
    p_mz = np.sort(rng.uniform(400, 1200, n)).astype(np.float32)
    index = jivf.IvfIndex.build(
        vectors, IvfConfig(num_list=l, num_probe=16), redundancy=redundancy,
        storage_dtype=np.int8, precursor_mz=p_mz if prec else None,
    )
    b = 64
    queries = (rng.integers(-32, 33, size=(b, d)) / 64.0).astype(np.float32)
    q_prec = p_mz[rng.choice(n, b, replace=False)]
    return index, queries, q_prec


def _random_index(seed, storage, redundancy, n=3000, d=100, l=64, b=96):
    rng = np.random.default_rng(seed)
    vectors = _clustered_vectors(rng, n=n, d=d, n_clusters=16)
    p_mz = rng.uniform(400, 1200, n).astype(np.float32)
    index = jivf.IvfIndex.build(
        vectors, IvfConfig(num_list=l, num_probe=12), redundancy=redundancy,
        storage_dtype=_STORAGE[storage][0], precursor_mz=p_mz,
    )
    rows = rng.choice(n, b, replace=False)
    queries = vectors[rows] + 0.05 * rng.normal(size=(b, d)).astype(
        np.float32
    )
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    q_prec = p_mz[rows] + rng.normal(0, 20, b).astype(np.float32)
    return index, queries.astype(np.float32), q_prec.astype(np.float32)


def _both_oracles(index, queries, q_prec, p, k, tol_val, tol_mode):
    arrays = [np.asarray(a) for a in (
        index.padded_vectors, index.padded_ids, index.padded_prec,
        index.padded_scales, index.centroids,
    )]
    redundant = index.redundancy > 1
    k_scan = index.redundancy * k
    e_s, e_ids = jivf._ivf_search_perquery(
        *(jnp.asarray(a) for a in arrays), jnp.asarray(queries),
        jnp.asarray(q_prec), jnp.float32(2.0), p, k, k_scan, tol_val,
        tol_mode, redundant,
    )
    g_s, g_ids = pivf._ivf_search_perquery(
        *_port(index)._blocks(), torch.from_numpy(queries),
        torch.from_numpy(q_prec), 2.0, p, k, k_scan, tol_val, tol_mode,
        redundant,
    )
    return (g_ids.numpy(), g_s.numpy(), np.asarray(e_ids),
            np.asarray(e_s))


@pytest.mark.parametrize("redundancy,tol_val", [(1, 0.0), (2, 50.0)])
def test_perquery_matches_jax_exact(redundancy, tol_val):
    index, queries, q_prec = _exact_index(61, redundancy)
    g_ids, g_s, e_ids, e_s = _both_oracles(
        index, queries, q_prec, 16, 32, tol_val, "Da"
    )
    np.testing.assert_array_equal(g_ids, e_ids)
    np.testing.assert_array_equal(g_s, e_s)


@pytest.mark.parametrize(
    "storage,tol_val,tol_mode",
    [("int8", 300.0, "Da"), ("bf16", 50000.0, "ppm"), ("f32", 300.0, "Da")],
)
def test_perquery_matches_jax_random(storage, tol_val, tol_mode):
    index, queries, q_prec = _random_index(67, storage, 2)
    g_ids, g_s, e_ids, e_s = _both_oracles(
        index, queries, q_prec, 12, 24, tol_val, tol_mode
    )
    if storage == "f32":  # exact f32 scores, taken in another order
        assert np.mean(g_ids == e_ids) >= 0.99
        same = (g_ids == e_ids) & (g_ids >= 0)
        np.testing.assert_allclose(g_s[same], e_s[same], rtol=1e-6)
        return
    _assert_lanes_agree(g_ids, g_s, e_ids, e_s)


# --------------------------------------------------------------------- #
# (3) search_device on the probe path vs the JAX probe path


def test_search_device_probe_path_matches_jax(monkeypatch):
    """x2 redundancy, a Da window, ragged D = 100, a batch of 100 (not a
    power of two) in four super-tiles of at most 32 queries."""
    index, queries, q_prec = _random_index(71, "int8", 2, n=2700, b=100)
    k = 16
    port = _port(index)
    _force_jax_probe(monkeypatch, index)
    e_ids, e_s = index.search_device(
        queries, k, q_prec=q_prec, charge=2.0, tol_val=300.0, tol_mode="Da"
    )
    assert index._last_chunked_flagged == 0
    monkeypatch.setattr(pivf, "_FULLSCAN_TRANSIENT", 0)
    monkeypatch.setattr(pivf, "_CHUNK_TQ", 32)
    tiles = _count_probe_tiles(monkeypatch)
    g_ids, g_s = port.search_device(
        torch.from_numpy(queries), k, q_prec=torch.from_numpy(q_prec),
        charge=2.0, tol_val=300.0, tol_mode="Da",
    )
    assert tiles == [32, 32, 32, 4]
    assert g_ids.dtype == torch.int32 and g_ids.shape == (100, k)
    _assert_lanes_agree(g_ids.numpy(), g_s.numpy(), np.asarray(e_ids),
                        np.asarray(e_s))


# --------------------------------------------------------------------- #
# (4) The contract: probe path == oracle, bit for bit, on exact data


@pytest.mark.parametrize("redundancy,tol_val,tol_mode",
                         [(1, 0.0, "Da"), (2, 50.0, "Da"),
                          (2, 40000.0, "ppm")])
def test_probe_path_identical_to_oracle(monkeypatch, redundancy, tol_val,
                                        tol_mode):
    index, queries, q_prec = _exact_index(79, redundancy)
    port = _port(index)
    monkeypatch.setattr(pivf, "_FULLSCAN_TRANSIENT", 0)
    monkeypatch.setattr(pivf, "_CHUNK_TQ", 24)
    tiles = _count_probe_tiles(monkeypatch)
    k, p = 32, 16
    g_ids, g_s = port.search_device(
        torch.from_numpy(queries), k, num_probe=p,
        q_prec=torch.from_numpy(q_prec), charge=2.0, tol_val=tol_val,
        tol_mode=tol_mode,
    )
    assert len(tiles) == 3
    w_s, w_ids = pivf._ivf_search_perquery(
        *port._blocks(), torch.from_numpy(queries),
        torch.from_numpy(q_prec), 2.0, p, k, redundancy * k, tol_val,
        tol_mode, redundancy > 1,
    )
    assert torch.equal(g_ids, w_ids.to(torch.int32))
    assert torch.equal(g_s, w_s)
    assert (g_ids >= 0).float().mean() > 0.5


def test_stable_topk_desc_keeps_only_k_columns():
    """`lax.top_k`'s tie order, in tensors that own only their k columns:
    a view of the full sort kept a whole (16384, 4096) index block alive
    per `assign_topk_blocked` block (68 GB at 2.1M rows)."""
    from ann_solo_tpu_torch.ops.topk import stable_topk_desc

    x = torch.from_numpy(
        np.random.default_rng(3).integers(0, 5, (64, 300)).astype(
            np.float32))
    values, idx = stable_topk_desc(x, 7)
    e_values, e_idx = jax.lax.top_k(jnp.asarray(x.numpy()), 7)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(e_idx))
    np.testing.assert_array_equal(values.numpy(), np.asarray(e_values))
    for t in (values, idx):
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size()


# --------------------------------------------------------------------- #
# (5) Dispatch


def _non_covering(storage):
    """256 lists probed once: 256 > 1 * 128, the union cannot cover."""
    rng = np.random.default_rng(1)
    vectors = _clustered_vectors(rng, n=2048, d=16, n_clusters=8)
    index = pivf.IvfIndex.build(
        torch.from_numpy(vectors), IvfConfig(num_list=256, num_probe=1),
        device="cpu", redundancy=1, storage_dtype=storage,
    )
    return index, torch.from_numpy(vectors[:40])


def test_non_covering_union_runs_probe_path(monkeypatch):
    index, queries = _non_covering(torch.int8)
    tiles = _count_probe_tiles(monkeypatch)
    ids, scores = index.search_device(queries, 8)
    assert tiles == [40]
    w_s, w_ids = pivf._ivf_search_perquery(
        *index._blocks(), queries, torch.zeros(40), 1.0, 1, 8, 8, 0.0,
        "Da", False,
    )
    assert torch.equal(ids, w_ids.to(torch.int32))
    assert torch.equal(scores, w_s)
    assert (ids[:, 0] == torch.arange(40)).float().mean() >= 0.9


def test_f32_storage_beyond_fullscan_is_the_oracle(monkeypatch):
    """f32 storage beyond the full scan, union not covering: the JAX
    package's degenerate-tile rule (256 lists <= 1 probe x 1,024) takes the
    plain chunked scan, whose results after repair are the oracle's: the
    same ids, and the same exact f32 scores up to the rounding of another
    summation order (a matrix product against the oracle's gathered
    einsum), rtol 1e-6 as for f32 storage elsewhere."""
    index, queries = _non_covering(torch.float32)
    tiles = _count_probe_tiles(monkeypatch)
    chunked = []
    scan = pivf._ivf_search_chunked
    monkeypatch.setattr(pivf, "_ivf_search_chunked",
                        lambda *a, **kw: chunked.append(1) or scan(*a, **kw))
    ids, scores = index.search_device(queries, 8)
    assert tiles == [] and chunked == [1]
    w_s, w_ids = pivf._ivf_search_perquery(
        *index._blocks(), queries, torch.zeros(40), 1.0, 1, 8, 8, 0.0,
        "Da", False,
    )
    assert torch.equal(ids, w_ids.to(torch.int32))
    torch.testing.assert_close(scores, w_s, rtol=1e-6, atol=0.0)


def test_beyond_lane_bound_runs_b3(monkeypatch):
    """A bf16 index beyond the probe path's lane bound takes the fused
    chunked scan (B3's plain version on the CPU) and returns the JAX
    package's forced fused search: 8 hot + 8 cold lists, 2 chunks of 16
    lists, a ppm window, certificates and repair."""
    rng = np.random.default_rng(97)
    n, d, l = 5400, 128, 64  # cap lands on 128
    vectors = _clustered_vectors(rng, n=n, d=d, n_clusters=16)
    p_mz = np.sort(rng.uniform(400, 1200, n)).astype(np.float32)
    index = jivf.IvfIndex.build(
        vectors, IvfConfig(num_list=l, num_probe=16), redundancy=1,
        storage_dtype=_STORAGE["bf16"][0], precursor_mz=p_mz,
    )
    b, k = 96, 32
    rows = rng.choice(n, b, replace=False)
    queries = vectors[rows] + 0.05 * rng.normal(size=(b, d)).astype(
        np.float32)
    queries = (queries / np.linalg.norm(queries, axis=1, keepdims=True)
               ).astype(np.float32)
    q_prec = p_mz[rows].copy()
    args = dict(charge=2.0, tol_val=50000.0, tol_mode="ppm")
    port = _port(index)
    cap = port.padded_vectors.shape[1]
    assert cap == 128
    monkeypatch.setattr(jivf, "_FULLSCAN_TRANSIENT", 0)
    monkeypatch.setenv("ANN_SOLO_TPU_CHUNKED_PALLAS", "force")
    monkeypatch.setenv("ANN_SOLO_TPU_PROBE_PALLAS", "0")
    index._device = None
    e_ids, e_s = index.search_device(queries, k, q_prec=q_prec, **args)
    monkeypatch.setattr(pivf, "_FULLSCAN_TRANSIENT", 0)
    monkeypatch.setattr(ivf_probe, "MAX_PROBE_LANES", 16 * cap - 1)
    fused = []
    tile = pivf._ivf_chunked_scan_tile
    monkeypatch.setattr(pivf, "_ivf_chunked_scan_tile",
                        lambda *a, **kw: fused.append(1) or tile(*a, **kw))
    tiles = _count_probe_tiles(monkeypatch)
    g_ids, g_s = port.search_device(
        torch.from_numpy(queries), k, q_prec=torch.from_numpy(q_prec), **args
    )
    assert fused == [1] and tiles == []
    assert port._last_chunked_flagged == index._last_chunked_flagged
    _assert_lanes_agree(g_ids.numpy(), g_s.numpy(), np.asarray(e_ids),
                        np.asarray(e_s))


# --------------------------------------------------------------------- #
# (6) The open-search slice on a probe-path index


def test_open_search_probe_regime_matches_jax(monkeypatch):
    from ann_solo_tpu.models.vectorize import (
        VectorizeParams as JaxVectorizeParams,
        vectorize_batch as jax_vectorize,
    )
    from ann_solo_tpu.ops.rescore import rescore_candidate_matrix
    from ann_solo_tpu_torch.convert import library_from_numpy
    from ann_solo_tpu_torch.models.vectorize import VectorizeParams
    from ann_solo_tpu_torch.search import (
        OpenSearchParams,
        ann_open_search_batch,
    )
    from test_torch_slice import CHARGE, FRAG_TOL, K, OPEN_TOL, _synth

    n_lib, n_q, n_cand = 4096, 64, 256
    rng = np.random.default_rng(43)
    lib_mz, lib_int, lib_ann, lib_prec = _synth(rng, n_lib)
    rows = rng.choice(n_lib, n_q, replace=False)
    q_mz = np.sort(lib_mz[rows] + rng.normal(0, 0.005, (n_q, K)).astype(
        np.float32), axis=1)
    q_int = np.abs(lib_int[rows] + rng.normal(0, 0.02, (n_q, K)).astype(
        np.float32))
    q_int /= np.linalg.norm(q_int, axis=1, keepdims=True)
    q_prec = lib_prec[rows] + rng.normal(0, 0.002, n_q)
    prec32 = lib_prec.astype(np.float32)
    q_n = np.full(n_q, K, np.int32)

    jparams = JaxVectorizeParams(11.0, 2010.0, 0.04, 800)
    jtables = jparams.device_tables()
    jindex = jivf.IvfIndex.build(
        jax_vectorize(jparams, jtables, lib_mz, lib_int,
                      np.full(n_lib, K, np.int32)),
        IvfConfig(num_list=256, num_probe=32), precursor_mz=prec32,
        storage_dtype=np.int8, redundancy=2,
    )
    port = _port(jindex)
    _force_jax_probe(monkeypatch, jindex)
    cand, _ = jindex.search_device(
        jax_vectorize(jparams, jtables, q_mz, q_int, q_n), n_cand,
        q_prec=q_prec.astype(np.float32), charge=float(CHARGE),
        tol_val=OPEN_TOL, tol_mode="Da",
    )
    assert jindex._last_chunked_flagged == 0
    exp_idx, exp_score, exp_n = rescore_candidate_matrix(
        jnp.asarray(q_mz), jnp.asarray(q_int),
        jnp.asarray(q_prec, jnp.float32), jnp.asarray(lib_mz),
        jnp.asarray(lib_int), jnp.asarray(lib_ann), jnp.asarray(prec32),
        cand, FRAG_TOL, CHARGE + 1, True, False,
    )

    monkeypatch.setattr(pivf, "_FULLSCAN_TRANSIENT", 0)
    tiles = _count_probe_tiles(monkeypatch)
    got_idx, got_score, got_n, matches = ann_open_search_batch(
        port, library_from_numpy(lib_mz, lib_int, lib_ann, lib_prec, "cpu"),
        q_mz, q_int, q_n, q_prec, CHARGE,
        OpenSearchParams(
            vectorize=VectorizeParams(11.0, 2010.0, 0.04, 800),
            num_candidates=n_cand, precursor_tolerance_mass_open=OPEN_TOL,
            fragment_mz_tolerance=FRAG_TOL,
        ),
    )
    assert tiles == [n_q]
    same = got_idx == exp_idx
    assert same.mean() >= 0.99
    np.testing.assert_allclose(got_score[same], exp_score[same], rtol=1e-5)
    assert np.mean(got_idx == rows) >= 0.95
    assert np.all(np.abs(got_n - exp_n) <= 0.01 * n_cand)
    assert len(matches) == int((got_idx >= 0).sum())


# --------------------------------------------------------------------- #
# (7) Kernel B2's list-major decomposition, on the CPU


def _probe_table(kind, rng, b=64, l=48, p=12):
    """(B, P) probe ids of one shape the kernel meets: each query its own
    ascending lists, every query on the same lists, phase 8's hot shape
    (P = 8), one query, a row repeating a list, ids -1 and L."""
    def own(b, p):
        return np.sort(np.stack([rng.choice(l, p, replace=False)
                                 for _ in range(b)]), 1)
    if kind == "random":
        table = own(b, p)
    elif kind == "clustered":
        table = np.repeat(own(1, p), b, 0)
    elif kind == "hot":
        table = own(b, 8)
    elif kind == "single_query":
        table = own(1, p)
    elif kind == "repeated_list":
        table = own(b, p)
        table[3, 1] = table[3, 0]
        table[5] = table[5, 0]
    else:  # "invalid"
        table = own(b, p)
        table[0, 0] = -1
        table[-1, -1] = l
        table[7, 2] = l + 5
    return torch.from_numpy(table.astype(np.int64)), l


@pytest.mark.parametrize("kind", ["random", "clustered", "hot",
                                  "single_query", "repeated_list",
                                  "invalid"])
def test_list_probe_entries(kind):
    """Every (b, rank) entry once, under its list (list L for ids outside
    [0, L)), ascending within a list, counts matching the table."""
    probe_ids, l = _probe_table(kind, np.random.default_rng(13))
    b, p = probe_ids.shape
    entries, starts, counts = ivf_probe.list_probe_entries(probe_ids, l)
    assert entries.dtype == starts.dtype == counts.dtype == torch.int32
    assert starts.shape == (l + 2,) and counts.shape == (l + 1,)
    assert torch.equal(torch.sort(entries).values,
                       torch.arange(b * p, dtype=torch.int32))
    assert int(starts[0]) == 0 and int(starts[-1]) == b * p
    assert torch.equal(starts.diff(), counts)
    flat = probe_ids.reshape(-1)
    key = torch.where((flat >= 0) & (flat < l), flat, l)
    assert torch.equal(counts.long(), torch.bincount(key, minlength=l + 1))
    for j in range(l + 1):
        group = entries[starts[j]:starts[j + 1]].long()
        assert bool((key[group] == j).all())
        assert bool((group.diff() > 0).all())
    if kind == "clustered":
        assert int(counts.max()) == b
    if kind == "repeated_list":  # one entry per (b, rank), not per list
        assert int(counts[int(probe_ids[5, 0])]) >= p


def _list_major_scan(vectors, ids, prec, scales, queries, q_prec, charge,
                     probe_ids, tol_val, tol_mode, per_pass=32, tile=256):
    """Kernel B2's addressing in plain PyTorch: work items of up to
    `per_pass` entries of one list times `tile` slots, each scored against
    the list's rows once and scattered to its entries' row segments."""
    l, cap, _ = vectors.shape
    b, p = probe_ids.shape
    entries, starts, _ = ivf_probe.list_probe_entries(probe_ids, l)
    q = queries.to(torch.bfloat16).to(torch.float32)
    out = torch.full((b * p, cap), float("nan"))
    for j in range(l + 1):
        group = entries[starts[j]:starts[j + 1]].long()
        for e0 in range(0, len(group), per_pass):
            ent = group[e0:e0 + per_pass]
            for s0 in range(0, cap, tile):
                s = slice(s0, min(cap, s0 + tile))
                if j == l:  # not a list: nothing is valid
                    out[ent, s] = float("-inf")
                    continue
                rows = vectors[j, s].to(torch.float32)
                scores = (q[ent // p] @ rows.T) * scales[j, s]
                ok = (ids[j, s] >= 0)[None, :].expand_as(scores)
                if tol_val > 0:
                    ok = ok & ivf_probe.window_mask(
                        q_prec[ent // p, None], prec[j, s][None, :], charge,
                        tol_val, tol_mode)
                out[ent, s] = torch.where(ok, scores, float("-inf"))
    return out.view(b, p * cap)


@pytest.mark.parametrize("storage,cap,d,tol_val,tol_mode,kind", [
    ("int8", 256, 128, 100.0, "Da", "random"),
    ("int8", 300, 100, 0.0, "Da", "clustered"),
    ("bf16", 200, 100, 1e5, "ppm", "invalid"),
    ("bf16", 520, 64, 100.0, "Da", "repeated_list"),
])
def test_list_major_addressing_matches_plain(storage, cap, d, tol_val,
                                             tol_mode, kind):
    """On exact data the list-major emulation equals the plain version bit
    for bit, ragged D (100) and cap (200, 300, 520 over 256-slot tiles)
    included; clustered tables run several passes of 32 a list."""
    rng = np.random.default_rng(17)
    probe_ids, l = _probe_table(kind, rng)
    arrays = _scan_inputs(rng, storage, True, l=l, cap=cap, d=d,
                          b=probe_ids.shape[0])
    args = [_to_torch(a) for a in arrays[:6]]
    want = ivf_probe_scan(*args, 2.0, probe_ids, tol_val, tol_mode)
    got = _list_major_scan(*args, 2.0, probe_ids, tol_val, tol_mode)
    assert not bool(torch.isnan(got).any())
    assert 0 < float(torch.isneginf(want).float().mean()) < 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("bad", ["minus_one", "l"])
def test_probe_scan_plain_invalid_id_is_neg_inf(bad):
    """A probe id of -1 or L scores no slot: its row segment is all -inf,
    the kernel's contract, and the other segments are unchanged."""
    rng = np.random.default_rng(19)
    arrays = [_to_torch(a) for a in _scan_inputs(rng, "int8", True)]
    l, cap = arrays[0].shape[:2]
    args = lambda probes: (*arrays[:6], 2.0, probes, 0.0, "Da")  # noqa: E731
    good = ivf_probe_scan(*args(arrays[6]))
    probes = arrays[6].clone()
    probes[2, 1] = -1 if bad == "minus_one" else l
    got = ivf_probe_scan(*args(probes))
    segment = slice(cap, 2 * cap)
    assert bool(torch.isneginf(got[2, segment]).all())
    assert not bool(torch.isneginf(good[2, segment]).all())
    got[2, segment] = good[2, segment]
    assert torch.equal(got, good)
