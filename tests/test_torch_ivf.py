"""PyTorch IVF index (build + full-scan search) vs the JAX package.

Bit-identical: `_key16`/`_key16_to_f32`, `plan_assignments` from the same
choices, SQ8 packing, top-k centroid choices and SOAR rankings on the same
centroids.  k-means from the same seeded init: centroids at atol 1e-5.
Search on a JAX-built index carried over by `convert.py`: the same ids
(as sets per query), the same scores on >= 99.9% of lanes with any other
difference a single bf16 key step, and no duplicate ids.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ann_solo_tpu.index import ivf as jivf
from ann_solo_tpu.ops import kmeans as jkmeans
from ann_solo_tpu.ops.ivf_scan_pallas import (
    _key16 as jax_key16,
    _key16_to_f32 as jax_key16_to_f32,
)
from ann_solo_tpu_torch.convert import ivf_index_from_numpy, to_numpy
from ann_solo_tpu_torch.index import ivf as pivf
from ann_solo_tpu_torch.ops import kmeans as pkmeans

from test_ivf import IvfConfig, _clustered_vectors


def test_key16_bit_identical():
    rng = np.random.default_rng(3)
    special = np.array(
        [0.0, -0.0, np.inf, -np.inf, 1.0, -1.0, 1e-40, -1e-40,
         np.finfo(np.float32).max, -np.finfo(np.float32).max],
        np.float32,
    )
    # bf16 rounding boundaries: the low 16 bits at 0x7FFF, 0x8000, 0x8001
    # with even and odd kept bits, both signs.
    hi = rng.integers(0, 0x7F80, 64).astype(np.uint32) << 16
    lows = np.array([0x7FFF, 0x8000, 0x8001, 0x0000, 0xFFFF], np.uint32)
    bits = (hi[:, None] | lows[None, :]).ravel()
    bits = np.concatenate([bits, bits | 0x80000000]).astype(np.uint32)
    x = np.concatenate([
        special, bits.view(np.float32),
        rng.normal(0, 3, 2000).astype(np.float32),
    ])
    exp = np.asarray(jax_key16(jnp.asarray(x)))
    got = pivf._key16(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, exp)
    assert got[np.isneginf(x)][0] == pivf._KEY16_NINF
    back_exp = np.asarray(jax_key16_to_f32(jnp.asarray(exp)))
    back = pivf._key16_to_f32(torch.from_numpy(got)).numpy()
    np.testing.assert_array_equal(back.view(np.uint32),
                                  back_exp.view(np.uint32))


@pytest.mark.parametrize("soar", [False, True])
def test_plan_assignments_identical(soar):
    """Same choices (and SOAR overrides) -> the same placements, including
    the all-choices-full host fallback (tight capacity)."""
    rng = np.random.default_rng(7)
    n, num_list, a = 600, 16, 4
    # Skewed rankings so lists overflow and the fallback runs.
    base = rng.integers(0, 4, n)
    choices = np.stack(
        [(base + j) % num_list for j in range(a)], axis=1
    ).astype(np.int32)
    cap = 48
    over = None
    if soar:
        over = [np.roll(choices, 1, axis=1)[:, :-1].astype(np.int32)]
    exp = jivf.plan_assignments(choices, num_list, cap, 2, over)
    got = pivf.plan_assignments(
        torch.from_numpy(choices), num_list, cap, 2,
        None if over is None else [torch.from_numpy(over[0])],
    )
    np.testing.assert_array_equal(got[0], exp[0])
    np.testing.assert_array_equal(got[1], exp[1])
    assert got[2] == exp[2] and got[2] > 0
    for g, e in zip(got[3], exp[3]):
        np.testing.assert_array_equal(g, e)


@pytest.mark.parametrize("dtype", ["int8", "bf16", "f32"])
def test_pack_lists_bit_identical(dtype):
    import ml_dtypes

    rng = np.random.default_rng(9)
    n, d, num_list, cap = 300, 40, 16, 48
    vectors = rng.normal(size=(n, d)).astype(np.float32)
    vectors[5] = 0.0  # all-zero row: scale 0
    slots = rng.permutation(num_list * cap)[: 2 * n].astype(np.int64)
    slots[::7] = -1
    row_ids = np.tile(np.arange(n, dtype=np.int32), 2)
    jdtype = {"int8": np.int8, "bf16": ml_dtypes.bfloat16,
              "f32": np.float32}[dtype]
    tdtype = {"int8": torch.int8, "bf16": torch.bfloat16,
              "f32": torch.float32}[dtype]
    e_ids, e_vecs, e_scales = jivf._pack_lists(
        jnp.asarray(vectors), jnp.asarray(slots), jnp.asarray(row_ids),
        num_list, cap, jnp.dtype(jdtype),
    )
    g_ids, g_vecs, g_scales = pivf._pack_lists(
        torch.from_numpy(vectors), slots, row_ids, num_list, cap, tdtype
    )
    np.testing.assert_array_equal(g_ids.numpy(), np.asarray(e_ids))
    np.testing.assert_array_equal(
        g_scales.numpy().view(np.uint32),
        np.asarray(e_scales).view(np.uint32),
    )
    e_vecs = np.asarray(e_vecs)
    if dtype == "bf16":
        g = g_vecs.view(torch.int16).numpy().view(np.uint16)
        np.testing.assert_array_equal(g, e_vecs.view(np.uint16))
    else:
        np.testing.assert_array_equal(g_vecs.numpy(), e_vecs)


def test_kmeans_choices_and_soar_identical():
    rng = np.random.default_rng(21)
    vectors = _clustered_vectors(rng, n=3000, d=32, n_clusters=12)
    e_cent, e_assign = jkmeans.spherical_kmeans(vectors, 16, n_iter=10)
    g_cent, g_assign = pkmeans.spherical_kmeans(
        torch.from_numpy(vectors), 16, n_iter=10
    )
    np.testing.assert_allclose(g_cent.numpy(), np.asarray(e_cent), atol=1e-5)
    assert np.mean(g_assign.numpy() == np.asarray(e_assign)) > 0.995
    # On the SAME centroids, choices and SOAR rankings are identical.
    cent = np.array(e_cent)
    e_ch = np.asarray(jkmeans.assign_topk_blocked(vectors, cent, 8))
    g_ch = pkmeans.assign_topk_blocked(
        torch.from_numpy(vectors), torch.from_numpy(cent), 8
    ).numpy()
    np.testing.assert_array_equal(g_ch, e_ch)
    e_soar = np.asarray(jkmeans.soar_round2_choices(vectors, cent, e_ch, 1.0))
    g_soar = pkmeans.soar_round2_choices(
        torch.from_numpy(vectors), torch.from_numpy(cent),
        torch.from_numpy(g_ch), 1.0,
    ).numpy()
    assert np.mean(np.all(g_soar == e_soar, axis=1)) > 0.999


def test_build_from_same_centroids_identical():
    rng = np.random.default_rng(33)
    vectors = _clustered_vectors(rng, n=2000, d=32, n_clusters=16)
    prec = rng.uniform(400, 1200, 2000).astype(np.float32)
    cfg = IvfConfig(num_list=32, num_probe=8)
    cent, _ = jkmeans.spherical_kmeans(vectors, 32)
    cent = np.array(cent)
    e = jivf.IvfIndex.build(vectors, cfg, precursor_mz=prec, centroids=cent,
                            storage_dtype=np.int8, redundancy=2)
    g = pivf.IvfIndex.build(
        torch.from_numpy(vectors), cfg, precursor_mz=prec,
        centroids=torch.from_numpy(cent), storage_dtype=torch.int8,
        redundancy=2, device="cpu",
    )
    np.testing.assert_array_equal(g.padded_ids.numpy(),
                                  np.asarray(e.padded_ids))
    np.testing.assert_array_equal(g.padded_vectors.numpy(),
                                  np.asarray(e.padded_vectors))
    np.testing.assert_array_equal(g.padded_scales.numpy(),
                                  np.asarray(e.padded_scales))
    np.testing.assert_array_equal(g.padded_prec.numpy(),
                                  np.asarray(e.padded_prec))
    assert (g.num_probe, g.redundancy) == (e.num_probe, e.redundancy)


def _jax_index(storage, seed=41, n=3000):
    rng = np.random.default_rng(seed)
    vectors = _clustered_vectors(rng, n=n, d=48, n_clusters=16)
    prec = rng.uniform(400, 1200, n).astype(np.float32)
    index = jivf.IvfIndex.build(
        vectors, IvfConfig(num_list=32, num_probe=6), precursor_mz=prec,
        storage_dtype=storage, redundancy=2,
    )
    queries = vectors[rng.choice(n, 256, replace=False)]
    queries = queries + 0.05 * rng.normal(size=queries.shape).astype(
        np.float32
    )
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    q_prec = prec[rng.choice(n, 256)] + rng.normal(0, 5, 256).astype(
        np.float32
    )
    return index, queries.astype(np.float32), q_prec.astype(np.float32)


def _port(index):
    return ivf_index_from_numpy(
        np.asarray(index.centroids), np.asarray(index.padded_vectors),
        np.asarray(index.padded_ids), np.asarray(index.padded_prec),
        np.asarray(index.padded_scales), index.num_probe, index.redundancy,
        "cpu",
    )


@pytest.mark.parametrize(
    "storage,tol_val,tol_mode",
    [("int8", 300.0, "Da"), ("int8", 20000.0, "ppm"), ("bf16", 0.0, "Da"),
     ("f32", 150.0, "Da")],
)
def test_search_device_matches_jax(storage, tol_val, tol_mode):
    import ml_dtypes

    jstorage = {"int8": np.int8, "bf16": ml_dtypes.bfloat16,
                "f32": np.float32}[storage]
    index, queries, q_prec = _jax_index(jstorage)
    k = 40
    e_ids, e_s = index.search_device(
        queries, k, q_prec=q_prec, charge=2.0, tol_val=tol_val,
        tol_mode=tol_mode,
    )
    e_ids, e_s = np.asarray(e_ids), np.asarray(e_s)
    port = _port(index)
    g_ids, g_s = port.search_device(
        torch.from_numpy(queries), k, q_prec=torch.from_numpy(q_prec),
        charge=2.0, tol_val=tol_val, tol_mode=tol_mode,
    )
    g_ids, g_s = g_ids.numpy(), g_s.numpy()
    assert g_ids.shape == e_ids.shape == (256, k)
    for i in range(len(queries)):
        row = g_ids[i][g_ids[i] >= 0]
        assert len(np.unique(row)) == len(row), f"query {i} has dups"
    # Lanes agree except where a score sits one bf16 key step from its
    # JAX counterpart (the f32 sums are taken in another order).
    same_lane = (g_ids == e_ids) & (g_s == e_s)
    assert same_lane.mean() >= 0.999
    if storage != "f32":
        gk = pivf._key16(torch.from_numpy(g_s)).numpy()
        ek = np.asarray(jax_key16(jnp.asarray(e_s)))
        assert np.all(np.abs(gk - ek) <= 1)
    same_set = [
        set(g_ids[i][g_ids[i] >= 0]) == set(e_ids[i][e_ids[i] >= 0])
        for i in range(len(queries))
    ]
    assert np.mean(same_set) >= 0.99


def test_dedup_topk_semantics():
    scores = torch.tensor(
        [[9.0, 9.0, 7.0, 7.0, 7.0, 5.0, -np.inf, -np.inf]]
    )
    ids = torch.tensor([[11, 11, 3, 8, 3, 4, -1, -1]], dtype=torch.int32)
    out_s, out_i = pivf._dedup_topk(scores, ids, 4)
    np.testing.assert_array_equal(out_i.numpy()[0], [11, 3, 8, 4])
    np.testing.assert_allclose(out_s.numpy()[0], [9.0, 7.0, 7.0, 5.0])
    out_s, out_i = pivf._dedup_topk(scores, ids, 6)
    np.testing.assert_array_equal(out_i.numpy()[0], [11, 3, 8, 4, -1, -1])
    assert out_s.numpy()[0, 4] == -np.inf


def test_resolvers_and_convert_roundtrip():
    for n in (100, 4096, 25_000, 131_072, 2_100_000):
        nl = pivf.resolve_num_list(0, n)
        assert nl == jivf.resolve_num_list(0, n)
        for probe in (0, 64):
            assert (pivf.resolve_num_probe(probe, nl)
                    == jivf.resolve_num_probe(probe, nl))
        for r, lam in ((1, 0.0), (2, 1.0), (3, 0.0)):
            assert (pivf.ivf_build_params(n, nl, r, lam)
                    == jivf.ivf_build_params(n, nl, r, lam))
    import ml_dtypes

    index, _, _ = _jax_index(ml_dtypes.bfloat16, n=1000)
    arrays = to_numpy(_port(index))
    np.testing.assert_array_equal(
        arrays["padded_vectors"].view(ml_dtypes.bfloat16),
        np.asarray(index.padded_vectors),
    )
    assert arrays["redundancy"] == index.redundancy


def test_non_fullscan_regime_raises(monkeypatch):
    """A library whose probe union cannot cover it returns the per-query
    oracle's results through the probe path and, beyond the probe path's
    lane bound (where this search used to raise), through the plain
    chunked scan with its repair."""
    from ann_solo_tpu_torch.ops import ivf_probe

    rng = np.random.default_rng(1)
    vectors = _clustered_vectors(rng, n=512, d=16, n_clusters=8)
    index = pivf.IvfIndex.build(
        torch.from_numpy(vectors), IvfConfig(num_list=256, num_probe=1),
        device="cpu", redundancy=1,
    )
    queries = torch.from_numpy(vectors[:4])
    ids, scores = index.search_device(queries, 8)
    w_s, w_ids = pivf._ivf_search_perquery(
        *index._blocks(), queries, torch.zeros(4), 1.0, 1, 8, 8, 0.0, "Da",
        False,
    )
    assert torch.equal(ids, w_ids.to(torch.int32))
    assert torch.equal(scores, w_s)
    monkeypatch.setattr(ivf_probe, "MAX_PROBE_LANES", 1)
    chunked = []
    scan = pivf._ivf_search_chunked
    monkeypatch.setattr(pivf, "_ivf_search_chunked",
                        lambda *a, **kw: chunked.append(1) or scan(*a, **kw))
    ids, scores = index.search_device(queries, 8)
    assert chunked == [1]
    assert torch.equal(ids, w_ids.to(torch.int32))
    assert torch.equal(scores, w_s)
