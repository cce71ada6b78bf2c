"""The port's chunked regimes vs the JAX package: kernel B3's path (the
fused chunked scan + select, its certificates and the per-query repair)
and the plain chunked scan with pooled-max group selection.

Kernel B3's plain version with the selection after it against the JAX
`ivf_chunked_scan_select` in interpret mode, the support rules, mass ties
and the truncation certificate, `_ivf_search_chunked` and its tie
certificate, and `search_device` forced into each chunked regime (the JAX
package forced the way its own tests force it: `_FULLSCAN_TRANSIENT = 0`
with `ANN_SOLO_TPU_CHUNKED_PALLAS=force` and `ANN_SOLO_TPU_PROBE_PALLAS=0`
for the fused kernel; the port by setting `ops.ivf_probe.MAX_PROBE_LANES`
below P * cap).

Tolerances.  On exact data (storage integers, queries integers / 64, so
every partial sum is exact in f32 in any order) results are bit-identical,
certificate flags included.  On random data a score may differ by the f32
rounding of another summation order; after the 16-bit keys that is at most
one key step, so over the queries neither package flags >= 99.9% of
(position, score) lanes agree and every other lane is one key step away.
f32 storage keeps exact f32 scores: the same ids for >= 99% of lanes,
scores at rtol 1e-6.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ann_solo_tpu.index import ivf as jivf
from ann_solo_tpu.ops import ivf_scan_pallas as jscan
from ann_solo_tpu_torch.index import ivf as pivf
from ann_solo_tpu_torch.ops import ivf_probe
from ann_solo_tpu_torch.ops import ivf_scan as pscan

from test_ivf import IvfConfig, _clustered_vectors
from test_torch_ivf_probe import _STORAGE, _assert_lanes_agree, _port, _to_torch


def _force_jax_fused(monkeypatch, index):
    monkeypatch.setattr(jivf, "_FULLSCAN_TRANSIENT", 0)
    monkeypatch.setenv("ANN_SOLO_TPU_CHUNKED_PALLAS", "force")
    monkeypatch.setenv("ANN_SOLO_TPU_PROBE_PALLAS", "0")
    index._device = None  # re-upload with the big-library layout


def _force_port_fused(monkeypatch, index, num_probe):
    """Full scan off, and the probe path's lane bound just below P * cap."""
    l, cap, _ = index.padded_vectors.shape
    monkeypatch.setattr(pivf, "_FULLSCAN_TRANSIENT", 0)
    monkeypatch.setattr(ivf_probe, "MAX_PROBE_LANES",
                        min(num_probe, l) * cap - 1)


def _spy(monkeypatch, name):
    """Record the batch size of every call of `pivf.<name>`."""
    calls = []
    fn = getattr(pivf, name)

    def spy(*args, **kwargs):
        calls.append(args[5].shape[0])
        return fn(*args, **kwargs)

    monkeypatch.setattr(pivf, name, spy)
    return calls


def _lanes_agree(g, e, rows):
    """>= 99.9% of (position, score) lanes equal over `rows`, every key16
    within one step."""
    (g_s, g_pos), (e_s, e_pos) = g, e
    if not rows.any():
        return
    same = (g_s[rows] == e_s[rows]) & (g_pos[rows] == e_pos[rows])
    assert same.mean() >= 0.999, same.mean()
    gk = pscan._key16(torch.from_numpy(g_s[rows])).numpy()
    ek = np.asarray(jscan._key16(jnp.asarray(e_s[rows])))
    assert np.all(np.abs(gk - ek) <= 1)


# --------------------------------------------------------------------- #
# (1) Support rules


@pytest.mark.parametrize("storage", ["int8", "bf16", "f32"])
def test_chunked_support_rules_match_jax(storage):
    np_dtype, torch_dtype = _STORAGE[storage]
    for l in (2, 16, 24, 64, 4096, 4097, 65536):
        for cap in (96, 128, 200, 256, 768, 1024, 2048, 4096, 8192):
            assert (pscan._pick_chunk_lists(l, cap)
                    == jscan._pick_chunk_lists(l, cap))
            for num_probe in (1, 8, 15, 16, 64, 512):
                for k_scan in (16, 1024, 4096):
                    assert pscan.chunked_pallas_supported(
                        l, cap, 800, num_probe, k_scan, torch_dtype
                    ) == jscan.chunked_pallas_supported(
                        l, cap, 800, num_probe, k_scan, np.dtype(np_dtype)
                    ), (l, cap, num_probe, k_scan)
    for p in range(40):
        assert pscan.hot_list_count(p) == jscan.hot_list_count(p)
    # The 2.1M-spectrum point: C = 2, cw = 1,536, pos_bits 11.
    assert pscan.chunked_pallas_supported(4096, 768, 800, 64, 1024,
                                          torch_dtype) == (storage != "f32")
    assert pscan.chunk_layout(4096, 768) == (2, 1536, 6, 2048, 11)


# --------------------------------------------------------------------- #
# (2) The plain rows + selection vs the JAX function (interpret mode)


def _select_inputs(rng, storage, exact, l=32, cap=128, d=64, b=32, p=16):
    if exact:
        vals = rng.integers(-4, 5, (l, cap, d))
        vectors = vals if storage == "int8" else vals / 8.0
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
    ids = np.arange(l * cap, dtype=np.int32).reshape(l, cap)
    ids[rng.uniform(size=(l, cap)) < 0.2] = -1
    prec = rng.uniform(400, 1200, (l, cap))
    q_prec = rng.uniform(400, 1200, b)
    probes = np.stack([rng.choice(l, p, replace=False) for _ in range(b)])
    return (vectors, ids, prec.astype(np.float32),
            scales.astype(np.float32), queries.astype(np.float32),
            q_prec.astype(np.float32), probes.astype(np.int32))


def _both_selects(inputs, h, k_scan, tol_val, tol_mode, charge=2.0):
    vectors, ids, prec, scales, queries, q_prec, probes = inputs
    p = probes.shape[1]
    hot = np.sort(probes[:, :h], 1) if h else None
    cold = np.sort(probes[:, h:], 1)
    e = jscan.ivf_chunked_scan_select(
        jnp.asarray(vectors), jnp.asarray((ids >= 0).astype(np.int8)),
        jnp.asarray(prec), jnp.asarray(scales), jnp.asarray(queries),
        jnp.asarray(q_prec), jnp.float32(charge), jnp.asarray(cold), p - h,
        k_scan, tol_val, tol_mode,
        hot_ids=None if hot is None else jnp.asarray(hot), interpret=True,
    )
    g = pscan.ivf_chunked_scan_select(
        *(_to_torch(a) for a in (vectors, ids, prec, scales, queries,
                                 q_prec)),
        charge, _to_torch(cold), p - h, k_scan, tol_val, tol_mode,
        hot_ids=None if hot is None else _to_torch(hot),
    )
    return [x.numpy() for x in g], [np.asarray(x) for x in e]


@pytest.mark.parametrize(
    "storage,hot,tol_val,tol_mode,exact",
    [
        ("int8", True, 200.0, "Da", True),
        ("int8", False, 3e5, "ppm", True),
        ("bf16", True, 3e5, "ppm", True),
        ("bf16", False, 200.0, "Da", True),
        ("int8", True, 0.0, "Da", True),
        ("int8", True, 200.0, "Da", False),
        ("bf16", True, 3e5, "ppm", False),
        ("int8", False, 3e5, "ppm", False),
        ("bf16", False, 0.0, "Da", False),
    ],
)
def test_scan_select_matches_jax(storage, hot, tol_val, tol_mode, exact):
    rng = np.random.default_rng(131)
    inputs = _select_inputs(rng, storage, exact, p=16 if hot else 8)
    (g_s, g_pos, g_f), (e_s, e_pos, e_f) = _both_selects(
        inputs, 8 if hot else 0, 200, tol_val, tol_mode)
    # k_eff: 200, or 2 chunks x CK = 192 without hot lists.
    assert g_s.shape == e_s.shape == g_pos.shape == (32, 200 if hot else 192)
    assert g_pos.dtype == np.int64 and g_f.dtype == np.bool_
    assert 0 < np.isfinite(g_s).mean()
    if exact:
        np.testing.assert_array_equal(g_s, e_s)
        np.testing.assert_array_equal(g_pos, e_pos)
        np.testing.assert_array_equal(g_f, e_f)
        return
    assert np.mean(g_f == e_f) >= 0.95
    _lanes_agree((g_s, g_pos), (e_s, e_pos), ~(g_f | e_f))


def _dense_canonical(vectors, ids, scales, queries, probes, k_scan):
    """Canonical dense oracle on exact data: scores in float64 (exact),
    masked outside each query's probes, 16-bit keys, a stable sort on
    descending keys (ties by ascending global position)."""
    l, cap, d = vectors.shape
    v = np.asarray(vectors, np.float64).reshape(l * cap, d)
    qb = queries.astype(ml_dtypes.bfloat16).astype(np.float64)
    s = (qb @ v.T) * scales.reshape(-1)
    mask = np.zeros((len(queries), l), bool)
    np.put_along_axis(mask, probes, True, axis=1)
    ok = np.repeat(mask, cap, axis=1) & (ids.reshape(-1) >= 0)
    s = np.where(ok, s, -np.inf).astype(np.float32)
    keys = pscan._key16(torch.from_numpy(s)).numpy()
    top = np.argsort(-keys, axis=1, kind="stable")[:, :k_scan]
    top_s = pscan._key16_to_f32(
        torch.from_numpy(np.take_along_axis(keys, top, 1))).numpy()
    return np.where(top_s > -np.inf, top, -1), top_s


def test_mass_ties_resolve_canonically():
    """Mass exact-duplicate rows force boundary key ties everywhere; the
    canonical (key desc, position asc) order resolves them, so unflagged
    queries equal the dense oracle and ties alone do not flag."""
    rng = np.random.default_rng(89)
    l, cap, d = 32, 128, 64
    base = rng.integers(-4, 5, (64, d))
    dup = (np.tile(base, (l * cap // 64, 1)).reshape(l, cap, d) / 8.0
           ).astype(ml_dtypes.bfloat16)
    b, p, k_scan = 32, 8, 40  # 40: the boundary lands inside a tie block
    ids = np.arange(l * cap, dtype=np.int32).reshape(l, cap)
    queries = ((base[rng.choice(64, b)] * 8 + rng.integers(-1, 2, (b, d)))
               / 64.0).astype(np.float32)
    scales = np.ones((l, cap), np.float32)
    cents = rng.normal(size=(l, d)).astype(np.float32)
    probes = np.argsort(-(queries @ cents.T), axis=1, kind="stable")[:, :p]
    inputs = (dup, ids, np.zeros((l, cap), np.float32), scales, queries,
              np.zeros(b, np.float32), probes.astype(np.int32))
    (g_s, g_pos, g_f), (e_s, e_pos, e_f) = _both_selects(
        inputs, 0, k_scan, 0.0, "Da", charge=1.0)
    np.testing.assert_array_equal(g_s, e_s)
    np.testing.assert_array_equal(g_pos, e_pos)
    np.testing.assert_array_equal(g_f, e_f)
    want_pos, want_s = _dense_canonical(dup, ids, scales, queries, probes,
                                        k_scan)
    for q in np.nonzero(~g_f)[0]:
        np.testing.assert_array_equal(g_pos[q], want_pos[q], f"query {q}")
        np.testing.assert_array_equal(g_s[q], want_s[q], f"query {q}")
    assert g_f.mean() < 0.2 and (~g_f).sum() > b // 2


def test_truncation_certificate_fires_and_hot_scan_absorbs():
    """One probed list holds more than CK of every query's top-k, all in
    one chunk: the CK cut must flag every query.  Routing that list
    through the exact hot scan removes the truncation: no flags, and the
    dense oracle's results."""
    rng = np.random.default_rng(91)
    l, cap, d = 64, 128, 64
    vals = rng.integers(-4, 5, (l, cap, d))
    qdir = rng.integers(-4, 5, d)
    vals[3] = qdir[None] + rng.integers(-1, 2, (cap, d)) * (
        rng.uniform(size=(cap, d)) < 0.1)  # list 3: 128 near-clones
    vectors = (vals / 8.0).astype(ml_dtypes.bfloat16)
    ids = np.arange(l * cap, dtype=np.int32).reshape(l, cap)
    b, k_scan = 16, 256
    assert pscan.chunked_pallas_supported(l, cap, d, 4, k_scan,
                                          torch.bfloat16)
    queries = ((qdir[None] * 8 + rng.integers(-1, 2, (b, d))) / 64.0
               ).astype(np.float32)
    scales = np.ones((l, cap), np.float32)
    zeros_l = np.zeros((l, cap), np.float32)
    probes = np.tile(np.array([3, 17, 33, 49], np.int32), (b, 1))
    inputs = (vectors, ids, zeros_l, scales, queries, np.zeros(b, np.float32),
              probes)
    (_, _, g_f), (_, _, e_f) = _both_selects(inputs, 0, k_scan, 0.0, "Da",
                                             charge=1.0)
    assert g_f.all() and e_f.all(), "CK truncation must trip the certificate"

    (g_s, g_pos, g_f), (e_s, e_pos, e_f) = _both_selects(
        inputs, 1, cap, 0.0, "Da", charge=1.0)  # list 3 is the hot list
    assert not g_f.any() and not e_f.any()
    np.testing.assert_array_equal(g_s, e_s)
    np.testing.assert_array_equal(g_pos, e_pos)
    want_pos, want_s = _dense_canonical(vectors, ids, scales, queries,
                                        probes, cap)
    np.testing.assert_array_equal(g_pos, want_pos)
    np.testing.assert_array_equal(g_s, want_s)


# --------------------------------------------------------------------- #
# (3) The plain chunked scan vs the JAX one


def _index(rng, storage, exact, n=3000, d=32, l=64, redundancy=2,
           prec=True):
    if exact:
        vectors = (rng.integers(-4, 5, size=(n, d)) / 8.0).astype(np.float32)
    else:
        vectors = _clustered_vectors(rng, n=n, d=d, n_clusters=16)
    p_mz = np.sort(rng.uniform(400, 1200, n)).astype(np.float32)
    index = jivf.IvfIndex.build(
        vectors, IvfConfig(num_list=l, num_probe=8), redundancy=redundancy,
        storage_dtype=_STORAGE[storage][0],
        precursor_mz=p_mz if prec else None,
    )
    return index, vectors, p_mz


def _queries(rng, vectors, p_mz, b, exact):
    rows = rng.choice(len(vectors), b, replace=False)
    if exact:
        queries = (rng.integers(-32, 33, (b, vectors.shape[1])) / 64.0)
    else:
        queries = vectors[rows] + 0.05 * rng.normal(size=(b, vectors.shape[1]))
        queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    return queries.astype(np.float32), p_mz[rows].copy()


@pytest.mark.parametrize("storage,exact", [("int8", True), ("bf16", False),
                                           ("f32", False)])
def test_search_chunked_matches_jax_and_oracle(storage, exact):
    """`list_chunk` 24 does not divide L = 64: the clamped last chunk
    re-reads lists, masks them, and maps stacked to true positions."""
    rng = np.random.default_rng(53)
    index, vectors, p_mz = _index(rng, storage, exact)
    queries, q_prec = _queries(rng, vectors, p_mz, 64, exact)
    port = _port(index)
    blocks = [np.asarray(a) for a in (
        index.padded_vectors, index.padded_ids, index.padded_prec,
        index.padded_scales, index.centroids)]
    p, k, k_scan = 8, 16, 32
    o_s, o_i = pivf._ivf_search_perquery(
        *port._blocks(), torch.from_numpy(queries), torch.from_numpy(q_prec),
        2.0, p, k, k_scan, 50.0, "Da", True,
    )
    o_s, o_i = o_s.numpy(), o_i.numpy()
    for pool_g, list_chunk in ((32, 24), (8, 64)):
        e_s, e_i, e_f = (np.asarray(x) for x in jivf._ivf_search_chunked(
            *(jnp.asarray(a) for a in blocks), jnp.asarray(queries),
            jnp.asarray(q_prec), jnp.float32(2.0), p, k, k_scan, pool_g,
            list_chunk, 50.0, "Da", True,
        ))
        g_s, g_i, g_f = (x.numpy() for x in pivf._ivf_search_chunked(
            *port._blocks(), torch.from_numpy(queries),
            torch.from_numpy(q_prec), 2.0, p, k, k_scan, pool_g, list_chunk,
            50.0, "Da", True,
        ))
        assert g_i.shape == (64, k) and g_f.shape == (64,)
        assert g_f.mean() < 0.2
        clean = ~g_f
        if exact:
            np.testing.assert_array_equal(g_s, e_s)
            np.testing.assert_array_equal(g_i, e_i)
            np.testing.assert_array_equal(g_f, e_f)
            np.testing.assert_array_equal(g_s[clean], o_s[clean])
            np.testing.assert_array_equal(g_i[clean], o_i[clean])
        elif storage == "f32":
            assert np.mean(g_f == e_f) >= 0.95
            assert np.mean(g_i == e_i) >= 0.99
            same = (g_i == e_i) & (g_i >= 0)
            np.testing.assert_allclose(g_s[same], e_s[same], rtol=1e-6)
            for q in np.nonzero(clean)[0]:
                assert set(g_i[q][g_i[q] >= 0]) == set(o_i[q][o_i[q] >= 0])
        else:
            assert np.mean(g_f == e_f) >= 0.95
            rows = clean & ~e_f
            _assert_lanes_agree(g_i[rows], g_s[rows], e_i[rows], e_s[rows])
            _assert_lanes_agree(g_i[clean], g_s[clean], o_i[clean],
                                o_s[clean])
        assert (g_i >= 0).mean() > 0.5


def test_chunked_tie_certificate_and_repair():
    """Mass exact duplicates trip the group-selection tie certificate; the
    repaired search gives the oracle's scores and no duplicate ids."""
    rng = np.random.default_rng(71)
    base = _clustered_vectors(rng, n=100, d=32, n_clusters=8)
    vectors = np.repeat(base, 30, axis=0)  # 30 exact copies of each row
    index = pivf.IvfIndex.build(
        torch.from_numpy(vectors), IvfConfig(num_list=64, num_probe=8),
        device="cpu", redundancy=1, storage_dtype=torch.float32,
    )
    b, k, p = 48, 16, 8
    queries = base[rng.choice(100, b)] + 0.01 * rng.normal(size=(b, 32))
    queries = torch.from_numpy(
        (queries / np.linalg.norm(queries, axis=1, keepdims=True)).astype(
            np.float32))
    zeros = torch.zeros(b)
    _, _, flags = pivf._ivf_search_chunked(
        *index._blocks(), queries, zeros, 1.0, p, k, k, 8, 32, 0.0, "Da",
        False,
    )
    assert flags.any(), "mass ties must trip the certificate"
    o_s, _ = pivf._ivf_search_perquery(
        *index._blocks(), queries, zeros, 1.0, p, k, k, 0.0, "Da", False)
    scores, ids = index._search_chunked(queries, zeros, 1.0, p, k, k, 0.0,
                                        "Da", False)
    assert index._last_chunked_flagged > 0
    for q in range(b):
        row = ids[q][ids[q] >= 0]
        assert len(torch.unique(row)) == len(row), f"query {q} dup ids"
    np.testing.assert_allclose(torch.sort(scores, 1).values.numpy(),
                               torch.sort(o_s, 1).values.numpy(), rtol=1e-6,
                               atol=1e-6)


# --------------------------------------------------------------------- #
# (4) search_device forced into the chunked regimes


def test_plain_chunked_dispatch_end_to_end(monkeypatch):
    """f32 storage beyond the full scan takes the plain chunked scan in
    power-of-two super-tiles of >= 128 queries, with repair; the id sets
    are the full scan's."""
    rng = np.random.default_rng(59)
    index, vectors, p_mz = _index(rng, "f32", False, n=4000)
    queries, q_prec = _queries(rng, vectors, p_mz, 320, False)
    port = _port(index)
    args = dict(q_prec=torch.from_numpy(q_prec), charge=2.0, tol_val=50.0,
                tol_mode="Da")
    want, _ = port.search_device(torch.from_numpy(queries), 16, **args)
    monkeypatch.setattr(pivf, "_FULLSCAN_TRANSIENT", 0)
    monkeypatch.setattr(pivf, "_CHUNK_TQ", 128)
    tiles = _spy(monkeypatch, "_ivf_search_chunked")
    got, _ = port.search_device(torch.from_numpy(queries), 16, **args)
    assert tiles == [128, 128, 64]
    for q in range(320):
        assert set(got[q][got[q] >= 0].tolist()) == set(
            want[q][want[q] >= 0].tolist()), f"query {q}"


def test_plain_chunked_repair_path(monkeypatch):
    """`_tie_unsafe` patched to flag every query: the whole batch goes
    through the per-query repair, and the results are the oracle's."""
    rng = np.random.default_rng(61)
    index, vectors, p_mz = _index(rng, "bf16", False, n=4000)
    queries, _ = _queries(rng, vectors, p_mz, 96, False)
    port = _port(index)
    monkeypatch.setattr(pivf, "_FULLSCAN_TRANSIENT", 0)
    monkeypatch.setattr(ivf_probe, "MAX_PROBE_LANES", 0)
    monkeypatch.setattr(
        pivf, "_tie_unsafe",
        lambda pool, kept: torch.ones(pool.shape[0], dtype=torch.bool))
    tiles = _spy(monkeypatch, "_ivf_search_chunked")
    ids, scores = port.search_device(torch.from_numpy(queries), 16,
                                     num_probe=8)
    assert tiles == [96] and port._last_chunked_flagged == 96
    w_s, w_i = pivf._ivf_search_perquery(
        *port._blocks(), torch.from_numpy(queries), torch.zeros(96), 1.0, 8,
        16, 32, 0.0, "Da", True,
    )
    assert torch.equal(ids, w_i.to(torch.int32))
    assert torch.equal(scores, w_s)


@pytest.mark.parametrize("num_probe,k", [(16, 32), (8, 200)])
def test_fused_dispatch_identical_to_oracle_and_jax(monkeypatch, num_probe,
                                                    k):
    """Tie-saturated exact int8 data through the forced B3 path: ids and
    scores bit-identical to the per-query oracle and to the JAX package's
    forced fused search, with the same certificate flags.  At 16 probes (8
    hot) ties resolve canonically and few queries flag; at 8 probes with
    k = 200 (no hot lists) most queries flag and are repaired."""
    rng = np.random.default_rng(107)
    index, vectors, p_mz = _index(rng, "int8", True, n=5400, d=128,
                                  redundancy=1, prec=False)
    assert index.padded_vectors.shape[1] == 128
    b = 128
    queries, _ = _queries(rng, vectors, p_mz, b, True)
    port = _port(index)
    _force_jax_fused(monkeypatch, index)
    e_ids, e_s = index.search_with_scores(queries, k, num_probe=num_probe,
                                          charge=2.0)
    e_flagged = index._last_chunked_flagged
    _force_port_fused(monkeypatch, port, num_probe)
    tiles = _spy(monkeypatch, "_ivf_chunked_scan_tile")
    ids, scores = port.search_device(torch.from_numpy(queries), k,
                                     num_probe=num_probe, charge=2.0)
    assert tiles == [b]
    assert port._last_chunked_flagged == e_flagged
    if num_probe == 16:
        assert e_flagged <= b // 8
    else:
        assert e_flagged > b // 2
    w_s, w_i = pivf._ivf_search_perquery(
        *port._blocks(), torch.from_numpy(queries), torch.zeros(b), 2.0,
        num_probe, k, k, 0.0, "Da", False,
    )
    assert torch.equal(ids, w_i.to(torch.int32))
    assert torch.equal(scores, w_s)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(e_ids))
    np.testing.assert_array_equal(scores.numpy(), np.asarray(e_s))


def test_fused_dispatch_redundant_ragged_d(monkeypatch):
    """x2 redundant storage (dedup after the fused select) and D = 100 on
    the forced B3 path, in super-tiles of 32 queries, against the JAX
    package's forced fused search (which pads D to 128 with zeros)."""
    rng = np.random.default_rng(101)
    index, vectors, p_mz = _index(rng, "bf16", False, n=2700, d=100,
                                  redundancy=2)
    assert index.padded_vectors.shape[1] == 128
    queries, q_prec = _queries(rng, vectors, p_mz, 80, False)
    args = dict(num_probe=16, charge=2.0, tol_val=100.0, tol_mode="Da")
    port = _port(index)
    _force_jax_fused(monkeypatch, index)
    e_ids, e_s = index.search_with_scores(queries, 16, q_prec=q_prec,
                                          **args)
    _force_port_fused(monkeypatch, port, 16)
    monkeypatch.setattr(pivf, "_CHUNK_TQ", 32)
    tiles = _spy(monkeypatch, "_ivf_chunked_scan_tile")
    ids, scores = port.search_device(torch.from_numpy(queries), 16,
                                     q_prec=torch.from_numpy(q_prec), **args)
    assert tiles == [32, 32, 16]
    _assert_lanes_agree(ids.numpy(), scores.numpy(), np.asarray(e_ids),
                        np.asarray(e_s))


# --------------------------------------------------------------------- #
# (5) What kernel B3 adds outside its scan: the constant row of an
# unprobed (query, chunk) and each chunk's list of probing queries


def _probed_bitmap(rng, kind, b, l, p):
    """(B, L) uint8 probe bitmaps: random probe sets, one probe set shared
    by every query, none, or every list."""
    probed = np.zeros((b, l), np.uint8)
    if kind == "random":
        for q in range(b):
            probed[q, rng.choice(l, min(p, l), replace=False)] = 1
    elif kind == "clustered":
        probed[:, rng.choice(l, min(p, l), replace=False)] = 1
    elif kind == "all":
        probed[:] = 1
    return probed


# (L, cap, D): the layouts of chip_smoke.py's phase-3c cases (2.1M tile,
# bf16 ppm, exact ties, 8 probes, ragged D), cap 384 (C = 4, npc = 6) and
# a one-supergroup chunk (C = 1: 24 survivors, lanes 24-95 pad with -1).
@pytest.mark.parametrize("l,cap,d", [
    (4096, 768, 4), (1024, 256, 8), (256, 256, 8), (512, 256, 8),
    (128, 256, 100), (64, 384, 16), (3, 256, 16),
])
def test_unprobed_row_equals_plain_rows(l, cap, d):
    rng = np.random.default_rng(l + cap)
    b = 3
    c, cw, npc, n_chunks, pos_bits = pscan.chunk_layout(l, cap)
    vectors = torch.from_numpy(
        rng.integers(-127, 128, (l, cap, d)).astype(np.int8))
    ids = torch.arange(l * cap, dtype=torch.int32).view(l, cap)
    prec = torch.from_numpy(rng.uniform(400, 1200, (l, cap)).astype(
        np.float32))
    scales = torch.full((l, cap), 0.01)
    queries = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32))
    q_prec = torch.full((b,), 800.0)
    probed = torch.from_numpy(_probed_bitmap(rng, "random", b, l,
                                             max(1, l // 8)))
    probed[0] = 0  # query 0 probes nothing
    rows = pscan.ivf_chunked_scan_rows_plain(
        vectors, ids, prec, scales, queries, q_prec, 2.0, probed, 0.0, "Da")
    hit = probed.view(b, n_chunks, c).amax(2) > 0
    assert (~hit).sum() > 0
    want = pscan.unprobed_row(l, cap)
    assert want.shape == (pscan.LANES,) and want.dtype == torch.int32
    assert torch.equal(rows[~hit], want.expand(int((~hit).sum()), -1))
    # Lane 0 of a probed chunk with a finite score ranks above it.
    finite = hit & ((rows[..., 0] >> pos_bits) > pscan._KEY_NEG_INF)
    assert bool((rows[..., 0][finite] > want[0]).all())
    assert int((want[pscan.CK + npc:] == -1).sum()) == pscan.LANES - (
        pscan.CK + npc)
    assert int((want[:pscan.CK] >= 0).sum()) == min(pscan.CK,
                                                    npc * pscan.M_RANKS)


@pytest.mark.parametrize("kind", ["random", "clustered", "empty", "all"])
@pytest.mark.parametrize("l,c", [(64, 1), (64, 2), (128, 8)])
def test_chunk_query_lists_cover_each_probed_pair_once(kind, l, c):
    rng = np.random.default_rng(7 * l + c)
    b = 37
    probed = _probed_bitmap(rng, kind, b, l, 6)
    lists, counts = pscan.chunk_query_lists(torch.from_numpy(probed), c)
    n_chunks = l // c
    assert lists.shape == (n_chunks, b) and counts.shape == (n_chunks,)
    assert lists.dtype == counts.dtype == torch.int32
    assert lists.is_contiguous()
    want = {(j, q) for q in range(b) for j in range(n_chunks)
            if probed[q, j * c:(j + 1) * c].any()}
    got = []
    for j in range(n_chunks):
        qs = lists[j, :counts[j]].tolist()
        assert qs == sorted(set(qs)), "ascending, each query once"
        got += [(j, q) for q in qs]
    assert len(got) == len(set(got)) and set(got) == want
    assert int(counts.sum()) == len(want)
    if kind == "empty":
        assert int(counts.sum()) == 0
    if kind == "all":
        assert bool((counts == b).all())


@pytest.mark.parametrize("kind", ["random", "clustered"])
def test_rows_from_probed_pairs_equal_plain(kind):
    """The kernel's decomposition on the CPU: the plain rows of each
    chunk's probing queries alone, the constant row everywhere else,
    equal the plain rows of the whole batch."""
    rng = np.random.default_rng(5)
    inputs = _select_inputs(rng, "bf16", False, l=32, cap=128, d=40, b=24)
    vectors, ids, prec, scales, queries, q_prec, _ = (
        _to_torch(a) for a in inputs)
    l, cap, _ = vectors.shape
    c, _, _, n_chunks, _ = pscan.chunk_layout(l, cap)
    probed = torch.from_numpy(_probed_bitmap(rng, kind, 24, l, 5))
    args = (2.0, probed, 50.0, "Da")
    want = pscan.ivf_chunked_scan_rows_plain(vectors, ids, prec, scales,
                                             queries, q_prec, *args)
    got = pscan.unprobed_row(l, cap).repeat(24, n_chunks, 1)
    lists, counts = pscan.chunk_query_lists(probed, c)
    for j in range(n_chunks):
        qs = lists[j, :counts[j]].long()
        if len(qs):
            got[qs, j] = pscan.ivf_chunked_scan_rows_plain(
                vectors, ids, prec, scales, queries[qs], q_prec[qs], 2.0,
                probed[qs], 50.0, "Da")[:, j]
    assert torch.equal(got, want)
