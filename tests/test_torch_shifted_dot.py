"""PyTorch shifted-dot (plain version, the kernel's CPU route) vs JAX.

Inputs are made with NumPy from a seed and fed to both packages.
Tolerance: rtol 2e-5, atol 1e-6 on totals (the JAX tests' own bound
between its XLA and Pallas forms); peak-match sets must be identical.
"""

import numpy as np
import pytest
import torch

from ann_solo_tpu.ops.shifted_dot import (
    shifted_dot_best_match as jax_best_match,
    shifted_dot_oracle,
    shifted_dot_scores as jax_scores,
)
from ann_solo_tpu.ops.shifted_dot_pallas import (
    PAIR_BLOCK,
    gather_pair_scores as jax_gather_pair_scores,
    shifted_dot_pallas_full,
)
from ann_solo_tpu_torch.ops import shifted_dot as pt
from ann_solo_tpu_torch.ops import shifted_dot_cuda
from ann_solo_tpu_torch.ops.shifted_dot_cuda import (
    gather_pair_scores,
    shifted_dot_best_match_auto,
    shifted_dot_full,
)

from test_shifted_dot import _pad, _random_pair

RTOL, ATOL = 2e-5, 1e-6


def _batch(seed, n, k, charge, kq=None, kc=None, mods=(0.0, 16.0)):
    rng = np.random.default_rng(seed)
    pairs = [
        _random_pair(rng, k, charge, mod_mass=rng.choice(mods))
        for _ in range(n)
    ]
    kq = kq or k + 2
    kc = kc or k + 2
    return (
        _pad([p[0] for p in pairs], kq), _pad([p[1] for p in pairs], kq),
        _pad([p[2] for p in pairs], kc), _pad([p[3] for p in pairs], kc),
        _pad([p[4] for p in pairs], kc),
        np.asarray([p[5] for p in pairs], np.float32),
        np.asarray([p[6] for p in pairs], np.float32),
        np.full(n, charge, np.int32),
    )


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _match_sets(match):
    return [
        {(i, int(row[i])) for i in range(len(row)) if row[i] >= 0}
        for row in np.asarray(match)
    ]


@pytest.mark.parametrize("allow_shift", [False, True])
def test_plain_scores_match_jax(allow_shift):
    arrays = _batch(19, 64, 30, 3)
    charge = 3
    valid = np.ones(64, bool)
    valid[5] = False
    expected = np.asarray(jax_scores(
        *arrays, valid, 0.02, charge + 1, allow_shift
    ))
    got = pt.shifted_dot_scores(
        *_t(arrays), torch.from_numpy(valid), 0.02, charge + 1, allow_shift
    ).numpy()
    assert got[5] == -np.inf
    np.testing.assert_allclose(got, expected, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("allow_shift", [False, True])
def test_full_matches_pallas_interpret(allow_shift):
    """The wrapper's CPU route vs the Pallas kernel itself (interpret
    mode): totals and the (P, K) match tables."""
    charge = 2
    arrays = _batch(29, PAIR_BLOCK, 30, charge, kq=32, kc=32)
    exp_total, exp_match = shifted_dot_pallas_full(
        *arrays, 0.02, charge + 1, allow_shift, interpret=True
    )
    total, match = shifted_dot_full(
        *_t(arrays), 0.02, charge + 1, allow_shift
    )
    assert match.dtype == torch.int32 and match.shape == (PAIR_BLOCK, 32)
    np.testing.assert_allclose(
        total.numpy(), np.asarray(exp_total), rtol=RTOL, atol=ATOL
    )
    assert _match_sets(match) == _match_sets(exp_match)


def test_best_match_auto_sets_match_jax():
    charge = 3
    arrays = _batch(31, 48, 28, charge, mods=(0.0, 16.0, 79.97))
    exp_total, exp_q, exp_c = jax_best_match(
        *arrays, 0.02, charge + 1, True
    )
    total, match_q, match_c = shifted_dot_best_match_auto(
        *_t(arrays), 0.02, charge + 1, True
    )
    np.testing.assert_allclose(
        total.numpy(), np.asarray(exp_total), rtol=RTOL, atol=ATOL
    )
    exp_q, exp_c = np.asarray(exp_q), np.asarray(exp_c)
    # The plain version returns the pairs in the same selection order.
    _, sel_q, sel_c = pt.shifted_dot_best_match(
        *_t(arrays), 0.02, charge + 1, True
    )
    np.testing.assert_array_equal(sel_q.numpy(), exp_q)
    np.testing.assert_array_equal(sel_c.numpy(), exp_c)
    for p in range(48):
        got = {
            (int(a), int(b))
            for a, b in zip(match_q[p].numpy(), match_c[p].numpy()) if a >= 0
        }
        exp = {(int(a), int(b)) for a, b in zip(exp_q[p], exp_c[p]) if a >= 0}
        assert got == exp, f"pair {p}"


def test_plain_matches_oracle():
    """Against the scalar C++-faithful oracle, shift on."""
    charge = 2
    arrays = _batch(41, 12, 24, charge, mods=(0.0, 16.0, 79.97))
    total, match = shifted_dot_full(*_t(arrays), 0.02, charge + 1, True)
    for p in range(12):
        n = 24
        score, pairs = shifted_dot_oracle(
            arrays[0][p, :n], arrays[1][p, :n], arrays[2][p, :n],
            arrays[3][p, :n], arrays[4][p, :n],
            arrays[5][p], arrays[6][p], charge, 0.02, True,
        )
        np.testing.assert_allclose(total[p].item(), score, rtol=RTOL,
                                   atol=ATOL)
        assert _match_sets(match[p:p + 1, :n])[0] == set(pairs)


def test_gather_pair_scores_unequal_widths():
    """Query and library peak widths differ (24 vs 32); the dispatcher
    pads to one width, like the JAX one."""
    rng = np.random.default_rng(37)
    b, n_lib, kq, kc = 16, 40, 24, 32
    q_mz = np.sort(rng.uniform(100, 1500, (b, kq)), axis=1).astype(np.float32)
    q_int = rng.uniform(0.05, 1, (b, kq)).astype(np.float32)
    q_prec = rng.uniform(400, 1200, b).astype(np.float32)
    l_mz = np.sort(rng.uniform(100, 1500, (n_lib, kc)), axis=1).astype(
        np.float32
    )
    l_mz[:b, :kq] = q_mz + rng.normal(0, 0.005, (b, kq)).astype(np.float32)
    l_mz = np.sort(l_mz, axis=1)
    l_int = rng.uniform(0.05, 1, (n_lib, kc)).astype(np.float32)
    l_ann = rng.integers(0, 3, (n_lib, kc)).astype(np.int32)
    l_prec = rng.uniform(400, 1200, n_lib).astype(np.float32)
    pair_q = rng.integers(0, b, 256).astype(np.int32)
    pair_c = rng.integers(0, n_lib, 256).astype(np.int32)
    pair_c[:b] = np.arange(b)
    pair_q[:b] = np.arange(b)
    valid = rng.random(256) > 0.1
    for allow_shift in (False, True):
        expected = np.asarray(jax_gather_pair_scores(
            q_mz, q_int, q_prec, l_mz, l_int, l_ann, l_prec,
            pair_q, pair_c, valid, 0.02, 3 if allow_shift else 1,
            allow_shift, False,
        ))
        got = gather_pair_scores(
            *_t((q_mz, q_int, q_prec, l_mz, l_int, l_ann, l_prec)),
            torch.from_numpy(pair_q.astype(np.int64)),
            torch.from_numpy(pair_c.astype(np.int64)),
            torch.from_numpy(valid), 0.02, 3 if allow_shift else 1,
            allow_shift,
        ).numpy()
        np.testing.assert_allclose(got, expected, rtol=RTOL, atol=ATOL)


def test_wrapper_rejects_bad_inputs():
    arrays = _t(_batch(3, 4, 24, 2))
    bad_dtype = list(arrays)
    bad_dtype[4] = bad_dtype[4].to(torch.int64)
    with pytest.raises(TypeError):
        shifted_dot_full(*bad_dtype, 0.02, 3, True)
    bad_shape = list(arrays)
    bad_shape[2] = bad_shape[2][:, :5].contiguous()
    with pytest.raises(ValueError):
        shifted_dot_full(*bad_shape, 0.02, 3, True)
    strided = list(arrays)
    strided[0] = torch.cat([strided[0], strided[0]], 1)[:, ::2]
    with pytest.raises(ValueError):
        shifted_dot_full(*strided, 0.02, 3, True)


def test_wide_peaks_take_plain_path(monkeypatch):
    """More than 128 peaks (the JAX package's width rule sends them to its
    XLA path): CPU tensors take the plain version, which agrees with the
    JAX scores; CUDA tensors would take the kernel's wide branch, chosen
    from K alone without loading the library."""
    monkeypatch.setattr(shifted_dot_cuda, "_library", lambda: pytest.fail(
        "the library was loaded"))
    charge = 2
    arrays = _batch(5, 4, 120, charge, kq=136, kc=136)
    expected = np.asarray(jax_scores(
        *arrays, np.ones(4, bool), 0.02, charge + 1, True
    ))
    total, match = shifted_dot_full(*_t(arrays), 0.02, charge + 1, True)
    assert match.shape == (4, 136)
    np.testing.assert_allclose(total.numpy(), expected, rtol=RTOL,
                               atol=ATOL)
    assert shifted_dot_cuda.branch(128) == "registers"
    for k in (129, 136, 300, 1024, 70_000):
        assert shifted_dot_cuda.branch(k) == "wide"


@pytest.mark.parametrize("k", [129, 300, 1024])
def test_plain_matches_jax_wide(k):
    """At K = 129, 300 and 1,024 the plain version (the kernel's CPU
    route) against the JAX package's XLA path: totals within the stated
    tolerance and the same peak pairs in the same selection order."""
    charge = 3
    n = 16 if k < 1024 else 3
    arrays = _batch(60 + k, n, k - 2, charge, mods=(0.0, 16.0, 79.97))
    assert arrays[0].shape == (n, k)
    exp_total, exp_q, exp_c = jax_best_match(*arrays, 0.02, charge + 1, True)
    total, sel_q, sel_c = pt.shifted_dot_best_match(
        *_t(arrays), 0.02, charge + 1, True)
    np.testing.assert_allclose(total.numpy(), np.asarray(exp_total),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(sel_q.numpy(), np.asarray(exp_q))
    np.testing.assert_array_equal(sel_c.numpy(), np.asarray(exp_c))
    full_total, table = shifted_dot_full(*_t(arrays), 0.02, charge + 1, True)
    assert torch.equal(full_total, total)
    assert _match_sets(table) == _match_sets(pt.match_table(
        sel_q, sel_c, k))


# --------------------------------------------------------------------- #
# The kernel's decomposition: the greedy over compacted positive entries


def _chip_smoke():
    """`chip_smoke.py` (repo root) as a module, for its pair generator."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# (pairs, query peaks, library peaks, charge, ties, tolerance, zero
# intensities): chip_smoke's shapes, all-zero pairs, and dense pairs (a
# tolerance wider than the m/z range: every entry positive).
@pytest.mark.parametrize("p,kq,kc,charge,ties,tol,zero", [
    (200, 20, 20, 2, False, 0.04, False),
    (200, 20, 20, 2, True, 0.04, False),
    (200, 50, 50, 2, False, 0.04, False),
    (200, 50, 50, 2, True, 0.04, False),
    (64, 128, 128, 2, False, 0.04, False),
    (64, 128, 128, 3, True, 0.04, False),
    (200, 50, 32, 3, True, 0.04, False),
    (32, 50, 50, 2, False, 0.04, True),
    (16, 50, 50, 2, False, 5000.0, False),
    (16, 20, 20, 2, True, 5000.0, False),
], ids=["k20", "k20_ties", "k50", "k50_ties", "k128", "k128_ties_c3",
        "unequal_ties", "all_zero", "dense_k50", "dense_k20_ties"])
def test_greedy_over_positives_is_the_greedy(p, kq, kc, charge, ties, tol,
                                             zero):
    """Walking the positive entries in (value desc, flat index asc) order
    gives `greedy_assignment`'s picks in its order, and its totals and
    match tables bit for bit."""
    cs = _chip_smoke()
    from ann_solo_tpu_torch.ops.shifted_dot_cuda import pad_peaks

    rng = np.random.default_rng(p * 1000 + kq + kc + charge)
    arrays = _t(cs.synth_pairs(rng, p, kq, kc, charge, ties))
    if zero:
        arrays[1].zero_()
        arrays[3].zero_()
    qm, qi, cm, ci, ca = pad_peaks(*arrays[:5])
    args = (qm, qi, cm, ci, ca, *arrays[5:], tol, charge + 1, True)
    scores = pt.pair_score_matrix(*args)
    n_pos = (scores > 0).reshape(p, -1).sum(1)
    if zero:
        assert int(n_pos.max()) == 0
    elif tol > 100:
        assert bool((n_pos == scores.shape[1] * scores.shape[2]).all())
    else:
        assert 0 < float(n_pos.float().mean()) < 64
    want = pt.greedy_assignment(scores)
    got = pt.greedy_over_positives(scores)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    total, table = pt.shifted_dot_full_plain(*args)
    assert torch.equal(got[0], total)
    assert torch.equal(pt.match_table(got[1], got[2], qm.shape[1]), table)
    if ties:  # equal scores compete, so the tie rule is exercised
        assert int(n_pos.sum()) > len(torch.unique(scores[scores > 0]))
