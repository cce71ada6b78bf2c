"""PyTorch certificate rescoring vs the JAX `rescore_candidate_matrix`.

Both packages get the same NumPy-made corpora (from `test_rescore`): the
sparse and the conflict corpus, a tiny `top_t`, and the bound-inflating
corpus that forces the t0 -> top_t -> full-C escalation.  Best indices
must be identical; scores agree at rtol 1e-5 (float32 sums taken in
another order), and n_candidates exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ann_solo_tpu.ops.rescore import (
    _stage1_bounds as jax_stage1,
    rescore_candidate_matrix as jax_rescore,
)
from ann_solo_tpu_torch.ops import rescore as pt_rescore
from ann_solo_tpu_torch.ops.shifted_dot import shifted_dot_scores

from test_rescore import _spectra


def _corpus(conflict, seed, b=24, n_lib=200, c=16):
    rng = np.random.default_rng(seed)
    q_mz, q_int, _, q_prec = _spectra(rng, b, conflict=conflict)
    l_mz, l_int, l_ann, l_prec = _spectra(rng, n_lib, conflict=conflict)
    cand = rng.integers(0, n_lib, (b, c)).astype(np.int32)
    cand[rng.random((b, c)) < 0.1] = -1
    for i in range(b):
        row = i % n_lib
        l_mz[row] = q_mz[i] + rng.normal(0, 0.004, q_mz[i].shape).astype(
            np.float32
        )
        l_prec[row] = q_prec[i]
        cand[i, rng.integers(0, c)] = row
    return (q_mz, q_int, q_prec, l_mz, l_int, l_ann, l_prec), cand


def _escalation_corpus():
    """Bound-inflating candidates (test_rescore_ladder_escalation_exact):
    every t0-th bound exceeds the winner, so the ladder runs to full C."""
    rng = np.random.default_rng(13)
    b, n_lib, c, k = 8, 128, 64, 8
    base = rng.uniform(400, 800, b).astype(np.float32)
    q_mz = np.sort(
        base[:, None] + rng.uniform(0, 0.03, (b, k)).astype(np.float32),
        axis=1,
    )
    q_int = np.full((b, k), 1.0 / np.sqrt(k), np.float32)
    q_prec = rng.uniform(400, 1200, b).astype(np.float32)
    l_mz = np.sort(
        rng.uniform(100, 1500, (n_lib, k)).astype(np.float32), axis=1
    )
    owners = rng.integers(0, b, n_lib)
    strengths = rng.uniform(0.5, 1.0, n_lib).astype(np.float32)
    for j in range(n_lib):
        l_mz[j, k // 2] = base[owners[j]] + 0.015
    l_mz = np.sort(l_mz, axis=1)
    l_int = np.full((n_lib, k), 0.1, np.float32)
    for j in range(n_lib):
        pos = int(np.argmin(np.abs(l_mz[j] - (base[owners[j]] + 0.015))))
        l_int[j, pos] = strengths[j]
    l_int /= np.linalg.norm(l_int, axis=1, keepdims=True)
    l_ann = np.zeros((n_lib, k), np.int32)
    l_prec = q_prec[owners] + rng.uniform(-200, 200, n_lib).astype(
        np.float32
    )
    cand = np.stack([
        rng.permutation(np.nonzero(owners == i % b)[0])[:c]
        if (owners == i % b).sum() >= c
        else rng.integers(0, n_lib, c)
        for i in range(b)
    ]).astype(np.int32)
    return (q_mz, q_int, q_prec, l_mz, l_int, l_ann, l_prec), cand


def _compare(arrays, cand, **kw):
    frag_tol, num_shifts, allow_shift = 0.02, 3, True
    exp_idx, exp_score, exp_n = jax_rescore(
        *(jnp.asarray(a) for a in arrays), jnp.asarray(cand),
        frag_tol, num_shifts, allow_shift, use_pallas=False, **kw,
    )
    got_idx, got_score, got_n = pt_rescore.rescore_candidate_matrix(
        *(torch.from_numpy(a) for a in arrays), torch.from_numpy(cand),
        frag_tol, num_shifts, allow_shift, **kw,
    )
    np.testing.assert_array_equal(got_idx, exp_idx)
    np.testing.assert_allclose(got_score, exp_score, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got_n, exp_n)
    return got_idx, got_score


@pytest.mark.parametrize(
    "conflict,seed,top_t",
    [(False, 5, 4), (True, 7, 4), (True, 11, 1)],
    ids=["sparse", "conflict", "tiny_top_t"],
)
def test_rescore_matches_jax(conflict, seed, top_t):
    arrays, cand = _corpus(conflict, seed)
    _compare(arrays, cand, top_t=top_t)


def test_escalation_ladder_matches_jax():
    arrays, cand = _escalation_corpus()
    # The corpus must really escalate: the t0 certificate fails somewhere.
    t = torch.from_numpy
    ub = pt_rescore._stage1_bounds(
        *(t(a) for a in arrays), t(cand).long(), 0.02, 3, True, 16
    )
    _, _, cert, _ = pt_rescore._stage2_dense(
        *(t(a) for a in arrays), ub, t(cand).long(), 4, 0.02, 3, True
    )
    assert not bool(cert.all())
    _compare(arrays, cand, top_t=16, t0=4)


def test_stage1_bounds_match_jax_and_are_sound():
    arrays, cand = _corpus(True, 23)
    exp = np.asarray(jax_stage1(
        *(jnp.asarray(a) for a in arrays), jnp.asarray(cand),
        0.02, 3, True, 8,
    ))
    t = torch.from_numpy
    got = pt_rescore._stage1_bounds(
        *(t(a) for a in arrays), t(cand).long(), 0.02, 3, True, 8
    ).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(exp))
    finite = np.isfinite(exp)
    np.testing.assert_allclose(got[finite], exp[finite], rtol=1e-6)
    # Soundness: every pair's bound is >= its greedy score.
    q_mz, q_int, q_prec, l_mz, l_int, l_ann, l_prec = arrays
    rows, cols = np.nonzero(cand >= 0)
    ids = cand[rows, cols]
    scores = shifted_dot_scores(
        t(q_mz[rows]), t(q_int[rows]), t(l_mz[ids]), t(l_int[ids]),
        t(l_ann[ids]), t(q_prec[rows]), t(l_prec[ids]),
        torch.full((len(ids),), 2, dtype=torch.int32),
        torch.ones(len(ids), dtype=torch.bool), 0.02, 3, True,
    ).numpy()
    assert np.all(got[rows, cols] >= scores)
