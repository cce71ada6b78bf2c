"""Shifted-dot-product rescoring: the plain PyTorch version.

Port of `ann_solo_tpu/ops/shifted_dot.py` (semantics of the reference
`SpectrumMatch.cpp:8-133`).  For a batch of (query, candidate) pairs:

1.  the (K x K) match-score matrix: entry (i, j) is
    ``mult * q_int[i] * c_int[j]`` with ``mult`` the maximum over active
    shifts s of the annotation rule (shift 0: 1; shift s >= 1: 1 if the
    candidate peak's annotation charge is s, 2/3 if it is 0, else 0).
    Shift s has m/z offset ``prec_diff / s`` and applies only when
    ``allow_shift``, ``|prec_diff| >= tol`` and ``s <= charge``.  Without
    shifts (``not (allow_shift and num_shifts > 1)``) the entry follows
    the direct rule ``(q_int[i] if |q_mz[i] - c_mz[j]| <= tol else 0) *
    c_int[j]``, as the reference computes it: there its multiplier is a
    converted predicate, which XLA rewrites into that select, so an entry
    whose m/z does not match is 0 even where q_int is NaN or +-inf;
2.  the greedy one-to-one assignment: an iterated argmax over the
    flattened matrix, ties to the lowest flat index, zeroing the chosen
    row and column, until no positive entry is left.  A pair with a NaN
    entry takes nothing: its first argmax is NaN, which is not > 0.

The CUDA kernel (`csrc/shifted_dot.cu`) runs step 2 over each pair's
positive entries alone (`greedy_over_positives`, the same function).
This is what the kernel must compute: the
term order ``(mult * q_int) * c_int`` and the sequential ``total += best``
in selection order are kept, so the kernel's totals equal these bit for
bit.  Every float division here divides by a tensor, never by a Python
scalar: PyTorch's CUDA ``div`` turns a CPU-scalar divisor into a multiply
by its reciprocal, which is not the IEEE quotient the kernel computes.
"""

from __future__ import annotations

import torch

TWO_THIRDS = 2.0 / 3.0


def pair_score_matrix(
    q_mz: torch.Tensor,  # (P, K) float32
    q_int: torch.Tensor,  # (P, K) float32
    c_mz: torch.Tensor,  # (P, K) float32
    c_int: torch.Tensor,  # (P, K) float32
    c_ann: torch.Tensor,  # (P, K) int32 annotation charge (0 = none)
    q_prec_mz: torch.Tensor,  # (P,)
    c_prec_mz: torch.Tensor,  # (P,)
    charge: torch.Tensor,  # (P,) int32 candidate precursor charge
    fragment_mz_tolerance: float,
    num_shifts: int,
    allow_shift: bool,
) -> torch.Tensor:
    """(P, K, K) float32 match-score matrices (0 where nothing matches)."""
    f32 = torch.float32
    tol = torch.tensor(fragment_mz_tolerance, dtype=f32, device=q_mz.device)
    prec_diff = (q_prec_mz - c_prec_mz) * charge.to(f32)  # (P,)
    shifted_active = allow_shift & (prec_diff.abs() >= tol)  # (P,)

    diff0 = q_mz[:, :, None] - c_mz[:, None, :]
    if not (allow_shift and num_shifts > 1):
        # The direct rule, chosen by the flags alone (a pair with no
        # active shift under `allow_shift` keeps the product).
        zero = torch.zeros((), dtype=f32, device=q_mz.device)
        return torch.where(diff0.abs() <= tol, q_int[:, :, None],
                           zero) * c_int[:, None, :]
    best_mult = (diff0.abs() <= tol).to(f32)
    ann = c_ann[:, None, :]  # (P, 1, K)
    one = torch.ones((), dtype=f32, device=q_mz.device)
    zero = torch.zeros((), dtype=f32, device=q_mz.device)
    two_thirds = torch.tensor(TWO_THIRDS, dtype=f32, device=q_mz.device)
    for s in range(1, num_shifts):
        s_t = torch.tensor(float(s), dtype=f32, device=q_mz.device)
        offset = prec_diff / s_t  # (P,) IEEE quotient
        within = (diff0 - offset[:, None, None]).abs() <= tol
        mult = torch.where(
            ann == s, one, torch.where(ann == 0, two_thirds, zero)
        )  # (P, 1, K)
        active = (shifted_active & (s <= charge))[:, None, None]
        best_mult = torch.maximum(
            best_mult, torch.where(within & active, mult, zero)
        )
    return best_mult * q_int[:, :, None] * c_int[:, None, :]


def greedy_assignment(scores: torch.Tensor):
    """Greedy one-to-one assignment over (P, Kq, Kc) score matrices.

    Returns (total (P,) float32, match_q (P, M), match_c (P, M)) with
    M = min(Kq, Kc): the (query peak, candidate peak) pairs in selection
    order, -1 padded.
    """
    p, kq, kc = scores.shape
    n_iter = min(kq, kc)
    kk = kq * kc
    flat = scores.reshape(p, kk).clone()
    dev = scores.device
    col_ids = torch.arange(kk, dtype=torch.int64, device=dev)[None, :]
    row_of = col_ids // kc
    col_of = col_ids - row_of * kc
    total = torch.zeros(p, dtype=torch.float32, device=dev)
    match_q = torch.full((p, n_iter), -1, dtype=torch.int64, device=dev)
    match_c = torch.full((p, n_iter), -1, dtype=torch.int64, device=dev)
    sentinel = torch.full((), kk, dtype=torch.int64, device=dev)
    for step in range(n_iter):
        best = flat.amax(dim=1)  # (P,)
        idx = torch.where(flat >= best[:, None], col_ids, sentinel).amin(1)
        take = best > 0.0
        if not bool(take.any()):
            break
        total = total + torch.where(take, best, torch.zeros_like(best))
        i = idx // kc
        j = idx - i * kc
        match_q[:, step] = torch.where(take, i, -1)
        match_c[:, step] = torch.where(take, j, -1)
        blocked = (row_of == i[:, None]) | (col_of == j[:, None])
        flat = torch.where(blocked & take[:, None], 0.0, flat)
    return total, match_q, match_c


def greedy_over_positives(scores: torch.Tensor):
    """`greedy_assignment` computed the way the CUDA kernel does it: over
    each pair's positive entries alone.

    Walking them in (value desc, flat index asc) order and taking each
    entry whose row and column are still free picks the same entries in
    the same order as the iterated argmax: at each of its steps the live
    entries are the positive ones with a free row and column, and an entry
    skipped once never comes alive again.  A pair with a NaN entry takes
    nothing, as the kernel flags it while it compacts.  Same outputs as
    `greedy_assignment`, bit for bit (``total += value`` in selection
    order).  For tests and `chip_smoke.py`; the search never calls it."""
    p, kq, kc = scores.shape
    dev = scores.device
    flat = scores.reshape(p, kq * kc)
    clean = ~torch.isnan(flat).any(1)
    n_max = int((flat > 0).sum(1).max()) if p else 0
    # A stable sort of the negated values: ties keep the lower flat index.
    order = torch.sort(-flat, dim=1, stable=True).indices[:, :n_max]
    values = flat.gather(1, order)
    pairs = torch.arange(p, device=dev)
    row_free = torch.ones((p, kq), dtype=torch.bool, device=dev)
    col_free = torch.ones((p, kc), dtype=torch.bool, device=dev)
    total = torch.zeros(p, dtype=torch.float32, device=dev)
    n_iter = min(kq, kc)
    match_q = torch.full((p, n_iter + 1), -1, dtype=torch.int64, device=dev)
    match_c = torch.full((p, n_iter + 1), -1, dtype=torch.int64, device=dev)
    taken = torch.zeros(p, dtype=torch.int64, device=dev)
    for t in range(n_max):
        v = values[:, t]
        i = order[:, t] // kc
        j = order[:, t] - i * kc
        take = (v > 0.0) & clean & row_free[pairs, i] & col_free[pairs, j]
        total = total + torch.where(take, v, torch.zeros_like(v))
        # Pairs that take nothing write -1 into the spare column n_iter.
        slot = torch.where(take, taken, n_iter)
        match_q[pairs, slot] = torch.where(take, i, -1)
        match_c[pairs, slot] = torch.where(take, j, -1)
        row_free[pairs, i] &= ~take
        col_free[pairs, j] &= ~take
        taken += take
    return total, match_q[:, :n_iter], match_c[:, :n_iter]


def match_table(match_q: torch.Tensor, match_c: torch.Tensor, k: int):
    """(P, K) int32 table: entry i is the candidate peak matched to query
    peak i, -1 when unmatched (the kernel's output layout)."""
    p = match_q.shape[0]
    out = torch.full((p, k + 1), -1, dtype=torch.int64, device=match_q.device)
    # Unmatched steps write -1 into the spare column k; matched query
    # peaks are distinct, so every other column is written at most once.
    out.scatter_(1, torch.where(match_q >= 0, match_q, k), match_c)
    return out[:, :k].to(torch.int32)


def shifted_dot_full_plain(
    q_mz, q_int, c_mz, c_int, c_ann, q_prec_mz, c_prec_mz, charge,
    fragment_mz_tolerance: float, num_shifts: int, allow_shift: bool,
):
    """(total (P,) float32, match (P, K) int32): the kernel's contract."""
    scores = pair_score_matrix(
        q_mz, q_int, c_mz, c_int, c_ann, q_prec_mz, c_prec_mz, charge,
        fragment_mz_tolerance, num_shifts, allow_shift,
    )
    total, match_q, match_c = greedy_assignment(scores)
    return total, match_table(match_q, match_c, q_mz.shape[1])


def shifted_dot_scores(
    q_mz, q_int, c_mz, c_int, c_ann, q_prec_mz, c_prec_mz, charge,
    pair_valid: torch.Tensor,  # (P,) bool -- padding pairs score -inf
    fragment_mz_tolerance: float, num_shifts: int, allow_shift: bool,
) -> torch.Tensor:
    """Score a batch of (query, candidate) pairs. Invalid pairs -> -inf."""
    scores = pair_score_matrix(
        q_mz, q_int, c_mz, c_int, c_ann, q_prec_mz, c_prec_mz, charge,
        fragment_mz_tolerance, num_shifts, allow_shift,
    )
    total, _, _ = greedy_assignment(scores)
    return torch.where(pair_valid, total, float("-inf"))


def shifted_dot_best_match(
    q_mz, q_int, c_mz, c_int, c_ann, q_prec_mz, c_prec_mz, charge,
    fragment_mz_tolerance: float, num_shifts: int, allow_shift: bool,
):
    """Scores plus the greedy peak matches per pair (selection order)."""
    scores = pair_score_matrix(
        q_mz, q_int, c_mz, c_int, c_ann, q_prec_mz, c_prec_mz, charge,
        fragment_mz_tolerance, num_shifts, allow_shift,
    )
    return greedy_assignment(scores)
