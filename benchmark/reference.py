"""The plain reference of the open search's answers, in plain PyTorch.

It follows the shifted dot product of ANN-SoLo (`SpectrumMatch.cpp`) as
the port states it, and imports nothing of the port:

* the entry of query peak i and library peak j is
  ``(mult * q_int[i]) * c_int[j]``, where `mult` is the largest of the
  windows the pair passes: the direct window ``|q_mz - c_mz| <= tol``
  (multiplier 1) and, when shifts are allowed and ``|prec_diff| >= tol``
  with ``prec_diff = (q_prec - c_prec) * charge``, the window of each
  shift s = 1 .. charge at offset ``prec_diff / s`` (multiplier 1 when
  the library peak's annotation charge is s, 2/3 when it has none, else
  0).  Precursors are float32 on both sides, as the port keeps them on
  the card;
* the score is the greedy one-to-one assignment: take the largest
  positive entry (ties to the lowest flat index i * K + j), clear its
  row and column, repeat; the score is the sum of the taken entries in
  the order taken, in float32; the matches are the taken (i, j) in that
  order.

`value_dtype` computes the entries in another type (the check's control
computes them in bfloat16); the greedy and its sum stay in float32.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

TWO_THIRDS = 2.0 / 3.0


def entry_matrix(q_mz, q_int, q_prec, c_mz, c_int, c_ann, c_prec,
                 charge: int, tol: float, allow_shift: bool,
                 value_dtype=torch.float32):
    """(P, Kq, Kc) float32 entries of P (query, library) pairs."""
    f32 = torch.float32
    dev = q_mz.device
    tol_t = torch.tensor(tol, dtype=f32, device=dev)
    prec_diff = (q_prec.to(f32) - c_prec.to(f32)) * torch.tensor(
        float(charge), dtype=f32, device=dev)
    diff = q_mz[:, :, None] - c_mz[:, None, :]
    mult = (diff.abs() <= tol_t).to(f32)
    if allow_shift and charge >= 1:
        shifted = (prec_diff.abs() >= tol_t)[:, None, None]
        ann = c_ann[:, None, :]
        for s in range(1, charge + 1):
            offset = prec_diff / torch.tensor(float(s), dtype=f32, device=dev)
            inside = ((diff - offset[:, None, None]).abs() <= tol_t) & shifted
            rule = torch.where(ann == s, 1.0,
                               torch.where(ann == 0, TWO_THIRDS, 0.0)).to(f32)
            mult = torch.maximum(mult, torch.where(inside, rule, 0.0))
    vd = value_dtype
    values = (mult.to(vd) * q_int[:, :, None].to(vd)) * c_int[:, None, :].to(vd)
    return values.to(f32)


def greedy(values: torch.Tensor):
    """(score (P,) float32, matches: P lists of (i, j) in the order taken)
    of the greedy assignment over (P, Kq, Kc) entries."""
    p, kq, kc = values.shape
    flat = values.reshape(p, kq * kc).clone()
    dev = values.device
    score = torch.zeros(p, dtype=torch.float32, device=dev)
    lane = torch.arange(kq * kc, device=dev)
    taken_i, taken_j = [], []
    for _ in range(min(kq, kc)):
        best = flat.max(dim=1).values
        live = best > 0
        if not bool(live.any()):
            break
        first = torch.where(flat == best[:, None], lane, kq * kc).min(1).values
        i, j = first // kc, first % kc
        score = score + torch.where(live, best, 0.0)
        taken_i.append(torch.where(live, i, -1))
        taken_j.append(torch.where(live, j, -1))
        clear = live[:, None] & ((lane // kc == i[:, None])
                                 | (lane % kc == j[:, None]))
        flat = torch.where(clear, 0.0, flat)
    matches: List[np.ndarray] = [np.zeros((0, 2), np.int64)] * p
    if taken_i:
        ti = torch.stack(taken_i, 1).cpu().numpy()
        tj = torch.stack(taken_j, 1).cpu().numpy()
        matches = [np.stack([ti[r][ti[r] >= 0], tj[r][tj[r] >= 0]], 1)
                   for r in range(p)]
    return score, matches


def score_pairs(q_mz, q_int, q_prec, c_mz, c_int, c_ann, c_prec,
                charge: int, tol: float, allow_shift: bool,
                value_dtype=torch.float32, block: int = 16384):
    """Greedy scores (NumPy float32) and matches of P pairs, `block` pairs
    at a time."""
    scores, matches = [], []
    for s in range(0, q_mz.shape[0], block):
        sl = slice(s, s + block)
        values = entry_matrix(q_mz[sl], q_int[sl], q_prec[sl], c_mz[sl],
                              c_int[sl], c_ann[sl], c_prec[sl], charge, tol,
                              allow_shift, value_dtype)
        sc, mt = greedy(values)
        scores.append(sc.cpu().numpy())
        matches.extend(mt)
    if not scores:
        return np.zeros(0, np.float32), []
    return np.concatenate(scores), matches


def window_counts(q_prec: np.ndarray, lib_prec_sorted: np.ndarray,
                  charge: int, tol_da: float) -> np.ndarray:
    """Library rows within each query's open precursor window
    ``|q - l| * charge <= tol`` (float64, sorted library precursors)."""
    half = tol_da / charge
    lo = np.searchsorted(lib_prec_sorted, q_prec - half, "left")
    hi = np.searchsorted(lib_prec_sorted, q_prec + half, "right")
    return hi - lo
