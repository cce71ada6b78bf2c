"""The card's peaks and the work of kernels B2 and B4, from their inputs.

Peaks of one H100 SXM (NVIDIA's data sheet, dense, at its 700 W limit):
HBM bytes/s, bf16 tensor-core FLOP/s, and the f32 instruction rate that
a subtraction, a compare or a max issues at (one instruction a lane, 128
lanes an SM x 132 SMs x 1.98 GHz: half the 67 TFLOP/s FMA rate).

A launch's least time is the larger of its bytes over the HBM rate and
its operations over the peak of their type.  Each input byte is counted
read once and each output byte written once; where the work depends on
the data, what these inputs need is counted, not the most they could.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
F32_INSTR_PER_S = F32_FLOPS / 2


def least_seconds(n_bytes: float, ops: float, ops_per_s: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, ops / ops_per_s)


def b2_work(list_shape, storage_bytes: int, probe_ids: torch.Tensor):
    """(bytes, operations) of one B2 launch (the probe-gather scan): each
    probed list read once (its rows, ids, precursors and scales), the
    queries, their precursors and the probe table, and the (B, P * cap)
    float32 scores written; a bf16 multiply-add for every probed slot and
    dimension."""
    n_list, cap, d = list_shape
    b, p = probe_ids.shape
    valid = probe_ids[(probe_ids >= 0) & (probe_ids < n_list)]
    n_lists = int(torch.unique(valid).numel())
    n_bytes = (n_lists * cap * (d * storage_bytes + 12)
               + b * d * 4 + b * 4
               + probe_ids.numel() * probe_ids.element_size()
               + b * p * cap * 4)
    return float(n_bytes), 2.0 * b * p * cap * d


def ascending_rows(lib_mz: torch.Tensor, lib_int: torch.Tensor):
    """(N,) bool: the rows B4 searches by range (finite intensities, the
    peaks of positive intensity a prefix of the row, their m/z finite and
    non-decreasing); the others it walks densely."""
    pos = lib_int > 0
    after_gap = pos[:, 1:] & ~pos[:, :-1]
    descent = pos[:, 1:] & ~(lib_mz[:, :-1] <= lib_mz[:, 1:])
    return (~after_gap.any(1) & ~descent.any(1)
            & (~pos | torch.isfinite(lib_mz)).all(1)
            & torch.isfinite(lib_int).all(1))


def b4_work(q_mz, q_int, q_prec, lib_mz, lib_int, lib_prec, cand_ids,
            tol: float, num_shifts: int, allow_shift: bool):
    """(bytes, operations) of one B4 launch (stage 1's bounds).

    Bytes: the queries, the candidate ids, each library row referenced
    (m/z, intensity, annotation and precursor) and the (B, C) float32
    bounds.  Operations, what these inputs need: for a pair whose row is
    searched by range, a merge of its Kq query peaks with the row's n
    kept peaks in each window it has (the direct one; each shift when
    |prec_diff| >= tol), a subtraction and a compare a step and one
    subtraction more in a shift window; for a row walked densely every
    query peak against every kept peak, a subtraction and a compare an
    entry and window; then Kq products and Kq adds a pair."""
    kq, kc = q_mz.shape[1], lib_mz.shape[1]
    valid = cand_ids >= 0
    rows = torch.nonzero(valid)[:, 0]
    ids = cand_ids[valid].clamp(max=lib_mz.shape[0] - 1)
    n_shift = num_shifts - 1 if allow_shift and num_shifts > 1 else 0
    chg = float(num_shifts - 1 if allow_shift else 1)
    pd = (q_prec[rows] - lib_prec[ids]) * chg
    extra = n_shift * (pd.abs() >= torch.tensor(
        tol, dtype=torch.float32, device=pd.device)).to(torch.float64)
    kept = (lib_int > 0).sum(1).to(torch.float64)[ids]
    fast = ascending_rows(lib_mz, lib_int)[ids]
    ops = float(torch.where(fast, (kq + kept) * (2 + 3 * extra),
                            kq * kept * (2 + 2 * extra)).sum()
                + 2 * kq * ids.numel())
    n_rows = int(torch.unique(ids).numel())
    b, c = cand_ids.shape
    n_bytes = (b * kq * 8 + b * 4 + cand_ids.numel() * cand_ids.element_size()
               + n_rows * (kc * 12 + 4) + b * c * 4)
    return float(n_bytes), ops
