"""ANN open search of one charge-homogeneous query batch.

The counterpart of the ANN open-search branch of
`ann_solo_tpu/search.py::SpectralLibrary._search_batch` (:607-634, with
`_ann_candidates`, `_rescore_candidate_matrix` and `_best_pair_matches`),
which is also the work `bench.py` times:

1.  vectorize the queries (hashed, unit-norm vectors);
2.  select the top `num_candidates` library rows per query from the IVF
    index, with the precursor window fused into the scan;
3.  rescore the (B, C) candidate matrix exactly with the greedy
    shifted-dot kernel under the optimality certificate;
4.  extract the greedy peak matches of each query's best pair.

Single device, no mesh: the device is the one the index and the library
block were created on.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from ann_solo_tpu_torch.device import synchronize
from ann_solo_tpu_torch.models.vectorize import (
    VectorizeParams,
    device_tables,
    vectorize_batch,
)
from ann_solo_tpu_torch.ops.rescore import rescore_candidate_matrix
from ann_solo_tpu_torch.ops.shifted_dot_cuda import (
    shifted_dot_best_match_auto,
)

_MATCH_CHUNK = 4096  # pairs per match-extraction call (padded)


@dataclasses.dataclass(frozen=True)
class OpenSearchParams:
    """Open-search settings (the config keys the JAX engine reads)."""

    vectorize: VectorizeParams = VectorizeParams()
    num_candidates: int = 512
    precursor_tolerance_mass_open: float = 500.0
    precursor_tolerance_mode_open: str = "Da"
    fragment_mz_tolerance: float = 0.04
    allow_peak_shifts: bool = True

    def num_shifts(self, charge: int) -> int:
        return charge + 1 if self.allow_peak_shifts else 1


@dataclasses.dataclass
class LibraryBlock:
    """Per-charge library peak blocks on one device (the JAX
    `_ChargeLibrary.device_arrays`)."""

    mz: torch.Tensor  # (N, K) float32
    intensity: torch.Tensor  # (N, K) float32
    ann_charge: torch.Tensor  # (N, K) int32
    precursor_mz: torch.Tensor  # (N,) float32

    @property
    def device(self) -> torch.device:
        return self.mz.device


def best_pair_matches(lib: LibraryBlock, q_mz, q_int, q_prec,
                      rows: np.ndarray, cand_idx: np.ndarray, charge: int,
                      params: OpenSearchParams) -> Dict[int, np.ndarray]:
    """Greedy peak matches ((M, 2) [query peak, library peak]) of each
    listed query row's best candidate, in query-peak order."""
    dev = lib.device
    matches_by_row: Dict[int, np.ndarray] = {}
    for start in range(0, len(rows), _MATCH_CHUNK):
        r = rows[start:start + _MATCH_CHUNK]
        c = cand_idx[start:start + _MATCH_CHUNK]
        n = len(r)
        if n < _MATCH_CHUNK:  # pad to the one fixed chunk size
            r = np.concatenate([r, np.full(_MATCH_CHUNK - n, r[0])])
            c = np.concatenate([c, np.full(_MATCH_CHUNK - n, c[0])])
        r_d = torch.as_tensor(r, dtype=torch.int64, device=dev)
        c_d = torch.as_tensor(c, dtype=torch.int64, device=dev)
        _, match_q, match_c = shifted_dot_best_match_auto(
            q_mz.index_select(0, r_d), q_int.index_select(0, r_d),
            lib.mz.index_select(0, c_d), lib.intensity.index_select(0, c_d),
            lib.ann_charge.index_select(0, c_d),
            q_prec.index_select(0, r_d), lib.precursor_mz.index_select(0, c_d),
            torch.full((len(r),), charge, dtype=torch.int32, device=dev),
            params.fragment_mz_tolerance, params.num_shifts(charge),
            params.allow_peak_shifts,
        )
        match_q = match_q[:n].cpu().numpy()
        match_c = match_c[:n].cpu().numpy()
        for j, row in enumerate(r[:n]):
            sel = match_q[j] >= 0
            matches_by_row[int(row)] = np.column_stack(
                [match_q[j][sel], match_c[j][sel]]
            )
    return matches_by_row


@torch.no_grad()
def ann_open_search_batch(
    index,  # ann_solo_tpu_torch.index.ivf.IvfIndex on the device
    lib: LibraryBlock,  # the same charge partition's peak blocks
    q_mz, q_int,  # (B, K) float32 query peaks (m/z sorted, 0-padded)
    q_n,  # (B,) valid peak counts
    q_prec,  # (B,) precursor m/z
    charge: int,
    params: OpenSearchParams,
    stage_seconds: Optional[Dict[str, float]] = None,
):
    """ANN open search of one query batch of precursor charge `charge`.

    Returns (best_idx (B,) int64 library row or -1, best_score (B,)
    float64, n_cands (B,) int32, matches_by_row {row: (M, 2) int array}),
    like the JAX engine's ANN branch.  With `stage_seconds` given, the
    device is synchronized at each stage boundary and each stage's wall
    seconds are added under its name.
    """
    dev = lib.device
    q_mz = torch.as_tensor(q_mz).to(device=dev, dtype=torch.float32)
    q_int = torch.as_tensor(q_int).to(device=dev, dtype=torch.float32)
    q_n = torch.as_tensor(q_n).to(device=dev)
    q_prec = torch.as_tensor(np.asarray(q_prec, np.float32)).to(dev)
    clock = [time.perf_counter()]

    def stage(name):
        if stage_seconds is None:
            return
        synchronize(dev)
        now = time.perf_counter()
        stage_seconds[name] = stage_seconds.get(name, 0.0) + now - clock[0]
        clock[0] = now

    vectors = vectorize_batch(
        params.vectorize, device_tables(params.vectorize, dev),
        q_mz, q_int, q_n,
    )
    stage("vectorize")
    cand_ids, _ = index.search_device(
        vectors, params.num_candidates, q_prec=q_prec, charge=float(charge),
        tol_val=float(params.precursor_tolerance_mass_open),
        tol_mode=params.precursor_tolerance_mode_open,
    )
    stage("select")
    best_idx, best_score, n_cands = rescore_candidate_matrix(
        q_mz, q_int, q_prec,
        lib.mz, lib.intensity, lib.ann_charge, lib.precursor_mz,
        cand_ids, params.fragment_mz_tolerance, params.num_shifts(charge),
        params.allow_peak_shifts,
    )
    stage("rescore")
    rows = np.nonzero(best_idx >= 0)[0]
    matches_by_row = best_pair_matches(
        lib, q_mz, q_int, q_prec, rows, best_idx[rows], charge, params
    )
    stage("matches")
    return best_idx, best_score, n_cands, matches_by_row
