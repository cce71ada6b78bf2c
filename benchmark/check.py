"""The check that decides `correct`: a sample of the window's answers held
against the plain reference (`reference.py`).

Every batch of the window keeps the answers of a few of its queries,
drawn from the seed and the batch's ordinal, with the candidate rows the
select gave those queries; once the window has closed, the sample is
drawn from those, again from the seed.  An answer is what
`ann_open_search_batch` returned for the query: its best library row,
score and candidate count, and the best pair's peak matches.  Four
numbers are compared, each with a limit of its own (`checks/<cell>.json`
names the numbers a cell compares):

* ``score_gap``: the largest gap between a reported score and the
  reference's score of the same (query, row) pair, over that score (at
  least 1e-3): rescoring computes the greedy score exactly;
* ``answers_differ``: the share of sampled queries whose answer is wrong
  in a way that is not a matter of degree: the matches differ from the
  reference's greedy matches of that pair (in the order taken), the row
  lies outside the open precursor window or is none of the query's
  candidates, the candidate count is not the smaller of the number of
  candidates asked for and the library rows in the window, or no row is
  reported though the window holds some;
* ``source_missed``: the share of sampled noised copies (queries made
  from a library row with noise alone) whose reported score lies below
  the reference's score of the query with that row (by more than 1e-6 of
  it): vectorize and select lost the row the query came from, and
  nothing they found scores as well.  Modified copies are left out: how
  many of them the select finds is the index's recall at its settings,
  not a guarantee;
* ``rescore_missed``: over a smaller draw from the sample
  (``rescore_sample``), the share of queries whose reported score lies
  below the reference's best score over all the candidates the select
  gave the query (by more than 1e-6 of it): rescoring has to return the
  exact best of its candidates, whichever tier certifies it.  This
  number follows the program from its own state (the candidate ids);
  the select that it takes as given is held by ``source_missed`` and
  the candidate count.

The control (`control_answers`) puts the reference in the program's
place with its entries computed in bfloat16: each sampled query is
answered by the candidate of the best bfloat16 score (the first of
equal ones), with that score, its bfloat16 matches and the exact
candidate count.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from benchmark import reference
from benchmark.workload import KINDS

SCORE_FLOOR = 1e-3  # denominators of score_gap
SOURCE_SLACK = 1e-6  # relative: a score this close to the source's is kept
WINDOW_SLACK = 1e-3  # Da: float32 precursors on the card
NUMBERS = ("score_gap", "answers_differ", "source_missed", "rescore_missed")


@dataclasses.dataclass
class Answer:
    batch: int  # pool index
    row: int  # query row in the batch
    best: int
    score: float
    n_cands: int
    matches: np.ndarray  # (M, 2) [query peak, library peak]
    cands: object = None  # (C,) int32 tensor: the select's candidates


def seed_key(seed: int) -> int:
    """A non-negative key for NumPy's and PyTorch's generators."""
    return int(seed) % (1 << 63)


def keep_rows(seed: int, ordinal: int, batch: int, per_batch: int):
    rng = np.random.default_rng([seed_key(seed), ordinal])
    return rng.choice(batch, min(per_batch, batch), replace=False)


def keep(answers: List[Answer], out, pool_index: int, rows,
         cands=None) -> None:
    """Keep the answers of `rows`, with their candidates (a (rows, C)
    tensor) where given."""
    best, score, n_cands, matches = out
    for j, r in enumerate(rows):
        r = int(r)
        answers.append(Answer(pool_index, r, int(best[r]), float(score[r]),
                              int(n_cands[r]),
                              np.asarray(matches.get(r, np.zeros((0, 2)))),
                              None if cands is None else cands[j]))


def draw_sample(seed: int, answers: Sequence[Answer], size: int):
    return _draw(seed, 1 << 32, answers, size)


def _draw(seed: int, stream: int, items: Sequence, size: int) -> list:
    rng = np.random.default_rng([seed_key(seed), stream])
    pick = rng.choice(len(items), min(size, len(items)), replace=False)
    return [items[i] for i in np.sort(pick)]


def _queries(sample, pool, dev):
    """(m/z, intensity, precursor) of the sampled queries."""
    q_mz = torch.stack([pool[a.batch].mz[a.row] for a in sample])
    q_int = torch.stack([pool[a.batch].intensity[a.row] for a in sample])
    q_prec = torch.as_tensor(
        np.asarray([pool[a.batch].prec[a.row] for a in sample], np.float32),
        device=dev)
    return q_mz, q_int, q_prec


def _pairs(sample, rows, pool, lib, cfg, value_dtype, per_query=1):
    """Reference scores and matches of (sampled query, library row) pairs:
    `per_query` consecutive rows a query (rows < 0 score nothing)."""
    dev = lib.mz.device
    pick = torch.arange(len(sample), device=dev).repeat_interleave(
        per_query)
    q_mz, q_int, q_prec = (t[pick] for t in _queries(sample, pool, dev))
    ids = torch.as_tensor(np.asarray(rows).reshape(-1), device=dev)
    valid = ids >= 0
    ids = ids.clamp(min=0)
    return reference.score_pairs(
        q_mz, q_int, q_prec, lib.mz[ids],
        torch.where(valid[:, None], lib.intensity[ids], 0.0), lib.ann[ids],
        lib.prec[ids].to(torch.float32), int(cfg["charge"]),
        float(cfg["fragment_mz_tolerance"]), bool(cfg["allow_peak_shifts"]),
        value_dtype)


def _candidates(sample) -> np.ndarray:
    """(S, C) int64 candidates of the sampled queries, -1 = none (all of
    them where the select gave a query none)."""
    width = max((a.cands.shape[0] for a in sample if a.cands is not None),
                default=1)
    none = torch.full((width,), -1, dtype=torch.int64)
    return torch.stack([none if a.cands is None else
                        a.cands.to(torch.int64).cpu() for a in sample]) \
        .numpy()


def _expected(sample, pool, lib, cfg):
    """(candidate count due, precursor m/z) of each sampled query."""
    q_prec = np.asarray([pool[a.batch].prec[a.row] for a in sample])
    charge = int(cfg["charge"])
    tol = float(cfg["precursor_tolerance_mass_open"])
    n_window = reference.window_counts(q_prec, lib.prec.cpu().numpy(),
                                       charge, tol)
    return np.minimum(n_window, int(cfg["num_candidates"])), q_prec


def compare(sample: Sequence[Answer], pool, lib, cfg, seed: int,
            rescore_sample: int,
            source_kinds=("noised",)) -> Dict[str, float]:
    """The four numbers of a sample of answers (`source_missed` over the
    queries of `source_kinds`)."""
    if not sample:
        return {name: float("inf") for name in NUMBERS}
    best = np.asarray([a.best for a in sample])
    score = np.asarray([a.score for a in sample], np.float64)
    n_cands = np.asarray([a.n_cands for a in sample])
    source = np.asarray([pool[a.batch].source[a.row] for a in sample])
    kind = np.asarray([pool[a.batch].kind[a.row] for a in sample])
    counted = np.isin(kind, [KINDS.index(k) for k in source_kinds])
    ref_best, ref_matches = _pairs(sample, best, pool, lib, cfg,
                                   torch.float32)
    ref_src, _ = _pairs(sample, source, pool, lib, cfg, torch.float32)
    due, q_prec = _expected(sample, pool, lib, cfg)
    lib_prec = lib.prec.cpu().numpy()
    charge = int(cfg["charge"])
    tol = float(cfg["precursor_tolerance_mass_open"])
    cands = _candidates(sample)

    has = best >= 0
    gap = np.abs(score - ref_best) / np.maximum(np.abs(ref_best), SCORE_FLOOR)
    score_gap = float(gap[has].max()) if has.any() else 0.0
    in_window = np.abs(q_prec - lib_prec[np.maximum(best, 0)]) * charge \
        <= tol + WINDOW_SLACK
    among = (cands == best[:, None]).any(1)
    wrong = n_cands != due
    wrong |= ~has & (due > 0)
    for i, a in enumerate(sample):
        if has[i] and (not in_window[i] or not among[i]
                       or not np.array_equal(a.matches.reshape(-1, 2),
                                             ref_matches[i])):
            wrong[i] = True
    sourced = counted & (source >= 0)
    missed = sourced & (~has | (score < ref_src * (1.0 - SOURCE_SLACK)))
    return {
        "score_gap": score_gap,
        "answers_differ": float(wrong.mean()),
        "source_missed": (float(missed.sum() / sourced.sum())
                          if sourced.any() else 0.0),
        "rescore_missed": rescore_missed(sample, pool, lib, cfg, seed,
                                         rescore_sample),
    }


def best_of_candidates(sample, pool, lib, cfg, value_dtype):
    """(S,) reference best score over each sampled query's candidates, and
    the (S,) position of the first candidate that reaches it."""
    cands = _candidates(sample)
    scores, _ = _pairs(sample, cands, pool, lib, cfg, value_dtype,
                       per_query=cands.shape[1])
    scores = np.where(cands >= 0, scores.reshape(cands.shape), -np.inf)
    return scores.max(1), scores.argmax(1)


def rescore_missed(sample, pool, lib, cfg, seed: int, size: int) -> float:
    """The share of a draw of `size` sampled queries with candidates whose
    reported score lies below the best of their candidates."""
    drawn = _draw(seed, 1 << 33, sample, size)
    if not drawn:
        return 0.0
    ref, _ = best_of_candidates(drawn, pool, lib, cfg, torch.float32)
    score = np.asarray([a.score for a in drawn], np.float64)
    missed = np.isfinite(ref) & (ref > 0) & (score < ref * (1.0
                                                           - SOURCE_SLACK))
    return float(missed.mean())


def control_answers(sample: Sequence[Answer], pool, lib,
                    cfg) -> List[Answer]:
    """The control's answers to the sampled queries (see the module)."""
    cands = _candidates(sample)
    s_best, at = best_of_candidates(sample, pool, lib, cfg, torch.bfloat16)
    rows = cands[np.arange(len(sample)), at]
    _, matches = _pairs(sample, rows, pool, lib, cfg, torch.bfloat16)
    due, _ = _expected(sample, pool, lib, cfg)
    out = []
    for i, a in enumerate(sample):
        if not np.isfinite(s_best[i]):
            out.append(Answer(a.batch, a.row, -1, float("-inf"), int(due[i]),
                              np.zeros((0, 2), np.int64), a.cands))
            continue
        out.append(Answer(a.batch, a.row, int(rows[i]), float(s_best[i]),
                          int(due[i]), matches[i], a.cands))
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every number the cell compares is within its limit."""
    return all(numbers[name] <= limit for name, limit in limits.items())
