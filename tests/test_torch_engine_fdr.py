"""FDR control, SSM features and the engine's search helpers against the
JAX package, on the same inputs made from seeds.

FDR and the features are NumPy/SciPy in both packages: they must agree at
rtol 0 (the semi-supervised models are held in `test_torch_fdr_models.py`;
here they only have to run).  The window helpers run the port's rescorer (plain PyTorch on the
CPU) against the JAX engine's methods: the same (best index, best score)
per query, with exact ties placed across sub-rows.
"""

import types

import numpy as np
import pytest
import torch

import ann_solo_tpu.search as jax_search
from ann_solo_tpu import fdr as jax_fdr
from ann_solo_tpu.config import config as jax_config
from ann_solo_tpu.models import similarity as jax_similarity
from ann_solo_tpu.models.spectrum import Spectrum as JaxSpectrum
from ann_solo_tpu.models.spectrum import SpectrumSpectrumMatch as JaxSSM
from ann_solo_tpu.ops.shifted_dot import shifted_dot_best_match
from ann_solo_tpu_torch import fdr
from ann_solo_tpu_torch import search
from ann_solo_tpu_torch.config import config as torch_config
from ann_solo_tpu_torch.models import similarity
from ann_solo_tpu_torch.models.spectrum import Spectrum
from ann_solo_tpu_torch.models.spectrum import SpectrumSpectrumMatch
from ann_solo_tpu_torch.search import (
    LibraryBlock,
    OpenSearchParams,
    best_pair_matches,
)

ARGS = [
    "lib.mgf", "q.mgf", "out.mztab",
    "--precursor_tolerance_mass", "20",
    "--precursor_tolerance_mode", "ppm",
    "--fragment_mz_tolerance", "0.02", "--model", "none",
]


@pytest.fixture()
def both_configs():
    saved = (jax_config._namespace, torch_config._namespace)
    jax_config.parse(ARGS + ["--allow_peak_shifts"])
    torch_config.parse(ARGS + ["--allow_peak_shifts"])
    yield
    jax_config._namespace, torch_config._namespace = saved


def _random_ssms(seed, n, ssm_cls, spectrum_cls):
    """SSMs with random peaks and matches: some without matches, decoys,
    exact duplicates (tied scores) and open-search mass differences
    clustered at a few offsets."""
    rng = np.random.default_rng(seed)
    seeds = rng.integers(1 << 30, size=n)
    out = []
    for i in range(n):
        # Every seventh SSM repeats the previous one exactly (tied scores).
        r = np.random.default_rng(seeds[i - 1] if i % 7 == 3 else seeds[i])
        nq, nl = int(r.integers(5, 50)), int(r.integers(5, 50))
        charge = int(r.integers(1, 6))
        lib_mz = float(r.uniform(400, 1200))
        shift = r.choice([0.0, 0.0, 15.9949, 79.9663, 0.9840,
                          r.uniform(-50, 50)])
        query = spectrum_cls(
            f"q{i}", lib_mz + shift / charge + r.normal(0, 1e-3), charge,
            np.sort(r.uniform(100, 1500, nq)), r.uniform(0.01, 1, nq),
        )
        library = spectrum_cls(
            f"l{i}", lib_mz, charge, np.sort(r.uniform(100, 1500, nl)),
            r.uniform(0.01, 1, nl), peptide="PEPTIDEK"[: 3 + i % 5],
            is_decoy=bool(r.random() < 0.3),
        )
        n_match = 0 if i % 11 == 5 else int(r.integers(1, min(nq, nl)))
        pm = np.column_stack([
            r.permutation(nq)[:n_match], r.permutation(nl)[:n_match],
        ]).astype(np.int64)
        out.append(ssm_cls(query, library, peak_matches=pm,
                           search_engine_score=float(r.random())))
    return out


def _pair(seed, n):
    return (_random_ssms(seed, n, SpectrumSpectrumMatch, Spectrum),
            _random_ssms(seed, n, JaxSSM, JaxSpectrum))


def _assert_features_equal(got, want):
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("seed,n", [(1, 40), (2, 400)])
def test_tdc_qvalues_equal_jax(seed, n):
    rng = np.random.default_rng(seed)
    scores = np.round(rng.random(n), 2)  # many ties
    is_target = rng.random(n) < 0.7
    np.testing.assert_array_equal(fdr.tdc_qvalues(scores, is_target),
                                  jax_fdr.tdc_qvalues(scores, is_target))


@pytest.mark.parametrize("min_group_size", [1, 5, 100])
def test_ssm_groups_equal_jax(min_group_size):
    got, want = _pair(3, 300)
    np.testing.assert_array_equal(
        fdr._get_ssm_groups(got, min_group_size),
        jax_fdr._get_ssm_groups(want, min_group_size))


def test_batch_features_equal_jax(both_configs):
    rng = np.random.default_rng(4)
    b, k, m = 30, 40, 25
    n_q, n_l = rng.integers(1, k, b), rng.integers(1, k, b)
    lane = np.arange(k)[None]
    q_int = np.where(lane < n_q[:, None], rng.random((b, k)), 0.0)
    l_int = np.where(lane < n_l[:, None], rng.random((b, k)), 0.0)
    q_int[3, :5] = 0.5  # tied intensities
    q_mz = np.sort(rng.uniform(100, 1500, (b, k)), 1)
    l_mz = np.sort(rng.uniform(100, 1500, (b, k)), 1)
    match_q = -np.ones((b, m), np.int64)
    match_c = -np.ones((b, m), np.int64)
    for i in range(b):
        n = 0 if i == 7 else int(rng.integers(1, min(n_q[i], n_l[i]) + 1))
        match_q[i, :n] = rng.permutation(n_q[i])[:n]
        match_c[i, :n] = rng.permutation(n_l[i])[:n]
    args = (q_mz, q_int, n_q, l_mz, l_int, n_l, match_q, match_c)
    _assert_features_equal(
        similarity.batch_features(similarity.MatchBlock(*args), torch_config),
        jax_similarity.batch_features(jax_similarity.MatchBlock(*args),
                                      jax_config))


def test_compute_ssm_features_equal_jax(both_configs):
    got, want = _pair(5, 120)
    _assert_features_equal(fdr.compute_ssm_features(got, torch_config),
                           jax_fdr.compute_ssm_features(want, jax_config))


@pytest.mark.parametrize("grouped,min_group_size", [
    (False, 100), (True, 100), (True, 3),
])
def test_score_ssms_model_none_equal_jax(both_configs, grouped,
                                         min_group_size):
    got, want = _pair(6, 300)
    got = fdr.score_ssms(got, 0.01, None, grouped, min_group_size,
                         torch_config)
    want = jax_fdr.score_ssms(want, 0.01, None, grouped, min_group_size,
                              jax_config)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.query_identifier == b.query_identifier
        np.testing.assert_array_equal(
            [a.search_engine_score, a.q], [b.search_engine_score, b.q])
    assert any(np.isfinite(a.q) for a in got)
    assert any(np.isnan(a.q) for a in got)  # decoys and unmatched SSMs


@pytest.mark.parametrize("model", ["rf", "svm"])
def test_score_ssms_refuses_unported_models(both_configs, model):
    """`rf` and `svm` run through `score_ssms` (the name dates from when
    the package refused both); a model it does not have is refused before
    any feature is computed."""
    ssms, _ = _pair(7, 300)
    scored = fdr.score_ssms(ssms, 0.05, model, config=torch_config,
                            device="cpu")
    q = np.asarray([s.q for s in scored])
    matched = np.asarray([len(s.peak_matches) > 0 for s in scored])
    is_decoy = np.asarray([s.is_decoy for s in scored])
    assert np.isfinite(q[matched & ~is_decoy]).all()
    assert ((q[matched & ~is_decoy] > 0) & (q[matched & ~is_decoy] <= 1)).all()
    assert np.isnan(q[is_decoy | ~matched]).all()
    scores = np.asarray([s.search_engine_score for s in scored])
    assert np.isfinite(scores).all() and len(np.unique(scores)) > 10
    with pytest.raises(ValueError, match="Unknown semi-supervised"):
        fdr.score_ssms(_pair(7, 5)[0], 0.01, model + "2",
                       config=None)  # refused before the config is read


# --------------------------------------------------------------------- #
# search helpers


@pytest.mark.parametrize("tol_val,tol_mode", [
    (20.0, "ppm"), (0.0, "ppm"), (300.0, "Da"), (0.5, "Da"), (1e5, "ppm"),
])
@pytest.mark.parametrize("charge", [1, 2, 3])
def test_precursor_window_bounds_equal_jax(tol_val, tol_mode, charge):
    rng = np.random.default_rng(10)
    lib = np.sort(np.round(rng.uniform(400, 1200, 3000), 3))
    queries = np.concatenate([rng.uniform(350, 1250, 200), lib[::60]])
    got = search.precursor_window_bounds(queries, charge, lib, tol_val,
                                         tol_mode)
    want = jax_search.precursor_window_bounds(queries, charge, lib,
                                              tol_val, tol_mode)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int64
        np.testing.assert_array_equal(a, b)


def _window_library(rng, n, k, n_dups):
    """A charge block whose spectra repeat in groups of identical peaks
    at spread precursor m/z (exact ties across sub-rows)."""
    mz = np.sort(rng.uniform(150, 1400, (n, k)), 1).astype(np.float32)
    intensity = rng.uniform(0.05, 1, (n, k)).astype(np.float32)
    ann = rng.integers(0, 4, (n, k)).astype(np.uint8)
    src = rng.integers(0, n, n_dups)
    dst = rng.integers(0, n, n_dups)
    mz[dst], intensity[dst], ann[dst] = mz[src], intensity[src], ann[src]
    n_peaks = np.full(n, k, np.int32)
    n_peaks[::17] = k // 2
    lane = np.arange(k)[None]
    mz = np.where(lane < n_peaks[:, None], mz, 0.0).astype(np.float32)
    intensity = np.where(lane < n_peaks[:, None], intensity, 0.0).astype(
        np.float32)
    valid = np.ones(n, bool)
    valid[::23] = False
    block = types.SimpleNamespace(
        rows=np.arange(n) * 2 + 1,
        precursor_mz=rng.uniform(500, 560, n).astype(np.float32),
        proc_mz=mz, proc_intensity=intensity, proc_ann_charge=ann,
        proc_n_peaks=n_peaks, proc_is_valid=valid,
    )
    return block, src


@pytest.mark.parametrize("allow_shift", [False, True])
def test_rescore_window_ranges_equal_jax(monkeypatch, both_configs,
                                         allow_shift):
    """Narrow rows, wide rows split into 64-wide sub-rows (both packages'
    `_WIN_WIDE` patched), empty windows and exact ties across sub-rows."""
    monkeypatch.setattr(jax_search.SpectralLibrary, "_WIN_WIDE", 64)
    monkeypatch.setattr(search.SpectralLibrary, "_WIN_WIDE", 64)
    extra = ["--allow_peak_shifts"] if allow_shift else []
    jax_config.parse(ARGS + extra)
    rng = np.random.default_rng(20 + allow_shift)
    k, n = 20, 1000
    block, dup_src = _window_library(rng, n, k, 250)
    jax_lib = jax_search._ChargeLibrary(block)
    lib = search._ChargeLibrary(block, torch.device("cpu"))
    # Queries copy library rows (noised m/z for half): their windows hold
    # the duplicates of their source spectrum too.
    b = 112
    src = np.concatenate([dup_src[:b // 2], rng.integers(0, n, b // 2)])
    q_mz = block.proc_mz[src].copy()
    noise = rng.normal(0, 0.004, (b // 2, k)).astype(np.float32)
    q_mz[b // 2:] += np.where(q_mz[b // 2:] > 0, noise, 0)
    q_int = block.proc_intensity[src].copy()
    q_prec = block.precursor_mz[src].astype(np.float64) + rng.normal(
        0, 0.5, b)
    lo, hi = search.precursor_window_bounds(
        q_prec, 2, lib.precursor_mz, 500.0 * rng.random(), "ppm")
    lo[:40] = rng.integers(0, lib.n_spectra - 700, 40)  # wide windows
    hi[:40] = lo[:40] + rng.integers(257, 700, 40)
    hi[40:45] = lo[40:45]  # empty windows
    assert (hi - lo > 256).sum() >= 40

    jax_engine = jax_search.SpectralLibrary.__new__(jax_search.SpectralLibrary)
    jax_engine._mesh = None
    engine = search.SpectralLibrary.__new__(search.SpectralLibrary)
    engine.device = torch.device("cpu")
    engine._params = OpenSearchParams(fragment_mz_tolerance=0.02,
                                      allow_peak_shifts=allow_shift)
    want_idx, want_score = jax_engine._rescore_window_ranges(
        q_mz, q_int, q_prec, jax_lib, lo, hi, 2)
    got_idx, got_score = engine._rescore_window_ranges(
        q_mz, q_int, q_prec, lib, lo, hi, 2)
    np.testing.assert_array_equal(got_idx, want_idx)
    np.testing.assert_array_equal(got_score, want_score)
    assert (got_idx[40:45] == -1).all()
    if allow_shift:
        return
    # Ties: wide windows whose winner has an identical duplicate (an equal
    # score) in a later sub-row; the earlier one wins.
    tied = 0
    for q in range(40):
        win = got_idx[q]
        for row in range(win + 1, hi[q]):
            later = (row - lo[q]) // 64 > (win - lo[q]) // 64
            if later and np.array_equal(lib.mz[row], lib.mz[win]) and \
                    np.array_equal(lib.intensity[row], lib.intensity[win]):
                tied += 1
                break
    assert tied > 0


def _with_holes(selection_order, holes):
    """`_selection_order` with each row's unmatched entries moved among
    its matched ones, the matched ones in their order: the greedy leaves
    matches in a prefix, and the compaction must not rely on that.
    `holes` gets the number of rows with a match after an unmatched
    entry."""
    def order(*args):
        match_q, match_c = selection_order(*args)
        gen = torch.Generator().manual_seed(31)
        matched = match_c >= 0
        # Matched entries keep even keys in their order, the unmatched
        # draw odd ones: a stable sort interleaves them.
        key = torch.where(
            matched, 2 * matched.cumsum(1),
            2 * torch.randint(0, match_c.shape[1], match_c.shape,
                              generator=gen) + 1)
        perm = torch.sort(key, dim=1, stable=True).indices
        match_q, match_c = match_q.gather(1, perm), match_c.gather(1, perm)
        after = (match_c < 0).cummax(1).values[:, :-1] & (match_c[:, 1:] >= 0)
        holes.append(int(after.any(1).sum()))
        return match_q, match_c
    return order


@pytest.mark.parametrize("case", ["selection_order", "unmatched_rows",
                                  "nonfinite", "holes", "chunks"])
def test_best_pair_matches_in_selection_order(case, monkeypatch):
    """The port's matches come in the greedy's selection order: the order
    of the JAX package's plain greedy on the same pairs, as a mapping of
    row -> (M, 2) int64 C-contiguous views that acts as the dict of
    per-row arrays the matches once were.  Cases: rows whose pair
    matches nothing; NaN and infinite intensities (direct rule: +inf
    entries tie at the head, a pair with a NaN entry takes nothing);
    self pairs with half their peaks matched, the unmatched entries put
    among the matched ones; several chunks, rows in no order."""
    rng = np.random.default_rng(30)
    n, k, b = 300, 30, 200
    mz = np.sort(rng.uniform(150, 1400, (n, k)), 1).astype(np.float32)
    intensity = np.ceil(rng.uniform(0, 4, (n, k))).astype(np.float32) / 4
    ann = rng.integers(0, 3, (n, k)).astype(np.int32)
    prec = rng.uniform(500, 900, n).astype(np.float32)
    lib = LibraryBlock(*(torch.from_numpy(a) for a in (mz, intensity, ann,
                                                       prec)))
    rows = np.arange(0, b)
    cand = rng.integers(0, n, b)
    cand[::3] = rows[::3]  # self pairs: many matches, many ties
    q_mz = mz[:b] + rng.normal(0, 0.005, (b, k)).astype(np.float32)
    q_int = intensity[:b].copy()
    shifts = case != "nonfinite"
    holes = []
    if case == "unmatched_rows":
        # Peaks past the library's m/z and every shift of it.
        q_mz[::5] = rng.uniform(1500, 1600, (len(q_mz[::5]), k))
    elif case == "nonfinite":
        q_int[1::4, 3] = np.nan
        q_int[2::4, 5] = np.inf
        q_int[3::8, [2, 7]] = np.inf
    elif case == "holes":
        q_mz[::3, 1::2] += 0.5  # self pairs with half their peaks matched
        monkeypatch.setattr(search, "_selection_order",
                            _with_holes(search._selection_order, holes))
    elif case == "chunks":
        monkeypatch.setattr(search, "_MATCH_CHUNK", 64)
        rows = rng.permutation(b)[:150]
    q_mz = torch.from_numpy(q_mz).sort(1).values
    q_int = torch.from_numpy(q_int)
    q_prec = torch.from_numpy(prec[:b] + np.float32(8.0))
    params = OpenSearchParams(fragment_mz_tolerance=0.02,
                              allow_peak_shifts=shifts)
    got = best_pair_matches(lib, q_mz, q_int, q_prec, rows, cand[rows], 2,
                            params)
    c = cand[rows]
    _, want_q, want_c = shifted_dot_best_match(
        q_mz.numpy()[rows], q_int.numpy()[rows], mz[c], intensity[c],
        ann[c], q_prec.numpy()[rows], prec[c],
        np.full(len(rows), 2, np.int32), 0.02, 3 if shifts else 1, shifts)
    want_q, want_c = np.asarray(want_q), np.asarray(want_c)
    old = {}  # the per-row arrays the matches once were
    for j, row in enumerate(rows):
        sel = want_q[j] >= 0
        old[int(row)] = np.column_stack([want_q[j][sel], want_c[j][sel]])
    assert list(got) == list(old) == rows.tolist()
    assert len(got) == len(old)
    for row, want in old.items():
        m = got[row]
        np.testing.assert_array_equal(m, want)
        assert m.dtype == np.int64 and m.shape == (len(want), 2)
        assert m.flags.c_contiguous
        assert row in got and got.get(row) is not None
    missing = object()
    for row in (-1, b, b + 1000, max(old) + 1, "row", 2.5):
        if row not in old:
            assert row not in got
            assert got.get(row, missing) is missing
            with pytest.raises(KeyError):
                got[row]
    assert np.asarray(got.get(b, np.zeros((0, 2)))).shape == (0, 2)
    n_matched = sum(len(m) for m in old.values())
    empty = sum(len(m) == 0 for m in old.values())
    assert n_matched > 1000
    if case == "unmatched_rows":
        assert empty >= len(rows[::5])
    elif case == "nonfinite":
        inf_matched = [j for j in range(len(rows))
                       if np.isinf(q_int.numpy()[rows[j]][want_q[j][
                           want_q[j] >= 0]]).any()]
        assert empty > 0 and inf_matched
    elif case == "holes":
        assert holes[0] >= b // 4
