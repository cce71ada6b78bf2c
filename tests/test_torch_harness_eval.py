"""The port's post-search tools against the JAX package's: the mzTab SSM
reader without pandas with `eval` (statistics, histogram, CLI), the
mirror-plot matching and render (`plot`), and FASTA libraries.

Both packages read the same mzTab files, written by the JAX CLI and by
the port's CLI (``--no_gpu``) on one corpus with decoys, unmodified and
modified queries, in a bf and an ann cascade; every statistic must be
equal, exactly.
"""

import json
import os

import numpy as np
import pytest
import torch

import ann_solo_tpu.plot as jax_plot
import ann_solo_tpu.search as jax_search
from ann_solo_tpu import eval as jax_eval
from ann_solo_tpu.cli import main as jax_main
from ann_solo_tpu.io.mgf import write_mgf
from ann_solo_tpu.io.mztab import read_mztab_ssms as jax_read_ssms
from ann_solo_tpu.io.splib import write_splib
from ann_solo_tpu_torch import eval as torch_eval
from ann_solo_tpu_torch import plot as torch_plot
from ann_solo_tpu_torch.cli import main as torch_main
from ann_solo_tpu_torch.io.mztab import read_mztab_ssms
from test_torch_engine_cli import COMMON, assert_same_mztab, run_both

from synth import make_library, modified_query, noisy_query

OPEN_ARGS = COMMON + [
    "--fdr", "0.05", "--add_decoys",
    "--precursor_tolerance_mass_open", "30",
    "--precursor_tolerance_mode_open", "Da", "--allow_peak_shifts",
]
ANN_ARGS = ["--mode", "ann", "--num_list", "8", "--num_probe", "4",
            "--num_candidates", "32"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's engine on the CPU runs many small torch ops; under a
    test runner with several workers their thread pools fight over the
    cores (a 3 s quality run took minutes), as in
    `test_torch_fdr_models.py`.  One thread per worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """mzTab files of both CLIs, bf and ann cascades, on one corpus."""
    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp("torch_harness_eval")
    rng = np.random.default_rng(47)
    peptides, spectra = make_library(rng, n_peptides=120, charges=(2,))
    lib_path = str(tmp / "lib.splib")
    write_splib(spectra, lib_path)
    queries = [noisy_query(s, rng, f"q_std_{i}")
               for i, s in enumerate(spectra[:30])]
    queries += [modified_query(peptides[30 + i], s, rng, f"q_open_{i}")
                for i, s in enumerate(spectra[30:48])]
    query_path = str(tmp / "queries.mgf")
    write_mgf(queries, query_path)
    files = {}
    for mode, extra in (("bf", ["--mode", "bf"]), ("ann", ANN_ARGS)):
        run_both(mp, lib_path, query_path, tmp, mode, OPEN_ARGS + extra)
        files[mode] = {pkg: str(tmp / f"{mode}_{pkg}.mztab")
                       for pkg in ("jax", "torch")}
    mp.undo()
    return tmp, lib_path, query_path, files


def _all_files(results):
    return [path for by_pkg in results[3].values()
            for path in by_pkg.values()]


def test_read_mztab_ssms_columns_equal_pandas(results):
    """Row order, PSM_IDs and every column's values as pandas reads
    them: int and float columns by value, string columns with missing
    values as None where pandas has NaN."""
    for path in _all_files(results):
        want = jax_read_ssms(path)
        got = read_mztab_ssms(path)
        assert got.index == [str(q) for q in want.index]
        assert list(got.columns) == list(want.columns)
        for name in want.columns:
            w = want[name].to_numpy()
            g = got[name]
            if w.dtype == object:
                assert g.dtype == object, name
                assert [None if isinstance(v, float) else v for v in w] \
                    == list(g), name
            else:
                assert g.dtype == w.dtype, name
                np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("fdr", [0.01, 0.05, 0.06])
def test_ssm_stats_and_histogram_equal_jax(results, fdr):
    n_modified = 0
    for path in _all_files(results):
        want_ssms = jax_read_ssms(path)
        got_ssms = read_mztab_ssms(path)
        want = jax_eval.ssm_stats(want_ssms, fdr)
        got = torch_eval.ssm_stats(got_ssms, fdr)
        assert got == want
        assert json.dumps(got) == json.dumps(want)
        n_modified += got["n_modified"]
        for kwargs in ({}, {"bin_width": 0.5},
                       {"min_mass": -50.0, "max_mass": 50.0}):
            w_hist, w_edges = jax_eval.mass_diff_histogram(
                want_ssms, fdr, **kwargs)
            g_hist, g_edges = torch_eval.mass_diff_histogram(
                got_ssms, fdr, **kwargs)
            np.testing.assert_array_equal(g_hist, w_hist)
            np.testing.assert_array_equal(g_edges, w_edges)
    if fdr > 0.0556:  # the open level's q-values
        assert n_modified > 0


def test_ssm_stats_missing_values_and_numeric_ids(tmp_path):
    """pandas' traps: null/NA/empty fields are missing (nunique skips
    them), a numeric PSM_ID column is read as ints by pandas (the port
    keeps the strings), an all-null column is float NaN."""
    header = ["PSH", "sequence", "PSM_ID", "accession", "charge",
              "exp_mass_to_charge", "calc_mass_to_charge",
              "search_engine_score[1]", "search_engine_score[2]",
              "opt_ms_run[1]_cv_MS:1003062_spectrum_index",
              "opt_ms_run[1]_cv_MS:1002217_decoy_peptide"]
    rows = [
        ["PEPTIDEK", "1", "null", "2", "500.25", "500.25", "0.9", "0.001",
         "10", "0"],
        ["null", "2", "null", "2", "510.0", "500.0", "0.8", "0.002",
         "11", "0"],
        ["NA", "3", "null", "3", "400.1", "400.0", "0.7", "0.003", "12",
         "0"],
        ["", "4", "null", "2", "600.0", "600.0", "0.6", "0.004", "13",
         "1"],
        ["PEPTIDEK", "5", "null", "2", "500.25", "500.2", "0.5", "0.5",
         "14", "0"],
        ["ACDK", "6", "null", "2", "300.0", "300.0", "0.4", "0.005", "15",
         "0"],
    ]
    path = tmp_path / "tricky.mztab"
    path.write_text("MTD\tmzTab-version\t1.0.0\n" + "\t".join(header) + "\n"
                    + "".join("\t".join(["PSM"] + r) + "\n" for r in rows))
    want_ssms = jax_read_ssms(str(path))
    got_ssms = read_mztab_ssms(str(path))
    assert list(want_ssms.index) == [1, 2, 3, 4, 5, 6]
    assert got_ssms.index == ["1", "2", "3", "4", "5", "6"]
    assert got_ssms["accession"].dtype == np.float64
    assert np.isnan(got_ssms["accession"]).all()
    assert got_ssms["sequence"][1] is None
    for fdr in (0.0035, 0.01, 0.6):
        assert torch_eval.ssm_stats(got_ssms, fdr) == \
            jax_eval.ssm_stats(want_ssms, fdr)


def test_eval_main_prints_the_same_json(results, capsys):
    for path in _all_files(results):
        for args in ([path], [path, "--fdr", "0.2"]):
            assert jax_eval.main(args) == 0
            want = capsys.readouterr().out
            assert torch_eval.main(args) == 0
            assert capsys.readouterr().out == want


def test_eval_quality_dispatch(monkeypatch):
    """`eval quality ...` hands the rest of the arguments to the quality
    harness."""
    import ann_solo_tpu_torch.quality as torch_quality

    seen = []
    monkeypatch.setattr(torch_quality, "main",
                        lambda argv: seen.append(argv) or 0)
    assert torch_eval.main(["quality", "--n-peptides", "10"]) == 0
    assert seen == [["--n-peptides", "10"]]


def test_plot_matches_equal_jax(results, monkeypatch):
    """The peak matches (in the greedy's selection order), the spectra
    and the title of the mirror plot equal the JAX `plot.main`'s, for
    unmodified and modified SSMs of both cascades."""
    monkeypatch.setattr(jax_search.SpectralLibrary, "_make_library_mesh",
                        staticmethod(lambda: None))
    drawn = []
    monkeypatch.setattr(jax_plot, "mirror_plot",
                        lambda *args: drawn.append(args))
    for mode, by_pkg in results[3].items():
        path = by_pkg["torch"]
        ids = read_mztab_ssms(path).index
        picked = [q for q in ids if q.startswith("q_std")][:3] + \
            [q for q in ids if q.startswith("q_open")][:3]
        got = torch_plot.ssm_matches(path, picked, device="cpu")
        for qid, match in zip(picked, got):
            drawn.clear()
            assert jax_plot.main([path, qid]) == 0
            (q, lib, peak_matches, title, _), = drawn
            assert match.title == title
            np.testing.assert_array_equal(match.peak_matches, peak_matches)
            assert len(match.peak_matches) > 0
            np.testing.assert_array_equal(match.query.mz, q.mz)
            np.testing.assert_array_equal(match.query.intensity,
                                          q.intensity)
            np.testing.assert_array_equal(match.library.mz, lib.mz)
            assert match.library.identifier == lib.identifier
    with pytest.raises(ValueError, match="not present"):
        torch_plot.ssm_matches(path, ["no_such_query"], device="cpu")


def test_plot_main_writes_png(results):
    _, _, _, files = results
    path = files["bf"]["jax"]
    qid = read_mztab_ssms(path).index[0]
    assert torch_plot.main([path, qid, "--no_gpu"]) == 0
    png = f"{os.path.splitext(path)[0]}_{qid}.png"
    assert os.path.getsize(png) > 1000


# --------------------------------------------------------------------- #
# FASTA libraries


FASTA_PEPTIDES = ["ACDEFGHIK", "LMNPQSTVWYK", "GGEEDDNNR", "AAILVVFFK"]


def _fasta_args(lib, query, out):
    """`test_e2e_formats.py::_base_args`."""
    return [
        lib, query, out,
        "--precursor_tolerance_mass", "20",
        "--precursor_tolerance_mode", "ppm",
        "--fragment_mz_tolerance", "0.02",
        "--min_mz_range", "200",
        "--min_peaks", "5",
        "--model", "none",
        "--mode", "bf",
        "--fdr", "0.05",
        "--add_decoys",
    ]


@pytest.mark.parametrize("options", [
    [], ["--missed_cleavages", "0", "--max_precursor_charge", "4",
         "--collision_energies", "27", "32"]])
def test_fasta_library_equals_jax(tmp_path, options, caplog):
    """`read_library_file` on a FASTA file gives the JAX reader's
    spectra, field for field, targets then decoys, after the WARNING
    that the local predictor stands in for Koina."""
    from ann_solo_tpu.config import config as jax_config
    from ann_solo_tpu.io.reader import read_library_file as jax_read
    from ann_solo_tpu_torch.config import config as torch_config
    from ann_solo_tpu_torch.io.reader import read_library_file
    from test_torch_engine_io import assert_same_spectrum

    fasta = tmp_path / "prot.fasta"
    fasta.write_text(">sp|A|A first\n" + "".join(FASTA_PEPTIDES[:2])
                     + "\n\n>sp|B|B second\n" + FASTA_PEPTIDES[2] + "\n"
                     + FASTA_PEPTIDES[3] + "RPEPK\n")
    args = _fasta_args(str(fasta), "q.mgf", "o.mztab") + options
    jax_config.parse(args)
    torch_config.parse(args)
    np.random.seed(5)
    want = list(jax_read(str(fasta), jax_config))
    np.random.seed(5)
    with caplog.at_level("WARNING"):
        got = list(read_library_file(str(fasta)))
    assert "local fragment-ion predictor" in caplog.text
    assert len(got) == len(want) > 0
    assert sum(s.is_decoy for s in got) == len(got) // 2
    for a, b in zip(got, want):
        assert_same_spectrum(a, b)


def test_fasta_library_cascade_equals_jax(tmp_path, monkeypatch):
    """`test_e2e_formats.py::test_fasta_library_cascade`'s protein and
    queries: the port's CLI writes the JAX CLI's PSM lines, each query
    identified as its own peptide."""
    from ann_solo_tpu.config import config as jax_config
    from ann_solo_tpu.io.reader import read_library_file as jax_read

    monkeypatch.setattr(jax_search.SpectralLibrary, "_make_library_mesh",
                        staticmethod(lambda: None))
    fasta = tmp_path / "prot.fasta"
    fasta.write_text(f">sp|TEST|TEST test protein\n"
                     f"{''.join(FASTA_PEPTIDES)}\n")
    query_path = str(tmp_path / "queries.mgf")
    want_path = str(tmp_path / "jax.mztab")
    got_path = str(tmp_path / "torch.mztab")
    args = _fasta_args(str(fasta), query_path, want_path)
    jax_config.parse(args)
    by_peptide = {}
    for s in jax_read(str(fasta), jax_config):
        if s.peptide in FASTA_PEPTIDES and not s.is_decoy:
            by_peptide.setdefault(s.peptide, s)
    rng = np.random.default_rng(93)
    queries = [noisy_query(s, rng, f"q_{p}")
               for p, s in sorted(by_peptide.items())]
    write_mgf(queries, query_path)
    assert jax_main(args) == 0
    assert torch_main([str(fasta), query_path, got_path] + args[3:]
                      + ["--no_gpu"]) == 0
    psm = assert_same_mztab(got_path, want_path)
    assert len(psm) == len(queries) >= 3
    assert all(line.split("\t")[2] == f"q_{line.split(chr(9))[1]}"
               for line in psm)
