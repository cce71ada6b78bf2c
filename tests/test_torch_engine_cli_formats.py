"""The port's CLI on the JAX package's other end-to-end corpora, and what
it refuses.

`test_multifile.py` (a query glob: one mzTab per file, the same naming
errors), `test_e2e_formats.py` (mzML queries) and `test_iprg_format.py`
(a binary .splib library, every setting through a config.ini given with
``-c``): the port's CLI with ``--no_gpu`` writes the JAX CLI's PSM lines.
``--model rf|svm`` (and the default, rf) run; an unknown model and FASTA
libraries are refused before the store is opened, and without ``--no_gpu``
the CLI needs CUDA.
"""

import shutil

import numpy as np
import pytest
import torch

from ann_solo_tpu.cli import main as jax_main
from ann_solo_tpu.io.mgf import write_mgf
from ann_solo_tpu.io.mzml import write_mzml
from ann_solo_tpu.io.splib import write_splib
from ann_solo_tpu_torch import search as torch_search
from ann_solo_tpu_torch.cli import main as torch_main
from test_torch_engine_cli import COMMON, assert_same_mztab, run_both

from synth import make_library, modified_query, noisy_query

BF_ARGS = COMMON + ["--mode", "bf", "--fdr", "0.05", "--add_decoys"]


@pytest.fixture(scope="module")
def multifile(tmp_path_factory):
    """`test_multifile.py`'s corpus: one library, two query files."""
    tmp = tmp_path_factory.mktemp("torch_multifile")
    rng = np.random.default_rng(83)
    _, spectra = make_library(rng, n_peptides=40)
    lib_path = str(tmp / "lib.splib")
    write_splib(spectra, lib_path)
    for part in range(2):
        queries = [noisy_query(s, rng, f"p{part}_q{i}")
                   for i, s in enumerate(spectra[part * 15:part * 15 + 15])]
        write_mgf(queries, str(tmp / f"run{part}.mgf"))
    return tmp, lib_path


def test_query_glob_writes_the_jax_mztabs(monkeypatch, multifile):
    import ann_solo_tpu.search as jax_search

    monkeypatch.setattr(jax_search.SpectralLibrary, "_make_library_mesh",
                        staticmethod(lambda: None))
    tmp, lib_path = multifile
    for name in ("jax_outs", "torch_outs"):
        (tmp / name).mkdir()
    glob = str(tmp / "run*.mgf")
    assert jax_main([lib_path, glob, str(tmp / "jax_outs")] + BF_ARGS) == 0
    assert torch_main([lib_path, glob, str(tmp / "torch_outs")] + BF_ARGS
                      + ["--no_gpu"]) == 0
    names = sorted(p.name for p in (tmp / "torch_outs").glob("*.mztab"))
    assert names == ["run0.mztab", "run1.mztab"]
    for part, name in enumerate(names):
        psm = assert_same_mztab(str(tmp / "torch_outs" / name),
                                str(tmp / "jax_outs" / name))
        assert len(psm) == 15
        assert all(line.split("\t")[2].startswith(f"p{part}_")
                   for line in psm)
        assert f"run{part}.mgf" in open(tmp / "torch_outs" / name).read()


def test_query_glob_naming_errors(multifile, tmp_path, monkeypatch):
    """The naming errors of the JAX CLI, raised before the library is
    read."""
    tmp, lib_path = multifile
    monkeypatch.setattr(torch_search, "open_or_build_store", None)  # never reached
    with pytest.raises(ValueError, match="placeholder"):
        torch_main([lib_path, str(tmp / "run*.mgf"),
                    str(tmp / "single.mztab")] + BF_ARGS + ["--no_gpu"])
    both = tmp_path / "both"
    (both / "x").mkdir(parents=True)
    (both / "y").mkdir()
    shutil.copy(str(tmp / "run0.mgf"), str(both / "x" / "run0.mgf"))
    shutil.copy(str(tmp / "run0.mgf"), str(both / "y" / "run0.mgf"))
    with pytest.raises(ValueError, match="colliding"):
        torch_main([lib_path, str(both / "*" / "run0.mgf"), str(tmp_path)]
                   + BF_ARGS + ["--no_gpu"])


def test_mzml_queries_equal_jax(monkeypatch, tmp_path):
    """`test_e2e_formats.py::test_mzml_query_cascade`."""
    rng = np.random.default_rng(91)
    peptides, spectra = make_library(rng, n_peptides=30)
    lib_path = str(tmp_path / "lib.splib")
    write_splib(spectra, lib_path)
    queries = [noisy_query(s, rng, f"q{i}") for i, s in enumerate(spectra[:12])]
    query_path = str(tmp_path / "queries.mzML")
    write_mzml(queries, query_path)
    psm = run_both(monkeypatch, lib_path, query_path, tmp_path, "mzml",
                   BF_ARGS)
    assert len(psm) == 12
    correct = sum(line.split("\t")[1] == peptides[int(
        line.split("\t")[2].lstrip("q"))] for line in psm)
    assert correct >= 10


def test_iprg_style_splib_with_config_file_equals_jax(monkeypatch, tmp_path):
    """`test_iprg_format.py`: a binary .splib library, settings from a
    config.ini through ``-c``, the std -> open (300 Da) cascade in ann
    mode (too few spectra for an index: window rescoring throughout)."""
    import ann_solo_tpu.search as jax_search

    monkeypatch.setattr(jax_search.SpectralLibrary, "_make_library_mesh",
                        staticmethod(lambda: None))
    rng = np.random.default_rng(2012)
    peptides, spectra = make_library(rng, n_peptides=60)
    lib_path = str(tmp_path / "human_yeast_targetdecoy.splib")
    write_splib(spectra, lib_path)
    queries = [noisy_query(s, rng, f"iPRG2012_std_{i}")
               for i, s in enumerate(spectra[:40])]
    queries += [modified_query(peptides[40 + i], s, rng, f"iPRG2012_open_{i}")
                for i, s in enumerate(spectra[40:52])]
    query_path = str(tmp_path / "iPRG2012.mgf")
    write_mgf(queries, query_path)
    ini = tmp_path / "config.ini"
    ini.write_text(
        "[DEFAULT]\n"
        "precursor_tolerance_mass = 20\n"
        "precursor_tolerance_mode = ppm\n"
        "precursor_tolerance_mass_open = 300\n"
        "precursor_tolerance_mode_open = Da\n"
        "fragment_mz_tolerance = 0.02\n"
        "allow_peak_shifts = true\n"
        "min_mz_range = 200\n"
        "min_peaks = 5\n"
        "model = none\n"
        "fdr = 0.05\n"
        "add_decoys = true\n"
        "mode = ann\n"
        "batch_size = 512\n"
    )
    want, got = str(tmp_path / "jax.mztab"), str(tmp_path / "torch.mztab")
    assert jax_main(["-c", str(ini), lib_path, query_path, want]) == 0
    assert torch_main(["-c", str(ini), lib_path, query_path, got,
                       "--no_gpu"]) == 0
    psm = assert_same_mztab(got, want)
    assert len(psm) == 52
    shifted = sum(abs(float(line.split("\t")[13]) - float(
        line.split("\t")[14])) > 0.5 for line in psm)
    assert shifted >= 6


@pytest.mark.parametrize("model", ["rf", "svm"])
def test_unported_models_refused_before_the_store(multifile, model,
                                                  monkeypatch):
    """`--model rf` and `--model svm` run through the CLI to an mzTab file
    with q-values.  (The name dates from when the package refused both; a
    model it does not have is still refused before the store is opened:
    see the next test.)"""
    tmp, lib_path = multifile
    out = str(tmp / f"{model}.mztab")
    args = [lib_path, str(tmp / "run0.mgf"), out]
    args += [a if a != "none" else model for a in BF_ARGS] + ["--no_gpu"]
    assert torch_main(args) == 0
    psm = [line.split("\t") for line in open(out)
           if line.startswith("PSM\t")]
    assert len(psm) == 15
    assert all(0.0 < float(row[9]) <= 1.0 for row in psm)
    assert len({row[8] for row in psm}) > 1  # the model's scores


def test_default_model_runs_and_unknown_model_is_refused(multifile,
                                                         monkeypatch):
    """With no ``--model`` argument the CLI takes its default, the random
    forest; a model unknown to the engine is refused before the store is
    opened."""
    from ann_solo_tpu_torch.config import config as torch_config
    from ann_solo_tpu_torch.utils.profiling import profiler

    tmp, lib_path = multifile
    out = str(tmp / "default.mztab")
    args = [lib_path, str(tmp / "run0.mgf"), out]
    args += [a for a in BF_ARGS if a not in ("--model", "none")]
    assert torch_main(args + ["--no_gpu"]) == 0
    assert torch_config.model == "rf"
    assert profiler.totals["std FDR model"] > 0
    assert len([1 for line in open(out) if line.startswith("PSM\t")]) == 15
    # argparse refuses an unknown name at the command line ...
    with pytest.raises(SystemExit):
        torch_main(args + ["--model", "xgb", "--no_gpu"])
    # ... and the engine one that reaches it another way.
    monkeypatch.setattr(torch_search, "open_or_build_store", None)
    torch_config.parse(args + ["--no_gpu"])
    monkeypatch.setitem(torch_config._namespace, "model", "xgb")
    with pytest.raises(ValueError, match="Unknown semi-supervised"):
        torch_search.SpectralLibrary(lib_path, device="cpu")


def test_fasta_library_refused_before_the_store(multifile, monkeypatch):
    tmp, _ = multifile
    fasta = tmp / "prot.fasta"
    fasta.write_text(">sp|TEST|TEST test protein\nACDEFGHIKLMNPQSTVWYK\n")
    monkeypatch.setattr(torch_search, "open_or_build_store", None)  # never reached
    with pytest.raises(ValueError, match="FASTA"):
        torch_main([str(fasta), str(tmp / "run0.mgf"),
                    str(tmp / "x.mztab")] + BF_ARGS + ["--no_gpu"])


def test_cli_needs_cuda_without_no_gpu(multifile, monkeypatch):
    """No silent CPU fallback: without --no_gpu the search needs CUDA."""
    tmp, lib_path = multifile
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch_search, "open_or_build_store", None)  # never reached
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_main([lib_path, str(tmp / "run0.mgf"), str(tmp / "x.mztab")]
                   + BF_ARGS)
