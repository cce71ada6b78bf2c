"""The port's CLI (``--no_gpu``) writes the JAX CLI's PSM lines.

The corpora and settings of the JAX package's end-to-end tests
(`test_e2e.py`: the bf standard search and the bf cascade at 30 Da;
`test_e2e_ann.py`: the ann cascade at num_list 8;
`test_search_unknown_charge.py`), made from the same seeds.  Both CLIs run
on the same files; every PSM line must be identical, and every MTD line
but the three that name the output file and the package version.  The
JAX engine runs on one device, as `test_e2e_ann.py`'s single-device leg
does.
"""

import numpy as np
import pytest

import ann_solo_tpu.search as jax_search
from ann_solo_tpu.cli import main as jax_main
from ann_solo_tpu.io.mgf import write_mgf
from ann_solo_tpu.io.splib import write_splib
from ann_solo_tpu_torch.cli import main as torch_main

from synth import make_library, modified_query, noisy_query

# MTD keys that name the output file or the software version.
_VARIABLE_MTD = {"mzTab-ID", "title", "software[1]"}

COMMON = [
    "--precursor_tolerance_mass", "20",
    "--precursor_tolerance_mode", "ppm",
    "--fragment_mz_tolerance", "0.02",
    "--min_mz_range", "200",
    "--min_peaks", "5",
    "--model", "none",
]


def split_mztab(path):
    """(MTD lines by key, the PSH line, PSM lines) of an mzTab file."""
    mtd, psh, psm = {}, None, []
    for line in open(path).read().splitlines():
        fields = line.split("\t")
        if fields[0] == "MTD":
            mtd[fields[1]] = line
        elif fields[0] == "PSH":
            psh = line
        elif fields[0] == "PSM":
            psm.append(line)
    return mtd, psh, psm


def assert_same_mztab(got_path, want_path):
    got_mtd, got_psh, got = split_mztab(got_path)
    want_mtd, want_psh, want = split_mztab(want_path)
    assert got_psh == want_psh
    assert got == want
    assert got_mtd.keys() == want_mtd.keys()
    for key, line in want_mtd.items():
        if key not in _VARIABLE_MTD:
            assert got_mtd[key] == line, key
    return got


def run_both(monkeypatch, lib_path, query_path, out_dir, tag, args):
    """Run the JAX CLI (single device) and the port's CLI on the CPU;
    returns the PSM lines, asserted identical."""
    monkeypatch.setattr(jax_search.SpectralLibrary, "_make_library_mesh",
                        staticmethod(lambda: None))
    want = str(out_dir / f"{tag}_jax.mztab")
    got = str(out_dir / f"{tag}_torch.mztab")
    assert jax_main([lib_path, query_path, want] + args) == 0
    assert torch_main([lib_path, query_path, got] + args + ["--no_gpu"]) == 0
    return assert_same_mztab(got, want)


@pytest.fixture(scope="module")
def e2e_setup(tmp_path_factory):
    """`test_e2e.py`'s corpus."""
    tmp = tmp_path_factory.mktemp("torch_e2e")
    rng = np.random.default_rng(23)
    peptides, spectra = make_library(rng, n_peptides=60)
    lib_path = str(tmp / "lib.splib")
    write_splib(spectra, lib_path)
    queries = [noisy_query(s, rng, f"q_std_{i}")
               for i, s in enumerate(spectra[:40])]
    queries += [modified_query(peptides[40 + i], s, rng, f"q_open_{i}")
                for i, s in enumerate(spectra[40:52])]
    query_path = str(tmp / "queries.mgf")
    write_mgf(queries, query_path)
    return tmp, lib_path, query_path, peptides


E2E_ARGS = COMMON + ["--batch_size", "512", "--fdr", "0.05",
                     "--add_decoys"]


def test_bf_standard_search_equals_jax(monkeypatch, e2e_setup):
    tmp, lib_path, query_path, peptides = e2e_setup
    psm = run_both(monkeypatch, lib_path, query_path, tmp, "std",
                   E2E_ARGS + ["--mode", "bf"])
    # Modified queries have no candidate in the 20 ppm window.
    assert len(psm) == 40
    correct = sum(
        line.split("\t")[1] == peptides[int(line.split("\t")[2][6:])]
        for line in psm if line.split("\t")[2].startswith("q_std"))
    assert correct >= 32


def test_bf_cascade_open_search_equals_jax(monkeypatch, e2e_setup):
    tmp, lib_path, query_path, _ = e2e_setup
    psm = run_both(monkeypatch, lib_path, query_path, tmp, "open",
                   E2E_ARGS + ["--mode", "bf",
                               "--precursor_tolerance_mass_open", "30",
                               "--precursor_tolerance_mode_open", "Da",
                               "--allow_peak_shifts"])
    assert len(psm) == 52


def test_ann_cascade_equals_jax(monkeypatch, tmp_path):
    """`test_e2e_ann.py`'s corpus and settings: the open level goes
    through the IVF index (num_list 8)."""
    rng = np.random.default_rng(41)
    peptides, spectra = make_library(rng, n_peptides=120, charges=(2,))
    lib_path = str(tmp_path / "lib.splib")
    write_splib(spectra, lib_path)
    queries = [noisy_query(s, rng, f"q_std_{i}")
               for i, s in enumerate(spectra[:30])]
    queries += [modified_query(peptides[30 + i], s, rng, f"q_open_{i}")
                for i, s in enumerate(spectra[30:45])]
    query_path = str(tmp_path / "queries.mgf")
    write_mgf(queries, query_path)
    from ann_solo_tpu_torch.utils.profiling import profiler

    psm = run_both(monkeypatch, lib_path, query_path, tmp_path, "ann",
                   E2E_ARGS + [
                       "--precursor_tolerance_mass_open", "30",
                       "--precursor_tolerance_mode_open", "Da",
                       "--allow_peak_shifts", "--mode", "ann",
                       "--num_list", "8", "--num_probe", "4",
                       "--num_candidates", "32"])
    assert len(psm) == 45
    # The port's open level went through the index, its std level
    # through window rescoring.
    assert profiler.counts["open level charge 2: ivf select"] > 0
    assert profiler.counts["std level charge 2: window rescoring"] > 0
    assert profiler.notes["index charge 2"]["num_list"] == 8


def test_unknown_charge_queries_equal_jax(monkeypatch, tmp_path):
    """`test_search_unknown_charge.py`: queries without a charge are
    searched at charges 2 and 3 and keep their best expansion."""
    rng = np.random.default_rng(61)
    peptides, spectra = make_library(rng, n_peptides=30, charges=(2, 3))
    lib_path = str(tmp_path / "lib.splib")
    write_splib(spectra, lib_path)
    queries = []
    for i, spectrum in enumerate(spectra[:12]):
        query = noisy_query(spectrum, rng, f"q_{i}")
        query.precursor_charge = None
        queries.append(query)
    query_path = str(tmp_path / "queries.mgf")
    write_mgf(queries, query_path)
    psm = run_both(monkeypatch, lib_path, query_path, tmp_path, "unknown",
                   COMMON + ["--mode", "bf", "--fdr", "0.3", "--add_decoys"])
    ids = [line.split("\t")[2] for line in psm]
    assert len(ids) == len(set(ids)) == 12
    assert {line.split("\t")[12] for line in psm} == {"2", "3"}
