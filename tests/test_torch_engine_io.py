"""The engine's host-side copies equal the JAX package's originals.

`ann_solo_tpu_torch` keeps its own copies of the JAX-free modules it
needs (config, rndm, masses, the spectrum model, the readers and writers,
decoys, synthetic data) and builds its library store in memory.  Each is
run here beside the original on the same inputs, made from seeds: the
values must be equal (rtol 0: both run the same NumPy code).
"""

import dataclasses

import numpy as np
import pytest
import torch

from ann_solo_tpu import decoy as jax_decoy
from ann_solo_tpu import synthdata as jax_synth
from ann_solo_tpu.config import Config as JaxConfig
from ann_solo_tpu.config import config as jax_config
from ann_solo_tpu.io import masses as jax_masses
from ann_solo_tpu.io import mgf as jax_mgf
from ann_solo_tpu.io import mzml as jax_mzml
from ann_solo_tpu.io import mztab as jax_mztab
from ann_solo_tpu.io import splib as jax_splib
from ann_solo_tpu.io import store as jax_store
from ann_solo_tpu.models import spectrum as jax_spectrum
from ann_solo_tpu.models.preprocess import PreprocessParams as JaxPP
from ann_solo_tpu_torch import decoy, rndm, synthdata
from ann_solo_tpu_torch.config import Config
from ann_solo_tpu_torch.config import config as torch_config
from ann_solo_tpu_torch.io import masses, mgf, mzml, mztab, reader, splib
from ann_solo_tpu_torch.io import store
from ann_solo_tpu_torch.models import spectrum
from ann_solo_tpu_torch.models.preprocess import PreprocessParams

_SPECTRUM_FIELDS = [f.name for f in dataclasses.fields(jax_spectrum.Spectrum)]

BASE_ARGS = [
    "lib.splib", "q.mgf", "out.mztab",
    "--precursor_tolerance_mass", "20",
    "--precursor_tolerance_mode", "ppm",
    "--fragment_mz_tolerance", "0.02",
    "--min_mz_range", "200", "--min_peaks", "5", "--model", "none",
]


def assert_same_spectrum(got, want):
    for name in _SPECTRUM_FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
            assert a is not None and b is not None, name
            assert np.asarray(a).dtype == np.asarray(b).dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name


@pytest.fixture(scope="module")
def library():
    """Peptides and annotated library spectra (charges 2 and 3), with one
    decoy, one unannotated and one retention-timed spectrum."""
    rng = np.random.default_rng(5)
    peptides, spectra = jax_synth.make_library(rng, n_peptides=24)
    spectra[3].is_decoy = True
    spectra[4].ann_type = spectra[4].ann_index = None
    spectra[4].ann_charge = None
    spectra[5].retention_time = 12.5
    return peptides, spectra


# --------------------------------------------------------------------- #
# config, rndm


@pytest.mark.parametrize("extra", [
    [],
    ["--precursor_tolerance_mass_open", "300",
     "--precursor_tolerance_mode_open", "Da", "--allow_peak_shifts",
     "--mode", "bf", "--num_list", "64", "--resolution", "2",
     "--collision_energies", "30", "35", "--no_gpu", "--add_decoys"],
])
def test_config_parses_like_jax(extra):
    a, b = Config(), JaxConfig()
    a.parse(BASE_ARGS + extra)
    b.parse(BASE_ARGS + extra)
    assert a._namespace == b._namespace
    assert store.hyperparameter_hash(a) == jax_store.hyperparameter_hash(b)


def test_config_file_precedence_like_jax(tmp_path):
    ini = tmp_path / "config.ini"
    ini.write_text(
        "[DEFAULT]\n"
        "precursor_tolerance_mass = 10\n"
        "precursor_tolerance_mode = Da\n"
        "fragment_mz_tolerance = 0.05\n"
        "allow_peak_shifts = true\n"
        "num_list = 128\n"
        "collision_energies = 25 30\n"
        "[search]\n"
        "fdr = 0.05\n"
        "unknown_key = 3\n"
    )
    # The command line beats the file (--num_list); the file beats the
    # defaults and satisfies the required arguments.
    args = ["-c", str(ini), "lib.mgf", "q.mgf", "o.mztab", "--num_list", "7"]
    a, b = Config(), JaxConfig()
    a.parse(args)
    b.parse(args)
    assert a._namespace == b._namespace
    assert a.num_list == 7 and a.fdr == 0.05 and a.allow_peak_shifts
    assert store.hyperparameter_hash(a) == jax_store.hyperparameter_hash(b)


def test_set_seeds_like_jax():
    rndm.set_seeds()
    got = np.random.random(5)
    from ann_solo_tpu import rndm as jax_rndm

    jax_rndm.set_seeds()
    np.testing.assert_array_equal(got, np.random.random(5))


# --------------------------------------------------------------------- #
# masses


PEPTIDES = ["PEPTIDEK", "AC[+57.021]DEFGHIK", "[+42.011]-MLKR",
            "ACDM[Oxidation]PQR", "GGS[+79.966]TYR[-17.027]", "KRP"]


@pytest.mark.parametrize("peptide", PEPTIDES)
def test_masses_equal_jax(peptide):
    got, want = masses.parse_proforma(peptide), jax_masses.parse_proforma(
        peptide)
    assert (got.sequence, got.mods) == (want.sequence, want.mods)
    assert got.to_proforma() == want.to_proforma()
    assert got.mass == want.mass
    assert masses.peptide_mass(peptide) == jax_masses.peptide_mass(peptide)
    for charge in (1, 2, 3):
        assert got.precursor_mz(charge) == want.precursor_mz(charge)
        assert masses.precursor_mz(peptide, charge) == \
            jax_masses.precursor_mz(peptide, charge)
        for ions, losses in (("by", False), ("abpy", True)):
            assert masses.theoretical_fragments(
                got, ions, charge, neutral_losses=losses
            ) == jax_masses.theoretical_fragments(
                want, ions, charge, neutral_losses=losses)


def test_masses_constants_cleave_and_mass_diff_equal_jax():
    for name in ("PROTON", "NEUTRON", "CO"):
        assert getattr(masses, name) == getattr(jax_masses, name)
    protein = "MKWVTFISLLLLFSSAYSRGVFRRDTHKSEIAHRFKDLGEEHFKGLVLIAFSQYLQQCPF"
    for protease, missed in (("trypsin", 0), ("trypsin", 2)):
        assert masses.cleave(protein, protease, missed) == \
            jax_masses.cleave(protein, protease, missed)
    rng = np.random.default_rng(3)
    a, b = rng.uniform(400, 1200, 50), rng.uniform(400, 1200, 50)
    for da in (True, False):
        np.testing.assert_array_equal(masses.mass_diff(a, b, da),
                                      jax_masses.mass_diff(a, b, da))


# --------------------------------------------------------------------- #
# spectrum model


def test_spectrum_and_pack_spectra_equal_jax():
    rng = np.random.default_rng(8)
    made = {"torch": [], "jax": []}
    for i in range(9):
        n = int(rng.integers(0 if i == 0 else 1, 90))
        fields = dict(
            identifier=f"s{i}", precursor_mz=float(rng.uniform(300, 900)),
            precursor_charge=None if i == 2 else int(rng.integers(1, 4)),
            mz=rng.uniform(100, 1500, n),  # unsorted
            intensity=rng.uniform(0, 1, n),
            ann_charge=rng.integers(0, 3, n).astype(np.uint8)
            if i % 2 else None,
            ann_type=rng.integers(0, 8, n).astype(np.uint8) if i % 2 else None,
        )
        made["torch"].append(spectrum.Spectrum(**fields))
        made["jax"].append(jax_spectrum.Spectrum(**fields))
    for got, want in zip(made["torch"], made["jax"]):
        assert_same_spectrum(got, want)
        np.testing.assert_array_equal(got.annotation_charges(),
                                      want.annotation_charges())
    for kwargs in ({}, {"pad_multiple": 128}, {"pad_to": 96}):
        got = spectrum.pack_spectra(made["torch"], **kwargs)
        want = jax_spectrum.pack_spectra(made["jax"], **kwargs)
        for field in dataclasses.fields(want):
            a, b = getattr(got, field.name), getattr(want, field.name)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert spectrum.ION_TYPE_CODES == jax_spectrum.ION_TYPE_CODES


# --------------------------------------------------------------------- #
# readers and writers


def _file_bytes(path):
    return open(path, "rb").read()


def test_library_readers_and_writers_equal_jax(library, tmp_path):
    _, spectra = library
    for ext, jax_write, write, jax_read, read in (
        (".splib", jax_splib.write_splib, splib.write_splib,
         jax_splib.read_splib, splib.read_splib),
        (".sptxt", jax_splib.write_sptxt, splib.write_sptxt,
         jax_splib.read_sptxt, splib.read_sptxt),
        (".mgf", jax_mgf.write_mgf, mgf.write_mgf,
         jax_mgf.read_mgf_python, mgf.read_mgf_python),
    ):
        jax_path, path = str(tmp_path / f"j{ext}"), str(tmp_path / f"t{ext}")
        jax_write(spectra, jax_path)
        write(spectra, path)
        assert _file_bytes(path) == _file_bytes(jax_path), ext
        want = list(jax_read(jax_path))
        for got in (list(read(jax_path)),
                    list(reader.read_library_file(jax_path))):
            assert len(got) == len(want) == len(spectra), ext
            for a, b in zip(got, want):
                assert_same_spectrum(a, b)


def test_query_readers_equal_jax(library, tmp_path):
    _, spectra = library
    rng = np.random.default_rng(9)
    queries = [jax_synth.noisy_query(s, rng, str(i + 1))
               for i, s in enumerate(spectra)]
    queries[1].precursor_charge = None
    for ext, jax_write, write, jax_read, read in (
        (".mgf", jax_mgf.write_mgf, mgf.write_mgf,
         jax_mgf.read_mgf_python, mgf.read_mgf_python),
        (".mzML", jax_mzml.write_mzml, mzml.write_mzml,
         jax_mzml.read_mzml, mzml.read_mzml),
        (".mzXML", jax_mzml.write_mzxml, mzml.write_mzxml,
         jax_mzml.read_mzxml, mzml.read_mzxml),
    ):
        jax_path, path = str(tmp_path / f"j{ext}"), str(tmp_path / f"t{ext}")
        jax_write(queries, jax_path)
        write(queries, path)
        assert _file_bytes(path) == _file_bytes(jax_path), ext
        want = list(jax_read(jax_path))
        for got in (list(read(jax_path)),
                    list(reader.read_query_file(jax_path))):
            assert len(got) == len(want) == len(queries), ext
            for a, b in zip(got, want):
                assert_same_spectrum(a, b)


# --------------------------------------------------------------------- #
# decoys, synthetic data


@pytest.fixture()
def both_configs():
    """Both packages' config singletons set to the same namespace."""
    saved = (jax_config._namespace, torch_config._namespace)
    jax_config.parse(BASE_ARGS + ["--fragment_tol_mode", "Da"])
    torch_config.parse(BASE_ARGS + ["--fragment_tol_mode", "Da"])
    yield
    jax_config._namespace, torch_config._namespace = saved


def test_decoys_equal_jax(library, both_configs):
    _, spectra = library
    spectra = [s for s in spectra if s.ann_type is not None]
    out = {}
    for name, fn in (("jax", jax_decoy.shuffle_and_reposition),
                     ("torch", decoy.shuffle_and_reposition)):
        np.random.seed(11)  # decoys draw from the global RNG
        out[name] = [fn(s) for s in spectra]
        out[name + "_next"] = np.random.random()
    assert out["torch_next"] == out["jax_next"]  # same number of draws
    for got, want in zip(out["torch"], out["jax"]):
        assert_same_spectrum(got, want)
    with pytest.raises(ValueError):
        decoy.shuffle_and_reposition(
            spectrum.Spectrum("x", 500.0, 2, np.ones(3), np.ones(3)))


def test_make_corpus_equal_jax():
    got = synthdata.make_corpus(np.random.default_rng(42), 60, 40)
    want = jax_synth.make_corpus(np.random.default_rng(42), 60, 40)
    assert got[2] == want[2]
    for a_list, b_list in ((got[0], want[0]), (got[1], want[1])):
        assert len(a_list) == len(b_list)
        for a, b in zip(a_list, b_list):
            assert_same_spectrum(a, b)
    assert synthdata.AMINO_ACIDS == jax_synth.AMINO_ACIDS
    np.testing.assert_array_equal(synthdata.MOD_WEIGHTS,
                                  jax_synth.MOD_WEIGHTS)


# --------------------------------------------------------------------- #
# store


def test_store_equals_jax_store_file(library, tmp_path, both_configs):
    """The in-memory store holds the arrays of the JAX package's store
    file, decoys and preprocessing included."""
    _, spectra = library
    spectra = [s for s in spectra if s.ann_type is not None]
    lib_path = str(tmp_path / "lib.mgf")
    jax_mgf.write_mgf(spectra, lib_path)
    config_hash = jax_store.hyperparameter_hash(jax_config)
    assert config_hash == store.hyperparameter_hash(torch_config)
    h5_path = str(tmp_path / "lib.store.h5")
    jax_store.build_store(
        jax_mgf.read_mgf_python(lib_path), h5_path, config_hash, "lib.mgf",
        JaxPP.from_config(jax_config, is_library=True), add_decoys=True,
    )
    want = jax_store.SpectralLibraryStore(h5_path)
    stages = {}
    got = store.build_store(
        mgf.read_mgf(lib_path), config_hash, "lib.mgf",
        PreprocessParams.from_config(torch_config, is_library=True),
        torch.device("cpu"), add_decoys=True, stage_seconds=stages,
    )
    assert set(stages) == {"library read", "decoys", "library preprocess"}
    assert got.n_spectra == want.n_spectra == 2 * len(spectra)
    for name in ("identifiers", "peptides", "precursor_mz",
                 "precursor_charge", "is_decoy", "peak_offsets", "peak_mz",
                 "peak_intensity", "peak_ann_type", "peak_ann_index",
                 "peak_ann_charge", "proc_mz", "proc_intensity",
                 "proc_ann_charge", "proc_n_peaks", "proc_is_valid"):
        a, b = getattr(got, name), getattr(want, name)
        if b.dtype != object:
            assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.charges() == want.charges()
    assert got.get_version() == want.get_version()
    for charge in got.charges():
        np.testing.assert_array_equal(got.charge_block(charge).rows,
                                      want.charge_block(charge).rows)
    for row in (0, 1, got.n_spectra - 1):
        for processed in (True, False):
            assert_same_spectrum(got.get_spectrum(row, processed),
                                 want.get_spectrum(row, processed))


# --------------------------------------------------------------------- #
# mzTab


def test_mztab_writer_equals_jax(library, tmp_path, both_configs):
    _, spectra = library
    rng = np.random.default_rng(12)
    ssms = []
    for i, lib_spectrum in enumerate(spectra[:10]):
        query = jax_synth.noisy_query(lib_spectrum, rng, f"scan={10 - i}")
        query.index = i
        ssm = jax_spectrum.SpectrumSpectrumMatch(
            query, lib_spectrum,
            search_engine_score=float(np.float32(rng.random())),
            q=float(rng.random()) if i % 3 else float("nan"),
        )
        ssms.append(ssm)
    paths = {}
    for name, fn, cfg in (("jax", jax_mztab.write_mztab, jax_config),
                          ("torch", mztab.write_mztab, torch_config)):
        paths[name] = fn(ssms, str(tmp_path / f"{name}.mztab"), "v1", cfg,
                         query_filename="q.mgf")
    lines = {name: open(p).read().splitlines() for name, p in paths.items()}
    assert len(lines["torch"]) == len(lines["jax"])
    for a, b in zip(lines["torch"], lines["jax"]):
        key = a.split("\t")[1]
        if a.startswith("MTD") and key in ("mzTab-ID", "title",
                                           "software[1]"):
            continue  # output file name, package version
        assert a == b
    assert mztab.read_mztab_metadata(paths["torch"]) == \
        jax_mztab.read_mztab_metadata(paths["jax"])
    order = [line.split("\t")[2] for line in lines["torch"]
             if line.startswith("PSM")]
    assert order == sorted(order, key=mztab.natural_sort_key)
