"""The port's store file (`io/store.py`: `SpectralLibraryStore.save` and
`open`, `open_or_build_store`) and the engine's second run, on the CPU.

A store built, written and opened again holds every column with its dtype
and the same Python strings; it equals the JAX package's ``.store.h5`` of
the same MGF (read here with h5py and handed to `convert.store_from_numpy`:
the port itself never imports h5py).  The reuse rule is the JAX package's
(`tests/test_staleness.py`): same file reused, changed content rebuilt,
changed settings rebuilt; an unreadable file is warned about and rebuilt,
and no temporary file stays behind.  The CLI run twice on the JAX
package's ann end-to-end corpus loads store and index the second time and
writes the first run's PSM lines, which are the JAX CLI's.
"""

import os

import h5py
import numpy as np
import pytest
import torch

import ann_solo_tpu.search as jax_search
from ann_solo_tpu.cli import main as jax_main
from ann_solo_tpu.config import config as jax_config
from ann_solo_tpu.io import mgf as jax_mgf
from ann_solo_tpu.io import store as jax_store
from ann_solo_tpu.io.mgf import write_mgf
from ann_solo_tpu.io.splib import write_splib
from ann_solo_tpu.models.preprocess import PreprocessParams as JaxPP
from ann_solo_tpu_torch.cli import main as torch_main
from ann_solo_tpu_torch.config import config as torch_config
from ann_solo_tpu_torch.convert import store_from_numpy
from ann_solo_tpu_torch.io import files, store
from ann_solo_tpu_torch.models.preprocess import PreprocessParams
from ann_solo_tpu_torch.utils.profiling import profiler

from synth import make_library, modified_query, noisy_query
from test_torch_engine_cli import E2E_ARGS, assert_same_mztab, split_mztab

COLUMNS = ("identifiers", "peptides", "precursor_mz", "precursor_charge",
           "is_decoy", "peak_offsets", "peak_mz", "peak_intensity",
           "peak_ann_type", "peak_ann_index", "peak_ann_charge", "proc_mz",
           "proc_intensity", "proc_ann_charge", "proc_n_peaks",
           "proc_is_valid")
META = ("config_hash", "source_filename", "source_fingerprint")
# The JAX store file's dataset of each column.
H5_NAMES = {"peak_offsets": "peaks/offsets", "peak_mz": "peaks/mz",
            "peak_intensity": "peaks/intensity",
            "peak_ann_type": "peaks/ann_type",
            "peak_ann_index": "peaks/ann_index",
            "peak_ann_charge": "peaks/ann_charge", "proc_mz": "processed/mz",
            "proc_intensity": "processed/intensity",
            "proc_ann_charge": "processed/ann_charge",
            "proc_n_peaks": "processed/n_peaks",
            "proc_is_valid": "processed/is_valid"}
ARGS = ["lib.mgf", "q.mgf", "out.mztab", "--precursor_tolerance_mass", "20",
        "--precursor_tolerance_mode", "ppm", "--fragment_mz_tolerance",
        "0.02", "--min_mz_range", "200", "--add_decoys"]
CPU = torch.device("cpu")


@pytest.fixture()
def both_configs():
    saved = (jax_config._namespace, torch_config._namespace)
    jax_config.parse(ARGS)
    torch_config.parse(ARGS)
    yield
    jax_config._namespace, torch_config._namespace = saved


def _write_library(path, seed, n=24):
    _, spectra = make_library(np.random.default_rng(seed), n_peptides=n)
    if str(path).endswith(".mgf"):
        jax_mgf.write_mgf(spectra, str(path))
    else:
        write_splib(spectra, str(path))
    return spectra


def _assert_same_store(got, want, meta=META):
    assert got.n_spectra == want.n_spectra
    for name in COLUMNS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("identifiers", "peptides"):
        assert all(type(s) is str for s in getattr(got, name))
    for name in meta:
        assert getattr(got, name) == getattr(want, name), name
    assert got.get_version() == want.get_version()


def _params():
    return PreprocessParams.from_config(torch_config, is_library=True)


def test_store_written_and_opened_is_the_store_built(tmp_path, both_configs):
    lib = tmp_path / "lib.mgf"
    _write_library(lib, seed=1)
    stages = {}
    built = store.open_or_build_store(str(lib), torch_config, _params(), CPU,
                                      stage_seconds=stages)
    assert set(stages) == {"library read", "decoys", "library preprocess",
                           "store write"}
    name = store.store_filename(str(lib), built.config_hash)
    assert built.filename == name and name.endswith(".store.npz")
    jax_name = jax_store.store_filename(str(lib), built.config_hash)
    assert name[:-len(".store.npz")] == jax_name[:-len(".store.h5")]
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["lib.mgf", os.path.basename(name)])  # no temporary file
    assert built.is_decoy.sum() == built.n_spectra // 2
    assert built.source_fingerprint == store.source_fingerprint(str(lib)) \
        == jax_store.source_fingerprint(str(lib))

    # Opening draws nothing from the global generator.
    np.random.seed(5)
    before = np.random.get_state()[1].copy()
    opened = store.SpectralLibraryStore.open(name)
    np.testing.assert_array_equal(np.random.get_state()[1], before)
    _assert_same_store(opened, built)
    with np.load(name, allow_pickle=False) as f:  # plain arrays only
        assert {n + s for n in ("identifiers", "peptides")
                for s in ("_bytes", "_offsets")} <= set(f.files)


def test_strings_travel_as_utf8_bytes():
    strings = np.asarray(["", "PEPTIDEK/2", "µ-é 23", "scan=7 ✓", ""], object)
    data, offsets = store._pack_strings(strings)
    assert data.dtype == np.uint8 and offsets.dtype == np.int64
    assert offsets[-1] == len(data) > len("".join(strings))  # multi-byte
    back = store._unpack_strings(data, offsets)
    assert back.dtype == object and list(back) == list(strings)
    assert len(store._unpack_strings(*store._pack_strings([]))) == 0


def test_opened_store_equals_the_jax_store_file(tmp_path, both_configs):
    lib = str(tmp_path / "lib.mgf")
    _write_library(lib, seed=2)
    assert jax_store.hyperparameter_hash(jax_config) == \
        store.hyperparameter_hash(torch_config)
    want = jax_store.open_or_build_store(
        lib, jax_config, JaxPP.from_config(jax_config, is_library=True))
    with h5py.File(want.filename, "r") as f:
        columns = {name: f[H5_NAMES.get(name, name)][()] for name in COLUMNS}
        meta = dict(f.attrs)
    carried = store_from_numpy(columns, meta)
    store.open_or_build_store(lib, torch_config, _params(), CPU)
    stages = {}
    got = store.open_or_build_store(lib, torch_config, _params(), CPU,
                                    stage_seconds=stages)
    assert set(stages) == {"store load"}
    _assert_same_store(got, carried)
    _assert_same_store(got, want)
    # Both packages' files sit beside the library under their own names.
    assert {os.path.splitext(n)[1] for n in os.listdir(tmp_path)} == {
        ".mgf", ".h5", ".npz"}


def test_store_reuse_follows_the_jax_rule(tmp_path, both_configs, caplog):
    """`tests/test_staleness.py::test_store_rebuilds_on_content_change`,
    and changed settings."""
    lib = tmp_path / "lib.splib"
    _write_library(lib, seed=1)
    fp1 = store.source_fingerprint(str(lib))
    store1 = store.open_or_build_store(str(lib), torch_config, _params(), CPU)
    assert store1.source_fingerprint == fp1

    # Same settings, same file name, different content: rebuilt.
    _write_library(lib, seed=2)
    fp2 = store.source_fingerprint(str(lib))
    assert fp2 != fp1
    with caplog.at_level("WARNING"):
        stages = {}
        store2 = store.open_or_build_store(str(lib), torch_config, _params(),
                                           CPU, stage_seconds=stages)
    assert "library file content changed" in caplog.text
    assert "library read" in stages and "store load" not in stages
    assert store2.source_fingerprint == fp2
    assert set(store1.peptides) != set(store2.peptides)

    # Unchanged content: reused.
    stages = {}
    store3 = store.open_or_build_store(str(lib), torch_config, _params(), CPU,
                                       stage_seconds=stages)
    assert set(stages) == {"store load"}
    _assert_same_store(store3, store2)

    # Another library of the same stem beside it, so the base name differs
    # from the one recorded: "non-compatible settings", rebuilt.
    os.replace(str(lib), str(tmp_path / "lib.sptxt.splib"))
    os.replace(store3.filename,
               store.store_filename(str(tmp_path / "lib.sptxt.splib"),
                                    store3.config_hash))
    caplog.clear()
    with caplog.at_level("WARNING"):
        stages = {}
        store4 = store.open_or_build_store(
            str(tmp_path / "lib.sptxt.splib"), torch_config, _params(), CPU,
            stage_seconds=stages)
    assert "non-compatible settings" in caplog.text
    assert "library read" in stages
    assert store4.source_filename == "lib.sptxt.splib"

    # Changed settings: another hash, another file, built.
    torch_config.parse(ARGS + ["--max_peaks_used_library", "40"])
    stages = {}
    store5 = store.open_or_build_store(
        str(tmp_path / "lib.sptxt.splib"), torch_config, _params(), CPU,
        stage_seconds=stages)
    assert store5.config_hash != store4.config_hash
    assert store5.filename != store4.filename and "library read" in stages
    assert store5.proc_mz.shape[1] == 40


def test_truncated_store_file_is_rebuilt(tmp_path, both_configs, caplog):
    lib = tmp_path / "lib.splib"
    _write_library(lib, seed=3)
    built = store.open_or_build_store(str(lib), torch_config, _params(), CPU)
    size = os.path.getsize(built.filename)
    for cut in (size // 2, 10):
        with open(built.filename, "r+b") as f:
            f.truncate(cut)
        caplog.clear()
        with caplog.at_level("WARNING"):
            stages = {}
            again = store.open_or_build_store(
                str(lib), torch_config, _params(), CPU, stage_seconds=stages)
        assert "Failed to open library store" in caplog.text
        assert "library read" in stages and "store write" in stages
        _assert_same_store(again, built)
        assert os.path.getsize(built.filename) == size
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["lib.splib", os.path.basename(built.filename)])


def test_failed_write_leaves_no_file(tmp_path, monkeypatch):
    def broken(f, **arrays):
        f.write(b"half")
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", broken)
    with pytest.raises(OSError, match="disk full"):
        files.write_npz_atomically(str(tmp_path / "x.store.npz"),
                                   {"a": np.zeros(3)})
    assert os.listdir(tmp_path) == []


def test_second_cli_run_loads_and_writes_the_same_psms(monkeypatch, tmp_path):
    """`test_e2e_ann.py`'s corpus and settings (the open level through the
    IVF index, num_list 8), `--model none`."""
    monkeypatch.setattr(jax_search.SpectralLibrary, "_make_library_mesh",
                        staticmethod(lambda: None))
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
    args = E2E_ARGS + ["--precursor_tolerance_mass_open", "30",
                       "--precursor_tolerance_mode_open", "Da",
                       "--allow_peak_shifts", "--mode", "ann",
                       "--num_list", "8", "--num_probe", "4",
                       "--num_candidates", "32"]
    outs = [str(tmp_path / f"run{i}.mztab") for i in range(2)]
    assert torch_main([lib_path, query_path, outs[0]] + args
                      + ["--no_gpu"]) == 0
    first = dict(totals=dict(profiler.totals), notes=dict(profiler.notes))
    assert first["notes"]["store"]["source"] == "built"
    assert first["notes"]["index charge 2"]["source"] == "built"
    for stage in ("library read", "decoys", "store write",
                  "index build charge 2", "index write charge 2"):
        assert first["totals"][stage] > 0, stage
    files = sorted(n for n in os.listdir(tmp_path) if n.endswith(".npz"))
    assert [n.split(".", 1)[1] for n in files] == ["store.npz", "ivf.npz"]
    assert first["notes"]["store"]["bytes"] == os.path.getsize(
        tmp_path / files[0])

    assert torch_main([lib_path, query_path, outs[1]] + args
                      + ["--no_gpu"]) == 0
    assert profiler.notes["store"]["source"] == "loaded"
    assert profiler.notes["index charge 2"]["source"] == "loaded"
    assert profiler.totals["store load"] > 0
    assert profiler.totals["index load charge 2"] > 0
    for stage in ("library read", "decoys", "library preprocess",
                  "store write", "index build charge 2",
                  "index write charge 2"):
        assert stage not in profiler.totals, stage
    assert profiler.counts["open level charge 2: ivf select"] > 0
    psm = assert_same_mztab(outs[1], outs[0])
    assert len(psm) == 45
    # The second run prints the first run's metadata too.
    assert split_mztab(outs[0])[0].keys() == split_mztab(outs[1])[0].keys()

    want = str(tmp_path / "jax.mztab")
    assert jax_main([lib_path, query_path, want] + args) == 0
    assert_same_mztab(outs[1], want)
