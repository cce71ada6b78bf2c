"""The port's native C++ readers against its Python readers and the JAX
package's native readers.

The port keeps byte-equal copies of the JAX package's parser sources
(`ann_solo_tpu_torch/csrc/native/`), builds them with g++ into
`build/native/` at first use and reads .splib, .sptxt and .mgf files
through them.  On the JAX package's native-reader fixtures (edge cases,
garbage lines, nested BEGIN IONS, a truncated final block, malformed
spectra, empty files) and on synthetic libraries written in all three
formats, every field of every spectrum must equal the port's Python
reader's and the JAX native reader's.  A non-ASCII MGF title reads as the
Python readers read it.  Without a compiler the dispatch warns once and
reads with the Python reader.
"""

import logging
import os

import numpy as np
import pytest

from ann_solo_tpu.io import mgf as jax_mgf
from ann_solo_tpu.io import mgf_native as jax_mgf_native
from ann_solo_tpu.io import splib_native as jax_splib_native
from ann_solo_tpu.io import sptxt_native as jax_sptxt_native
from ann_solo_tpu_torch.io import (
    _native_build,
    mgf,
    mgf_native,
    reader,
    splib,
    splib_native,
    sptxt_native,
)
from ann_solo_tpu_torch.synthdata import make_corpus
from ann_solo_tpu_torch.utils.profiling import profiler

from synth import make_library, noisy_query
from test_mgf_native import _edge_case_mgf
from test_sptxt_native import _FIXTURE
from test_torch_engine_io import assert_same_spectrum

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARSERS = ("splib_parser", "sptxt_parser", "mgf_parser")

_READERS = {
    # extension: (port native, port Python, JAX native)
    ".splib": (splib_native.read_splib_native, splib.read_splib,
               jax_splib_native.read_splib_native),
    ".sptxt": (sptxt_native.read_sptxt_native, splib.read_sptxt,
               jax_sptxt_native.read_sptxt_native),
    ".mgf": (mgf_native.read_mgf_native, mgf.read_mgf_python,
             jax_mgf_native.read_mgf_native),
}


def _read_three_ways(path):
    """The port's native, its Python and the JAX native reader's spectra
    of `path`, required equal; returns the port's native spectra."""
    read_native, read_python, read_jax_native = _READERS[
        os.path.splitext(str(path))[1]]
    native = list(read_native(str(path)))
    jax_native = list(read_jax_native(str(path)))
    python = list(read_python(str(path)))
    assert len(native) == len(python) == len(jax_native)
    for a, b, c in zip(native, python, jax_native):
        assert_same_spectrum(a, b)
        assert_same_spectrum(a, c)
    return native


def test_sources_are_byte_equal_copies():
    for name in ("splib_parser.cpp", "sptxt_parser.cpp", "mgf_parser.cpp",
                 "mmap_guard.h"):
        with open(os.path.join(REPO, "native", name), "rb") as f:
            original = f.read()
        assert (_native_build.SOURCE_DIR / name).read_bytes() == original


def test_parsers_build_into_build_native_only(tmp_path, monkeypatch):
    """A fresh build compiles into the build directory (by default
    `build/native/` at the checkout's root), named by the source hash, and
    writes nothing under `native/`."""
    assert _native_build.BUILD_DIR == (
        _native_build.PACKAGE_DIR.parent / "build" / "native")
    assert str(_native_build.BUILD_DIR).startswith(REPO)
    for name in PARSERS:
        assert _native_build.library_path(name).parent == (
            _native_build.BUILD_DIR)
    assert splib_native.available() and mgf_native.available()
    assert _native_build.library_path("mgf_parser").exists()

    monkeypatch.setattr(_native_build, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(_native_build, "_loaded", {})
    built = {name: _native_build.ensure_built(name) for name in PARSERS}
    for name, path in built.items():
        assert path.parent == tmp_path / "native" and path.exists()
        assert path.name.startswith(f"lib{name}_")
    assert sptxt_native.available()
    assert not [p for p in os.listdir(os.path.join(REPO, "native"))
                if any(p.startswith(f"lib{name}_") for name in PARSERS)]
    assert not list((tmp_path / "native").glob("*.tmp"))


@pytest.mark.parametrize("case", [
    "edge", "garbage", "nested", "truncated", "malformed", "empty",
    "synthetic"])
def test_mgf_fixtures(case, tmp_path, caplog):
    path = tmp_path / f"{case}.mgf"
    if case == "edge":
        _edge_case_mgf(path)
    elif case == "garbage":
        path.write_text(
            "BEGIN IONS\nTITLE=messy\nPEPMASS=500.0\nCHARGE=two\n100.0 1.0\n"
            "123abc 456\n1,5 100\n200.0 2.0\nEND IONS\n"
            "BEGIN IONS\nTITLE=suffixed charge\nPEPMASS=600.0\nCHARGE=2x\n"
            "150.0 1.5\nEND IONS\n")
    elif case == "nested":
        path.write_text(
            "BEGIN IONS\nTITLE=dangling\nPEPMASS=500.0\n100.0 1.0\n"
            "BEGIN IONS\nTITLE=complete\nPEPMASS=600.0\n200.0 2.0\n"
            "END IONS\n")
    elif case == "truncated":
        path.write_text(
            "BEGIN IONS\nTITLE=complete\nPEPMASS=500.0\n100.0 1.0\n"
            "200.0 2.0\nEND IONS\n"
            "BEGIN IONS\nTITLE=cut off mid-peaks\nPEPMASS=600.0\n150.0 1.5\n")
    elif case == "malformed":
        path.write_text(
            "BEGIN IONS\nTITLE=ok\nPEPMASS=500.0\n100.0 1.0\nEND IONS\n"
            "BEGIN IONS\nTITLE=bad\nPEPMASS=oops\n100.0 1.0\nEND IONS\n"
            "BEGIN IONS\nTITLE=missing\n100.0 1.0\nEND IONS\n")
    elif case == "empty":
        path.write_text("")
    else:
        rng = np.random.default_rng(71)
        _, spectra = make_library(rng, n_peptides=25)
        queries = [noisy_query(s, rng, f"q{i}") for i, s in enumerate(spectra)]
        mgf.write_mgf(spectra + queries, str(path))
    with caplog.at_level(logging.WARNING):
        native = _read_three_ways(path)
    titles = [s.identifier for s in native]
    expected = {
        "edge": ["spectrum one", "42", "3"],
        "garbage": ["messy", "suffixed charge"],
        "nested": ["complete"],
        "truncated": ["complete"],
        "malformed": ["ok"],
        "empty": [],
    }
    if case in expected:
        assert titles == expected[case]
    else:
        assert len(titles) == 50
    if case == "malformed":
        skipped = [r for r in caplog.records
                   if r.levelno == logging.WARNING and "Skipping" in r.message]
        # Two spectra skipped by each of the three readers.
        assert len(skipped) == 6


def test_sptxt_fixtures(tmp_path):
    path = tmp_path / "fixture.sptxt"
    path.write_text(_FIXTURE)
    first, second = _read_three_ways(path)
    assert first.peptide == "PEPT[Phospho]IDEK"
    assert second.is_decoy and second.precursor_mz == pytest.approx(300.2)
    # An empty file: both native readers read nothing (the Python
    # readers of both packages cannot map an empty file).
    empty = tmp_path / "empty.sptxt"
    empty.write_text("")
    assert list(sptxt_native.read_sptxt_native(str(empty))) == []
    assert list(jax_sptxt_native.read_sptxt_native(str(empty))) == []
    rng = np.random.default_rng(97)
    _, spectra = make_library(rng, n_peptides=40)
    spectra[0].peptide = "PEPT[Phospho]IDE[-18.011]K"
    synthetic = tmp_path / "synthetic.sptxt"
    splib.write_sptxt(spectra, str(synthetic))
    assert _read_three_ways(synthetic)[0].peptide == spectra[0].peptide


def test_splib_fixture(tmp_path):
    rng = np.random.default_rng(31)
    _, spectra = make_library(rng, n_peptides=20)
    spectra[5].is_decoy = spectra[11].is_decoy = True
    path = tmp_path / "lib.splib"
    splib.write_splib(spectra, str(path))
    native = _read_three_ways(path)
    assert [s.is_decoy for s in native].count(True) == 2


@pytest.mark.parametrize("ext", [".splib", ".sptxt", ".mgf"])
def test_synthdata_library(ext, tmp_path):
    """A `synthdata` corpus (modified peptides, decoys) in each format, and
    the dispatch of `read_library_file` to the native reader."""
    library, _, _ = make_corpus(np.random.default_rng(3), 150, 10)
    library[7].is_decoy = True
    path = str(tmp_path / f"lib{ext}")
    {".splib": splib.write_splib, ".sptxt": splib.write_sptxt,
     ".mgf": mgf.write_mgf}[ext](library, path)
    native = _read_three_ways(path)
    assert len(native) == len(library)
    profiler.notes.pop("library reader", None)
    for a, b in zip(reader.read_library_file(path), native):
        assert_same_spectrum(a, b)
    assert profiler.notes["library reader"] == "native"


def test_non_ascii_title(tmp_path, record_property):
    """A multi-byte title: the port's native reader slices the raw bytes
    before decoding and equals its Python reader and the JAX Python
    reader.  The JAX native reader decodes first and slices the decoded
    text by byte offsets; its identifiers are recorded, not pinned."""
    path = tmp_path / "utf8.mgf"
    path.write_text(
        "BEGIN IONS\nTITLE=µ-é spectrum\nPEPMASS=500.0\n100.0 1.0\n"
        "END IONS\n"
        "BEGIN IONS\nTITLE=after\nPEPMASS=600.0\nSEQ=PEPTIDEK\n200.0 2.0\n"
        "END IONS\n", encoding="utf-8")
    native = list(mgf_native.read_mgf_native(str(path)))
    python = list(mgf.read_mgf_python(str(path)))
    jax_python = list(jax_mgf.read_mgf_python(str(path)))
    assert [s.identifier for s in native] == ["µ-é spectrum", "after"]
    for a, b, c in zip(native, python, jax_python):
        assert_same_spectrum(a, b)
        assert_same_spectrum(a, c)
    record_property("jax_native_identifiers", [
        s.identifier for s in jax_mgf_native.read_mgf_native(str(path))])


def test_dispatch_falls_back_with_one_warning(tmp_path, monkeypatch, caplog):
    """Native when the parser builds; without a compiler, one WARNING per
    parser and the Python reader (recorded in the profiler's notes)."""
    library, queries, _ = make_corpus(np.random.default_rng(4), 30, 20)
    lib_path, q_path = str(tmp_path / "lib.splib"), str(tmp_path / "q.mgf")
    splib.write_splib(library, lib_path)
    mgf.write_mgf(queries, q_path)
    want_lib = list(reader.read_library_file(lib_path))
    want_q = list(reader.read_query_file(q_path))
    assert profiler.notes["library reader"] == "native"
    assert profiler.notes["query reader"] == "native"

    monkeypatch.setattr(_native_build, "CXX", str(tmp_path / "no-g++"))
    monkeypatch.setattr(_native_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_native_build, "_loaded", {})
    with caplog.at_level(logging.WARNING):
        for _ in range(2):
            got_lib = list(reader.read_library_file(lib_path))
            assert profiler.notes["library reader"] == "python"
            got_q = list(reader.read_query_file(q_path))
            assert profiler.notes["query reader"] == "python"
            assert list(mgf.read_mgf(q_path))[0].identifier == (
                want_q[0].identifier)
    warnings = [r for r in caplog.records if r.levelno == logging.WARNING
                and "unavailable" in r.message]
    assert sorted(r.args[0] for r in warnings) == ["mgf_parser",
                                                  "splib_parser"]
    for a, b in zip(got_lib + got_q, want_lib + want_q):
        assert_same_spectrum(a, b)
    assert not splib_native.available() and not mgf_native.available()
