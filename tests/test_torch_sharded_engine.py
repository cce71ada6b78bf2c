"""The port's CLI with the library sharded over a mesh of CPU devices.

`test_e2e_ann.py`'s corpus and sharded-engine arguments (num_list 8,
full probing).  The port's `SpectralLibrary._make_library_mesh` is patched
to a mesh of 8 repeated CPU devices, (dp=1, lib=8) and (dp=2, lib=4), as
`test_e2e_ann.py` patches the JAX one; under --no_gpu the port otherwise
stays unsharded.  The sharded CLI must write the unsharded port's PSM
lines exactly, and the same PSMs and sequences as the JAX package's
sharded CLI on its 8 virtual CPU devices (search scores at rtol 1e-5, as
`test_e2e_ann.py` compares its sharded and single-device engines).
"""

import numpy as np
import pytest
import torch

import ann_solo_tpu_torch.search as torch_search
from ann_solo_tpu.cli import main as jax_main
from ann_solo_tpu.io.mgf import write_mgf
from ann_solo_tpu.io.splib import write_splib
from ann_solo_tpu_torch.cli import main as torch_main
from ann_solo_tpu_torch.parallel.mesh import make_mesh
from ann_solo_tpu_torch.parallel.sharded_ivf import ShardedIvfIndex
from ann_solo_tpu_torch.utils.profiling import profiler

from synth import make_library, modified_query, noisy_query

_CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """`test_e2e_ann.py`'s `ann_setup` corpus (seed 41)."""
    tmp = tmp_path_factory.mktemp("torch_sharded_engine")
    rng = np.random.default_rng(41)
    peptides, spectra = make_library(rng, n_peptides=120, charges=(2,))
    lib_path = str(tmp / "lib.splib")
    write_splib(spectra, lib_path)
    queries = [noisy_query(s, rng, f"q_std_{i}")
               for i, s in enumerate(spectra[:30])]
    queries += [modified_query(peptides[30 + i], s, rng, f"q_open_{i}")
                for i, s in enumerate(spectra[30:45])]
    query_path = str(tmp / "queries.mgf")
    write_mgf(queries, query_path)
    return tmp, lib_path, query_path


def _args(lib_path, query_path, out):
    """`test_e2e_ann.py`'s sharded-engine arguments."""
    return [
        lib_path, query_path, out,
        "--precursor_tolerance_mass", "20",
        "--precursor_tolerance_mode", "ppm",
        "--precursor_tolerance_mass_open", "30",
        "--precursor_tolerance_mode_open", "Da",
        "--fragment_mz_tolerance", "0.02",
        "--allow_peak_shifts",
        "--min_mz_range", "200",
        "--min_peaks", "5",
        "--model", "none",
        "--mode", "ann",
        "--num_list", "8",
        "--num_probe", "8",  # full probing: identical candidate sets
        "--num_candidates", "32",
        "--batch_size", "512",
        "--fdr", "0.05",
        "--add_decoys",
    ]


def _psm_lines(path):
    return [line for line in open(path).read().splitlines()
            if line.startswith("PSM\t")]


def _psms(path):
    """{PSM_ID: (sequence, search_engine_score[1])} of an mzTab file."""
    out = {}
    for line in _psm_lines(path):
        f = line.split("\t")
        out[f[2]] = (f[1], float(f[8]))
    return out


@pytest.fixture(scope="module")
def unsharded(corpus):
    """The port's unsharded CLI on the corpus (its files built here and
    reused by the sharded runs)."""
    tmp, lib_path, query_path = corpus
    out = str(tmp / "unsharded.mztab")
    assert torch_main(_args(lib_path, query_path, out) + ["--no_gpu"]) == 0
    return out


def test_make_library_mesh_is_none_on_the_cpu():
    assert torch_search.SpectralLibrary._make_library_mesh(
        torch.device("cpu")) is None


@pytest.mark.parametrize("dp,n_shards", [(1, 8), (2, 4)])
def test_sharded_cli_equals_unsharded_and_jax(monkeypatch, corpus,
                                              unsharded, dp, n_shards):
    tmp, lib_path, query_path = corpus
    mesh = make_mesh(8, dp_size=dp, devices=_CPU8)
    assert mesh.shape == {"dp": dp, "lib": n_shards}
    placed = []
    real_init = ShardedIvfIndex.__init__

    def spy(self, mesh_, index):
        real_init(self, mesh_, index)
        placed.append(self)

    monkeypatch.setattr(ShardedIvfIndex, "__init__", spy)
    searched = []
    real_search = ShardedIvfIndex._search

    def search_spy(self, replicas, *args):
        searched.append(list(replicas))
        return real_search(self, replicas, *args)

    monkeypatch.setattr(ShardedIvfIndex, "_search", search_spy)
    monkeypatch.setattr(torch_search.SpectralLibrary, "_make_library_mesh",
                        staticmethod(lambda device: mesh))
    out = str(tmp / f"sharded_{dp}x{n_shards}.mztab")
    assert torch_main(_args(lib_path, query_path, out) + ["--no_gpu"]) == 0
    # The charge's index (loaded from the unsharded run's file) was placed
    # on the mesh, and the open level went through it.
    assert len(placed) == 1 and placed[0].n_list_shards == n_shards
    note = profiler.notes["index charge 2"]
    assert note["source"] == "loaded"
    assert note["sharded"]["mesh"] == {"dp": dp, "lib": n_shards}
    assert profiler.counts["open level charge 2: ivf select"] > 0
    # Each dp replica searched its own part of the open-level batches.
    assert sorted({r for rs in searched for r in rs}) == list(range(dp))
    assert all(len(rs) == 1 for rs in searched)
    got = _psm_lines(out)
    assert len(got) > 30
    assert got == _psm_lines(unsharded)

    # The JAX package's sharded CLI on its 8 virtual devices: --num_shards
    # 8 gives its (dp=1, lib=8) mesh, --num_shards 4 its (dp=2, lib=4).
    want = str(tmp / f"jax_sharded_{dp}x{n_shards}.mztab")
    assert jax_main(_args(lib_path, query_path, want)
                    + ["--num_shards", str(n_shards)]) == 0
    got_psms, want_psms = _psms(out), _psms(want)
    assert sorted(got_psms) == sorted(want_psms)
    ids = sorted(want_psms)
    assert [got_psms[i][0] for i in ids] == [want_psms[i][0] for i in ids]
    np.testing.assert_allclose([got_psms[i][1] for i in ids],
                               [want_psms[i][1] for i in ids], rtol=1e-5)
