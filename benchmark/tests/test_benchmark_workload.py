"""The generator and the lookup of a cell's files by name."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import harness, workload
from benchmark.tests.conftest import tiny_config, tiny_traffic


def _make(seed, traffic):
    gen = torch.Generator()
    gen.manual_seed(seed)
    cfg = tiny_config()
    lib = workload.make_library(gen, cfg, torch.device("cpu"))
    return lib, workload.make_pool(gen, lib, cfg, traffic)


@pytest.mark.parametrize("mix", ["self", "openmod"])
def test_generator_is_deterministic_for_a_seed(mix):
    lib_a, pool_a = _make(5, tiny_traffic(mix))
    lib_b, pool_b = _make(5, tiny_traffic(mix))
    _, pool_c = _make(6, tiny_traffic(mix))
    for name in ("mz", "intensity", "ann", "prec"):
        assert torch.equal(getattr(lib_a, name), getattr(lib_b, name))
    for a, b in zip(pool_a, pool_b):
        assert torch.equal(a.mz, b.mz) and torch.equal(a.intensity,
                                                       b.intensity)
        assert np.array_equal(a.prec, b.prec)
        assert np.array_equal(a.source, b.source)
    assert not torch.equal(pool_a[0].mz, pool_c[0].mz)


def test_library_rows_sorted_and_unit_norm():
    lib, _ = _make(1, tiny_traffic("self"))
    assert bool((lib.prec[1:] >= lib.prec[:-1]).all())
    assert bool((lib.mz[:, 1:] >= lib.mz[:, :-1]).all())
    norms = torch.linalg.vector_norm(lib.intensity, dim=1)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-5)


def test_self_mix_is_noised_copies_of_distinct_rows():
    lib, pool = _make(2, tiny_traffic("self"))
    for batch in pool:
        assert (batch.source >= 0).all()
        assert len(set(batch.source.tolist())) == len(batch.source)
        src = torch.as_tensor(batch.source)
        assert float((batch.mz - lib.mz[src]).abs().max()) < 0.05
        assert np.abs(batch.prec - lib.prec[src].numpy()).max() < 0.02


def test_openmod_shares_and_mass_profile():
    traffic = tiny_traffic("openmod")
    traffic["batch"] = 200
    cfg = tiny_config()
    lib, pool = _make(3, traffic)
    counts = workload.exact_counts([0.60, 0.35, 0.05], 200)
    assert counts.tolist() == [120, 70, 10]
    want = workload.exact_counts(traffic["mod_weights"], 70)
    assert want.sum() == 70
    masses = np.asarray(traffic["mod_masses"])
    for batch in pool:
        kinds = np.bincount(batch.kind, minlength=3)
        assert kinds.tolist() == counts.tolist()
        assert ((batch.source < 0) == (batch.kind == 2)).all()
        mod = np.nonzero(batch.kind == 1)[0]
        # The precursor moved by delta / charge (noise 0.002): recover
        # each delta and hold the multiset to the profile's counts.
        src = batch.source[mod]
        delta = (batch.prec[mod] - lib.prec[src].numpy()) * cfg["charge"]
        nearest = np.abs(delta[:, None] - masses[None]).argmin(1)
        assert np.abs(delta - masses[nearest]).max() < 0.02
        assert np.bincount(nearest, minlength=len(masses)).tolist() == \
            want.tolist()


def test_modified_fragments_move_by_delta_over_their_charge():
    traffic = tiny_traffic("openmod")
    traffic["noise"] = {"mz_sd": 0.0, "intensity_sd": 0.0,
                        "precursor_sd": 0.0}
    cfg = tiny_config()
    lib, pool = _make(4, traffic)
    batch = pool[0]
    for q in np.nonzero(batch.kind == 1)[0][:10]:
        s = int(batch.source[q])
        delta = (batch.prec[q] - float(lib.prec[s])) * cfg["charge"]
        ann = lib.ann[s].numpy()
        lib_mz = lib.mz[s].numpy().astype(np.float64)
        got = np.sort(batch.mz[q].numpy().astype(np.float64))
        # Some cut c: peaks at index >= c with an annotation moved.
        fits = []
        for cut in range(len(lib_mz) + 1):
            moved = lib_mz + np.where((np.arange(len(lib_mz)) >= cut)
                                      & (ann >= 1),
                                      delta / np.maximum(ann, 1), 0.0)
            fits.append(np.abs(np.sort(moved) - got).max())
        assert min(fits) < 1e-3


def test_unknown_query_kind_is_refused():
    traffic = tiny_traffic("self")
    traffic["kinds"] = {"noised": 0.5, "decoy": 0.5}
    with pytest.raises(ValueError, match="unknown query kinds"):
        _make(1, traffic)


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix, check limits and a per-layer metric
    dropped into the folders as new files are found by name."""
    from benchmark.tests.conftest import make_root

    root = make_root(tmp_path)
    bench = os.path.join(root, "benchmark")
    spec = workload.load_spec(root)
    cfg = dict(tiny_config(), n_library=1024)
    with open(os.path.join(bench, "configs", "other.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", "bursty.json"), "w") as f:
        json.dump(dict(tiny_traffic(), batch=8), f)
    with open(os.path.join(bench, "checks", "other.bursty.json"), "w") as f:
        json.dump({"sample": 1, "limits": {}}, f)
    with open(os.path.join(bench, "metrics", "new.metric-1.py"), "w") as f:
        f.write("def read(record):\n    return record.n_batches * 2.0\n")
    spec["configs"].append({"name": "other", "source": "test",
                            "file": "benchmark/configs/other.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "other.bursty", "config": "other",
                              "traffic": "bursty", "chips": 1, "why": "t"})
    spec["per_layer"].append({"name": "new.metric-1", "unit": "x",
                              "better": "higher", "source": "program_counter",
                              "layer": "search", "moves": "queries_per_s",
                              "workloads": ["other.bursty"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    spec = workload.load_spec(root)
    cell = workload.find_cell(spec, "other.bursty")
    assert workload.load_config(root, spec, cell["config"])["n_library"] \
        == 1024
    assert workload.load_traffic(root, cell["traffic"])["batch"] == 8
    assert workload.load_limits(root, "other.bursty")["sample"] == 1
    names = [m["name"] for m in harness.cell_metrics(spec, "other.bursty",
                                                      "per_layer")]
    assert "new.metric-1" in names
    assert "new.metric-1" not in [
        m["name"] for m in harness.cell_metrics(spec, "tiny.openmod",
                                                "per_layer")]
    record = type("R", (), {"n_batches": 3})()
    assert harness.load_reader(root, "new.metric-1")(record) == 6.0
    with pytest.raises(KeyError):
        workload.find_cell(spec, "missing.cell")
