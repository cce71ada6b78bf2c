"""The port imports nothing of the JAX package nor what the GPU machine
lacks, has a counterpart of every JAX module, and its copies of what it
needed from there equal the originals.

Every module of `ann_solo_tpu_torch/` (`parallel/` included) and
`chip_smoke.py` is parsed with `ast`: no `import` or `from ... import`
anywhere in it (at top level or inside a function) may name
`ann_solo_tpu`, `jax`, `jaxlib`, `ml_dtypes`, `pandas`, `h5py` or
`sklearn`, or a submodule of one; `matplotlib` only inside
`plot.py::mirror_plot`.  Every module of `ann_solo_tpu/` has a module of
the same path in `ann_solo_tpu_torch/` or is listed with the reason it
has none.  The port's MurmurHash3 bin table and mass constants are held
equal to the JAX package's here; the other copies in
`test_torch_engine_*.py`.
"""

import ast
import os

import numpy as np
import pytest

from ann_solo_tpu.io import masses as jax_masses
from ann_solo_tpu.ops import murmur as jax_murmur
from ann_solo_tpu_torch.io import masses
from ann_solo_tpu_torch.ops import murmur

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCES = sorted(
    os.path.relpath(os.path.join(root, name), REPO)
    for root, _, names in os.walk(os.path.join(REPO, "ann_solo_tpu_torch"))
    for name in names if name.endswith(".py")
) + ["chip_smoke.py"]


# Modules of the JAX package without a counterpart of the same path.
NO_COUNTERPART = {
    "ops/shifted_dot_pallas.py": "kernel B1: csrc/shifted_dot.cu, "
                                 "ops/shifted_dot_cuda.py",
    "ops/ivf_probe_pallas.py": "kernel B2: csrc/ivf_probe_scan.cu, "
                               "ops/ivf_probe_cuda.py",
    "ops/ivf_scan_pallas.py": "kernel B3: csrc/ivf_chunked_scan.cu, "
                              "ops/ivf_scan_cuda.py",
    "prosit.py": "a Koina client (koinapy, pandas, the network): the port "
                 "predicts FASTA spectra locally (io/fasta.py)",
    "utils/jax_cache.py": "XLA's compilation cache: the port's kernels are "
                          "cached by ops/_build.py in build/kernels/",
}
_NOT_ON_THE_GPU_MACHINE = ("ann_solo_tpu", "jax", "jaxlib", "ml_dtypes",
                           "pandas", "h5py", "sklearn")


def _modules(package):
    root = os.path.join(REPO, package)
    return {os.path.relpath(os.path.join(d, name), root)
            for d, _, names in os.walk(root) for name in names
            if name.endswith(".py")}


def _imported_modules(path, skip_function=None):
    """Every module name an import statement in `path` names (outside the
    function named `skip_function`)."""
    tree = ast.parse(open(os.path.join(REPO, path)).read(), path)
    skipped = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == skip_function:
            skipped.update(id(n) for n in ast.walk(node))
    for node in ast.walk(tree):
        if id(node) in skipped:
            continue
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            yield from (f"{node.module}.{alias.name}" for alias in node.names)


def test_sources_found():
    assert "ann_solo_tpu_torch/models/vectorize.py" in _SOURCES
    assert "ann_solo_tpu_torch/models/preprocess.py" in _SOURCES
    for name in ("mesh", "collectives", "sharded", "sharded_ivf"):
        assert f"ann_solo_tpu_torch/parallel/{name}.py" in _SOURCES
    assert len(_SOURCES) > 15


@pytest.mark.parametrize("path", _SOURCES)
def test_no_import_of_the_jax_package(path):
    bad = [name for name in _imported_modules(path)
           if name.split(".")[0] in _NOT_ON_THE_GPU_MACHINE]
    assert not bad, f"{path} imports {bad}"
    plotting = [name for name in _imported_modules(path, "mirror_plot")
                if name.split(".")[0] == "matplotlib"]
    assert not plotting, f"{path} imports {plotting}"


def test_every_jax_module_has_a_counterpart():
    """Each module of `ann_solo_tpu/` has one of the same path in the
    port, or a reason in `NO_COUNTERPART`; no reason is left over for a
    module that exists in the port or no longer exists."""
    jax_modules = _modules("ann_solo_tpu")
    port_modules = _modules("ann_solo_tpu_torch")
    missing = jax_modules - port_modules - set(NO_COUNTERPART)
    assert not missing, f"no counterpart and no reason: {sorted(missing)}"
    assert set(NO_COUNTERPART) <= jax_modules - port_modules
    for path in ("quality.py", "sweep.py", "eval.py", "plot.py",
                 "io/fasta.py"):
        assert path in port_modules
    for name in ("csrc/shifted_dot.cu", "csrc/ivf_probe_scan.cu",
                 "csrc/ivf_chunked_scan.cu", "ops/_build.py"):
        assert os.path.isfile(os.path.join(REPO, "ann_solo_tpu_torch", name))


@pytest.mark.parametrize("n_bins,hash_len,seed", [
    (1, 800, 42), (50_000, 800, 42), (1000, 1, 42), (12_345, 97, 0),
    (3000, 4096, 7),
])
def test_hash_bin_table_equals_jax(n_bins, hash_len, seed):
    got = murmur.hash_bin_table(n_bins, hash_len, seed)
    want = jax_murmur.hash_bin_table(n_bins, hash_len, seed)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_hash_bin_table_default_seed_is_42():
    np.testing.assert_array_equal(murmur.hash_bin_table(500, 800),
                                  jax_murmur.hash_bin_table(500, 800, 42))


def test_mass_constants_equal_jax():
    assert masses.PROTON == jax_masses.PROTON
    assert masses.NEUTRON == jax_masses.NEUTRON
    # The port's copy has every public name of the original (their values
    # are held equal in test_torch_engine_io.py).
    public = {n for n in dir(jax_masses) if not n.startswith("_")}
    assert public <= set(dir(masses))
    for name in public:
        value = getattr(jax_masses, name)
        if isinstance(value, (int, float, str, dict, tuple)):
            assert getattr(masses, name) == value, name
