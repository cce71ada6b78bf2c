"""The port imports nothing of the JAX package, and its copies of what it
needed from there equal the originals.

Every module of `ann_solo_tpu_torch/` (`parallel/` included) and
`chip_smoke.py` is parsed with `ast`: no `import` or `from ... import`
anywhere in it (at top level or inside a function) may name
`ann_solo_tpu`, `jax` or `jaxlib`, or a submodule of one.  The
port's MurmurHash3 bin table and mass constants are held equal to the JAX
package's here; the other copies in `test_torch_engine_*.py`.
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


def _imported_modules(path):
    """Every module name an import statement in `path` names."""
    tree = ast.parse(open(os.path.join(REPO, path)).read(), path)
    for node in ast.walk(tree):
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
           if name.split(".")[0] in ("ann_solo_tpu", "jax", "jaxlib")]
    assert not bad, f"{path} imports {bad}"


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
