"""`--model svm` and `--model rf` on the engine's own features: the port
against the JAX package's own spread.

Engine corpora made by `synthdata.make_corpus` (2,000 peptides, 1,000
queries, seed 42) with QUALITY's 5% of foreign queries and with 30% (on
the first every model accepts nearly every target, so the second makes
the decoy competition decide), each searched by both CLIs in ``--mode
bf`` (the two engines write identical SSMs under ``--model none``, so
only the models differ), with QUALITY's settings and a 1% FDR:

* the JAX CLI with ``--model svm`` three times, liblinear fed its
  training rows in three orders (as given, and two permutations), and
  with ``--model rf`` for the forests' ``random_state`` 1 (its own), 2
  and 3;
* the port's CLI (``--no_gpu``) once with each model.

It prints the confident PSMs (targets at q < 0.01) of every run, the
overlap of each run's confident PSM_IDs with the JAX package's own run
(svm rows as given, rf ``random_state`` 1), and whether the port falls
within the JAX runs' range.  The table quoted in `PERF.md` §6 and the rule
in `ROADMAP.md` §C come from this script.  Not a test (about 15 minutes a
corpus on one CPU core); run it from the repository's root, with the
shares of foreign queries to run (default both):

    JAX_PLATFORMS=cpu python tests/torch_fdr_engine_models.py [workdir] \
        [frac_foreign ...]
"""

import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import ann_solo_tpu.fdr as jax_fdr  # noqa: E402
import ann_solo_tpu.search as jax_search  # noqa: E402
from ann_solo_tpu.cli import main as jax_cli  # noqa: E402
from ann_solo_tpu_torch.cli import main as torch_cli  # noqa: E402
from ann_solo_tpu_torch.eval import confident_targets  # noqa: E402
from ann_solo_tpu_torch.io.mgf import write_mgf  # noqa: E402
from ann_solo_tpu_torch.io.mztab import read_mztab_ssms  # noqa: E402
from ann_solo_tpu_torch.io.splib import write_splib  # noqa: E402
from ann_solo_tpu_torch.quality import _cli_args  # noqa: E402
from ann_solo_tpu_torch.synthdata import make_corpus  # noqa: E402

N_PEPTIDES, N_QUERIES, SEED, FDR = 2000, 1000, 42, 0.01
FRAC_FOREIGN = (0.05, 0.30)


class Settings:
    """QUALITY's search settings, `--mode bf`."""

    open_tolerance = 300.0
    num_list = 0
    num_probe = 256
    num_candidates = 1024
    index_dtype = "int8"
    fdr = FDR

    def __init__(self, model, no_gpu):
        self.model = model
        self.no_gpu = no_gpu


def confident(path):
    return set(confident_targets(read_mztab_ssms(path), FDR).index)


def permuted_svm(seed):
    """`LinearSVC` fed its training rows in the order of a permutation
    drawn from `seed` (None: as given)."""
    real = jax_fdr.LinearSVC

    class Permuted(real):
        def fit(self, X, y, *args, **kwargs):
            if seed is not None:
                order = np.random.default_rng(seed).permutation(len(y))
                X, y = X[order], np.asarray(y)[order]
            return super().fit(X, y, *args, **kwargs)

    return Permuted


def seeded_forest(random_state):
    real = jax_fdr.RandomForestClassifier

    def forest(random_state=1, _seed=random_state, **settings):
        return real(random_state=_seed, **settings)

    return forest


def run_jax(lib, queries, out, model, value):
    saved = (jax_fdr.LinearSVC, jax_fdr.RandomForestClassifier,
             jax_search.SpectralLibrary._make_library_mesh)
    jax_search.SpectralLibrary._make_library_mesh = staticmethod(
        lambda: None)
    if model == "svm":
        jax_fdr.LinearSVC = permuted_svm(value)
    else:
        jax_fdr.RandomForestClassifier = seeded_forest(value)
    try:
        assert jax_cli(_cli_args(lib, queries, out, "bf",
                                 Settings(model, False))) == 0
    finally:
        (jax_fdr.LinearSVC, jax_fdr.RandomForestClassifier,
         jax_search.SpectralLibrary._make_library_mesh) = saved
    return confident(out)


def main(workdir=None, fracs=FRAC_FOREIGN):
    root = workdir or tempfile.mkdtemp(prefix="fdr_engine_models_")
    for frac in fracs:
        compare(os.path.join(root, f"foreign_{frac:g}"), frac)
    return 0


def compare(workdir, frac_foreign):
    os.makedirs(workdir, exist_ok=True)
    lib = os.path.join(workdir, "library.splib")
    queries = os.path.join(workdir, "queries.mgf")
    if not (os.path.isfile(lib) and os.path.isfile(queries)):
        library, query_spectra, _ = make_corpus(
            np.random.default_rng(SEED), N_PEPTIDES, N_QUERIES,
            frac_foreign=frac_foreign)
        write_splib(library, lib)
        write_mgf(query_spectra, queries)
    print(f"corpus: {N_PEPTIDES} peptides, {N_QUERIES} queries "
          f"({frac_foreign:.0%} foreign), seed {SEED}, --mode bf, {FDR} "
          f"FDR ({workdir})", flush=True)
    for model, label, values in (("svm", "row order", (None, 1, 2)),
                                 ("rf", "random_state", (1, 2, 3))):
        runs = {}
        for value in values:
            out = os.path.join(workdir, f"jax_{model}_{value}.mztab")
            runs[value] = run_jax(lib, queries, out, model, value)
            print(f"JAX {model} {label} {value}: {len(runs[value])} "
                  "confident", flush=True)
        out = os.path.join(workdir, f"torch_{model}.mztab")
        assert torch_cli(_cli_args(lib, queries, out, "bf",
                                   Settings(model, True))) == 0
        port = confident(out)
        own = runs[values[0]]
        counts = [len(r) for r in runs.values()]
        for value, ids in list(runs.items())[1:] + [("port", port)]:
            print(f"{model} {value}: {len(ids)} confident, "
                  f"{len(ids & own)} shared with the JAX run's own "
                  f"({len(own)}), {len(ids - own)} not in it, "
                  f"{len(own - ids)} missing", flush=True)
        low, high = min(counts), max(counts)
        gap = max(low - len(port), len(port) - high, 0)
        verdict = "within" if gap == 0 else f"outside by {gap}"
        print(f"{model}: JAX {counts} (range {low}-{high}); port "
              f"{len(port)}: {verdict} the JAX runs' range", flush=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else None,
                  [float(v) for v in sys.argv[2:]] or FRAC_FOREIGN))
