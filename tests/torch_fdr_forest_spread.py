"""How far one random stream moves the forest's identifications.

Prints, for `test_fdr_parity._planted` at data seeds 19-22, the targets at
q < 0.01 after `brew(..., model="rf")`:

* of the JAX package (scikit-learn) for ``random_state`` 1 (its own) to 4,
  with the grid winners of ``random_state=1``;
* of the port with its own grid search;
* of the port with the JAX package's grid winners given.

The numbers quoted in `tests/test_torch_fdr_models.py`, `ROADMAP.md` and
`PERF.md` come from this script.  Not a test (about 8 minutes on 8 CPU
cores); run it from the repository's root:

    JAX_PLATFORMS=cpu python tests/torch_fdr_forest_spread.py
"""

import os
import sys

import numpy as np
from sklearn.ensemble import RandomForestClassifier
from sklearn.model_selection import GridSearchCV

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ann_solo_tpu import fdr as jax_fdr  # noqa: E402
from ann_solo_tpu_torch import fdr  # noqa: E402
from test_fdr_parity import _ids_and_fdp, _planted  # noqa: E402


def jax_brew(X, is_target, init, random_state):
    """(scores, grid winners) of the JAX package's `brew` with its forests
    seeded with `random_state` in place of 1."""
    winners = []

    class Recording(GridSearchCV):
        def fit(self, X, y=None, **params):
            super().fit(X, y, **params)
            winners.append(self.best_params_)
            return self

    def forest(random_state=1, _seed=random_state, **settings):
        return RandomForestClassifier(random_state=_seed, **settings)

    saved = jax_fdr.GridSearchCV, jax_fdr.RandomForestClassifier
    jax_fdr.GridSearchCV, jax_fdr.RandomForestClassifier = Recording, forest
    try:
        scores = jax_fdr.brew(X, is_target, init, 0.05, "rf")
    finally:
        jax_fdr.GridSearchCV, jax_fdr.RandomForestClassifier = saved
    return scores, winners


def port_brew(X, is_target, init, winners=None):
    saved = fdr.grid_search_forest
    if winners is not None:
        given = iter(winners)
        fdr.grid_search_forest = lambda *a, **k: (next(given), None)
    try:
        return fdr.brew(X, is_target, init, 0.05, "rf", device="cpu")
    finally:
        fdr.grid_search_forest = saved


def main():
    for seed in (19, 20, 21, 22):
        X, is_target, is_true, init = _planted(np.random.default_rng(seed))

        def ids(scores):
            return _ids_and_fdp(scores, is_target, is_true)[0]

        streams, winners = [], None
        for random_state in (1, 2, 3, 4):
            scores, won = jax_brew(X, is_target, init, random_state)
            winners = winners or won
            streams.append(ids(scores))
        print(f"seed {seed}: JAX random_state 1-4 {streams}; "
              f"port own grid {ids(port_brew(X, is_target, init))}; "
              f"port with the reference's winners "
              f"{ids(port_brew(X, is_target, init, winners))}; "
              f"winners {winners}", flush=True)


if __name__ == "__main__":
    main()
