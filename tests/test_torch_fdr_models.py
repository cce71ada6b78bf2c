"""The port's rescoring models (`--model svm|rf`) against scikit-learn and
the JAX package, on the CPU.

The deterministic pieces are held to scikit-learn itself: the scaler chain
(same kept columns, rtol 1e-12), the linear SVM (`LinearSVC(dual="auto",
max_iter=5000)`; tolerances below), the stratified folds, the grid's order
and tie rule, and one tree without bootstrap on integer-valued features
against `DecisionTreeClassifier`.  The random forest cannot reproduce
scikit-learn's random stream, so `brew` is held to the JAX package's own
planted-truth criteria (`tests/test_fdr_parity.py`, `tests/test_fdr_rf.py`)
and to its identification counts on the same planted data.

The planted sets are `test_fdr_parity._planted` (900 true targets, 600
false targets, 1,500 decoys, 20 features) from that file's data seed 19
and from 20, 21 and 22.  The SVM is liblinear's own solver, so the port's
`brew` scores equal the JAX package's there (3e-15 measured).  The
forest's bootstraps are scikit-learn's own and its class weights work as
scikit-learn 1.9's, but its feature subsets are another stream, and
identifications at q < 0.01 hinge on the rank of the sixth or seventh
decoy: on seed 19 scikit-learn itself reads 701, 320, 736 and 708 for
random_state 1-4.  Measured on seeds 19-22 (scikit-learn 1.9, by
`tests/torch_fdr_forest_spread.py`):

    JAX package `brew`                        701  713  725  450
    port, the reference's grid winners        669  724  703  462
    port, its own grid search                 638  691  714  462

Each grid is decided by one held-out row in about 1,350 (the reference's
top settings lie 0.0007 apart), so the winners differ in some folds
(seed 19, fold 2: depth 7 against no limit) and the forest is held to
the 5% with the reference's winners given; with its own grid it is held
to the planted criteria and to the reference at q < 0.05, where the
reading does not hang on single decoys (864/872, 849/841, 847/845,
851/846).  On seed 22 the reference itself (450) is under the JAX test's
floor of 0.6 x 900, which that test meets on its seed 19 only; there the
floor is the reference's count less 5%.
"""

import functools

import numpy as np
import pytest
import torch
from sklearn.ensemble import RandomForestClassifier
from sklearn.feature_selection import VarianceThreshold
from sklearn.model_selection import GridSearchCV, ParameterGrid
from sklearn.model_selection import StratifiedKFold
from sklearn.pipeline import make_pipeline
from sklearn.preprocessing import StandardScaler
from sklearn.svm import LinearSVC
from sklearn.tree import DecisionTreeClassifier

from ann_solo_tpu import fdr as jax_fdr
from ann_solo_tpu_torch import fdr
from ann_solo_tpu_torch.models import rescoring
from ann_solo_tpu_torch.models.spectrum import Spectrum
from ann_solo_tpu_torch.models.spectrum import SpectrumSpectrumMatch

from test_fdr import FakeConfig
from test_fdr_parity import _ids_and_fdp, _planted

PLANTED_SEEDS = (19, 20, 21, 22)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The forest runs thousands of small torch ops; under a test runner
    with several workers their thread pools fight over the cores (a 9 s
    fit took minutes).  One thread per worker keeps the file's time
    bounded."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------- #
# Scaler chain


@pytest.mark.parametrize("seed", [0, 1])
def test_scaler_chain_equals_sklearn_pipeline(seed):
    """Fit on 300 rows, applied to 500; a constant column (dropped by the
    variance threshold), an affine copy and a near copy of earlier columns
    (dropped by the correlation threshold).  Same kept columns; values at
    rtol 1e-12 (the two sum a column's mean in different orders)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(500, 12)) * rng.uniform(0.1, 50, 12) + 3.0
    X[:, 3] = 0.1
    X[:, 7] = 2.0 * X[:, 2] + 1.0
    X[:, 9] = X[:, 1] + 0.01 * rng.normal(size=500)
    pipe = make_pipeline(StandardScaler(), VarianceThreshold(),
                         jax_fdr.CorrelationThreshold(0.95))
    want = pipe.fit(X[:300]).transform(X)
    kept = np.nonzero(pipe[1].get_support())[0][pipe[2].get_support()]
    chain = fdr._make_scaler().fit(X[:300])
    assert list(chain.support_) == list(kept)
    assert set(range(12)) - set(kept) == {3, 7, 9}
    np.testing.assert_allclose(chain.transform(X), want, rtol=1e-12,
                               atol=1e-13)
    np.testing.assert_allclose(fdr._make_scaler().fit_transform(X[:300]),
                               want[:300], rtol=1e-12, atol=1e-13)


def test_scaler_chain_refuses_all_constant_columns():
    with pytest.raises(ValueError, match="variance threshold"):
        fdr._make_scaler().fit(np.ones((10, 3)))


# --------------------------------------------------------------------- #
# Linear SVM


def _svm_problem(seed):
    rng = np.random.default_rng(seed)
    n = 400
    X = rng.normal(size=(n, 10))
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.7 * rng.normal(size=n) > 0.3)
    return X, y.astype(int)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_linear_svm_equals_linearsvc(seed):
    """Coefficients and intercept against `LinearSVC(dual="auto",
    max_iter=5000)`.  The port runs liblinear's own trust-region Newton
    method to liblinear's own stopping point: measured gaps 6e-17, 3e-16
    and 2e-16 on coefficients of size 0.9, and 1.3e-15 on the decision
    values, so atol 1e-14 (ten times the largest).  Liblinear run to
    tolerance 1e-12 lies 2e-5 to 6e-5 away from both."""
    X, y = _svm_problem(seed)
    got = rescoring.LinearSVM().fit(X, y)
    want = LinearSVC(dual="auto", max_iter=5000).fit(X, y)
    np.testing.assert_allclose(got.coef_, want.coef_[0], rtol=0, atol=1e-14)
    np.testing.assert_allclose(got.intercept_, want.intercept_[0], rtol=0,
                               atol=1e-14)
    np.testing.assert_allclose(got.decision_function(X),
                               want.decision_function(X), rtol=0, atol=1e-14)
    tight = LinearSVC(dual="auto", max_iter=100000, tol=1e-12).fit(X, y)
    assert 1e-6 < np.abs(got.coef_ - tight.coef_[0]).max() < 6e-4


def test_linear_svm_penalizes_the_intercept():
    """liblinear regularizes the intercept (a constant feature appended):
    on shifted data an unpenalized intercept is another model.  Shifted
    data takes more Newton steps; measured gap 1.8e-10, atol 2e-9."""
    X, y = _svm_problem(3)
    X = X + 4.0
    got = rescoring.LinearSVM().fit(X, y)
    want = LinearSVC(dual="auto", max_iter=5000).fit(X, y)
    np.testing.assert_allclose(got.coef_, want.coef_[0], rtol=0, atol=2e-9)
    np.testing.assert_allclose(got.intercept_, want.intercept_[0], rtol=0,
                               atol=2e-9)
    # Solving the same data with the constant column left unpenalized
    # (centred features) moves the decision values by far more.
    centred = rescoring.LinearSVM().fit(X - X.mean(0), y)
    gap = np.abs(centred.decision_function(X - X.mean(0))
                 - got.decision_function(X)).max()
    assert gap > 1e-2


# --------------------------------------------------------------------- #
# Folds and grid


@pytest.mark.parametrize("labels", ["balanced", "flipped", "rare"])
def test_stratified_folds_equal_sklearn(labels):
    rng = np.random.default_rng(7)
    y = rng.integers(0, 2, 100)
    if labels == "flipped":
        y = 1 - y
    elif labels == "rare":
        y = np.r_[np.zeros(7, int), np.ones(50, int)][rng.permutation(57)]
    got = rescoring.stratified_folds(y, 3)
    for fold, (_, test) in enumerate(StratifiedKFold(3).split(y, y)):
        np.testing.assert_array_equal(np.nonzero(got == fold)[0], test)


def test_stratified_folds_refuse_too_few_members():
    with pytest.raises(ValueError, match="n_splits=3"):
        rescoring.stratified_folds(np.array([0, 1, 1, 0]), 3)


def test_grid_order_and_tie_rule():
    """`ParameterGrid` order (class_weight outer, max_depth inner), the
    JAX package's grid value for value, and ties to the first setting."""
    assert fdr._RF_PARAM_GRID == jax_fdr._RF_PARAM_GRID
    settings = rescoring.param_grid(fdr._RF_PARAM_GRID)
    assert settings == list(ParameterGrid(jax_fdr._RF_PARAM_GRID))
    assert settings[0] == {"class_weight": None, "max_depth": 3}
    assert settings[4] == {"class_weight": None, "max_depth": None}
    assert settings[5] == {"class_weight": {0: 0.1, 1: 1}, "max_depth": 3}
    scores = np.full(len(settings), 0.9)
    assert rescoring.grid_winner(scores) == 0
    scores[[12, 30]] = 0.95
    assert rescoring.grid_winner(scores) == 12
    scores[33] = 0.96
    assert rescoring.grid_winner(scores) == 33


def test_grid_search_picks_its_own_best_mean():
    """The grid search's answer is `grid_winner` of its own table, and a
    forest grown with max_depth = d is the unlimited forest cut at d: the
    search reads every depth off one growth per class weight and fold."""
    rng = np.random.default_rng(11)
    X = rng.normal(size=(240, 6))
    y = (X[:, 0] + X[:, 1] * X[:, 2] + 0.5 * rng.normal(size=240) > 0)
    y = y.astype(int)
    best, means = rescoring.grid_search_forest(X, y, device="cpu")
    settings = rescoring.param_grid()
    assert best == settings[rescoring.grid_winner(means)]
    assert len(means) == 35 and all(0.0 <= m <= 1.0 for m in means)
    # One setting recomputed the long way: three forests, each fitted
    # (and so binned) on its fold's training rows with its own depth
    # limit, as `GridSearchCV` fits them.
    setting = settings[7]  # {0: 0.1, 1: 1}, max_depth 7
    assert setting == {"class_weight": {0: 0.1, 1: 1}, "max_depth": 7}
    folds = rescoring.stratified_folds(y, 3)
    scores = []
    for fold in range(3):
        train, held = folds != fold, folds == fold
        forest = rescoring.RandomForest(device="cpu", **setting)
        predicted = forest.fit(X[train], y[train]).predict_proba1(X[held])
        scores.append(float(((predicted > 0.5) == y[held]).mean()))
    assert means[7] == sum(scores) / 3


# --------------------------------------------------------------------- #
# Trees


@pytest.mark.parametrize("max_depth", [1, 2, 3])
def test_single_tree_equals_decision_tree(max_depth):
    """One tree, no bootstrap, every feature a candidate, on features with
    12 integer values (searched exactly): the class-1 fraction of every
    training row's leaf equals `DecisionTreeClassifier`'s (atol 1e-15).
    Random labels with structure, so no two splits tie in gain."""
    rng = np.random.default_rng(5)
    n = 300
    X = rng.integers(0, 12, size=(n, 6)).astype(float)
    y = ((X[:, 0] > 5) ^ (X[:, 1] > 3)) | (X[:, 2] > 9)
    y = np.where(rng.random(n) < 0.1, ~y, y).astype(int)
    tree = rescoring.RandomForest(max_depth=max_depth, n_trees=1,
                                  bootstrap=False, max_features=None,
                                  device="cpu")
    got = tree.fit(X, y).predict_proba1(X)
    want = DecisionTreeClassifier(max_depth=max_depth, random_state=0)
    want = want.fit(X, y).predict_proba(X)[:, 1]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)
    assert len(np.unique(got)) > 1


@pytest.mark.parametrize("class_weight", [None, {0: 10, 1: 0.1},
                                          {0: 0.1, 1: 1}])
def test_bootstrap_draws_equal_sklearn(class_weight):
    """The rows every tree draws are `RandomForestClassifier(
    random_state=1)`'s own (`estimators_samples_`), uniform without a
    class weight and with probability proportional to it with one."""
    rng = np.random.default_rng(17)
    X = rng.normal(size=(150, 4))
    y = (X[:, 0] + rng.normal(size=150) > 0.4).astype(int)
    want = RandomForestClassifier(random_state=1, class_weight=class_weight,
                                  max_depth=2).fit(X, y)
    got = rescoring.bootstrap_counts(
        150, rescoring._row_weight(class_weight, y))
    assert got.shape == (100, 150) and (got.sum(axis=1) == 150).all()
    for t, rows in enumerate(want.estimators_samples_):
        np.testing.assert_array_equal(got[t], np.bincount(rows,
                                                          minlength=150))


def test_forest_is_deterministic_and_weighs_classes():
    """A class weight moves the forest as it moves scikit-learn 1.9's:
    through the bootstrap draws.  With {0: 10, 1: 0.1} nearly every drawn
    row is of class 0 and so is nearly every prediction, in both."""
    rng = np.random.default_rng(13)
    X = rng.normal(size=(300, 9))
    y = (X[:, 0] + 0.8 * rng.normal(size=300) > 0.5).astype(int)

    def forest(**settings):
        return rescoring.RandomForest(device="cpu", **settings).fit(X, y)

    a = forest().predict_proba1(X)
    b = forest().predict_proba1(X)
    np.testing.assert_array_equal(a, b)
    assert ((a > 0.5) == y).mean() > 0.95  # unlimited trees fit their rows
    up = forest(class_weight={0: 0.1, 1: 10}, max_depth=3).predict_proba1(X)
    down = forest(class_weight={0: 10, 1: 0.1}, max_depth=3).predict_proba1(X)
    assert up.mean() > a.mean() + 0.1
    assert down.mean() < a.mean() - 0.1
    for class_weight, got in (({0: 0.1, 1: 10}, up), ({0: 10, 1: 0.1}, down)):
        want = RandomForestClassifier(
            random_state=1, class_weight=class_weight, max_depth=3,
        ).fit(X, y).predict_proba(X)[:, 1]
        # Same draws, other feature subsets: measured 0.003 and 0.011.
        assert abs(got.mean() - want.mean()) < 0.03
        assert ((got > 0.5) == (want > 0.5)).mean() > 0.97


# --------------------------------------------------------------------- #
# brew


@functools.lru_cache(maxsize=None)
def _planted_set(seed):
    return _planted(np.random.default_rng(seed))


@functools.lru_cache(maxsize=None)
def _port_scores(seed, model):
    """The port's `brew` with its own grid search."""
    X, is_target, _, init = _planted_set(seed)
    return fdr.brew(X, is_target, init, train_fdr=0.05, model=model,
                    device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_scores(seed, model):
    """(scores, grid winners in fold order) of the JAX package's `brew`."""
    winners = []

    class Recording(GridSearchCV):
        def fit(self, X, y=None, **params):
            super().fit(X, y, **params)
            winners.append(self.best_params_)
            return self

    X, is_target, _, init = _planted_set(seed)
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_fdr, "GridSearchCV", Recording)
        scores = jax_fdr.brew(X, is_target, init, train_fdr=0.05, model=model)
    return scores, winners


def _ids_at(scores, is_target, level):
    q = fdr.tdc_qvalues(scores, is_target)
    return int((is_target & (q < level)).sum())


@pytest.mark.parametrize("seed", PLANTED_SEEDS)
@pytest.mark.parametrize("model", ["svm", "rf"])
def test_brew_controls_fdr_and_beats_initial_score(model, seed):
    """`tests/test_fdr_parity.py`'s criteria on its own seed 19 and on
    20-22: actual FDP <= 0.03 at q < 0.01, IDs >= 0.6 x the planted trues
    and >= 1.3 x the initial score's.  Where the JAX package's own `brew`
    is under 0.6 x the planted trues (rf on seed 22: 450), the floor is
    its count less 5%."""
    _, is_target, is_true, init = _planted_set(seed)
    baseline_ids, _ = _ids_and_fdp(init, is_target, is_true)
    ids, fdp = _ids_and_fdp(_port_scores(seed, model), is_target, is_true)
    n_true = int(is_true.sum())
    floor = 0.6 * n_true
    if ids < floor:
        want, _ = _ids_and_fdp(_jax_scores(seed, model)[0], is_target,
                               is_true)
        if want < floor:
            floor = 0.95 * want
    assert fdp <= 0.03, f"{model}: actual FDP {fdp:.3f} at q<0.01"
    assert ids >= floor, f"{model}: only {ids}/{n_true} IDs"
    assert ids >= 1.3 * max(baseline_ids, 1), (
        f"{model}: {ids} IDs vs baseline {baseline_ids}")


@pytest.mark.parametrize("seed", PLANTED_SEEDS)
def test_brew_svm_equals_the_jax_package(seed):
    """The SVM is liblinear's solver step for step, so ten iterations of
    three folds end on the JAX package's scores (3e-15 measured, atol
    1e-12) and on its identifications and q-values exactly."""
    _, is_target, is_true, _ = _planted_set(seed)
    got, (want, _) = _port_scores(seed, "svm"), _jax_scores(seed, "svm")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(fdr.tdc_qvalues(got, is_target),
                                  jax_fdr.tdc_qvalues(want, is_target))
    assert _ids_and_fdp(got, is_target, is_true) \
        == _ids_and_fdp(want, is_target, is_true)


@pytest.mark.parametrize("seed", PLANTED_SEEDS)
def test_brew_ids_close_to_the_jax_package(seed, monkeypatch):
    """The forest against the JAX package's `brew` (scikit-learn's) on the
    same planted data.  With the reference's grid winners given, IDs at
    q < 0.01 within 5%; with its own grid search, IDs at q < 0.05 within
    3% (see the module docstring for both readings on every seed)."""
    X, is_target, is_true, init = _planted_set(seed)
    want_scores, winners = _jax_scores(seed, "rf")
    assert len(winners) == 3
    want, _ = _ids_and_fdp(want_scores, is_target, is_true)
    own = _port_scores(seed, "rf")
    assert abs(_ids_at(own, is_target, 0.05)
               - _ids_at(want_scores, is_target, 0.05)) \
        <= 0.03 * _ids_at(want_scores, is_target, 0.05)
    given = iter(winners)
    monkeypatch.setattr(fdr, "grid_search_forest",
                        lambda *args, **kwargs: (next(given), None))
    scores = fdr.brew(X, is_target, init, train_fdr=0.05, model="rf",
                      device="cpu")
    got, fdp = _ids_and_fdp(scores, is_target, is_true)
    assert fdp <= 0.03
    assert abs(got - want) <= 0.05 * want, (seed, got, want, winners)


@pytest.mark.parametrize("model", ["svm", "rf"])
def test_brew_fabricates_nothing_on_signal_free_data(model):
    rng = np.random.default_rng(23)
    n = 1200
    X = rng.normal(size=(n, 10))
    is_target = rng.random(n) < 0.5
    init = rng.normal(size=n)
    scores = fdr.brew(X, is_target, init, train_fdr=0.05, model=model,
                      device="cpu")
    q = fdr.tdc_qvalues(scores, is_target)
    assert (is_target & (q < 0.01)).sum() <= 0.02 * n


def test_brew_falls_back_to_the_initial_score(caplog):
    """No decoys, so no fold can train: the initial scores come back
    (standardization needs decoys too) with the JAX package's warning."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(60, 4))
    init = rng.normal(size=60)
    with caplog.at_level("WARNING"):
        scores = fdr.brew(X, np.ones(60, bool), init, 0.05, "svm",
                          device="cpu")
    np.testing.assert_array_equal(scores, init)
    assert caplog.text.count("keeping the initial score direction") == 3


def _synthetic_ssms(n_targets, n_decoys, seed=5):
    """`tests/test_fdr.py::_make_synthetic_ssms` with the port's classes."""
    rng = np.random.default_rng(seed)
    ssms, k = [], 20
    for i in range(n_targets + n_decoys):
        is_decoy = i >= n_targets
        mz = np.sort(rng.uniform(150, 1200, k))
        q_int = rng.uniform(0.1, 1.0, k)
        q_int /= np.linalg.norm(q_int)
        noise = 0.9 if is_decoy else 0.1
        l_int = q_int * (1 - noise) + rng.uniform(0.1, 1.0, k) * noise
        l_int /= np.linalg.norm(l_int)
        n_match = rng.integers(5, k) if is_decoy else k
        matches = np.column_stack([np.arange(n_match), np.arange(n_match)])
        query = Spectrum(f"q{i}", 500.0 + i * 0.01, 2, mz, q_int)
        library = Spectrum(f"l{i}", 500.0 + i * 0.01 - 0.001, 2, mz, l_int)
        library.peptide = f"PEPTIDEK{i}"
        library.is_decoy = is_decoy
        ssms.append(SpectrumSpectrumMatch(query, library, matches))
    return ssms


@pytest.mark.parametrize("model,n,floor", [("rf", 150, 0.7),
                                           ("svm", 300, 0.8)])
def test_score_ssms_models_separate_targets(model, n, floor):
    """`tests/test_fdr_rf.py` (rf: > 0.7 of 150 targets at q < 0.05) and
    `tests/test_fdr.py::test_score_ssms_separates_targets` (svm: > 0.8 of
    300), through `score_ssms`; the report names what was measured."""
    report = {}
    scored = fdr.score_ssms(_synthetic_ssms(n, n), 0.05, model,
                            config=FakeConfig(), device="cpu", report=report)
    q = np.asarray([s.q for s in scored])
    is_decoy = np.asarray([s.is_decoy for s in scored])
    assert np.isnan(q[is_decoy]).all()
    assert (q[~is_decoy] < 0.05).mean() > floor
    assert report["features_sec"] > 0 and report["model_sec"] > 0
    if model == "rf":
        assert len(report["grid"]) == 3
        assert all(g in rescoring.param_grid() for g in report["grid"])
