"""The port's fit -> predict against the JAX package beyond the default
multiclass fit: other losses, eval cadence, min_gain, missing values, bin
counts, stumps, SketchBoost Full, padded outputs, round prefixes in predict,
SHAP and apply, and the input-validation errors.

Reference: ``GBDTConfig(use_kernel="jnp", loop="python")``.  Both fits see
the same numpy data with an eval set and early stopping, and the port takes
the reference's per-round projections.  Features are drawn independent
(``n_informative=m``) and ``min_data_in_leaf`` keeps leaves large, so no
two candidate splits tie exactly (see tests/test_torch_fit.py).
"""
import jax
import numpy as np
import pytest

from repro.core import boosting as JB
from repro.core import sketch as JS
from repro.data.pipeline import make_tabular
from repro_torch.core import boosting as TB

KW = dict(n_trees=10, depth=4, learning_rate=1.0, early_stopping_rounds=2,
          min_data_in_leaf=20.0, sketch_k=3)


def _replayed_projections(n_rounds, d, k, seed=0):
    key, out = jax.random.key(seed), []
    for _ in range(n_rounds):
        key, sub = jax.random.split(key)
        k_key, _, _ = jax.random.split(sub, 3)
        out.append(np.array(JS.random_projection_matrix(d, k, k_key)))
    return out


def _data(task="multiclass", n=1300, m=8, d=5, seed=4, nan=0.0):
    X, y = make_tabular(task, n, m, d, seed=seed, n_informative=m)
    if nan:
        X = X.copy()
        X[np.random.default_rng(seed).random(X.shape) < nan] = np.nan
    return X, y


def _fit_both(X, y, d, **cfg):
    """Fit both packages on rows 0:900 with rows 900:1100 as the eval set."""
    kw = dict(KW, **cfg)
    Xt, yt, Xv, yv = X[:900], y[:900], X[900:1100], y[900:1100]
    ref = JB.SketchBoost(JB.GBDTConfig(use_kernel="jnp", loop="python", **kw))
    ref.fit(Xt, yt, eval_set=(Xv, yv))
    k = kw["sketch_k"]
    pis = (None if kw.get("sketch_method") == "none" or k >= d
           else _replayed_projections(kw["n_trees"], d, k))
    port = TB.SketchBoost(TB.GBDTConfig(**kw), device="cpu")
    port.fit(Xt, yt, eval_set=(Xv, yv), sketch_mats=pis)
    return ref, port


CASES = {
    "multilabel": (dict(task="multilabel"), dict(loss="multilabel")),
    "multitask_mse": (dict(task="multitask_mse"),
                      dict(loss="multitask_mse", learning_rate=0.3)),
    "eval_every_3": ({}, dict(eval_every=3, early_stopping_rounds=4)),
    "min_gain_5": ({}, dict(min_gain=5.0)),
    "nan_features": (dict(nan=0.1), {}),
    "n_bins_17": ({}, dict(n_bins=17)),
    "depth_1": ({}, dict(depth=1)),
    "sketch_none": ({}, dict(sketch_method="none")),
    "n_outputs_above_labels": ({}, dict(n_outputs=7)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fit_case_matches_reference(case):
    """Same rounds, best round and valid losses (rtol 1e-5) as the
    reference; predictions within atol 1e-4."""
    data_kw, cfg = CASES[case]
    X, y = _data(**data_kw)
    d = cfg.get("n_outputs") or 5
    ref, port = _fit_both(X, y, d, **cfg)
    assert port.cfg.n_outputs == ref.cfg.n_outputs == d
    assert port.best_round == ref.best_round
    assert [sorted(h) for h in port.history] == [
        sorted(h) for h in ref.history]
    assert [h["round"] for h in port.history] == [
        h["round"] for h in ref.history]
    np.testing.assert_allclose(
        [h.get("valid_loss", 0.0) for h in port.history],
        [h.get("valid_loss", 0.0) for h in ref.history], rtol=1e-5)
    Xte = X[1100:]
    np.testing.assert_allclose(port.predict_raw(Xte).numpy(),
                               np.asarray(ref.predict_raw(Xte)), atol=1e-4)
    np.testing.assert_allclose(port.predict(Xte).numpy(),
                               np.asarray(ref.predict(Xte)), atol=1e-4)


@pytest.fixture(scope="module")
def fitted():
    X, y = _data(seed=7)
    ref, port = _fit_both(X, y, 5, early_stopping_rounds=0, n_trees=6)
    return X[1100:1164], ref, port


@pytest.mark.parametrize("iteration", [0, 99, -1])
def test_round_prefixes_match_reference(fitted, iteration):
    """``iteration`` in predict, SHAP and apply: 0 keeps no round, 99 more
    rounds than were fitted, -1 all but the last (a slice of the tree
    axis in both packages)."""
    X, ref, port = fitted
    np.testing.assert_allclose(port.predict_raw(X, iteration).numpy(),
                               np.asarray(ref.predict_raw(X, iteration)),
                               atol=1e-4)
    phi, base = port.shap_values(X, iteration=iteration)
    phi_r, base_r = ref.shap_values(X, iteration=iteration)
    np.testing.assert_allclose(phi.numpy(), np.asarray(phi_r), atol=1e-4)
    np.testing.assert_allclose(base.numpy(), np.asarray(base_r), atol=1e-4)
    np.testing.assert_array_equal(port.apply(X, iteration).numpy(),
                                  np.asarray(ref.apply(X, iteration)))


def _bad_inputs(X, y):
    Xinf = X.copy()
    Xinf[3, 2] = np.inf
    yf = y.astype(np.float32)
    return {
        "inf_feature": (Xinf, y),
        "text_features": (X.astype(str), y),
        "one_dim_X": (X[:, 0], y),
        "rows_misaligned": (X, y[:-1]),
        "non_integer_class": (X, yf + 0.5),
        "negative_class": (X, np.where(y == 0, -1, y)),
        "nan_target": (X, np.where(np.arange(len(y)) == 5, np.nan, yf)),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs(*_data(n=60))))
def test_input_validation_errors_match_reference(case):
    """Each bad input is refused by both packages with a ValueError, before
    any training."""
    X, y = _bad_inputs(*_data(n=60))[case]
    cfg = dict(n_trees=1, depth=1)
    with pytest.raises(ValueError):
        JB.SketchBoost(JB.GBDTConfig(use_kernel="jnp", **cfg)).fit(X, y)
    with pytest.raises(ValueError):
        TB.SketchBoost(TB.GBDTConfig(**cfg), device="cpu").fit(X, y)


def test_eval_set_and_unfitted_model_errors_match_reference(fitted):
    X, ref, port = fitted
    for model in (ref, port):
        with pytest.raises(ValueError, match="features"):
            model.predict_raw(X[:, :5])
    Xs, ys = _data(n=60)
    ref = JB.SketchBoost(JB.GBDTConfig(use_kernel="jnp", n_trees=1))
    port = TB.SketchBoost(TB.GBDTConfig(n_trees=1), device="cpu")
    for model in (ref, port):
        with pytest.raises(ValueError, match="eval_set X has 5 features"):
            model.fit(Xs, ys, eval_set=(Xs[:, :5], ys))
    # Before fit the reference fails on its empty forest (AttributeError);
    # the port says so.
    with pytest.raises(AttributeError):
        ref.predict_raw(Xs)
    with pytest.raises(ValueError, match="not fitted"):
        TB.SketchBoost(TB.GBDTConfig(), device="cpu").predict_raw(Xs)
