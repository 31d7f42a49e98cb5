"""The slice as a whole: the port's fit -> predict against the JAX package.

Reference: ``GBDTConfig(use_kernel="jnp", loop="python")``.  Both fits see
the same numpy data with an eval set and early stopping.  Features are
drawn independent (``n_informative=m``) and ``min_data_in_leaf`` keeps
leaves large: ``make_tabular``'s duplicated features and tiny leaves make
exactly tied splits, which the two packages may break differently.
"""
import jax
import numpy as np
import pytest

from repro.core import boosting as JB
from repro.core import sketch as JS
from repro.data.pipeline import make_tabular
from repro_torch.core import boosting as TB
from repro_torch.data import pipeline as TP

KW = dict(n_trees=14, depth=4, learning_rate=1.0, early_stopping_rounds=2,
          min_data_in_leaf=20.0)


def _replayed_projections(seed, n_rounds, d, k):
    """The reference's per-round Pi: ``fit`` splits the key once per round
    and ``_boost_round`` splits the round key into (sketch, sample,
    colsample) keys."""
    key, out = jax.random.key(seed), []
    for _ in range(n_rounds):
        key, sub = jax.random.split(key)
        k_key, _, _ = jax.random.split(sub, 3)
        out.append(np.array(JS.random_projection_matrix(d, k, k_key)))
    return out


@pytest.mark.parametrize("d,k,seed", [(4, 5, 14), (8, 3, 22)])
def test_fit_predict_matches_reference(d, k, seed):
    X, y = make_tabular("multiclass", 1400, 10, d, seed=seed,
                        n_informative=10)
    Xt, yt, Xv, yv = X[:1000], y[:1000], X[1000:1200], y[1000:1200]
    Xte = X[1200:]
    ref = JB.SketchBoost(JB.GBDTConfig(sketch_k=k, use_kernel="jnp",
                                       loop="python", **KW))
    ref.fit(Xt, yt, eval_set=(Xv, yv))
    pis = None if k >= d else _replayed_projections(0, KW["n_trees"], d, k)
    port = TB.SketchBoost(TB.GBDTConfig(sketch_k=k, **KW), device="cpu")
    port.fit(Xt, yt, eval_set=(Xv, yv), sketch_mats=pis)

    assert len(ref.history) < KW["n_trees"]          # early stopping fired
    assert port.best_round == ref.best_round
    assert port.best_iteration == ref.best_iteration
    assert [h["round"] for h in port.history] == [
        h["round"] for h in ref.history]
    np.testing.assert_allclose([h["valid_loss"] for h in port.history],
                               [h["valid_loss"] for h in ref.history],
                               rtol=1e-5)
    np.testing.assert_allclose(port.predict_raw(Xte).numpy(),
                               np.asarray(ref.predict_raw(Xte)), atol=1e-4)
    np.testing.assert_allclose(port.predict(Xte).numpy(),
                               np.asarray(ref.predict(Xte)), atol=1e-4)
    np.testing.assert_allclose(
        port.predict_raw(Xte, iteration=2).numpy(),
        np.asarray(ref.predict_raw(Xte, iteration=2)), atol=1e-4)
    np.testing.assert_allclose(port.eval_loss(Xv, yv),
                               ref.eval_loss(Xv, yv), rtol=1e-5)


@pytest.mark.parametrize("loop", ["scan", "python"])
def test_both_loops_train_the_same_forest(loop):
    """The port under either ``loop`` against the reference's compiled
    ``loop="scan"`` (scan segments with host-side early stopping), which the
    reference guarantees equal to its per-round loop."""
    X, y = make_tabular("multiclass", 900, 8, 4, seed=3, n_informative=8)
    Xt, yt, Xv, yv = X[:600], y[:600], X[600:750], y[600:750]
    kw = dict(KW, n_trees=8)
    ref = JB.SketchBoost(JB.GBDTConfig(use_kernel="jnp", loop="scan",
                                       scan_chunk=3, **kw))
    ref.fit(Xt, yt, eval_set=(Xv, yv))
    port = TB.SketchBoost(TB.GBDTConfig(loop=loop, **kw), device="cpu")
    port.fit(Xt, yt, eval_set=(Xv, yv))
    assert port.best_round == ref.best_round
    assert len(port.history) == len(ref.history)
    np.testing.assert_allclose([h["valid_loss"] for h in port.history],
                               [h["valid_loss"] for h in ref.history],
                               rtol=1e-5)
    np.testing.assert_allclose(port.predict_raw(X[750:]).numpy(),
                               np.asarray(ref.predict_raw(X[750:])),
                               atol=1e-4)


def test_data_copy_matches_reference_generator():
    for task in ("multiclass", "multilabel", "multitask_mse"):
        a = make_tabular(task, 50, 7, 3, seed=4)
        b = TP.make_tabular(task, 50, 7, 3, seed=4)
        for x, z in zip(a, b):
            np.testing.assert_array_equal(x, z)
    X, y = make_tabular("multiclass", 30, 4, 2, seed=0)
    from repro.data.pipeline import train_test_split
    for x, z in zip(train_test_split(X, y, seed=2),
                    TP.train_test_split(X, y, seed=2)):
        np.testing.assert_array_equal(x, z)
