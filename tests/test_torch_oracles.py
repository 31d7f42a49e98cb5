"""Port vs reference: the helpers the reference's benches and tests call.

`losses.rmse`/`accuracy`, `quantize.quantize_uniform`, the heap-tree
walks of `tree` (`route_level`, `tree_leaf_index`, `predict_tree`,
`predict_forest`), the split oracle `split.brute_force_best_split` and
`GBDTConfig.resolve`, each on the same seeded numpy inputs as the JAX
package's.  Codes, routes and leaf indices are held bitwise.
`predict_forest` is held within one float32 rounding a tree of the
reference's: XLA's CPU backend contracts its ``acc + lr * v`` into a fused
multiply-add (one rounding), where the port rounds twice, as its traversal
kernel does (see tests/test_torch_forest.py); against the port's own
traversal (`forest.predict_raw`) it is bitwise.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import boosting as JB
from repro.core import losses as JL
from repro.core import quantize as JQ
from repro.core import split as JS
from repro.core import tree as JT
from repro.data.pipeline import make_tabular
from repro_torch.core import boosting as TB
from repro_torch.core import forest as TF
from repro_torch.core import losses as TL
from repro_torch.core import quantize as TQ
from repro_torch.core import split as TS
from repro_torch.core import tree as TT
from repro_torch.io import convert
from repro_torch.kernels import ops


def _rng(seed):
    return np.random.default_rng(seed)


# -- metrics ------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_rmse_matches_reference(seed):
    F = _rng(seed).normal(size=(300, 5)).astype(np.float32)
    Y = _rng(seed + 10).normal(size=(300, 5)).astype(np.float32)
    got = TL.rmse(torch.from_numpy(F), torch.from_numpy(Y))
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got), float(JL.rmse(F, Y)), rtol=1e-6)


@pytest.mark.parametrize("one_hot", [False, True])
def test_accuracy_matches_reference(one_hot):
    r = _rng(3)
    F = r.normal(size=(257, 6)).astype(np.float32)
    y = np.where(r.random(257) < 0.6, F.argmax(1), r.integers(0, 6, 257))
    Y = np.eye(6, dtype=np.float32)[y] if one_hot else y.astype(np.int64)
    got = TL.accuracy(torch.from_numpy(F), torch.from_numpy(Y))
    assert got.dtype == torch.float32 and got.ndim == 0
    want = float(JL.accuracy(jnp.asarray(F), jnp.asarray(Y)))
    assert abs(float(got) - want) <= 1e-6
    assert 0.55 < want < 0.8


# -- uniform binning ----------------------------------------------------------

@pytest.mark.parametrize("n_bins", [256, 17])
def test_quantize_uniform_is_bitwise_the_reference(n_bins):
    """Drawn columns at several scales, NaNs scattered, an all-NaN column,
    a constant column (the 1e-12 floor) and a column whose minimum is
    NaN-adjacent."""
    r = _rng(n_bins)
    X = (r.normal(size=(500, 8)) * np.array([1, 1e-3, 1e3, 7, 1, 1, 1, 1])
         ).astype(np.float32)
    X[r.random(X.shape) < 0.05] = np.nan
    X[:, 4] = np.nan
    X[:, 5] = 3.25
    X[0, 6], X[1, 6] = np.nan, X[:, 6][2:].min() - 1.0
    got = TQ.quantize_uniform(torch.from_numpy(X), n_bins).numpy()
    want = np.asarray(JQ.quantize_uniform(jnp.asarray(X), n_bins=n_bins))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert (got[:, 4] == 0).all() and (got[np.isnan(X)] == 0).all()
    assert got[~np.isnan(X)].min() >= 1 and got.max() <= n_bins - 1


# -- heap-tree walks ----------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _jax_model():
    X, y = make_tabular("multiclass", 600, 8, 5, seed=11)
    cfg = JB.GBDTConfig(n_trees=5, depth=4, sketch_k=2, learning_rate=0.3,
                        use_kernel="jnp", loop="python")
    return JB.SketchBoost(cfg).fit(X, y), X


def _port_forest():
    jm, _ = _jax_model()
    f = jm.forest
    return convert.forest_from_arrays(
        np.asarray(f.feat), np.asarray(f.thr), np.asarray(f.value),
        np.asarray(f.gain), np.asarray(f.cover), device="cpu")


def test_route_level_is_bitwise_the_reference():
    r = _rng(5)
    n, m, nodes = 400, 9, 8
    codes = r.integers(0, 256, (n, m)).astype(np.uint8)
    pos = r.integers(0, nodes, n).astype(np.int32)
    feat = r.integers(0, m, nodes).astype(np.int32)
    thr = r.integers(0, 256, nodes).astype(np.int32)
    got = TT.route_level(*(torch.from_numpy(a) for a in (codes, pos, feat,
                                                          thr)))
    want = np.asarray(JT.route_level(codes, pos, feat, thr))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_tree_leaf_index_and_predict_tree_are_bitwise_the_reference():
    jm, X = _jax_model()
    codes = np.array(jm._bin(X))
    forest = _port_forest()
    for t in range(forest.n_trees):
        got = TT.tree_leaf_index(forest.feat[t], forest.thr[t],
                                 torch.from_numpy(codes), depth=4)
        want = np.asarray(JT.tree_leaf_index(
            jm.forest.feat[t], jm.forest.thr[t], codes, depth=4))
        np.testing.assert_array_equal(got.numpy(), want)
        tree = TT.Tree(*(None if f is None else f[t] for f in forest))
        jtree = JT.Tree(*(None if f is None else f[t] for f in jm.forest))
        np.testing.assert_array_equal(
            TT.predict_tree(tree, torch.from_numpy(codes)).numpy(),
            np.asarray(JT.predict_tree(jtree, codes)))
    assert len(np.unique(want)) > 4          # the walk reaches many leaves


def test_predict_forest_matches_reference_and_the_traversal():
    jm, X = _jax_model()
    codes = np.array(jm._bin(X))
    forest = _port_forest()
    lr = jm.cfg.learning_rate
    base = torch.from_numpy(np.array(jm.base_score))
    got = TT.predict_forest(forest, torch.from_numpy(codes), lr, base)
    want = np.asarray(JT.predict_forest(jm.forest, codes, lr,
                                        jm.base_score))
    # One float32 rounding of the running sum, and one of lr * v, a tree.
    step = np.spacing(np.abs(want).max()) + np.spacing(
        np.float32(lr) * np.abs(np.asarray(jm.forest.value)).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=forest.n_trees * step)
    pf = TF.pack_forest(forest, base, lr)
    assert torch.equal(got, TF.predict_raw(pf, torch.from_numpy(codes)))


def test_forest_from_arrays_keeps_every_buffer():
    jm, _ = _jax_model()
    forest = _port_forest()
    for name, f in jm.forest._asdict().items():
        np.testing.assert_array_equal(getattr(forest, name).numpy(),
                                      np.asarray(f))
    assert forest.depth == jm.forest.depth and forest.n_trees == 5
    bare = convert.forest_from_arrays(np.asarray(jm.forest.feat),
                                      np.asarray(jm.forest.thr),
                                      np.asarray(jm.forest.value),
                                      device="cpu")
    assert bare.gain is None and bare.cover is None


# -- the split oracle ---------------------------------------------------------

@pytest.mark.parametrize("min_data", [0, 12])
def test_brute_force_best_split_matches_reference(min_data):
    """Gradients with a split planted on feature 2 (at code 9) in noise;
    the reference's oracle is float32, the port's float64."""
    r = _rng(min_data)
    n, m, k = 160, 4, 3
    codes = r.integers(0, 24, (n, m)).astype(np.uint8)
    g = r.normal(size=(n, k)).astype(np.float32)
    g[codes[:, 2] <= 9] += np.float32(0.8)
    stats = np.concatenate([g, np.ones((n, 1), np.float32)], 1)
    feat, thr, gain = TS.brute_force_best_split(
        torch.from_numpy(codes), torch.from_numpy(stats), 1.0, min_data)
    jf, jt, jg = JS.brute_force_best_split(jnp.asarray(codes),
                                           jnp.asarray(stats), 1.0, min_data)
    assert isinstance(feat, int) and isinstance(thr, int)
    assert isinstance(gain, float)
    assert (feat, thr) == (int(jf), int(jt)) and feat == 2
    np.testing.assert_allclose(gain, float(jg), rtol=1e-5)


def test_brute_force_best_split_agrees_with_the_split_scan():
    """The oracle against the port's histogram path (plain B2) on one node:
    the same (feature, threshold), gains within 1e-5."""
    r = _rng(9)
    n, m, k = 300, 5, 2
    codes = r.integers(0, 256, (n, m)).astype(np.uint8)
    stats = np.concatenate([r.normal(size=(n, k)),
                            np.ones((n, 1))], 1).astype(np.float32)
    feat, thr, gain = TS.brute_force_best_split(
        torch.from_numpy(codes), torch.from_numpy(stats), 1.0, 5)
    hist = ops.histogram(torch.from_numpy(codes).t().contiguous(),
                         torch.zeros(n, dtype=torch.int32),
                         torch.from_numpy(stats), n_nodes=1, n_bins=256)
    sp = TS.best_splits(TS.split_scores(hist, 1.0, 5.0))
    assert (int(sp.feat[0]), int(sp.thr[0])) == (feat, thr)
    np.testing.assert_allclose(float(sp.gain[0]), gain, rtol=1e-5)


# -- GBDTConfig.resolve -------------------------------------------------------

@pytest.mark.parametrize("engine", ["auto", "direct", "partition",
                                    "subtract"])
def test_resolve_matches_reference(engine):
    kw = dict(hist_engine=engine, sketch_k=3, n_trees=7)
    got = TB.GBDTConfig(**kw).resolve(9)
    want = JB.GBDTConfig(**kw).resolve(9)
    assert got.n_outputs == want.n_outputs == 9
    assert got.hist_engine == want.hist_engine
    assert got.use_kernel is True
    same = {f.name for f in dataclasses.fields(TB.GBDTConfig)} - {
        "use_kernel"}
    assert {k: getattr(got, k) for k in same} == {
        k: getattr(want, k) for k in same}


REFUSED = [dict(growth="bestfirst"), dict(max_leaves=8),
           dict(growth="leafwise", max_leaves=1),
           dict(growth="leafwise", max_leaves=128, depth=6),
           dict(growth="leafwise", max_leaves=8, hist_engine="direct"),
           dict(hist_dtype="float16"), dict(dist_hist_compression="zip"),
           dict(dist_hist_k=-1), dict(dist_hist_compression="sketch"),
           dict(guard_policy="ignore"), dict(guard_clip=0.0),
           dict(hessian_floor=-1.0), dict(save_every=-1),
           dict(save_every=2), dict(ckpt_keep=0),
           dict(hist_engine="fused")]


@pytest.mark.parametrize("kw", REFUSED, ids=lambda kw: ",".join(kw))
def test_resolve_refuses_what_the_reference_refuses(kw):
    with pytest.raises(ValueError):
        JB.GBDTConfig(**kw).resolve(4)
    with pytest.raises(ValueError):
        TB.GBDTConfig(**kw).resolve(4)
