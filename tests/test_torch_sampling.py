"""Row and column sampling (SGB ``subsample``, GOSS ``goss_a``/``goss_b``,
``colsample``): the port against the JAX package on the CPU.

The reference splits each round's key into sketch, sample and column keys
and draws ``uniform(s_key, (n,))`` and ``uniform(c_key, (m,))``; the tests
replay those uniforms (and the sketch's Pi) into the port through
``fit(sample_draws=..., feature_draws=..., sketch_mats=...)``.  The
weights ride in the count channel, so the split search compares weighted
counts with ``min_data_in_leaf``, and the leaf pass and covers are
weighted.  GOSS's amplification ``(1 - a) / b`` is 8.0 at a = 0.2, b =
0.1, exact in bf16 too.  The reference's bf16 path is its interpret mode.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import boosting as JB
from repro.core import sketch as JS
from repro.data.pipeline import make_tabular
from repro_torch.core import boosting as TB

GOSS = dict(goss_a=0.2, goss_b=0.1)
SAMPLERS = {"sgb": dict(subsample=0.6), "goss": GOSS,
            "colsample": dict(colsample=0.6),
            "goss_colsample": dict(GOSS, colsample=0.7)}


def replay_draws(seed, n_rounds, n, m, d=0, k=0,
                 method="random_projection"):
    """The reference's per-round draws: ``fit`` splits its key once a
    round and ``_boost_round`` splits the round key into (sketch, sample,
    column) keys.  Returns ``(sketch_mats, sample_draws, feature_draws)``
    (``sketch_mats`` None without ``d``)."""
    key = jax.random.key(seed)
    mats, rows, cols = [], [], []
    for _ in range(n_rounds):
        key, sub = jax.random.split(key)
        k_key, s_key, c_key = jax.random.split(sub, 3)
        rows.append(np.asarray(jax.random.uniform(s_key, (n,))))
        cols.append(np.asarray(jax.random.uniform(c_key, (m,))))
        if d:
            mats.append(np.asarray(
                jax.random.gumbel(k_key, (k, d), jnp.float32)
                if method == "random_sampling"
                else JS.random_projection_matrix(d, k, k_key)))
    return (mats or None), rows, cols


# -- the draws' functions -------------------------------------------------------

def _cfgs(**kw):
    return JB.GBDTConfig(**kw), TB.GBDTConfig(**kw)


@pytest.mark.parametrize("kw", [dict(subsample=0.5), dict(subsample=0.9),
                                GOSS, dict(goss_a=0.5, goss_b=0.3),
                                dict(goss_a=0.01, goss_b=0.5), dict()])
@pytest.mark.parametrize("seed", [0, 1])
def test_sample_weights_match_reference(kw, seed):
    """Same gradients, same uniforms: the same weights, bit for bit."""
    rng = np.random.default_rng(seed)
    n, d = 501, 6
    G = rng.normal(size=(n, d)).astype(np.float32)
    key = jax.random.key(seed)
    jcfg, tcfg = _cfgs(**kw)
    want = np.asarray(JB._sample_weights(key, jnp.asarray(G), jcfg))
    u = torch.from_numpy(np.array(jax.random.uniform(key, (n,))))
    got = TB._sample_weights(torch.from_numpy(G), tcfg, u)
    if not kw:
        assert got is None and (want == 1.0).all()
        return
    np.testing.assert_array_equal(got.numpy(), want[:, 0])


@pytest.mark.parametrize("d", [1, 4])
def test_goss_keeps_every_row_tied_at_the_threshold(d):
    """Rows whose gradient norms tie the n_top-th largest all stay, as the
    reference's ``gnorm >= top_k(gnorm, n_top)[-1]`` keeps them: 40 rows
    share the threshold's norm, of which the top fraction holds 17."""
    rng = np.random.default_rng(3)
    n = 300
    G = rng.uniform(-0.5, 0.5, size=(n, d)).astype(np.float32)
    big = rng.choice(n, 43, replace=False)
    G[big[:3]] = 9.0                      # the three largest
    G[big[3:]] = 2.0                      # 40 rows tied below them
    kw = dict(goss_a=0.2 * 20 / 300, goss_b=0.25)   # n_top = 20
    jcfg, tcfg = _cfgs(**kw)
    key = jax.random.key(5)
    want = np.asarray(JB._sample_weights(key, jnp.asarray(G), jcfg))[:, 0]
    u = torch.from_numpy(np.array(jax.random.uniform(key, (n,))))
    got = TB._sample_weights(torch.from_numpy(G), tcfg, u).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[big] == 1.0).all() and (got == 1.0).sum() == 43


@pytest.mark.parametrize("colsample", [0.3, 0.8, 1.0])
def test_feature_mask_matches_reference(colsample):
    key = jax.random.key(11)
    jcfg, tcfg = _cfgs(colsample=colsample)
    want = JB._feature_mask(key, 37, jcfg)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (37,))))
    got = TB._feature_mask(tcfg, u)
    if colsample >= 1.0:
        assert got is None and want is None
        return
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_goss_membership_on_the_card_sum_order():
    """The gradient norms sum d squares: XLA and torch may order them
    otherwise and differ in the last bits, which moves a row across the
    threshold only when the n_top-th and the next norm lie within a few
    ulp.  On this seed they are far apart, and the kept sets are equal."""
    rng = np.random.default_rng(9)
    n, d = 2000, 37
    G = rng.normal(size=(n, d)).astype(np.float32)
    norms = np.sort(np.square(G.astype(np.float64)).sum(1))[::-1]
    n_top = int(0.2 * n)
    gap = norms[n_top - 1] - norms[n_top]
    assert gap > 16 * np.spacing(np.float32(norms[n_top - 1]))
    jcfg, tcfg = _cfgs(**GOSS)
    key = jax.random.key(2)
    want = np.asarray(JB._sample_weights(key, jnp.asarray(G), jcfg))[:, 0]
    u = torch.from_numpy(np.array(jax.random.uniform(key, (n,))))
    got = TB._sample_weights(torch.from_numpy(G), tcfg, u).numpy()
    np.testing.assert_array_equal(got, want)


# -- fits ---------------------------------------------------------------------

N_TRAIN, N_VALID, M = 500, 150, 8
BASE = dict(n_trees=4, depth=3, learning_rate=0.3, n_bins=32, sketch_k=2,
            min_data_in_leaf=20.0)


def _data(task="multiclass", d=4, seed=13):
    X, y = make_tabular(task, N_TRAIN + N_VALID + 100, M, d, seed=seed,
                        n_informative=M)
    s = N_TRAIN + N_VALID
    return (X[:N_TRAIN], y[:N_TRAIN], X[N_TRAIN:s], y[N_TRAIN:s], X[s:])


@functools.lru_cache(maxsize=None)
def _pair(sampler, task="multiclass", d=4, seed=13, **kw):
    """The reference's fit and the port's, on its replayed draws."""
    kw = dict(BASE, loss=task, **SAMPLERS[sampler], **kw)
    ref_kw = dict(use_kernel="interpret") if kw.get(
        "hist_dtype") == "bfloat16" else dict(use_kernel="jnp")
    Xt, yt, Xv, yv, _ = _data(task, d, seed)
    ref_m = JB.SketchBoost(JB.GBDTConfig(loop="python", **ref_kw, **kw)).fit(
        Xt, yt, eval_set=(Xv, yv))
    mats, rows, cols = replay_draws(0, kw["n_trees"], N_TRAIN, M, d,
                                    kw["sketch_k"])
    port = TB.SketchBoost(TB.GBDTConfig(**kw), device="cpu").fit(
        Xt, yt, eval_set=(Xv, yv), sketch_mats=mats, sample_draws=rows,
        feature_draws=cols)
    return ref_m, port


def _assert_same_fit(ref_m, port, X_test):
    a, b = port.packed, ref_m.packed
    np.testing.assert_array_equal(a.feat.numpy(), np.asarray(b.feat))
    np.testing.assert_array_equal(a.thr.numpy(), np.asarray(b.thr))
    np.testing.assert_allclose(a.cover.numpy(), np.asarray(b.cover),
                               rtol=1e-6)
    assert port.best_round == ref_m.best_round
    np.testing.assert_allclose([h["valid_loss"] for h in port.history],
                               [h["valid_loss"] for h in ref_m.history],
                               rtol=1e-5)
    np.testing.assert_allclose(port.predict_raw(X_test).numpy(),
                               np.asarray(ref_m.predict_raw(X_test)),
                               atol=1e-4)


@pytest.mark.parametrize("engine", ["direct", "partition", "subtract"])
@pytest.mark.parametrize("sampler", ["sgb", "goss", "colsample"])
def test_sampled_fit_matches_reference(sampler, engine):
    """Each engine and sampler: the same splits and weighted covers,
    predictions within atol 1e-4."""
    ref_m, port = _pair(sampler, hist_engine=engine)
    _assert_same_fit(ref_m, port, _data()[4])


@pytest.mark.parametrize("sampler", ["sgb", "goss_colsample"])
def test_sampled_leafwise_fit_matches_reference(sampler):
    ref_m, port = _pair(sampler, growth="leafwise", max_leaves=6)
    _assert_same_fit(ref_m, port, _data()[4])


@pytest.mark.parametrize("growth,engine", [("levelwise", "subtract"),
                                           ("levelwise", "direct"),
                                           ("leafwise", "auto")])
def test_sampled_one_vs_all_fit_matches_reference(growth, engine):
    """GOSS plus colsample under one-vs-all, regression targets (a
    univariate tree's first gradients take few values, and exact ties
    would break differently in the two packages)."""
    ref_m, port = _pair("goss_colsample", task="multitask_mse", d=3,
                        seed=4, strategy="one_vs_all", growth=growth,
                        hist_engine=engine,
                        max_leaves=6 if growth == "leafwise" else 0)
    _assert_same_fit(ref_m, port, _data("multitask_mse", 3, 4)[4])


def test_sampled_bf16_fit_matches_reference_interpret():
    """GOSS with bf16 statistics against the reference's interpret-mode
    B1-bf16: the weights (0, 1, 8) are exact in bf16."""
    ref_m, port = _pair("goss", n_trees=3, hist_dtype="bfloat16")
    _assert_same_fit(ref_m, port, _data()[4])


def test_goss_model_shap_matches_reference():
    """Covers are weighted under GOSS, so TreeSHAP's zero-fractions are;
    SHAP of the GOSS model within atol 1e-5 + rtol 1e-5 of the
    reference's on its own model, and additive."""
    ref_m, port = _pair("goss")
    X = _data()[4][:40]
    phi, base = port.shap_values(X, check_additivity=True)
    jphi, jbase = ref_m.shap_values(X)
    np.testing.assert_allclose(phi.numpy(), np.asarray(jphi), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(base.numpy(), np.asarray(jbase), atol=1e-6)


def test_free_running_sampled_fit_is_seeded():
    """Without injected draws the rows' and features' uniforms come from
    the fit's generator: two fits agree bitwise, a third with another
    seed does not, and the model beats its base score."""
    Xt, yt, Xv, yv, _ = _data()
    kw = dict(BASE, **GOSS, colsample=0.7)
    a, b = (TB.SketchBoost(TB.GBDTConfig(**kw), device="cpu").fit(Xt, yt)
            for _ in range(2))
    c = TB.SketchBoost(TB.GBDTConfig(seed=1, **kw), device="cpu").fit(Xt, yt)
    assert torch.equal(a.predict_raw(Xv), b.predict_raw(Xv))
    assert not torch.equal(a.predict_raw(Xv), c.predict_raw(Xv))
    base = TB.SketchBoost(TB.GBDTConfig(**dict(kw, n_trees=1)),
                          device="cpu").fit(Xt, yt)
    assert a.eval_loss(Xt, yt) < base.eval_loss(Xt, yt)


def test_min_data_in_leaf_reads_weighted_counts():
    """With SGB every node's count channel holds its kept rows only:
    ``min_data_in_leaf`` at the kept rows of the root keeps the tree a
    stump, one below it lets the root split, as in the reference."""
    Xt, yt, _, _, _ = _data()
    _, rows, _ = replay_draws(0, 1, N_TRAIN, M)
    kept = float((rows[0] < 0.6).sum())
    for min_data, splits in ((kept / 2 + 1, False), (kept / 4, True)):
        kw = dict(BASE, n_trees=1, subsample=0.6, min_data_in_leaf=min_data)
        ref_m = JB.SketchBoost(JB.GBDTConfig(use_kernel="jnp", loop="python",
                                             **kw)).fit(Xt, yt)
        port = TB.SketchBoost(TB.GBDTConfig(**kw), device="cpu").fit(
            Xt, yt, sketch_mats=replay_draws(0, 1, N_TRAIN, M, 4, 2)[0],
            sample_draws=rows)
        root = float(port.packed.gain[0, 0])
        assert (root > 0) == splits
        np.testing.assert_array_equal(port.packed.feat.numpy(),
                                      np.asarray(ref_m.packed.feat))
        np.testing.assert_array_equal(port.packed.thr.numpy(),
                                      np.asarray(ref_m.packed.thr))
