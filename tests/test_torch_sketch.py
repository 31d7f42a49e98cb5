"""Port vs reference: the paper's sketch methods (``top_outputs``,
``random_sampling``, ``truncated_svd`` beside ``random_projection`` and
``none``), from the selectors up to whole fits.

Inputs are made with numpy from a seed and go through the JAX package and
its PyTorch port on the CPU.  ``random_sampling``'s draw is the (k, d)
Gumbel noise ``jax.random.categorical`` takes its arg-max over; the tests
replay it with ``jax.random.gumbel`` on the reference's key.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import boosting as JB
from repro.core import sketch as JS
from repro_torch.core import boosting as TB
from repro_torch.core import losses as TL
from repro_torch.core import sketch as TS
from repro_torch.core import split as TSP
from repro_torch.data import pipeline as TP

# XLA on the CPU sums the norms in another order than torch does; the two
# totals differ in their last bits, and with them ``p`` and the scales, by
# up to 2 ulp (measured).  Given its own total each side's scale is the
# IEEE float32 ``1 / sqrt(k p)`` (test_random_sampling_scales_are_ieee).
SCALE_ULP = 4


def test_sketch_methods_match_reference():
    assert TS.SKETCH_METHODS == JS.SKETCH_METHODS


def test_column_sq_norms_match_reference():
    G = np.random.default_rng(0).normal(size=(300, 9)).astype(np.float32)
    np.testing.assert_allclose(TS.column_sq_norms(torch.from_numpy(G)).numpy(),
                               np.asarray(JS.column_sq_norms(jnp.asarray(G))),
                               rtol=1e-6)


@pytest.mark.parametrize("seed,d,k", [(0, 12, 5), (1, 7, 7), (2, 40, 3)])
def test_top_outputs_selector_bitwise(seed, d, k):
    norms = np.random.default_rng(seed).random(d).astype(np.float32)
    np.testing.assert_array_equal(
        TS.top_outputs_selector(torch.from_numpy(norms), k).numpy(),
        np.asarray(JS.top_outputs_selector(jnp.asarray(norms), k)))


def test_top_outputs_ties_pick_the_lower_index():
    """``jax.lax.top_k`` puts the lower index first among equal norms; the
    port's stable descending sort does the same."""
    norms = np.array([1, 3, 2, 3, 0, 3, 2, 2], np.float32)
    for k in (1, 2, 3, 4, 6):
        got = TS.top_outputs_selector(torch.from_numpy(norms), k).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(JS.top_outputs_selector(jnp.asarray(norms), k)))
    assert TS.top_outputs_selector(torch.from_numpy(norms), 4).numpy(
        ).argmax(0).tolist() == [1, 3, 5, 2]


def _assert_selector_close(got, want):
    """Same columns picked, bitwise; scales within SCALE_ULP ulp."""
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_array_max_ulp(got, want, maxulp=SCALE_ULP)


@pytest.mark.parametrize("seed", range(6))
def test_random_sampling_selector_with_replayed_noise(seed):
    """Same noise, same norms: the port picks the reference's columns, with
    replacement, and scales them ``1/sqrt(k p)``; every third case has all
    norms zero (the uniform fallback), every other one some zero norms."""
    rng = np.random.default_rng(seed)
    d, k = int(rng.integers(2, 300)), int(rng.integers(1, 9))
    norms = (rng.random(d) * 10.0 ** rng.uniform(-3, 3, d)).astype(np.float32)
    if seed % 3 == 0:
        norms[:] = 0.0
    elif seed % 2:
        norms[rng.random(d) < 0.5] = 0.0
    key = jax.random.key(seed)
    want = np.asarray(JS.random_sampling_selector(jnp.asarray(norms), k, key))
    noise = np.array(jax.random.gumbel(key, (k, d), jnp.float32))
    got = TS.random_sampling_selector(torch.from_numpy(norms), k,
                                      torch.from_numpy(noise)).numpy()
    _assert_selector_close(got, want)
    assert (np.count_nonzero(got, axis=0) == 1).all()


def _ieee_scales(norms, total, idx, k):
    """The reference's scales in float32 numpy, each step rounded once:
    ``p = norms / total`` (uniform when the total is 0), ``1 / sqrt(k p)``."""
    d = norms.shape[0]
    total = np.float32(total)
    p = (norms / np.maximum(total, np.float32(1e-30)) if total > 0
         else np.full(d, np.float32(1) / np.float32(d)))
    return (np.float32(1) / np.sqrt(
        np.float32(k) * np.maximum(p[idx], np.float32(1e-30)))).astype(
            np.float32)


def _picked_scales(sel):
    """(k,) scale of each column of a one-hot (d, k) selector, and its row."""
    idx = np.argmax(sel != 0, axis=0)
    return idx, sel[idx, np.arange(sel.shape[1])]


@pytest.mark.parametrize("seed", range(6))
def test_random_sampling_scales_are_ieee(seed):
    """Where the port and the reference part (`SCALE_ULP`): each side's
    scales are bitwise the IEEE float32 formula applied to that side's own
    sum of the norms, so the gap is the sum's order and nothing else."""
    rng = np.random.default_rng(seed)
    d, k = int(rng.integers(2, 300)), int(rng.integers(1, 9))
    norms = (rng.random(d) * 10.0 ** rng.uniform(-3, 3, d)).astype(np.float32)
    if seed % 3 == 0:
        norms[:] = 0.0
    key = jax.random.key(seed)
    noise = np.array(jax.random.gumbel(key, (k, d), jnp.float32))
    got = TS.random_sampling_selector(torch.from_numpy(norms), k,
                                      torch.from_numpy(noise)).numpy()
    want = np.asarray(JS.random_sampling_selector(jnp.asarray(norms), k, key))
    for sel, total in ((got, torch.from_numpy(norms).sum().item()),
                       (want, float(jnp.sum(jnp.asarray(norms))))):
        idx, scale = _picked_scales(sel)
        np.testing.assert_array_equal(
            scale.view(np.int32),
            _ieee_scales(norms, total, idx, k).view(np.int32))


@pytest.mark.parametrize("seed", range(6))
def test_random_sampling_selector_bitwise_on_exact_sums(seed):
    """Norms whose every partial sum is exact in float32 (multiples of
    2^-7 below 2^10) leave the order of the sum no say: the port's selector
    is then bitwise the reference's, the uniform fallback included."""
    rng = np.random.default_rng(100 + seed)
    d, k = int(rng.integers(2, 300)), int(rng.integers(1, 9))
    norms = (rng.integers(0, 1024, d) * 2.0 ** -7).astype(np.float32)
    if seed % 3 == 0:
        norms[:] = 0.0
    key = jax.random.key(seed)
    noise = np.array(jax.random.gumbel(key, (k, d), jnp.float32))
    got = TS.random_sampling_selector(torch.from_numpy(norms), k,
                                      torch.from_numpy(noise)).numpy()
    want = np.asarray(JS.random_sampling_selector(jnp.asarray(norms), k, key))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_random_sampling_noise_is_a_categorical_draw():
    """The seam's premise: JAX's ``categorical`` with replacement is the
    arg-max of ``gumbel(key, (k, d)) + logits``."""
    logits = jnp.log(jnp.asarray([0.1, 0.5, 0.05, 0.35], jnp.float32))
    for s in range(5):
        key = jax.random.key(s)
        idx = jax.random.categorical(key, logits, shape=(6,))
        noise = jax.random.gumbel(key, (6, 4), jnp.float32)
        np.testing.assert_array_equal(np.asarray(idx),
                                      np.asarray(jnp.argmax(noise + logits,
                                                            -1)))


def _gains(Gk, codes, B=8):
    """Split gains of one node from the sketched stats (the port's scorer):
    what the sketch feeds the split search."""
    n, m = codes.shape
    stats = torch.cat([Gk, torch.ones(n, 1)], 1)
    hist = torch.zeros((1, m, B, stats.shape[1]))
    for f in range(m):
        hist[0, f].index_add_(0, codes[:, f].long(), stats)
    return TSP.split_scores(hist, 1.0, 1.0)


@pytest.mark.parametrize("d,k", [(6, 2), (12, 5), (30, 3)])
def test_truncated_svd_projector_and_gains(d, k):
    """Eigenvector signs and rotations within a repeated eigenvalue are
    free, so the port is held to the reference's projector ``V V^T`` and to
    its split gains, both within 1e-4."""
    rng = np.random.default_rng(d)
    G = (rng.normal(size=(400, d)) * np.linspace(3, 0.2, d)).astype(
        np.float32)
    V_r = np.asarray(JS.truncated_svd_projector(jnp.asarray(G), k))
    V = TS.truncated_svd_projector(torch.from_numpy(G), k).numpy()
    np.testing.assert_allclose(V @ V.T, V_r @ V_r.T, atol=1e-4)
    codes = torch.from_numpy(rng.integers(0, 8, (400, 4)))
    Gk = TS.build_sketch(torch.from_numpy(G), method="truncated_svd", k=k)
    Gk_r = JS.build_sketch(jnp.asarray(G), method="truncated_svd", k=k)
    g, g_r = _gains(Gk, codes), _gains(torch.from_numpy(np.array(Gk_r)),
                                       codes)
    np.testing.assert_allclose(g.numpy(), g_r.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("method", ["top_outputs", "random_sampling"])
def test_build_sketch_matches_reference(method):
    rng = np.random.default_rng(4)
    G = (rng.normal(size=(200, 10)) * np.linspace(2, 0.5, 10)).astype(
        np.float32)
    key = jax.random.key(3)
    want = np.asarray(JS.build_sketch(jnp.asarray(G), method=method, k=4,
                                      key=key))
    noise = (torch.from_numpy(np.array(jax.random.gumbel(key, (4, 10))))
             if method == "random_sampling" else None)
    got = TS.build_sketch(torch.from_numpy(G), method=method, k=4,
                          draw=noise).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_build_sketch_needs_a_draw_or_a_generator():
    G = torch.randn(20, 8)
    for method in ("random_sampling", "random_projection"):
        with pytest.raises(ValueError, match="draw or a generator"):
            TS.build_sketch(G, method=method, k=3)
        a, b = (TS.build_sketch(G, method=method, k=3,
                                generator=torch.Generator().manual_seed(5))
                for _ in range(2))
        assert a.shape == (20, 3) and torch.equal(a, b)
    assert torch.equal(TS.build_sketch(G, method="truncated_svd", k=8), G)


def _replayed_draws(method, seed, n_rounds, d, k):
    """The reference's per-round sketch draws: ``fit`` splits the key once
    per round and ``_boost_round`` splits the round key into (sketch,
    sample, colsample) keys."""
    key, out = jax.random.key(seed), []
    for _ in range(n_rounds):
        key, sub = jax.random.split(key)
        k_key, _, _ = jax.random.split(sub, 3)
        out.append(np.array(
            jax.random.gumbel(k_key, (k, d), jnp.float32)
            if method == "random_sampling"
            else JS.random_projection_matrix(d, k, k_key)))
    return out


def _plain_data(seed, n=700, m=8, d=5):
    """The reference's ``tests/test_hist_engine.py::_plain_data``."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, m)).astype(np.float32),
            rng.integers(0, d, n).astype(np.int32))


@pytest.mark.parametrize("method", ["top_outputs", "random_sampling",
                                    "truncated_svd"])
def test_fit_sketch_method_matches_reference(method):
    """A fit per sketch method against the JAX package's with the draws
    replayed: predictions atol 1e-4, valid losses rtol 1e-5, same best
    round."""
    X, y = _plain_data(13)
    Xt, yt, Xv, yv = X[:500], y[:500], X[500:600], y[500:600]
    kw = dict(n_trees=6, depth=4, learning_rate=0.3, n_bins=32, sketch_k=2,
              sketch_method=method, min_data_in_leaf=20.0)
    ref_m = JB.SketchBoost(JB.GBDTConfig(use_kernel="jnp", loop="python",
                                         **kw)).fit(Xt, yt, eval_set=(Xv, yv))
    port = TB.SketchBoost(TB.GBDTConfig(**kw), device="cpu").fit(
        Xt, yt, eval_set=(Xv, yv),
        sketch_mats=_replayed_draws(method, 0, 6, 5, 2))
    assert port.best_round == ref_m.best_round
    np.testing.assert_allclose([h["valid_loss"] for h in port.history],
                               [h["valid_loss"] for h in ref_m.history],
                               rtol=1e-5)
    np.testing.assert_allclose(port.predict_raw(X[600:]).numpy(),
                               np.asarray(ref_m.predict_raw(X[600:])),
                               atol=1e-4)


@pytest.mark.parametrize("method", TS.SKETCH_METHODS)
def test_free_running_fit_is_seeded(method):
    """Without replayed draws each method trains from ``cfg.seed``: two
    fits agree bitwise, and the model beats its base score."""
    X, y = TP.make_tabular("multiclass", 400, 6, 6, seed=1, n_informative=6)
    cfg = TB.GBDTConfig(n_trees=4, depth=3, n_bins=32, sketch_k=2,
                        sketch_method=method, learning_rate=0.3)
    a, b = (TB.SketchBoost(cfg, device="cpu").fit(X, y) for _ in range(2))
    assert torch.equal(a.predict_raw(X), b.predict_raw(X))
    loss = TL.get_loss("multiclass")
    base = float(loss.value(a.predict_raw(X, iteration=0),
                            torch.from_numpy(y).long()))
    assert a.eval_loss(X, y) < base
