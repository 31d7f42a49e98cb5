"""Port vs reference: the histogram engines ``"direct"`` and ``"partition"``
beside ``"subtract"``, from the plain B4 up to whole fits.

Inputs are made with numpy from a seed and go through the JAX package (jnp
paths, ``ref`` oracles, or Pallas ``interpret=True``) and its PyTorch port
on the CPU, where the port's kernel wrappers run their plain versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import boosting as JB
from repro.core import histogram as JH
from repro.core import sketch as JS
from repro.core import tree as JT
from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro_torch.core import boosting as TB
from repro_torch.core import histogram as TH
from repro_torch.core import tree as TT
from repro_torch.kernels import hist_kernel, ref
from repro_torch.kernels import ops as TO

ENGINES = ["direct", "partition", "subtract"]
# The shapes of the reference's own kernel test (tests/test_kernels.py).
SHAPES = [(64, 3, 1, 8, 2), (256, 8, 4, 16, 4), (300, 5, 8, 16, 6),
          (128, 2, 2, 256, 1)]


def _direct_problem(seed, n, m, nodes, B, c, dyadic):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, B, (n, m)).astype(np.uint8)
    node = rng.integers(0, nodes, n).astype(np.int32)
    stats = rng.normal(size=(n, c)).astype(np.float32)
    if dyadic:                       # every float32 sum exact in any order
        stats = np.round(stats * 8) / 8
    return codes, node, stats


def _port_hist(codes, node, stats, nodes, B):
    return hist_kernel.hist_direct(
        torch.from_numpy(codes.T.copy()), torch.from_numpy(node),
        torch.from_numpy(stats), n_nodes=nodes, n_bins=B).numpy()


@pytest.mark.parametrize("dyadic", [True, False])
@pytest.mark.parametrize("n,m,nodes,B,c", SHAPES)
def test_histogram_ref_matches_reference(n, m, nodes, B, c, dyadic):
    """Plain B4 against ``ref.histogram_ref`` and the Pallas kernel in
    interpret mode: bitwise on dyadic stats; rtol 1e-5 / atol 1e-4 on
    normal stats, the reference's own kernel tolerance."""
    codes, node, stats = _direct_problem(n + m, n, m, nodes, B, c, dyadic)
    got = _port_hist(codes, node, stats, nodes, B)
    want = np.asarray(JR.histogram_ref(jnp.asarray(codes), jnp.asarray(node),
                                       jnp.asarray(stats), n_nodes=nodes,
                                       n_bins=B))
    kern = np.asarray(JO.histogram(jnp.asarray(codes).astype(jnp.int32),
                                   jnp.asarray(node), jnp.asarray(stats),
                                   n_nodes=nodes, n_bins=B, interpret=True))
    assert got.shape == (nodes, m, B, c) and got.dtype == np.float32
    if dyadic:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, kern)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(got, kern, rtol=1e-5, atol=1e-4)


def test_histogram_ref_sums_each_cell_in_row_order():
    """The fixed order the kernel keeps: each cell adds its rows one at a
    time in dataset order from 0.0 (a float32 numpy replay), with one row,
    empty nodes and repeated cells."""
    rng = np.random.default_rng(3)
    n, m, nodes, B, c = 517, 3, 6, 5, 3
    codes = rng.integers(0, B, (n, m)).astype(np.uint8)
    node = rng.choice([0, 2, 5], n).astype(np.int32)     # 1, 3, 4 empty
    stats = (rng.normal(size=(n, c)) * 10.0 ** rng.integers(-4, 5, (n, 1))
             ).astype(np.float32)
    want = np.zeros((nodes, m, B, c), np.float32)
    for i in range(n):
        for f in range(m):
            cell = want[node[i], f, codes[i, f]]
            cell[:] = (cell + stats[i]).astype(np.float32)
    np.testing.assert_array_equal(_port_hist(codes, node, stats, nodes, B),
                                  want)
    one = _port_hist(codes[:1], node[:1], stats[:1], nodes, B)
    assert one[node[0], 0, codes[0, 0]].tolist() == stats[0].tolist()
    assert np.count_nonzero(one) == m * np.count_nonzero(stats[0])


def test_build_histograms_matches_reference():
    codes, node, stats = _direct_problem(4, 333, 4, 4, 16, 3, False)
    got = TO.histogram(torch.from_numpy(codes.T.copy()),
                       torch.from_numpy(node), torch.from_numpy(stats),
                       n_nodes=4, n_bins=16).numpy()
    want = JH.build_histograms(jnp.asarray(codes), jnp.asarray(node),
                               jnp.asarray(stats), n_nodes=4, n_bins=16)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed,nodes,masked", [(0, 1, False), (1, 4, True),
                                               (2, 8, False)])
def test_histogram_splits_matches_reference(seed, nodes, masked):
    """B4 then B2 against the reference's fused pair (Pallas interpret):
    equal split indices, gains within 1e-4."""
    n, m, B, k = 600, 6, 16, 3
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, B, (n, m)).astype(np.uint8)
    node = rng.integers(0, nodes, n).astype(np.int32)
    stats = np.concatenate([rng.normal(size=(n, k)),
                            np.ones((n, 1))], 1).astype(np.float32)
    mask = (rng.random(m) < 0.7).astype(np.float32) if masked else None
    g_r, i_r = JO.histogram_splits(
        jnp.asarray(codes), jnp.asarray(node), jnp.asarray(stats),
        jnp.float32(1.0), jnp.float32(2.0),
        None if mask is None else jnp.asarray(mask), n_nodes=nodes,
        n_bins=B, interpret=True)
    g, i = TO.histogram_splits(
        torch.from_numpy(codes.T.copy()), torch.from_numpy(node),
        torch.from_numpy(stats), 1.0, 2.0,
        None if mask is None else torch.from_numpy(mask), n_nodes=nodes,
        n_bins=B)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_r))
    np.testing.assert_allclose(g.numpy(), np.asarray(g_r), rtol=1e-4)


@pytest.mark.parametrize("engine", [None, "auto"] + ENGINES)
def test_resolve_hist_engine_matches_reference(engine):
    assert TH.resolve_hist_engine(engine) == JH.resolve_hist_engine(engine)
    assert TH.HIST_ENGINES == JH.HIST_ENGINES


def test_resolve_hist_engine_rejects_unknown():
    with pytest.raises(ValueError, match="unknown hist engine"):
        TH.resolve_hist_engine("tiles")


def _rand_problem(seed, n=450, m=8, B=16, d=3):
    """The reference's ``tests/test_hist_engine.py::_rand_problem``."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, B, (n, m)).astype(np.uint8)
    G = rng.normal(size=(n, d)).astype(np.float32)
    Hd = np.ones((n, d), np.float32)
    stats = np.concatenate([G, np.ones((n, 1), np.float32)], 1)
    return codes, stats, G, Hd


def _port_tree(codes, stats, G, Hd, engine, **kw):
    return TT.grow_tree(torch.from_numpy(codes),
                        torch.from_numpy(codes.T.copy()),
                        torch.from_numpy(stats), torch.from_numpy(G),
                        torch.from_numpy(Hd), hist_engine=engine, **kw)


@pytest.mark.parametrize("engine", ENGINES)
def test_grow_tree_engine_matches_reference(engine):
    """Each engine against the reference's ``grow_tree(use_kernel="jnp")``
    with the same engine: equal feat/thr/leaf_pos, values within rtol 1e-4
    / atol 1e-5 (the reference's engine tolerance)."""
    codes, stats, G, Hd = _rand_problem(11)
    kw = dict(depth=4, n_bins=16, lam=1.0, min_data_in_leaf=3.0)
    tr, pos_r = JT.grow_tree(jnp.asarray(codes), jnp.asarray(stats),
                             jnp.asarray(G), jnp.asarray(Hd),
                             use_kernel="jnp", hist_engine=engine, **kw)
    t, pos = _port_tree(codes, stats, G, Hd, engine, **kw)
    np.testing.assert_array_equal(t.feat.numpy(), np.asarray(tr.feat))
    np.testing.assert_array_equal(t.thr.numpy(), np.asarray(tr.thr))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(pos_r))
    np.testing.assert_allclose(t.value.numpy(), np.asarray(tr.value),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t.gain.numpy(), np.asarray(tr.gain),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(t.cover.numpy(), np.asarray(tr.cover))


def test_direct_engine_is_the_exact_reference():
    """On dyadic statistics every float32 sum is exact, so the three
    engines grow the same tree bit for bit, with the masked feature never
    chosen."""
    codes, stats, G, Hd = _rand_problem(5)
    stats = np.round(stats * 4) / 4
    mask = torch.ones(8)
    mask[2] = 0.0
    trees = [_port_tree(codes, stats, G, Hd, e, depth=4, n_bins=16, lam=1.0,
                        feature_mask=mask) for e in ENGINES]
    for t, pos in trees[1:]:
        for a, b in zip(t, trees[0][0]):
            assert torch.equal(a, b)
        assert torch.equal(pos, trees[0][1])
    assert not (trees[0][0].feat[trees[0][0].gain > 0] == 2).any()


def _plain_data(seed, n=500, m=8, d=5):
    """The reference's ``tests/test_hist_engine.py::_plain_data``: plain
    noise features, no exactly tied splits."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, m)).astype(np.float32),
            rng.integers(0, d, n).astype(np.int32))


def _replayed_projections(seed, n_rounds, d, k):
    """The reference's per-round Pi (see tests/test_torch_fit.py)."""
    key, out = jax.random.key(seed), []
    for _ in range(n_rounds):
        key, sub = jax.random.split(key)
        k_key, _, _ = jax.random.split(sub, 3)
        out.append(np.array(JS.random_projection_matrix(d, k, k_key)))
    return out


@pytest.mark.parametrize("engine", ENGINES)
def test_fit_engine_matches_reference(engine):
    """A fit per engine against the JAX package's fit with the same engine
    and replayed Pi: predictions atol 1e-4, valid losses rtol 1e-5, same
    best round; the fitted config names the engine."""
    X, y = _plain_data(13, n=700)
    Xt, yt, Xv, yv = X[:500], y[:500], X[500:600], y[500:600]
    kw = dict(n_trees=5, depth=4, learning_rate=0.3, n_bins=32, sketch_k=2,
              hist_engine=engine, min_data_in_leaf=20.0)
    ref_m = JB.SketchBoost(JB.GBDTConfig(use_kernel="jnp", loop="python",
                                         **kw)).fit(Xt, yt, eval_set=(Xv, yv))
    port = TB.SketchBoost(TB.GBDTConfig(**kw), device="cpu").fit(
        Xt, yt, eval_set=(Xv, yv),
        sketch_mats=_replayed_projections(0, 5, 5, 2))
    assert port.cfg.hist_engine == ref_m.cfg.hist_engine == engine
    assert port.best_round == ref_m.best_round
    np.testing.assert_allclose([h["valid_loss"] for h in port.history],
                               [h["valid_loss"] for h in ref_m.history],
                               rtol=1e-5)
    np.testing.assert_allclose(port.predict_raw(X[600:]).numpy(),
                               np.asarray(ref_m.predict_raw(X[600:])),
                               atol=1e-4)


def test_fit_resolves_auto_engine_to_subtract():
    X, y = _plain_data(2, n=200)
    port = TB.SketchBoost(TB.GBDTConfig(n_trees=2, depth=2, n_bins=16),
                          device="cpu").fit(X, y)
    assert TB.GBDTConfig().hist_engine == "auto"
    assert port.cfg.hist_engine == "subtract"


def test_direct_wrapper_takes_plain_version_on_cpu():
    """A CPU tensor takes the plain version; the wrapper never falls back:
    the plain version is reached only through the tensor's device."""
    codes, node, stats = _direct_problem(0, 40, 2, 2, 8, 2, True)
    out = hist_kernel.hist_direct(torch.from_numpy(codes.T.copy()),
                                  torch.from_numpy(node),
                                  torch.from_numpy(stats), n_nodes=2,
                                  n_bins=8)
    np.testing.assert_array_equal(
        out.numpy(), ref.histogram_ref(torch.from_numpy(codes.T.copy()),
                                       torch.from_numpy(node),
                                       torch.from_numpy(stats), n_nodes=2,
                                       n_bins=8).numpy())
    assert hist_kernel.DIRECT_KERNEL.launches == 0
