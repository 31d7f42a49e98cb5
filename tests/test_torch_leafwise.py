"""Port vs reference: leaf-wise (best-first) growth, the pointer forest it
packs into, staged prediction, and their interop.

Inputs are made with numpy from a seed and go through the JAX package
(jnp paths, ``ref`` oracles, or Pallas ``interpret=True``) and its PyTorch
port on the CPU, where the port's kernel wrappers run their plain versions.
Fixtures are tie-free: random codes with normal gradients, or independent
features with ``min_data_in_leaf=20`` for fits (ROADMAP §C, tied splits).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import explain as JEX
from repro.core import boosting as JB
from repro.core import forest as JF
from repro.core import histogram as JH
from repro.core import tree as JT
from repro.data.pipeline import make_tabular
from repro.io import checkpoint as JC
from repro.kernels import ops as JO
from repro_torch.core import boosting as TB
from repro_torch.core import forest as TF
from repro_torch.core import histogram as TH
from repro_torch.core import tree as TT
from repro_torch.io import checkpoint as TC
from repro_torch.io import convert
from repro_torch.kernels import ops as TO
from test_torch_fit import _replayed_projections

# Value and gain tolerance of the port's level-wise tree parity
# (tests/test_torch_engines.py): float32 sums in another order.
TREE_TOL = dict(rtol=1e-4, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True, order="C"))


def _rand_problem(seed, n=400, m=6, B=16, d=4):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, B, (n, m)).astype(np.uint8)
    G = rng.normal(size=(n, d)).astype(np.float32)
    Hd = np.ones((n, d), np.float32)
    stats = np.concatenate([G, np.ones((n, 1), np.float32)], 1)
    return codes, stats, G, Hd


def _port_leafwise(codes, stats, G, Hd, **kw):
    return TT.grow_tree_leafwise(_t(codes), _t(codes.T), _t(stats), _t(G),
                                 _t(Hd), **kw)


def _port_levelwise(codes, stats, G, Hd, **kw):
    return TT.grow_tree(_t(codes), _t(codes.T), _t(stats), _t(G), _t(Hd),
                        hist_engine="subtract", **kw)


# -- the per-node partition ----------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_partition_at_bitwise(seed):
    """A chain of splits (root, a left child, a right child, an empty
    side) against the reference's masked scan: order, node_perm, starts and
    counts bitwise.  The reference's ``do=False`` step is an exact no-op;
    the port does not call it (its grower leaves the loop instead)."""
    rng = np.random.default_rng(seed)
    n, slots = 301, 9
    ref = JH.init_node_partition(n, slots)
    part = TH.init_node_partition(n, slots)
    steps = [(0, 1, 2, 0.4), (1, 3, 4, 0.7), (2, 5, 6, 0.5), (4, 7, 8, 0.0)]
    for p, c1, c2, frac in steps:
        bits = (rng.random(n) < frac).astype(np.int32)
        ref = JH.split_partition_at(ref, jnp.int32(p), jnp.int32(c1),
                                    jnp.int32(c2), jnp.asarray(bits),
                                    jnp.bool_(True))
        part = TH.split_partition_at(part, p, c1, c2, _t(bits))
        for name, a, b in zip(ref._fields, ref, part):
            assert b.dtype == torch.int32, name
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=name)
    noop = JH.split_partition_at(ref, jnp.int32(3), jnp.int32(0),
                                 jnp.int32(0), jnp.asarray(bits),
                                 jnp.bool_(False))
    for a, b in zip(noop, part):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_gather_node_rows_matches_reference():
    rng = np.random.default_rng(4)
    n = 200
    ref = JH.init_node_partition(n, 5)
    part = TH.init_node_partition(n, 5)
    for p, c1, c2 in ((0, 1, 2), (2, 3, 4)):
        bits = rng.integers(0, 2, n).astype(np.int32)
        ref = JH.split_partition_at(ref, jnp.int32(p), jnp.int32(c1),
                                    jnp.int32(c2), jnp.asarray(bits),
                                    jnp.bool_(True))
        part = TH.split_partition_at(part, p, c1, c2, _t(bits))
    for node in range(5):
        rows, valid = JH.gather_node_rows(ref, jnp.int32(node), n)
        want = np.asarray(rows)[np.asarray(valid)]
        np.testing.assert_array_equal(
            TH.gather_node_rows(part, node).numpy(), want)


# -- one node's histogram ---------------------------------------------------------

def _node_rows(seed, n, frac):
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(n, int(n * frac), replace=False)).astype(
        np.int32)


@pytest.mark.parametrize("B", [16, 256])
def test_node_histogram_bitwise_node_hist_jnp_on_dyadic(B):
    """On dyadic statistics every float32 sum is exact in any order, so the
    port's one-node build (plain B1) equals ``node_hist_jnp`` bitwise."""
    codes, stats, _, _ = _rand_problem(5, n=700, m=5, B=B)
    stats = np.round(stats * 8) / 8
    rows = _node_rows(5, 700, 0.6)
    want = JH.node_hist_jnp(jnp.asarray(codes)[rows],
                            jnp.asarray(stats)[rows], n_bins=B)
    got = TO.node_histogram(_t(codes.T), _t(rows), _t(stats), n_bins=B)
    assert got.shape == (5, B, stats.shape[1]) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_node_histogram_matches_interpret_kernel():
    """Normal statistics: within 1e-6 x the histogram's scale of the
    reference's ``ops.node_histogram`` (Pallas, interpret), a sum-order
    difference only; the count channel bitwise."""
    B = 16
    codes, stats, _, _ = _rand_problem(6, n=900, m=4, B=B)
    rows = _node_rows(6, 900, 0.45)
    want = np.asarray(JO.node_histogram(
        jnp.asarray(codes)[rows], jnp.asarray(stats)[rows], n_bins=B,
        interpret=True))
    got = TO.node_histogram(_t(codes.T), _t(rows), _t(stats),
                            n_bins=B).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-6 * scale
    np.testing.assert_array_equal(got[..., -1], want[..., -1])


def test_node_histogram_of_no_rows_is_zero():
    codes, stats, _, _ = _rand_problem(7, n=50, m=3)
    got = TO.node_histogram(_t(codes.T), torch.zeros(0, dtype=torch.int32),
                            _t(stats), n_bins=16)
    assert got.shape == (3, 16, stats.shape[1]) and not got.any()


# -- the grower against the reference --------------------------------------------

CASES = [  # (depth, max_leaves, min_gain): 2 leaves, 5, the full budget,
    (3, 2, 0.0), (3, 5, 0.0), (3, 8, 0.0),    # a binding depth bound and
    (2, 4, 0.0), (4, 9, 0.0), (4, 9, 30.0)]   # an early-empty frontier


@pytest.mark.parametrize("mode", ["jnp", "interpret"])
@pytest.mark.parametrize("depth,max_leaves,min_gain", CASES)
def test_grow_tree_leafwise_matches_reference(depth, max_leaves, min_gain,
                                              mode):
    """feat, thr, left, right, node_count and leaf_pos equal; value, gain
    and cover within the level-wise parity tolerance."""
    codes, stats, G, Hd = _rand_problem(depth * 10 + max_leaves)
    kw = dict(depth=depth, max_leaves=max_leaves, n_bins=16, lam=1.0,
              min_data_in_leaf=3.0, min_gain=min_gain)
    tr, pos_r = JT.grow_tree_leafwise(
        jnp.asarray(codes), jnp.asarray(stats), jnp.asarray(G),
        jnp.asarray(Hd), use_kernel=mode, **kw)
    t, pos = _port_leafwise(codes, stats, G, Hd, **kw)
    assert isinstance(t, TT.NodeTree) and t.n_nodes == 2 * max_leaves - 1
    for name in ("feat", "thr", "left", "right", "node_count"):
        got = getattr(t, name)
        assert got.dtype == torch.int32, name
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(tr, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(pos_r))
    for name in ("value", "gain", "cover"):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(tr, name)),
                                   err_msg=name, **TREE_TOL)
    if min_gain > 0:                       # the frontier emptied early
        assert int(t.node_count) < 2 * max_leaves - 1


@pytest.mark.parametrize("hist_dtype", ["float32", "bfloat16"])
def test_full_budget_is_bitwise_the_levelwise_subtract_tree(hist_dtype):
    """max_leaves = 2^depth with every node splitting: the same leaves as
    the port's level-wise subtract engine, each row's leaf value bitwise,
    and the same multiset of splits."""
    codes, stats, G, Hd = _rand_problem(3)
    kw = dict(depth=3, n_bins=16, lam=1.0, hist_dtype=hist_dtype)
    lw, pos_lw = _port_leafwise(codes, stats, G, Hd, max_leaves=8, **kw)
    lv, pos_lv = _port_levelwise(codes, stats, G, Hd, **kw)
    assert int(lw.node_count) == 15
    assert torch.equal(lw.value[pos_lw.long()], lv.value[pos_lv.long()])
    real = lw.left != torch.arange(15, dtype=torch.int32)
    assert sorted(zip(lw.feat[real].tolist(), lw.thr[real].tolist())) == \
        sorted(zip(lv.feat.tolist(), lv.thr.tolist()))
    assert torch.equal(torch.sort(lw.gain[real]).values,
                       torch.sort(lv.gain).values)


def test_leafwise_tree_respects_budget_and_depth():
    codes, stats, G, Hd = _rand_problem(8, n=600)
    t, pos = _port_leafwise(codes, stats, G, Hd, depth=3, max_leaves=7,
                            n_bins=16, lam=1.0)
    left, right = t.left.numpy(), t.right.numpy()
    nc = int(t.node_count)
    depth_of = np.zeros(13, int)
    for i in range(13):
        if left[i] != i:
            depth_of[left[i]] = depth_of[right[i]] = depth_of[i] + 1
    term = left == np.arange(13)
    assert depth_of[:nc].max() <= 3 and (term[:nc]).sum() <= 7
    assert (left[nc:] == np.arange(nc, 13)).all()        # inert slots
    assert not t.value[nc:].any() and not t.value[~_t(term)].any()
    assert set(pos.tolist()) <= set(np.flatnonzero(term).tolist())
    assert t.cover[0] == 600


# -- whole fits ---------------------------------------------------------------

def _plain_data(seed, n=700, m=8, d=5):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, m)).astype(np.float32),
            rng.integers(0, d, n).astype(np.int32))


FIT_KW = dict(n_trees=5, depth=4, learning_rate=0.3, n_bins=32, sketch_k=2,
              min_data_in_leaf=20.0)


@pytest.mark.parametrize("max_leaves", [6, 16])
def test_leafwise_fit_matches_reference(max_leaves):
    """A leaf-wise fit with the reference's per-round Pi injected against
    the reference's fit: valid losses within rtol 1e-5, predictions within
    5e-7 (the port's fit parity, ROADMAP §C), the same best round and node
    counts; the packed walk bound is the configured depth."""
    X, y = _plain_data(13)
    Xt, yt, Xv, yv = X[:500], y[:500], X[500:600], y[500:600]
    kw = dict(FIT_KW, growth="leafwise", max_leaves=max_leaves)
    jm = JB.SketchBoost(JB.GBDTConfig(use_kernel="jnp", loop="python",
                                      **kw)).fit(Xt, yt, eval_set=(Xv, yv))
    port = TB.SketchBoost(TB.GBDTConfig(**kw), device="cpu").fit(
        Xt, yt, eval_set=(Xv, yv),
        sketch_mats=_replayed_projections(0, 5, 5, 2))
    assert isinstance(port.forest, TT.NodeTree)
    assert port.packed.depth == jm.packed.depth == 4
    np.testing.assert_array_equal(port.packed.node_count.numpy(),
                                  np.asarray(jm.packed.node_count))
    assert port.best_round == jm.best_round
    np.testing.assert_allclose([h["valid_loss"] for h in port.history],
                               [h["valid_loss"] for h in jm.history],
                               rtol=1e-5)
    np.testing.assert_allclose(port.predict_raw(X[600:]).numpy(),
                               np.asarray(jm.predict_raw(X[600:])),
                               atol=5e-7)


def test_leafwise_fit_full_budget_equals_levelwise_fit():
    """The reference's own acceptance on the port: max_leaves = 2^depth
    fits predict bitwise as the level-wise subtract fit."""
    X, y = _plain_data(14, n=500)
    pis = _replayed_projections(1, 5, 5, 2)
    fits = [TB.SketchBoost(TB.GBDTConfig(**FIT_KW, **kw), device="cpu").fit(
        X, y, sketch_mats=pis)
        for kw in ({}, dict(growth="leafwise", max_leaves=16))]
    assert torch.equal(fits[0].predict_raw(X), fits[1].predict_raw(X))


VALIDATE = [  # the reference's accept/raise cases, config by config
    (dict(growth="leafwise", max_leaves=8, depth=3), None),
    (dict(growth="leafwise", max_leaves=2, depth=1), None),
    (dict(growth="leafwise", max_leaves=8, hist_engine="subtract"), None),
    (dict(growth="depthwise"), "unknown growth"),
    (dict(max_leaves=8), "max_leaves=8 is set but growth='levelwise'"),
    (dict(growth="leafwise"), "max_leaves >= 2"),
    (dict(growth="leafwise", max_leaves=1), "max_leaves >= 2"),
    (dict(growth="leafwise", max_leaves=9, depth=3), "exceeds 2\\^depth=8"),
    (dict(growth="leafwise", max_leaves=8, hist_engine="direct"),
     "no leaf-wise implementation"),
    (dict(growth="leafwise", max_leaves=8, hist_engine="partition"),
     "no leaf-wise implementation"),
    (dict(hist_dtype="float16"), "unknown hist_dtype"),
]


@pytest.mark.parametrize("kw,error", VALIDATE)
def test_validate_matches_reference(kw, error):
    jcfg = JB.GBDTConfig(use_kernel="jnp", **kw)
    tcfg = TB.GBDTConfig(**kw)
    if error is None:
        jcfg.validate()
        tcfg.validate()
        return
    with pytest.raises(ValueError, match=error):
        jcfg.validate()
    with pytest.raises(ValueError, match=error):
        tcfg.validate()


def test_slices_still_to_come_are_named():
    for kw, slice_name in ((dict(strategy="one_vs_all", save_every=2),
                            "checkpoint slice"),
                           (dict(subsample=0.5), "sampling slice"),
                           (dict(guard_policy="raise"), "robustness slice"),
                           (dict(save_every=2), "checkpoint slice"),
                           (dict(dist_hist_compression="sketch"),
                            "distributed slice")):
        with pytest.raises(ValueError, match=slice_name):
            TB.GBDTConfig(growth="leafwise", max_leaves=4, **kw).validate()


# -- the pointer forest, staged prediction, interop -----------------------------

@functools.lru_cache(maxsize=None)
def _port_leafwise_fit(max_leaves=6, seed=21):
    X, y = make_tabular("multiclass", 400, 6, 4, seed=seed, n_informative=6)
    cfg = TB.GBDTConfig(n_trees=5, depth=4, growth="leafwise",
                        max_leaves=max_leaves, learning_rate=0.3,
                        sketch_k=2, min_data_in_leaf=10.0)
    m = TB.SketchBoost(cfg, device="cpu").fit(X[:300], y[:300],
                                               eval_set=(X[300:], y[300:]))
    return m, X


@functools.lru_cache(maxsize=None)
def _jax_leafwise_fit(seed=22):
    X, y = make_tabular("multiclass", 400, 6, 4, seed=seed, n_informative=6)
    cfg = JB.GBDTConfig(n_trees=4, depth=4, growth="leafwise", max_leaves=7,
                        learning_rate=0.3, sketch_k=2, use_kernel="jnp",
                        loop="python")
    return JB.SketchBoost(cfg).fit(X, y), X


def _jax_packed(pf):
    """A port `PackedForest` as the reference's."""
    fields = {k: (None if v is None else jnp.asarray(v.numpy()))
              for k, v in pf._asdict().items()
              if k not in ("depth", "lr")}
    return JF.PackedForest(lr=jnp.float32(float(pf.lr)), depth=pf.depth,
                           **fields)


def test_node_tree_pack_unpack_round_trip():
    m, _ = _port_leafwise_fit()
    pf = m.packed
    assert not pf.is_heap and pf.depth == 4
    forest, strategy = TF.unpack_forest(pf)
    assert strategy == "single_tree" and isinstance(forest, TT.NodeTree)
    for name in TT.NodeTree._fields:
        assert torch.equal(getattr(forest, name), getattr(m.forest, name))
    again = TF.pack_forest(forest, pf.base, float(pf.lr), max_depth=4)
    for a, b in zip(again, pf):
        assert a == b if isinstance(a, int) else torch.equal(a, b)
    assert TF.pack_forest(forest, pf.base, 0.3).depth == \
        TF._pointer_max_depth(pf.left.numpy(), pf.right.numpy())


def test_pack_node_tree_matches_reference():
    """The reference's NodeTrees, carried over by `node_tree_from_arrays`,
    pack as the reference packs them; the heap forest round-trips too."""
    jm, _ = _jax_leafwise_fit()
    jf = jm.forest
    nt = convert.node_tree_from_arrays(
        {k: np.asarray(v) for k, v in jf._asdict().items()}, device="cpu")
    pf = TF.pack_forest(nt, _t(np.asarray(jm.base_score)), 0.3, max_depth=4)
    for name in ("feat", "thr", "left", "right", "leaf", "out_col", "cover",
                 "gain", "node_count"):
        np.testing.assert_array_equal(getattr(pf, name).numpy(),
                                      np.asarray(getattr(jm.packed, name)),
                                      err_msg=name)
    X, y = _plain_data(2, n=200)
    m = TB.SketchBoost(TB.GBDTConfig(n_trees=3, depth=3), device="cpu").fit(
        X, y)
    forest, strategy = TF.unpack_forest(m.packed)
    assert isinstance(forest, TT.Forest) and strategy == "single_tree"
    for a, b in zip(forest, m.forest):
        assert torch.equal(a, b)


@pytest.mark.parametrize("variant", ["heap", "one_vs_all", "leafwise"])
def test_unpack_forest_matches_reference(variant):
    """`unpack_forest` of a JAX-fitted forest of each topology, carried over
    by `io/convert`, gives the reference's container, strategy and arrays
    bitwise."""
    X, y = make_tabular("multiclass", 300, 6, 3, seed=23, n_informative=6)
    kw = dict(n_trees=3, depth=3, learning_rate=0.3, use_kernel="jnp")
    if variant == "one_vs_all":
        kw.update(strategy="one_vs_all")
    if variant == "leafwise":
        kw.update(growth="leafwise", max_leaves=6)
    jpf = JB.SketchBoost(JB.GBDTConfig(**kw)).fit(X, y).packed
    arrays = {k: (None if v is None else np.array(v))
              for k, v in jpf._asdict().items() if k != "depth"}
    pf = convert.packed_forest_from_arrays(arrays, depth=jpf.depth,
                                           device="cpu")
    want, want_strategy = JF.unpack_forest(jpf)
    got, strategy = TF.unpack_forest(pf)
    assert strategy == want_strategy
    assert type(got).__name__ == type(want).__name__
    for name, a in want._asdict().items():
        b = getattr(got, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=name)


def test_reference_leafwise_forest_predicts_as_the_reference():
    """A JAX-fitted leaf-wise forest carried over by `io/convert` predicts
    within one rounding per tree of the reference (the reference's CPU
    oracle fuses the add into an FMA; ROADMAP §C)."""
    jm, X = _jax_leafwise_fit()
    arrays = {k: (None if v is None else np.array(v))
              for k, v in jm.packed._asdict().items() if k != "depth"}
    pf = convert.packed_forest_from_arrays(arrays, depth=jm.packed.depth,
                                           device="cpu")
    codes = np.array(jm._bin(X))
    got = TF.predict_raw(pf, _t(codes)).numpy()
    want = np.asarray(jm.predict_raw(X))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= pf.n_trees * np.spacing(
        np.float32(scale))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_leafwise_checkpoint_crosses_both_ways(tmp_path, writer):
    m, X = _port_leafwise_fit()
    if writer == "port":
        TC.save_forest_checkpoint(str(tmp_path), m.packed, m.quantizer,
                                  metadata={"loss": "multiclass"})
        jpf, _, meta = JC.load_forest_checkpoint(str(tmp_path))
        assert meta["depth"] == 4 and meta["format_version"] == 5
        for name, v in m.packed._asdict().items():
            if name not in ("depth", "lr"):
                np.testing.assert_array_equal(np.asarray(getattr(jpf, name)),
                                              v.numpy(), err_msg=name)
        assert jpf.depth == 4 and float(jpf.lr) == float(m.packed.lr)
        return
    JC.save_forest_checkpoint(str(tmp_path), _jax_packed(m.packed),
                              metadata={"loss": "multiclass"})
    pf, _, meta = TC.load_forest_checkpoint(str(tmp_path), device="cpu")
    assert pf.depth == 4 and not pf.is_heap
    assert float(pf.lr) == float(m.packed.lr)
    for name, a, b in zip(pf._fields, pf, m.packed):
        if name != "lr":
            assert a == b if isinstance(a, int) else torch.equal(a, b), name


@pytest.mark.parametrize("variant", ["heap", "leafwise"])
def test_predict_staged_equals_sliced_predict(variant):
    """The reference's checks: ``staged[r]`` is ``predict_raw`` of the
    first r + 1 rounds bitwise, ``staged[-1]`` the full prediction, and
    `SketchBoost.predict_raw(iteration=)` a slice of it."""
    if variant == "leafwise":
        m, X = _port_leafwise_fit()
    else:
        X, y = _plain_data(3, n=300)
        m = TB.SketchBoost(TB.GBDTConfig(n_trees=5, depth=3,
                                         learning_rate=0.2),
                           device="cpu").fit(X, y)
    codes = m._bin(X)
    staged = TF.predict_staged(m.packed, codes)
    assert staged.shape == (5, len(X), m.packed.n_outputs)
    for r in (1, 3, 5):
        assert torch.equal(staged[r - 1], TF.predict_raw(
            TF.slice_rounds(m.packed, r), codes))
    assert torch.equal(m.predict_raw(X, 3), staged[2])
    assert torch.equal(m.predict_raw(X), staged[-1])


@pytest.mark.parametrize("variant", ["heap", "leafwise"])
def test_staged_eval_replays_the_history(variant):
    """``staged_eval`` equals the fit's valid losses (rtol 1e-5, atol 1e-6
    as in the reference's test) and its arg-min is the best iteration; the
    reference's ``staged_eval`` on the same forest agrees."""
    if variant == "leafwise":
        m, X = _port_leafwise_fit()
        Xv, yv = X[300:], make_tabular("multiclass", 400, 6, 4, seed=21,
                                       n_informative=6)[1][300:]
    else:
        X, y = make_tabular("multiclass", 400, 6, 3, seed=17,
                            n_informative=6)
        Xv, yv = X[:100], y[:100]
        m = TB.SketchBoost(TB.GBDTConfig(n_trees=8, depth=3,
                                         learning_rate=0.3,
                                         sketch_method="none"),
                           device="cpu").fit(X[100:], y[100:],
                                             eval_set=(Xv, yv))
    codes = m._bin(Xv)
    vloss = TF.staged_eval(m.packed, codes, m._targets(yv), "multiclass")
    hist = [r["valid_loss"] for r in m.history]
    np.testing.assert_allclose(vloss.numpy(), np.asarray(hist, np.float32),
                               rtol=1e-5, atol=1e-6)
    assert m.best_iteration == int(vloss.argmin()) + 1
    want = JF.staged_eval(_jax_packed(m.packed), jnp.asarray(codes.numpy()),
                          jnp.asarray(yv), "multiclass")
    np.testing.assert_allclose(vloss.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_shap_and_importances_on_a_leafwise_forest():
    """Explain runs on a port-fitted leaf-wise forest: local accuracy
    within 1e-4, SHAP within the explain tolerance (atol 1e-5 + rtol 1e-5)
    of the reference's on the same forest, importances as the
    reference's."""
    m, X = _port_leafwise_fit()
    phi, base = m.shap_values(X[:64], check_additivity=True)
    np.testing.assert_allclose((base + phi.sum(1)).numpy(),
                               m.predict_raw(X[:64]).numpy(), atol=1e-4)
    jpf = _jax_packed(m.packed)
    codes = jnp.asarray(m._bin(X[:64]).numpy())
    jphi, jbase = JEX.shap_values(jpf, codes, mode="jnp")
    np.testing.assert_allclose(phi.numpy(), np.asarray(jphi), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(base.numpy(), np.asarray(jbase), atol=1e-5,
                               rtol=1e-5)
    for kind in ("gain", "cover", "split_count"):
        np.testing.assert_allclose(
            m.feature_importances(kind).numpy(),
            np.asarray(JEX.feature_importances(jpf, kind=kind,
                                               n_features=6)),
            rtol=1e-6, atol=1e-7, err_msg=kind)
    ids = m.apply(X[:64])
    assert (m.packed.left[0][ids[:, 0].long()] == ids[:, 0]).all()


def test_apply_tree_of_a_node_tree_is_the_packed_walk():
    """The in-loop eval update of a leaf-wise round (`_apply_tree`) is the
    packed forest's traversal of that round."""
    m, X = _port_leafwise_fit()
    codes = m._bin(X[:50])
    F = m.base_score.expand(50, -1).contiguous()
    tree = TT.NodeTree(*(f[0] for f in m.forest))
    got = TB._apply_tree(tree, codes, F.clone(), m.cfg)
    want = TF.predict_raw(TF.slice_rounds(m.packed, 1), codes)
    assert torch.equal(got, want)
