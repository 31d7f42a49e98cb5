"""``strategy="one_vs_all"``: the port's d univariate trees a round against
the JAX package, and the grouped growers against themselves.

Reference: ``GBDTConfig(use_kernel="jnp", loop="python")``, which vmaps its
single-output grower over the outputs.  Features are drawn independent
(``n_informative=m``) and ``min_data_in_leaf`` keeps leaves large.  A
univariate tree's gradients take few distinct values in the first rounds
(``p - y`` with y in {0, 1}), so two splits can tie exactly in exact
arithmetic and the two packages' roundings break such a tie differently
(ROADMAP §C); the seeds below give fits without one.  The reference holds
its histogram engines to one forest (``tests/test_hist_engine.py``), so
the port's engines are all held to its default engine's fit.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import boosting as JB
from repro.core import forest as JF
from repro.core import tree as JT
from repro.data.pipeline import make_tabular
from repro.training import serve_lib as JS
from repro_torch.core import boosting as TB
from repro_torch.core import forest as TF
from repro_torch.core import histogram as TH
from repro_torch.core import tree as TT
from repro_torch.io import checkpoint as TC
from repro_torch.kernels import hist_kernel, ref
from repro_torch.training import serve_lib as TS

M = 8
KW = dict(strategy="one_vs_all", n_trees=10, depth=4, learning_rate=1.0,
          early_stopping_rounds=2, min_data_in_leaf=20.0)
# (loss, d, seed): multiclass, multilabel and multi-target regression.
TASKS = {"multiclass": (4, 1), "multilabel": (3, 1), "multitask_mse": (3, 4)}


def _data(task):
    d, seed = TASKS[task]
    X, y = make_tabular(task, 900, M, d, seed=seed, n_informative=M)
    return X[:600], y[:600], X[600:750], y[600:750], X[750:]


@functools.lru_cache(maxsize=None)
def _ref_fit(task, growth="levelwise", max_leaves=0):
    Xt, yt, Xv, yv, _ = _data(task)
    cfg = JB.GBDTConfig(loss=task, growth=growth, max_leaves=max_leaves,
                        use_kernel="jnp", loop="python", **KW)
    return JB.SketchBoost(cfg).fit(Xt, yt, eval_set=(Xv, yv))


@functools.lru_cache(maxsize=None)
def _port_fit(task, **kw):
    Xt, yt, Xv, yv, _ = _data(task)
    cfg = TB.GBDTConfig(loss=task, **dict(KW, **kw))
    return TB.SketchBoost(cfg, device="cpu").fit(Xt, yt, eval_set=(Xv, yv))


def _assert_fit_matches(port, ref_model, X):
    assert len(ref_model.history) < KW["n_trees"]     # early stopping fired
    assert port.best_round == ref_model.best_round
    assert [h["round"] for h in port.history] == [
        h["round"] for h in ref_model.history]
    np.testing.assert_allclose([h["valid_loss"] for h in port.history],
                               [h["valid_loss"] for h in ref_model.history],
                               rtol=1e-5)
    for f in ("feat", "thr", "left", "right", "out_col", "node_count"):
        np.testing.assert_array_equal(getattr(port.packed, f).numpy(),
                                      np.asarray(getattr(ref_model.packed, f)),
                                      err_msg=f)
    assert port.packed.trees_per_round == port.packed.n_outputs
    np.testing.assert_allclose(port.predict_raw(X).numpy(),
                               np.asarray(ref_model.predict_raw(X)),
                               atol=1e-4)
    np.testing.assert_allclose(port.predict(X).numpy(),
                               np.asarray(ref_model.predict(X)), atol=1e-4)


@pytest.mark.parametrize("task", sorted(TASKS))
def test_fit_matches_reference(task):
    _assert_fit_matches(_port_fit(task), _ref_fit(task), _data(task)[4])


@pytest.mark.parametrize("engine", ["direct", "partition"])
def test_engines_match_reference(engine):
    port = _port_fit("multiclass", hist_engine=engine)
    assert port.cfg.hist_engine == engine
    _assert_fit_matches(port, _ref_fit("multiclass"), _data("multiclass")[4])


@pytest.mark.parametrize("max_leaves", [6, 16])
def test_leafwise_matches_reference(max_leaves):
    port = _port_fit("multiclass", growth="leafwise", max_leaves=max_leaves)
    assert isinstance(port.forest, TT.NodeTree)
    _assert_fit_matches(port, _ref_fit("multiclass", "leafwise", max_leaves),
                        _data("multiclass")[4])


def test_leafwise_full_budget_is_levelwise_bitwise():
    """At ``max_leaves = 2^depth`` the lockstep leaf-wise grower expands
    every node that level-wise growth splits, puts each tree's rows into
    the level-wise leaves and sums them in the same order: equal
    predictions, bit for bit."""
    lvl = _port_fit("multiclass")
    lw = _port_fit("multiclass", growth="leafwise", max_leaves=16)
    X = _data("multiclass")[0]
    assert torch.equal(lw.predict_raw(X), lvl.predict_raw(X))
    a, b = lvl.apply(X), lw.apply(X)
    for t in range(a.shape[1]):
        pairs = torch.unique(a[:, t].long() * 64 + b[:, t].long())
        assert (pairs.numel() == torch.unique(a[:, t]).numel()
                == torch.unique(b[:, t]).numel())
    assert lvl.best_round == lw.best_round
    assert [h["valid_loss"] for h in lvl.history] == [
        h["valid_loss"] for h in lw.history]


@pytest.mark.parametrize("growth", ["levelwise", "leafwise"])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_groups_of_trees_train_the_same_forest(monkeypatch, growth, group):
    """Groups of 1, 2 and all d = 4 trees: the same forest, bit for bit."""
    kw = dict(growth=growth, max_leaves=12 if growth == "leafwise" else 0,
              n_trees=3)
    Xt, yt, Xv, yv, X = _data("multiclass")
    cfg = TB.GBDTConfig(loss="multiclass", **dict(KW, **kw))
    monkeypatch.setattr(TT, "OVA_GROUP_ENTRIES", len(Xt) * 4)
    whole = TB.SketchBoost(cfg, device="cpu").fit(Xt, yt, eval_set=(Xv, yv))
    monkeypatch.setattr(TT, "OVA_GROUP_ENTRIES", len(Xt) * group + 3)
    assert len(TT.ova_groups(4, len(Xt))) == -(-4 // group)
    part = TB.SketchBoost(cfg, device="cpu").fit(Xt, yt, eval_set=(Xv, yv))
    for name, a in whole.packed._asdict().items():
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, getattr(part.packed, name)), name
    assert torch.equal(whole.predict_raw(X), part.predict_raw(X))
    assert whole.history == [dict(h, train_time_s=g["train_time_s"])
                             for h, g in zip(part.history, whole.history)]


@pytest.mark.parametrize("hist_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("subtract", [False, True])
def test_group_grower_is_per_tree_grower(hist_dtype, subtract):
    """The level-wise group grower against `grow_tree` run on each column
    alone (the single-output grower on ``[g_t, 1]``): the same splits and
    leaves; leaf values within float32 rounding of the two leaf passes."""
    rng = np.random.default_rng(3)
    n, m, d, B = 700, 5, 3, 32
    codes = torch.from_numpy(rng.integers(0, B, (n, m)).astype(np.uint8))
    G = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    Hd = torch.from_numpy(rng.uniform(0.1, 1, (n, d)).astype(np.float32))
    kw = dict(depth=3, n_bins=B, lam=1.0, min_data_in_leaf=5.0,
              hist_dtype=hist_dtype)
    tree, pos = TT.grow_trees_levelwise(codes.T.contiguous(), G, Hd,
                                        subtract=subtract, **kw)
    engine = "subtract" if subtract else "partition"
    for t in range(d):
        one, p1 = TT.grow_tree(codes, codes.T.contiguous(),
                               torch.stack([G[:, t], torch.ones(n)], 1),
                               G[:, t:t + 1], Hd[:, t:t + 1],
                               hist_engine=engine, **kw)
        assert torch.equal(tree.feat[t], one.feat)
        assert torch.equal(tree.thr[t], one.thr)
        assert torch.equal(tree.gain[t], one.gain)
        assert torch.equal(tree.cover[t], one.cover)
        assert torch.equal(pos[t], p1)
        torch.testing.assert_close(tree.value[t], one.value, rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("hist_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,levels", [(900, 3), (ref.TILE_ROWS + 700, 2)])
def test_hist_nodes_plain_at_s_past_n(hist_dtype, n, levels):
    """B1's plain version over a partition of 3 trees (S = 3n > n, node ids
    tree-major) equals the per-tree calls concatenated, bit for bit,
    through the subtract engine's build counts and tiles past one."""
    rng = np.random.default_rng(n)
    trees, m, B = 3, 3, 64
    codes_t = torch.from_numpy(rng.integers(0, B, (m, n)).astype(np.uint8))
    g = torch.from_numpy(rng.normal(size=(trees, n)).astype(np.float32))
    state = TH.init_level_state(n, trees=trees)
    for _ in range(levels):
        bits = torch.from_numpy(rng.random(trees * n) < 0.4)
        state = TH.advance_level_state(state, bits, permuted=True)
    _, is_built = TH.smaller_children(state.counts)
    build = torch.where(is_built, state.counts, 0).to(torch.int32)
    tree_of = state.node_perm >> levels
    stats_p = torch.stack([g.reshape(-1)[tree_of.long() * n
                                         + state.order.long()],
                           torch.ones(trees * n)], 1)
    stats_p = stats_p.to(ref.stats_dtype(hist_dtype))
    kw = dict(n_bins=B, hist_dtype=hist_dtype)
    whole = hist_kernel.hist_nodes(codes_t, state.order, stats_p,
                                   state.counts, build, **kw)
    per = 2 ** levels
    parts = [hist_kernel.hist_nodes(
        codes_t, state.order[t * n:(t + 1) * n], stats_p[t * n:(t + 1) * n],
        state.counts[t * per:(t + 1) * per], build[t * per:(t + 1) * per],
        **kw) for t in range(trees)]
    assert torch.equal(whole, torch.cat(parts))
    # Every tree's entries stayed in its block, sorted by node.
    assert torch.equal(tree_of, torch.arange(trees).repeat_interleave(n)
                       .to(torch.int32))
    for t in range(trees):
        blk = state.order[t * n:(t + 1) * n]
        assert torch.equal(torch.sort(blk).values,
                           torch.arange(n, dtype=torch.int32))


def test_segment_sums_depend_on_the_segment_alone():
    rng = np.random.default_rng(0)
    lengths = [0, 5, 700, 1, 256, 0, 513]
    vals = torch.from_numpy(rng.normal(size=(sum(lengths), 2))
                            .astype(np.float32))
    out = TH.segment_sums(vals, torch.tensor(lengths))
    s = 0
    for i, n in enumerate(lengths):
        alone = TH.segment_sums(vals[s:s + n], torch.tensor([n]))
        assert torch.equal(out[i], alone[0])
        np.testing.assert_allclose(out[i].numpy(),
                                   vals[s:s + n].double().sum(0).numpy(),
                                   rtol=1e-5, atol=1e-5)
        s += n


@pytest.mark.parametrize("growth", ["levelwise", "leafwise"])
def test_pack_forest_matches_reference(growth):
    """The port's one-vs-all fold against the reference's pack of the same
    (rounds, d, ...) training buffers, every field bit for bit."""
    kw = dict(growth="leafwise", max_leaves=6) if growth == "leafwise" else {}
    port = _port_fit("multiclass", **kw)
    f = port.forest
    arrays = {k: jnp.asarray(v.numpy()) for k, v in f._asdict().items()
              if v is not None}
    jforest = (JT.NodeTree(**arrays) if growth == "leafwise"
               else JT.Forest(**arrays))
    depth = KW["depth"] if growth == "leafwise" else None
    jp = JF.pack_forest(jforest, jnp.asarray(port.base_score.numpy()),
                        KW["learning_rate"], strategy="one_vs_all",
                        max_depth=depth)
    tp = TF.pack_forest(f, port.base_score, KW["learning_rate"],
                        strategy="one_vs_all", max_depth=depth)
    for name in ("feat", "thr", "left", "right", "leaf", "out_col", "cover",
                 "gain", "node_count", "base", "lr"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)),
                                      err_msg=name)
    assert tp.depth == jp.depth
    back, strategy = TF.unpack_forest(tp)
    assert strategy == "one_vs_all"
    for a, b in zip(back, f):
        if b is not None and growth == "leafwise":
            assert torch.equal(a, b)
    if growth == "levelwise":
        assert torch.equal(back.feat, f.feat) and torch.equal(back.value,
                                                              f.value)


# -- downstream paths on a port-fitted one-vs-all model ----------------------

@pytest.mark.parametrize("growth", ["levelwise", "leafwise"])
def test_staged_prediction(growth):
    kw = dict(growth="leafwise", max_leaves=6) if growth == "leafwise" else {}
    port = _port_fit("multiclass", **kw)
    _, _, Xv, yv, _ = _data("multiclass")
    codes = port._bin(Xv)
    staged = TF.predict_staged(port.packed, codes)
    assert staged.shape[0] == port.packed.n_rounds == port.best_iteration
    assert torch.equal(staged[-1], port.predict_raw(Xv))
    assert torch.equal(staged[1], port.predict_raw(Xv, iteration=2))
    losses = TF.staged_eval(port.packed, codes, port._targets(yv),
                            "multiclass")
    np.testing.assert_allclose(
        losses.numpy(), [h["valid_loss"] for h in
                         port.history[:port.best_iteration]], rtol=1e-5)


@pytest.mark.parametrize("growth", ["levelwise", "leafwise"])
def test_shap_apply_and_importances(growth):
    kw = dict(growth="leafwise", max_leaves=6) if growth == "leafwise" else {}
    port = _port_fit("multiclass", **kw)
    ref_model = _ref_fit("multiclass", growth, kw.get("max_leaves", 0))
    X = _data("multiclass")[4][:40]
    phi, _ = port.shap_values(X, check_additivity=True)
    assert phi.shape == (40, M, 4) and bool(phi.isfinite().all())
    jphi, _ = ref_model.shap_values(X)
    np.testing.assert_allclose(phi.numpy(), np.asarray(jphi), atol=1e-4)
    leaves = port.apply(X)
    assert leaves.shape == (40, port.packed.n_trees)
    np.testing.assert_array_equal(leaves.numpy(),
                                  np.asarray(ref_model.apply(X)))
    for kind in ("gain", "cover", "split_count"):
        np.testing.assert_allclose(
            port.feature_importances(kind).numpy(),
            np.asarray(ref_model.feature_importances(kind)), rtol=1e-5,
            atol=1e-7)


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_checkpoint_serves(tmp_path, quantize):
    """A port-fitted one-vs-all model through a checkpoint into the port's
    `ForestServer` (float32: the model's predictions bit for bit; int8:
    the reference's server on the same checkpoint)."""
    port = _port_fit("multiclass")
    X = _data("multiclass")[4]
    TC.save_forest_checkpoint(str(tmp_path), port.packed, port.quantizer,
                              metadata={"loss": "multiclass"})
    srv = TS.ForestServer.from_checkpoint(str(tmp_path), device="cpu",
                                          quantize=quantize)
    reqs = [X[:7], X[7:40], X[40:41]]
    got = srv.serve(reqs)
    if quantize == "none":
        want = port.predict(X[:41]).numpy()
        np.testing.assert_array_equal(np.concatenate(got), want)
    else:
        jsrv = JS.ForestServer.from_checkpoint(str(tmp_path),
                                               quantize=quantize)
        for a, b in zip(got, jsrv.serve(reqs)):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-4)
