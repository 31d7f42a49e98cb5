"""Port vs reference: bf16 histogram statistics (``hist_dtype="bfloat16"``,
B1's bf16 variant) from the plain version up to whole fits.

The reference rounds the statistics to bf16 inside its Pallas tiles kernel
and accumulates in float32; its jnp path has no bf16, so the reference side
runs in ``interpret`` mode.  The port's plain version rounds once, to
nearest even, and sums in float32 in B1's order.  Fixtures are tie-free
(not the reference's seed 30, where its own bf16 tree flips a near-tie).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import boosting as JB
from repro.core import histogram as JH
from repro.core import tree as JT
from repro.kernels import ops as JO
from repro.kernels.hist_kernel import hist_tiles_pallas
from repro_torch.core import boosting as TB
from repro_torch.core import tree as TT
from repro_torch.kernels import hist_kernel, ref
from repro_torch.kernels import ops as TO
from test_torch_fit import _replayed_projections
from test_torch_hist import _levels, _port_state, _problem

TREE_TOL = dict(rtol=1e-4, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True, order="C"))


def _level_inputs(seed, B, n=1500, m=5, level=2):
    """A subtract-engine level of a reference tree: codes, stats, the
    partition and the built counts."""
    codes, stats = _problem(seed, n=n, m=m, B=B)
    state = _levels(codes, stats, level + 1, B)[level][0]
    counts = np.array(state.counts)
    _, is_built = JH.smaller_children(state.counts)
    build = np.where(np.asarray(is_built), counts, 0).astype(np.int32)
    return codes, stats, state, counts, build


def _port_hist(codes, stats, state, counts, build, B, hist_dtype):
    order = _t(np.asarray(state.order))
    return hist_kernel.hist_nodes(
        _t(codes.T), order, _t(stats)[order.long()], _t(counts), _t(build),
        n_bins=B, hist_dtype=hist_dtype).numpy()


@pytest.mark.parametrize("seed,B", [(5, 16), (6, 256)])
def test_plain_bf16_matches_interpret_tiles_kernel(seed, B):
    """Plain B1-bf16 against the reference's ``hist_tiles_pallas(
    hist_dtype="bfloat16", interpret=True)`` summed per node: within 1e-6 x
    the scale (sum order only); the count channel bitwise."""
    codes, stats, state, counts, build = _level_inputs(seed, B)
    n, rt = codes.shape[0], 256
    n_tiles = n // 2 // rt + 1 + counts.shape[0]
    tile_node, src, valid = JO._tile_plan(state.counts, jnp.asarray(build),
                                          n=n, n_tiles=n_tiles, row_tile=rt)
    ri = state.order[src]
    stats_g = jnp.asarray(stats)[ri] * valid[:, None]
    tiles = hist_tiles_pallas(jnp.asarray(codes)[ri].T.astype(jnp.int32),
                              stats_g, n_bins=B, row_tile=rt,
                              hist_dtype="bfloat16", interpret=True)
    want = np.asarray(jax.ops.segment_sum(tiles.transpose(1, 0, 2, 3),
                                          tile_node,
                                          num_segments=counts.shape[0]))
    got = _port_hist(codes, stats, state, counts, build, B, "bfloat16")
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-6 * scale
    np.testing.assert_array_equal(got[..., -1], want[..., -1])


def test_plain_bf16_bitwise_node_hist_jnp_on_pre_rounded_stats():
    """Statistics k/8 (1 <= |k| < 128) plus noise under half a bf16 ulp:
    bf16 rounding drops the noise and every float32 sum of the rounded
    values is exact, so the port (rounding itself) equals the reference's
    ``node_hist_jnp`` on ``jnp.bfloat16``-rounded stats bit for bit, and
    differs from the unrounded fp32 build."""
    rng = np.random.default_rng(9)
    n, m, B = 800, 4, 32
    codes = rng.integers(0, B, (n, m)).astype(np.uint8)
    k = rng.integers(1, 128, (n, 3)) * rng.choice([-1, 1], (n, 3))
    noise = rng.uniform(0, 1e-4, (n, 3)) * np.abs(k) / 128
    stats = np.concatenate([k / 8 + noise, np.ones((n, 1))], 1).astype(
        np.float32)
    rows = np.sort(rng.choice(n, 500, replace=False)).astype(np.int32)
    rounded = jnp.asarray(stats).astype(jnp.bfloat16).astype(jnp.float32)
    want = np.asarray(JH.node_hist_jnp(jnp.asarray(codes)[rows],
                                       rounded[rows], n_bins=B))
    got = TO.node_histogram(_t(codes.T), _t(rows),
                            TO.stats_for(_t(stats), "bfloat16"), n_bins=B,
                            hist_dtype="bfloat16").numpy()
    np.testing.assert_array_equal(got, want)
    fp32 = TO.node_histogram(_t(codes.T), _t(rows), _t(stats),
                             n_bins=B).numpy()
    assert not np.array_equal(fp32, got)


@pytest.mark.parametrize("seed,B", [(7, 16), (8, 64)])
def test_plain_bf16_within_the_reference_envelope_of_fp32(seed, B):
    """Within the reference's 1e-2 x scale of the fp32 build (bf16 inputs
    round at 2^-8 relative); the count channel equal; and exactly the fp32
    build of the bf16-rounded statistics."""
    codes, stats, state, counts, build = _level_inputs(seed, B)
    got = _port_hist(codes, stats, state, counts, build, B, "bfloat16")
    fp32 = _port_hist(codes, stats, state, counts, build, B, "float32")
    rounded = torch.from_numpy(stats).to(torch.bfloat16).float().numpy()
    again = _port_hist(codes, rounded, state, counts, build, B, "float32")
    assert np.abs(got - fp32).max() <= 1e-2 * np.abs(fp32).max()
    np.testing.assert_array_equal(got[..., -1], fp32[..., -1])
    np.testing.assert_array_equal(got, again)


def test_subtraction_drift_bounded_bf16():
    """Mirrors the reference's ``test_subtraction_drift_bounded_bf16``:
    the bf16 subtract chain stays within 4e-2 x scale of the exact direct
    histograms at every level."""
    n, m, B, depth = 520, 6, 16, 4
    codes, stats = _problem(21, n=n, m=m, B=B)
    prev = None
    for lvl, (state, node_pos) in enumerate(_levels(codes, stats, depth, B)):
        s = _port_state(state)
        _, _, prev = TO.histogram_splits_level(
            _t(codes.T), TO.stats_for(_t(stats), "bfloat16"), s.order,
            s.counts, prev, 1.0, 1.0, n_bins=B, subtract=lvl > 0,
            hist_dtype="bfloat16")
        direct = np.asarray(JH.build_histograms_jnp(
            jnp.asarray(codes), node_pos, jnp.asarray(stats),
            n_nodes=2 ** lvl, n_bins=B))
        scale = max(np.abs(direct).max(), 1.0)
        assert np.abs(prev.numpy() - direct).max() <= 4e-2 * scale, lvl


def test_unknown_hist_dtype_raises():
    codes, stats, state, counts, build = _level_inputs(3, 16, n=300)
    order = _t(np.asarray(state.order))
    args = (_t(codes.T), order, _t(stats), _t(counts), _t(build))
    with pytest.raises(ValueError, match="unknown hist_dtype"):
        hist_kernel.hist_nodes(*args, n_bins=16, hist_dtype="float16")
    with pytest.raises(ValueError, match="unknown hist_dtype"):
        ref.hist_nodes_ref(*args, n_bins=16, hist_dtype="float16")
    with pytest.raises(ValueError, match="unknown hist_dtype"):
        TO.node_histogram(_t(codes.T), order, _t(stats), n_bins=16,
                          hist_dtype="float16")
    with pytest.raises(ValueError, match="unknown hist_dtype"):
        TO.histogram_splits_level(_t(codes.T), _t(stats), order,
                                  _t(counts), None, 1.0, 1.0, n_bins=16,
                                  subtract=False, hist_dtype="float16")


def test_builders_take_the_cast_statistics_only():
    """`ops.stats_for` is the one cast: the level and node builders refuse
    statistics in another storage type than ``hist_dtype``'s."""
    codes, stats, state, counts, build = _level_inputs(4, 16, n=300)
    order = _t(np.asarray(state.order))
    for hist_dtype, wrong in (("bfloat16", _t(stats)),
                              ("float32", _t(stats).to(torch.bfloat16))):
        with pytest.raises(ValueError, match="stats_for"):
            TO.node_histogram(_t(codes.T), order, wrong, n_bins=16,
                              hist_dtype=hist_dtype)
        with pytest.raises(ValueError, match="stats_for"):
            TO.histogram_splits_level(_t(codes.T), wrong, order, _t(counts),
                                      None, 1.0, 1.0, n_bins=16,
                                      subtract=False, hist_dtype=hist_dtype)


def test_hist_nodes_refuses_segments_past_its_rows():
    """B1's wrapper refuses an ``order`` longer than the rows of
    ``codes_t``, and host counts whose segments run past ``order``."""
    codes, stats, state, counts, build = _level_inputs(3, 16, n=300)
    order = _t(np.asarray(state.order))
    args = (_t(codes.T), order, _t(stats), _t(counts), _t(build))
    long_order = torch.cat([order, order[:1]])
    with pytest.raises(ValueError, match="more than"):
        hist_kernel.hist_nodes(args[0], long_order,
                               torch.cat([args[2], args[2][:1]]), *args[3:],
                               n_bins=16)
    short = order[:-10]
    with pytest.raises(ValueError, match="past the"):
        hist_kernel.hist_nodes(args[0], short, args[2][:-10], *args[3:],
                               n_bins=16)


# -- trees and fits ---------------------------------------------------------------

def _rand_problem(seed, n=450, m=8, B=16, d=3):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, B, (n, m)).astype(np.uint8)
    G = rng.normal(size=(n, d)).astype(np.float32)
    Hd = np.ones((n, d), np.float32)
    stats = np.concatenate([G, np.ones((n, 1), np.float32)], 1)
    return codes, stats, G, Hd


@pytest.mark.parametrize("growth", ["subtract", "partition", "leafwise"])
def test_bf16_tree_matches_reference_interpret(growth):
    """A bf16 tree of each growth mode against the reference's interpret
    path on a tie-free seed: the same splits and leaf_pos, values within
    rtol 1e-4 / atol 1e-5."""
    codes, stats, G, Hd = _rand_problem(31)
    kw = dict(depth=4, n_bins=16, lam=1.0, hist_dtype="bfloat16")
    jargs = (jnp.asarray(codes), jnp.asarray(stats), jnp.asarray(G),
             jnp.asarray(Hd))
    targs = (_t(codes), _t(codes.T), _t(stats), _t(G), _t(Hd))
    if growth == "leafwise":
        tr, pos_r = JT.grow_tree_leafwise(*jargs, max_leaves=11,
                                          use_kernel="interpret", **kw)
        t, pos = TT.grow_tree_leafwise(*targs, max_leaves=11, **kw)
        names = ("feat", "thr", "left", "right", "node_count")
    else:
        tr, pos_r = JT.grow_tree(*jargs, hist_engine=growth,
                                 use_kernel="interpret", **kw)
        t, pos = TT.grow_tree(*targs, hist_engine=growth, **kw)
        names = ("feat", "thr")
    for name in names:
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(tr, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(pos_r))
    np.testing.assert_allclose(t.value.numpy(), np.asarray(tr.value),
                               **TREE_TOL)
    np.testing.assert_allclose(t.gain.numpy(), np.asarray(tr.gain),
                               **TREE_TOL)


def test_direct_engine_ignores_hist_dtype_in_both_packages():
    """The direct engine has no bf16 variant (B4 and ``histogram_pallas``
    take float32): ``hist_dtype="bfloat16"`` grows the fp32 tree in each
    package (ROADMAP §C)."""
    codes, stats, G, Hd = _rand_problem(32)
    kw = dict(depth=3, n_bins=16, lam=1.0, hist_engine="direct")
    jargs = (jnp.asarray(codes), jnp.asarray(stats), jnp.asarray(G),
             jnp.asarray(Hd))
    j32, _ = JT.grow_tree(*jargs, use_kernel="interpret", **kw)
    j16, _ = JT.grow_tree(*jargs, use_kernel="interpret",
                          hist_dtype="bfloat16", **kw)
    targs = (_t(codes), _t(codes.T), _t(stats), _t(G), _t(Hd))
    t32, _ = TT.grow_tree(*targs, **kw)
    t16, _ = TT.grow_tree(*targs, hist_dtype="bfloat16", **kw)
    for a, b in zip(j32, j16):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(t32, t16):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(t16.feat.numpy(), np.asarray(j16.feat))


def _plain_data(seed, n=600, m=8, d=5):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, m)).astype(np.float32),
            rng.integers(0, d, n).astype(np.int32))


@pytest.mark.parametrize("growth", [dict(), dict(growth="leafwise",
                                                 max_leaves=7)])
def test_bf16_fit_matches_reference(growth):
    """A bf16 fit with the reference's per-round Pi against the
    reference's bf16 fit (interpret kernels, its only bf16 path): the same
    node counts, valid losses within rtol 1e-5 and predictions within 5e-7,
    the fp32 fits' limit.  That holds because the splits agree (tie-free
    data): the leaf values come from the full float32 gradients in both
    packages, so bf16 rounding reaches the predictions only through the
    choice of splits."""
    X, y = _plain_data(15)
    Xt, yt, Xv, yv = X[:450], y[:450], X[450:520], y[450:520]
    kw = dict(n_trees=3, depth=3, learning_rate=0.3, n_bins=16, sketch_k=2,
              min_data_in_leaf=20.0, hist_dtype="bfloat16", **growth)
    jm = JB.SketchBoost(JB.GBDTConfig(use_kernel="interpret", loop="python",
                                      **kw)).fit(Xt, yt, eval_set=(Xv, yv))
    port = TB.SketchBoost(TB.GBDTConfig(**kw), device="cpu").fit(
        Xt, yt, eval_set=(Xv, yv),
        sketch_mats=_replayed_projections(0, 3, 5, 2))
    assert port.cfg.hist_dtype == "bfloat16"
    np.testing.assert_array_equal(port.packed.node_count.numpy(),
                                  np.asarray(jm.packed.node_count))
    np.testing.assert_allclose([h["valid_loss"] for h in port.history],
                               [h["valid_loss"] for h in jm.history],
                               rtol=1e-5)
    np.testing.assert_allclose(port.predict_raw(X[520:]).numpy(),
                               np.asarray(jm.predict_raw(X[520:])),
                               atol=5e-7)


def test_bf16_accepted_on_the_cpu_unlike_the_reference_jnp_path():
    """The reference refuses bf16 under its jnp path, which would ignore
    it; the port has no jnp mode and its plain version rounds, so it
    accepts bf16 on every device (ROADMAP §C)."""
    with pytest.raises(ValueError, match="jnp path would silently ignore"):
        JB.GBDTConfig(hist_dtype="bfloat16", use_kernel="jnp").validate()
    JB.GBDTConfig(hist_dtype="bfloat16", use_kernel="interpret").validate()
    TB.GBDTConfig(hist_dtype="bfloat16").validate()
    TB.GBDTConfig(hist_dtype="bfloat16", growth="leafwise",
                  max_leaves=8).validate()
