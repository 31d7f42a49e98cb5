"""Port vs reference: row partition, level histograms, split scan.

Inputs are made with numpy from a seed and go through the JAX package
(jnp paths, ``ref`` oracles, or Pallas ``interpret=True``) and its PyTorch
port on the CPU, where the port's kernel wrappers run their plain versions.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import histogram as JH
from repro.core import split as JS
from repro.core import tree as JT
from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro_torch.core import histogram as TH
from repro_torch.core import split as TS
from repro_torch.core import tree as TT
from repro_torch.kernels import hist_kernel, ref, split_kernel
from repro_torch.kernels import ops as TO


def _problem(seed, n=520, m=6, B=16, d=3):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, B, (n, m)).astype(np.uint8)
    G = rng.normal(size=(n, d)).astype(np.float32)
    stats = np.concatenate([G, np.ones((n, 1), np.float32)], 1)
    return codes, stats


def _levels(codes, stats, depth, B):
    """Reference LevelStates and node positions of a grown tree's levels."""
    n = codes.shape[0]
    tree, _ = JT.grow_tree(jnp.asarray(codes), jnp.asarray(stats),
                           jnp.asarray(stats[:, :-1]),
                           jnp.ones((n, stats.shape[1] - 1)), depth=depth,
                           n_bins=B, lam=1.0, use_kernel="jnp",
                           hist_engine="direct")
    state = JH.init_level_state(n)
    node_pos = jnp.zeros((n,), jnp.int32)
    out = [(state, node_pos)]
    for lvl in range(depth - 1):
        off = 2 ** lvl - 1
        feat = tree.feat[off:2 * off + 1]
        thr = tree.thr[off:2 * off + 1]
        bits = JT.route_bits(jnp.asarray(codes), node_pos, feat, thr)
        node_pos = node_pos * 2 + bits
        state = JH.advance_level_state(state, bits)
        out.append((state, node_pos))
    return out


def _port_state(state):
    return TH.LevelState(*(torch.from_numpy(np.array(x)) for x in state))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_advance_level_state_bitwise(seed):
    rng = np.random.default_rng(seed)
    n = 300
    s_ref, s = JH.init_level_state(n), TH.init_level_state(n)
    for _ in range(4):
        bits = (rng.random(n) < rng.random()).astype(np.int32)
        s_ref = JH.advance_level_state(s_ref, jnp.asarray(bits))
        s = TH.advance_level_state(s, torch.from_numpy(bits))
        for a, b in zip(s, s_ref):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("counts", [[3, 5, 4, 4, 0, 7, 9, 2],
                                    [1, 1, 0, 0, 6, 6, 2, 8]])
def test_smaller_children_and_interleave_bitwise(counts):
    c = np.asarray(counts, np.int32)
    side_r, built_r = JH.smaller_children(jnp.asarray(c))
    side, built = TH.smaller_children(torch.from_numpy(c))
    np.testing.assert_array_equal(side.numpy(), np.asarray(side_r))
    np.testing.assert_array_equal(built.numpy(), np.asarray(built_r))
    b = np.arange(4 * 3, dtype=np.float32).reshape(4, 3)
    s = -b - 1
    np.testing.assert_array_equal(
        TH.interleave_children(side, torch.from_numpy(b),
                               torch.from_numpy(s)).numpy(),
        np.asarray(JH.interleave_children(side_r, jnp.asarray(b),
                                          jnp.asarray(s))))


@pytest.mark.parametrize("seed,row_tile", [(0, 256), (1, 64), (2, 8)])
def test_tile_plan_bitwise(seed, row_tile):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 700, 8).astype(np.int32)
    counts[3] = 0
    build = np.where(rng.random(8) < 0.5, counts, 0).astype(np.int32)
    n = int(counts.sum())
    n_tiles = n // row_tile + 1 + 8
    r = JO._tile_plan(jnp.asarray(counts), jnp.asarray(build), n=n,
                      n_tiles=n_tiles, row_tile=row_tile)
    p = TO.tile_plan(torch.from_numpy(counts), torch.from_numpy(build), n=n,
                     n_tiles=n_tiles, row_tile=row_tile)
    for a, b in zip(p, r):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_build_level_matches_reference():
    """The port's level builder (the histograms of the fused level step,
    plain versions on the CPU) against ``build_level_jnp``, subtract
    engine, level by level.  Dyadic statistics make every float32 sum
    exact in any order, so the two builders must agree bitwise."""
    codes, stats = _problem(4)
    stats = np.round(stats * 8) / 8
    B = 16
    prev_r = prev = None
    codes_t = torch.from_numpy(codes.T.copy())
    for lvl, (state, _) in enumerate(_levels(codes, stats, 4, B)):
        sub = lvl > 0
        prev_r = JH.build_level_jnp(jnp.asarray(codes), jnp.asarray(stats),
                                    state, prev_r, n_nodes=2 ** lvl,
                                    n_bins=B, subtract=sub)
        s = _port_state(state)
        _, _, prev = TO.histogram_splits_level(
            codes_t, torch.from_numpy(stats), s.order, s.counts, prev, 1.0,
            1.0, n_bins=B, subtract=sub)
        np.testing.assert_array_equal(prev.numpy(), np.asarray(prev_r))


@pytest.mark.parametrize("seed,B", [(5, 16), (6, 256)])
def test_plain_hist_matches_tiles_ref_and_segment_sum(seed, B):
    """Plain B1 against the reference's per-tile oracle followed by the
    tile->node segment_sum of ``ops.histogram_splits_level``."""
    codes, stats = _problem(seed, n=1500, m=5, B=B)
    state = _levels(codes, stats, 3, B)[2][0]
    counts = np.array(state.counts)
    side, is_built = JH.smaller_children(state.counts)
    build = np.where(np.asarray(is_built), counts, 0).astype(np.int32)
    n, rt = codes.shape[0], 256
    n_tiles = n // 2 // rt + 1 + counts.shape[0]
    tile_node, src, valid = JO._tile_plan(state.counts, jnp.asarray(build),
                                          n=n, n_tiles=n_tiles, row_tile=rt)
    ri = state.order[src]
    stats_g = jnp.asarray(stats)[ri] * valid[:, None]
    tiles = JR.histogram_tiles_ref(jnp.asarray(codes)[ri].T, stats_g,
                                   n_bins=B, row_tile=rt)
    expect = jax.ops.segment_sum(tiles.transpose(1, 0, 2, 3), tile_node,
                                 num_segments=counts.shape[0])
    order = torch.from_numpy(np.array(state.order))
    stats_p = torch.from_numpy(stats)[order.long()]
    got = hist_kernel.hist_nodes(torch.from_numpy(codes.T.copy()), order,
                                 stats_p, torch.from_numpy(counts),
                                 torch.from_numpy(build), n_bins=B)
    expect = np.asarray(expect)
    np.testing.assert_allclose(got.numpy()[..., :-1], expect[..., :-1],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got.numpy()[..., -1], expect[..., -1])


def _replay_b1(codes, order, stats_p, counts, build, B, row_tile):
    """B1's documented order in float32 numpy: each node's first
    ``build[v]`` rows cut into ``row_tile`` tiles from its segment's start;
    each cell of a tile adds its rows in row order from 0.0, and the tiles
    are added into the node in tile order from 0.0."""
    m, c = codes.shape[1], stats_p.shape[1]
    out = np.zeros((len(counts), m, B, c), np.float32)
    start = 0
    for v, (cnt, bc) in enumerate(zip(counts, build)):
        for t0 in range(0, bc, row_tile):
            part = np.zeros((m, B, c), np.float32)
            for p in range(start + t0, start + min(t0 + row_tile, bc)):
                for f in range(m):
                    cell = part[f, codes[order[p], f]]
                    cell[:] = (cell + stats_p[p]).astype(np.float32)
            out[v] = (out[v] + part).astype(np.float32)
        start += cnt
    return out


@pytest.mark.parametrize("row_tile", [7, 64])
def test_hist_nodes_ref_sums_tiles_in_order(row_tile):
    """Plain B1 keeps its documented order bit for bit (a float32 numpy
    replay at a small tile length): rows cross several tile boundaries,
    one node is empty, one builds none of its rows, one ends in a one-row
    tile, and the segments end before the rows of ``codes_t`` do."""
    rng = np.random.default_rng(row_tile)
    m, B, c = 3, 6, 3
    counts = np.array([3 * row_tile + 1, 0, 40, 2 * row_tile + 5, 9],
                      np.int32)
    build = counts.copy()
    build[2] = 0
    build[3] -= 2
    s = int(counts.sum())
    n = s + 11
    codes = rng.integers(0, B, (n, m)).astype(np.uint8)
    order = rng.permutation(n)[:s].astype(np.int32)
    stats_p = (rng.normal(size=(s, c)) * 10.0 ** rng.integers(-4, 5, (s, 1))
               ).astype(np.float32)
    want = _replay_b1(codes, order, stats_p, counts, build, B, row_tile)
    got = ref.hist_nodes_ref(
        torch.from_numpy(codes.T.copy()), torch.from_numpy(order),
        torch.from_numpy(stats_p), torch.from_numpy(counts),
        torch.from_numpy(build), n_bins=B, row_tile=row_tile)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[1].any() and not got[2].any()


def test_tile_rows_is_the_kernels_constant():
    """The plain versions' tile length is the one the kernels are built
    with."""
    src = (Path(hist_kernel.__file__).parent / "csrc"
           / "hist_common.cuh").read_text()
    assert f"constexpr int kTileRows = {ref.TILE_ROWS};" in src


def _hist_native(h):
    """(nodes, m, B, C) -> the reference's (m, nodes * B, C) layout."""
    nodes, m, B, c = h.shape
    return jnp.asarray(h.transpose(1, 0, 2, 3).reshape(m, nodes * B, c))


def _scan_both(h, lam=1.0, min_data=1.0, mask=None):
    m = h.shape[1]
    mask = np.ones(m, np.float32) if mask is None else mask
    g_r, i_r = JR.split_scan_ref(_hist_native(h), jnp.float32(lam),
                                 jnp.float32(min_data), jnp.asarray(mask),
                                 n_nodes=h.shape[0], n_bins=h.shape[2])
    g, i = split_kernel.split_scan(torch.from_numpy(h), lam, min_data,
                                   torch.from_numpy(mask))
    return (g.numpy(), i.numpy()), (np.asarray(g_r), np.asarray(i_r))


def _rand_hist(rng, nodes=4, m=5, B=32, k=3):
    h = rng.normal(size=(nodes, m, B, k + 1)).astype(np.float32)
    h[..., -1] = rng.integers(0, 9, (nodes, m, B))
    return h


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_split_scan_matches_reference(seed):
    (g, i), (g_r, i_r) = _scan_both(_rand_hist(np.random.default_rng(seed)))
    np.testing.assert_array_equal(i, i_r)
    np.testing.assert_allclose(g, g_r, rtol=1e-5)


@pytest.mark.parametrize("min_gain", [0.0, 0.5])
def test_split_scores_and_best_splits_match_reference(min_gain):
    h = _rand_hist(np.random.default_rng(6), nodes=3, m=4)
    mask = np.array([1, 1, 0, 1], np.float32)
    g_r = JS.split_scores(jnp.asarray(h), jnp.float32(1.0), jnp.float32(2.0),
                          jnp.asarray(mask) > 0)
    g = TS.split_scores(torch.from_numpy(h), 1.0, 2.0, torch.from_numpy(mask))
    np.testing.assert_allclose(g.numpy(), np.asarray(g_r), rtol=1e-5)
    sp_r = JS.best_splits(g_r, jnp.float32(min_gain))
    sp = TS.best_splits(torch.from_numpy(np.array(g_r)), min_gain)
    for a, b in zip(sp, sp_r):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_split_scan_ties_take_first_index():
    h = _rand_hist(np.random.default_rng(3), nodes=2, m=4)
    h[:, 2] = h[:, 0]                       # feature 2 duplicates feature 0
    h[:, 1] = h[:, 3]
    h[:, :, 10:12] = 0.0                    # empty bins: equal adjacent gains
    (g, i), (g_r, i_r) = _scan_both(h)
    np.testing.assert_array_equal(i, i_r)
    np.testing.assert_allclose(g, g_r, rtol=1e-6)
    assert not np.isin(i // 32, [2, 3]).any()    # a copy never wins


def test_split_scan_all_illegal_node():
    h = _rand_hist(np.random.default_rng(4), nodes=3)
    (g, i), (g_r, i_r) = _scan_both(h, min_data=1e9)
    assert np.isneginf(g).all() and (i == 0).all()
    np.testing.assert_array_equal(i, i_r)
    np.testing.assert_array_equal(g, g_r)


@pytest.mark.parametrize("min_data", [1.0, 15.0])
def test_split_scan_feature_mask_and_min_data(min_data):
    h = _rand_hist(np.random.default_rng(5), nodes=4, m=6)
    mask = np.array([1, 0, 1, 0, 0, 1], np.float32)
    (g, i), (g_r, i_r) = _scan_both(h, min_data=min_data, mask=mask)
    np.testing.assert_array_equal(i, i_r)
    np.testing.assert_allclose(g, g_r, rtol=1e-5)
    legal = np.isfinite(g)
    assert mask[(i[legal] // 32)].all()


def test_histogram_splits_level_matches_interpret_kernels():
    """The port's fused level step against the reference's Pallas path
    (``interpret=True``) over four levels with sibling subtraction: the
    same (feature, threshold), gains within rtol 1e-5, and histograms within
    the subtraction drift bound of 1e-3 of a direct build."""
    n, m, B, depth = 520, 6, 16, 4
    codes, stats = _problem(8, n=n, m=m, B=B)
    codes_t = torch.from_numpy(codes.T.copy())
    prev_r = prev = None
    for lvl, (state, node_pos) in enumerate(_levels(codes, stats, depth, B)):
        sub = lvl > 0
        g_r, i_r, prev_r = JO.histogram_splits_level(
            jnp.asarray(codes), jnp.asarray(stats), state.order, state.counts,
            prev_r, jnp.float32(1.0), jnp.float32(1.0), n_nodes=2 ** lvl,
            n_bins=B, subtract=sub, row_tile=64, interpret=True)
        g, i, prev = TO.histogram_splits_level(
            codes_t, torch.from_numpy(stats),
            torch.from_numpy(np.array(state.order)),
            torch.from_numpy(np.array(state.counts)), prev, 1.0, 1.0,
            n_bins=B, subtract=sub)
        np.testing.assert_array_equal(i.numpy() // B, np.asarray(i_r) // B)
        np.testing.assert_array_equal(i.numpy() % B, np.asarray(i_r) % B)
        np.testing.assert_allclose(g.numpy(), np.asarray(g_r), rtol=1e-5)
        direct = JH.build_histograms_jnp(jnp.asarray(codes), node_pos,
                                         jnp.asarray(stats),
                                         n_nodes=2 ** lvl, n_bins=B)
        assert np.abs(prev.numpy() - np.asarray(direct)).max() <= 1e-3


def test_grow_tree_matches_reference_tree():
    """One tree end to end (plain versions): identical splits on
    continuous features, leaf values and covers close."""
    n, m, B, d = 700, 5, 32, 3
    rng = np.random.default_rng(9)
    codes = rng.integers(0, B, (n, m)).astype(np.uint8)
    G = rng.normal(size=(n, d)).astype(np.float32)
    Hd = rng.random((n, d)).astype(np.float32)
    stats = np.concatenate([G, np.ones((n, 1), np.float32)], 1)
    tr, pos_r = JT.grow_tree(jnp.asarray(codes), jnp.asarray(stats),
                             jnp.asarray(G), jnp.asarray(Hd), depth=4,
                             n_bins=B, lam=1.0, min_data_in_leaf=5.0,
                             use_kernel="jnp")
    t, pos = TT.grow_tree(torch.from_numpy(codes),
                          torch.from_numpy(codes.T.copy()),
                          torch.from_numpy(stats), torch.from_numpy(G),
                          torch.from_numpy(Hd), depth=4, n_bins=B, lam=1.0,
                          min_data_in_leaf=5.0)
    np.testing.assert_array_equal(t.feat.numpy(), np.asarray(tr.feat))
    np.testing.assert_array_equal(t.thr.numpy(), np.asarray(tr.thr))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(pos_r))
    np.testing.assert_allclose(t.gain.numpy(), np.asarray(tr.gain),
                               rtol=1e-5)
    np.testing.assert_allclose(t.value.numpy(), np.asarray(tr.value),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(t.cover.numpy(), np.asarray(tr.cover))
