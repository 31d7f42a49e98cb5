"""B2's order of the sums on the card, replayed in numpy on the CPU.

`csrc/split.cu` scans one (node, feature) a warp.  The narrow kernel
(C <= 32) turns each channel into its left sums bin by bin in bin order in
double, each rounded to float32 (the plain version's cumsum on the CPU),
then scores every bin with right = total - left.  The wide entry point (C > 32) scans each channel by runs:
lane q sums its run of R = ceil(B / 32) consecutive bins, a Kogge-Stone
scan over the 32 lanes joins the runs, and each lane walks its run again
from the prefix before it; one warp sums a group of gradient channels
(``split_kernel.wide_groups``: a block of ``WIDE_WARPS`` warps takes chunks
of 32 channels, each warp 32 / ``WIDE_WARPS`` of every chunk): the squared
left and right sums (and the squared totals) are summed over a group's
channels in that order from 0, and the groups' sums are folded in group
order from 0.  `replay_split_scan` repeats either order in float32
(``groups=wide_groups(C)`` the wide one) and is held to the port's plain
version (`ref.split_scan_ref`) and to the JAX package's
``split_scan_ref``: the same indices, gains within rtol 1e-5, and the same
bits where every sum is exact (dyadic histograms).  The narrow order is
the plain version's, so at one gradient channel (C = 2) its gains are the
plain version's bits on any histogram, and an empty bin ties the bin
before it wherever it lies.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JR
from repro_torch.kernels import ref
from repro_torch.kernels.split_kernel import wide_groups

LANES = 32


def _hist_native(h):
    """(nodes, m, B, C) -> the reference's (m, nodes * B, C) layout."""
    nodes, m, B, c = h.shape
    return jnp.asarray(h.transpose(1, 0, 2, 3).reshape(m, nodes * B, c))


def _run_sums(h, run):
    """Per-lane sums of each run, bin by bin from 0: (..., 32, C)."""
    B, C = h.shape[-2:]
    p = np.zeros(h.shape[:-2] + (LANES, C), np.float32)
    for q in range(LANES):
        for b in range(q * run, min((q + 1) * run, B)):
            p[..., q, :] = p[..., q, :] + h[..., b, :]
    return p


def _lane_scan(p):
    """Inclusive Kogge-Stone scan over the lane axis: at step ``off`` a
    lane at or past ``off`` adds its own value to the one ``off`` lanes
    below it (received value first)."""
    off = 1
    while off < LANES:
        nxt = p.copy()
        nxt[..., off:, :] = p[..., :-off, :] + p[..., off:, :]
        p, off = nxt, off * 2
    return p


def _sq_sum(v, groups=None):
    """Sum over the last axis of squares: within each group of channels in
    its order from 0, then the groups' sums in group order from 0
    (``None``: one group of every channel in channel order)."""
    if groups is None:
        groups = [range(v.shape[-1])]
    total = np.zeros(v.shape[:-1], np.float32)
    for group in groups:
        s = np.zeros(v.shape[:-1], np.float32)
        for c in group:
            s = s + v[..., c] * v[..., c]
        total = total + s
    return total


def _run_scan(h):
    """Left sums by runs: each lane's run summed, the runs joined by the
    lane scan, each lane walking its run from the prefix before it.
    Returns ``(cs, tot)``."""
    B = h.shape[-2]
    run = -(-B // LANES)
    incl = _lane_scan(_run_sums(h, run))
    excl = np.concatenate([np.zeros_like(incl[..., :1, :]),
                           incl[..., :-1, :]], axis=-2)
    cs = np.empty_like(h)              # left sums, each lane from its prefix
    for q in range(LANES):
        left = excl[..., q, :].copy()
        for b in range(q * run, min((q + 1) * run, B)):
            left = left + h[..., b, :]
            cs[..., b, :] = left
    return cs, incl[..., LANES - 1, :]


def _cumsum(h):
    """Left sums bin by bin in double, each rounded to float32."""
    return np.cumsum(h, axis=-2, dtype=np.float64).astype(np.float32)


def replay_split_scan(h, lam, min_data, mask, groups=None, runs=None):
    """(nodes, m, B, C) float32 -> per-node (best_gain, best_idx) in the
    kernel's order: the first maximum over (feature, bin), ties to the
    lowest index, (-inf, 0) where nothing is legal.  ``groups``: the wide
    kernel's groups of gradient channels (``None``: the narrow kernel);
    ``runs``: the left sums by runs and a lane scan (the wide kernel's, the
    default with ``groups``) rather than bin by bin (the narrow
    kernel's)."""
    h = np.asarray(h, np.float32)
    nodes, m, B, C = h.shape
    lam, min_data = np.float32(lam), np.float32(min_data)
    if runs is None:
        runs = groups is not None
    if runs:
        cs, tot = _run_scan(h)
    else:
        cs = _cumsum(h)
        tot = cs[..., -1, :]
    sl = _sq_sum(cs[..., :-1], groups)                  # (nodes, m, B)
    sr = _sq_sum(tot[..., None, :-1] - cs[..., :-1], groups)
    s_parent = _sq_sum(tot[..., :-1], groups) / (tot[..., -1] + lam)
    cl = cs[..., -1]
    cr = tot[..., -1:] - cl
    g = np.float32(0.5) * (sl / (cl + lam) + sr / (cr + lam)
                           - s_parent[..., None])
    legal = ((cl >= min_data) & (cr >= min_data) & (mask[None, :, None] > 0)
             & (np.arange(B) < B - 1))
    gain = np.where(legal, g, np.float32(-np.inf))
    flat = gain.reshape(nodes, -1)
    idx = flat.argmax(1).astype(np.int32)        # first maximum
    best = flat[np.arange(nodes), idx]
    idx[np.isneginf(best)] = 0
    return best, idx


def _random_hist(rng, nodes, m, B, C):
    h = rng.normal(size=(nodes, m, B, C)).astype(np.float32)
    h[..., -1] = rng.integers(0, 9, (nodes, m, B))
    return h


def _dyadic_hist(rng, nodes, m, B, C):
    """Gradient sums in quarters of at most 1 and small integer counts:
    every sum, square and sum of squares below is exact in float32, so any
    order gives the same bits.  Features 0 and 2 are equal, and a band of
    empty bins gives equal neighbouring gains: the lowest index must win."""
    h = (rng.integers(-4, 5, (nodes, m, B, C)) / 4).astype(np.float32)
    h[..., -1] = rng.integers(0, 4, (nodes, m, B))
    h[:, 2] = h[:, 0]
    h[:, :, B // 3:B // 3 + 3] = 0.0
    return h


def _plain(h, lam, min_data, mask):
    g, i = ref.split_scan_ref(torch.from_numpy(h), lam, min_data,
                              torch.from_numpy(mask))
    return g.numpy(), i.numpy()


def _jax(h, lam, min_data, mask):
    g, i = JR.split_scan_ref(_hist_native(h), jnp.float32(lam),
                             jnp.float32(min_data), jnp.asarray(mask),
                             n_nodes=h.shape[0], n_bins=h.shape[2])
    return np.asarray(g), np.asarray(i)


# (nodes, m, B, C): the main path's level 0, a leaf-wise expansion and the
# level-5 width at few features; then the CUDA tests' bins and channels.
SHAPES = [(1, 7, 256, 6), (2, 7, 256, 6), (32, 3, 256, 6), (3, 5, 8, 2),
          (2, 4, 31, 17), (2, 3, 256, 64), (4, 6, 33, 9)]


@pytest.mark.parametrize("nodes,m,B,C", SHAPES)
def test_replay_matches_plain_and_reference(nodes, m, B, C):
    rng = np.random.default_rng(nodes * 1000 + B + C)
    h = _random_hist(rng, nodes, m, B, C)
    mask = (rng.uniform(size=m) < 0.8).astype(np.float32)
    mask[0] = 1.0
    for min_data in (1.0, 30.0):
        g, i = replay_split_scan(h, 1.0, min_data, mask)
        pg, pi = _plain(h, 1.0, min_data, mask)
        jg, ji = _jax(h, 1.0, min_data, mask)
        np.testing.assert_array_equal(i, pi)
        np.testing.assert_array_equal(i, ji)
        np.testing.assert_allclose(g, pg, rtol=1e-5, atol=0)
        np.testing.assert_allclose(g, jg, rtol=1e-5, atol=0)


@pytest.mark.parametrize("nodes,m,B,C", [(1, 4, 256, 6), (2, 4, 31, 5),
                                         (3, 3, 8, 2), (2, 4, 256, 4)])
def test_replay_bitwise_on_dyadic_ties(nodes, m, B, C):
    rng = np.random.default_rng(B * C)
    h = _dyadic_hist(rng, nodes, m, B, C)
    mask = np.ones(m, np.float32)
    g, i = replay_split_scan(h, 1.0, 1.0, mask)
    pg, pi = _plain(h, 1.0, 1.0, mask)
    jg, ji = _jax(h, 1.0, 1.0, mask)
    np.testing.assert_array_equal(i, pi)
    np.testing.assert_array_equal(i, ji)
    assert np.array_equal(g.view(np.int32), pg.view(np.int32))
    assert not np.isin(i // B, [2]).any()         # the copy never wins


def test_replay_ties_across_features_and_bins_take_lowest_index():
    """Every feature the same, and the left sums alternate so that every
    other bin's gain is the same: the winner is the lowest such bin of the
    first unmasked feature."""
    B, C, m = 40, 3, 5
    h = np.zeros((2, m, B, C), np.float32)
    h[..., 0] = 1.0
    h[..., -1] = 1.0
    h[:, :, 1::2, 0] = -1.0            # left sums 1, 0, 1, 0, ...: ties
    mask = np.array([0, 1, 1, 1, 1], np.float32)
    g, i = replay_split_scan(h, 1.0, 1.0, mask)
    pg, pi = _plain(h, 1.0, 1.0, mask)
    np.testing.assert_array_equal(i, pi)
    assert np.array_equal(g, pg)
    assert (i == 1 * B + 0).all()


@pytest.mark.parametrize("case", ["masked", "min_data"])
def test_replay_nothing_legal(case):
    rng = np.random.default_rng(7)
    h = _random_hist(rng, 3, 4, 31, 5)
    mask = np.full(4, 0.0 if case == "masked" else 1.0, np.float32)
    min_data = 1.0 if case == "masked" else 1e9
    g, i = replay_split_scan(h, 1.0, min_data, mask)
    pg, pi = _plain(h, 1.0, min_data, mask)
    assert np.isneginf(g).all() and (i == 0).all()
    np.testing.assert_array_equal(i, pi)
    np.testing.assert_array_equal(g, pg)



# The wide entry point: channel counts over 32 (C - 1 = 32, 63, 64, 128,
# 199, 512 and 1,023 gradient channels: 1 to 32 chunks of 32, the last of
# 63, 199 and 1,023 cut short).
WIDE_C = [33, 64, 65, 129, 200, 513, 1024]


@pytest.mark.parametrize("nodes", [1, 3])
@pytest.mark.parametrize("B", [31, 256])
@pytest.mark.parametrize("C", WIDE_C)
def test_wide_replay_matches_plain_and_reference(C, B, nodes):
    rng = np.random.default_rng(nodes * 10_000 + B * 7 + C)
    m = 3
    h = _random_hist(rng, nodes, m, B, C)
    mask = np.array([1, 0, 1], np.float32)              # feature 1 masked
    for min_data in (1.0, 30.0):
        g, i = replay_split_scan(h, 1.0, min_data, mask, groups=wide_groups(C))
        pg, pi = _plain(h, 1.0, min_data, mask)
        jg, ji = _jax(h, 1.0, min_data, mask)
        np.testing.assert_array_equal(i, pi)
        np.testing.assert_array_equal(i, ji)
        np.testing.assert_allclose(g, pg, rtol=1e-5, atol=0)
        np.testing.assert_allclose(g, jg, rtol=1e-5, atol=0)
        assert not (i // B == 1).any()


@pytest.mark.parametrize("nodes,B,C", [(1, 256, 65), (3, 31, 129),
                                       (3, 256, 200), (1, 256, 513),
                                       (3, 31, 1024)])
def test_wide_replay_bitwise_on_dyadic_ties(nodes, B, C):
    rng = np.random.default_rng(B * C + nodes)
    m = 4
    h = _dyadic_hist(rng, nodes, m, B, C)
    mask = np.ones(m, np.float32)
    g, i = replay_split_scan(h, 1.0, 1.0, mask, groups=wide_groups(C))
    pg, pi = _plain(h, 1.0, 1.0, mask)
    jg, ji = _jax(h, 1.0, 1.0, mask)
    np.testing.assert_array_equal(i, pi)
    np.testing.assert_array_equal(i, ji)
    assert np.array_equal(g.view(np.int32), pg.view(np.int32))
    assert np.array_equal(g.view(np.int32), jg.view(np.int32))
    assert not np.isin(i // B, [2]).any()         # the copy never wins


@pytest.mark.parametrize("C", [65, 513])
def test_wide_replay_ties_across_features_and_bins_take_lowest_index(C):
    """Every feature the same, and the left sums of one channel in the
    first group and one in a later group alternate, so that every other
    bin's gain is the same: the lowest such bin of the first unmasked
    feature wins."""
    B, m = 40, 5
    h = np.zeros((2, m, B, C), np.float32)
    for c in (0, wide_groups(C)[-1][-1]):
        h[..., c] = 1.0
        h[:, :, 1::2, c] = -1.0        # left sums 1, 0, 1, 0, ...: ties
    h[..., -1] = 1.0
    mask = np.array([0, 1, 1, 1, 1], np.float32)
    g, i = replay_split_scan(h, 1.0, 1.0, mask, groups=wide_groups(C))
    pg, pi = _plain(h, 1.0, 1.0, mask)
    np.testing.assert_array_equal(i, pi)
    assert np.array_equal(g, pg)
    assert (i == 1 * B + 0).all()


@pytest.mark.parametrize("case", ["masked", "min_data"])
def test_wide_replay_nothing_legal(case):
    rng = np.random.default_rng(8)
    h = _random_hist(rng, 3, 4, 31, 129)
    mask = np.full(4, 0.0 if case == "masked" else 1.0, np.float32)
    min_data = 1.0 if case == "masked" else 1e9
    g, i = replay_split_scan(h, 1.0, min_data, mask, groups=wide_groups(129))
    pg, pi = _plain(h, 1.0, min_data, mask)
    jg, ji = _jax(h, 1.0, min_data, mask)
    assert np.isneginf(g).all() and (i == 0).all()
    np.testing.assert_array_equal(i, pi)
    np.testing.assert_array_equal(g, pg)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_array_equal(g, jg)


def test_one_group_of_every_channel_is_the_narrow_order():
    """The narrow kernel's sums of squares are the wide kernel's with one
    group: the fold of a single group's sum from 0 changes no bit."""
    rng = np.random.default_rng(11)
    h = _random_hist(rng, 2, 3, 256, 40)
    mask = np.ones(3, np.float32)
    g, i = replay_split_scan(h, 1.0, 1.0, mask)
    g1, i1 = replay_split_scan(h, 1.0, 1.0, mask, groups=[range(39)],
                               runs=False)
    np.testing.assert_array_equal(i, i1)
    assert np.array_equal(g.view(np.int32), g1.view(np.int32))


@pytest.mark.parametrize("B", [256, 37])
def test_narrow_replay_ties_an_empty_bin_at_a_run_start(B):
    """Random (inexact) sums with empty bins at the start of lanes' runs:
    the narrow order's left sums at an empty bin are the bin before it,
    bit for bit, so the lower bin wins as in the plain version; at one
    gradient channel every gain is the plain version's bits.  The runs
    order (the wide kernel's, and the narrow kernel's first design) gives
    such a bin other bits."""
    rng = np.random.default_rng(B)
    run = -(-B // LANES)
    h = _random_hist(rng, 3, 4, B, 2)
    h[..., -1] = rng.integers(1, 9, h.shape[:-1])
    starts = np.arange(run, B - 1, run)
    h[:, :, starts] = 0.0
    mask = np.ones(4, np.float32)
    g, i = replay_split_scan(h, 1.0, 1.0, mask)
    pg, pi = _plain(h, 1.0, 1.0, mask)
    np.testing.assert_array_equal(i, pi)
    assert np.array_equal(g.view(np.int32), pg.view(np.int32))
    cs = _cumsum(h)
    assert np.array_equal(cs[:, :, starts], cs[:, :, starts - 1])
    assert torch.equal(torch.cumsum(torch.from_numpy(h), 2),
                       torch.from_numpy(cs))
    rcs, _ = _run_scan(h)
    assert not np.array_equal(rcs[:, :, starts], rcs[:, :, starts - 1])
