"""B2's order of the sums on the card, replayed in numpy on the CPU.

`csrc/split.cu` scans one (node, feature) a warp: lane q sums its run of
R = ceil(B / 32) consecutive bins, a Kogge-Stone scan over the 32 lanes
joins the runs, and each lane walks its run again from the prefix before
it, scoring every bin with right = total - left.  `replay_split_scan`
repeats that order in float32 and is held to the port's plain version
(`ref.split_scan_ref`, a sequential cumsum) and to the JAX package's
``split_scan_ref``: the same indices, gains within rtol 1e-5, and the same
bits where every sum is exact (dyadic histograms).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JR
from repro_torch.kernels import ref

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


def _sq_sum(v):
    """Sum over the last axis of squares, in channel order from 0."""
    s = np.zeros(v.shape[:-1], np.float32)
    for c in range(v.shape[-1]):
        s = s + v[..., c] * v[..., c]
    return s


def replay_split_scan(h, lam, min_data, mask):
    """(nodes, m, B, C) float32 -> per-node (best_gain, best_idx) in the
    kernel's order: the first maximum over (feature, bin), ties to the
    lowest index, (-inf, 0) where nothing is legal."""
    h = np.asarray(h, np.float32)
    nodes, m, B, C = h.shape
    lam, min_data = np.float32(lam), np.float32(min_data)
    run = -(-B // LANES)
    incl = _lane_scan(_run_sums(h, run))
    tot = incl[..., LANES - 1, :]                       # (nodes, m, C)
    excl = np.concatenate([np.zeros_like(incl[..., :1, :]),
                           incl[..., :-1, :]], axis=-2)
    s_parent = _sq_sum(tot[..., :-1]) / (tot[..., -1] + lam)
    gain = np.full((nodes, m, B), -np.inf, np.float32)
    for q in range(LANES):
        cs = excl[..., q, :].copy()
        for b in range(q * run, min((q + 1) * run, B)):
            cs = cs + h[..., b, :]
            if b >= B - 1:
                break
            sl = _sq_sum(cs[..., :-1])
            sr = _sq_sum(tot[..., :-1] - cs[..., :-1])
            cl = cs[..., -1]
            cr = tot[..., -1] - cl
            g = np.float32(0.5) * (sl / (cl + lam) + sr / (cr + lam)
                                   - s_parent)
            legal = (cl >= min_data) & (cr >= min_data) & (mask[None] > 0)
            gain[..., b] = np.where(legal, g, -np.inf)
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

