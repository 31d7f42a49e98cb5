"""B6's order on the card, replayed in numpy on the CPU.

`csrc/shap.cu` plans each tree once on the card (`shap_plan_kernel`: a
stable counting sort of its kept slots by feature, so that each used
feature gets its (path, slot) pairs in ascending path order), computes
every (row, tree, path)'s Shapley factors once with a path's repeated
features merged into its first slot, then for each used feature sums
``a * leaf`` down the feature's list in registers and adds ``lr * res``
into phi.  `plan_lists` and `replay_tree_shap` repeat that order in numpy
float32 (two roundings per add).

What this adds to `tests/test_torch_cuda.py::test_tree_shap_kernel_bitwise`
(which holds the built kernel bitwise to the plain version, on a card): it
runs without a card, and it shows that regrouping the plain version's sums
by feature lists keeps each (row, feature, column)'s order, so that the
replay, and with it the kernel's order, is bit for bit the port's plain
version (`ref.tree_shap_ref`) on forests and on hand-made tables with
repeated, padded and out-of-range slots, and within the explain tests'
tolerance of the JAX package's ``tree_shap_ref``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JR
from repro_torch import explain as EX
from repro_torch.core import forest as FO
from repro_torch.core.tree import heap_to_node_arrays
from repro_torch.kernels import ref

TOL = dict(atol=1e-5, rtol=1e-5)


def plan_lists(sf_t, M):
    """One tree's plan as the plan kernel builds it: ``(entries,
    segments)``; entries are ``(path, slot)`` of kept slots (a feature in
    [0, M), its first slot on its path) in (feature, path) order, segments
    ``(feature, end)`` of the used features in ascending order."""
    L, D = sf_t.shape
    kept = []
    for l in range(L):
        for s in range(D):
            f = int(sf_t[l, s])
            if 0 <= f < M and f not in sf_t[l, :s].tolist():
                kept.append((f, l, s))
    counts = np.bincount([f for f, _, _ in kept], minlength=M)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    entries = [None] * len(kept)
    cursor = starts.copy()
    for f, l, s in kept:                       # ascending (path, slot)
        entries[cursor[f]] = (l, s)
        cursor[f] += 1
    ends = np.cumsum(counts)
    segments = [(f, int(ends[f])) for f in range(M) if counts[f] > 0]
    return entries, segments


def merged_factors(codes, sf_t, lo_t, hi_t, z_t):
    """(n, L, D) factors ``(o - z) * Psi`` (the plain version's), each
    path's later slots on a feature added into its first, in slot order."""
    a = ref._path_contribs(torch.from_numpy(codes).long(),
                           torch.from_numpy(sf_t), torch.from_numpy(lo_t),
                           torch.from_numpy(hi_t),
                           torch.from_numpy(z_t)).numpy()
    out = np.zeros_like(a)
    L, D = sf_t.shape
    for l in range(L):
        row = sf_t[l].tolist()
        for s, f in enumerate(row):
            if f in row[:s]:
                continue
            v = a[:, l, s]
            for s2 in range(s + 1, D):
                if row[s2] == f:
                    v = v + a[:, l, s2]
            out[:, l, s] = v
    return out


def replay_tree_shap(codes, sf, lo, hi, z, leaf, out_col, lr, d):
    """phi (n, M, d) in the kernel's order: trees in index order; per used
    feature, ascending, ``res`` summed from 0 down its list; then ``phi +
    lr * res`` at the tree's columns."""
    n, M = codes.shape
    lr = np.float32(lr)
    phi = np.zeros((n, M, d), np.float32)
    for t in range(sf.shape[0]):
        a = merged_factors(codes, sf[t], lo[t], hi[t], z[t])
        entries, segments = plan_lists(sf[t], M)
        col, W = int(out_col[t]), leaf.shape[2]
        k = 0
        for f, end in segments:
            res = np.zeros((n, W), np.float32)
            for l, s in entries[k:end]:
                res = res + a[:, l, s][:, None] * leaf[t, l][None, :]
            k = end
            phi[:, f, col:col + W] = phi[:, f, col:col + W] + lr * res
    return phi


def _forest(rng, T, depth, W, M, zero_cover=0.2):
    """Random heap trees with covers (some leaf covers zero: z = 0 edges),
    as a CPU `PackedForest`, and its path pack."""
    h = 2 ** depth - 1
    feat, thr, left, right, leaf = heap_to_node_arrays(
        torch.from_numpy(rng.integers(0, M, (T, h)).astype(np.int32)),
        torch.from_numpy(rng.integers(0, 255, (T, h)).astype(np.int32)),
        torch.from_numpy(rng.normal(size=(T, h + 1, W)).astype(np.float32)))
    leaf_cover = rng.integers(1, 50, (T, h + 1)).astype(np.float32)
    leaf_cover[rng.uniform(size=leaf_cover.shape) < zero_cover] = 0.0
    gain = np.concatenate([rng.random((T, h)), np.zeros((T, h + 1))], 1)
    pf = FO.PackedForest(
        feat=feat, thr=thr, left=left, right=right, leaf=leaf,
        out_col=torch.zeros(T, dtype=torch.int32), base=torch.zeros(W),
        lr=torch.tensor(0.1), cover=FO._heap_cover(torch.from_numpy(
            leaf_cover)), gain=torch.from_numpy(gain.astype(np.float32)),
        node_count=torch.full((T,), 2 * h + 1, dtype=torch.int32),
        depth=depth)
    return pf, EX.build_path_pack(pf)


def _raw_tables(rng, T=5, L=8, D=4, M=7):
    """Hand-made tables: repeated features on a path, an out-of-range
    feature id, padding slots, z = 0 edges."""
    sf = rng.integers(-1, M, (T, L, D)).astype(np.int32)
    sf[0, 0] = [2, 2, 5, 2]
    sf[1, 3] = [M + 3, 1, -1, 1]
    lo = rng.integers(-1, 100, (T, L, D)).astype(np.int32)
    hi = (lo + rng.integers(1, 200, (T, L, D))).astype(np.int32)
    hi[sf == -1] = ref.SHAP_BIG_BIN
    lo[sf == -1] = -1
    z = rng.uniform(0, 1, (T, L, D)).astype(np.float32)
    z[rng.uniform(size=z.shape) < 0.2] = 0.0
    z[sf == -1] = 1.0
    return sf, lo, hi, z


def _plain(codes, sf, lo, hi, z, leaf, out_col, lr, d):
    t = torch.from_numpy
    phi = torch.zeros((codes.shape[0], codes.shape[1], d))
    return ref.tree_shap_ref(phi, t(codes), t(sf), t(lo), t(hi), t(z),
                             t(leaf), t(out_col), lr).numpy()


@pytest.mark.parametrize("case", ["wide", "narrow", "pruned", "stump",
                                  "deep"])
def test_replay_bitwise_plain_on_forests(case):
    rng = np.random.default_rng(len(case) + 40)
    n, T, depth, M, d = 29, 4, 5, 9, 11
    if case == "stump":
        n, T, depth, M, d = 13, 3, 1, 2, 3
    if case == "deep":
        n, T, depth, M, d = 7, 2, 9, 6, 3
    W = 1 if case == "narrow" else d
    pf, pack = _forest(rng, T, depth, W, M)
    if case == "pruned":
        pf = FO.compact_forest(FO.prune_forest(pf, 0.5))
        pack = EX.build_path_pack(pf)
    cols = (rng.integers(0, d, T) if case == "narrow"
            else np.zeros(T)).astype(np.int32)
    codes = rng.integers(0, 256, (n, M)).astype(np.uint8)
    args = (codes, pack.slot_feat.numpy(), pack.slot_lo.numpy(),
            pack.slot_hi.numpy(), pack.slot_z.numpy(), pack.leaf.numpy(),
            cols, 0.1, d)
    got = replay_tree_shap(*args)
    want = _plain(*args)
    assert np.array_equal(got, want), float(np.abs(got - want).max())


@pytest.mark.parametrize("W", [6, 1])
def test_replay_on_raw_tables_matches_plain_and_reference(W):
    rng = np.random.default_rng(4 + W)
    T, L, D, M, n, d = 5, 8, 4, 7, 33, 6
    sf, lo, hi, z = _raw_tables(rng, T, L, D, M)
    codes = rng.integers(0, 256, (n, M)).astype(np.uint8)
    cols = (np.zeros(T) if W == d else rng.integers(0, d, T)).astype(np.int32)
    leaf = rng.normal(size=(T, L, W)).astype(np.float32)
    leaf[:, -2:] = 0.0
    got = replay_tree_shap(codes, sf, lo, hi, z, leaf, cols, 0.3, d)
    assert np.array_equal(got, _plain(codes, sf, lo, hi, z, leaf, cols, 0.3,
                                      d))
    want = JR.tree_shap_ref(
        jnp.zeros((n, M, d), jnp.float32), jnp.asarray(codes),
        jnp.asarray(sf), jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(z),
        jnp.asarray(leaf), jnp.asarray(cols), jnp.float32(0.3), depth=D)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
