"""Multivariate trees: level-wise growth in heap layout and leaf-wise
(best-first) growth over pointer nodes (the JAX package's
``core/tree.py``).

A level-wise tree of depth D is a perfect heap: internal nodes ``0 ..
2^D - 2`` (level ``l`` at ``[2^l - 1, 2^(l+1) - 1)``) and leaves ``0 ..
2^D - 1``.  Rows that reach a no-split node go left.  A leaf-wise tree is
a `NodeTree` of ``2 * max_leaves - 1`` node slots numbered in creation
order.  The split search reads the sketched statistics ``[G_k | w]``, ``w``
the rows' sample weights (SGB/GOSS; all ones without row sampling) in the
count channel; leaf values use the full gradients (eq. (3)): ``v_j = -
sum_i w_i g_i / (sum_i w_i h_i + lambda)``, and a leaf's cover is the sum
of its rows' weights.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import histogram as H
from repro_torch.core import split as S
from repro_torch.kernels import hist_kernel, ops


class Tree(NamedTuple):
    feat: torch.Tensor     # (2^D - 1,) int32
    thr: torch.Tensor      # (2^D - 1,) int32, go left if code <= thr
    value: torch.Tensor    # (2^D, d) float32 leaf values
    gain: torch.Tensor     # (2^D - 1,) float32
    cover: Optional[torch.Tensor] = None   # (2^D,) weighted rows per leaf

    @property
    def depth(self) -> int:
        return (self.feat.shape[0] + 1).bit_length() - 1


class Forest(NamedTuple):
    """Stacked training-side ensemble: every field has a leading T axis."""
    feat: torch.Tensor
    thr: torch.Tensor
    value: torch.Tensor
    gain: Optional[torch.Tensor] = None
    cover: Optional[torch.Tensor] = None

    @property
    def n_trees(self) -> int:
        return self.feat.shape[0]

    @property
    def depth(self) -> int:
        return (self.feat.shape[1] + 1).bit_length() - 1


class NodeTree(NamedTuple):
    """A leaf-wise tree over ``N = 2 * max_leaves - 1`` node slots, or with
    a leading ``T`` axis on every field a stacked forest.

    Node ids follow creation order: root 0, and expansion ``t`` appends
    children ``node_count`` and ``node_count + 1``, so children carry larger
    ids than their parent.  Terminal nodes self-loop (``left[i] == right[i]
    == i``); slots at and beyond ``node_count`` are inert self-loop leaves.
    """
    feat: torch.Tensor        # (N,) int32 split feature
    thr: torch.Tensor         # (N,) int32, go left if code <= thr
    left: torch.Tensor        # (N,) int32 child pointers; self-loop on leaves
    right: torch.Tensor       # (N,) int32
    value: torch.Tensor       # (N, d) float32 leaf values, 0 on internal
    gain: torch.Tensor        # (N,) float32 split gains, 0 on leaves
    cover: torch.Tensor       # (N,) float32 weighted rows through each node
    node_count: torch.Tensor  # () int32 slots used

    @property
    def n_nodes(self) -> int:
        return self.feat.shape[-1]

    @property
    def n_trees(self) -> int:
        return self.feat.shape[0]


def stack_trees(trees):
    """Stack the rounds' trees into a `Forest` (heap trees) or a stacked
    `NodeTree` (leaf-wise trees).  A one-vs-all round's trees carry a
    leading per-output axis, so its stack is ``(T, d, ...)``, the layout
    `forest.pack_forest` folds."""
    stacked = [torch.stack(fields) for fields in zip(*trees)]
    if isinstance(trees[0], NodeTree):
        return NodeTree(*stacked)
    return Forest(*stacked)


def unstack_trees(stacked):
    """The rounds' trees of a stacked `Forest` or `NodeTree` (the inverse
    of `stack_trees`): a `Tree` or `NodeTree` a round."""
    cls = NodeTree if isinstance(stacked, NodeTree) else Tree
    return [cls(*[None if f is None else f[i] for f in stacked])
            for i in range(stacked.feat.shape[0])]


def route_bits(codes: torch.Tensor, node_pos: torch.Tensor,
               feat: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """Per-row routing bit at the current level: ``[code > thr]``.
    ``codes`` is (n, m) row-major."""
    p = node_pos.long()
    code = codes.gather(1, feat.long()[p][:, None])[:, 0]
    return (code.long() > thr.long()[p]).to(torch.int32)


def grow_tree(codes: torch.Tensor, codes_t: torch.Tensor,
              stats: torch.Tensor, G: torch.Tensor, H_diag: torch.Tensor, *,
              depth: int, n_bins: int, lam: float,
              min_data_in_leaf: float = 1.0, min_gain: float = 0.0,
              feature_mask: Optional[torch.Tensor] = None,
              hist_engine: str = "auto", hist_dtype: str = "float32",
              weights: Optional[torch.Tensor] = None):
    """Grow one multivariate tree level by level.

    ``codes`` (n, m) and ``codes_t`` (m, n) are the same uint8 codes in
    both layouts; ``stats`` (n, k+1) the sketched gradients and the count
    channel; ``G``/``H_diag`` (n, d) the full gradients for the leaf pass;
    ``weights`` (n,) the rows' sample weights (the count channel), None
    for all ones; ``feature_mask`` (m,) bool, None for every feature.
    ``hist_engine`` (`histogram.resolve_hist_engine`) picks each level's
    step: ``"direct"`` runs `ops.histogram_splits` on the rows in dataset
    order (B4, then B2) and keeps no partition; ``"partition"`` and
    ``"subtract"`` run `ops.histogram_splits_level` on the node-sorted
    partition (B1, then B2), ``"subtract"`` building only the smaller child
    of each parent and deriving its sibling from the previous level.
    ``hist_dtype="bfloat16"`` rounds the statistics to bf16 once and
    builds through B1-bf16 (partitioned engines); ``"direct"`` ignores it,
    as the reference's does (B4 has no bf16 variant).
    Returns ``(Tree, leaf_pos)``.
    """
    n = codes.shape[0]
    device = codes.device
    engine = H.resolve_hist_engine(hist_engine)
    heap = 2 ** depth - 1
    feat = torch.zeros(heap, dtype=torch.int32, device=device)
    thr = torch.full((heap,), n_bins - 1, dtype=torch.int32, device=device)
    gain = torch.zeros(heap, dtype=torch.float32, device=device)
    node_pos = torch.zeros(n, dtype=torch.int32, device=device)
    state = (None if engine == "direct"
             else H.init_level_state(n, device=device))
    stats_h = stats if engine == "direct" else ops.stats_for(stats,
                                                             hist_dtype)
    prev_hist = None
    for lvl in range(depth):
        if engine == "direct":
            best_gain, best_idx = ops.histogram_splits(
                codes_t, node_pos, stats, lam, min_data_in_leaf,
                feature_mask, n_nodes=2 ** lvl, n_bins=n_bins)
        else:
            subtract = engine == "subtract" and lvl > 0
            best_gain, best_idx, hist = ops.histogram_splits_level(
                codes_t, stats_h, state.order, state.counts, prev_hist, lam,
                min_data_in_leaf, feature_mask, n_bins=n_bins,
                subtract=subtract, hist_dtype=hist_dtype)
            prev_hist = hist if engine == "subtract" else None
            del hist
        sp = S.splits_from_flat(best_gain, best_idx, n_bins=n_bins,
                                min_gain=min_gain)
        off = 2 ** lvl - 1
        feat[off:2 * off + 1] = sp.feat
        thr[off:2 * off + 1] = sp.thr
        gain[off:2 * off + 1] = sp.gain
        bits = route_bits(codes, node_pos, sp.feat, sp.thr)
        node_pos = node_pos * 2 + bits
        if state is not None and lvl < depth - 1:
            state = H.advance_level_state(state, bits)

    g_sum, h_sum, cover = H.leaf_sums(node_pos, G, H_diag,
                                      n_leaves=2 ** depth, weights=weights)
    value = -g_sum / (h_sum + lam)
    tree = Tree(feat=feat, thr=thr, value=value, gain=gain, cover=cover)
    return tree, node_pos


def grow_tree_leafwise(codes: torch.Tensor, codes_t: torch.Tensor,
                       stats: torch.Tensor, G: torch.Tensor,
                       H_diag: torch.Tensor, *, depth: int, max_leaves: int,
                       n_bins: int, lam: float,
                       min_data_in_leaf: float = 1.0, min_gain: float = 0.0,
                       feature_mask: Optional[torch.Tensor] = None,
                       hist_dtype: str = "float32",
                       weights: Optional[torch.Tensor] = None):
    """Grow one multivariate tree leaf-wise (best-first).

    Each step expands the frontier leaf with the highest pending split gain
    (the first such leaf), if that gain is above ``min_gain``; children at
    ``depth`` are not expandable.  An expansion splits the leaf's row
    segment of the `histogram.NodePartition` stably, builds the smaller
    child's histogram over its rows (`ops.node_histogram`: B1, or B1-bf16
    under ``hist_dtype="bfloat16"``; ties build the left child), derives
    the sibling as ``parent - built`` from the parent's pooled histogram,
    and scores both children in one split scan (B2).  The pool holds the
    histograms of expandable frontier leaves only; an expanded leaf's entry
    is dropped.  The loop ends once the frontier is empty; the arrays are
    those of the reference's ``max_leaves - 1`` masked steps, inert slots
    included.

    The expansion loop runs on the host: per expansion one read of the
    left child's count and one of the children's scores, plus one at the
    root and one in the leaf pass.  For a set of expanded nodes the
    built/derived histograms are those of the level-wise ``"subtract"``
    engine, so with ``max_leaves = 2^depth`` and every node splitting the
    two growers give the same leaves, bit for bit.
    The partition's row counts (which child is built) are unweighted, as
    the reference's are; leaf sums and covers are weighted by ``weights``.
    Returns ``(NodeTree, leaf_pos)``, ``leaf_pos`` the (n,) int32 terminal
    node of each row.
    """
    n = codes.shape[0]
    device = codes.device
    N = 2 * max_leaves - 1
    stats_h = ops.stats_for(stats, hist_dtype)
    gate = np.float32(min_gain)

    def build(rows):
        return ops.node_histogram(codes_t, rows, stats_h, n_bins=n_bins,
                                  hist_dtype=hist_dtype)

    def score(hists):
        """Best splits of (k, m, B, C) histograms, read to the host in one
        transfer: gains (float32), features, thresholds, leaf flags."""
        g, i = ops.split_scan(hists, lam, min_data_in_leaf, feature_mask)
        sp = S.splits_from_flat(g, i, n_bins=n_bins, min_gain=min_gain)
        host = torch.stack([sp.gain.double(), sp.feat.double(),
                            sp.thr.double(), sp.is_leaf.double()]).cpu()
        host = host.numpy()
        return (host[0].astype(np.float32), host[1].astype(np.int32),
                host[2].astype(np.int32), host[3] > 0)

    part = H.init_node_partition(n, N, device=device)
    feat = np.zeros(N, np.int32)
    thr = np.full(N, n_bins - 1, np.int32)
    left = np.arange(N, dtype=np.int32)
    right = left.copy()
    gain = np.zeros(N, np.float32)
    node_depth = np.zeros(N, np.int32)
    pend_gain = np.full(N, -np.inf, np.float32)
    pend_feat = np.zeros(N, np.int32)
    pend_thr = np.zeros(N, np.int32)

    root_hist = build(part.order)
    g0, f0, t0, leaf0 = score(root_hist[None])
    if not (leaf0[0] or depth < 1 or max_leaves < 2):
        pend_gain[0] = g0[0]
    pend_feat[0], pend_thr[0] = f0[0], t0[0]
    pool = {0: root_hist}
    node_count = 1
    for _ in range(max_leaves - 1):
        p = int(np.argmax(pend_gain))
        if not pend_gain[p] > gate:          # the frontier is empty
            break
        c1, c2 = node_count, node_count + 1
        go_right = codes_t[int(pend_feat[p])] > int(pend_thr[p])
        part = H.split_partition_at(part, p, c1, c2, go_right)
        feat[p], thr[p], gain[p] = pend_feat[p], pend_thr[p], pend_gain[p]
        left[p], right[p] = c1, c2
        d_child = node_depth[p] + 1
        node_depth[c1] = node_depth[c2] = d_child
        built_left = bool(part.counts[c1] <= part.counts[c2])
        built = build(H.gather_node_rows(part, c1 if built_left else c2))
        sib = pool.pop(p) - built
        hists = (built, sib) if built_left else (sib, built)
        g, f, t, leaf = score(torch.stack(hists))
        pend_gain[p] = -np.inf
        for j, c in enumerate((c1, c2)):
            expandable = not leaf[j] and d_child < depth
            pend_gain[c] = g[j] if expandable else -np.inf
            pend_feat[c], pend_thr[c] = f[j], t[j]
            if expandable:
                pool[c] = hists[j]
        node_count += 2
    del pool

    leaf_pos = torch.empty(n, dtype=torch.int32, device=device)
    leaf_pos[part.order.long()] = part.node_perm
    g_sum, h_sum, cover_leaf = H.leaf_sums(leaf_pos, G, H_diag, n_leaves=N,
                                           weights=weights)
    is_term = torch.from_numpy(left == np.arange(N)).to(device)
    value = torch.where(is_term[:, None], -g_sum / (h_sum + lam),
                        torch.zeros((), device=device))
    # Covers bottom-up: children carry larger ids, so one reverse sweep
    # makes every internal cover the sum of its children's.
    cover = cover_leaf.cpu().numpy()
    for j in range(N - 1, -1, -1):
        if left[j] != j:
            cover[j] = cover[left[j]] + cover[right[j]]

    def dev(a):
        return torch.from_numpy(a).to(device)
    tree = NodeTree(feat=dev(feat), thr=dev(thr), left=dev(left),
                    right=dev(right), value=value, gain=dev(gain),
                    cover=dev(cover),
                    node_count=torch.tensor(node_count, dtype=torch.int32,
                                            device=device))
    return tree, leaf_pos


def heap_to_node_arrays(feat: torch.Tensor, thr: torch.Tensor,
                        value: torch.Tensor):
    """Heap tree buffers -> pointer node arrays over the global numbering
    (internal nodes keep ids ``0 .. 2^D - 2``, leaf ``j`` becomes node
    ``2^D - 1 + j``; ``left = 2i + 1``, ``right = 2i + 2``; leaves
    self-loop).  Any leading batch axes.  Returns ``(feat, thr, left, right,
    leaf)`` with a node axis of ``2^(D+1) - 1``."""
    h = feat.shape[-1]
    n_leaves = h + 1
    n_nodes = h + n_leaves
    device = feat.device
    ids = torch.arange(n_nodes, dtype=torch.int32, device=device)
    internal_left = 2 * torch.arange(h, dtype=torch.int32, device=device) + 1
    left = torch.cat([internal_left, ids[h:]])
    right = torch.cat([internal_left + 1, ids[h:]])
    batch = feat.shape[:-1]
    zeros_i = torch.zeros(batch + (n_leaves,), dtype=feat.dtype, device=device)
    feat_n = torch.cat([feat, zeros_i], -1)
    thr_n = torch.cat([thr, zeros_i.to(thr.dtype)], -1)
    leaf_n = torch.cat([torch.zeros(batch + (h,) + value.shape[-1:],
                                    dtype=value.dtype, device=device), value],
                       -2)
    left_b = left.expand(batch + (n_nodes,)).contiguous()
    right_b = right.expand(batch + (n_nodes,)).contiguous()
    return feat_n, thr_n, left_b, right_b, leaf_n


# -- one-vs-all: the d univariate trees of a round, grown together --------------

# Entries (trees x rows) a group of the one-vs-all growers holds: the d
# trees of a round go through in groups of ``OVA_GROUP_ENTRIES // n`` trees
# (at least one), each group one partition, so that one B1 and one B2 launch
# serve a level (level-wise) or a step (leaf-wise) of every tree in it.
# 2^28 entries are 128 trees at 2,097,152 rows.
OVA_GROUP_ENTRIES = 2 ** 28


def ova_groups(d: int, n: int):
    """The one-vs-all growers' groups of outputs: ``[(t0, t1), ...]``."""
    size = max(1, min(d, OVA_GROUP_ENTRIES // max(n, 1)))
    return [(t0, min(d, t0 + size)) for t0 in range(0, d, size)]


def _flat_index(major: torch.Tensor, minor: torch.Tensor, n: int,
                size: int) -> torch.Tensor:
    """``major * n + minor``: an index into a row-major tensor of ``size``
    elements, int32 when it fits (half the bytes of int64)."""
    if size < 2 ** 31:
        return major.to(torch.int32) * n + minor.to(torch.int32)
    return major.long() * n + minor.long()


def _entry_stats(g_h: torch.Tensor, idx: torch.Tensor,
                 w_h: Optional[torch.Tensor],
                 rows: torch.Tensor) -> torch.Tensor:
    """A univariate tree's split statistics ``[g w, w]`` in partition order,
    in ``g_h``'s type: ``g_h`` the (trees * n) products ``g w`` and ``idx``
    each entry's index into them; ``w_h`` the (n,) weights (None: all
    ones) and ``rows`` each entry's row."""
    stats_p = torch.empty((idx.shape[0], 2), dtype=g_h.dtype,
                          device=g_h.device)
    stats_p[:, 0] = g_h.index_select(0, idx)
    if w_h is None:
        stats_p[:, 1] = 1.0
    else:
        stats_p[:, 1] = w_h.index_select(0, rows)
    return stats_p


def _flat_weighted(X: torch.Tensor,
                   weights: Optional[torch.Tensor]) -> torch.Tensor:
    """The one-vs-all growers' flat (trees * n) ``x w`` of an (n, trees)
    tensor, tree t's in ``[t * n, (t + 1) * n)``: the reference's ``g_j *
    w`` (or ``H_t * w``), one rounding each."""
    if weights is not None:
        X = X * weights[:, None]
    return X.t().contiguous().reshape(-1)


def _route(codes_t: torch.Tensor, order: torch.Tensor, node: torch.Tensor,
           feat: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """Each entry's routing bit ``code > thr`` at its node's split: entry
    ``e`` names row ``order[e]`` and node ``node[e]``."""
    m, n = codes_t.shape
    idx = _flat_index(feat.index_select(0, node), order, n, m * n)
    code = codes_t.reshape(-1).index_select(0, idx)
    return code > thr.to(torch.uint8).index_select(0, node)


def _leaf_sums(g_flat, h_flat, idx, lengths, weights=None, rows=None):
    """Leaf sums of one-vs-all trees over their final partition, segment
    ``s`` the next ``lengths[s]`` entries (`histogram.segment_sums`):
    ``(n_segments, 2)``, the sums of g w and of h w, or with ``weights``
    ``(n_segments, 3)``, the third column the sum of w (the cover).
    ``idx`` is each entry's index into the ``(trees, n)`` products,
    ``rows`` its row."""
    cols = [g_flat.index_select(0, idx), h_flat.index_select(0, idx)]
    if weights is not None:
        cols.append(weights.index_select(0, rows))
    return H.segment_sums(torch.stack(cols, 1), lengths)


def grow_trees_levelwise(codes_t: torch.Tensor, G: torch.Tensor,
                         H_diag: torch.Tensor, *, depth: int, n_bins: int,
                         lam: float, min_data_in_leaf: float = 1.0,
                         min_gain: float = 0.0,
                         feature_mask: Optional[torch.Tensor] = None,
                         subtract: bool = True,
                         hist_dtype: str = "float32",
                         weights: Optional[torch.Tensor] = None):
    """Grow one univariate tree per column of ``G`` level by level, all in
    one partition (the ``"partition"`` engine, or ``"subtract"`` with
    ``subtract``).

    ``G``/``H_diag`` (n, trees), ``weights`` (n,) or None (all ones):
    tree t's split statistics are ``[g_t w, w]`` and its leaf pass sums
    ``g_t w``, ``h_t w`` and (the cover) ``w``.  The trees share one
    `histogram.LevelState` over ``trees * n`` entries, tree t's in the
    block ``[t * n, (t + 1) * n)``, node ``t * 2^l + v`` at level l; each
    level gathers the statistics in partition order once, runs one B1 (or
    B1-bf16) and one B2 launch over all ``trees * 2^l`` nodes, and
    advances the partition from each entry's routing bit.  A tree's
    histograms, splits and leaf sums depend only on its own entries, in
    the same order, so the trees are those of one tree at a time.
    Returns ``(Tree, leaf_pos)``: the tree's fields with a leading
    ``trees`` axis (value ``(trees, 2^D, 1)``) and ``leaf_pos`` (trees, n)
    int32, the leaf of each row in each tree.
    """
    n = codes_t.shape[1]
    trees = G.shape[1]
    device = codes_t.device
    heap = 2 ** depth - 1
    feat = torch.zeros((trees, heap), dtype=torch.int32, device=device)
    thr = torch.full((trees, heap), n_bins - 1, dtype=torch.int32,
                     device=device)
    gain = torch.zeros((trees, heap), dtype=torch.float32, device=device)
    entries = trees * n
    g_flat = _flat_weighted(G, weights)           # entry t*n + i: [i, t]
    g_h = ops.stats_for(g_flat, hist_dtype)
    w_h = None if weights is None else ops.stats_for(weights, hist_dtype)
    state = H.init_level_state(n, device=device, trees=trees)
    prev_hist = None
    for lvl in range(depth):
        idx = _flat_index(state.node_perm >> lvl, state.order, n, entries)
        stats_p = _entry_stats(g_h, idx, w_h, state.order)
        del idx
        best_gain, best_idx, hist = ops.histogram_splits_partitioned(
            codes_t, stats_p, state.order, state.counts, prev_hist, lam, min_data_in_leaf,
            feature_mask, n_bins=n_bins, subtract=subtract and lvl > 0,
            hist_dtype=hist_dtype)
        prev_hist = hist if subtract else None
        del hist, stats_p
        sp = S.splits_from_flat(best_gain, best_idx, n_bins=n_bins,
                                min_gain=min_gain)
        off = 2 ** lvl - 1
        feat[:, off:2 * off + 1] = sp.feat.reshape(trees, -1)
        thr[:, off:2 * off + 1] = sp.thr.reshape(trees, -1)
        gain[:, off:2 * off + 1] = sp.gain.reshape(trees, -1)
        bits = _route(codes_t, state.order, state.node_perm, sp.feat, sp.thr)
        state = H.advance_level_state(state, bits, permuted=True)
        del bits
    del prev_hist
    idx = _flat_index(state.node_perm >> depth, state.order, n, entries)
    sums = _leaf_sums(g_flat, _flat_weighted(H_diag, weights), idx,
                      state.counts, weights, state.order)
    value = -sums[:, 0] / (sums[:, 1] + lam)
    cover = (state.counts.to(torch.float32) if weights is None
             else sums[:, 2])
    leaf_pos = torch.empty(trees * n, dtype=torch.int32, device=device)
    leaf_pos[idx] = state.node_perm & (2 ** depth - 1)
    tree = Tree(feat=feat, thr=thr, value=value.reshape(trees, -1, 1),
                gain=gain, cover=cover.reshape(trees, -1))
    return tree, leaf_pos.reshape(trees, n)


def _upload(arrays, device) -> torch.Tensor:
    """Host integer arrays of one length -> one (k, len) int64 tensor on
    ``device``, in one copy (from pinned memory on a card, so that the
    copy does not wait for the card)."""
    host = torch.from_numpy(np.stack(arrays).astype(np.int64))
    if torch.device(device).type == "cuda":
        host = host.pin_memory()
    return host.to(device, non_blocking=True)


def _segments(starts: torch.Tensor, counts: torch.Tensor, total: int,
              entries: int):
    """Positions of the concatenated segments ``[starts[s], starts[s] +
    counts[s])`` (device tensors; ``total`` their host sum) in a
    partition of ``entries``, and the segment of each: ``(pos, seg,
    first)``, ``first[s]`` the index in ``pos`` of segment s's first
    position.  int32 below 2^31 entries."""
    it = torch.int32 if entries < 2 ** 31 else torch.int64
    device = starts.device
    seg = torch.repeat_interleave(
        torch.arange(counts.shape[0], dtype=it, device=device), counts,
        output_size=total)
    first = (torch.cumsum(counts, 0) - counts).to(it)
    pos = ((starts.to(it) - first).index_select(0, seg)
           + torch.arange(total, dtype=it, device=device))
    return pos, seg, first


def grow_trees_leafwise(codes_t: torch.Tensor, G: torch.Tensor,
                        H_diag: torch.Tensor, *, depth: int, max_leaves: int,
                        n_bins: int, lam: float,
                        min_data_in_leaf: float = 1.0, min_gain: float = 0.0,
                        feature_mask: Optional[torch.Tensor] = None,
                        hist_dtype: str = "float32",
                        weights: Optional[torch.Tensor] = None):
    """Grow one univariate tree per column of ``G`` leaf-wise, in lockstep.

    Each tree's steps are `grow_tree_leafwise`'s on statistics ``[g_t w,
    w]`` (``weights`` None: all ones; the partition's counts stay
    unweighted): the first arg-max pending leaf expands while its gain is above
    ``min_gain``, children at ``depth`` are not expandable, the smaller
    child (ties: the left) is built and its sibling derived from the
    parent's pooled histogram.  The trees go together: at each step every
    tree whose frontier is not empty expands, its segment of the shared
    partition (``trees * n`` entries, tree t's in ``[t * n, (t + 1) *
    n)``) is split stably on the card, one B1 launch builds the built
    children of all of them, one B2 launch scores the ``2 * expanding``
    children, and two host reads a step (the left counts, the scores)
    drive the next.  A tree's histograms and sums depend only on its own
    entries, in the same order, so its nodes are those of one tree at a
    time; at ``max_leaves = 2^depth`` with every node splitting, its
    leaves are `grow_trees_levelwise`'s, bit for bit.
    Returns ``(NodeTree, leaf_pos)``: fields with a leading ``trees`` axis
    (value ``(trees, N, 1)``) and ``leaf_pos`` (trees, n) int32, the node of
    each row in each tree.
    """
    n = codes_t.shape[1]
    trees = G.shape[1]
    device = codes_t.device
    N = 2 * max_leaves - 1
    gate = np.float32(min_gain)
    entries = trees * n
    g_flat = _flat_weighted(G, weights)
    g_h = ops.stats_for(g_flat, hist_dtype)
    w_h = None if weights is None else ops.stats_for(weights, hist_dtype)
    order = torch.arange(n, dtype=torch.int32, device=device).repeat(trees)

    def build(starts, counts, total):
        """The histograms of the given segments (device tensors, ``total``
        entries in all), one B1 launch."""
        pos, _, _ = _segments(starts, counts, total, entries)
        rows = order.index_select(0, pos)
        stats_p = _entry_stats(g_h, _flat_index(pos // n, rows, n, entries),
                               w_h, rows)
        cnt = counts.to(torch.int32)
        return hist_kernel.hist_nodes(codes_t, rows, stats_p, cnt, cnt,
                                      n_bins=n_bins, hist_dtype=hist_dtype)

    def score(hists):
        """Best splits of (k, m, B, C) histograms, read to the host in one
        transfer: gains (float32), features, thresholds, leaf flags."""
        g, i = ops.split_scan(hists, lam, min_data_in_leaf, feature_mask)
        sp = S.splits_from_flat(g, i, n_bins=n_bins, min_gain=min_gain)
        host = torch.stack([sp.gain.double(), sp.feat.double(),
                            sp.thr.double(), sp.is_leaf.double()]).cpu()
        host = host.numpy()
        return (host[0].astype(np.float32), host[1].astype(np.int32),
                host[2].astype(np.int32), host[3] > 0)

    starts = np.zeros((trees, N), np.int64)
    counts = np.zeros((trees, N), np.int64)
    starts[:, 0] = np.arange(trees) * n
    counts[:, 0] = n
    feat = np.zeros((trees, N), np.int32)
    thr = np.full((trees, N), n_bins - 1, np.int32)
    left = np.broadcast_to(np.arange(N, dtype=np.int32), (trees, N)).copy()
    right = left.copy()
    gain = np.zeros((trees, N), np.float32)
    node_depth = np.zeros((trees, N), np.int32)
    pend_gain = np.full((trees, N), -np.inf, np.float32)
    pend_feat = np.zeros((trees, N), np.int32)
    pend_thr = np.zeros((trees, N), np.int32)

    up = _upload([starts[:, 0], counts[:, 0]], device)
    root = build(up[0], up[1], entries)
    g0, f0, t0, leaf0 = score(root)
    pend_gain[:, 0] = np.where(leaf0, -np.inf, g0)
    pend_feat[:, 0], pend_thr[:, 0] = f0, t0
    pool = {(t, 0): root[t] for t in range(trees)}
    del root
    node_count = np.ones(trees, np.int64)
    for _ in range(max_leaves - 1):
        p = np.argmax(pend_gain, 1)
        grow = np.flatnonzero(pend_gain[np.arange(trees), p] > gate)
        if grow.size == 0:                    # every frontier is empty
            break
        p = p[grow]
        c1 = node_count[grow]
        c2 = c1 + 1
        s0, cnt = starts[grow, p], counts[grow, p]
        # Split each expanding tree's segment stably on the card: a left
        # entry keeps its rank among the lefts, a right one goes after them.
        up = _upload([s0, cnt, pend_feat[grow, p], pend_thr[grow, p]],
                     device)
        total = int(cnt.sum())
        pos, seg, first = _segments(up[0], up[1], total, entries)
        rows = order.index_select(0, pos)
        bit = _route(codes_t, rows, seg, up[2].to(torch.int32), up[3])
        lefts = torch.zeros(total + 1, dtype=pos.dtype, device=device)
        torch.cumsum(~bit, 0, dtype=pos.dtype, out=lefts[1:])
        at_first = lefts.index_select(0, first)
        n_left = lefts.index_select(0, first + up[1].to(pos.dtype)) - at_first
        # Per segment: a left entry at index i lands at s0 + lefts[i] -
        # lefts[first], a right one at s0 + n_left + (i - first) - (lefts[i]
        # - lefts[first]).
        base_l = up[0].to(pos.dtype) - at_first
        base_r = base_l + n_left - first + 2 * at_first
        lf = lefts[:-1]
        dest = torch.where(
            bit, base_r.index_select(0, seg)
            + torch.arange(total, dtype=pos.dtype, device=device) - lf,
            base_l.index_select(0, seg) + lf)
        order[dest] = rows
        del pos, seg, rows, bit, lefts, lf, dest
        n_left = n_left.cpu().numpy()
        n_right = cnt - n_left
        starts[grow, c1], counts[grow, c1] = s0, n_left
        starts[grow, c2], counts[grow, c2] = s0 + n_left, n_right
        counts[grow, p] = 0
        feat[grow, p], thr[grow, p] = pend_feat[grow, p], pend_thr[grow, p]
        gain[grow, p] = pend_gain[grow, p]
        left[grow, p], right[grow, p] = c1, c2
        d_child = node_depth[grow, p] + 1
        node_depth[grow, c1] = node_depth[grow, c2] = d_child
        built_left = n_left <= n_right
        bc = np.where(built_left, n_left, n_right)
        up = _upload([np.where(built_left, s0, s0 + n_left), bc,
                      built_left], device)
        built = build(up[0], up[1], int(bc.sum()))
        sib = torch.stack([pool.pop((int(t), int(j)))
                           for t, j in zip(grow, p)]) - built
        side = up[2].bool().reshape(-1, 1, 1, 1)
        hists = torch.stack([torch.where(side, built, sib),
                             torch.where(side, sib, built)], 1)
        del built, sib
        g, f, t, leaf = score(hists.reshape((-1,) + hists.shape[2:]))
        pend_gain[grow, p] = -np.inf
        for j, c in enumerate((c1, c2)):
            expandable = ~leaf[j::2] & (d_child < depth)
            pend_gain[grow, c] = np.where(expandable, g[j::2], -np.inf)
            pend_feat[grow, c], pend_thr[grow, c] = f[j::2], t[j::2]
            for e in np.flatnonzero(expandable):
                pool[(int(grow[e]), int(c[e]))] = hists[e, j]
        node_count[grow] += 2
    del pool

    is_term = left == np.arange(N)
    tid, slot = np.nonzero(is_term & (counts > 0))
    by_start = np.argsort(starts[tid, slot], kind="stable")
    tid, slot = tid[by_start], slot[by_start]
    up = _upload([counts[tid, slot], tid, slot, tid * N + slot], device)
    lengths = up[0]
    idx = _flat_index(torch.repeat_interleave(up[1], lengths,
                                              output_size=entries),
                      order, n, entries)
    sums = torch.zeros((trees * N, 2 if weights is None else 3),
                       dtype=torch.float32, device=device)
    sums[up[3]] = _leaf_sums(g_flat, _flat_weighted(H_diag, weights), idx,
                             lengths, weights, order)
    is_term_d = _upload([is_term.reshape(-1)], device)[0].bool()
    value = torch.where(is_term_d, -sums[:, 0] / (sums[:, 1] + lam),
                        torch.zeros((), device=device))
    leaf_pos = torch.empty(entries, dtype=torch.int32, device=device)
    leaf_pos[idx] = torch.repeat_interleave(up[2].to(torch.int32), lengths,
                                            output_size=entries)
    # Covers bottom-up, as `grow_tree_leafwise` sweeps them.
    cover = (counts.astype(np.float32) if weights is None
             else sums[:, 2].reshape(trees, N).cpu().numpy())
    rows_t = np.arange(trees)
    for j in range(N - 1, -1, -1):
        inner = left[:, j] != j
        r = rows_t[inner]
        cover[r, j] = cover[r, left[r, j]] + cover[r, right[r, j]]

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    tree = NodeTree(feat=dev(feat), thr=dev(thr), left=dev(left),
                    right=dev(right), value=value.reshape(trees, N, 1),
                    gain=dev(gain), cover=dev(cover),
                    node_count=dev(node_count.astype(np.int32)))
    return tree, leaf_pos.reshape(trees, n)


def grow_trees(codes: torch.Tensor, codes_t: torch.Tensor, G: torch.Tensor,
               H_diag: torch.Tensor, *, growth: str, hist_engine: str,
               depth: int, max_leaves: int, n_bins: int, lam: float,
               min_data_in_leaf: float = 1.0, min_gain: float = 0.0,
               feature_mask: Optional[torch.Tensor] = None,
               hist_dtype: str = "float32",
               weights: Optional[torch.Tensor] = None):
    """The univariate trees of one group of one-vs-all outputs (``G``,
    ``H_diag`` (n, trees); ``weights`` (n,) the rows' sample weights, None
    for all ones): `grow_trees_leafwise` for ``growth=
    "leafwise"``, `grow_trees_levelwise` for the partitioned engines, and
    for ``"direct"`` `grow_tree` one tree at a time (B4 bins rows in
    dataset order from one node position a row, so it takes no shared
    partition: ``trees`` B4 launches a level).  Returns ``(tree,
    leaf_pos)`` with a leading ``trees`` axis."""
    kw = dict(depth=depth, n_bins=n_bins, lam=lam,
              min_data_in_leaf=min_data_in_leaf, min_gain=min_gain,
              feature_mask=feature_mask, hist_dtype=hist_dtype,
              weights=weights)
    if growth == "leafwise":
        return grow_trees_leafwise(codes_t, G, H_diag, max_leaves=max_leaves,
                                   **kw)
    engine = H.resolve_hist_engine(hist_engine)
    if engine != "direct":
        return grow_trees_levelwise(codes_t, G, H_diag,
                                    subtract=engine == "subtract", **kw)
    w = (torch.ones((G.shape[0], 1), dtype=torch.float32, device=G.device)
         if weights is None else weights[:, None])
    gw = G if weights is None else G * w
    out = [grow_tree(codes, codes_t, torch.cat([gw[:, t:t + 1], w], 1),
                     G[:, t:t + 1], H_diag[:, t:t + 1], hist_engine="direct",
                     **kw) for t in range(G.shape[1])]
    trees, pos = zip(*out)
    return Tree(*[torch.stack(f) for f in zip(*trees)]), torch.stack(pos)
