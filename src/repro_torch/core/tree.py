"""Multivariate trees: level-wise growth in heap layout and leaf-wise
(best-first) growth over pointer nodes (the JAX package's
``core/tree.py``).

A level-wise tree of depth D is a perfect heap: internal nodes ``0 ..
2^D - 2`` (level ``l`` at ``[2^l - 1, 2^(l+1) - 1)``) and leaves ``0 ..
2^D - 1``.  Rows that reach a no-split node go left.  A leaf-wise tree is
a `NodeTree` of ``2 * max_leaves - 1`` node slots numbered in creation
order.  The split search reads the sketched statistics ``[G_k | 1]``; leaf
values use the full gradients (eq. (3)): ``v_j = - sum_i g_i / (sum_i h_i
+ lambda)``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import histogram as H
from repro_torch.core import split as S
from repro_torch.kernels import ops


class Tree(NamedTuple):
    feat: torch.Tensor     # (2^D - 1,) int32
    thr: torch.Tensor      # (2^D - 1,) int32, go left if code <= thr
    value: torch.Tensor    # (2^D, d) float32 leaf values
    gain: torch.Tensor     # (2^D - 1,) float32
    cover: Optional[torch.Tensor] = None   # (2^D,) train rows per leaf

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
    cover: torch.Tensor       # (N,) float32 train rows through each node
    node_count: torch.Tensor  # () int32 slots used

    @property
    def n_nodes(self) -> int:
        return self.feat.shape[-1]

    @property
    def n_trees(self) -> int:
        return self.feat.shape[0]


def stack_trees(trees):
    """Stack one round's trees into a `Forest` (heap trees) or a stacked
    `NodeTree` (leaf-wise trees)."""
    stacked = [torch.stack(fields) for fields in zip(*trees)]
    if isinstance(trees[0], NodeTree):
        return NodeTree(*stacked)
    return Forest(*stacked)


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
              hist_engine: str = "auto", hist_dtype: str = "float32"):
    """Grow one multivariate tree level by level.

    ``codes`` (n, m) and ``codes_t`` (m, n) are the same uint8 codes in
    both layouts; ``stats`` (n, k+1) the sketched gradients and the count
    channel; ``G``/``H_diag`` (n, d) the full gradients for the leaf pass.
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

    # Sample weights are all ones in this slice (no SGB/GOSS), so the
    # reference's ``G * w`` / ``H * w`` are G and H themselves.
    g_sum, h_sum, counts = H.leaf_sums(node_pos, G, H_diag,
                                       n_leaves=2 ** depth)
    value = -g_sum / (h_sum + lam)
    tree = Tree(feat=feat, thr=thr, value=value, gain=gain,
                cover=counts.to(torch.float32))
    return tree, node_pos


def grow_tree_leafwise(codes: torch.Tensor, codes_t: torch.Tensor,
                       stats: torch.Tensor, G: torch.Tensor,
                       H_diag: torch.Tensor, *, depth: int, max_leaves: int,
                       n_bins: int, lam: float,
                       min_data_in_leaf: float = 1.0, min_gain: float = 0.0,
                       feature_mask: Optional[torch.Tensor] = None,
                       hist_dtype: str = "float32"):
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
    # Sample weights are all ones in this slice: ``G * w`` is G.
    g_sum, h_sum, counts = H.leaf_sums(leaf_pos, G, H_diag, n_leaves=N)
    is_term = torch.from_numpy(left == np.arange(N)).to(device)
    value = torch.where(is_term[:, None], -g_sum / (h_sum + lam),
                        torch.zeros((), device=device))
    # Covers bottom-up: children carry larger ids, so one reverse sweep
    # makes every internal cover the sum of its children's.
    cover = counts.cpu().numpy().astype(np.float32)
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
