"""Histogram engines: row partition, sibling subtraction, sums.

Port of the JAX package's ``core/histogram.py``.  Three engines
(`HIST_ENGINES`): ``"direct"`` rebuilds every node's histogram from the
rows in dataset order each level (`repro_torch.kernels.ops.histogram`, the
B4 kernel on the card), the exact reference the others are pinned to; ``"partition"`` and
``"subtract"`` read rows partitioned by node.  For those the grower
carries a stable permutation of rows sorted by node (`LevelState`),
advanced one level at a time by an O(n) stable 1-bit radix step, so rows
of each node are contiguous and in dataset order: summation order, and
with it the float32 histogram bits, is the same run to run.  With
``"subtract"`` only the smaller child of each parent is built; its sibling
is ``parent - built``.

The partitioned level step (the reference's ``build_level_jnp``) is
the fused `repro_torch.kernels.ops.histogram_splits_level`: the B1 kernel
on the card, its plain version on the CPU.

The leaf-wise grower carries a `NodePartition` instead: the same stable
row order, split one node's segment at a time (`split_partition_at`); its
one-node builds are `repro_torch.kernels.ops.node_histogram`.

The one-vs-all growers (``strategy="one_vs_all"``) hold a group of trees in
one partition of ``trees * n`` entries: tree ``t``'s entries fill the block
``[t * n, (t + 1) * n)``, each entry names a row of the data, and node ids
run tree-major.  Their leaf pass is `segment_sums` over the last
partition.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

HIST_ENGINES = ("direct", "partition", "subtract")


def resolve_hist_engine(engine) -> str:
    """Normalise an engine request into one of `HIST_ENGINES`: ``"auto"``
    (or None) is ``"subtract"``: partitioned histograms with sibling
    subtraction."""
    if engine in (None, "auto"):
        return "subtract"
    if engine not in HIST_ENGINES:
        raise ValueError(f"unknown hist engine {engine!r}; "
                         f"expected 'auto' or one of {HIST_ENGINES}")
    return engine


class LevelState(NamedTuple):
    """Loop-carried row partition for one tree level.

    ``order`` is a permutation of ``[0, n)`` such that ``node_perm[i]`` (the
    node of row ``order[i]``) is non-decreasing; ``counts`` holds the rows
    of each node.  All three are int32.
    """
    order: torch.Tensor      # (n,) row permutation, sorted by node
    node_perm: torch.Tensor  # (n,) node of order[i]
    counts: torch.Tensor     # (n_nodes,) rows per node


def init_level_state(n: int, device=None, trees: int = 1) -> LevelState:
    """Level-0 partition: every row in the root node, identity order.  With
    ``trees > 1`` it holds ``trees`` roots over ``trees * n`` entries: tree
    ``t``'s root is node ``t`` and its entries are ``[t * n, (t + 1) * n)``,
    each naming row ``entry - t * n``.  `advance_level_state` keeps every
    tree's entries in its block (node ``t * 2^l + v`` at level ``l``)."""
    return LevelState(
        order=torch.arange(n, dtype=torch.int32, device=device).repeat(trees),
        node_perm=torch.arange(trees, dtype=torch.int32,
                               device=device).repeat_interleave(n),
        counts=torch.full((trees,), n, dtype=torch.int32, device=device))


def advance_level_state(state: LevelState, go_right: torch.Tensor, *,
                        permuted: bool = False) -> LevelState:
    """Advance the partition one level: parent ``p`` -> children ``2p, 2p+1``.

    ``go_right`` is the per-row routing bit in ORIGINAL row order, or with
    ``permuted`` the bit of each entry in partition order (what a
    partition of several trees needs: the bit of a row depends on its
    tree).  Within each parent segment, left-routed rows keep their
    relative order and land in child ``2p``, right-routed rows in ``2p+1``
    (stable).  Integer arithmetic only, so the result is exact on every
    device.
    """
    n = state.order.shape[0]
    device = state.order.device
    # Positions fit in int32 below 2^31 entries (B1's limit): half the
    # bytes of every pass over the partition.
    it = torch.int32 if n < 2 ** 31 else torch.int64
    parent = state.node_perm.to(it)
    counts = state.counts.to(it)
    bit = (go_right if permuted else go_right[state.order.long()]).bool()
    starts = torch.cumsum(counts, 0, dtype=it) - counts
    # lefts[i]: left-routed entries before position i.  Entries are sorted
    # by parent, so each parent's left count is a difference of two.
    lefts = torch.zeros(n + 1, dtype=it, device=device)
    torch.cumsum(~bit, 0, dtype=it, out=lefts[1:])
    left_counts = lefts[(starts + counts).long()] - lefts[starts.long()]
    counts_new = torch.stack([left_counts, counts - left_counts],
                             1).reshape(-1)
    starts_new = torch.cumsum(counts_new, 0, dtype=it) - counts_new
    # Per parent p: a left entry at position i lands at base_l[p] +
    # lefts[i], a right one at base_r[p] + i - lefts[i].
    base_l = starts_new[0::2] - lefts[starts.long()]
    base_r = starts_new[1::2] - starts + lefts[starts.long()]
    lf = lefts[:-1]
    dest = torch.where(bit, base_r.index_select(0, parent)
                       + (torch.arange(n, dtype=it, device=device) - lf),
                       base_l.index_select(0, parent) + lf)   # a permutation
    del lefts, lf
    order_new = torch.empty_like(state.order)
    node_new = torch.empty_like(state.node_perm)
    order_new[dest] = state.order
    node_new[dest] = (2 * parent + bit).to(torch.int32)
    return LevelState(order=order_new, node_perm=node_new,
                      counts=counts_new.to(torch.int32))


class NodePartition(NamedTuple):
    """Row partition over the leaf-wise grower's node ids.

    ``order`` is a permutation of ``[0, n)`` whose positions ``[starts[j],
    starts[j] + counts[j])`` hold the rows of node ``j`` in dataset order;
    ``node_perm[i]`` is the node of ``order[i]``.  A split leaves its
    children where the parent's segment was, so segments are not sorted
    by node id.  ``order`` and ``node_perm`` (n,) int32 lie on the data's
    device; ``starts`` and ``counts`` (n_slots,) int32 are host (CPU)
    tensors, which the grower reads to cut segments without a device read.
    """
    order: torch.Tensor
    node_perm: torch.Tensor
    starts: torch.Tensor
    counts: torch.Tensor


def init_node_partition(n: int, n_slots: int, device=None) -> NodePartition:
    """Every row in root node 0, identity order; the other slots empty."""
    counts = torch.zeros(n_slots, dtype=torch.int32)
    counts[0] = n
    return NodePartition(
        order=torch.arange(n, dtype=torch.int32, device=device),
        node_perm=torch.zeros(n, dtype=torch.int32, device=device),
        starts=torch.zeros(n_slots, dtype=torch.int32), counts=counts)


def split_partition_at(part: NodePartition, p: int, c1: int, c2: int,
                       go_right: torch.Tensor) -> NodePartition:
    """Split node ``p``'s segment stably into children ``c1`` (its
    left-routed rows, first) and ``c2``, each keeping dataset order.

    ``go_right`` (n,) is the routing bit in ORIGINAL row order.  Only the
    segment is touched (the reference scans all n rows under a mask to keep
    its shapes fixed; the result is the same).  One host read: the left
    count.  Returns a new partition; ``part`` is unchanged.
    """
    s0, cnt = int(part.starts[p]), int(part.counts[p])
    seg = part.order[s0:s0 + cnt]
    bit = go_right[seg.long()].to(torch.uint8)
    n_left = cnt - int(bit.sum())
    order = part.order.clone()
    order[s0:s0 + cnt] = seg[torch.argsort(bit, stable=True)]
    node_perm = part.node_perm.clone()
    node_perm[s0:s0 + n_left] = c1
    node_perm[s0 + n_left:s0 + cnt] = c2
    counts, starts = part.counts.clone(), part.starts.clone()
    counts[c1], counts[c2], counts[p] = n_left, cnt - n_left, 0
    starts[c1], starts[c2] = s0, s0 + n_left
    return NodePartition(order=order, node_perm=node_perm, starts=starts,
                         counts=counts)


def gather_node_rows(part: NodePartition, node: int) -> torch.Tensor:
    """The dataset rows of ``node``, in partition order: exactly its
    ``counts[node]`` rows (a view of ``order``)."""
    s0 = int(part.starts[node])
    return part.order[s0:s0 + int(part.counts[node])]


def smaller_children(counts: torch.Tensor):
    """``(side, is_built)``: ``side[p]`` is parent p's smaller child (ties ->
    left); ``is_built[c]`` marks the children built directly."""
    n_nodes = counts.shape[0]
    side = (counts[0::2] > counts[1::2]).to(torch.int32)
    child = torch.arange(n_nodes, device=counts.device)
    is_built = (child % 2) == side[child // 2]
    return side, is_built


def interleave_children(side: torch.Tensor, built: torch.Tensor,
                        sib: torch.Tensor) -> torch.Tensor:
    """(P, ...) built/derived sibling pairs -> (2P, ...) child-ordered:
    child ``2p`` is the built histogram iff ``side[p] == 0``."""
    P = built.shape[0]
    s = side.reshape((P,) + (1,) * (built.ndim - 1))
    left = torch.where(s == 0, built, sib)
    right = torch.where(s == 0, sib, built)
    return torch.stack([left, right], 1).reshape((2 * P,) + built.shape[1:])


def leaf_sums(leaf_pos: torch.Tensor, G: torch.Tensor, H: torch.Tensor, *,
              n_leaves: int, weights: Optional[torch.Tensor] = None):
    """Per-leaf full-gradient sums for the leaf-value pass (eq. (3)).

    Rows are grouped by a stable sort of ``leaf_pos`` and each leaf's rows
    summed with one reduction, so the result is the same run to run on
    every device (a scatter-add on CUDA would not be).  With ``weights``
    (n,) (SGB/GOSS) the sums are of ``G * w`` and ``H * w``, each product
    rounded once as the reference's, and a leaf's cover is the sum of its
    rows' weights.  Returns ``(G_sum, H_sum, cover)``: (n_leaves, d),
    (n_leaves, d), (n_leaves,) float32 (row counts without weights).
    """
    d = G.shape[1]
    perm = torch.sort(leaf_pos.long(), stable=True).indices
    counts = torch.bincount(leaf_pos.long(), minlength=n_leaves)
    gs = torch.zeros((n_leaves, d), dtype=torch.float32, device=G.device)
    hs = torch.zeros_like(gs)
    cover = (counts.to(torch.float32) if weights is None else
             torch.zeros(n_leaves, dtype=torch.float32, device=G.device))
    start = 0
    for j, cnt in enumerate(counts.tolist()):
        if cnt:
            # One gathered (rows, d) block alive at a time: a leaf can hold
            # most of the rows.
            rows = perm[start:start + cnt]
            w = (None if weights is None
                 else weights.index_select(0, rows)[:, None])
            for src, out in ((G, gs), (H, hs)):
                block = src.index_select(0, rows)
                if w is not None:
                    block.mul_(w)
                out[j] = block.sum(0)
                del block
            if w is not None:
                cover[j] = w.sum()
        start += cnt
    return gs, hs, cover


# Rows a chunk of `segment_sums`.
SUM_CHUNK = 256


def segment_sums(values: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Sums of consecutive segments: ``values`` (S, c) float32, segment
    ``s`` the next ``lengths[s]`` rows (``sum(lengths) == S``; empty
    segments sum to 0).  Returns (n_segments, c).

    Each segment is cut into chunks of `SUM_CHUNK` rows from its start;
    each chunk is summed in row order from 0.0, then the chunks' sums in
    chunk order from 0.0 (``torch.segment_reduce``, which adds a segment's
    rows one after another on every device).  So a segment's sum depends
    on its rows alone, not on where it lies or on the other segments, and
    is the same run to run.  No host read.
    """
    K = SUM_CHUNK
    S, n_seg = values.shape[0], lengths.shape[0]
    device = values.device
    lengths = lengths.long()
    per = (lengths + K - 1) // K                          # chunks a segment
    ends = torch.cumsum(per, 0)
    slots = S // K + n_seg                                # >= every chunk
    slot = torch.arange(slots, device=device)
    seg = torch.searchsorted(ends, slot, right=True)
    seg_c = torch.clamp(seg, max=max(n_seg - 1, 0))
    k = slot - (ends - per)[seg_c]
    chunk_len = torch.where(seg < n_seg,
                            torch.clamp(lengths[seg_c] - k * K, 0, K), 0)
    chunks = torch.segment_reduce(values, "sum", lengths=chunk_len, axis=0,
                                  unsafe=True)
    # The slots past the last chunk go to one extra segment, dropped.
    per_all = torch.cat([per, (slots - ends[-1:]) if n_seg else
                         torch.full((1,), slots, device=device)])
    return torch.segment_reduce(chunks, "sum", lengths=per_all, axis=0,
                                unsafe=True)[:n_seg]
