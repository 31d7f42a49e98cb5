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
"""
from __future__ import annotations

from typing import NamedTuple

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


def _excl_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0) - x


def init_level_state(n: int, device=None) -> LevelState:
    """Level-0 partition: every row in the root node, identity order."""
    return LevelState(
        order=torch.arange(n, dtype=torch.int32, device=device),
        node_perm=torch.zeros(n, dtype=torch.int32, device=device),
        counts=torch.full((1,), n, dtype=torch.int32, device=device))


def advance_level_state(state: LevelState,
                        go_right: torch.Tensor) -> LevelState:
    """Advance the partition one level: parent ``p`` -> children ``2p, 2p+1``.

    ``go_right`` is the per-row routing bit in ORIGINAL row order.  Within
    each parent segment, left-routed rows keep their relative order and land
    in child ``2p``, right-routed rows in ``2p+1`` (stable).  Integer
    arithmetic only, so the result is exact on every device.
    """
    n = state.order.shape[0]
    device = state.order.device
    order = state.order.long()
    parent = state.node_perm.long()
    counts = state.counts.long()
    bit = go_right.long()[order]                              # permuted order
    starts = _excl_cumsum(counts)
    pre_left = _excl_cumsum(1 - bit)                          # lefts before i
    # Rows are sorted by parent, so each parent's left count is a
    # difference of one prefix sum (no scatter-add).
    lefts = torch.cat([pre_left, pre_left[-1:] + 1 - bit[-1:]])
    left_counts = lefts[starts + counts] - lefts[starts]
    counts_new = torch.stack([left_counts, counts - left_counts],
                             1).reshape(-1)
    starts_new = _excl_cumsum(counts_new)
    seg_start = starts[parent]
    lefts_in_seg = pre_left - pre_left[seg_start]
    offset_in_seg = torch.arange(n, device=device) - seg_start
    rank = torch.where(bit == 0, lefts_in_seg, offset_in_seg - lefts_in_seg)
    child = 2 * parent + bit
    dest = starts_new[child] + rank                           # a permutation
    order_new = torch.empty_like(state.order)
    node_new = torch.empty_like(state.node_perm)
    order_new[dest] = state.order
    node_new[dest] = child.to(torch.int32)
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
              n_leaves: int):
    """Per-leaf full-gradient sums for the leaf-value pass (eq. (3)).

    Rows are grouped by a stable sort of ``leaf_pos`` and each leaf's rows
    summed with one reduction, so the result is the same run to run on
    every device (a scatter-add on CUDA would not be).  Returns
    ``(G_sum, H_sum, counts)``: (n_leaves, d), (n_leaves, d), (n_leaves,).
    """
    d = G.shape[1]
    perm = torch.sort(leaf_pos.long(), stable=True).indices
    counts = torch.bincount(leaf_pos.long(), minlength=n_leaves)
    gs = torch.zeros((n_leaves, d), dtype=torch.float32, device=G.device)
    hs = torch.zeros_like(gs)
    start = 0
    for j, cnt in enumerate(counts.tolist()):
        if cnt:
            rows = perm[start:start + cnt]
            gs[j] = G.index_select(0, rows).sum(0)
            hs[j] = H.index_select(0, rows).sum(0)
        start += cnt
    return gs, hs, counts
