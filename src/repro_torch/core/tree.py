"""Level-wise multivariate trees in heap layout (the JAX package's
``core/tree.py``, level-wise growth with each histogram engine).

A tree of depth D is a perfect heap: internal nodes ``0 .. 2^D - 2`` (level
``l`` at ``[2^l - 1, 2^(l+1) - 1)``) and leaves ``0 .. 2^D - 1``.  Rows that
reach a no-split node go left.  The split search reads the sketched
statistics ``[G_k | 1]``; leaf values use the full gradients (eq. (3)):
``v_j = - sum_i g_i / (sum_i h_i + lambda)``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

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


def stack_trees(trees) -> Forest:
    return Forest(*(torch.stack(fields) for fields in zip(*trees)))


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
              hist_engine: str = "auto"):
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
    prev_hist = None
    for lvl in range(depth):
        if engine == "direct":
            best_gain, best_idx = ops.histogram_splits(
                codes_t, node_pos, stats, lam, min_data_in_leaf,
                feature_mask, n_nodes=2 ** lvl, n_bins=n_bins)
        else:
            subtract = engine == "subtract" and lvl > 0
            best_gain, best_idx, hist = ops.histogram_splits_level(
                codes_t, stats, state.order, state.counts, prev_hist, lam,
                min_data_in_leaf, feature_mask, n_bins=n_bins,
                subtract=subtract)
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
