"""The grower's level steps: histograms -> (sibling combine ->) splits.

Port of `histogram`, `histogram_splits`, `histogram_splits_level` and
`_tile_plan` of the JAX package's ``kernels/ops.py``, without the TPU's
layout: no 128-lane channel padding, no row or sublane padding, no
``nb_chunk`` grid, and no per-tile histograms in device memory (the
histogram kernels fold their tile sums into themselves).  Histograms stay
``(n_nodes, m, n_bins, C)`` throughout, the layout the split scan reads.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.histogram import interleave_children, smaller_children
from repro_torch.kernels import hist_kernel, split_kernel


def histogram(codes_t: torch.Tensor, node_pos: torch.Tensor,
              stats: torch.Tensor, *, n_nodes: int,
              n_bins: int) -> torch.Tensor:
    """Direct whole-level histograms (B4): ``codes_t`` (m, n) uint8,
    ``node_pos`` (n,) int32 and ``stats`` (n, C) in dataset row order ->
    ``(n_nodes, m, n_bins, C)`` float32."""
    return hist_kernel.hist_direct(
        codes_t, node_pos.to(torch.int32).contiguous(),
        stats.to(torch.float32).contiguous(), n_nodes=n_nodes, n_bins=n_bins)


def histogram_splits(codes_t: torch.Tensor, node_pos: torch.Tensor,
                     stats: torch.Tensor, lam: float, min_data: float,
                     feature_mask: Optional[torch.Tensor] = None, *,
                     n_nodes: int, n_bins: int):
    """The direct engine's level step: B4, then the split scan (B2) on its
    output as it is.  Returns per-node ``(best_gain, best_idx)``."""
    hist = histogram(codes_t, node_pos, stats, n_nodes=n_nodes,
                     n_bins=n_bins)
    return split_kernel.split_scan(hist, lam, min_data,
                                   _mask(feature_mask, codes_t.shape[0],
                                         stats.device))


def _mask(feature_mask: Optional[torch.Tensor], m: int,
          device) -> torch.Tensor:
    """(m,) float32 feature mask for the split scan; all ones if None."""
    return (torch.ones(m, dtype=torch.float32, device=device)
            if feature_mask is None else feature_mask.to(torch.float32))


def tile_plan(counts: torch.Tensor, build_counts: torch.Tensor, *, n: int,
              n_tiles: int, row_tile: int):
    """Node-contiguous tile layout: every node gets ``max(ceil(build_counts
    / row_tile), 1)`` tiles, so each tile belongs to exactly one node.

    Returns ``(tile_node, src_perm, valid)``: the node of each tile, each
    row slot's index into the partition-ordered rows, and the real-row
    mask.  ``n_tiles`` must cover every node's tiles.
    """
    n_nodes = counts.shape[0]
    counts = counts.long()
    build_counts = build_counts.long()
    starts = torch.cumsum(counts, 0) - counts
    t_c = torch.clamp((build_counts + row_tile - 1) // row_tile, min=1)
    tile_starts = torch.cumsum(t_c, 0) - t_c
    tile_node = torch.searchsorted(
        torch.cumsum(t_c, 0),
        torch.arange(n_tiles, device=counts.device), right=True)
    tile_node = torch.clamp(tile_node, max=n_nodes - 1)
    slot = torch.arange(n_tiles * row_tile, device=counts.device)
    t_of = slot // row_tile
    node_of = tile_node[t_of]
    pos_in_node = (t_of - tile_starts[node_of]) * row_tile + slot % row_tile
    valid = pos_in_node < build_counts[node_of]
    src_perm = torch.clamp(starts[node_of] + pos_in_node, max=n - 1)
    return (tile_node.to(torch.int32), src_perm.to(torch.int32), valid)


def histogram_splits_level(codes_t: torch.Tensor, stats: torch.Tensor,
                           order: torch.Tensor, counts: torch.Tensor,
                           prev_hist: Optional[torch.Tensor], lam: float,
                           min_data: float,
                           feature_mask: Optional[torch.Tensor] = None, *,
                           n_bins: int, subtract: bool):
    """One level of split search over the node-sorted row partition.

    ``codes_t`` (m, n) uint8, ``stats`` (n, C) float32 in row order,
    ``order``/``counts`` the `core.histogram.LevelState` partition.  With
    ``subtract`` only the smaller child of each parent is built (ties ->
    left) and its sibling is ``prev_hist - built``.  Returns ``(best_gain,
    best_idx, hist)``: per-node results of the split scan and this level's
    ``(n_nodes, m, n_bins, C)`` histograms, the next level's ``prev_hist``.
    """
    m = codes_t.shape[0]
    if subtract:
        side, is_built = smaller_children(counts)
        build_counts = torch.where(is_built, counts, 0).to(torch.int32)
    else:
        build_counts = counts
    stats_p = stats.to(torch.float32).index_select(0, order.long())
    hist = hist_kernel.hist_nodes(codes_t, order, stats_p.contiguous(),
                                  counts, build_counts, n_bins=n_bins)
    if subtract:
        pairs = hist.reshape((-1, 2) + hist.shape[1:])
        s = side.reshape(-1, 1, 1, 1)
        built = torch.where(s == 0, pairs[:, 0], pairs[:, 1])
        hist = interleave_children(side, built, prev_hist - built)
    gain, idx = split_kernel.split_scan(hist, lam, min_data,
                                        _mask(feature_mask, m, stats.device))
    return gain, idx, hist
