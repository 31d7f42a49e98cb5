"""The grower's level steps: histograms -> (sibling combine ->) splits.

Port of `histogram`, `histogram_splits`, `histogram_splits_level`,
`node_histogram` and `_tile_plan` of the JAX package's ``kernels/ops.py``,
without the TPU's
layout: no 128-lane channel padding, no row or sublane padding, no
``nb_chunk`` grid, and no per-tile histograms in device memory (the
histogram kernels fold their tile sums into themselves).  Histograms stay
``(n_nodes, m, n_bins, C)`` throughout, the layout the split scan reads.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.histogram import interleave_children, smaller_children
from repro_torch.kernels import hist_kernel, ref, split_kernel


def stats_for(stats: torch.Tensor, hist_dtype: str) -> torch.Tensor:
    """``stats`` in the storage type of ``hist_dtype``'s kernel: float32
    for B1, bfloat16 (rounded to nearest even) for B1-bf16.  The one cast:
    a grower makes it once per tree, and the builders below take its
    result as it is."""
    return stats.to(ref.stats_dtype(hist_dtype))


def _require_cast(stats: torch.Tensor, hist_dtype: str) -> None:
    dtype = ref.stats_dtype(hist_dtype)
    if stats.dtype != dtype:
        raise ValueError(f"stats must be {dtype} for hist_dtype="
                         f"{hist_dtype!r} (see stats_for), got {stats.dtype}")


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
    return split_scan(hist, lam, min_data, feature_mask)


def split_scan(hist: torch.Tensor, lam: float, min_data: float,
               feature_mask: Optional[torch.Tensor] = None):
    """The split scan (B2) of ``(nodes, m, n_bins, C)`` histograms, with
    all features legal when ``feature_mask`` is None.  Returns per-node
    ``(best_gain, best_idx)``."""
    mask = (torch.ones(hist.shape[1], dtype=torch.float32,
                       device=hist.device)
            if feature_mask is None else feature_mask.to(torch.float32))
    return split_kernel.split_scan(hist, lam, min_data, mask)


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
                           n_bins: int, subtract: bool,
                           hist_dtype: str = "float32"):
    """One level of split search over the node-sorted row partition.

    ``codes_t`` (m, n) uint8, ``stats`` (n, C) in row order and in
    ``hist_dtype``'s storage type (`stats_for`), ``order``/``counts`` the
    `core.histogram.LevelState` partition.  With ``subtract`` only the
    smaller child of each parent is built (ties -> left) and its sibling is
    ``prev_hist - built``.  Under ``hist_dtype="bfloat16"`` the statistics
    are bf16 before the partition gather (so the gather moves half the
    bytes) and the build runs B1-bf16; the histograms stay float32.  Returns ``(best_gain, best_idx, hist)``:
    per-node results of the split scan and this level's ``(n_nodes, m,
    n_bins, C)`` histograms, the next level's ``prev_hist``.
    """
    stats_p = stats.index_select(0, order.long()).contiguous()
    return histogram_splits_partitioned(
        codes_t, stats_p, order, counts, prev_hist, lam, min_data,
        feature_mask, n_bins=n_bins, subtract=subtract,
        hist_dtype=hist_dtype)


def histogram_splits_partitioned(codes_t: torch.Tensor,
                                 stats_p: torch.Tensor, order: torch.Tensor,
                                 counts: torch.Tensor,
                                 prev_hist: Optional[torch.Tensor],
                                 lam: float, min_data: float,
                                 feature_mask: Optional[torch.Tensor] = None,
                                 *, n_bins: int, subtract: bool,
                                 hist_dtype: str = "float32"):
    """`histogram_splits_level` on statistics already in partition order:
    ``stats_p`` (S, C) holds the statistics of entry ``e`` of ``order``
    (S,), contiguous and in ``hist_dtype``'s storage type.  The partition
    may hold several trees (S a multiple of n, node ids tree-major, as the
    one-vs-all growers keep it): one B1 and one B2 launch then serve every
    node of every tree, and a pair ``(2p, 2p + 1)`` is always the two
    children of one parent."""
    if subtract:
        side, is_built = smaller_children(counts)
        build_counts = torch.where(is_built, counts, 0).to(torch.int32)
    else:
        build_counts = counts
    _require_cast(stats_p, hist_dtype)
    hist = hist_kernel.hist_nodes(codes_t, order, stats_p, counts,
                                  build_counts, n_bins=n_bins,
                                  hist_dtype=hist_dtype)
    if subtract:
        pairs = hist.reshape((-1, 2) + hist.shape[1:])
        s = side.reshape(-1, 1, 1, 1)
        built = torch.where(s == 0, pairs[:, 0], pairs[:, 1])
        hist = interleave_children(side, built, prev_hist - built)
    gain, idx = split_scan(hist, lam, min_data, feature_mask)
    return gain, idx, hist


def node_histogram(codes_t: torch.Tensor, rows: torch.Tensor,
                   stats: torch.Tensor, *, n_bins: int,
                   hist_dtype: str = "float32") -> torch.Tensor:
    """One node's histogram ``(m, n_bins, C)`` float32: B1 (or B1-bf16)
    over the node's rows, the leaf-wise grower's builder.

    ``codes_t`` (m, n) uint8 and ``stats`` (n, C) in dataset row order and
    in ``hist_dtype``'s storage type (`stats_for`); ``rows`` (S,) int32 the
    node's rows in partition order, gathered exactly (no fixed buffer), so
    the one node's count is S.  The sums run in
    ``rows`` order in tiles of `ref.TILE_ROWS` rows, tiles in order: the
    level engine's sums for the same rows.  Semantics of the reference's
    ``ops.node_histogram`` and ``histogram.node_hist_jnp``.
    """
    _require_cast(stats, hist_dtype)
    m, s, c = codes_t.shape[0], rows.shape[0], stats.shape[1]
    if s == 0:
        return torch.zeros((m, n_bins, c), dtype=torch.float32,
                           device=stats.device)
    rows = rows.to(torch.int32).contiguous()
    stats_p = stats.index_select(0, rows.long()).contiguous()
    one = torch.full((1,), s, dtype=torch.int32, device=stats.device)
    return hist_kernel.hist_nodes(codes_t, rows, stats_p, one, one,
                                  n_bins=n_bins, hist_dtype=hist_dtype)[0]
