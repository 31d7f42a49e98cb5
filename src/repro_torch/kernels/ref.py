"""Plain PyTorch versions of the three CUDA kernels.

Each function computes what its kernel computes, with the same inputs, in
plain tensor operations: the CPU path of the wrappers and the yardstick the
kernels are held to on the card.  Counterparts in the JAX package's
``kernels/ref.py``: `hist_nodes_ref` is ``histogram_tiles_ref`` followed by
the tile->node ``segment_sum`` of ``ops.histogram_splits_level``;
`split_scan_ref` is ``split_scan_ref``; `node_walk_ref` and
`forest_apply_ref` are their namesakes.
"""
from __future__ import annotations

import torch

from repro_torch.core import split as S


def histogram_tiles_ref(codes_g: torch.Tensor, stats_g: torch.Tensor, *,
                        n_bins: int, row_tile: int = 256) -> torch.Tensor:
    """(m, S) codes + (S, C) stats -> (m, S // row_tile, n_bins, C) per-tile
    histograms, each summed in row order."""
    m, s = codes_g.shape
    c = stats_g.shape[1]
    n_tiles = s // row_tile
    tile = torch.arange(s, device=codes_g.device) // row_tile
    out = torch.zeros((m, n_tiles * n_bins, c), dtype=torch.float32,
                      device=stats_g.device)
    for f in range(m):
        out[f].index_add_(0, tile * n_bins + codes_g[f].long(), stats_g)
    return out.reshape(m, n_tiles, n_bins, c)


def hist_nodes_ref(codes_t: torch.Tensor, order: torch.Tensor,
                   stats_p: torch.Tensor, counts: torch.Tensor,
                   build_counts: torch.Tensor, *, n_bins: int,
                   row_tile: int = 256) -> torch.Tensor:
    """Plain B1: per-node histograms of node-contiguous rows.

    Node ``v`` contributes the first ``build_counts[v]`` rows of its
    segment of the partition (``order``, segment sizes ``counts``); the rows
    are laid into node-contiguous ``row_tile`` tiles (`ops.tile_plan`),
    histogrammed per tile, and the tiles summed into their node in tile
    order.  ``stats_p`` is (n, C) in partition order.  Returns
    ``(n_nodes, m, n_bins, C)``.
    """
    from repro_torch.kernels.ops import tile_plan
    n = order.shape[0]
    m = codes_t.shape[0]
    n_nodes = counts.shape[0]
    c = stats_p.shape[1]
    per_node = torch.clamp((build_counts + row_tile - 1) // row_tile, min=1)
    n_tiles = int(per_node.sum())
    tile_node, src, valid = tile_plan(counts, build_counts, n=n,
                                      n_tiles=n_tiles, row_tile=row_tile)
    codes_g = codes_t[:, order.long()[src.long()]]
    stats_g = stats_p[src.long()] * valid[:, None]
    tiles = histogram_tiles_ref(codes_g, stats_g, n_bins=n_bins,
                                row_tile=row_tile)
    out = torch.zeros((n_nodes, m, n_bins, c), dtype=torch.float32,
                      device=stats_p.device)
    out.index_add_(0, tile_node.long(), tiles.transpose(0, 1))
    return out


def split_scan_ref(hist: torch.Tensor, lam: float, min_data: float,
                   mask: torch.Tensor):
    """Plain B2: (nodes, m, B, C) histograms -> per-node ``(best_gain,
    best_idx)``, idx = feature * B + bin, ``(-inf, 0)`` with no legal
    split.  ``mask`` (m,) float32; 0 disables a feature."""
    return S.flat_argmax(S.split_scores(hist, lam, min_data, mask))


def node_walk_ref(feat: torch.Tensor, thr: torch.Tensor, left: torch.Tensor,
                  right: torch.Tensor, codes: torch.Tensor, *,
                  depth: int) -> torch.Tensor:
    """Pointer walk of ONE tree for ``depth`` steps: (n,) terminal node ids.
    Terminal nodes self-loop, so extra steps are exact no-ops."""
    n = codes.shape[0]
    pos = torch.zeros(n, dtype=torch.long, device=codes.device)
    for _ in range(depth):
        code = codes.gather(1, feat.long()[pos][:, None])[:, 0].long()
        pos = torch.where(code > thr.long()[pos], right.long()[pos],
                          left.long()[pos])
    return pos


def forest_apply_ref(F: torch.Tensor, codes: torch.Tensor,
                     feat: torch.Tensor, thr: torch.Tensor,
                     left: torch.Tensor, right: torch.Tensor,
                     leaf: torch.Tensor, out_col: torch.Tensor, lr: float,
                     *, depth: int) -> torch.Tensor:
    """Plain B3: ``F[:, col:col+w] += lr * leaf[t, pos]`` tree by tree in
    index order, updating ``F`` (n, d) float32 in place and returning it.
    ``lr * leaf`` is rounded before the add, as in the reference."""
    w = leaf.shape[2]
    lr_t = torch.tensor(lr, dtype=torch.float32, device=F.device)
    for t, col in enumerate(out_col.tolist()):
        pos = node_walk_ref(feat[t], thr[t], left[t], right[t], codes,
                            depth=depth)
        F[:, col:col + w] += lr_t * leaf[t][pos]
    return F
