"""Histogram kernel wrappers: B1 (`csrc/hist.cu`) and B4
(`csrc/hist_direct.cu`).

B1, `hist_nodes`, replaces the JAX package's ``hist_tiles_pallas`` plus its
tile->node epilogue (the partition and subtract engines).  B4,
`hist_direct`, replaces ``histogram_pallas`` (the direct engine).  A CPU
tensor goes to the plain version (`ref.hist_nodes_ref`,
`ref.histogram_ref`); a CUDA tensor goes to the kernel, or the wrapper
raises.  ``KERNEL.launches`` and ``DIRECT_KERNEL.launches`` count the
kernels' launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quantize import MAX_BINS
from repro_torch.kernels import ref
from repro_torch.kernels._build import CudaKernel, require

KERNEL = CudaKernel(
    "hist_nodes", "hist.cu", "hist_nodes_launch",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7)
DIRECT_KERNEL = CudaKernel(
    "hist_direct", "hist_direct.cu", "hist_direct_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 6)
CHANNEL_WINDOW = 8     # channels per launch (CW in hist.cu, hist_direct.cu)


def hist_nodes(codes_t: torch.Tensor, order: torch.Tensor,
               stats_p: torch.Tensor, counts: torch.Tensor,
               build_counts: torch.Tensor, *, n_bins: int) -> torch.Tensor:
    """Per-node histograms ``(n_nodes, m, n_bins, C)`` of the first
    ``build_counts[v]`` rows of each node's segment (see
    `ref.hist_nodes_ref`): ``codes_t`` (m, n) uint8, ``order`` (n,) int32,
    ``stats_p`` (n, C) float32 in partition order, ``counts`` and
    ``build_counts`` (n_nodes,) int32."""
    if codes_t.device.type == "cpu":
        return ref.hist_nodes_ref(codes_t, order, stats_p, counts,
                                  build_counts, n_bins=n_bins)
    m, n = codes_t.shape
    n_nodes = counts.shape[0]
    c = stats_p.shape[1]
    require(codes_t, torch.uint8, (m, n), "codes_t")
    require(order, torch.int32, (n,), "order")
    require(stats_p, torch.float32, (n, c), "stats_p")
    require(counts, torch.int32, (n_nodes,), "counts")
    require(build_counts, torch.int32, (n_nodes,), "build_counts")
    if not 2 <= n_bins <= MAX_BINS:
        raise ValueError(f"n_bins must be in [2, {MAX_BINS}], got {n_bins}")
    out = torch.empty((n_nodes, m, n_bins, c), dtype=torch.float32,
                      device=codes_t.device)
    for c0 in range(0, c, CHANNEL_WINDOW):
        KERNEL.launch(codes_t.data_ptr(), order.data_ptr(),
                      stats_p.data_ptr(), counts.data_ptr(),
                      build_counts.data_ptr(), out.data_ptr(), n, m, n_nodes,
                      n_bins, c, c0, min(CHANNEL_WINDOW, c - c0))
    return out


def hist_direct(codes_t: torch.Tensor, node_pos: torch.Tensor,
                stats: torch.Tensor, *, n_nodes: int,
                n_bins: int) -> torch.Tensor:
    """Whole-level histograms ``(n_nodes, m, n_bins, C)`` of rows in dataset
    order (see `ref.histogram_ref`): ``codes_t`` (m, n) uint8, ``node_pos``
    (n,) int32 in ``[0, n_nodes)``, ``stats`` (n, C) float32."""
    if codes_t.device.type == "cpu":
        return ref.histogram_ref(codes_t, node_pos, stats, n_nodes=n_nodes,
                                 n_bins=n_bins)
    m, n = codes_t.shape
    c = stats.shape[1]
    require(codes_t, torch.uint8, (m, n), "codes_t")
    require(node_pos, torch.int32, (n,), "node_pos")
    require(stats, torch.float32, (n, c), "stats")
    if not 2 <= n_bins <= MAX_BINS:
        raise ValueError(f"n_bins must be in [2, {MAX_BINS}], got {n_bins}")
    if n_nodes < 1:
        raise ValueError(f"n_nodes must be >= 1, got {n_nodes}")
    out = torch.empty((n_nodes, m, n_bins, c), dtype=torch.float32,
                      device=codes_t.device)
    for c0 in range(0, c, CHANNEL_WINDOW):
        DIRECT_KERNEL.launch(codes_t.data_ptr(), node_pos.data_ptr(),
                             stats.data_ptr(), out.data_ptr(), n, m, n_nodes,
                             n_bins, c, c0, min(CHANNEL_WINDOW, c - c0))
    return out
