"""B1 wrapper: per-node gradient histograms (`csrc/hist.cu`).

Replaces the JAX package's ``hist_tiles_pallas`` plus its tile->node
epilogue.  A CPU tensor goes to the plain version
(`ref.hist_nodes_ref`); a CUDA tensor goes to the kernel, or the wrapper
raises.  ``KERNEL.launches`` counts the kernel's launches.
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
CHANNEL_WINDOW = 8     # channels per launch (CW in hist.cu)


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
