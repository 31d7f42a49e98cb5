"""Histogram kernel wrappers: B1 and its bf16 variant (`csrc/hist.cu`),
and B4 (`csrc/hist_direct.cu`).

B1, `hist_nodes`, replaces the JAX package's ``hist_tiles_pallas`` plus its
tile->node epilogue (the partition and subtract engines, and the leaf-wise
grower's one-node builds); with ``hist_dtype="bfloat16"`` it takes bf16
statistics and launches B1-bf16.  B4, `hist_direct`, replaces
``histogram_pallas`` (the direct engine).  A CPU tensor goes to the plain
version (`ref.hist_nodes_ref`, `ref.histogram_ref`); a CUDA tensor goes to
the kernel, or the wrapper raises.  ``KERNEL.launches``,
``KERNEL_BF16.launches`` and ``DIRECT_KERNEL.launches`` count the kernels'
launches.
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
KERNEL_BF16 = CudaKernel(
    "hist_nodes_bf16", "hist.cu", "hist_nodes_bf16_launch",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7)
DIRECT_KERNEL = CudaKernel(
    "hist_direct", "hist_direct.cu", "hist_direct_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 6)
CHANNEL_WINDOW = 8     # channels per launch (CW in hist.cu, hist_direct.cu)


def hist_nodes(codes_t: torch.Tensor, order: torch.Tensor,
               stats_p: torch.Tensor, counts: torch.Tensor,
               build_counts: torch.Tensor, *, n_bins: int,
               hist_dtype: str = "float32") -> torch.Tensor:
    """Per-node histograms ``(n_nodes, m, n_bins, C)`` float32 of the first
    ``build_counts[v]`` rows of each node's segment (see
    `ref.hist_nodes_ref`): ``codes_t`` (m, n) uint8, ``order`` (S,) int32
    (the rows of the partition, S <= n), ``stats_p`` (S, C) in partition
    order, float32 or, with ``hist_dtype="bfloat16"``, bfloat16,
    ``counts`` and ``build_counts`` (n_nodes,) int32.  The node segments
    must lie within the S rows: S <= n is checked here, and so is
    ``sum(counts) <= S`` where ``counts`` is on the host."""
    dtype = ref.stats_dtype(hist_dtype)
    m, n = codes_t.shape
    s = order.shape[0]
    if s > n:
        raise ValueError(f"order has {s} rows, more than the {n} of codes_t")
    if counts.device.type == "cpu" and int(counts.sum()) > s:
        raise ValueError(f"counts sum to {int(counts.sum())}, past the {s} "
                         "rows of order")
    if codes_t.device.type == "cpu":
        return ref.hist_nodes_ref(codes_t, order, stats_p, counts,
                                  build_counts, n_bins=n_bins,
                                  hist_dtype=hist_dtype)
    n_nodes = counts.shape[0]
    c = stats_p.shape[1]
    kernel = KERNEL_BF16 if hist_dtype == "bfloat16" else KERNEL
    require(codes_t, torch.uint8, (m, n), "codes_t")
    require(order, torch.int32, (s,), "order")
    require(stats_p, dtype, (s, c), "stats_p")
    require(counts, torch.int32, (n_nodes,), "counts")
    require(build_counts, torch.int32, (n_nodes,), "build_counts")
    if not 2 <= n_bins <= MAX_BINS:
        raise ValueError(f"n_bins must be in [2, {MAX_BINS}], got {n_bins}")
    out = torch.empty((n_nodes, m, n_bins, c), dtype=torch.float32,
                      device=codes_t.device)
    for c0 in range(0, c, CHANNEL_WINDOW):
        kernel.launch(codes_t.data_ptr(), order.data_ptr(),
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
