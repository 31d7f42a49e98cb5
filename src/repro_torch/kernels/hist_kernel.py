"""Histogram kernel wrappers: B1 and its bf16 variant (`csrc/hist.cu`),
and B4 (`csrc/hist_direct.cu`), both built on `csrc/hist_common.cuh`.

B1, `hist_nodes`, replaces the JAX package's ``hist_tiles_pallas`` plus its
tile->node epilogue (the partition and subtract engines, and the leaf-wise
grower's one-node builds); with ``hist_dtype="bfloat16"`` it takes bf16
statistics and launches B1-bf16.  B4, `hist_direct`, replaces
``histogram_pallas`` (the direct engine).  Both sum in tiles of
`ref.TILE_ROWS` rows, each tile in row order and the tiles in order, and
take every channel in one launch.  A CPU tensor goes to the plain version
(`ref.hist_nodes_ref`, `ref.histogram_ref`); a CUDA tensor goes to the
kernel, or the wrapper raises.  ``KERNEL.launches``,
``KERNEL_BF16.launches`` and ``DIRECT_KERNEL.launches`` count the kernels'
launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quantize import MAX_BINS
from repro_torch.kernels import ref
from repro_torch.kernels._build import CudaKernel, require

_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
KERNEL = CudaKernel("hist_nodes", "hist.cu", "hist_nodes_launch", _ARGS)
KERNEL_BF16 = CudaKernel("hist_nodes_bf16", "hist.cu",
                         "hist_nodes_bf16_launch", _ARGS)
DIRECT_KERNEL = CudaKernel(
    "hist_direct", "hist_direct.cu", "hist_direct_launch",
    [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4)


def _scratch(kernel: CudaKernel, query: str, device, *sizes) -> torch.Tensor:
    """The kernel's int32 scratch (tickets, fold flags; B4's partition), of
    the size its library gives for these widths; the launch zeroes what it
    must."""
    ints = kernel.call(query, [ctypes.c_int] * len(sizes), *sizes)
    return torch.empty(ints, dtype=torch.int32, device=device)


def _check_bins(n_bins: int) -> None:
    if not 2 <= n_bins <= MAX_BINS:
        raise ValueError(f"n_bins must be in [2, {MAX_BINS}], got {n_bins}")


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
    _check_bins(n_bins)
    out = torch.empty((n_nodes, m, n_bins, c), dtype=torch.float32,
                      device=codes_t.device)
    scratch = _scratch(kernel, "hist_nodes_scratch_ints", codes_t.device,
                       n_nodes, m, c)
    kernel.launch(codes_t.data_ptr(), order.data_ptr(), stats_p.data_ptr(),
                  counts.data_ptr(), build_counts.data_ptr(), out.data_ptr(),
                  scratch.data_ptr(), scratch.numel(), n, s, m, n_nodes,
                  n_bins, c)
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
    _check_bins(n_bins)
    if n_nodes < 1:
        raise ValueError(f"n_nodes must be >= 1, got {n_nodes}")
    out = torch.empty((n_nodes, m, n_bins, c), dtype=torch.float32,
                      device=codes_t.device)
    scratch = _scratch(DIRECT_KERNEL, "hist_direct_scratch_ints",
                       codes_t.device, n, m, n_nodes, c)
    DIRECT_KERNEL.launch(codes_t.data_ptr(), node_pos.data_ptr(),
                         stats.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                         scratch.numel(), n, m, n_nodes, n_bins, c)
    return out


def launch_info(kernel: CudaKernel, *, c: int, n_bins: int) -> dict:
    """What the build gives a launch at these widths: registers a thread,
    shared bytes a block and blocks resident an SM (``cudaFuncGetAttributes``
    and the occupancy calculator)."""
    info = (ctypes.c_int * 3)()
    if kernel is DIRECT_KERNEL:
        err = kernel.call("hist_direct_info", [ctypes.c_int] * 2
                          + [ctypes.c_void_p], c, n_bins, info)
    else:
        err = kernel.call("hist_nodes_info", [ctypes.c_int] * 3
                          + [ctypes.c_void_p], int(kernel is KERNEL_BF16), c,
                          n_bins, info)
    if err != 0:
        raise RuntimeError(f"{kernel.name}: CUDA error {err} in launch_info")
    return dict(registers=info[0], smem_bytes=info[1], blocks_per_sm=info[2])
