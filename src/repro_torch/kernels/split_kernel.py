"""B2 wrapper: best split per node (`csrc/split.cu`).

Replaces the JAX package's ``split_scan_pallas``.  A CPU tensor goes to the
plain version (`ref.split_scan_ref`); a CUDA tensor goes to the kernel, or
the wrapper raises.  Two kernels share the source: ``KERNEL`` for up to 64
channels (a sketch), ``WIDE_KERNEL`` for 65 to 1,024 (SketchBoost Full,
d + 1 channels); each counts its own launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import CudaKernel, require

KERNEL = CudaKernel(
    "split_scan", "split.cu", "split_scan_launch",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2)
WIDE_KERNEL = CudaKernel(
    "split_scan_wide", "split.cu", "split_scan_wide_launch",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2)
NARROW_CHANNELS = 64    # in registers; wider histograms spread over a block
MAX_CHANNELS = 1024


def split_scan(hist: torch.Tensor, lam: float, min_data: float,
               mask: torch.Tensor):
    """(nodes, m, B, C) float32 histograms + (m,) float32 feature mask ->
    per-node ``(best_gain float32, best_idx int32)``; idx = feature * B +
    bin, ties to the lowest index, ``(-inf, 0)`` with no legal split."""
    if hist.device.type == "cpu":
        return ref.split_scan_ref(hist, lam, min_data, mask)
    nodes, m, B, c = hist.shape
    require(hist, torch.float32, (nodes, m, B, c), "hist")
    require(mask, torch.float32, (m,), "mask")
    if not 2 <= c <= MAX_CHANNELS:
        raise ValueError(f"split_scan takes 2..{MAX_CHANNELS} channels "
                         f"(sketch width + 1, or d + 1 unsketched), got {c}")
    gain = torch.empty(nodes, dtype=torch.float32, device=hist.device)
    idx = torch.empty(nodes, dtype=torch.int32, device=hist.device)
    # The per-(node, feature) maxima, then each node's best of them.
    part_gain = torch.empty((nodes, m), dtype=torch.float32,
                            device=hist.device)
    part_idx = torch.empty((nodes, m), dtype=torch.int32, device=hist.device)
    kernel = KERNEL if c <= NARROW_CHANNELS else WIDE_KERNEL
    kernel.launch(hist.data_ptr(), mask.data_ptr(), gain.data_ptr(),
                  idx.data_ptr(), part_gain.data_ptr(), part_idx.data_ptr(),
                  nodes, m, B, c, float(lam), float(min_data))
    return gain, idx
