"""B2 wrapper: best split per node (`csrc/split.cu`).

Replaces the JAX package's ``split_scan_pallas``.  A CPU tensor goes to the
plain version (`ref.split_scan_ref`); a CUDA tensor goes to the kernel, or
the wrapper raises.  Two entry points share the source: ``KERNEL`` for up
to 32 channels (a sketch of up to 31 columns), ``WIDE_KERNEL`` for 33 to
1,024 (wider sketches, and SketchBoost Full's d + 1 channels; up to 256
bins), which is faster from 33 channels on; each counts its own launches.
Under a roofline counter each call is counted by `work.split_scan`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref, work
from repro_torch.kernels._build import CudaKernel, require

KERNEL = CudaKernel(
    "split_scan", "split.cu", "split_scan_launch",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2)
WIDE_KERNEL = CudaKernel(
    "split_scan_wide", "split.cu", "split_scan_wide_launch",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2)
NARROW_CHANNELS = 32    # in registers; wider histograms spread over warps
MAX_CHANNELS = 1024
# The wide scan: a warp takes a span of WIDE_CHUNKS chunks of 32 gradient
# channels, summing their squares channel by channel in order; a block
# holds WIDE_WARPS such warps, each with its own 32 KB chunk buffer.
WIDE_WARPS = 1
WIDE_CHUNKS = 8
WIDE_MAX_BINS = 256


def wide_groups(c: int):
    """The wide scan's groups of gradient channels of a C-channel
    histogram, in group order, each in the order its warp sums them."""
    span = 32 * WIDE_CHUNKS
    return [list(range(c0, min(c0 + span, c - 1)))
            for c0 in range(0, c - 1, span)]


def split_scan(hist: torch.Tensor, lam: float, min_data: float,
               mask: torch.Tensor):
    """(nodes, m, B, C) float32 histograms + (m,) float32 feature mask ->
    per-node ``(best_gain float32, best_idx int32)``; idx = feature * B +
    bin, ties to the lowest index, ``(-inf, 0)`` with no legal split."""
    nodes, m, B, c = hist.shape
    name = (KERNEL if c <= NARROW_CHANNELS else WIDE_KERNEL).name
    with work.kernel(name, lambda: work.split_scan(
            nodes, int((mask > 0).sum()), m, B, c)):
        if hist.device.type == "cpu":
            return ref.split_scan_ref(hist, lam, min_data, mask)
        return _launch(hist, lam, min_data, mask)


def _launch(hist, lam, min_data, mask):
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
    ptrs = [hist.data_ptr(), mask.data_ptr(), gain.data_ptr(),
            idx.data_ptr(), part_gain.data_ptr(), part_idx.data_ptr()]
    if c <= NARROW_CHANNELS:
        KERNEL.launch(*ptrs, nodes, m, B, c, float(lam), float(min_data))
        return gain, idx
    if B > WIDE_MAX_BINS:
        raise ValueError(f"split_scan takes at most {WIDE_MAX_BINS} bins "
                         f"above {NARROW_CHANNELS} channels, got {B}")
    # Each group's per-bin partial sums (sum cs^2, sum (T - cs)^2), float64.
    groups = len(wide_groups(c))
    scan_part = torch.empty((nodes, m, groups, B, 2), dtype=torch.float64,
                            device=hist.device)
    WIDE_KERNEL.launch(*ptrs, scan_part.data_ptr(), nodes, m, B, c,
                       WIDE_WARPS, WIDE_CHUNKS, float(lam), float(min_data))
    return gain, idx
