"""B3 wrapper: packed-forest traversal (`csrc/predict.cu`).

Replaces the JAX package's ``forest_traverse_pallas``.  A CPU tensor goes
to the plain version (`ref.forest_apply_ref`); a CUDA tensor goes to the
kernel, or the wrapper raises.  ``KERNEL.launches`` counts the kernel's
launches.  Both update ``F`` in place and return it.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import CudaKernel, require

KERNEL = CudaKernel(
    "forest_traverse", "predict.cu", "forest_traverse_launch",
    [ctypes.c_void_p] * 8 + [ctypes.c_float] + [ctypes.c_int] * 7,
    extra_flags=("-fmad=false",))


def forest_traverse(F: torch.Tensor, codes: torch.Tensor, feat: torch.Tensor,
                    thr: torch.Tensor, left: torch.Tensor, right: torch.Tensor,
                    leaf: torch.Tensor, out_col: torch.Tensor, lr: float, *,
                    depth: int) -> torch.Tensor:
    """``F[:, out_col[t]:out_col[t]+W] += lr * leaf[t, walk_t(codes)]`` for
    every tree t in index order.  F (n, D) float32, codes (n, M) uint8,
    feat/thr/left/right (T, N) int32, leaf (T, N, W) float32, out_col (T,)
    int32."""
    lr = float(np.float32(lr))
    if F.device.type == "cpu":
        return ref.forest_apply_ref(F, codes, feat, thr, left, right, leaf,
                                    out_col, lr, depth=depth)
    n, D = F.shape
    T, N, W = leaf.shape
    M = codes.shape[1]
    require(F, torch.float32, (n, D), "F")
    require(codes, torch.uint8, (n, M), "codes")
    for name, t in (("feat", feat), ("thr", thr), ("left", left),
                    ("right", right)):
        require(t, torch.int32, (T, N), name)
    require(leaf, torch.float32, (T, N, W), "leaf")
    require(out_col, torch.int32, (T,), "out_col")
    if n == 0 or T == 0:
        return F
    KERNEL.launch(F.data_ptr(), codes.data_ptr(), feat.data_ptr(),
                  thr.data_ptr(), left.data_ptr(), right.data_ptr(),
                  leaf.data_ptr(), out_col.data_ptr(), lr, n, D, M, T, N, W,
                  depth)
    return F
