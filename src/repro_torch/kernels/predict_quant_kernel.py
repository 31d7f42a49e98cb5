"""B5 wrapper: quantized packed-forest traversal (`csrc/predict.cu`).

Replaces the JAX package's ``forest_traverse_quant_pallas``.  A CPU tensor
goes to the plain version (`ref.forest_apply_quant_ref`); a CUDA tensor goes
to the kernel, or the wrapper raises.  The kernel is built once per leaf
type, and ``KERNELS[dtype].launches`` counts each one's launches.  Both
update ``F`` in place and return it.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import CudaKernel, require

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_float] + [ctypes.c_int] * 7
KERNELS = {
    torch.int8: CudaKernel(
        "forest_traverse_quant_int8", "predict.cu",
        "forest_traverse_quant_int8_launch", _ARGTYPES,
        extra_flags=("-fmad=false",)),
    torch.bfloat16: CudaKernel(
        "forest_traverse_quant_bf16", "predict.cu",
        "forest_traverse_quant_bf16_launch", _ARGTYPES,
        extra_flags=("-fmad=false",)),
}


def forest_traverse_quant(F: torch.Tensor, codes: torch.Tensor,
                          feat: torch.Tensor, thr: torch.Tensor,
                          left: torch.Tensor, right: torch.Tensor,
                          leaf: torch.Tensor, leaf_scale: torch.Tensor,
                          out_col: torch.Tensor, lr: float, *,
                          depth: int) -> torch.Tensor:
    """``F[:, out_col[t]:out_col[t]+W] += lr * (leaf[t, walk_t(codes)]
    .float() * leaf_scale[t])`` for every tree t in index order.  F (n, D)
    float32, codes (n, M) uint8, feat/left/right (T, N) int32, thr (T, N)
    uint8, leaf (T, N, W) int8 or bfloat16, leaf_scale T float32 values
    ((T, 1) as `QuantizedForest` stores them, or (T,)), out_col (T,)
    int32."""
    lr = float(np.float32(lr))
    if F.device.type == "cpu":
        return ref.forest_apply_quant_ref(F, codes, feat, thr, left, right,
                                          leaf, leaf_scale, out_col, lr,
                                          depth=depth)
    if leaf.dtype not in KERNELS:
        raise ValueError(f"leaf must be int8 or bfloat16, got {leaf.dtype}")
    n, D = F.shape
    T, N, W = leaf.shape
    M = codes.shape[1]
    require(F, torch.float32, (n, D), "F")
    require(codes, torch.uint8, (n, M), "codes")
    for name, t in (("feat", feat), ("left", left), ("right", right)):
        require(t, torch.int32, (T, N), name)
    require(thr, torch.uint8, (T, N), "thr")
    require(leaf, leaf.dtype, (T, N, W), "leaf")
    if leaf_scale.numel() != T:
        raise ValueError(f"leaf_scale must hold {T} values, got shape "
                         f"{tuple(leaf_scale.shape)}")
    scale = leaf_scale.reshape(T)
    require(scale, torch.float32, (T,), "leaf_scale")
    require(out_col, torch.int32, (T,), "out_col")
    if n == 0 or T == 0:
        return F
    KERNELS[leaf.dtype].launch(
        F.data_ptr(), codes.data_ptr(), feat.data_ptr(), thr.data_ptr(),
        left.data_ptr(), right.data_ptr(), leaf.data_ptr(), scale.data_ptr(),
        out_col.data_ptr(), lr, n, D, M, T, N, W, depth)
    return F
