"""B6 wrapper: path-dependent TreeSHAP (`csrc/shap.cu`).

Replaces the JAX package's ``shap_pallas`` and its padding wrapper
``ops.tree_shap``, without the TPU's lane and sublane padding: the kernel
takes the `explain.paths.PathPack` tables in their own ``(T, L, D)``
layout.  A CPU tensor goes to the plain version (`ref.tree_shap_ref`); a
CUDA tensor goes to the kernel, or the wrapper raises.  ``KERNEL.launches``
counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import CudaKernel, require

KERNEL = CudaKernel(
    "tree_shap", "shap.cu", "tree_shap_launch",
    [ctypes.c_void_p] * 10 + [ctypes.c_float] + [ctypes.c_int] * 7,
    extra_flags=("-fmad=false",))
MAX_DEPTH = 32          # path slots the kernel holds per thread (MAXD)
_SHAPE_ARGS = [ctypes.c_int] * 7
INFO_KEYS = ("rows_a_thread", "rows", "feature_warps", "features_a_warp",
             "staged", "shared_bytes", "chunk_rows", "feature_passes",
             "trees_a_buffer")


def launch_info(n: int, M: int, d: int, T: int, L: int, D: int,
                W: int) -> dict:
    """What ``shap.cu`` picks for this shape on the current card: the
    scatter's rows a thread and a block, its warps across the features and
    the features each holds in registers, whether the tables are staged in
    shared memory, the shared bytes a block, the rows of one pass through
    the Psi scratch, the passes over the features, and the trees staged at
    a time."""
    out = (ctypes.c_int * len(INFO_KEYS))()
    err = KERNEL.call("tree_shap_info", _SHAPE_ARGS + [ctypes.c_void_p],
                      n, M, d, T, L, D, W, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"tree_shap_info: CUDA error {err}")
    return dict(zip(INFO_KEYS, out))


def tree_shap(codes: torch.Tensor, slot_feat: torch.Tensor,
              slot_lo: torch.Tensor, slot_hi: torch.Tensor,
              slot_z: torch.Tensor, leaf: torch.Tensor, out_col: torch.Tensor,
              lr: float, *, n_outputs: int) -> torch.Tensor:
    """``lr * sum_t shap_t(codes)`` as a new (n, M, n_outputs) float32
    tensor on the codes' device.  codes (n, M) uint8, slot_feat / slot_lo /
    slot_hi (T, L, D) int32, slot_z (T, L, D) float32, leaf (T, L, W)
    float32, out_col (T,) int32; the slot axis D is the path depth."""
    lr = float(np.float32(lr))
    n, M = codes.shape
    d = int(n_outputs)
    if codes.device.type == "cpu":
        phi = torch.zeros((n, M, d), dtype=torch.float32)
        return ref.tree_shap_ref(phi, codes, slot_feat, slot_lo, slot_hi,
                                 slot_z, leaf, out_col, lr)
    T, L, D = slot_feat.shape
    W = leaf.shape[2]
    require(codes, torch.uint8, (n, M), "codes")
    for name, t in (("slot_feat", slot_feat), ("slot_lo", slot_lo),
                    ("slot_hi", slot_hi)):
        require(t, torch.int32, (T, L, D), name)
    require(slot_z, torch.float32, (T, L, D), "slot_z")
    require(leaf, torch.float32, (T, L, W), "leaf")
    require(out_col, torch.int32, (T,), "out_col")
    if not 1 <= D <= MAX_DEPTH:
        raise ValueError(f"the SHAP kernel takes paths of 1 to {MAX_DEPTH} "
                         f"slots, got {D}")
    if n == 0 or M == 0 or d == 0 or T == 0:
        return torch.zeros((n, M, d), dtype=torch.float32,
                           device=codes.device)
    phi = torch.empty((n, M, d), dtype=torch.float32, device=codes.device)
    wts = torch.tensor(ref._unwind_weights(D), dtype=torch.float32,
                       device=codes.device)
    # The per-tree plans and the Psi factors of one chunk of rows.
    kib = KERNEL.call("tree_shap_scratch_kib", _SHAPE_ARGS, n, M, d, T, L,
                      D, W)
    if kib < 0:
        raise ValueError(f"tree_shap: shape {(n, M, d, T, L, D, W)} out "
                         "of range")
    scratch = torch.empty(kib * 256, dtype=torch.float32, device=codes.device)
    KERNEL.launch(phi.data_ptr(), codes.data_ptr(), slot_feat.data_ptr(),
                  slot_lo.data_ptr(), slot_hi.data_ptr(), slot_z.data_ptr(),
                  leaf.data_ptr(), out_col.data_ptr(), wts.data_ptr(),
                  scratch.data_ptr(), lr, n, M, d, T, L, D, W)
    return phi
