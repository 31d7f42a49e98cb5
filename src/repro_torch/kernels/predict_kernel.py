"""B3 wrapper: packed-forest traversal (`csrc/predict.cu`).

Replaces the JAX package's ``forest_traverse_pallas``.  A CPU tensor goes
to the plain version (`ref.forest_apply_ref`); a CUDA tensor goes to the
kernel, or the wrapper raises.  ``KERNEL.launches`` counts the kernel's
launches.  Both update ``F`` in place and return it.  The kernel picks its
tile for each call; `launch_info` reports the pick and its build.  Under a
roofline counter each call is counted by `work.traverse`, over the nodes
its rows' walks touch.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import ref, work
from repro_torch.kernels._build import CudaKernel, require

KERNEL = CudaKernel(
    "forest_traverse", "predict.cu", "forest_traverse_launch",
    [ctypes.c_void_p] * 8 + [ctypes.c_float] + [ctypes.c_int] * 7,
    extra_flags=("-fmad=false",))


def launch_info(kernel: CudaKernel, kind: int, n: int, D: int,
                M: int) -> dict:
    """What a launch of entry point ``kind`` (0 B3, 1 B5 int8, 2 B5 bf16)
    at F (n, D) with ``M`` codes a row takes on the current card: the tile
    that ``predict.cu`` picks (rows, columns, tree group, columns a vector),
    its grid and whether the rows' codes are staged in shared memory; and
    what the tile's build gives it: registers and local (spill) bytes a
    thread, shared bytes a block and blocks resident an SM."""
    info = (ctypes.c_int * 9)()
    err = kernel.call("forest_traverse_info", [ctypes.c_int] * 4
                      + [ctypes.c_void_p], kind, n, D, M, info)
    if err != 0:
        raise RuntimeError(f"{kernel.name}: CUDA error {err} in launch_info")
    rows, cols = info[4], info[5]
    return dict(rows=rows, cols=cols, group=info[6], vec=info[7],
                grid=(-(-n // rows), -(-D // cols)), stage_codes=bool(info[8]),
                registers=info[0], smem_bytes=info[1], blocks_per_sm=info[2],
                local_bytes=info[3])


def forest_traverse(F: torch.Tensor, codes: torch.Tensor, feat: torch.Tensor,
                    thr: torch.Tensor, left: torch.Tensor, right: torch.Tensor,
                    leaf: torch.Tensor, out_col: torch.Tensor, lr: float, *,
                    depth: int) -> torch.Tensor:
    """``F[:, out_col[t]:out_col[t]+W] += lr * leaf[t, walk_t(codes)]`` for
    every tree t in index order.  F (n, D) float32, codes (n, M) uint8,
    feat/thr/left/right (T, N) int32, leaf (T, N, W) float32, out_col (T,)
    int32."""
    lr = float(np.float32(lr))
    n, D = F.shape
    T, N, W = leaf.shape
    with work.kernel(KERNEL.name, lambda: work.traverse(
            n, codes.shape[1], T, D, W, leaf.element_size(),
            *work.traverse_touched(codes, feat, thr, left, right, depth))):
        if F.device.type == "cpu":
            return ref.forest_apply_ref(F, codes, feat, thr, left, right,
                                        leaf, out_col, lr, depth=depth)
        return _launch(F, codes, feat, thr, left, right, leaf, out_col, lr,
                       depth)


def _launch(F, codes, feat, thr, left, right, leaf, out_col, lr, depth):
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
