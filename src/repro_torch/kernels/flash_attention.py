"""B7 wrapper: forward GQA attention with causal and window masks
(`csrc/flash_attention.cu`).

Replaces the JAX package's ``flash_attention_pallas`` and its padding
wrapper ``ops.flash_attention``, without the TPU's tiles: the kernel takes
any ``sq`` and ``sk`` and masks keys past the true ``sk``.  (The reference's
wrapper pads k and v with zeros to its tile and passes the padded length as
``kv_len``, so without the causal mask it attends to the padding too.)  A
CPU tensor goes to the plain version (`ref.flash_attention_ref`); a CUDA
tensor goes to the kernel, or the wrapper raises.  ``KERNEL.launches``
counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import CudaKernel, require

KERNEL = CudaKernel(
    "flash_attention", "flash_attention.cu", "flash_attention_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_float])
MAX_HEAD_DIM = 256


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Attention of q (b, hq, sq, dh) over k, v (b, hkv, sk, dh), float32
    or bfloat16, ``hq % hkv == 0``; returns (b, hq, sq, dh) in q's dtype.
    Query head h reads kv head ``h // (hq // hkv)``; a key is seen when it
    lies before ``sk``, at or before the query (``causal``) and less than
    ``window`` behind it.  Every query row must see a key, which fails only
    when ``sq - sk >= window``."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be (b, h, s, dh), got {tuple(q.shape)}"
                         f" and {tuple(k.shape)}")
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention takes float32 or bfloat16, got "
                         f"{q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or tuple(t.shape) != (b, hkv, sk, dh):
            raise ValueError(f"{name} must be {q.dtype} of shape "
                             f"{(b, hkv, sk, dh)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"query heads ({hq}) must be a multiple of kv heads "
                         f"({hkv})")
    if min(b, sq, sk, dh) < 1 or dh > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes b, sq, sk >= 1 and 1 <= dh "
                         f"<= {MAX_HEAD_DIM}, got {tuple(q.shape)}, sk={sk}")
    if window is not None and (window < 1 or sq - sk >= window):
        raise ValueError(f"window {window} must be >= 1 and leave every query "
                         f"row a key (sq - sk < window; sq={sq}, sk={sk})")
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    require(q, q.dtype, (b, hq, sq, dh), "q")
    require(k, q.dtype, (b, hkv, sk, dh), "k")
    require(v, q.dtype, (b, hkv, sk, dh), "v")
    out = torch.empty_like(q)
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  b, hq, hkv, sq, sk, dh, int(causal),
                  0 if window is None else int(window),
                  int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(dh))
    return out
