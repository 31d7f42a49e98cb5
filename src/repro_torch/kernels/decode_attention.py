"""B8 wrapper: one query token per sequence against a KV cache in the
cache's own ``(b, s, hkv, dh)`` layout (`csrc/decode_attention.cu`).

Replaces the JAX package's ``decode_attention_pallas`` and its padding
wrapper ``ops.decode_attention``, without the reference's transposed copy
of the cache and without its tile padding: the kernel reads k and v where
they lie, with row stride ``hkv * dh``.  A CPU tensor goes to the plain
version (`ref.decode_attention_ref`); a CUDA tensor goes to the kernel, or
the wrapper raises.  ``KERNEL.launches`` counts the kernel's launches.
Under a roofline counter each call is counted by `work.decode`.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Union

import torch

from repro_torch.kernels import ref, work
from repro_torch.kernels._build import CudaKernel, require

KERNEL = CudaKernel(
    "decode_attention", "decode_attention.cu", "decode_attention_launch",
    [ctypes.c_void_p] * 3 + [ctypes.c_void_p, ctypes.c_int]
    + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9 + [ctypes.c_float])
MAX_HEAD_DIM = 256
_DTYPES = (torch.float32, torch.bfloat16)


def splits_for(device: torch.device, blocks: int, keys: int) -> int:
    """Key splits that fill one wave of the kernel's four blocks an SM when
    ``blocks`` (batch rows x kv heads) are fewer, each split keeping 128
    keys or more."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    if blocks >= 4 * sms:
        return 1
    return max(1, min(-(-4 * sms // blocks), -(-keys // 128)))


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: Union[int, torch.Tensor], *,
                     window: Optional[int] = None) -> torch.Tensor:
    """Attention of q (b, hq, dh) over the cache k, v (b, s, hkv, dh):
    float32 or bfloat16 q, float32 or bfloat16 cache (k and v alike),
    ``hq % hkv == 0``; returns (b, hq, dh) in q's dtype.  Row i sees the
    keys ``kpos < lengths[i]`` and, with a window, ``lengths[i] - 1 - kpos
    < window``.  ``lengths`` is a (b,) integer tensor on q's device, or one
    int for every row; each must lie in ``[1, s]``.  An int is checked on
    the host; a CUDA tensor's values are read back to check them, which
    waits for the card (the decode path passes an int)."""
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"q must be (b, hq, dh) and k (b, s, hkv, dh), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    b, hq, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES or k.dtype not in _DTYPES:
        raise ValueError(f"decode_attention takes float32 or bfloat16 q and "
                         f"cache, got {q.dtype} and {k.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != k.dtype or tuple(t.shape) != (b, s, hkv, dh):
            raise ValueError(f"{name} must be {k.dtype} of shape "
                             f"{(b, s, hkv, dh)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"query heads ({hq}) must be a multiple of kv heads "
                         f"({hkv})")
    if min(b, s, dh) < 1 or dh > MAX_HEAD_DIM:
        raise ValueError(f"decode_attention takes b, s >= 1 and 1 <= dh <= "
                         f"{MAX_HEAD_DIM}, got q {tuple(q.shape)}, s={s}")
    if window is not None and window < 1:
        raise ValueError(f"window {window} must be >= 1")
    if isinstance(lengths, torch.Tensor):
        if tuple(lengths.shape) != (b,) or lengths.is_floating_point():
            raise ValueError(f"lengths must be an integer tensor of shape "
                             f"{(b,)}, got {lengths.dtype} "
                             f"{tuple(lengths.shape)}")
        lo, hi = int(lengths.min()), int(lengths.max())
    else:
        lo = hi = int(lengths)
    if lo < 1 or hi > s:
        raise ValueError(f"lengths must lie in [1, {s}] (the cache's "
                         f"slots), got [{lo}, {hi}]")
    with work.kernel(KERNEL.name, lambda: work.decode(
            b, hq, hkv, dh, _seen(lengths, b, window), q.element_size(),
            k.element_size()), q, k, v) as shape_only:
        if shape_only:
            return torch.empty_like(q)
        if q.device.type == "cpu":
            if not isinstance(lengths, torch.Tensor):
                lengths = torch.full((b,), int(lengths), dtype=torch.int32)
            return ref.decode_attention_ref(q, k, v, lengths, window=window)
        return _launch(q, k, v, lengths, window)


def _seen(lengths, b: int, window: Optional[int]) -> int:
    """Cache slots the rows see in all: each row's length cut to the
    window."""
    if isinstance(lengths, torch.Tensor):
        seen = lengths.long()
        if window is not None:
            seen = torch.clamp(seen, max=window)
        return int(seen.sum())
    return b * (int(lengths) if window is None else min(int(lengths), window))


def _launch(q, k, v, lengths, window):
    b, hq, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    require(q, q.dtype, (b, hq, dh), "q")
    require(k, k.dtype, (b, s, hkv, dh), "k")
    require(v, k.dtype, (b, s, hkv, dh), "v")
    if isinstance(lengths, torch.Tensor):
        lengths = lengths.to(torch.int32)
        require(lengths, torch.int32, (b,), "lengths")
        len_ptr, length = lengths.data_ptr(), 0
    else:
        len_ptr, length = None, int(lengths)
    keys = s if window is None else min(s, window)
    splits = splits_for(q.device, b * hkv, keys)
    out = torch.empty_like(q)
    part = (torch.empty(b * hq * splits * (dh + 2), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), len_ptr, length,
                  out.data_ptr(), None if part is None else part.data_ptr(),
                  b, hq, hkv, s, dh, 0 if window is None else int(window),
                  splits, int(q.dtype == torch.bfloat16),
                  int(k.dtype == torch.bfloat16), 1.0 / math.sqrt(dh))
    return out
