"""B7 wrapper: GQA attention with causal and window masks
(`csrc/flash_attention.cu`), and its backward (`csrc/flash_attention_bwd.cu`).

Replaces the JAX package's ``flash_attention_pallas`` and its padding
wrapper ``ops.flash_attention``, without the TPU's tiles: the kernel takes
any ``sq`` and ``sk`` and masks keys past the true ``sk``.  (The reference's
wrapper pads k and v with zeros to its tile and passes the padded length as
``kv_len``, so without the causal mask it attends to the padding too.)  A
CPU tensor goes to the plain version (`ref.flash_attention_ref`); a CUDA
tensor goes to the kernel, or the wrapper raises.  ``KERNEL.launches``
counts the forward kernel's launches, ``BWD_KERNEL.launches`` the
backward's (one a call: its three device kernels go in one launch).

A call that records gradients (grad mode on and q, k or v requiring them)
runs as `FlashAttention`, a ``torch.autograd.Function``, on either device:
the forward also gives each query row's float32 log-sum-exp, and the
backward recomputes the probabilities from it (the kernels on the card,
`ref.flash_attention_ref` and `ref.flash_attention_bwd_ref` on the CPU).
Any other call runs the forward alone, without that output.  So a roofline
counter (`kernels.work`) counts each call, forward and backward, once by
its formula, on the same structure on either device.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import ref, work
from repro_torch.kernels._build import CudaKernel, require

KERNEL = CudaKernel(
    "flash_attention", "flash_attention.cu", "flash_attention_launch",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_float])
BWD_KERNEL = CudaKernel(
    "flash_attention_bwd", "flash_attention_bwd.cu",
    "flash_attention_bwd_launch",
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_float])
MAX_HEAD_DIM = 256


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int]) -> None:
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


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: Optional[int], with_lse: bool):
    """The forward kernel: (out, float32 lse (b, hq, sq) or None)."""
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    require(q, q.dtype, (b, hq, sq, dh), "q")
    require(k, q.dtype, (b, hkv, sk, dh), "k")
    require(v, q.dtype, (b, hkv, sk, dh), "v")
    out = torch.empty_like(q)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  None if lse is None else lse.data_ptr(),
                  b, hq, hkv, sq, sk, dh, int(causal),
                  0 if window is None else int(window),
                  int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(dh))
    return out, lse


def _fwd_work(q, k, causal, window, lse):
    b, hq, sq, dh = q.shape
    return lambda: work.flash_fwd(b, hq, k.shape[1], sq, k.shape[2], dh,
                                  causal, window, q.element_size(), lse)


class FlashAttention(torch.autograd.Function):
    """B7 with its hand-written backward: the kernels on the card, the
    plain versions on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = flash_attention_lse(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(),
                                         causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Attention of q (b, hq, sq, dh) over k, v (b, hkv, sk, dh), float32
    or bfloat16, ``hq % hkv == 0``; returns (b, hq, sq, dh) in q's dtype.
    Query head h reads kv head ``h // (hq // hkv)``; a key is seen when it
    lies before ``sk``, at or before the query (``causal``) and less than
    ``window`` behind it.  Every query row must see a key, which fails only
    when ``sq - sk >= window``.  Differentiable on both devices."""
    _check(q, k, v, window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window)
    with work.kernel(KERNEL.name, _fwd_work(q, k, causal, window, False),
                     q, k, v) as shape_only:
        if shape_only:
            return torch.empty_like(q)
        if q.device.type == "cpu":
            return ref.flash_attention_ref(q, k, v, causal=causal,
                                           window=window)
        return _launch(q, k, v, causal, window, with_lse=False)[0]


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None):
    """`flash_attention` without gradients, with each query row's float32
    log-sum-exp of its scaled scores: (out, lse (b, hq, sq)), what
    `flash_attention_bwd` takes."""
    _check(q, k, v, window)
    with work.kernel(KERNEL.name, _fwd_work(q, k, causal, window, True),
                     q, k, v) as shape_only:
        if shape_only:
            return torch.empty_like(q), q.new_empty(q.shape[:3],
                                                    dtype=torch.float32)
        if q.device.type == "cpu":
            return ref.flash_attention_ref(q, k, v, causal=causal,
                                           window=window, return_lse=True)
        return _launch(q, k, v, causal, window, with_lse=True)


def bwd_launch_info(dh: int) -> dict:
    """What the build gives the backward's bf16 body at head width ``dh``
    (<= 128): for its dK/dV and dQ kernels, registers a thread, shared
    bytes a block and blocks resident an SM (``cudaFuncGetAttributes`` and
    the occupancy calculator).  A query, not a launch."""
    info = (ctypes.c_int * 6)()
    err = BWD_KERNEL.call("flash_attention_bwd_info",
                          [ctypes.c_int, ctypes.c_void_p], dh, info)
    if err != 0:
        raise RuntimeError(f"{BWD_KERNEL.name}: CUDA error {err} in "
                           f"bwd_launch_info")
    return {name: dict(registers=info[3 * i], smem_bytes=info[3 * i + 1],
                       blocks_per_sm=info[3 * i + 2])
            for i, name in enumerate(("dkdv", "dq"))}


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None):
    """The gradients (dq, dk, dv) of `flash_attention` at (q, k, v), given
    its output ``out``, its float32 ``lse`` (b, hq, sq) and the output's
    gradient ``dout``, each in q's dtype and shape; float32 sums, rounded
    once to the input type (bf16 with dh <= 128 on the tensor cores, P and
    dS each through three exact bf16 parts).  A CPU tensor goes to the plain
    version (`ref.flash_attention_bwd_ref`), a CUDA tensor to the kernel."""
    _check(q, k, v, window)
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    for name, t in (("out", out), ("dout", dout)):
        if t.dtype != q.dtype or tuple(t.shape) != (b, hq, sq, dh):
            raise ValueError(f"{name} must be {q.dtype} of shape "
                             f"{(b, hq, sq, dh)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, hq, sq):
        raise ValueError(f"lse must be float32 of shape {(b, hq, sq)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    with work.kernel(BWD_KERNEL.name, lambda: work.flash_bwd(
            b, hq, hkv, sq, sk, dh, causal, window, q.element_size()),
            q, k, v, dout) as shape_only:
        if shape_only:
            return tuple(torch.empty_like(t) for t in (q, k, v))
        if q.device.type == "cpu":
            return ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                               causal=causal, window=window)
        return _launch_bwd(q, k, v, out, lse, dout, causal, window)


def _launch_bwd(q, k, v, out, lse, dout, causal, window):
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out),
                    ("dout", dout), ("lse", lse)):
        require(t, t.dtype, tuple(t.shape), name)
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    BWD_KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), lse.data_ptr(), dout.data_ptr(),
                      delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                      dv.data_ptr(), b, hq, hkv, sq, sk, dh, int(causal),
                      0 if window is None else int(window),
                      int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(dh))
    return dq, dk, dv
