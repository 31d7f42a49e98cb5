"""Transformer building blocks: RMSNorm, RoPE, GQA attention, GLU MLPs.

The port of the JAX package's ``models/layers.py`` for full-sequence
attention (train shapes and prefill) and one-token decode over a KV cache.
Weights keep the reference's ``(d_in, d_out)`` layout, applied as ``x @
w``.  Full-sequence attention always goes through B7
(`kernels.flash_attention.flash_attention`) and decode through B8
(`kernels.decode_attention.decode_attention`), each picked by device: the
kernel on a CUDA tensor, its plain version on a CPU tensor.  The
reference's pure-jnp ``chunked_attention`` and ``decode_attention_jnp``
(its ``use_pallas=False`` paths) have no counterpart: the first rounds the
probabilities to the model dtype before the PV product, where B7 keeps
them in float32, and the second computes B8's function without the kernel.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.params import ParamDecl


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """In float32, times the float32 weight, cast back to x's dtype."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Half-split rotary embedding of x (..., S, H, dh) at ``positions``
    (broadcastable to S), in float32, cast back to x's dtype."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].to(torch.float32) * freqs     # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                        # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def attention_decls(d_model: int, n_heads: int, n_kv_heads: int,
                    head_dim: int) -> Dict[str, ParamDecl]:
    return {
        "wq": ParamDecl((d_model, n_heads * head_dim), ("fsdp", "tp")),
        "wk": ParamDecl((d_model, n_kv_heads * head_dim), ("fsdp", "tp")),
        "wv": ParamDecl((d_model, n_kv_heads * head_dim), ("fsdp", "tp")),
        "wo": ParamDecl((n_heads * head_dim, d_model), ("tp", "fsdp")),
    }


def attention_apply(p, x: torch.Tensor, *, n_heads: int, n_kv_heads: int,
                    head_dim: int, rope_theta: float,
                    positions: Optional[torch.Tensor] = None,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Full-sequence self-attention of x (b, s, d): projections, RoPE on q
    and k, B7 in the ``(b, h, s, dh)`` layout, output projection."""
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, n_heads, head_dim)
    k = (x @ p["wk"]).reshape(b, s, n_kv_heads, head_dim)
    v = (x @ p["wv"]).reshape(b, s, n_kv_heads, head_dim)
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q = rope(q, positions, rope_theta)
    k = rope(k, positions, rope_theta)
    out = flash_attention(q.transpose(1, 2).contiguous(),
                          k.transpose(1, 2).contiguous(),
                          v.transpose(1, 2).contiguous(),
                          causal=causal, window=window)
    return out.transpose(1, 2).reshape(b, s, n_heads * head_dim) @ p["wo"]


def attention_cache(b: int, s_max: int, n_kv_heads: int, head_dim: int,
                    dtype=torch.bfloat16, window: Optional[int] = None,
                    device=None, n_layers: Optional[int] = None):
    """A zeroed KV cache: ``k`` and ``v`` of shape (b, s_alloc, hkv, dh)
    (with a leading ``n_layers`` axis when given), ``s_alloc = min(s_max,
    window)`` with a window (the cache is then a ring) and ``s_max``
    without; bf16 by default whatever the model dtype, as the reference's;
    ``length`` 0, a host int."""
    s_alloc = min(s_max, window) if window is not None else s_max
    shape = (b, s_alloc, n_kv_heads, head_dim)
    if n_layers is not None:
        shape = (n_layers,) + shape
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "length": 0}


def attention_decode(p, x: torch.Tensor, cache, *, n_heads: int,
                     n_kv_heads: int, head_dim: int, rope_theta: float,
                     window: Optional[int] = None):
    """One-token decode of x (b, d) against ``cache`` (`attention_cache`),
    updated in place: returns ``(y, cache)`` with the same dict.

    q and k are roped at the true position ``length`` (the tokens already
    cached); the new k and v are written at slot ``length % s_alloc`` with
    a window (a ring) and at ``length`` without; B8 then reads the first
    ``min(length + 1, s_alloc)`` slots, masking by slot.  ``length`` is a
    host int, so the slot is computed without reading the card.  A write
    that would overwrite a key the query must still see raises: past
    ``s_alloc`` without a window, or past a ring shorter than the window
    (``max_seq_len`` below it).  The reference clamps or wraps there and
    answers wrongly."""
    b = x.shape[0]
    length = int(cache["length"])
    k_cache, v_cache = cache["k"], cache["v"]
    s_alloc = k_cache.shape[1]
    if length >= s_alloc and (window is None or s_alloc < window):
        ring = "" if window is None else f" (window {window})"
        raise ValueError(
            f"decode past the cache: {length} tokens are cached in "
            f"{s_alloc} slots{ring}; make the cache with a larger "
            f"max_seq_len")
    q = (x @ p["wq"]).reshape(b, 1, n_heads, head_dim)
    k = (x @ p["wk"]).reshape(b, 1, n_kv_heads, head_dim)
    v = (x @ p["wv"]).reshape(b, n_kv_heads, head_dim)
    pos = torch.full((1,), length, device=x.device)
    q = rope(q, pos, rope_theta)[:, 0]
    k = rope(k, pos, rope_theta)[:, 0]
    slot = length % s_alloc if window is not None else length
    k_cache[:, slot] = k.to(k_cache.dtype)
    v_cache[:, slot] = v.to(v_cache.dtype)
    out = decode_attention(q, k_cache, v_cache, min(length + 1, s_alloc),
                           window=window)
    cache["length"] = length + 1
    return out.reshape(b, n_heads * head_dim) @ p["wo"], cache


def mlp_decls(d_model: int, d_ff: int, act: str) -> Dict[str, ParamDecl]:
    decls = {
        "wi": ParamDecl((d_model, d_ff), ("fsdp", "tp")),
        "wo": ParamDecl((d_ff, d_model), ("tp", "fsdp")),
    }
    if act in ("swiglu", "geglu"):
        decls["wg"] = ParamDecl((d_model, d_ff), ("fsdp", "tp"))
    return decls


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh form, in float32, cast back."""
    return F.gelu(x.float(), approximate="tanh").to(x.dtype)


def mlp_apply(p, x: torch.Tensor, *, act: str) -> torch.Tensor:
    """``wi`` is the up projection and ``wg`` the gate:
    swiglu ``silu(x wg) * (x wi)``, geglu ``gelu(x wg) * (x wi)``, gelu
    ``gelu(x wi)``; then ``@ wo``."""
    h = x @ p["wi"]
    if act == "swiglu":
        h = F.silu(x @ p["wg"]) * h
    elif act == "geglu":
        h = _gelu(x @ p["wg"]) * h
    elif act == "gelu":
        h = _gelu(h)
    else:
        raise ValueError(f"unknown act {act!r}")
    return h @ p["wo"]
