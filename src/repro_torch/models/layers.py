"""Transformer building blocks: RMSNorm, RoPE, GQA attention, GLU MLPs.

The port of the JAX package's ``models/layers.py`` for full-sequence
attention (train shapes and prefill).  Weights keep the reference's
``(d_in, d_out)`` layout, applied as ``x @ w``.  Attention always goes
through B7 (`kernels.flash_attention.flash_attention`), picked by device:
the kernel on a CUDA tensor, its plain version on a CPU tensor.  The
reference's pure-jnp ``chunked_attention`` (its ``use_pallas=False`` path)
has no counterpart: it rounds the probabilities to the model dtype before
the PV product, where B7 keeps them in float32.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

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
