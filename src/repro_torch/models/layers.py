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

`AxisCtx` is a training step's layout on a mesh of ranks (batch axes,
FSDP axes, model axis, and the parameters' partition specs).  The
reference threads it through the layers to constrain activations, and
GSPMD places the collectives; here the layers run tensor-parallel over
``model`` themselves (Megatron's layout): ``attention_apply`` and
``mlp_apply`` take the replicated activations through `collectives.
copy_to`, multiply by their column blocks (q/k/v, ``wi``/``wg``), run B7
on this rank's heads, and sum the row-parallel ``wo`` products with
`collectives.reduce_from`.  With no mesh, or a model axis of one rank,
they are the one-device functions, op for op.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as C
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.params import ParamDecl, entry_axes, map_specs


@dataclasses.dataclass(frozen=True)
class AxisCtx:
    """A step's layout on a mesh (None: no mesh): the batch dimension over
    ``batch_axes``, heads and FFN hidden over ``model_axis`` (None in
    ``dp_only`` mode), the parameters' storage over ``fsdp_axes``;
    ``specs`` the parameters' partition specs (`lm.abstract`'s layout), on
    a mesh of ranks."""
    mesh: Optional[Any] = None
    batch_axes: Tuple[str, ...] = ("data",)
    model_axis: Optional[str] = "model"
    fsdp_axes: Tuple[str, ...] = ()
    specs: Any = dataclasses.field(default=None, compare=False)

    @property
    def tp(self) -> int:
        """Ranks on the model axis (1 without one)."""
        if self.mesh is None or self.model_axis is None:
            return 1
        return self.mesh.axis_size(self.model_axis)

    @property
    def tp_rank(self) -> int:
        return 0 if self.tp == 1 else self.mesh.index(self.model_axis)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's ``f`` over the model axis (identity with one rank)."""
        return C.copy_to(x, self.mesh, self.model_axis)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's ``g`` over the model axis."""
        return C.reduce_from(x, self.mesh, self.model_axis)

    def gather(self, tree, specs):
        """Each leaf of ``tree`` (this rank's blocks) gathered over the
        FSDP axes its spec shards it on; the gradients are reduce-scattered
        back (`collectives.gather_param`).  ``tree`` itself without a
        mesh."""
        if self.mesh is None:
            return tree

        def one(x, spec):
            for dim, entry in enumerate(spec):
                for ax in reversed(entry_axes(entry)):
                    if ax in self.fsdp_axes:
                        x = C.gather_param(x, self.mesh, ax, dim)
            return x
        return map_specs(one, tree, specs)


NULL_CTX = AxisCtx()


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


def _project(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` in the promoted type of the two, as JAX's matmul."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return a.to(dt) @ w.to(dt)


def attention_apply(p, x: torch.Tensor, *, n_heads: int, n_kv_heads: int,
                    head_dim: int, rope_theta: float,
                    positions: Optional[torch.Tensor] = None,
                    causal: bool = True, window: Optional[int] = None,
                    kv_inputs: Optional[torch.Tensor] = None,
                    ctx: AxisCtx = NULL_CTX) -> torch.Tensor:
    """Full-sequence attention of x (b, s, d): projections, B7 in the
    ``(b, h, s, dh)`` layout, output projection.  Self-attention ropes q
    and k at ``positions``.  With ``kv_inputs`` (b, sk, d) it is
    cross-attention: k and v are projected from ``kv_inputs``, nothing is
    roped, and no mask applies (the reference's ``kv_inputs``).  Like the
    reference, k and v are projected in the promoted type of
    ``kv_inputs`` and the weights (float32 embeddings into a bf16 model:
    float32); B7 takes one type, so they are then rounded to q's.

    With a model axis of more than one rank (``ctx``), ``p`` holds this
    rank's column blocks of q/k/v and row block of ``wo`` and B7 runs on
    its heads (`_local_kv`); the output is summed over the axis."""
    b, s, _ = x.shape
    # Replicated heads (fewer heads than ranks) run as on one device.
    tp = ctx.tp if p["wq"].shape[1] < n_heads * head_dim else 1
    if tp > 1:
        x = ctx.copy(x)
    kv_src = x if kv_inputs is None else kv_inputs
    sk = kv_src.shape[1]
    hq = p["wq"].shape[1] // head_dim
    q = (x @ p["wq"]).reshape(b, s, hq, head_dim)
    wk, wv, kv_map = p["wk"], p["wv"], None
    if tp > 1:
        wk, wv, kv_map = _local_kv(wk, wv, ctx, n_heads, n_kv_heads,
                                   head_dim)
    hkv = wk.shape[1] // head_dim
    k = _project(kv_src, wk).reshape(b, sk, hkv, head_dim)
    v = _project(kv_src, wv).reshape(b, sk, hkv, head_dim)
    k, v = k.to(q.dtype), v.to(q.dtype)
    if kv_map is not None:                # one kv head a local q head
        k, v = k[:, :, kv_map], v[:, :, kv_map]
    if kv_inputs is None:
        if positions is None:
            positions = torch.arange(s, device=x.device)
        q = rope(q, positions, rope_theta)
        k = rope(k, positions, rope_theta)
    out = flash_attention(q.transpose(1, 2).contiguous(),
                          k.transpose(1, 2).contiguous(),
                          v.transpose(1, 2).contiguous(),
                          causal=causal and kv_inputs is None, window=window)
    out = out.transpose(1, 2).reshape(b, s, hq * head_dim) @ p["wo"]
    return ctx.reduce(out) if tp > 1 else out


def _local_kv(wk: torch.Tensor, wv: torch.Tensor, ctx: AxisCtx,
              n_heads: int, n_kv_heads: int, head_dim: int):
    """The k and v weights of this rank's q heads under tensor
    parallelism: ``(wk, wv, kv_map)``.  Local q head j is global head
    ``r H/tp + j``; its kv head is ``(r H/tp + j) // (H/Hkv)``.  Where
    ``Hkv`` divides by the model axis the blocks are whole kv heads in
    order (``kv_map`` None).  Otherwise the weights are made whole (an
    all-gather over the axis when they are split there, a gradient summed
    over it when replicated), the kv heads this rank's q heads need are
    cut out, and ``kv_map`` gives each local q head its kv head where B7's
    GQA grouping cannot."""
    tp, r = ctx.tp, ctx.tp_rank
    full = n_kv_heads * head_dim
    if n_kv_heads % tp == 0 and wk.shape[1] * tp == full:
        return wk, wv, None
    if wk.shape[1] == full:                  # replicated over the axis
        wk, wv = ctx.copy(wk), ctx.copy(wv)
    else:                                    # split, not by whole heads
        wk = C.gather_param(wk, ctx.mesh, ctx.model_axis, 1, tag="tp")
        wv = C.gather_param(wv, ctx.mesh, ctx.model_axis, 1, tag="tp")
    hl, group = n_heads // tp, n_heads // n_kv_heads
    need = [(r * hl + j) // group for j in range(hl)]
    lo, hi = need[0], need[-1] + 1
    wk = wk[:, lo * head_dim:hi * head_dim]
    wv = wv[:, lo * head_dim:hi * head_dim]
    n = hi - lo
    if hl % n == 0 and need == [lo + j // (hl // n) for j in range(hl)]:
        return wk, wv, None
    return wk, wv, torch.tensor([i - lo for i in need], device=wk.device)


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


def mlp_apply(p, x: torch.Tensor, *, act: str, d_ff: int = 0,
              ctx: AxisCtx = NULL_CTX) -> torch.Tensor:
    """``wi`` is the up projection and ``wg`` the gate:
    swiglu ``silu(x wg) * (x wi)``, geglu ``gelu(x wg) * (x wi)``, gelu
    ``gelu(x wi)``; then ``@ wo``.  With a model axis of more than one
    rank (``ctx``) and ``wi`` narrower than ``d_ff``, ``wi``/``wg`` are
    column blocks and ``wo`` a row block, summed over the axis."""
    tp = ctx.tp if p["wi"].shape[1] < d_ff else 1
    if tp > 1:
        x = ctx.copy(x)
    h = x @ p["wi"]
    if act == "swiglu":
        h = F.silu(x @ p["wg"]) * h
    elif act == "geglu":
        h = _gelu(x @ p["wg"]) * h
    elif act == "gelu":
        h = _gelu(h)
    else:
        raise ValueError(f"unknown act {act!r}")
    out = h @ p["wo"]
    return ctx.reduce(out) if tp > 1 else out
