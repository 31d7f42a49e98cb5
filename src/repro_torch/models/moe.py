"""Top-k Mixture-of-Experts layer (grok-1: 8 experts top-2, phi-3.5-moe: 16
experts top-2).

The port of the JAX package's ``models/moe.py``.  Routing is the
reference's, group by group: tokens are routed in groups of ``g =
min(router_group, t)`` tokens (halved until g divides t), each expert takes
at most ``cap = max(int(capacity_factor * g * top_k / n_experts), 1)``
tokens of a group, first choices before second choices and earlier tokens
first, and a (token, choice) past its expert's capacity contributes 0.  The
slot of each (token, choice) is the reference's exactly (`_slot_positions`).

Tokens move by index, not by the reference's dense one-hot products: each
in-capacity (token, choice) is scattered into its expert's slot of a
zeroed (G, E, C, D) buffer, every expert's (GLU-)MLP runs over its C slots
of every group as one batched product, and each (token, choice) gathers its
slot back.  The two ``dispatch_mode``s keep the reference's casts of the
combine: ``einsum`` rounds the gate weights to the model dtype before the
weighted sum (``moe.py:168``), ``gather`` weighs in float32 and casts the
sum (``moe.py:154-157``); both sum a token's (at most ``top_k``) products
in float32 and round once.  The reference's ``moe_shard`` shapes only the
sharding of the declarations (`moe_decls`) and changes nothing on one
device, so `moe_apply` does not take it.

On a mesh (``ctx``, a model axis of more than one rank) every rank routes
every token of its data shard, so the plan (`moe_plan`: choices, slots,
drops) is the one-device plan on the same tokens.  With the experts split
over ``model`` (``moe_shard="ep"``, `_moe_ep`) each rank owns a contiguous
share of the tokens: it fills its tokens' slots, an all-to-all brings
each expert's slots to the rank that holds it, and a second all-to-all
returns the outputs to their tokens' owners, which combine them and
all-gather the tokens.  With each expert's ``d_ff`` split (``"tp"``) every
rank runs every slot through its block of every expert and the combined
tokens are summed over ``model``.  The gate values enter the combine
through `collectives.copy_to`, as each rank's combine sees part of them.

``torch.topk`` does not say which of two equal probabilities it takes
first; ``jax.lax.top_k`` takes the lower index, so `_route` sorts stably.
No Pallas kernel is involved in the reference, and none here: the
dispatch is plain PyTorch and the expert products ``torch.matmul``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as C
from repro_torch.models.params import ParamDecl


def moe_decls(d_model: int, d_ff: int, n_experts: int, act: str,
              moe_shard: str = "ep") -> Dict[str, ParamDecl]:
    e_ax, f_ax = ("ep", None) if moe_shard == "ep" else (None, "tp")
    decls = {
        "router": ParamDecl((d_model, n_experts), (None, None),
                            init="small_normal"),
        "wi": ParamDecl((n_experts, d_model, d_ff), (e_ax, "fsdp", f_ax)),
        "wo": ParamDecl((n_experts, d_ff, d_model), (e_ax, f_ax, "fsdp")),
    }
    if act in ("swiglu", "geglu"):
        decls["wg"] = ParamDecl((n_experts, d_model, d_ff),
                                (e_ax, "fsdp", f_ax))
    return decls


def _route(tokens: torch.Tensor, router: torch.Tensor,
           top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float32 router softmax over (T, E), then the ``top_k`` largest
    probabilities of each token, ties to the lower expert index, divided
    by their sum: (gate values float32 (T, k), expert ids int64 (T, k))."""
    probs = torch.softmax(tokens.float() @ router.float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :top_k], idx[:, :top_k]
    return vals / vals.sum(-1, keepdim=True).clamp_min(1e-9), idx


def _slot_positions(gidx: torch.Tensor, n_experts: int, top_k: int,
                    cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(G, g, k) expert choices -> (slot within the expert's capacity
    int32 (G, g, k), in_cap bool (G, g, k)).  A choice's slot is the number
    of earlier choices of the same expert in its group, choices ordered
    first choice before second, earlier tokens first."""
    n_groups, g, _ = gidx.shape
    flat = gidx.transpose(1, 2).reshape(n_groups, top_k * g)
    onehot = F.one_hot(flat, n_experts)                      # (G, k*g, E)
    before = onehot.cumsum(1) - onehot
    slot = before.gather(2, flat[..., None])[..., 0]
    slot = slot.reshape(n_groups, top_k, g).transpose(1, 2).to(torch.int32)
    return slot.contiguous(), slot < cap


def _expert_ffn(xe: torch.Tensor, p, act: str) -> torch.Tensor:
    """(E, N, D) slots through every expert's (GLU-)MLP -> (E, N, D)."""
    h = torch.bmm(xe, p["wi"])
    if act in ("swiglu", "geglu"):
        gate = torch.bmm(xe, p["wg"]).float()
        nl = F.silu(gate) if act == "swiglu" else F.gelu(gate,
                                                         approximate="tanh")
        h = nl.to(h.dtype) * h
    else:
        h = F.gelu(h.float(), approximate="tanh").to(h.dtype)
    return torch.bmm(h, p["wo"])


def moe_plan(x: torch.Tensor, router: torch.Tensor, *, n_experts: int,
             top_k: int, capacity_factor: float = 2.0,
             router_group: int = 1024) -> Dict[str, torch.Tensor]:
    """The routing of x (B, S, D): group size ``g``, capacity ``cap``, and
    per (group, token, choice) the gate value ``gval`` (float32), the
    expert ``gidx``, the ``slot`` and ``in_cap``, each (G, g, k)."""
    t = x.shape[0] * x.shape[1]
    g = min(router_group, t)
    while t % g:
        g //= 2
    n_groups = t // g
    cap = max(int(capacity_factor * g * top_k / n_experts), 1)
    gval, gidx = _route(x.reshape(t, x.shape[-1]), router, top_k)
    gidx = gidx.reshape(n_groups, g, top_k)
    slot, in_cap = _slot_positions(gidx, n_experts, top_k, cap)
    return dict(g=g, cap=cap, gval=gval.reshape(n_groups, g, top_k),
                gidx=gidx, slot=slot, in_cap=in_cap)


def moe_apply(p, x: torch.Tensor, *, n_experts: int, top_k: int, act: str,
              capacity_factor: float = 2.0, router_group: int = 1024,
              dispatch_mode: str = "einsum", d_ff: int = 0,
              ctx=None) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D), the load-balance loss aside
    (`moe_aux_loss`).  ``ctx`` (`layers.AxisCtx`) with a model axis of
    more than one rank runs the layer split over it (`_moe_ep` when ``p``
    holds a block of the experts, the ``d_ff`` split when it holds a block
    of each expert's ``d_ff``; replicated experts run as on one
    device)."""
    if dispatch_mode not in ("einsum", "gather"):
        raise ValueError(f"unknown dispatch_mode {dispatch_mode!r}")
    b, s, d = x.shape
    plan = moe_plan(x, p["router"], n_experts=n_experts, top_k=top_k,
                    capacity_factor=capacity_factor,
                    router_group=router_group)
    tp = 1 if ctx is None else ctx.tp
    if tp > 1 and p["wi"].shape[0] < n_experts:
        return _moe_ep(p, x, plan, n_experts, top_k, act, dispatch_mode, ctx)
    split_ff = tp > 1 and p["wi"].shape[2] < d_ff
    cap, g, slot, in_cap = plan["cap"], plan["g"], plan["slot"], plan["in_cap"]
    n_groups, n_slots = slot.shape[0], n_experts * cap
    # Each (token, choice)'s row of its group's (E * C) slots; a dropped one
    # goes to the extra last row, which nothing reads.
    dst = torch.where(in_cap, plan["gidx"] * cap + slot, n_slots)
    dst = dst.reshape(n_groups, g * top_k)
    if split_ff:
        x = ctx.copy(x)
    src = x.reshape(n_groups, g, 1, d).expand(n_groups, g, top_k, d)
    xe = x.new_zeros(n_groups, n_slots + 1, d)
    xe.scatter_(1, dst[..., None].expand(-1, -1, d),
                src.reshape(n_groups, g * top_k, d))
    xe = xe[:, :n_slots].reshape(n_groups, n_experts, cap, d)
    ye = _expert_ffn(xe.transpose(0, 1).reshape(n_experts, -1, d), p, act)
    ye = ye.reshape(n_experts, n_groups, cap, d).transpose(0, 1)
    ye = ye.reshape(n_groups, n_slots, d)
    picked = ye.gather(1, dst.clamp_max(n_slots - 1)[..., None]
                       .expand(-1, -1, d)).reshape(n_groups, g, top_k, d)
    gval = ctx.copy(plan["gval"]) if split_ff else plan["gval"]
    w = gval * in_cap
    if dispatch_mode == "einsum":
        w = w.to(x.dtype)
    y = (picked.float() * w.float()[..., None]).sum(2).to(x.dtype)
    y = y.reshape(b, s, d)
    return ctx.reduce(y) if split_ff else y


def _moe_ep(p, x: torch.Tensor, plan, n_experts: int, top_k: int, act: str,
            dispatch_mode: str, ctx) -> torch.Tensor:
    """The MoE layer with the experts split over the model axis: rank r
    holds experts ``[r E/tp, (r+1) E/tp)`` and owns tokens ``[r t/tp,
    (r+1) t/tp)`` of the flattened (B S) tokens.  Its tokens' slots
    travel to their experts' ranks and back by two all-to-alls of (tp, G,
    E/tp, C, D) buffers (zero where a slot is not the destination's), and
    its combined tokens are all-gathered."""
    b, s, d = x.shape
    mesh, axis, tp, r = ctx.mesh, ctx.model_axis, ctx.tp, ctx.tp_rank
    t = b * s
    if t % tp:
        raise ValueError(f"{t} tokens do not split over {tp} expert ranks")
    cap, g, slot, in_cap = plan["cap"], plan["g"], plan["slot"], plan["in_cap"]
    n_groups, n_slots = slot.shape[0], n_experts * cap
    el = p["wi"].shape[0]
    own = t // tp
    owner = (torch.arange(t, device=x.device) // own).reshape(n_groups, g, 1)
    owner = owner.expand(n_groups, g, top_k)
    dst = torch.where(in_cap, plan["gidx"] * cap + slot, n_slots)
    # The rank whose token fills each slot (-1: an empty slot).
    slot_owner = torch.full((n_groups, n_slots + 1), -1, dtype=torch.int64,
                            device=x.device)
    slot_owner.scatter_(1, dst.reshape(n_groups, -1),
                        owner.reshape(n_groups, -1))
    slot_owner = slot_owner[:, :n_slots].reshape(n_groups, tp, el, cap)
    mine = torch.where(owner == r, dst, n_slots).reshape(n_groups, -1)
    x = ctx.copy(x)
    src = x.reshape(n_groups, g, 1, d).expand(n_groups, g, top_k, d)
    xe = x.new_zeros(n_groups, n_slots + 1, d)
    xe.scatter_(1, mine[..., None].expand(-1, -1, d),
                src.reshape(n_groups, g * top_k, d))
    xe = xe[:, :n_slots].reshape(n_groups, tp, el, cap, d).transpose(0, 1)
    recv = C.all_to_all_grad(xe.contiguous(), mesh, axis, tag="ep")
    xl = recv.sum(0)                       # one owner a slot: exact
    ye = _expert_ffn(xl.transpose(0, 1).reshape(el, -1, d), p, act)
    ye = ye.reshape(el, n_groups, cap, d).transpose(0, 1)   # (G, el, C, D)
    ranks = torch.arange(tp, device=x.device).reshape(tp, 1, 1, 1)
    dest = (slot_owner[:, r][None] == ranks)[..., None]
    send = torch.where(dest, ye[None], torch.zeros((), dtype=ye.dtype,
                                                   device=ye.device))
    back = C.all_to_all_grad(send, mesh, axis, tag="ep")   # (tp, G, el, C, D)
    ye = back.transpose(0, 1).reshape(n_groups * n_slots, d)
    rows = torch.arange(r * own, (r + 1) * own, device=x.device)
    idx = (rows // g)[:, None] * n_slots + dst.reshape(t, top_k)[rows] \
        .clamp_max(n_slots - 1)
    picked = ye[idx]                                       # (own, k, D)
    w = (ctx.copy(plan["gval"]) * in_cap).reshape(t, top_k)[rows]
    if dispatch_mode == "einsum":
        w = w.to(x.dtype)
    y = (picked.float() * w.float()[..., None]).sum(1).to(x.dtype)
    return C.gather_rows(y, mesh, axis, 0, tag="ep").reshape(b, s, d)


def moe_aux_loss(p, x: torch.Tensor, *, n_experts: int,
                 top_k: int) -> torch.Tensor:
    """Switch-style load-balancing loss: E * sum_e f_e * p_e (f_e the share
    of tokens whose first choice is e, p_e the mean router probability)."""
    tokens = x.reshape(-1, x.shape[-1]).float()
    probs = torch.softmax(tokens @ p["router"].float(), dim=-1)
    frac = F.one_hot(probs.argmax(-1), n_experts).float().mean(0)
    return n_experts * (frac * probs.mean(0)).sum()
