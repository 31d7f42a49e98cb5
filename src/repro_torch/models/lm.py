"""Decoder-only LM: parameters, forward, prefill and one-token decode.

The port of the JAX package's ``models/lm.py`` for every family:
  dense / moe            pre-norm attention + (GLU-)MLP / MoE blocks
                         (`models.moe`);
  audio (musicgen)       the same backbone, embedding-frontend stub;
  vlm (llama-3.2-vision) standalone cross-attention blocks over the image
                         embeddings every ``cross_attn_every`` layers;
  ssm (mamba2)           Mamba2-SSD blocks (`models.ssm`), attention-free;
  hybrid (zamba2)        Mamba2 blocks + one *shared* attention block run
                         every ``attn_every`` layers.
The layers are split at the periodic sites into the reference's
`segments`.  Parameters are a tree of nested dicts of tensors, as the
reference's, except that ``blocks`` is a list of one dict per layer and
``cross`` one dict per site where the reference stacks them along a
leading axis (`init` draws them stacked and unstacks;
`io.convert.lm_params_from_arrays` unstacks the reference's).
`TransformerLM` holds such a tree as an ``nn.Module``.

``cfg.use_pallas`` is kept with the reference's default, so that configs
compare equal, but nothing branches on it: every attention (self, shared
and cross) runs B7 (`kernels.flash_attention`) in forward and prefill and
B8 (`kernels.decode_attention`) in decode, the VLM's image
cross-attention included, whose device picks the kernel or its plain
version.  ``attn_chunk``, ``causal_skip`` and ``scan_layers`` shape the
reference's compiled graph and have no counterpart here.  Forward,
prefill and decode run under ``torch.inference_mode()``; `lm_loss` records
gradients, and with ``cfg.remat`` runs each plain layer under
``torch.utils.checkpoint`` (`_remat`), so that B7's forward runs twice a
layer in a training step.  A
VLM's ``image_embeds`` keep their type: float32 embeddings into a bf16
model are projected to the cross k and v in float32, as in the reference,
and rounded to bf16 for B7 (`layers.attention_apply`).

The cache (`init_cache`) is the reference's: attention ``k`` and ``v``
stacked over layers, (L, b, s_alloc, hkv, dh), bf16 by default; for
ssm/hybrid each layer's float32 SSM ``state`` and convolution buffers,
stacked over layers, plus a hybrid's list of shared-attention site caches;
for a VLM the image ``k`` and ``v`` of each cross site.  Where the
reference keeps one ``length`` array per layer and site (always equal),
the port keeps one host int for the cache, so a decode step reads nothing
back from the card.  Like the reference's, `prefill` fills no cache: a
prompt enters it token by token through `decode_step`, and nothing fills
the image cache (the reference's neither).

For the dry run, `abstract` and `abstract_cache` give the parameters and
the cache as ``meta`` tensors with their partition specs on a mesh
(`sharding_rules`, `cache_pspecs`).

`lm_loss` also runs one rank's share of a training step on a mesh of
ranks (``ctx``, `layers.AxisCtx`): the parameters are this rank's blocks
(`params.shard_tree`), the batch this rank's rows.  The embedding, head,
final norm, shared block and cross sites are all-gathered over the FSDP
axes once, each layer's weights inside its block (so that `_remat`
gathers them again in the backward), and the layers run tensor-parallel
over ``model``.  The vocabulary is split over ``model`` too: the lookup
masks the ids outside this rank's rows and sums over the axis, the logits
stay split, and the log-softmax takes its max and its sum of exponentials
over the axis.  The loss is this rank's weighted sum over the weights'
global sum, so that the sum over the batch axes is the one-device loss.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint as ckpt
from torch import nn

from repro_torch.core.device import resolve_device
from repro_torch.distributed import collectives as C
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.models import layers as Ly
from repro_torch.models import moe as Moe
from repro_torch.models import ssm as Ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import (LOGICAL_RULES, ParamDecl,
                                       abstract_params, dp_only_rules,
                                       init_params, mesh_axes, stack)


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# Parameter declarations and sites
# ---------------------------------------------------------------------------

def _is_ssm(cfg: ModelConfig) -> bool:
    return cfg.family in ("ssm", "hybrid")


def _block_decls(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    if _is_ssm(cfg):
        return {
            "ln1": ParamDecl((d,), (None,), init="ones"),
            "ssm": Ssm.ssm_decls(d, cfg.d_inner, cfg.ssm_state,
                                 cfg.ssm_nheads, cfg.ssm_conv),
        }
    block = {
        "ln1": ParamDecl((d,), (None,), init="ones"),
        "attn": Ly.attention_decls(d, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.head_dim_),
        "ln2": ParamDecl((d,), (None,), init="ones"),
    }
    if cfg.n_experts:
        block["moe"] = Moe.moe_decls(d, cfg.d_ff, cfg.n_experts, cfg.act,
                                     cfg.moe_shard)
    else:
        block["mlp"] = Ly.mlp_decls(d, cfg.d_ff, cfg.act)
    return block


def _shared_attn_decls(cfg: ModelConfig) -> Dict[str, Any]:
    """The hybrid's one shared block; its MLP is always gelu, ``d_ff`` wide
    (``4 d_model`` when d_ff is 0)."""
    d = cfg.d_model
    return {
        "ln1": ParamDecl((d,), (None,), init="ones"),
        "attn": Ly.attention_decls(d, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.head_dim_),
        "ln2": ParamDecl((d,), (None,), init="ones"),
        "mlp": Ly.mlp_decls(d, cfg.d_ff or 4 * d, "gelu"),
    }


def _cross_decls(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    return {
        "ln": ParamDecl((d,), (None,), init="ones"),
        "attn": Ly.attention_decls(d, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.head_dim_),
        "gate": ParamDecl((1,), (None,), init="zeros"),
    }


def n_sites(cfg: ModelConfig) -> int:
    """Periodic sites: shared-attention runs (hybrid) or cross blocks."""
    every = cfg.attn_every if cfg.family == "hybrid" else cfg.cross_attn_every
    return -(-cfg.n_layers // every) if every else 0


def segments(cfg: ModelConfig) -> List[Tuple[Optional[int], int, int]]:
    """[(site index or None, first layer, end layer)] covering all layers;
    a site's block runs before its segment's layers."""
    every = (cfg.attn_every if cfg.family == "hybrid"
             else cfg.cross_attn_every if cfg.family == "vlm" else 0)
    if not every:
        return [(None, 0, cfg.n_layers)]
    return [(i, s, min(s + every, cfg.n_layers))
            for i, s in enumerate(range(0, cfg.n_layers, every))]


def param_decls(cfg: ModelConfig) -> Dict[str, Any]:
    d, v = cfg.d_model, cfg.padded_vocab
    decls: Dict[str, Any] = {
        "embed": ParamDecl((v, d), ("tp", "fsdp"), init="small_normal"),
        "blocks": stack(_block_decls(cfg), cfg.n_layers),
        "final_norm": ParamDecl((d,), (None,), init="ones"),
    }
    if not cfg.tie_embeddings:
        decls["lm_head"] = ParamDecl((v, d), ("tp", "fsdp"),
                                     init="small_normal")
    if cfg.family == "hybrid" and cfg.attn_every:
        decls["shared_attn"] = _shared_attn_decls(cfg)
    if cfg.family == "vlm" and cfg.cross_attn_every:
        decls["cross"] = stack(_cross_decls(cfg), n_sites(cfg))
    return decls


def unstack(tree, n: int) -> List[Any]:
    """A tree of (n, ...) tensors -> a list of n trees of (...) views."""
    if isinstance(tree, torch.Tensor):
        if tree.dim() == 0 or tree.shape[0] != n:
            raise ValueError(f"expected {n} stacked layers, got shape "
                             f"{tuple(tree.shape)}")
        return list(tree.unbind(0))
    per_key = {k: unstack(v, n) for k, v in tree.items()}
    return [{k: v[i] for k, v in per_key.items()} for i in range(n)]


def unstack_params(cfg: ModelConfig, params):
    """``blocks`` (over layers) and ``cross`` (over sites) of a stacked
    tree into lists, in place."""
    params["blocks"] = unstack(params["blocks"], cfg.n_layers)
    if "cross" in params:
        params["cross"] = unstack(params["cross"], n_sites(cfg))
    return params


def init(cfg: ModelConfig, generator: torch.Generator, device=None):
    """Random parameters (`params.init_params`) in the model dtype, norm
    weights and gates in float32, blocks and cross sites unstacked; on
    CUDA unless ``device`` names another device, drawn from ``generator``
    on it."""
    return unstack_params(cfg, init_params(param_decls(cfg), generator,
                                           model_dtype(cfg), device))


def _unstack_specs(tree, n: int) -> List[Any]:
    """A spec tree of stacked leaves -> a list of n trees without the
    leading (layer or site) entry."""
    if isinstance(tree, tuple):
        return [tree[1:] for _ in range(n)]
    per_key = {k: _unstack_specs(v, n) for k, v in tree.items()}
    return [{k: v[i] for k, v in per_key.items()} for i in range(n)]


def sharding_rules(cfg: ModelConfig, mesh=None):
    """Logical -> mesh axes for ``cfg`` on ``mesh``: `dp_only_rules` in
    ``dp_only`` mode; across pods the FSDP storage over ``("pod",
    "data")`` too; else `params.LOGICAL_RULES`."""
    if mesh is not None and cfg.tp_strategy == "dp_only":
        return dp_only_rules(mesh)
    if mesh is not None and "pod" in mesh_axes(mesh):
        return dict(LOGICAL_RULES, fsdp=("pod", "data"))
    return LOGICAL_RULES


def abstract(cfg: ModelConfig, mesh=None):
    """``(params, specs)``: the parameters as ``meta`` tensors in `init`'s
    layout (blocks and cross sites unstacked, norms and gates float32)
    and, with a mesh, their partition specs in the same layout (else
    None)."""
    values, specs = abstract_params(param_decls(cfg), model_dtype(cfg), mesh,
                                    rules=sharding_rules(cfg, mesh))
    values = unstack_params(cfg, values)
    if specs is not None:
        specs["blocks"] = _unstack_specs(specs["blocks"], cfg.n_layers)
        if "cross" in specs:
            specs["cross"] = _unstack_specs(specs["cross"], n_sites(cfg))
    return values, specs


# ---------------------------------------------------------------------------
# Blocks and forward
# ---------------------------------------------------------------------------

def _attn_kwargs(cfg: ModelConfig) -> Dict[str, Any]:
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim_, rope_theta=cfg.rope_theta)


def _moe_kwargs(cfg: ModelConfig) -> Dict[str, Any]:
    return dict(n_experts=cfg.n_experts, top_k=cfg.top_k, act=cfg.act,
                capacity_factor=cfg.capacity_factor,
                router_group=cfg.router_group,
                dispatch_mode=cfg.dispatch_mode, d_ff=cfg.d_ff)


def _ffn(bp, h: torch.Tensor, cfg: ModelConfig,
         ctx: Ly.AxisCtx = Ly.NULL_CTX) -> torch.Tensor:
    """The block's MLP, or its MoE layer on (B, S, D)."""
    if cfg.n_experts:
        return Moe.moe_apply(bp["moe"], h, ctx=ctx, **_moe_kwargs(cfg))
    return Ly.mlp_apply(bp["mlp"], h, act=cfg.act, d_ff=cfg.d_ff, ctx=ctx)


def _dense_block(bp, x: torch.Tensor, cfg: ModelConfig,
                 ctx: Ly.AxisCtx = Ly.NULL_CTX) -> torch.Tensor:
    h = Ly.rms_norm(x, bp["ln1"], cfg.norm_eps)
    h = Ly.attention_apply(bp["attn"], h, window=cfg.window, ctx=ctx,
                           **_attn_kwargs(cfg))
    x = x + h
    return x + _ffn(bp, Ly.rms_norm(x, bp["ln2"], cfg.norm_eps), cfg, ctx)


def _ssm_block(bp, x: torch.Tensor, cfg: ModelConfig,
               ctx: Ly.AxisCtx = Ly.NULL_CTX) -> torch.Tensor:
    h = Ly.rms_norm(x, bp["ln1"], cfg.norm_eps)
    return x + Ssm.ssm_apply(bp["ssm"], h, n_state=cfg.ssm_state,
                             n_heads=cfg.ssm_nheads,
                             head_dim=cfg.ssm_headdim, d_conv=cfg.ssm_conv,
                             chunk=cfg.ssm_chunk, ctx=ctx)


def _shared_attn_block(sp, x: torch.Tensor, cfg: ModelConfig,
                       ctx: Ly.AxisCtx = Ly.NULL_CTX) -> torch.Tensor:
    """The hybrid's shared block: causal attention without a window, then
    the gelu MLP."""
    h = Ly.rms_norm(x, sp["ln1"], cfg.norm_eps)
    x = x + Ly.attention_apply(sp["attn"], h, ctx=ctx, **_attn_kwargs(cfg))
    h = Ly.rms_norm(x, sp["ln2"], cfg.norm_eps)
    return x + Ly.mlp_apply(sp["mlp"], h, act="gelu",
                            d_ff=cfg.d_ff or 4 * cfg.d_model, ctx=ctx)


def _gate(cp, x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(cp["gate"].float()).to(x.dtype)


def _cross_block(cp, x: torch.Tensor, image_embeds: torch.Tensor,
                 cfg: ModelConfig,
                 ctx: Ly.AxisCtx = Ly.NULL_CTX) -> torch.Tensor:
    """Non-causal cross-attention over the image embeddings, added through
    ``tanh(gate)`` (0 at init)."""
    c = Ly.rms_norm(x, cp["ln"], cfg.norm_eps)
    c = Ly.attention_apply(cp["attn"], c, kv_inputs=image_embeds, ctx=ctx,
                           **_attn_kwargs(cfg))
    return x + _gate(cp, x) * c


def _vocab_split(table: torch.Tensor, cfg: ModelConfig,
                 ctx: Ly.AxisCtx) -> bool:
    """Whether ``table`` (embedding or head) is this rank's block of the
    vocabulary on a model axis of more than one rank."""
    return ctx.tp > 1 and table.shape[0] < cfg.padded_vocab


def embed_tokens(params, cfg: ModelConfig, inputs,
                 ctx: Ly.AxisCtx = Ly.NULL_CTX) -> torch.Tensor:
    """Token ids (B, S) -> embeddings, or, with ``embed_inputs``, the given
    (B, S, d_model) embeddings cast to the model dtype; then times
    ``sqrt(d_model)`` rounded to that dtype when ``embed_scale``.  With
    the vocabulary split over ``model`` each rank looks up the ids in its
    rows, zeros the others, and the lookups are summed over the axis."""
    embed = params["embed"]
    inputs = torch.as_tensor(inputs, device=embed.device)
    if cfg.embed_inputs:
        x = inputs.to(model_dtype(cfg))
    elif _vocab_split(embed, cfg, ctx):
        vl = embed.shape[0]
        ids = inputs.long() - ctx.tp_rank * vl
        inside = (ids >= 0) & (ids < vl)
        x = embed[ids.clamp(0, vl - 1)]
        x = torch.where(inside[..., None], x,
                        torch.zeros((), dtype=x.dtype, device=x.device))
        x = ctx.reduce(x)
    else:
        x = embed[inputs.long()]
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def logits_from_hidden(params, cfg: ModelConfig, x: torch.Tensor,
                       ctx: Ly.AxisCtx = Ly.NULL_CTX) -> torch.Tensor:
    """Final norm, then the head product in the model dtype, then float32,
    then the tanh soft cap when set: float32 logits over ``padded_vocab``
    (this rank's block of it when the head is split over ``model``)."""
    x = Ly.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    if _vocab_split(head, cfg, ctx):
        x = ctx.copy(x)
    logits = (x @ head.t()).float()
    if cfg.logit_softcap:
        cap = cfg.logit_softcap
        logits = cap * torch.tanh(logits / cap)
    return logits


def _image_embeds(params, cfg: ModelConfig, batch: Dict[str, Any]):
    if cfg.family != "vlm" or not cfg.cross_attn_every:
        return None
    if batch.get("image_embeds") is None:
        raise ValueError(f"{cfg.name} (family 'vlm') needs "
                         f"batch['image_embeds'] (B, n_image_tokens, "
                         f"d_model)")
    image = torch.as_tensor(batch["image_embeds"],
                            device=params["embed"].device)
    # Kept in the caller's type, as the reference does (the cross
    # projections promote); float64 becomes float32 as under JAX's default.
    return image.float() if image.dtype == torch.float64 else image


# Matrix products, which ``remat_policy="dots"`` keeps (the reference's
# ``dots_saveable``); everything else is recomputed.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(block, policy: str):
    """``block`` under activation checkpointing: the reference's
    ``jax.checkpoint`` of each plain layer (lm.py:210-215).  "nothing"
    keeps only the layer's input and recomputes the layer in the backward;
    "dots" also keeps the outputs of its matrix products."""
    if policy not in ("nothing", "dots"):
        raise ValueError(f"unknown remat_policy {policy!r}")
    extra = ({} if policy == "nothing" else dict(
        context_fn=functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)))

    def run(bp, x, cfg):
        return ckpt.checkpoint(block, bp, x, cfg, use_reentrant=False,
                               **extra)
    return run


# The leaves outside the layers, gathered once a step on a mesh.
_TOP = ("embed", "lm_head", "final_norm", "shared_attn", "cross")


def _gather_top(params, cfg: ModelConfig, ctx: Ly.AxisCtx):
    """``params`` with every leaf outside ``blocks`` gathered over the FSDP
    axes (the embedding left as it is where nothing reads it: an untied
    model fed embeddings)."""
    out = dict(params)
    for k in _TOP:
        if k not in params or (k == "embed" and cfg.embed_inputs
                               and not cfg.tie_embeddings):
            continue
        out[k] = ctx.gather(params[k], ctx.specs[k])
    return out


def _layer(block, ctx: Ly.AxisCtx, i: int):
    """Layer ``i``'s function ``(bp, x, cfg)``: ``block`` itself without a
    mesh, else ``block`` on the layer's weights gathered over the FSDP
    axes, under ``ctx``."""
    if ctx.mesh is None:
        return block
    spec = ctx.specs["blocks"][i]

    def run(bp, x, cfg):
        return block(ctx.gather(bp, spec), x, cfg, ctx)
    return run


def _hidden(params, cfg: ModelConfig, batch: Dict[str, Any],
            remat: bool = False,
            ctx: Ly.AxisCtx = Ly.NULL_CTX) -> torch.Tensor:
    """The last layer's output.  On a mesh (``ctx``) ``params`` holds the
    gathered leaves outside the layers (`_gather_top`) and each layer's
    blocks, gathered inside its (remat'd) function."""
    x = embed_tokens(params, cfg, batch["inputs"], ctx)
    image_embeds = _image_embeds(params, cfg, batch)
    block = _ssm_block if _is_ssm(cfg) else _dense_block
    for site, s0, s1 in segments(cfg):
        if site is not None and cfg.family == "hybrid":
            x = _shared_attn_block(params["shared_attn"], x, cfg, ctx)
        elif site is not None and cfg.family == "vlm":
            x = _cross_block(params["cross"][site], x, image_embeds, cfg,
                             ctx)
        for i in range(s0, s1):
            fn = _layer(block, ctx, i)
            if remat:
                fn = _remat(fn, cfg.remat_policy)
            x = fn(params["blocks"][i], x, cfg)
    return x


@torch.inference_mode()
def forward(params, cfg: ModelConfig, batch: Dict[str, Any]) -> torch.Tensor:
    """Full-sequence forward -> float32 logits (B, S, padded_vocab).
    ``batch["inputs"]``: token ids, or embeddings with ``embed_inputs``; a
    VLM's ``batch["image_embeds"]`` (B, n_image_tokens, d_model)."""
    return logits_from_hidden(params, cfg, _hidden(params, cfg, batch))


@torch.inference_mode()
def prefill(params, cfg: ModelConfig, batch: Dict[str, Any]) -> torch.Tensor:
    """Prefill = the forward's last-position logits (B, padded_vocab).  The
    head is applied to that position alone (the reference computes every
    position's logits, then keeps the last)."""
    return logits_from_hidden(params, cfg,
                              _hidden(params, cfg, batch)[:, -1])


def vocab_mask(cfg: ModelConfig, device=None) -> Optional[torch.Tensor]:
    """0 on real tokens and -1e30 on the padding of ``padded_vocab``, or
    None when there is no padding."""
    if cfg.padded_vocab == cfg.vocab_size:
        return None
    ids = torch.arange(cfg.padded_vocab, device=device)
    return torch.where(ids < cfg.vocab_size, 0.0, -1e30)


def _split_label_logp(logits: torch.Tensor, labels: torch.Tensor,
                      ctx: Ly.AxisCtx) -> torch.Tensor:
    """The labels' log-probabilities from this rank's block of the logits
    (vocabulary split over ``model``): the max and the sum of exponentials
    over the axis, the label's logit from the rank that holds it."""
    mesh, axis = ctx.mesh, ctx.model_axis
    vl = logits.shape[-1]
    m = C.all_reduce_max(logits.detach().amax(-1), mesh, axis, tag="loss")
    se = C.reduce_from((logits - m[..., None]).exp().sum(-1), mesh, axis,
                       tag="loss")
    local = labels - ctx.tp_rank * vl
    inside = (local >= 0) & (local < vl)
    lab = logits.gather(-1, local.clamp(0, vl - 1)[..., None])[..., 0]
    lab = torch.where(inside, lab, torch.zeros((), device=lab.device))
    lab = C.reduce_from(lab, mesh, axis, tag="loss")
    return lab - (m + se.log())


def lm_loss(params, cfg: ModelConfig, batch: Dict[str, Any],
            ctx: Optional[Ly.AxisCtx] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Mean next-token cross-entropy, recording gradients: the forward
    (each plain layer under `_remat` when ``cfg.remat``), the vocab mask
    added to the float32 logits, a float32 log-softmax, the labels'
    log-probabilities weighted by ``batch["loss_mask"]`` (ones when
    absent) and divided by the weights' sum (at least 1).  Returns
    ``(loss, {"ce": loss})``; as in the reference, no MoE load-balance
    term is added (`moe.moe_aux_loss` is not called).

    On a mesh (``ctx``) ``params`` are this rank's blocks and ``batch``
    its rows; the weights' sum is taken over the batch axes, so that the
    returned loss is this rank's share: summed over the batch axes it is
    the one-device loss of the global batch."""
    ctx = ctx or Ly.NULL_CTX
    if ctx.mesh is not None:
        params = _gather_top(params, cfg, ctx)
    logits = logits_from_hidden(
        params, cfg, _hidden(params, cfg, batch, remat=cfg.remat, ctx=ctx),
        ctx)
    split = ctx.tp > 1 and logits.shape[-1] < cfg.padded_vocab
    mask = vocab_mask(cfg, device=logits.device)
    if mask is not None:
        if split:
            vl = logits.shape[-1]
            mask = mask[ctx.tp_rank * vl:(ctx.tp_rank + 1) * vl]
        logits = logits + mask
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    if split:
        picked = _split_label_logp(logits, labels, ctx)
    else:
        logp = torch.log_softmax(logits, dim=-1)
        picked = logp.gather(-1, labels[..., None])[..., 0]
    weights = batch.get("loss_mask")
    weights = (torch.ones_like(picked) if weights is None else
               torch.as_tensor(weights, device=logits.device).to(picked.dtype))
    den = weights.sum()
    if ctx.mesh is not None:
        for ax in ctx.batch_axes:
            den = C.all_reduce(den, ctx.mesh, ax, tag="loss")
    loss = -(picked * weights).sum() / den.clamp_min(1.0)
    return loss, {"ce": loss}


# ---------------------------------------------------------------------------
# Caches and decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """A zeroed cache for ``batch`` sequences of up to ``s_max`` tokens, on
    CUDA unless ``device`` names another device, ``length`` 0:
      attention layers  ``layers``: ``k``, ``v`` (L, batch, s_alloc, hkv,
                        dh), ``s_alloc = min(s_max, window)`` with a window
                        (a ring that decodes past ``s_max``), ``s_max``
                        without;
      ssm / hybrid      ``layers``: `ssm.ssm_cache` stacked over L (float32
                        ``state``, convolution buffers in ``dtype``);
                        a hybrid also ``shared_attn``, one ``{k, v}`` of
                        (batch, s_max, hkv, dh) a site;
      vlm               also ``image_kv``: ``k``, ``v`` (sites, batch,
                        n_image_tokens, hkv, dh), zeros until the caller
                        fills them."""
    device = resolve_device(device)
    if _is_ssm(cfg):
        cache: Dict[str, Any] = {"layers": Ssm.ssm_cache(
            batch, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state,
            cfg.ssm_conv, cfg.d_inner, dtype, device=device,
            n_layers=cfg.n_layers), "length": 0}
        if cfg.family == "hybrid" and cfg.attn_every:
            cache["shared_attn"] = []
            for _ in range(n_sites(cfg)):
                site = Ly.attention_cache(batch, s_max, cfg.n_kv_heads,
                                          cfg.head_dim_, dtype,
                                          device=device)
                cache["shared_attn"].append({"k": site["k"],
                                             "v": site["v"]})
        return cache
    one = Ly.attention_cache(batch, s_max, cfg.n_kv_heads, cfg.head_dim_,
                             dtype, window=cfg.window, device=device,
                             n_layers=cfg.n_layers)
    cache = {"layers": {"k": one["k"], "v": one["v"]}, "length": 0}
    if cfg.family == "vlm" and cfg.cross_attn_every:
        shape = (n_sites(cfg), batch, cfg.n_image_tokens, cfg.n_kv_heads,
                 cfg.head_dim_)
        cache["image_kv"] = {
            n: torch.zeros(shape, dtype=dtype, device=device) for n in "kv"}
    return cache


def cache_pspecs(cfg: ModelConfig, batch: int, mesh,
                 batch_axes: Tuple[str, ...] = ("data",),
                 model_axis: str = "model") -> Dict[str, Any]:
    """Partition specs of `init_cache`'s tensors (its host-int ``length``
    has none): the batch over ``batch_axes`` when divisible, else
    replicated (long_500k's batch of 1); kv heads over ``model_axis`` when
    divisible, else the cache's sequence (slots) over it; SSM state heads
    and the x convolution's channels over ``model_axis``.  A spec may name
    an axis its dimension does not divide by; `abstract_cache` drops it
    there."""
    sizes = mesh_axes(mesh)
    tp = sizes[model_axis]
    nrow = 1
    for a in batch_axes:
        nrow *= sizes[a]
    baxes = batch_axes if len(batch_axes) > 1 else batch_axes[0]
    b_ax = baxes if batch % nrow == 0 else None

    def attn_kv(stacked: bool) -> Tuple:
        kv_ax = model_axis if cfg.n_kv_heads % tp == 0 else None
        seq_ax = model_axis if kv_ax is None else None
        spec = (b_ax, seq_ax, kv_ax, None)
        return (None, *spec) if stacked else spec

    if _is_ssm(cfg):
        h_ax = model_axis if cfg.ssm_nheads % tp == 0 else None
        di_ax = model_axis if cfg.d_inner % tp == 0 else None
        pspecs: Dict[str, Any] = {"layers": {
            "state": (None, b_ax, h_ax, None, None),
            "conv_x": (None, b_ax, None, di_ax),
            "conv_B": (None, b_ax, None, None),
            "conv_C": (None, b_ax, None, None),
        }}
        if cfg.family == "hybrid" and cfg.attn_every:
            pspecs["shared_attn"] = [
                {"k": attn_kv(False), "v": attn_kv(False)}
                for _ in range(n_sites(cfg))]
        return pspecs
    pspecs = {"layers": {"k": attn_kv(True), "v": attn_kv(True)}}
    if cfg.family == "vlm" and cfg.cross_attn_every:
        kv_ax = model_axis if cfg.n_kv_heads % tp == 0 else None
        pspecs["image_kv"] = {"k": (None, b_ax, None, kv_ax, None),
                              "v": (None, b_ax, None, kv_ax, None)}
    return pspecs


def _fit_spec(shape, spec: Tuple, mesh) -> Tuple:
    """``spec`` with each axis its dimension does not divide by dropped."""
    sizes = mesh_axes(mesh)
    names = list(spec) + [None] * (len(shape) - len(spec))
    fixed = []
    for dim, ax in zip(shape, names):
        n = 1
        for a in (() if ax is None else ax if isinstance(ax, tuple)
                  else (ax,)):
            n *= sizes[a]
        fixed.append(ax if dim % n == 0 else None)
    return tuple(fixed)


def abstract_cache(cfg: ModelConfig, batch: int, s_max: int, mesh=None,
                   batch_axes: Tuple[str, ...] = ("data",),
                   model_axis: str = "model", dtype=torch.bfloat16):
    """``(cache, specs)``: `init_cache` on the ``meta`` device (no
    storage) and, with a mesh, each tensor's partition spec
    (`cache_pspecs` fitted to the allocated shapes; else None)."""
    cache = init_cache(cfg, batch, s_max, dtype, device="meta")
    if mesh is None:
        return cache, None
    specs = cache_pspecs(cfg, batch, mesh, batch_axes, model_axis)

    def fit(c, sp):
        if isinstance(sp, tuple):
            return _fit_spec(c.shape, sp, mesh)
        if isinstance(sp, list):
            return [fit(ci, si) for ci, si in zip(c, sp)]
        return {k: fit(c[k], v) for k, v in sp.items()}
    return cache, fit(cache, specs)


def _layer_decode(bp, x: torch.Tensor, layers, i: int, length: int,
                  cfg: ModelConfig) -> torch.Tensor:
    """Layer ``i`` of a decode step; its cache is updated in place."""
    h = Ly.rms_norm(x, bp["ln1"], cfg.norm_eps)
    if _is_ssm(cfg):
        lc = {k: t[i] for k, t in layers.items()}
        h, _ = Ssm.ssm_decode(bp["ssm"], h, lc, n_state=cfg.ssm_state,
                              n_heads=cfg.ssm_nheads,
                              head_dim=cfg.ssm_headdim)
        return x + h
    lc = {"k": layers["k"][i], "v": layers["v"][i], "length": length}
    h, _ = Ly.attention_decode(bp["attn"], h, lc, window=cfg.window,
                               **_attn_kwargs(cfg))
    x = x + h
    h = Ly.rms_norm(x, bp["ln2"], cfg.norm_eps)
    if cfg.n_experts:
        return x + Moe.moe_apply(bp["moe"], h[:, None],
                                 **_moe_kwargs(cfg))[:, 0]
    return x + Ly.mlp_apply(bp["mlp"], h, act=cfg.act)


def _shared_attn_decode(sp, x: torch.Tensor, sc, length: int,
                        cfg: ModelConfig) -> torch.Tensor:
    h = Ly.rms_norm(x, sp["ln1"], cfg.norm_eps)
    h, _ = Ly.attention_decode(sp["attn"], h, dict(sc, length=length),
                               **_attn_kwargs(cfg))
    x = x + h
    h = Ly.rms_norm(x, sp["ln2"], cfg.norm_eps)
    return x + Ly.mlp_apply(sp["mlp"], h, act="gelu")


def _cross_decode(cp, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """The token's query against a site's whole image cache (B8, no
    window, no RoPE), added through ``tanh(gate)``."""
    b = x.shape[0]
    c = Ly.rms_norm(x, cp["ln"], cfg.norm_eps)
    q = (c @ cp["attn"]["wq"]).reshape(b, cfg.n_heads, cfg.head_dim_)
    o = decode_attention(q, k, v, k.shape[1])
    o = o.reshape(b, cfg.n_heads * cfg.head_dim_) @ cp["attn"]["wo"]
    return x + _gate(cp, x) * o


@torch.inference_mode()
def decode_step(params, cfg: ModelConfig, cache: Dict[str, Any],
                token_or_embed):
    """One token per sequence: (B,) ids, or (B, d_model) embeddings with
    ``embed_inputs`` -> (float32 logits (B, padded_vocab), cache).  The
    returned cache is the same dict, updated in place: each attention
    layer's and site's new k and v written at its slot, each SSM layer's
    state and convolution buffers replaced, ``length`` one more."""
    x = embed_tokens(params, cfg, token_or_embed)
    length = int(cache["length"])
    layers = cache["layers"]
    for site, s0, s1 in segments(cfg):
        if site is not None and cfg.family == "hybrid":
            x = _shared_attn_decode(params["shared_attn"], x,
                                    cache["shared_attn"][site], length, cfg)
        elif site is not None and cfg.family == "vlm":
            ik = cache["image_kv"]
            x = _cross_decode(params["cross"][site], x, ik["k"][site],
                              ik["v"][site], cfg)
        for i in range(s0, s1):
            x = _layer_decode(params["blocks"][i], x, layers, i, length, cfg)
    cache["length"] = length + 1
    return logits_from_hidden(params, cfg, x), cache


# ---------------------------------------------------------------------------
# nn.Module
# ---------------------------------------------------------------------------

_LISTS = ("blocks", "cross")      # subtrees kept as one dict per layer / site


def _flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    out: Dict[str, torch.Tensor] = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _unflatten(flat: Dict[str, torch.Tensor]):
    tree: Dict[str, Any] = {}
    for name, t in flat.items():
        node = tree
        *path, leaf = name.split("/")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t
    for key in _LISTS:
        if key in tree:
            tree[key] = [tree[key][str(i)] for i in range(len(tree[key]))]
    return tree


class TransformerLM(nn.Module):
    """``cfg`` and its parameter tree as an ``nn.Module``: the leaves are
    parameters without gradients under ``/``-joined names
    (``blocks/3/attn/wq``, ``cross/1/gate``), so ``.to(device)`` and
    ``state_dict`` work as usual.  `random` builds one from a
    ``torch.Generator``."""

    def __init__(self, cfg: ModelConfig, params):
        super().__init__()
        self.cfg = cfg
        self.weights = nn.ParameterDict({
            k: nn.Parameter(v, requires_grad=False)
            for k, v in _flatten(params).items()})

    @classmethod
    def random(cls, cfg: ModelConfig, generator: torch.Generator,
               device=None) -> "TransformerLM":
        return cls(cfg, init(cfg, generator, device))

    @property
    def params(self):
        return _unflatten(dict(self.weights.items()))

    def forward(self, batch: Dict[str, Any]) -> torch.Tensor:
        return forward(self.params, self.cfg, batch)

    def prefill(self, batch: Dict[str, Any]) -> torch.Tensor:
        return prefill(self.params, self.cfg, batch)

    def init_cache(self, batch: int, s_max: int,
                   dtype=torch.bfloat16) -> Dict[str, Any]:
        """`init_cache` on the module's device."""
        return init_cache(self.cfg, batch, s_max, dtype,
                          device=self.weights["embed"].device)

    def decode_step(self, cache: Dict[str, Any], token_or_embed):
        return decode_step(self.params, self.cfg, cache, token_or_embed)
