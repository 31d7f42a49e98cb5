"""Training step factory: loss -> gradients -> optimizer, with gradient
accumulation over microbatches.

The port of the JAX package's ``training/train_lib.py`` for one device.
`make_train_step` returns ``train_step(params, opt_state, batch, step) ->
(params, opt_state, metrics)``: ``cfg.microbatches`` slices of the batch,
each through `lm.lm_loss` and ``torch.autograd.grad``; with more than one,
the gradients are summed in float32 and divided by their count (one
microbatch keeps the parameters' dtype, as the reference's).  The
optimizer (`training.optimizer.opt_update`) then writes the new
parameters and moments into the given tensors.  The reference's
``jit_train_step`` (``jax.jit`` with donated buffers) has no counterpart:
PyTorch runs eagerly, and the in-place update is the donation.

The reference's ``TrainConfig.compress_pods``, ``compress_rank`` and
``log_every`` have no field here: its step reads none of them.  The mesh
half (``make_axis_ctx``, ``batch_sharding``, a step on a mesh, the
cross-pod compression) comes with the LM sharding rules of
``models/params.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.training import optimizer as opt

Tree = Any


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: opt.OptConfig = dataclasses.field(default_factory=opt.OptConfig)


def default_opt_config(cfg: ModelConfig) -> opt.OptConfig:
    """Adafactor for >= 100B parameters (Adam's state would not fit),
    AdamW below."""
    big = cfg.n_params() >= 100e9
    return opt.OptConfig(name="adafactor" if big else "adamw",
                         lr=1e-4 if big else 3e-4)


MESH_NOT_PORTED = (
    "an LM training step on a mesh is not ported yet: it needs the LM "
    "sharding half of models/params.py (partition_spec, tree_shardings), "
    "which comes with the next slice of repro_torch (the dry run); pass "
    "mesh=None")

COMPRESS_NOT_PORTED = (
    "cross-pod gradient compression for an LM is not ported: it is a "
    "collective of a step on a mesh (see MESH_NOT_PORTED); --compress "
    "applies to the GBDT's --dist fit only")


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(MESH_NOT_PORTED)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    mesh: Optional[Any] = None) -> Callable:
    """Returns ``train_step(params, opt_state, batch, step) -> (params,
    opt_state, metrics)``; ``metrics`` holds 0-d float32 tensors
    ``loss`` (the mean of the microbatches' losses), ``grad_norm`` (before
    clipping) and ``lr``.  ``batch`` holds (B, ...) tensors or arrays on
    the parameters' device, B divisible by ``cfg.microbatches``; ``step``
    is the step index.  The parameters are made to require gradients."""
    _no_mesh(mesh)
    mb = max(cfg.microbatches, 1)

    def train_step(params, opt_state, batch, step):
        leaves = opt.tree_leaves(params)
        for p in leaves:
            if not p.requires_grad:
                p.requires_grad_(True)
        n = batch["labels"].shape[0]
        if n % mb:
            raise ValueError(f"a batch of {n} rows does not split into "
                             f"{mb} microbatches")
        sz = n // mb
        loss_acc, acc = None, None
        for i in range(mb):
            sub = batch if mb == 1 else {
                k: v[i * sz:(i + 1) * sz] for k, v in batch.items()}
            loss, _ = lm.lm_loss(params, cfg, sub)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for g, p in zip(grads, leaves)]
            loss = loss.detach()
            if mb == 1:
                loss_acc, acc = loss, grads
            elif acc is None:
                loss_acc, acc = loss, [g.float() for g in grads]
            else:
                loss_acc = loss_acc + loss
                acc = [a + g.float() for a, g in zip(acc, grads)]
            del grads
        if mb > 1:                       # float32 sums, divided in place
            for a in acc:
                a.div_(mb)
            loss_acc = loss_acc / mb
        grads = opt.tree_unflatten(params, acc)
        del acc
        gnorm = opt.global_norm(grads)
        params, opt_state = opt.opt_update(grads, opt_state, params, step,
                                           tcfg.opt)
        metrics = {"loss": loss_acc, "grad_norm": gnorm,
                   "lr": opt.lr_schedule(tcfg.opt, step, gnorm.device)}
        return params, opt_state, metrics

    return train_step


def input_specs(cfg: ModelConfig, *, seq_len: int, global_batch: int,
                kind: str, mesh: Optional[Any] = None) -> Dict[str, Any]:
    """Stand-ins for every model input of a shape cell, as tensors on the
    ``meta`` device (shapes and dtypes, no storage).

    train/prefill: token (or stub-embedding) batch and labels (and a VLM's
    image embeddings).  decode: one new token; the cache is the caller's
    (`lm.init_cache` on the meta device)."""
    _no_mesh(mesh)
    b, s = global_batch, seq_len
    meta = dict(device="meta")
    if kind in ("train", "prefill"):
        if cfg.embed_inputs:
            inputs = torch.empty((b, s, cfg.d_model), dtype=torch.bfloat16,
                                 **meta)
        else:
            inputs = torch.empty((b, s), dtype=torch.int32, **meta)
        batch = {"inputs": inputs,
                 "labels": torch.empty((b, s), dtype=torch.int32, **meta)}
        if cfg.family == "vlm":
            batch["image_embeds"] = torch.empty(
                (b, cfg.n_image_tokens, cfg.d_model), dtype=torch.bfloat16,
                **meta)
        return batch
    if kind == "decode":
        if cfg.embed_inputs:
            tok = torch.empty((b, cfg.d_model), dtype=torch.bfloat16, **meta)
        else:
            tok = torch.empty((b,), dtype=torch.int32, **meta)
        return {"token": tok}
    raise ValueError(kind)
