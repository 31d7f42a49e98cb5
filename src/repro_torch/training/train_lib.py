"""Training step factory: loss -> gradients -> optimizer, with gradient
accumulation over microbatches.

The port of the JAX package's ``training/train_lib.py``.
`make_train_step` returns ``train_step(params, opt_state, batch, step) ->
(params, opt_state, metrics)``: ``cfg.microbatches`` slices of the batch,
each through `lm.lm_loss` and ``torch.autograd.grad``; with more than one,
the gradients are summed in float32 and divided by their count (one
microbatch keeps the parameters' dtype, as the reference's).  The
optimizer (`training.optimizer.opt_update`) then writes the new
parameters and moments into the given tensors.  The reference's
``jit_train_step`` (``jax.jit`` with donated buffers) has no counterpart:
PyTorch runs eagerly, and the in-place update is the donation.

On a mesh of ranks (`launch.mesh.Mesh`) the step is one rank's share:
``params`` and ``opt_state`` are this rank's blocks (`params.shard_tree`
on `mesh_specs`; `opt_init` with `mesh_layout`), ``batch`` its rows
(`local_batch`).  Each layer's weights are all-gathered over the FSDP
axes when the layer runs and the layers run tensor-parallel over
``model`` (`lm.lm_loss` with `make_axis_ctx`); each gradient is
reduce-scattered over the FSDP axes that split it (the gathers'
backward) and all-reduced over the batch axes that do not.  ``dp_only``
puts the batch and the storage over every axis, with no tensor
parallelism.  The loss is the one-device loss of the global batch, and at
mesh (1, 1) every collective has one rank and the step is the ``mesh=None``
step bit for bit.

The reference's ``TrainConfig.compress_pods``, ``compress_rank`` and
``log_every`` have no field here: its step reads none of them
(`COMPRESS_NOT_PORTED`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.distributed import collectives as C
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import AxisCtx
from repro_torch.models.params import (batch_axes, entry_axes, mesh_axes,
                                       spec_entry)
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


COMPRESS_NOT_PORTED = (
    "--compress has nothing to port for an LM: the reference's LM step "
    "reads neither TrainConfig.compress_pods nor compress_rank, so its "
    "--compress changes no number; --compress applies to the GBDT's "
    "--dist fit (the histogram collective's sketch)")


def make_axis_ctx(mesh, cfg: ModelConfig) -> AxisCtx:
    """The step's layout on ``mesh``: the batch over `params.batch_axes`,
    heads and FFN over ``model`` (over nothing in ``dp_only`` mode), the
    FSDP storage over `lm.sharding_rules`' axes; on a mesh of ranks also
    the parameters' partition specs (`mesh_specs`)."""
    if mesh is None:
        return AxisCtx()
    dp_only = cfg.tp_strategy == "dp_only"
    fsdp = tuple(entry_axes(lm.sharding_rules(cfg, mesh).get("fsdp")))
    specs = None if isinstance(mesh, AbstractMesh) else mesh_specs(cfg, mesh)
    return AxisCtx(mesh=mesh, batch_axes=batch_axes(mesh, dp_only),
                   model_axis=None if dp_only else "model",
                   fsdp_axes=fsdp, specs=specs)


def mesh_specs(cfg: ModelConfig, mesh):
    """The parameters' partition specs on ``mesh``, in `lm.init`'s layout
    (`lm.abstract`)."""
    return lm.abstract(cfg, mesh)[1]


def mesh_layout(cfg: ModelConfig, mesh) -> Optional[opt.Layout]:
    """The optimizer's view of the blocks on ``mesh`` (None without)."""
    return None if mesh is None else opt.Layout(mesh, mesh_specs(cfg, mesh))


def local_batch(batch: Dict[str, Any], mesh, cfg: ModelConfig):
    """This rank's rows of a global batch on ``mesh``: the block of the
    batch axes (rows ``[n/k i, n/k (i+1))``, as `data.ShardedPrefetcher`
    cuts them), on the mesh's device."""
    if mesh is None:
        return batch
    i, k = mesh.block_index(batch_axes(mesh, cfg.tp_strategy == "dp_only"))
    out = {}
    for name, v in batch.items():
        v = torch.as_tensor(v)
        n = v.shape[0] // k
        out[name] = v[i * n:(i + 1) * n].to(mesh.device)
    return out


def make_grad_fn(cfg: ModelConfig, mesh=None) -> Callable:
    """``grad_fn(params, batch) -> (loss, grads)``: the microbatches'
    mean loss and gradients (a tree like ``params``).  On a mesh ``loss``
    is the global batch's (summed over the batch axes) and ``grads`` this
    rank's blocks of the global gradients.  The parameters are made to
    require gradients."""
    if isinstance(mesh, AbstractMesh):
        raise ValueError(
            "an AbstractMesh has axes and no ranks: a step runs on a "
            "launch.mesh.Mesh of torch.distributed ranks (make_mesh); the "
            "dry run counts an abstract one")
    mb = max(cfg.microbatches, 1)
    ctx = make_axis_ctx(mesh, cfg)
    layout = mesh_layout(cfg, mesh)

    def grad_fn(params, batch):
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
            loss, _ = lm.lm_loss(params, cfg, sub,
                                 ctx if mesh is not None else None)
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
        if mesh is not None:
            acc = _reduce_replicated(acc, layout, ctx.batch_axes)
            for ax in ctx.batch_axes:
                loss_acc = C.all_reduce(loss_acc, mesh, ax, tag="loss")
        return loss_acc, opt.tree_unflatten(params, acc)

    return grad_fn


def _reduce_replicated(grads, layout: opt.Layout, axes):
    """Each gradient summed over the batch axes that do not split its
    parameter (those that do were reduce-scattered by the gathers'
    backward)."""
    out = []
    for g, spec in zip(grads, layout.spec_leaves()):
        used = {a for e in spec for a in entry_axes(e)}
        for ax in axes:
            if ax not in used:
                g = C.all_reduce(g, layout.mesh, ax, tag="grad")
        out.append(g)
    return out


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    mesh: Optional[Any] = None) -> Callable:
    """Returns ``train_step(params, opt_state, batch, step) -> (params,
    opt_state, metrics)``; ``metrics`` holds 0-d float32 tensors
    ``loss`` (the mean of the microbatches' losses), ``grad_norm`` (before
    clipping) and ``lr``.  ``batch`` holds (B, ...) tensors or arrays on
    the parameters' device, B divisible by ``cfg.microbatches``; ``step``
    is the step index.  On a mesh, ``params``/``opt_state`` are this
    rank's blocks and ``batch`` its rows (module docstring).  The
    parameters are made to require gradients."""
    grad_fn = make_grad_fn(cfg, mesh)
    layout = mesh_layout(cfg, mesh)

    def train_step(params, opt_state, batch, step):
        loss, grads = grad_fn(params, batch)
        gnorm = opt.global_norm(grads, layout)
        params, opt_state = opt.opt_update(grads, opt_state, params, step,
                                           tcfg.opt, layout, norm=gnorm)
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "lr": opt.lr_schedule(tcfg.opt, step, gnorm.device)}
        return params, opt_state, metrics

    return train_step


def batch_sharding(mesh, global_batch: int = 0,
                   include_model: bool = False):
    """``spec_rest -> spec``: the batch dimension over the data-parallel
    axes (``pod``, ``data``, and ``model`` with ``include_model``), then
    ``spec_rest``; the batch replicated when ``global_batch`` does not
    divide by their size (long_500k's batch of 1).  None without a mesh."""
    if mesh is None:
        return None
    sizes = mesh_axes(mesh)
    axes = batch_axes(mesh, include_model)
    nrow = 1
    for a in axes:
        nrow *= sizes[a]
    if global_batch and global_batch % nrow != 0:
        axes = ()
    first = spec_entry(axes)
    return lambda spec_rest: (first, *spec_rest)


def input_specs(cfg: ModelConfig, *, seq_len: int, global_batch: int,
                kind: str, mesh: Optional[Any] = None) -> Dict[str, Any]:
    """Stand-ins for every model input of a shape cell, as tensors on the
    ``meta`` device (shapes and dtypes, no storage).

    train/prefill: token (or stub-embedding) batch and labels (and a VLM's
    image embeddings).  decode: one new token; the cache is the caller's
    (`lm.abstract_cache`).  With a mesh it returns ``(inputs, specs)``,
    ``specs`` the partition spec of each input (`batch_sharding`)."""
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
    elif kind == "decode":
        if cfg.embed_inputs:
            tok = torch.empty((b, cfg.d_model), dtype=torch.bfloat16, **meta)
        else:
            tok = torch.empty((b,), dtype=torch.int32, **meta)
        batch = {"token": tok}
    else:
        raise ValueError(kind)
    if mesh is None:
        return batch
    mk = batch_sharding(mesh, global_batch,
                        include_model=cfg.tp_strategy == "dp_only")
    specs = {k: mk((None,) * (t.dim() - 1)) for k, t in batch.items()}
    return batch, specs
