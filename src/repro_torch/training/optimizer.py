"""Optimizers: AdamW, Adafactor and SGD with a warmup-cosine schedule.

The port of the JAX package's ``training/optimizer.py``.  A tree is nested
dicts and lists of tensors (the port's LM parameters keep ``blocks`` as a
list); leaves are visited with dict keys in sorted order, as ``jax.tree``
does.  Optimizer state is float32 whatever the parameter's dtype; an
update is computed in float32 and cast back to the parameter's dtype, with
no float32 master copy of the parameters.  The step and every scalar of the
update (the schedule's cosine, ``b1 ** t``, ``b2 ** t``) are float32
tensors as in the reference, so the bias corrections round as its do.

Unlike the reference, whose updates return new trees, `opt_update` writes
the new parameters and state into the given tensors (under
``torch.no_grad()``) and returns them: a training step on the card then
holds one copy of the weights and of the moments.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.models.params import ParamDecl, abstract_params, map_decls

Tree = Any


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"             # adamw | adafactor | sgd
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    # adafactor
    decay_rate: float = 0.8
    factored_min_dim: int = 128


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------

def tree_leaves(tree: Tree, is_leaf: Optional[Callable] = None) -> List:
    """Leaves in ``jax.tree.leaves`` order: dict keys sorted, lists in
    order."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t, is_leaf)]
    return [tree]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(like: Tree, leaves) -> Tree:
    """A tree of ``like``'s structure holding ``leaves``, given in
    `tree_leaves` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)
    return build(like)


def _device(tree: Tree) -> torch.device:
    return tree_leaves(tree)[0].device


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Schedule and clipping
# ---------------------------------------------------------------------------

def lr_schedule(cfg: OptConfig, step, device=None) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio * lr``, in
    float32: a 0-d tensor on ``device`` (the step's own when it is a
    tensor, else the CPU)."""
    if device is None:
        device = step.device if isinstance(step, torch.Tensor) else "cpu"
    step = _f32(step, device)
    warm = step / max(cfg.warmup_steps, 1)
    prog = ((step - cfg.warmup_steps)
            / max(cfg.decay_steps - cfg.warmup_steps, 1)).clamp(0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, decay)


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    return torch.sqrt(torch.stack(
        [x.float().square().sum() for x in tree_leaves(tree)]).sum())


def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    """Grads times ``min(1, max_norm / max(norm, 1e-9))`` (the factor cast
    to each gradient's dtype), and the norm."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / norm.clamp_min(1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(params: Tree) -> Dict[str, Tree]:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}


@torch.no_grad()
def adamw_update(grads: Tree, state: Dict[str, Tree], params: Tree, step,
                 cfg: OptConfig):
    dev = _device(params)
    lr = lr_schedule(cfg, step, dev)
    t = _f32(step, dev) + 1.0
    bc1 = 1 - cfg.b1 ** t
    bc2 = 1 - cfg.b2 ** t

    def upd(g, m, v, p):
        gf = g.float()
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * gf)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * gf.square())
        pf = p.float()
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
            + cfg.weight_decay * pf
        p.copy_((pf - lr * delta).to(p.dtype))

    tree_map(upd, grads, state["m"], state["v"], params)
    return params, state


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern, 2018): factored second moments
# ---------------------------------------------------------------------------

def _factored(p_shape, min_dim: int) -> bool:
    return (len(p_shape) >= 2 and p_shape[-1] >= min_dim
            and p_shape[-2] >= min_dim)


def adafactor_init(params: Tree, cfg: Optional[OptConfig] = None) -> Tree:
    cfg = cfg or OptConfig(name="adafactor")

    def init_one(p):
        z = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                      device=p.device)
        if _factored(p.shape, cfg.factored_min_dim):
            return {"vr": z(p.shape[:-1]), "vc": z(p.shape[:-2] + p.shape[-1:])}
        return {"v": z(p.shape)}

    return tree_map(init_one, params)


def _stacked_groups(params: Tree, grads: Tree, state: Tree):
    """Lists of (grad, state, param) leaves that the reference holds as one
    stacked leaf: the same path in every element of a list (``blocks``,
    ``cross``), or one leaf alone."""
    if isinstance(params, dict):
        for k in sorted(params):
            yield from _stacked_groups(params[k], grads[k], state[k])
    elif isinstance(params, (list, tuple)):
        per = [list(_stacked_groups(p, g, s))
               for p, g, s in zip(params, grads, state)]
        for parts in zip(*per):
            yield [x for part in parts for x in part]
    else:
        yield [(grads, state, params)]


@torch.no_grad()
def adafactor_update(grads: Tree, state: Tree, params: Tree, step,
                     cfg: OptConfig):
    """The reference's rule.  Its update clipping (RMS <= 1) takes the RMS
    over a whole stacked leaf, all layers of ``blocks`` at once, so the
    port takes it over each `_stacked_groups` group: one pass updates the
    moments and sums the squares of the unclipped updates, a second
    recomputes each update from its moments and applies it."""
    dev = _device(params)
    lr = lr_schedule(cfg, step, dev)
    t = _f32(step, dev) + 1.0
    beta2 = 1.0 - t ** (-cfg.decay_rate)
    eps = 1e-30

    def moments(g, s):
        gf = g.float()
        g2 = gf.square() + eps
        if "vr" in s:
            s["vr"].copy_(beta2 * s["vr"] + (1 - beta2) * g2.mean(-1))
            s["vc"].copy_(beta2 * s["vc"] + (1 - beta2) * g2.mean(-2))
        else:
            s["v"].copy_(beta2 * s["v"] + (1 - beta2) * g2)

    def direction(g, s):
        gf = g.float()
        if "vr" in s:
            vr, vc = s["vr"], s["vc"]
            r = vr / vr.mean(-1, keepdim=True).clamp_min(eps)
            approx = r[..., None] * vc[..., None, :]
            return gf * torch.rsqrt(approx.clamp_min(eps))
        return gf * torch.rsqrt(s["v"].clamp_min(eps))

    for group in _stacked_groups(params, grads, state):
        sq, count = 0.0, 0
        for g, s, _ in group:
            moments(g, s)
            sq = sq + direction(g, s).square().sum()
            count += g.numel()
        # update clipping (RMS <= 1) as in the paper
        rms = torch.sqrt(sq / count + eps)
        for g, s, p in group:
            update = direction(g, s) / rms.clamp_min(1.0)
            pf = p.float()
            update = update + cfg.weight_decay * pf
            p.copy_((pf - lr * update).to(p.dtype))
    return params, state


# ---------------------------------------------------------------------------
# Declared optimizer state (mirrors opt_init structurally)
# ---------------------------------------------------------------------------

def opt_state_decls(decl_tree: Tree, cfg: OptConfig) -> Tree:
    """`ParamDecl` tree of the optimizer state: the structure ``opt_init``
    gives for parameters materialized from ``decl_tree``, each leaf's axes
    inherited from its parameter.  Adafactor's factored moments drop the
    factored dimension and its axis."""
    if cfg.name == "sgd":
        return {}
    f32 = lambda d: ParamDecl(d.shape, d.axes, init="zeros")
    if cfg.name == "adamw":
        return {"m": map_decls(f32, decl_tree), "v": map_decls(f32, decl_tree)}
    if cfg.name == "adafactor":
        def one(d):
            if _factored(d.shape, cfg.factored_min_dim):
                return {"vr": ParamDecl(d.shape[:-1], d.axes[:-1],
                                        init="zeros"),
                        "vc": ParamDecl(d.shape[:-2] + d.shape[-1:],
                                        d.axes[:-2] + d.axes[-1:],
                                        init="zeros")}
            return {"v": f32(d)}
        return map_decls(one, decl_tree)
    raise ValueError(cfg.name)


def opt_abstract(decl_tree: Tree, cfg: OptConfig, mesh=None,
                 rules=None) -> Tuple[Tree, Optional[Tree]]:
    """``(state, specs)``: the optimizer state of `opt_state_decls` as
    float32 ``meta`` tensors (no storage) and, with a mesh, their
    partition specs (ZeRO-style: each moment where its parameter's shard
    lives); the tree is the declarations' (stacked layers), the reference's
    ``opt_abstract``."""
    return abstract_params(opt_state_decls(decl_tree, cfg), mesh=mesh,
                           rules=rules)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def opt_init(params: Tree, cfg: OptConfig) -> Tree:
    if cfg.name == "adamw":
        return adamw_init(params)
    if cfg.name == "adafactor":
        return adafactor_init(params, cfg)
    if cfg.name == "sgd":
        return {}
    raise ValueError(cfg.name)


@torch.no_grad()
def opt_update(grads: Tree, state: Tree, params: Tree, step,
               cfg: OptConfig):
    """One step: clip the grads by their global norm when ``grad_clip``,
    then the named rule.  ``step`` is the step index (an int or a 0-d
    tensor).  Returns ``(params, state)``, the given tensors updated in
    place."""
    if cfg.grad_clip:
        grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
    if cfg.name == "adamw":
        return adamw_update(grads, state, params, step, cfg)
    if cfg.name == "adafactor":
        return adafactor_update(grads, state, params, step, cfg)
    if cfg.name == "sgd":
        lr = lr_schedule(cfg, step, _device(params))

        def upd(p, g):
            p.copy_((p.float() - lr * g.float()).to(p.dtype))
        tree_map(upd, params, grads)
        return params, state
    raise ValueError(cfg.name)
