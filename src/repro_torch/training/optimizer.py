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

On a mesh of ranks the trees are this rank's blocks, and ``layout``
(`Layout`: the mesh and the parameters' partition specs) says how each
leaf is cut.  `global_norm` then sums each leaf's squares over the axes
that split it (a replicated leaf counts once), Adafactor takes its row and
column means and its update RMS over whole leaves (sums over the axes that
split the dimension), and AdamW, elementwise, runs on the blocks as they
are.  With every axis of one rank these are the one-device sums, op for
op.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.distributed import collectives as C
from repro_torch.models.params import (ParamDecl, abstract_params, entry_axes,
                                       map_decls)

Tree = Any


@dataclasses.dataclass(frozen=True)
class Layout:
    """How a tree of blocks is cut on a mesh of ranks: ``specs`` matches
    the parameters (`models.lm.abstract`'s specs)."""
    mesh: Any
    specs: Any

    def dims(self, spec) -> List[Tuple[str, ...]]:
        """The axes of more than one rank that split each dimension."""
        return [tuple(a for a in entry_axes(e)
                      if self.mesh.axis_size(a) > 1) for e in spec]

    def spec_leaves(self) -> List:
        return tree_leaves(self.specs, lambda x: isinstance(x, tuple))

    def psum(self, x: torch.Tensor, axes, tag: str) -> torch.Tensor:
        for ax in axes:
            x = C.all_reduce(x, self.mesh, ax, tag=tag)
        return x

    def full_shape(self, shape, spec) -> Tuple[int, ...]:
        out = list(shape)
        for i, axes in enumerate(self.dims(spec)):
            for a in axes:
                out[i] *= self.mesh.axis_size(a)
        return tuple(out)


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
    return _unflatten(like, iter(leaves))


def _unflatten(t: Tree, it) -> Tree:
    # Not a closure: a nested function that calls itself is a reference
    # cycle, which would hold ``leaves`` (a step's gradients) until the
    # cyclic collector happens to run.
    if isinstance(t, dict):
        out = {k: _unflatten(t[k], it) for k in sorted(t)}
        return {k: out[k] for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_unflatten(x, it) for x in t)
    return next(it)


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


def global_norm(tree: Tree, layout: Optional[Layout] = None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares.
    With ``layout`` the leaves are blocks: the leaves split over the same
    axes are summed together, then over those axes (one scalar all-reduce
    an axis of each such set)."""
    sq = [x.float().square().sum() for x in tree_leaves(tree)]
    if layout is None:
        return torch.sqrt(torch.stack(sq).sum())
    order = {a: i for i, a in enumerate(layout.mesh.axes)}
    groups: Dict[Tuple[str, ...], List[torch.Tensor]] = {}
    for x, spec in zip(sq, layout.spec_leaves()):
        key = tuple(sorted({a for d in layout.dims(spec) for a in d},
                           key=order.get))
        groups.setdefault(key, []).append(x)
    total = None
    for key in sorted(groups, key=lambda k: (len(k), k)):
        part = layout.psum(torch.stack(groups[key]).sum(), key, "norm")
        total = part if total is None else total + part
    return torch.sqrt(total)


def clip_by_global_norm(grads: Tree, max_norm: float,
                        norm: Optional[torch.Tensor] = None
                        ) -> Tuple[Tree, torch.Tensor]:
    """Grads times ``min(1, max_norm / max(norm, 1e-9))`` (the factor cast
    to each gradient's dtype), and the norm (`global_norm`'s unless
    given)."""
    if norm is None:
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


def adafactor_init(params: Tree, cfg: Optional[OptConfig] = None,
                   layout: Optional[Layout] = None) -> Tree:
    """Factored (``vr``, ``vc``) or whole (``v``) float32 second moments;
    with ``layout`` the blocks of them, factored by the whole leaf's
    shape."""
    cfg = cfg or OptConfig(name="adafactor")

    def init_one(p, spec=None):
        z = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                      device=p.device)
        full = p.shape if spec is None else layout.full_shape(p.shape, spec)
        if _factored(full, cfg.factored_min_dim):
            return {"vr": z(p.shape[:-1]), "vc": z(p.shape[:-2] + p.shape[-1:])}
        return {"v": z(p.shape)}

    if layout is None:
        return tree_map(init_one, params)
    from repro_torch.models.params import map_specs
    return map_specs(init_one, params, layout.specs)


def _stacked_groups(params: Tree, grads: Tree, state: Tree,
                    specs: Tree = None):
    """Lists of (grad, state, param, spec) leaves that the reference holds
    as one stacked leaf: the same path in every element of a list
    (``blocks``, ``cross``), or one leaf alone (``spec`` None without
    specs)."""
    if isinstance(params, dict):
        for k in sorted(params):
            yield from _stacked_groups(params[k], grads[k], state[k],
                                       None if specs is None else specs[k])
    elif isinstance(params, (list, tuple)):
        per = [list(_stacked_groups(p, g, s, None if specs is None
                                    else specs[i]))
               for i, (p, g, s) in enumerate(zip(params, grads, state))]
        for parts in zip(*per):
            yield [x for part in parts for x in part]
    else:
        yield [(grads, state, params, specs)]


@torch.no_grad()
def adafactor_update(grads: Tree, state: Tree, params: Tree, step,
                     cfg: OptConfig, layout: Optional[Layout] = None):
    """The reference's rule.  Its update clipping (RMS <= 1) takes the RMS
    over a whole stacked leaf, all layers of ``blocks`` at once, so the
    port takes it over each `_stacked_groups` group: one pass updates the
    moments and sums the squares of the unclipped updates, a second
    recomputes each update from its moments and applies it.  With
    ``layout`` a mean over a split dimension is a sum, summed over the
    axes that split it, over the whole dimension, and so is the RMS."""
    dev = _device(params)
    lr = lr_schedule(cfg, step, dev)
    t = _f32(step, dev) + 1.0
    beta2 = 1.0 - t ** (-cfg.decay_rate)
    eps = 1e-30

    def mean(x, dim, axes, keepdim=False):
        if not axes:
            return x.mean(dim, keepdim=keepdim)
        n = x.shape[dim] * math.prod(layout.mesh.axis_size(a) for a in axes)
        return layout.psum(x.sum(dim, keepdim=keepdim), axes, "opt") / n

    def moments(g, s, dims):
        gf = g.float()
        g2 = gf.square() + eps
        if "vr" in s:
            s["vr"].copy_(beta2 * s["vr"] + (1 - beta2) * mean(g2, -1,
                                                               dims[-1]))
            s["vc"].copy_(beta2 * s["vc"] + (1 - beta2) * mean(g2, -2,
                                                               dims[-2]))
        else:
            s["v"].copy_(beta2 * s["v"] + (1 - beta2) * g2)

    def direction(g, s, dims):
        gf = g.float()
        if "vr" in s:
            vr, vc = s["vr"], s["vc"]
            r = vr / mean(vr, -1, dims[-2], keepdim=True).clamp_min(eps)
            approx = r[..., None] * vc[..., None, :]
            return gf * torch.rsqrt(approx.clamp_min(eps))
        return gf * torch.rsqrt(s["v"].clamp_min(eps))

    specs = None if layout is None else layout.specs
    for group in _stacked_groups(params, grads, state, specs):
        sq, count, split = 0.0, 0, ()
        for g, s, _, spec in group:
            dims = ([()] * g.dim() if spec is None else layout.dims(spec))
            moments(g, s, dims)
            sq = sq + direction(g, s, dims).square().sum()
            n = g.numel()
            if spec is not None:
                split = tuple(a for d in dims for a in d)
                n = math.prod(layout.full_shape(g.shape, spec))
            count += n
        if split:
            sq = layout.psum(sq, split, "opt")
        # update clipping (RMS <= 1) as in the paper
        rms = torch.sqrt(sq / count + eps)
        for g, s, p, spec in group:
            dims = ([()] * g.dim() if spec is None else layout.dims(spec))
            update = direction(g, s, dims) / rms.clamp_min(1.0)
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

def opt_init(params: Tree, cfg: OptConfig,
             layout: Optional[Layout] = None) -> Tree:
    """The optimizer state of ``params`` (with ``layout``: of these
    blocks)."""
    if cfg.name == "adamw":
        return adamw_init(params)
    if cfg.name == "adafactor":
        return adafactor_init(params, cfg, layout)
    if cfg.name == "sgd":
        return {}
    raise ValueError(cfg.name)


def opt_state_specs(params: Tree, cfg: OptConfig, layout: Layout) -> Tree:
    """The partition specs of `opt_init`'s state on ``layout``'s mesh:
    each moment where its parameter's block lives; Adafactor's factored
    moments drop the factored dimension's entry."""
    if cfg.name == "sgd":
        return {}
    if cfg.name == "adamw":
        return {"m": layout.specs, "v": layout.specs}
    if cfg.name == "adafactor":
        from repro_torch.models.params import map_specs

        def one(p, spec):
            full = layout.full_shape(p.shape, spec)
            if _factored(full, cfg.factored_min_dim):
                return {"vr": spec[:-1], "vc": spec[:-2] + spec[-1:]}
            return {"v": spec}
        return map_specs(one, params, layout.specs)
    raise ValueError(cfg.name)


@torch.no_grad()
def opt_update(grads: Tree, state: Tree, params: Tree, step,
               cfg: OptConfig, layout: Optional[Layout] = None,
               norm: Optional[torch.Tensor] = None):
    """One step: clip the grads by their global norm when ``grad_clip``,
    then the named rule.  ``step`` is the step index (an int or a 0-d
    tensor).  ``layout`` says how the blocks are cut on a mesh; ``norm``
    is the gradients' global norm when the caller has it.  Returns
    ``(params, state)``, the given tensors updated in place."""
    if cfg.grad_clip:
        if norm is None:
            norm = global_norm(grads, layout)
        grads, _ = clip_by_global_norm(grads, cfg.grad_clip, norm)
    if cfg.name == "adamw":
        return adamw_update(grads, state, params, step, cfg)
    if cfg.name == "adafactor":
        return adafactor_update(grads, state, params, step, cfg, layout)
    if cfg.name == "sgd":
        lr = lr_schedule(cfg, step, _device(params))

        def upd(p, g):
            p.copy_((p.float() - lr * g.float()).to(p.dtype))
        tree_map(upd, params, grads)
        return params, state
    raise ValueError(cfg.name)
