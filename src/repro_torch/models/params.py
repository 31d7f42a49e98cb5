"""Declarative parameters: shapes, logical axes and init in one tree.

The port of the declaration half of the JAX package's ``models/params.py``.
Modules declare ``ParamDecl(shape, axes, init)`` leaves in nested dicts; the
same tree then counts parameters (`n_params`) or materializes as random
tensors (`init_params`).  The axes are kept for parity with the reference's
declarations; the mesh and sharding half comes with the distributed slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from repro_torch.core.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamDecl:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"            # normal | zeros | ones | small_normal
    scale: Optional[float] = None   # None -> 1/sqrt(fan_in)

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def map_decls(fn, tree):
    """``fn`` applied to every `ParamDecl` of a tree of nested dicts, the
    keys visited in sorted order (the reference's flatten order)."""
    if isinstance(tree, ParamDecl):
        return fn(tree)
    return {k: map_decls(fn, tree[k]) for k in sorted(tree)}


def _leaves(tree) -> list:
    out = []
    map_decls(out.append, tree)
    return out


def stack(decl_tree, n: int):
    """Prepend a stacked-layer dimension to every decl."""
    return map_decls(
        lambda d: ParamDecl((n,) + d.shape, (None,) + d.axes, d.init, d.scale),
        decl_tree)


def n_params(decl_tree) -> int:
    return sum(math.prod(d.shape) for d in _leaves(decl_tree))


def init_params(decl_tree, generator: torch.Generator,
                dtype: torch.dtype = torch.bfloat16,
                device=None) -> Any:
    """Materialize random parameters, as the reference's ``init_params``
    does (params.py:73): a fan-in-scaled normal (``1/sqrt(shape[-2])``, or
    the decl's own scale), 0.02 for ``small_normal``, drawn in float32 and
    cast to ``dtype``; ``zeros`` and ``ones`` in float32 whatever ``dtype``.
    Draws come from ``generator`` leaf by leaf in sorted-key order, so one
    seed gives one model; the numbers differ from the reference's (its
    ``jax.random`` keys), and parity tests carry its parameters over with
    `io.convert.lm_params_from_arrays`.  ``device`` follows the device rule
    (``None`` is CUDA); ``generator`` must lie on that device."""
    device = resolve_device(device)
    if generator.device.type != device.type:
        raise ValueError(
            f"the generator lies on {generator.device.type} but the "
            f"parameters go to {device.type}; pass "
            f"torch.Generator(device={device.type!r})")

    def make(d: ParamDecl) -> torch.Tensor:
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=torch.float32, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=torch.float32, device=device)
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        scale = d.scale if d.scale is not None else 1.0 / math.sqrt(fan_in)
        if d.init == "small_normal":
            scale = 0.02
        w = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return w.mul_(scale).to(dtype)

    return map_decls(make, decl_tree)
