"""Declarative parameters: shapes, logical axes and init in one tree.

The port of the JAX package's ``models/params.py``.  Modules declare
``ParamDecl(shape, axes, init)`` leaves in nested dicts; the same tree then
counts parameters (`n_params`), materializes as random tensors
(`init_params`), as ``meta`` tensors with their partition specs
(`abstract_params`, for the dry run: no storage), or as each rank's shard
shapes on a mesh (`tree_shard_shapes`).  `shard_tree` cuts a whole tree
into one rank's blocks on a mesh of ranks, and `gather_tree` puts the
blocks back together.  Logical axes:

  "tp"    tensor-parallel        -> mesh "model"
  "fsdp"  fully-sharded params   -> mesh "data"   (ZeRO-3-style storage)
  "ep"    expert-parallel        -> mesh "model"
  None    replicated dimension

A partition spec is a plain tuple with one entry a dimension, as the
reference's ``PartitionSpec``: a mesh axis name, a tuple of names, or None
(replicated).  A mesh is anything with ``axes`` and ``shape``: a real
`launch.mesh.Mesh` of ranks or an `launch.mesh.AbstractMesh`.
Divisibility fallback: a dimension not divisible by its mesh axes' size is
replicated (kv_heads=8 on a 16-way model axis).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

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


LOGICAL_RULES = {"tp": "model", "fsdp": "data", "ep": "model"}


def is_decl(x) -> bool:
    return isinstance(x, ParamDecl)


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


# ---------------------------------------------------------------------------
# Partition specs on a mesh
# ---------------------------------------------------------------------------

def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a mesh (real or abstract)."""
    return dict(zip(mesh.axes, mesh.shape))


def spec_entry(axes):
    """One spec entry for a dimension over ``axes`` (a name or a tuple of
    names), normalized as the reference's ``PartitionSpec`` does: no axis
    is None, one axis its name."""
    if isinstance(axes, tuple):
        return None if not axes else axes[0] if len(axes) == 1 else axes
    return axes


def batch_axes(mesh, dp_only: bool = False) -> Tuple[str, ...]:
    """The axes of ``mesh`` a step's batch is split over: ``pod`` and
    ``data``, and ``model`` too in ``dp_only`` mode, which shards no
    parameter over it."""
    axes = ("pod", "data", "model") if dp_only else ("pod", "data")
    return tuple(a for a in axes if a in mesh_axes(mesh))


def dp_only_rules(mesh):
    """Rules for small archs where TP is pure collective overhead: params
    replicated over "model" (no tp/ep), FSDP storage over every axis, and
    the batch sharded over "model" as extra data parallelism."""
    return {"tp": None, "ep": None, "fsdp": batch_axes(mesh, dp_only=True)}


def _axis_size(mesh, mesh_ax) -> int:
    sizes = mesh_axes(mesh)
    if isinstance(mesh_ax, tuple):
        n = 1
        for a in mesh_ax:
            n *= sizes.get(a, 1)
        return n
    return sizes.get(mesh_ax, 1)


def partition_spec(d: ParamDecl, mesh, rules=None) -> Tuple:
    """Logical axes -> partition spec with the divisibility fallback;
    ``()`` without a mesh.  ``rules`` maps a logical axis to a mesh axis
    (or a tuple of axes, or None: replicated)."""
    if mesh is None:
        return ()
    rules = rules or LOGICAL_RULES
    sizes = mesh_axes(mesh)
    names = []
    for dim, ax in zip(d.shape, d.axes):
        mesh_ax = None if ax is None else rules.get(ax, ax)
        if mesh_ax is None:
            names.append(None)
            continue
        single = mesh_ax if isinstance(mesh_ax, tuple) else (mesh_ax,)
        if all(a in sizes for a in single) and \
                dim % _axis_size(mesh, mesh_ax) == 0:
            names.append(spec_entry(mesh_ax))
        else:
            names.append(None)                      # replicate (fallback)
    return tuple(names)


def tree_pspecs(decl_tree, mesh, rules=None):
    return map_decls(lambda d: partition_spec(d, mesh, rules), decl_tree)


def shard_shape(shape: Tuple[int, ...], spec: Tuple, mesh) -> Tuple[int, ...]:
    """One rank's block of an array of ``shape`` laid out by ``spec`` (a
    spec shorter than the shape replicates the rest).  Every sharded
    dimension must divide by its axes' size."""
    out = []
    for i, dim in enumerate(shape):
        ax = spec[i] if i < len(spec) else None
        n = 1 if ax is None else _axis_size(mesh, ax)
        if dim % n:
            raise ValueError(f"dimension {i} of {tuple(shape)} does not "
                             f"divide over {ax!r} ({n} ranks)")
        out.append(dim // n)
    return tuple(out)


def tree_shard_shapes(decl_tree, mesh, rules=None):
    """Each leaf's shard shape on one rank of ``mesh``."""
    return map_decls(
        lambda d: shard_shape(d.shape, partition_spec(d, mesh, rules), mesh),
        decl_tree)


def decl_dtype(d: ParamDecl, dtype: torch.dtype) -> torch.dtype:
    """A leaf's type: float32 for ``zeros``/``ones`` (norms, gates,
    optimizer moments), ``dtype`` otherwise."""
    return torch.float32 if d.init in ("zeros", "ones") else dtype


def abstract_params(decl_tree, dtype: torch.dtype = torch.bfloat16,
                    mesh=None, rules=None):
    """``(tensors, specs)``: the tree as ``meta`` tensors (shapes and
    dtypes, no storage) and, with a mesh, its partition specs (else
    None)."""
    values = map_decls(lambda d: torch.empty(d.shape, dtype=decl_dtype(
        d, dtype), device="meta"), decl_tree)
    specs = None if mesh is None else tree_pspecs(decl_tree, mesh, rules)
    return values, specs


# ---------------------------------------------------------------------------
# One rank's blocks of a tree on a mesh of ranks
# ---------------------------------------------------------------------------

def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (None, a name or a tuple)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree of nested dicts and lists of tensors
    and the matching tree of partition specs (tuples), keeping the
    structure."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_specs(fn, v, s) for v, s in zip(tree, specs)]
    return fn(tree, specs)


def shard_block(x: torch.Tensor, spec: Tuple, mesh) -> torch.Tensor:
    """This rank's block of the whole array ``x`` laid out by ``spec``
    (a copy): each dimension cut over its axes, the first the major."""
    for dim, entry in enumerate(spec):
        axes = entry_axes(entry)
        if not axes:
            continue
        idx, n = mesh.block_index(axes)
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                             f"divide over {axes} ({n} ranks)")
        blk = x.shape[dim] // n
        x = x.narrow(dim, idx * blk, blk)
    return x.clone()


def shard_tree(tree, specs, mesh, device=None):
    """A whole tree (every rank holds the same) -> this rank's blocks on
    ``mesh``, on ``device`` (the mesh's by default).  ``specs`` matches the
    tree (`models.lm.abstract`'s specs for the LM parameters)."""
    dev = mesh.device if device is None else device
    return map_specs(lambda x, sp: shard_block(x, sp, mesh).to(dev), tree,
                     specs)


def gather_block(x: torch.Tensor, spec: Tuple, mesh, *,
                 tag: str = "gather") -> torch.Tensor:
    """The whole array from every rank's block ``x`` (a collective over
    the axes of ``spec``; each rank gets the whole)."""
    from repro_torch.distributed import collectives as C
    for dim, entry in enumerate(spec):
        for ax in reversed(entry_axes(entry)):
            x = C.all_gather_dim(x, mesh, ax, dim, tag=tag)
    return x


def gather_tree(tree, specs, mesh, *, tag: str = "gather"):
    """`shard_tree`'s inverse: every rank's blocks -> the whole tree, on
    every rank (rank 0 is the one that writes it)."""
    return map_specs(lambda x, sp: gather_block(x, sp, mesh, tag=tag), tree,
                     specs)
