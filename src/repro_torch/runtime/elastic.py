"""Elastic scaling: lay host arrays out on a (possibly different) mesh (the
JAX package's ``runtime/elastic.py``).

Checkpoints are mesh-agnostic host arrays, so a step written on one mesh
restores onto another: each rank takes its block of every array
(`remesh`).  After a loss of ranks the survivors start a new world of the
shape `shrink_data_axis` gives (a ``torch.distributed`` world cannot
shrink in place) and resume from the last step.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.launch.mesh import Mesh, MeshSpec

Tree = Any


class Layout(NamedTuple):
    """How an array lies on a mesh: dim 0 split over ``rows`` (the axes
    taken together, row-major; ``()`` for none), dim 1 over ``cols`` (an
    axis, or None)."""
    mesh: Mesh
    rows: Tuple[str, ...] = ()
    cols: Optional[str] = None


def block(x, layout: Layout) -> torch.Tensor:
    """This rank's block of the whole array ``x`` (a host array or a
    tensor) under ``layout``, on the mesh's device."""
    t = torch.as_tensor(np.asarray(x)) if not torch.is_tensor(x) else x
    mesh = layout.mesh
    if layout.rows:
        i, n = mesh.block_index(layout.rows)
        if t.shape[0] % n:
            raise ValueError(f"dim 0 of size {t.shape[0]} does not split "
                             f"over {n} row shards")
        size = t.shape[0] // n
        t = t[i * size:(i + 1) * size]
    if layout.cols is not None:
        j, n = mesh.index(layout.cols), mesh.axis_size(layout.cols)
        if t.shape[1] % n:
            raise ValueError(f"dim 1 of size {t.shape[1]} does not split "
                             f"over a {layout.cols!r} axis of {n}")
        size = t.shape[1] // n
        t = t[:, j * size:(j + 1) * size]
    return t.to(mesh.device).contiguous()


def _first_layout(layouts) -> Optional[Layout]:
    if isinstance(layouts, Layout):
        return layouts
    items = (layouts.values() if isinstance(layouts, dict)
             else layouts if isinstance(layouts, (list, tuple)) else ())
    for v in items:
        found = _first_layout(v)
        if found is not None:
            return found
    return None


def remesh(tree: Tree, layouts: Union[Layout, Tree], *, device=None) -> Tree:
    """Every leaf of ``tree`` (nested dicts, lists and tuples of host arrays
    or tensors) as this rank's block: ``layouts`` is one `Layout` for
    every leaf, or a nest of the tree's structure whose leaves are Layouts
    or None.  A leaf under None is kept whole, on ``device`` (by default
    the device of the first Layout's mesh)."""
    first = _first_layout(layouts)
    if first is None and layouts is not None:
        raise TypeError("shardings must be an elastic.Layout, None, or a "
                        "nest of dicts, lists and tuples of them; got "
                        f"{type(layouts).__name__}")
    if device is None and first is not None:
        device = first.mesh.device

    def walk(x, lay):
        if isinstance(lay, Layout) or lay is None:
            if isinstance(x, dict):
                return {k: walk(v, lay) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                items = [walk(v, lay) for v in x]
                return (type(x)(*items) if hasattr(x, "_fields")
                        else type(x)(items))
            if lay is None:
                t = torch.as_tensor(np.asarray(x)) if not torch.is_tensor(
                    x) else x
                return t if device is None else t.to(device)
            return block(x, lay)
        if isinstance(lay, dict):
            return {k: walk(x[k], lay[k]) for k in x}
        if isinstance(lay, (list, tuple)):
            items = [walk(v, s) for v, s in zip(x, lay)]
            return (type(x)(*items) if hasattr(x, "_fields")
                    else type(x)(items))
        raise TypeError("shardings must be an elastic.Layout, None, or a "
                        "nest of them; got a leaf of type "
                        f"{type(lay).__name__}")
    return walk(tree, layouts)


def _spec(mesh: Union[Mesh, MeshSpec]) -> MeshSpec:
    return mesh.spec if isinstance(mesh, Mesh) else MeshSpec(*mesh)


def shrink_data_axis(mesh: Union[Mesh, MeshSpec], lost: int = 1) -> MeshSpec:
    """The survivors' mesh after losing ``lost`` data-parallel slices: the
    shape to start the new world with."""
    spec = _spec(mesh)
    shape = dict(zip(spec.axes, spec.shape))
    if "data" not in shape or shape["data"] - lost < 1:
        raise ValueError("cannot shrink below one data slice")
    shape["data"] -= lost
    return MeshSpec(tuple(shape[a] for a in spec.axes), spec.axes)


def rebalance_batch(global_batch: int,
                    mesh: Union[Mesh, MeshSpec]) -> int:
    """The largest batch at most ``global_batch`` that divides by the
    data-parallel degree (``pod`` x ``data``)."""
    spec = _spec(mesh)
    shape = dict(zip(spec.axes, spec.shape))
    dp = shape.get("pod", 1) * shape.get("data", 1)
    return (global_batch // dp) * dp
