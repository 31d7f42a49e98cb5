"""Collectives on the axes of a `launch.mesh.Mesh`, written on
``all_reduce`` alone.

Gloo on CUDA tensors offers only ``all_reduce`` and ``broadcast``, so the
same three functions run under NCCL, under gloo on CUDA tensors and under
gloo on the CPU:

  * `psum` — a SUM all-reduce over each named axis in turn (the
    reference's ``_psum_all`` and ``jax.lax.psum``);
  * `pmax` — a MAX all-reduce;
  * `all_gather` — a SUM all-reduce of a buffer of ``axis_size`` blocks in
    which this rank fills its own block and leaves the others at the
    additive identity: ``-0.0`` for floats (``-0.0 + x`` is ``x`` bit for
    bit, ``+0.0`` and ``-0.0`` included, in any order of the sum), 0 for
    integers.  So the gather is exact.

Every call counts the bytes it hands to ``all_reduce`` into
``mesh.counted[(axis, tag)]``; the histogram all-reduces use the tag
``"hist"``, which `core.distributed.round_collective_bytes` models.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.distributed as dist

Axes = Union[str, Sequence[str]]


def _axes(axes: Axes):
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _reduce(x: torch.Tensor, mesh, axes: Axes, op, tag: str) -> torch.Tensor:
    if x.device != mesh.device:
        raise ValueError(f"a collective on {mesh.device} got a tensor on "
                         f"{x.device}")
    out = x.contiguous().clone()
    for ax in _axes(axes):
        mesh.count(ax, tag, out.numel() * out.element_size())
        dist.all_reduce(out, op=op, group=mesh.groups[ax])
    return out


def psum(x: torch.Tensor, mesh, axes: Axes, *,
         tag: str = "other") -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes`` (a new tensor)."""
    return _reduce(x, mesh, axes, dist.ReduceOp.SUM, tag)


def pmax(x: torch.Tensor, mesh, axes: Axes, *,
         tag: str = "other") -> torch.Tensor:
    """The elementwise maximum of ``x`` over the ranks of ``axes``."""
    return _reduce(x, mesh, axes, dist.ReduceOp.MAX, tag)


def all_gather(x: torch.Tensor, mesh, axis: str, *,
               tag: str = "other") -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, stacked in the axis' order:
    ``(axis_size, *x.shape)``, exact (see the module docstring)."""
    size = mesh.axis_size(axis)
    fill = -0.0 if x.dtype.is_floating_point else 0
    buf = torch.full((size,) + tuple(x.shape), fill, dtype=x.dtype,
                     device=x.device)
    buf[mesh.index(axis)] = x
    return _reduce(buf, mesh, axis, dist.ReduceOp.SUM, tag)


def barrier(mesh) -> None:
    """Wait for every rank of the mesh: a one-element all-reduce over each
    axis."""
    psum(torch.zeros(1, device=mesh.device), mesh, mesh.axes, tag="barrier")
