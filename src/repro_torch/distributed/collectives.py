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

Every call counts the bytes it hands to ``all_reduce`` (`Mesh.count`, read
as ``mesh.counted[(axis, tag)]``); the histogram all-reduces use the tag
``"hist"``, which `core.distributed.round_collective_bytes` models.

The LM training step on a mesh adds collectives along a tensor dimension,
one axis a call (a tuple of axes is the caller's loop, inner axis first
for a gather, so that blocks land in row-major order):

  * `all_gather_dim`, `reduce_scatter_dim` and `all_to_all`: under NCCL
    the native collectives; under gloo, which offers ``all_reduce`` alone
    on CUDA tensors, an exact SUM ``all_reduce`` of a buffer padded with
    the additive identity, as `all_gather` above (and a full sum, of which
    a rank keeps its block, for the reduce-scatter);
  * autograd pairs: `gather_param` (all-gather forward, reduce-scatter of
    the gradient backward: FSDP's storage), `copy_to` / `reduce_from`
    (Megatron's identity/sum pair over ``model``), `psum_both` (a sum
    whose gradient is summed too), `gather_rows` (all-gather forward,
    this rank's block of the gradient backward) and `all_to_all_grad`.

An axis of one rank is skipped: no call, no count.  Each call counts its
payload under its op (``mesh.by_op[(op, axis, tag)]``): the buffer
reduced or exchanged, or for an all-gather the block a rank adds.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.distributed as dist

Axes = Union[str, Sequence[str]]


def _axes(axes: Axes):
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _nccl(mesh, axis: str) -> bool:
    return dist.get_backend(mesh.groups[axis]) == "nccl"


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


# ---------------------------------------------------------------------------
# Collectives along a tensor dimension (the LM step on a mesh)
# ---------------------------------------------------------------------------

def _check(x: torch.Tensor, mesh) -> None:
    if x.device != mesh.device:
        raise ValueError(f"a collective on {mesh.device} got a tensor on "
                         f"{x.device}")


def _blocks_sum(x: torch.Tensor, mesh, axis: str, slot: int, size: int
                ) -> torch.Tensor:
    """Gloo's exact exchange: a (size, *x.shape) buffer holding ``x`` at
    ``slot`` and the additive identity elsewhere, SUM all-reduced."""
    fill = -0.0 if x.dtype.is_floating_point else 0
    buf = torch.full((size,) + tuple(x.shape), fill, dtype=x.dtype,
                     device=x.device)
    buf[slot] = x
    dist.all_reduce(buf, group=mesh.groups[axis])
    return buf


def all_reduce(x: torch.Tensor, mesh, axis: str, *,
               tag: str = "other") -> torch.Tensor:
    """The SUM of ``x`` over ``axis`` (a new tensor; ``x`` itself on an
    axis of one rank)."""
    n = mesh.axis_size(axis)
    if n == 1:
        return x
    _check(x, mesh)
    out = x.contiguous().clone()
    mesh.count(axis, tag, out.numel() * out.element_size(), op="all-reduce")
    dist.all_reduce(out, group=mesh.groups[axis])
    return out


def all_reduce_max(x: torch.Tensor, mesh, axis: str, *,
                   tag: str = "other") -> torch.Tensor:
    """The elementwise MAX of ``x`` over ``axis``."""
    n = mesh.axis_size(axis)
    if n == 1:
        return x
    _check(x, mesh)
    out = x.contiguous().clone()
    mesh.count(axis, tag, out.numel() * out.element_size(), op="all-reduce")
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=mesh.groups[axis])
    return out


def all_gather_dim(x: torch.Tensor, mesh, axis: str, dim: int, *,
                   tag: str = "other") -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, concatenated along ``dim`` in the
    axis' order."""
    n = mesh.axis_size(axis)
    if n == 1:
        return x
    _check(x, mesh)
    mesh.count(axis, tag, x.numel() * x.element_size(), op="all-gather")
    xt = x.movedim(dim, 0).contiguous()
    if _nccl(mesh, axis):
        out = torch.empty((n * xt.shape[0],) + tuple(xt.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, xt, group=mesh.groups[axis])
    else:
        out = _blocks_sum(xt, mesh, axis, mesh.index(axis), n).flatten(0, 1)
    return out.movedim(0, dim)


def reduce_scatter_dim(x: torch.Tensor, mesh, axis: str, dim: int, *,
                       tag: str = "other") -> torch.Tensor:
    """The SUM of ``x`` over ``axis``, of which this rank keeps its block
    along ``dim`` (the dimension divides by the axis' size)."""
    n = mesh.axis_size(axis)
    if n == 1:
        return x
    _check(x, mesh)
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                         f"divide over {axis!r} ({n} ranks)")
    mesh.count(axis, tag, x.numel() * x.element_size(),
               op="reduce-scatter")
    xt = x.movedim(dim, 0).contiguous()
    blk = xt.shape[0] // n
    if _nccl(mesh, axis):
        out = torch.empty((blk,) + tuple(xt.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.reduce_scatter_tensor(out, xt, group=mesh.groups[axis])
    else:
        xt = xt.clone()
        dist.all_reduce(xt, group=mesh.groups[axis])
        i = mesh.index(axis)
        out = xt[i * blk:(i + 1) * blk].clone()
    return out.movedim(0, dim)


def all_to_all(x: torch.Tensor, mesh, axis: str, *,
               tag: str = "other") -> torch.Tensor:
    """``x`` (n, ...): block j goes to rank j of ``axis``; the result's
    block j is what rank j sent here."""
    n = mesh.axis_size(axis)
    if n == 1:
        return x
    _check(x, mesh)
    if x.shape[0] != n:
        raise ValueError(f"all_to_all over {axis!r} ({n} ranks) needs a "
                         f"leading dimension of {n}, got {tuple(x.shape)}")
    mesh.count(axis, tag, x.numel() * x.element_size(), op="all-to-all")
    x = x.contiguous()
    if _nccl(mesh, axis):
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=mesh.groups[axis])
        return out
    buf = _blocks_sum(x, mesh, axis, mesh.index(axis), n)   # (src, dst, ...)
    return buf[:, mesh.index(axis)].clone()


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, tag):
        ctx.args = (mesh, axis, dim, tag)
        return all_gather_dim(x, mesh, axis, dim, tag=tag)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim, tag = ctx.args
        return reduce_scatter_dim(g, mesh, axis, dim, tag=tag), None, None, \
            None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, tag):
        ctx.args = (mesh, axis, tag)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, tag = ctx.args
        return all_reduce(g, mesh, axis, tag=tag), None, None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, tag):
        return all_reduce(x, mesh, axis, tag=tag)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


class _PsumBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, tag):
        ctx.args = (mesh, axis, tag)
        return all_reduce(x, mesh, axis, tag=tag)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, tag = ctx.args
        return all_reduce(g, mesh, axis, tag=tag), None, None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, tag):
        ctx.args = (mesh, axis, dim, x.shape[dim])
        return all_gather_dim(x, mesh, axis, dim, tag=tag)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim, blk = ctx.args
        i = mesh.index(axis)
        return g.narrow(dim, i * blk, blk), None, None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, tag):
        ctx.args = (mesh, axis, tag)
        return all_to_all(x, mesh, axis, tag=tag)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, tag = ctx.args
        return all_to_all(g, mesh, axis, tag=tag), None, None, None


def _trivial(mesh, axis) -> bool:
    return mesh is None or axis is None or mesh.axis_size(axis) == 1


def gather_param(x: torch.Tensor, mesh, axis: str, dim: int, *,
                 tag: str = "fsdp") -> torch.Tensor:
    """A parameter's block gathered along ``dim`` over ``axis``; the
    gradient is summed over the axis and scattered back to the blocks."""
    if _trivial(mesh, axis):
        return x
    return _GatherParam.apply(x, mesh, axis, dim, tag)


def copy_to(x: torch.Tensor, mesh, axis: str, *,
            tag: str = "tp") -> torch.Tensor:
    """Identity forward, the gradient summed over ``axis`` (Megatron's
    ``f``: where a replicated tensor enters work split over the axis)."""
    if _trivial(mesh, axis):
        return x
    return _Copy.apply(x, mesh, axis, tag)


def reduce_from(x: torch.Tensor, mesh, axis: str, *,
                tag: str = "tp") -> torch.Tensor:
    """The sum over ``axis`` forward, the gradient as it is (Megatron's
    ``g``: where partial sums leave work split over the axis)."""
    if _trivial(mesh, axis):
        return x
    return _Reduce.apply(x, mesh, axis, tag)


def psum_both(x: torch.Tensor, mesh, axis: str, *,
              tag: str = "tp") -> torch.Tensor:
    """The sum over ``axis`` forward and backward: a sum whose result each
    rank uses for its own part of the work, so that its gradient is
    partial too (the gated norm's sum of squares over ``d_inner``)."""
    if _trivial(mesh, axis):
        return x
    return _PsumBoth.apply(x, mesh, axis, tag)


def gather_rows(x: torch.Tensor, mesh, axis: str, dim: int = 0, *,
                tag: str = "tp") -> torch.Tensor:
    """Every rank's block along ``dim`` over ``axis``; backward, this
    rank's block of the (replicated) gradient."""
    if _trivial(mesh, axis):
        return x
    return _GatherRows.apply(x, mesh, axis, dim, tag)


def all_to_all_grad(x: torch.Tensor, mesh, axis: str, *,
                    tag: str = "tp") -> torch.Tensor:
    """`all_to_all` with the reverse exchange as its backward."""
    if _trivial(mesh, axis):
        return x
    return _AllToAll.apply(x, mesh, axis, tag)
