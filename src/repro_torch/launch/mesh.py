"""Meshes of ranks on ``torch.distributed`` (the JAX package's
``launch/mesh.py``).

A `Mesh` is a grid of ranks, ``(data, model)`` or ``(pod, data, model)``,
laid out row-major over the first ``prod(shape)`` ranks of the world: rank
``r`` sits at ``unravel_index(r, shape)``.  Each axis is one
``torch.distributed`` process group a rank, the ranks that share every
other coordinate.  The collectives on an axis (`repro_torch.distributed.
collectives`) count the bytes they all-reduce into `Mesh.counted`.

The backend is the caller's: NCCL with one card a rank, gloo where several
ranks share a card (NCCL refuses two ranks on one GPU) or on the CPU.
Nothing here switches backend or device when one fails.  Under
``torchrun`` `make_mesh` initialises the world from its ``env://``
variables; a world started by `repro_torch.launch.dist` is already up.
An `AbstractMesh` has the axes and sizes alone, for planning a world one
does not have (`make_production_mesh`, the dry run).
"""
from __future__ import annotations

import collections
import math
import os
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.device import resolve_device


class MeshSpec(NamedTuple):
    """A mesh's shape and axis names, without its process groups: what a
    new world is started with (`runtime.elastic.shrink_data_axis`)."""
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]


class Mesh:
    """This rank's place in a grid of ranks: ``axes`` and ``shape``,
    ``coords`` (axis -> index), one process group an axis, the ``device``
    its tensors live on, ``by_op`` and ``calls``, the bytes handed to
    collectives so far and the calls, keyed ``(op, axis, tag)`` (an op's
    payload is the buffer it reduces or exchanges, or for an all-gather the
    block each rank adds; `roofline.analysis.counted_collectives` turns
    them into ring bytes), and ``counted``, the bytes keyed ``(axis,
    tag)``."""

    def __init__(self, spec: MeshSpec, rank: int, groups: Dict[str, object],
                 device: torch.device):
        self.axes = tuple(spec.axes)
        self.shape = tuple(int(s) for s in spec.shape)
        self.rank = rank
        self.coords = dict(zip(self.axes,
                               (int(i) for i in
                                np.unravel_index(rank, self.shape))))
        self.groups = groups
        self.device = device
        self.by_op: collections.Counter = collections.Counter()
        self.calls: collections.Counter = collections.Counter()

    @property
    def spec(self) -> MeshSpec:
        return MeshSpec(self.shape, self.axes)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axes.index(axis)]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def block_index(self, axes: Sequence[str]) -> Tuple[int, int]:
        """This rank's block along ``axes`` taken together (row-major) and
        the number of blocks: the row shard of ``("pod", "data")``."""
        idx, total = 0, 1
        for ax in axes:
            idx = idx * self.axis_size(ax) + self.index(ax)
            total *= self.axis_size(ax)
        return idx, total

    @property
    def counted(self) -> collections.Counter:
        out: collections.Counter = collections.Counter()
        for (_, axis, tag), n in self.by_op.items():
            out[(axis, tag)] += n
        return out

    def count(self, axis: str, tag: str, n_bytes: int,
              op: str = "all-reduce") -> None:
        self.by_op[(op, axis, tag)] += int(n_bytes)
        self.calls[(op, axis, tag)] += 1

    def reset_counts(self) -> None:
        self.by_op.clear()
        self.calls.clear()

    def gather(self, x: torch.Tensor, rows: Sequence[str] = ("data",),
               cols: Optional[str] = "model") -> torch.Tensor:
        """Assemble the whole array from every rank's block: ``x`` is this
        rank's block, dim 0 split over ``rows`` and dim 1 over ``cols``."""
        from repro_torch.distributed import collectives as C
        if cols is not None:
            parts = C.all_gather(x, self, cols, tag="gather")
            x = torch.cat(list(parts), 1)
        for ax in reversed(tuple(rows)):
            x = torch.cat(list(C.all_gather(x, self, ax, tag="gather")), 0)
        return x

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, axes={self.axes}, "
                f"rank={self.rank}, device={self.device})")


def _axis_groups(shape: Tuple[int, ...], axis: int):
    """The rank lists of one axis: ranks that share every other
    coordinate, each list in the axis' order."""
    ranks = np.arange(math.prod(shape)).reshape(shape)
    moved = np.moveaxis(ranks, axis, -1).reshape(-1, shape[axis])
    return [list(map(int, g)) for g in moved]


def _init_from_env(backend: Optional[str]) -> None:
    """Start the world from ``torchrun``'s ``env://`` variables."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        raise RuntimeError(
            "torch.distributed is not initialised and RANK/WORLD_SIZE are "
            "not set: start the ranks with torchrun, or through "
            "repro_torch.launch.dist.spawn")
    if backend is None:
        raise ValueError("name the backend ('nccl' with one card a rank, "
                         "'gloo' otherwise) to start the world")
    dist.init_process_group(backend=backend, init_method="env://")


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], *,
              backend: Optional[str] = None, device=None) -> Optional[Mesh]:
    """A mesh of ``shape`` over the first ``prod(shape)`` ranks of the
    world, one process group an axis.  Every rank of the world must call
    it (group creation is collective); a rank outside the mesh gets None.

    ``device`` follows the device rule (CUDA unless named); under
    ``torchrun`` the default card is ``LOCAL_RANK``'s.  ``backend`` names
    the world's backend when this call starts it, and must agree with it
    otherwise."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    if not dist.is_initialized():
        _init_from_env(backend)
    world = dist.get_world_size()
    if backend is not None and dist.get_backend() != backend:
        raise ValueError(f"the world runs {dist.get_backend()!r}, not "
                         f"{backend!r}")
    need = math.prod(shape)
    if need > world:
        raise ValueError(f"a {shape} mesh needs {need} ranks; the world has "
                         f"{world}")
    if device is None and "LOCAL_RANK" in os.environ \
            and torch.cuda.is_available():
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    rank = dist.get_rank()
    groups = {}
    for i, ax in enumerate(axes):
        for ranks in _axis_groups(shape, i):
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[ax] = g
    if rank >= need:
        return None
    return Mesh(MeshSpec(shape, axes), rank, groups, device)


def device_subset_mesh(n_devices: int, model_parallel: int = 1,
                       axes: Tuple[str, str] = ("data", "model"), *,
                       backend: Optional[str] = None,
                       device=None) -> Optional[Mesh]:
    """A ``(n_devices // model_parallel, model_parallel)`` mesh over the
    first ``n_devices`` ranks."""
    if n_devices % model_parallel:
        raise ValueError(f"n_devices={n_devices} not divisible by "
                         f"model_parallel={model_parallel}")
    return make_mesh((n_devices // model_parallel, model_parallel), axes,
                     backend=backend, device=device)


def host_device_mesh(model_parallel: int = 1, pods: int = 1, *,
                     backend: Optional[str] = None,
                     device=None) -> Optional[Mesh]:
    """A mesh over every rank of the world: ``(data, model)``, or
    ``(pod, data, model)`` with ``pods > 1``; ``model_parallel`` falls back
    to 1 where it does not divide the world."""
    if not dist.is_initialized():
        _init_from_env(backend)
    n = dist.get_world_size()
    mp = model_parallel if n % model_parallel == 0 else 1
    dp = n // mp // pods
    if pods > 1:
        return make_mesh((pods, dp, mp), ("pod", "data", "model"),
                         backend=backend, device=device)
    return make_mesh((dp, mp), ("data", "model"), backend=backend,
                     device=device)


class AbstractMesh:
    """A mesh's axis names and sizes, with no ranks and no process groups
    (the reference's ``jax.sharding.AbstractMesh``): what the dry run plans
    a world of 256 or 512 cards on.  It has the ``axes``, ``shape`` and
    ``size`` of a `Mesh`, so the partition specs
    (`models.params.partition_spec`, `models.lm.cache_pspecs`,
    `core.distributed.gbdt_input_specs`) take either kind."""

    def __init__(self, shape: Tuple[int, ...], axes: Tuple[str, ...]):
        if len(shape) != len(axes):
            raise ValueError(f"shape {tuple(shape)} and axes {tuple(axes)} "
                             f"differ in length")
        self.shape = tuple(int(s) for s in shape)
        self.axes = tuple(axes)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def __repr__(self) -> str:
        return f"AbstractMesh(shape={self.shape}, axes={self.axes})"


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The reference's production meshes, abstract: ``(16, 16)`` over
    ``("data", "model")`` (256 cards), or ``(2, 16, 16)`` over ``("pod",
    "data", "model")`` (512).  For the dry run's specs and roofline; a
    mesh of real ranks comes from `make_mesh`."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))
