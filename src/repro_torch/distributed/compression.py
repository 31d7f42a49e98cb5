"""Sketched all-reduce: the paper's Random Projection operator applied to
a collective (the JAX package's ``distributed/compression.py``).

Each block ``g in R^{a x b}`` is compressed to ``g @ Pi`` with the JL
matrix ``Pi in R^{b x k}`` (N(0, 1/k) entries, Sec. 3.3 of the paper),
all-reduced at k/b of the bytes, and reconstructed by least squares
(`decompress_block`).  `sketched_psum` keeps the compression residual on
the rank and adds it back at the next call (error feedback).

``Pi`` is the same on every rank and never sent: a caller passes it in
(the tests replay the reference's draws), or every rank draws it from a
``torch.Generator`` seeded alike.  Products run in full float32 (TF32
off).
"""
from __future__ import annotations

import math
from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.sketch import _full_fp32
from repro_torch.distributed import collectives as C
from repro_torch.io.checkpoint import _flatten, _unflatten

Tree = Any


def _as_matrix(g: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    shape = tuple(g.shape)
    if g.ndim == 0:
        return g.reshape(1, 1), shape
    if g.ndim == 1:
        return g.reshape(1, -1), shape
    return g.reshape(-1, shape[-1]), shape


def jl_matrix(b: int, k: int, generator: torch.Generator,
              device=None) -> torch.Tensor:
    """A (b, k) JL matrix, N(0, 1/k) entries, drawn from ``generator``."""
    z = torch.randn((b, k), generator=generator, dtype=torch.float32,
                    device=device)
    return z / math.sqrt(float(k))


def compress_block(g: torch.Tensor, k: int, *,
                   Pi: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None):
    """``g -> (sketch (a, k), Pi, shape)``; a block whose last dim is at
    most k passes through unsketched (``Pi`` None).  ``Pi`` (b, k) is the
    draw, or it comes from ``generator``."""
    mat, shape = _as_matrix(g.to(torch.float32))
    b = mat.shape[1]
    if b <= k:
        return mat, None, shape
    if Pi is None:
        if generator is None:
            raise ValueError("compress_block needs Pi or a generator")
        Pi = jl_matrix(b, k, generator, device=mat.device)
    Pi = Pi.to(device=mat.device, dtype=torch.float32)
    with _full_fp32():
        return mat @ Pi, Pi, shape


def decompress_block(sketch: torch.Tensor, Pi: Optional[torch.Tensor],
                     shape: Tuple[int, ...]) -> torch.Tensor:
    """Least-squares reconstruction ``sketch @ (Pi^T Pi + 1e-6 I)^-1 Pi^T``:
    the orthogonal projection of g's rows onto colspace(Pi), a contractive
    compressor, as error feedback needs (the reference's regularised k x k
    solve)."""
    if Pi is None:
        return sketch.reshape(shape)
    with _full_fp32():
        gram = Pi.T @ Pi
        eye = torch.eye(gram.shape[0], dtype=gram.dtype, device=gram.device)
        rec = torch.linalg.solve(gram + 1e-6 * eye, sketch.T).T
        return (rec @ Pi.T).reshape(shape)


def sketched_psum(grads: Tree, mesh, axis: str, *, k: int = 32,
                  residuals: Optional[Tree] = None,
                  Pis: Optional[Sequence[Optional[torch.Tensor]]] = None,
                  generator: Optional[torch.Generator] = None,
                  tag: str = "grads") -> Tuple[Tree, Tree]:
    """All-reduce the mean of ``grads`` (a tensor, or nested dicts, lists
    and tuples of them) over ``axis`` through a JL sketch.  Returns
    ``(mean grads, new error-feedback residuals)``.  ``Pis`` gives each
    leaf's matrix in `io.checkpoint._flatten`'s order (None for a leaf
    that passes through); without it each leaf's comes from
    ``generator``."""
    flat = [v for _, v in _flatten(grads)]
    res = ([v for _, v in _flatten(residuals)] if residuals is not None
           else [torch.zeros_like(g, dtype=torch.float32) for g in flat])
    n = mesh.axis_size(axis)
    out: List[torch.Tensor] = []
    new_res: List[torch.Tensor] = []
    for i, (g, r) in enumerate(zip(flat, res)):
        corrected = g.to(torch.float32) + r
        sk, Pi, shape = compress_block(
            corrected, k, Pi=None if Pis is None else Pis[i],
            generator=generator)
        sk = C.psum(sk, mesh, axis, tag=tag) / n
        approx = decompress_block(sk, Pi, shape)
        new_res.append(corrected - approx)
        out.append(approx.to(g.dtype))
    return _unflatten(grads, iter(out)), _unflatten(grads, iter(new_res))


def exact_psum(grads: Tree, mesh, axis: str, *, tag: str = "grads") -> Tree:
    """The mean of ``grads`` over ``axis``, exactly."""
    n = mesh.axis_size(axis)
    flat = [C.psum(v, mesh, axis, tag=tag) / n for _, v in _flatten(grads)]
    return _unflatten(grads, iter(flat))


def compression_ratio(grads: Tree, k: int) -> float:
    """Bytes of the sketched all-reduce over those of the exact one."""
    full = sketched = 0
    for _, g in _flatten(grads):
        a, b = _as_matrix(g)[0].shape
        full += a * b
        sketched += a * min(b, k)
    return sketched / max(full, 1)
