"""Sketched split statistics (paper Section 3, Appendix A): ``G_k = G @ Pi``.

Port of the JAX package's ``core/sketch.py``.  Each method builds a (d, k)
operator ``Pi``; the identity applies for ``"none"`` and whenever ``k >= d``
(SketchBoost Full):

- ``top_outputs`` (Sec. 3.1): one-hot of the k largest column norms;
- ``random_sampling`` (Sec. 3.2): k columns drawn with replacement with
  probability ``p_j ~ ||g_j||^2``, scaled ``1/sqrt(k p_j)``;
- ``random_projection`` (Sec. 3.3): i.i.d. N(0, 1/k) entries;
- ``truncated_svd`` (App. A.1): the top-k eigenvectors of ``G^T G``.

``torch.Generator`` cannot reproduce the JAX package's threefry streams, so
each random method's draw is either made from a caller's generator or
passed in as `build_sketch`'s ``draw`` (parity tests replay the reference's
draws): ``Pi`` itself for ``random_projection``, and for
``random_sampling`` the (k, d) Gumbel noise from which the reference's
``jax.random.categorical`` takes its arg-max.
``G @ Pi`` and ``G^T G`` are plain large matrix products, left to
``torch.matmul`` in full float32: TF32 is switched off for those products
and the caller's setting restored after them.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch

SKETCH_METHODS = ("none", "top_outputs", "random_sampling",
                  "random_projection", "truncated_svd")


@contextlib.contextmanager
def _full_fp32():
    """Matrix products in full float32 (TF32 off), restoring the caller's
    setting after."""
    matmul = torch.backends.cuda.matmul
    allow_tf32, matmul.allow_tf32 = matmul.allow_tf32, False
    try:
        yield
    finally:
        matmul.allow_tf32 = allow_tf32


def column_sq_norms(G: torch.Tensor) -> torch.Tensor:
    """Squared column norms ``||g_j||^2`` of G, (d,) float32."""
    return torch.square(G.to(torch.float32)).sum(0)


def _one_hot_columns(idx: torch.Tensor, d: int) -> torch.Tensor:
    """(d, k) float32 with a one at ``(idx[j], j)``."""
    k = idx.shape[0]
    Pi = torch.zeros((d, k), dtype=torch.float32, device=idx.device)
    Pi[idx, torch.arange(k, device=idx.device)] = 1.0
    return Pi


def top_outputs_selector(norms: torch.Tensor, k: int) -> torch.Tensor:
    """One-hot (d, k) selector of the k columns with the largest norm,
    largest first; equal norms go to the lower index first, as
    ``jax.lax.top_k`` orders them (a stable descending sort)."""
    idx = torch.sort(norms, descending=True, stable=True).indices[:k]
    return _one_hot_columns(idx, norms.shape[0])


def gumbel_noise(k: int, d: int, generator: torch.Generator,
                 device=None) -> torch.Tensor:
    """(k, d) standard Gumbel noise, ``-log(-log(U))`` with U uniform on
    ``[tiny, 1)``, the recipe of ``jax.random.gumbel``."""
    u = torch.rand((k, d), generator=generator, dtype=torch.float32,
                   device=device).clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def random_sampling_selector(norms: torch.Tensor, k: int,
                             noise: torch.Tensor) -> torch.Tensor:
    """Importance-sampled (d, k) selector, scaled ``1/sqrt(k p_j)`` for
    unbiasedness, ``p_j = ||g_j||^2 / sum_i ||g_i||^2`` (uniform when every
    norm is zero).  Column j picks ``argmax(noise[j] + log p)``: ``noise``
    (k, d) Gumbel noise makes that a draw from ``p``, i.i.d. with
    replacement (the reference's ``jax.random.categorical``)."""
    d = norms.shape[0]
    total = norms.sum()
    p = torch.where(total > 0, norms / torch.clamp(total, min=1e-30),
                    torch.full_like(norms, 1.0 / d))
    logits = torch.log(torch.clamp(p, min=1e-30))
    idx = torch.argmax(noise.to(torch.float32) + logits[None, :], dim=1)
    scale = 1.0 / torch.sqrt(k * torch.clamp(p[idx], min=1e-30))
    return _one_hot_columns(idx, d) * scale[None, :]


def random_projection_matrix(d: int, k: int, generator: torch.Generator,
                             device=None) -> torch.Tensor:
    """JL projection: i.i.d. N(0, 1/k) entries, (d, k) float32."""
    z = torch.randn((d, k), generator=generator, dtype=torch.float32,
                    device=device)
    return z / math.sqrt(float(k))


def truncated_svd_projector(G: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k right singular subspace of G: the eigenvectors of the d x d
    Gram ``G^T G`` with the k largest eigenvalues, (d, k).  Their signs, and
    rotations inside a repeated eigenvalue, are free; the split score
    ``||sum g||^2`` does not see them."""
    Gf = G.to(torch.float32)
    with _full_fp32():
        gram = Gf.T @ Gf
    return torch.linalg.eigh(gram).eigenvectors[:, -k:]   # ascending


def _generator(generator: Optional[torch.Generator],
               method: str) -> torch.Generator:
    if generator is None:
        raise ValueError(f"{method} needs its draw or a generator")
    return generator


def build_sketch(G: torch.Tensor, *, method: str, k: int,
                 draw: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Sketch ``G_k`` of the gradient matrix ``G`` (n, d) -> (n, k).

    ``method='none'`` or ``k >= d`` returns G unchanged (SketchBoost Full).
    ``draw`` is the method's own random draw: ``Pi`` (d, k) for
    ``random_projection``, the Gumbel noise (k, d) for ``random_sampling``.
    Without it those two draw from ``generator``; the other methods draw
    nothing and ignore it.
    """
    d = G.shape[1]
    if method not in SKETCH_METHODS:
        raise ValueError(f"unknown sketch method {method!r}")
    if method == "none" or k >= d:
        return G.to(torch.float32)
    if draw is not None:
        draw = draw.to(device=G.device, dtype=torch.float32)
    if method == "top_outputs":
        Pi = top_outputs_selector(column_sq_norms(G), k)
    elif method == "random_sampling":
        if draw is None:
            draw = gumbel_noise(k, d, _generator(generator, method),
                                device=G.device)
        Pi = random_sampling_selector(column_sq_norms(G), k, draw)
    elif method == "random_projection":
        Pi = draw if draw is not None else random_projection_matrix(
            d, k, _generator(generator, method), device=G.device)
    else:
        Pi = truncated_svd_projector(G, k)
    with _full_fp32():
        return G.to(torch.float32) @ Pi
