"""Sketched split statistics (paper Section 3): ``G_k = G @ Pi``.

Port of the JAX package's ``core/sketch.py`` for the two sketches of this
slice: ``random_projection`` (JL Gaussian, i.i.d. N(0, 1/k) entries, the
paper's default) and ``none``.  The identity applies whenever ``k >= d``.

``torch.Generator`` cannot reproduce the JAX package's threefry streams, so
``Pi`` is either drawn from a caller's generator or passed in (parity tests
replay the reference's draws).  ``G @ Pi`` is a plain large matrix product,
left to ``torch.matmul`` in full float32: TF32 is switched off for that one
product and the caller's setting restored after it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

SKETCH_METHODS = ("none", "random_projection")


def random_projection_matrix(d: int, k: int, generator: torch.Generator,
                             device=None) -> torch.Tensor:
    """JL projection: i.i.d. N(0, 1/k) entries, (d, k) float32."""
    z = torch.randn((d, k), generator=generator, dtype=torch.float32,
                    device=device)
    return z / math.sqrt(float(k))


def build_sketch(G: torch.Tensor, *, method: str, k: int,
                 Pi: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Sketch ``G_k`` of the gradient matrix ``G`` (n, d) -> (n, k).

    ``method='none'`` or ``k >= d`` returns G unchanged (SketchBoost Full).
    Otherwise ``Pi`` (d, k) is used when given, else drawn from
    ``generator``.
    """
    d = G.shape[1]
    if method not in SKETCH_METHODS:
        raise ValueError(f"unknown sketch method {method!r}; this slice "
                         f"supports {SKETCH_METHODS}")
    if method == "none" or k >= d:
        return G.to(torch.float32)
    if Pi is None:
        if generator is None:
            raise ValueError("random_projection needs Pi or a generator")
        Pi = random_projection_matrix(d, k, generator, device=G.device)
    matmul = torch.backends.cuda.matmul
    allow_tf32, matmul.allow_tf32 = matmul.allow_tf32, False
    try:
        return G.to(torch.float32) @ Pi.to(device=G.device,
                                           dtype=torch.float32)
    finally:
        matmul.allow_tf32 = allow_tf32
