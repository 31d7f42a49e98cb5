"""Histogram-algorithm feature quantization (<=256 bins, uint8 codes).

Port of the JAX package's ``core/quantize.py`` (feature half): quantile
edges are fitted once on the host with numpy, and codes are
``searchsorted(edges, x, side="left") + 1`` with NaN -> ``MISSING_BIN = 0``.
Codes come out feature-major, ``(m, n)`` uint8, the layout the histogram
kernel reads; `codes_rows` gives the row-major ``(n, m)`` twin that routing
and the traversal kernel read.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

MAX_BINS = 256
MISSING_BIN = 0    # uint8 code of the dedicated NaN/missing bin


class Quantizer(NamedTuple):
    """Per-feature bin edges.  ``edges[f, j]`` is the upper edge of bin j+1.

    Bin layout (uint8 codes): 0 -> NaN / missing; 1 .. n_bins - 1 ->
    quantile buckets.
    """
    edges: torch.Tensor       # (m, n_bins - 1) float32, padded with +inf
    n_bins: int


def fit_quantizer(X: np.ndarray, n_bins: int = MAX_BINS,
                  sample_rows: int = 200_000, seed: int = 0,
                  device="cpu") -> Quantizer:
    """Per-feature quantile edges on the host (one-time, O(n m log n)).

    A uniform row subsample of ``sample_rows`` caps the sort cost; duplicate
    quantiles leave bins empty; all-NaN columns get every edge at ``+inf``.
    """
    if not 2 <= n_bins <= MAX_BINS:
        raise ValueError(f"n_bins must be in [2, {MAX_BINS}], got {n_bins}")
    n, m = X.shape
    if n > sample_rows:
        rng = np.random.default_rng(seed)
        X = X[rng.choice(n, sample_rows, replace=False)]
    qs = np.linspace(0.0, 1.0, n_bins)[1:-1]
    with np.errstate(all="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore", category=RuntimeWarning)
        edges = np.nanquantile(X.astype(np.float64), qs, axis=0).T
    edges = np.concatenate([edges, np.full((m, 1), np.inf)], axis=1)
    edges = np.nan_to_num(edges, nan=np.inf, posinf=np.inf)
    return Quantizer(edges=torch.as_tensor(edges.astype(np.float32),
                                           device=device), n_bins=n_bins)


def apply_quantizer(q: Quantizer, X: torch.Tensor) -> torch.Tensor:
    """Bin features: (n, m) float32 -> (m, n) uint8 feature-major codes."""
    Xt = X.to(torch.float32).t().contiguous()                  # (m, n)
    codes = torch.searchsorted(q.edges, Xt, side="left") + 1
    codes = torch.where(torch.isnan(Xt), MISSING_BIN, codes)
    return codes.to(torch.uint8)


def codes_rows(codes_t: torch.Tensor) -> torch.Tensor:
    """(m, n) feature-major codes -> (n, m) row-major codes."""
    return codes_t.t().contiguous()
