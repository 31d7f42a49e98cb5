"""Feature quantization (<=256 bins, uint8 codes) and forest quantization.

Port of the JAX package's ``core/quantize.py``.  Feature half: quantile
edges are fitted once on the host with numpy, and codes are
``searchsorted(edges, x, side="left") + 1`` with NaN -> ``MISSING_BIN = 0``.
Codes come out feature-major, ``(m, n)`` uint8, the layout the histogram
kernel reads; `codes_rows` gives the row-major ``(n, m)`` twin that routing
and the traversal kernels read.

Forest half: `QuantizedForest` stores a trained forest for serving with
uint8 thresholds (bin codes, so every split decision is exact) and int8 or
bfloat16 leaf blocks with a per-tree float32 ``leaf_scale``.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.device import resolve_device

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
                  device=None) -> Quantizer:
    """Per-feature quantile edges on the host (one-time, O(n m log n)),
    placed on ``device`` (the device rule: CUDA unless named).

    A uniform row subsample of ``sample_rows`` caps the sort cost; duplicate
    quantiles leave bins empty; all-NaN columns get every edge at ``+inf``.
    """
    device = resolve_device(device)
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


# ---------------------------------------------------------------------------
# Forest quantization for serving.  Thresholds are bin codes (< MAX_BINS), so
# uint8 storage takes the same branch at every node as the fp32 forest.  Only
# the leaf blocks are lossy: bfloat16 (round to nearest even; widening back to
# float32 is exact) or int8 with one symmetric float32 scale per tree.
# ---------------------------------------------------------------------------

QUANTIZE_DTYPES = ("bfloat16", "int8")


class QuantizedForest(NamedTuple):
    """A `core.forest.PackedForest` with quantized storage: ``thr`` is
    uint8, ``leaf`` int8 or bfloat16, and ``leaf_scale`` (T, 1) float32 is
    the per-tree scale (ones for bfloat16).  The dequantized leaf is
    ``leaf.float() * leaf_scale[t]``.  The presence of ``leaf_scale`` is
    what `core.forest.predict_raw` and `io.checkpoint` dispatch on."""
    feat: torch.Tensor
    thr: torch.Tensor
    left: torch.Tensor
    right: torch.Tensor
    leaf: torch.Tensor
    leaf_scale: torch.Tensor
    out_col: torch.Tensor
    base: torch.Tensor
    lr: torch.Tensor
    cover: Optional[torch.Tensor] = None
    gain: Optional[torch.Tensor] = None
    node_count: Optional[torch.Tensor] = None
    depth: int = 0

    @property
    def n_trees(self) -> int:
        return self.feat.shape[0]

    @property
    def n_nodes(self) -> int:
        return self.feat.shape[1]

    @property
    def leaf_width(self) -> int:
        return self.leaf.shape[2]

    @property
    def n_outputs(self) -> int:
        return self.base.shape[0]

    @property
    def trees_per_round(self) -> int:
        return 1 if self.leaf_width == self.n_outputs else self.n_outputs

    @property
    def n_rounds(self) -> int:
        return self.n_trees // self.trees_per_round

    @property
    def nbytes(self) -> int:
        """Model bytes at rest (thresholds, pointers, leaves, scales)."""
        return sum(x.numel() * x.element_size() for x in
                   (self.feat, self.thr, self.left, self.right, self.leaf,
                    self.leaf_scale, self.out_col, self.base))


def quantize_forest(pf, dtype: str = "bfloat16") -> QuantizedForest:
    """Quantize a `PackedForest` for serving: uint8 thresholds and
    ``dtype`` leaves, on the forest's device.

    ``int8`` stores one symmetric per-tree scale ``max|leaf| / 127``,
    computed in float32 numpy as the reference does, so scales and codes
    are bitwise the reference's; the worst-case leaf error is ``scale / 2``
    per tree.
    """
    if dtype not in QUANTIZE_DTYPES:
        raise ValueError(f"quantize dtype must be one of {QUANTIZE_DTYPES}, "
                         f"got {dtype!r}")
    thr = pf.thr.cpu().numpy()
    if thr.size and (thr.min() < 0 or thr.max() >= MAX_BINS):
        raise ValueError(
            f"thresholds outside the uint8 bin-code range "
            f"[0, {MAX_BINS}): [{thr.min()}, {thr.max()}] — this forest was "
            "not trained on binned codes and cannot be threshold-quantized")
    device = pf.feat.device
    t = pf.leaf.shape[0]
    if dtype == "bfloat16":
        leaf_q = pf.leaf.to(torch.float32).to(torch.bfloat16)
        scale = torch.ones((t, 1), dtype=torch.float32, device=device)
    else:
        leaf = pf.leaf.cpu().numpy().astype(np.float32)
        amax = np.abs(leaf).reshape(t, -1).max(axis=1)     # (T,)
        scale_np = np.maximum(amax, 1e-30) / 127.0
        q = np.clip(np.rint(leaf / scale_np[:, None, None]), -127, 127)
        leaf_q = torch.from_numpy(q.astype(np.int8)).to(device)
        scale = torch.from_numpy(scale_np[:, None].astype(np.float32)).to(
            device)
    return QuantizedForest(
        feat=pf.feat.to(torch.int32), thr=pf.thr.to(torch.uint8),
        left=pf.left.to(torch.int32), right=pf.right.to(torch.int32),
        leaf=leaf_q, leaf_scale=scale, out_col=pf.out_col.to(torch.int32),
        base=pf.base.to(torch.float32), lr=pf.lr.to(torch.float32),
        cover=pf.cover, gain=pf.gain, node_count=pf.node_count,
        depth=int(pf.depth))


def dequantize_forest(qf: QuantizedForest):
    """The float32 `PackedForest` twin of a `QuantizedForest`: it predicts
    bitwise as the quantized traversal does (both dequantize with the same
    ``leaf.float() * scale``)."""
    from repro_torch.core.forest import PackedForest
    leaf = qf.leaf.to(torch.float32) * qf.leaf_scale[:, :, None].to(
        torch.float32)
    return PackedForest(
        feat=qf.feat, thr=qf.thr.to(torch.int32), left=qf.left,
        right=qf.right, leaf=leaf, out_col=qf.out_col, base=qf.base,
        lr=qf.lr, cover=qf.cover, gain=qf.gain, node_count=qf.node_count,
        depth=int(qf.depth))
