"""Feature importances and leaf embeddings straight from packed buffers.

Port of the JAX package's ``explain/importance.py``.  No training data is
touched: gains and per-node covers ride the `PackedForest`.  Internal
nodes are recognised from the pointers (``left != self``); pass-through
nodes (the padding the depth-wise grower emits when no positive-gain split
exists) are excluded through the cover tensor: a real split routes weight
to both children, so ``cover[right_child] > 0``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import ref

IMPORTANCE_KINDS = ("gain", "cover", "split_count")


def real_split_mask(pf) -> torch.Tensor:
    """(T, N) bool: nodes carrying an actual split."""
    if pf.cover is None:
        raise ValueError(
            "feature importances need the per-node cover tensor; this "
            "PackedForest was packed without one (format_version 1 "
            "checkpoint?) — retrain/re-checkpoint to enable importances.")
    ids = torch.arange(pf.n_nodes, dtype=torch.int32, device=pf.left.device)
    internal = pf.left != ids[None, :]
    right_cover = torch.gather(pf.cover, 1, pf.right.long())
    return internal & (right_cover > 0)


def feature_importances(pf, *, kind: str = "gain",
                        n_features: Optional[int] = None,
                        normalize: bool = True) -> torch.Tensor:
    """Per-feature importance vector ``(n_features,)`` on the forest's
    device.

    ``gain``: summed split gains (needs ``pf.gain``); ``cover``: summed
    weighted row counts through each split; ``split_count``: number of real
    splits.  Normalised to sum to 1 by default.  The sums run on the host in
    a fixed order: node after node in (tree, node) order, then the total
    feature after feature.
    """
    if kind not in IMPORTANCE_KINDS:
        raise ValueError(f"unknown importance kind {kind!r}; "
                         f"expected one of {IMPORTANCE_KINDS}")
    mask = real_split_mask(pf).to(torch.float32)
    if kind == "gain":
        if pf.gain is None:
            raise ValueError("gain importances need the packed gain tensor "
                             "(absent on this forest); use kind='cover' or "
                             "'split_count'")
        w = pf.gain * mask
    elif kind == "cover":
        w = pf.cover * mask
    else:
        w = mask
    feat = pf.feat.reshape(-1).cpu().numpy()
    w = w.reshape(-1).cpu().numpy()
    if n_features is None:
        n_features = int(feat.max()) + 1
    keep = feat < n_features
    imp = np.zeros(n_features, np.float32)
    np.add.at(imp, feat[keep], w[keep])
    if normalize and n_features:
        total = np.add.accumulate(imp)[-1]
        if total > 0:
            imp = imp / total
    return torch.from_numpy(imp).to(pf.feat.device)


def apply_forest(pf, codes: torch.Tensor) -> torch.Tensor:
    """Terminal-node embeddings: ``(n, T)`` int32, the node id each row
    lands in per tree (a pointer walk of `ref.node_walk_ref` per tree).
    For heap-canonical trees leaf ``j`` of a depth-``D`` tree is
    ``2^D - 1 + j``."""
    out = torch.empty((codes.shape[0], pf.n_trees), dtype=torch.int32,
                      device=codes.device)
    for t in range(pf.n_trees):
        out[:, t] = ref.node_walk_ref(pf.feat[t], pf.thr[t], pf.left[t],
                                      pf.right[t], codes, depth=pf.depth)
    return out
