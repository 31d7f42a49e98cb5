"""Carry a fitted state of the JAX package over to the port.

The JAX package's fitted objects are given as numpy arrays (``np.asarray``
of each field), so this module needs nothing of JAX.  Both packages then
compute on the same forest, quantizer or tree.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.core.forest import PackedForest
from repro_torch.core.quantize import Quantizer
from repro_torch.core.tree import Tree

_INT_FIELDS = ("feat", "thr", "left", "right", "out_col", "node_count")
_FLOAT_FIELDS = ("leaf", "base", "cover", "gain")


def packed_forest_from_arrays(arrays: Mapping[str, Optional[np.ndarray]], *,
                              depth: int, device="cpu") -> PackedForest:
    """`PackedForest` from the reference's fields (feat, thr, left, right,
    leaf, out_col, base, lr, cover, gain, node_count) and its walk bound."""
    fields = {}
    for k in _INT_FIELDS + _FLOAT_FIELDS:
        v = arrays.get(k)
        if v is not None:
            dtype = torch.int32 if k in _INT_FIELDS else torch.float32
            fields[k] = torch.as_tensor(np.ascontiguousarray(v), dtype=dtype,
                                        device=device)
    fields["lr"] = torch.tensor(float(np.asarray(arrays["lr"])),
                                dtype=torch.float32)
    return PackedForest(depth=int(depth), **fields)


def quantizer_from_edges(edges: np.ndarray, n_bins: int,
                         device="cpu") -> Quantizer:
    """`Quantizer` from the reference's (m, n_bins - 1) bin edges."""
    return Quantizer(edges=torch.as_tensor(np.asarray(edges, np.float32),
                                           device=device), n_bins=n_bins)


def tree_from_arrays(feat, thr, value, gain, cover=None,
                     device="cpu") -> Tree:
    """A training-side heap `Tree` from the reference's tree buffers."""
    def t(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    return Tree(feat=t(feat, torch.int32), thr=t(thr, torch.int32),
                value=t(value, torch.float32), gain=t(gain, torch.float32),
                cover=None if cover is None else t(cover, torch.float32))
