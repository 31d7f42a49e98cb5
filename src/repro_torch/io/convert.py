"""Carry a fitted state of the JAX package over to the port.

The JAX package's fitted objects are given as numpy arrays (``np.asarray``
of each field), so this module needs nothing of JAX.  Both packages then
compute on the same forest, quantizer, tree or path pack.  Every helper
places its tensors by the device rule: CUDA unless ``device`` names another
device.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.forest import PackedForest
from repro_torch.core.quantize import QuantizedForest, Quantizer
from repro_torch.core.tree import Tree
from repro_torch.explain.paths import PathPack

_INT_FIELDS = ("feat", "thr", "left", "right", "out_col", "node_count")
_FLOAT_FIELDS = ("leaf", "base", "cover", "gain")


def _fields(arrays, dtypes, device) -> dict:
    out = {}
    for k, dtype in dtypes.items():
        v = arrays.get(k)
        if v is not None:
            out[k] = torch.as_tensor(np.array(v), dtype=dtype, device=device)
    # lr stays a host scalar: the kernels take it as a float argument.
    out["lr"] = torch.tensor(float(np.asarray(arrays["lr"])),
                             dtype=torch.float32)
    return out


def packed_forest_from_arrays(arrays: Mapping[str, Optional[np.ndarray]], *,
                              depth: int, device=None) -> PackedForest:
    """`PackedForest` from the reference's fields (feat, thr, left, right,
    leaf, out_col, base, lr, cover, gain, node_count) and its walk bound."""
    dtypes = {k: torch.int32 for k in _INT_FIELDS}
    dtypes.update({k: torch.float32 for k in _FLOAT_FIELDS})
    return PackedForest(depth=int(depth),
                        **_fields(arrays, dtypes, resolve_device(device)))


def quantized_forest_from_arrays(arrays: Mapping[str, Optional[np.ndarray]],
                                 *, depth: int, device=None
                                 ) -> QuantizedForest:
    """`QuantizedForest` from the reference's fields.  ``thr`` is uint8,
    ``leaf`` int8, or bfloat16 given as its ``uint16`` bit view (numpy has
    no bfloat16: pass ``np.asarray(qf.leaf).view(np.uint16)``)."""
    device = resolve_device(device)
    dtypes = {k: torch.int32 for k in _INT_FIELDS if k != "thr"}
    dtypes.update(thr=torch.uint8, base=torch.float32, cover=torch.float32,
                  gain=torch.float32, leaf_scale=torch.float32)
    fields = _fields(arrays, dtypes, device)
    leaf = np.array(arrays["leaf"])
    if leaf.dtype == np.uint16:
        fields["leaf"] = torch.from_numpy(leaf.view(np.int16)).view(
            torch.bfloat16).to(device)
    elif leaf.dtype == np.int8:
        fields["leaf"] = torch.from_numpy(leaf).to(device)
    else:
        raise ValueError(f"quantized leaves are int8 or bfloat16 as uint16 "
                         f"bits, got {leaf.dtype}")
    return QuantizedForest(depth=int(depth), **fields)


def quantizer_from_edges(edges: np.ndarray, n_bins: int,
                         device=None) -> Quantizer:
    """`Quantizer` from the reference's (m, n_bins - 1) bin edges."""
    return Quantizer(edges=torch.as_tensor(np.array(edges, np.float32),
                                           device=resolve_device(device)),
                     n_bins=n_bins)


def tree_from_arrays(feat, thr, value, gain, cover=None,
                     device=None) -> Tree:
    """A training-side heap `Tree` from the reference's tree buffers."""
    device = resolve_device(device)

    def t(x, dtype):
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)
    return Tree(feat=t(feat, torch.int32), thr=t(thr, torch.int32),
                value=t(value, torch.float32), gain=t(gain, torch.float32),
                cover=None if cover is None else t(cover, torch.float32))


def path_pack_from_arrays(arrays: Mapping[str, np.ndarray], *,
                          device=None) -> PathPack:
    """`explain.paths.PathPack` from the reference's fields (slot_feat,
    slot_lo, slot_hi as int32; slot_z, leaf_weight, leaf as float32)."""
    device = resolve_device(device)
    dtypes = dict(slot_feat=torch.int32, slot_lo=torch.int32,
                  slot_hi=torch.int32, slot_z=torch.float32,
                  leaf_weight=torch.float32, leaf=torch.float32)
    return PathPack(**{k: torch.as_tensor(np.array(arrays[k]), dtype=dtype,
                                          device=device)
                       for k, dtype in dtypes.items()})
