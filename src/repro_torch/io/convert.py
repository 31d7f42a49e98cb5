"""Carry a fitted state of the JAX package over to the port.

The JAX package's fitted objects are given as numpy arrays (``np.asarray``
of each field), so this module needs nothing of JAX.  Both packages then
compute on the same forest, quantizer, tree, path pack, LM parameters or
LM KV cache.
Every helper places its tensors by the device rule: CUDA unless ``device``
names another device.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.forest import PackedForest
from repro_torch.core.quantize import QuantizedForest, Quantizer
from repro_torch.core.tree import NodeTree, Tree
from repro_torch.explain.paths import PathPack
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import check_family, unstack

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


def node_tree_from_arrays(arrays: Mapping[str, np.ndarray], *,
                          device=None) -> NodeTree:
    """A leaf-wise `NodeTree` (or a stacked one) from the reference's
    fields: feat, thr, left, right, node_count as int32; value, gain,
    cover as float32."""
    device = resolve_device(device)
    dtypes = dict(feat=torch.int32, thr=torch.int32, left=torch.int32,
                  right=torch.int32, value=torch.float32,
                  gain=torch.float32, cover=torch.float32,
                  node_count=torch.int32)
    return NodeTree(**{k: torch.as_tensor(np.array(arrays[k]), dtype=dtype,
                                          device=device)
                       for k, dtype in dtypes.items()})


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


def _array_to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)
    if a.dtype == np.uint16:                   # bfloat16 as its bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    if a.dtype != np.float32:
        raise ValueError(f"LM parameters and caches are float32, or bfloat16 "
                         f"as uint16 bits, got {a.dtype}")
    return torch.from_numpy(a).to(device)


def lm_params_from_arrays(cfg: ModelConfig, tree: Mapping[str, Any], *,
                          device=None):
    """The port's LM parameters (`models.lm`) from the reference's tree:
    nested dicts of numpy arrays as ``lm.init`` lays them out, bfloat16
    leaves given as their ``uint16`` bit view (``np.asarray(a).view(
    np.uint16)``).  The stacked ``blocks`` subtree is unstacked into one
    dict per layer."""
    check_family(cfg)
    device = resolve_device(device)

    def convert(t):
        if isinstance(t, Mapping):
            return {k: convert(v) for k, v in t.items()}
        return _array_to_tensor(t, device)

    params = convert(tree)
    params["blocks"] = unstack(params["blocks"], cfg.n_layers)
    return params


def lm_cache_from_arrays(cfg: ModelConfig, tree: Mapping[str, Any], *,
                         device=None):
    """The port's KV cache (`models.lm.init_cache`) from the reference's:
    ``{"layers": {"k", "v", "length"}}`` as numpy arrays, k and v (L, b,
    s_alloc, hkv, dh) in float32 or as the ``uint16`` bits of bfloat16,
    ``length`` (L,).  The reference's per-layer lengths must all be equal;
    the port keeps one host int."""
    check_family(cfg)
    device = resolve_device(device)
    layers = tree["layers"]
    lengths = np.asarray(layers["length"]).reshape(-1)
    if lengths.shape != (cfg.n_layers,) or (lengths != lengths[0]).any():
        raise ValueError(f"the cache must hold one length a layer, all "
                         f"equal, for {cfg.n_layers} layers; got "
                         f"{lengths.tolist()}")
    k = _array_to_tensor(layers["k"], device)
    v = _array_to_tensor(layers["v"], device)
    want = (cfg.n_layers, k.shape[1], k.shape[2], cfg.n_kv_heads,
            cfg.head_dim_)
    if tuple(k.shape) != want or v.shape != k.shape or v.dtype != k.dtype:
        raise ValueError(f"k and v must both be {want}, got "
                         f"{tuple(k.shape)} {k.dtype} and {tuple(v.shape)} "
                         f"{v.dtype}")
    return {"layers": {"k": k, "v": v}, "length": int(lengths[0])}


def lm_cache_to_arrays(cache) -> dict:
    """The reference's cache layout from the port's, as numpy arrays
    (bfloat16 as its ``uint16`` bits, ``length`` repeated per layer as
    int32): the inverse of `lm_cache_from_arrays`."""
    def arr(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()

    k, v = cache["layers"]["k"], cache["layers"]["v"]
    return {"layers": {
        "k": arr(k), "v": arr(v),
        "length": np.full((k.shape[0],), int(cache["length"]), np.int32)}}
