"""Carry a fitted state of the JAX package over to the port.

The JAX package's fitted objects are given as numpy arrays (``np.asarray``
of each field), so this module needs nothing of JAX.  Both packages then
compute on the same forest, quantizer, tree, path pack, LM parameters,
LM optimizer state or LM KV cache; `lm_tree_to_arrays` carries LM trees
(parameters, gradients, optimizer state) back.
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
from repro_torch.models import lm

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
    dict per layer, and a VLM's stacked ``cross`` into one dict a site."""
    device = resolve_device(device)

    def convert(t):
        if isinstance(t, Mapping):
            return {k: convert(v) for k, v in t.items()}
        return _array_to_tensor(t, device)

    return lm.unstack_params(cfg, convert(tree))


def opt_state_from_arrays(cfg: ModelConfig, tree: Mapping[str, Any], *,
                          device=None):
    """The port's optimizer state (`training.optimizer.opt_init` on the
    port's parameters) from the reference's ``opt_state`` as numpy arrays,
    all float32: AdamW's ``{"m", "v"}``, each a parameter tree; Adafactor's
    parameter tree of ``{"vr", "vc"}`` / ``{"v"}`` dicts; SGD's ``{}``.
    Each parameter tree's ``blocks`` and ``cross`` are unstacked as in
    `lm_params_from_arrays`."""
    device = resolve_device(device)

    def convert(t):
        if isinstance(t, Mapping):
            return {k: convert(v) for k, v in t.items()}
        return _array_to_tensor(t, device)

    tree = convert(tree)
    if set(tree) == {"m", "v"}:
        return {k: lm.unstack_params(cfg, tree[k]) for k in ("m", "v")}
    return lm.unstack_params(cfg, tree) if tree else {}


def lm_tree_to_arrays(tree) -> Any:
    """The reference's layout of a port LM tree (parameters, their
    gradients or an optimizer state): each list (``blocks``, ``cross``)
    stacked along a new leading axis, every tensor a numpy array, bfloat16
    as its ``uint16`` bits.  The inverse of `lm_params_from_arrays` and
    `opt_state_from_arrays`."""
    if isinstance(tree, Mapping):
        return {k: lm_tree_to_arrays(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return _stack([lm_tree_to_arrays(t) for t in tree])
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _stack(parts):
    if isinstance(parts[0], Mapping):
        return {k: _stack([p[k] for p in parts]) for k in parts[0]}
    return np.stack(parts)


def _one_length(cfg: ModelConfig, tree: Mapping[str, Any]) -> int:
    """The reference keeps a length a layer (and a site); the port one."""
    lengths = np.asarray(tree["layers"]["length"]).reshape(-1)
    if lengths.shape != (cfg.n_layers,):
        raise ValueError(f"the cache must hold one length a layer for "
                         f"{cfg.n_layers} layers; got {lengths.tolist()}")
    lengths = lengths.tolist() + [int(np.asarray(site["length"]))
                                  for site in tree.get("shared_attn", [])]
    if any(n != lengths[0] for n in lengths):
        raise ValueError(f"the cache's lengths (each layer's, then each "
                         f"shared-attention site's) must be all equal; got "
                         f"{lengths}")
    return int(lengths[0])


def _kv_pair(cfg: ModelConfig, arrays: Mapping[str, Any], lead: tuple,
             device, what: str):
    """k and v of one attention cache: ``lead + (b, slots, hkv, dh)``,
    alike in shape and dtype."""
    k = _array_to_tensor(arrays["k"], device)
    v = _array_to_tensor(arrays["v"], device)
    tail = (cfg.n_kv_heads, cfg.head_dim_)
    if k.dim() != len(lead) + 4 or tuple(k.shape[:len(lead)]) != lead or \
            tuple(k.shape[-2:]) != tail or v.shape != k.shape or \
            v.dtype != k.dtype:
        raise ValueError(f"{what} k and v must both be {lead} + (b, slots) "
                         f"+ {tail}, alike; got {tuple(k.shape)} {k.dtype} "
                         f"and {tuple(v.shape)} {v.dtype}")
    return {"k": k, "v": v}


def lm_cache_from_arrays(cfg: ModelConfig, tree: Mapping[str, Any], *,
                         device=None):
    """The port's cache (`models.lm.init_cache`) from the reference's, as
    numpy arrays, bfloat16 as its ``uint16`` bits:
      attention layers  ``{"layers": {"k", "v", "length"}}``, k and v (L,
                        b, s_alloc, hkv, dh), ``length`` (L,);
      ssm / hybrid      ``{"layers": {"state", "conv_x", "conv_B",
                        "conv_C", "length"}}`` (state float32), a hybrid's
                        ``shared_attn`` list of ``{"k", "v", "length"}``;
      vlm               also ``image_kv`` ``{"k", "v"}``.
    The reference's lengths (a layer's and a site's) must all be equal;
    the port keeps one host int."""
    device = resolve_device(device)
    length = _one_length(cfg, tree)
    layers = tree["layers"]
    L = cfg.n_layers
    if "state" in layers:
        out = {k: _array_to_tensor(layers[k], device)
               for k in ("state", "conv_x", "conv_B", "conv_C")}
        want = (L, out["state"].shape[1], cfg.ssm_nheads, cfg.ssm_headdim,
                cfg.ssm_state)
        if tuple(out["state"].shape) != want or \
                out["state"].dtype != torch.float32:
            raise ValueError(f"the SSM state must be float32 {want}, got "
                             f"{out['state'].dtype} "
                             f"{tuple(out['state'].shape)}")
        cache: dict = {"layers": out, "length": length}
    else:
        cache = {"layers": _kv_pair(cfg, layers, (L,), device,
                                    "the layers'"), "length": length}
    if "shared_attn" in tree:
        cache["shared_attn"] = [_kv_pair(cfg, site, (), device, "a site's")
                                for site in tree["shared_attn"]]
    if "image_kv" in tree:
        cache["image_kv"] = _kv_pair(cfg, tree["image_kv"],
                                     (lm.n_sites(cfg),), device,
                                     "the image cache's")
    return cache


def lm_cache_to_arrays(cache) -> dict:
    """The reference's cache layout from the port's, as numpy arrays
    (bfloat16 as its ``uint16`` bits, ``length`` repeated as int32 per
    layer and per shared-attention site): the inverse of
    `lm_cache_from_arrays`."""
    def arr(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()

    length = int(cache["length"])
    layers = cache["layers"]
    n_layers = next(iter(layers.values())).shape[0]
    out = {"layers": {k: arr(t) for k, t in layers.items()}}
    out["layers"]["length"] = np.full((n_layers,), length, np.int32)
    if "shared_attn" in cache:
        out["shared_attn"] = [
            {"k": arr(s["k"]), "v": arr(s["v"]),
             "length": np.asarray(length, np.int32)}
            for s in cache["shared_attn"]]
    if "image_kv" in cache:
        out["image_kv"] = {k: arr(t) for k, t in cache["image_kv"].items()}
    return out
