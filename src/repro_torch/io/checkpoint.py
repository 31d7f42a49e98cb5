"""Checkpoints: atomic, optionally asynchronous, in the JAX package's format.

Port of the JAX package's ``io/checkpoint.py``: `CheckpointManager`, the
serving-forest steps and the resumable training steps (format v4's
``train/*`` subtree).  The format needs no framework: each step is one
``state.npz`` of flattened arrays plus a ``manifest.json`` (step, keys,
metadata), so either package reads what the other writes.  Keys are the
``/``-joined paths of nested dicts, taken in sorted key order as JAX
flattens them (``forest/feat``, ``quantizer/edges``, ...).

Dtypes numpy cannot hold (bfloat16, the float8 types) are stored as
unsigned-integer views of the same width, with the true dtype under the
manifest's ``metadata["_dtypes"]``; they are read back as torch tensors of
that dtype (no ``ml_dtypes`` needed).

Writes go to a temp dir, state first and manifest last, then ``os.replace``
publishes the step and an atomic ``LATEST`` pointer names it: a crash
mid-save leaves at worst a manifest-less step, which every reader ignores.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.device import resolve_device

_SEP = "/"
# torch dtypes without a numpy dtype, stored as same-width integer views.
_VIEW_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32}
_VIEW_INT = {1: torch.int8, 2: torch.int16, 4: torch.int32}


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs: dicts in sorted key order, lists and tuples
    by index, as JAX's ``tree_flatten_with_path`` names them."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out.extend(_flatten(v, f"{prefix}{_SEP}{k}" if prefix else k))
    return out


def dtype_name(t) -> str:
    """The dtype's name as numpy and JAX spell it (``"bfloat16"``,
    ``"int8"``, ``"float32"``)."""
    return str(t.dtype).removeprefix("torch.")


def _to_host(v) -> Tuple[np.ndarray, Optional[str]]:
    """A leaf as a host numpy array (a copy), plus the true dtype's name
    when the array is an integer view of a dtype numpy lacks."""
    if not torch.is_tensor(v):
        return np.array(v), None
    t = v.detach().cpu()
    try:
        return t.numpy().copy(), None
    except TypeError:                       # bfloat16, float8_*: no numpy
        size = t.element_size()
        bits = t.contiguous().view(_VIEW_INT[size]).numpy()
        return bits.view(_VIEW_UINT[size]).copy(), dtype_name(t)


def _from_host(arr: np.ndarray, dtype: Optional[str]) -> torch.Tensor:
    # ascontiguousarray makes a 0-d array 1-d: keep the stored shape.
    arr = np.ascontiguousarray(arr).reshape(arr.shape)
    if dtype is None:
        return torch.from_numpy(arr)
    target = getattr(torch, dtype, None)
    if not isinstance(target, torch.dtype):
        raise ValueError(f"checkpoint holds dtype {dtype!r}, which torch "
                         "has no dtype for")
    size = arr.dtype.itemsize
    ints = arr.view(_VIEW_UINT[size]).view(
        np.dtype(f"int{8 * size}"))
    return torch.from_numpy(ints).view(target)


def _fsync_dir(path: str) -> None:
    """Durability for renames: fsync the containing directory (POSIX)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:          # platforms without dir fds: rename is still atomic
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class CheckpointManager:
    """Directory layout::

        <root>/step_<n>/state.npz
        <root>/step_<n>/manifest.json
        <root>/LATEST            (atomic pointer file)
    """

    def __init__(self, root: str, keep_n: int = 3, async_save: bool = True):
        self.root = root
        self.keep_n = keep_n
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(root, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, metadata: Optional[Dict] = None):
        """Write ``tree`` (nested dicts of tensors, arrays or scalars) as
        step ``step``.  Leaves are copied to the host before this returns,
        so the caller may change them while an async write runs."""
        self.wait()
        items, dtypes = [], {}
        for k, v in _flatten(tree):
            arr, true_dtype = _to_host(v)
            if true_dtype is not None:
                dtypes[k] = true_dtype
            items.append((k, arr))
        metadata = dict(metadata or {})
        metadata["_dtypes"] = dtypes
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, items, metadata), daemon=True)
            self._thread.start()
        else:
            self._write(step, items, metadata)

    def _write(self, step: int, items, metadata: Dict):
        tmp = os.path.join(self.root, f".tmp_step_{step}_{os.getpid()}")
        final = os.path.join(self.root, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        with open(os.path.join(tmp, "state.npz"), "wb") as f:
            np.savez(f, **dict(items))
            f.flush()
            os.fsync(f.fileno())
        manifest = {"step": step, "time": time.time(),
                    "keys": [k for k, _ in items], "metadata": metadata}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)                     # atomic publish
        _fsync_dir(self.root)
        ptr_tmp = os.path.join(self.root, ".LATEST_tmp")
        with open(ptr_tmp, "w") as f:
            f.write(str(step))
            f.flush()
            os.fsync(f.fileno())
        os.replace(ptr_tmp, os.path.join(self.root, "LATEST"))
        _fsync_dir(self.root)
        self._gc()

    def wait(self):
        """Join a pending async write."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        """Keep the newest ``keep_n`` VALID steps.  Only valid steps count
        and only valid steps beyond ``keep_n`` are deleted, so the newest
        valid step survives even beside a younger manifest-less one (which
        is swept as garbage, as are stale ``.tmp_*`` dirs)."""
        steps = self.all_steps()
        for s in steps[:-self.keep_n] if self.keep_n else []:
            shutil.rmtree(os.path.join(self.root, f"step_{s}"),
                          ignore_errors=True)
        for name in os.listdir(self.root):
            path = os.path.join(self.root, name)
            if name.startswith(".tmp_step_"):
                shutil.rmtree(path, ignore_errors=True)
            elif name.startswith("step_"):
                s = _step_of(name)
                if s is not None and s not in steps and not self._is_valid(s):
                    shutil.rmtree(path, ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def _is_valid(self, step: int) -> bool:
        """A step is valid iff its state file exists and its manifest
        parses (the manifest is written last: it is the commit record)."""
        d = os.path.join(self.root, f"step_{step}")
        if not os.path.exists(os.path.join(d, "state.npz")):
            return False
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                json.load(f)
            return True
        except (OSError, ValueError):
            return False

    def all_steps(self) -> List[int]:
        """Valid steps, ascending."""
        steps = (_step_of(name) for name in os.listdir(self.root)
                 if name.startswith("step_"))
        return sorted(s for s in steps if s is not None and self._is_valid(s))

    def latest_step(self) -> Optional[int]:
        """The step ``LATEST`` names if it is valid, else the newest valid
        step, else None."""
        ptr = os.path.join(self.root, "LATEST")
        if os.path.exists(ptr):
            with open(ptr) as f:
                s = int(f.read().strip())
            if self._is_valid(s):
                return s
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _resolve(self, step: Optional[int]) -> int:
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        return step

    def read(self, step: int, keys) -> Dict[str, torch.Tensor]:
        """The arrays ``keys`` of step ``step`` as CPU tensors, each in its
        true dtype."""
        dtypes = self.manifest(step).get("metadata", {}).get("_dtypes", {})
        with np.load(os.path.join(self.root, f"step_{step}",
                                  "state.npz")) as data:
            return {k: _from_host(data[k], dtypes.get(k)) for k in keys}

    def restore(self, like: Any, step: Optional[int] = None,
                shardings: Any = None, *, device=None) -> Tuple[Any, int]:
        """Restore into the structure of ``like`` (nested dicts, lists and
        tuples; its leaves are replaced) as tensors on ``device`` (the
        device rule: CUDA unless named).  ``shardings`` (a
        `runtime.elastic.Layout`, or a nest of them matching ``like``) lays
        the restored arrays out on a mesh instead: each rank gets its block
        on the mesh's device (`runtime.elastic.remesh`), so a step written
        on one mesh restores onto another."""
        step = self._resolve(step)
        arrays = self.read(step, [k for k, _ in _flatten(like)])
        if shardings is not None:
            from repro_torch.runtime import elastic as E
            tree = _unflatten(like, iter(arrays[k] for k, _ in
                                         _flatten(like)))
            return E.remesh(tree, shardings, device=device), step
        device = resolve_device(device)
        leaves = iter(arrays[k].to(device) for k, _ in _flatten(like))
        return _unflatten(like, leaves), step

    def restore_raw(self, step: Optional[int] = None
                    ) -> Tuple[Dict[str, torch.Tensor], int]:
        """Template-free restore: ``({flat_key: CPU tensor}, step)``."""
        step = self._resolve(step)
        with np.load(os.path.join(self.root, f"step_{step}",
                                  "state.npz")) as data:
            keys = list(data.files)
        return self.read(step, keys), step

    def manifest(self, step: int) -> Dict:
        with open(os.path.join(self.root, f"step_{step}",
                               "manifest.json")) as f:
            return json.load(f)


def _unflatten(like: Any, leaves) -> Any:
    """``like`` with its leaves replaced from the iterator ``leaves``, in
    `_flatten`'s order."""
    if isinstance(like, dict):
        out = {k: None for k in like}
        for k in sorted(like, key=str):
            out[k] = _unflatten(like[k], leaves)
        return out
    if isinstance(like, (list, tuple)):
        items = [_unflatten(v, leaves) for v in like]
        if hasattr(like, "_fields"):                  # a NamedTuple
            return type(like)(*items)
        return type(like)(items)
    return next(leaves)


def _step_of(name: str) -> Optional[int]:
    try:
        return int(name.split("_", 1)[1])
    except ValueError:
        return None


# ---------------------------------------------------------------------------
# Serving checkpoints: a PackedForest or QuantizedForest (+ quantizer) in one
# self-describing step.  Format history (the reference's
# ``FOREST_FORMAT_VERSION`` notes): v1/v2 store implicit-heap arrays (v2 adds
# cover and gain); v3 the pointer layout with ``depth`` in the manifest; v4
# may add a ``train/*`` subtree for resuming, which serving ignores; v5 may
# hold a quantized forest, marked by the manifest's ``quantized`` key.
# ---------------------------------------------------------------------------
FOREST_FORMAT_VERSION = 5


def save_forest_checkpoint(root: str, packed, quantizer=None, *,
                           step: int = 0, metadata: Optional[Dict] = None,
                           keep_n: int = 3) -> None:
    """Checkpoint a `PackedForest` or `QuantizedForest` (and its quantizer)
    for serving, as the JAX package writes it: the forest's fields under
    ``forest/``, the quantizer under ``quantizer/``, and the manifest keys
    ``kind``, ``fields``, ``has_quantizer``, ``depth``, ``format_version``
    (and ``quantized``, the leaf dtype, for a quantized forest).
    ``metadata`` should carry the loss name, which serving reads."""
    forest_dict = {k: v for k, v in packed._asdict().items()
                   if v is not None and k != "depth"}
    tree: Dict[str, Any] = {"forest": forest_dict}
    if quantizer is not None:
        tree["quantizer"] = {"edges": quantizer.edges,
                             "n_bins": np.int32(quantizer.n_bins)}
    meta = dict(metadata or {})
    meta.update(kind="packed_forest", fields=list(forest_dict),
                has_quantizer=quantizer is not None, depth=int(packed.depth),
                format_version=FOREST_FORMAT_VERSION)
    if "leaf_scale" in forest_dict:
        meta["quantized"] = dtype_name(packed.leaf)
    CheckpointManager(root, keep_n=keep_n, async_save=False).save(
        step, tree, metadata=meta)


def load_forest_checkpoint(root: str, step: Optional[int] = None, *,
                           device=None):
    """Load a serving checkpoint of any format version onto ``device`` (the
    device rule: CUDA unless named): ``(forest, Quantizer | None, meta)``.

    v3 and later load verbatim (a v4 step's ``train/*`` arrays are not
    read); v1/v2 heap steps are upgraded in memory by
    `forest.heap_packed_to_pointer`; a step whose manifest has
    ``quantized`` loads as a `QuantizedForest`.  The learning rate stays a
    host scalar, as in a fitted forest.
    """
    from repro_torch.core.forest import PackedForest, heap_packed_to_pointer
    from repro_torch.core.quantize import QuantizedForest, Quantizer

    device = resolve_device(device)
    mgr = CheckpointManager(root, async_save=False)
    step = mgr._resolve(step)
    meta = dict(mgr.manifest(step).get("metadata", {}))
    meta.setdefault("format_version", 1)
    if meta.get("kind") != "packed_forest":
        raise ValueError(f"checkpoint step_{step} under {root} is not a "
                         f"packed_forest (kind={meta.get('kind')!r})")
    keys = [f"forest/{f}" for f in meta["fields"]]
    if meta.get("has_quantizer"):
        keys += ["quantizer/edges", "quantizer/n_bins"]
    arrays = mgr.read(step, keys)
    f = {k: arrays[f"forest/{k}"].to(device) for k in meta["fields"]}
    f["lr"] = arrays["forest/lr"]
    if meta.get("quantized"):
        packed = QuantizedForest(**f, depth=int(meta["depth"]))
    elif meta["format_version"] >= 3:
        packed = PackedForest(**f, depth=int(meta["depth"]))
    else:
        packed = heap_packed_to_pointer(
            f["feat"], f["thr"], f["leaf"], f["out_col"], f["base"],
            f["lr"], cover=f.get("cover"), gain=f.get("gain"))
    quantizer = None
    if meta.get("has_quantizer"):
        quantizer = Quantizer(edges=arrays["quantizer/edges"].to(device),
                              n_bins=int(arrays["quantizer/n_bins"]))
    return packed, quantizer, meta


# ---------------------------------------------------------------------------
# Training checkpoints (format v4): the serving forest's fields plus the
# resume state, as the JAX package writes them: ``train/trees/*`` (the raw
# stacked training trees), ``train/F`` and ``train/Fv`` (raw scores), and in
# the manifest's ``train`` block the round, the eval history, the
# early-stopping state and the schedule-critical config.  The JAX package
# stores its threefry key under ``train/key``; the port stores its draws'
# generator state under ``train/generator`` (a key of its own: torch cannot
# continue a threefry stream) and the generator's device type in the
# ``train`` block.
# ---------------------------------------------------------------------------

class BoostState(NamedTuple):
    """Everything a fit needs to resume at a round boundary."""
    packed: Any               # PackedForest prefix (serving-complete)
    quantizer: Any            # Quantizer | None
    trees: Any                # stacked tree.Forest | tree.NodeTree
    F: torch.Tensor           # (n, d) raw train scores at the boundary
    Fv: Optional[torch.Tensor]  # (nv, d) eval scores | None
    generator: Optional[torch.Tensor]  # the port's generator state | None
    generator_device: Optional[str]    # the device type it belongs to
    key: Optional[np.ndarray]  # a JAX-written step's raw key data | None
    round: int                # completed rounds
    history: List[Dict]       # eval-history records so far
    best_loss: float          # early-stopping tracker (inf: no eval yet)
    best_round: int
    meta: Dict                # the manifest's metadata


def save_boost_checkpoint(root: str, *, round_done: int, packed,
                          quantizer, trees, F, Fv,
                          generator: torch.Generator, history: List[Dict],
                          best_loss: float, best_round: int, cfg_meta: Dict,
                          keep_n: int = 3) -> None:
    """Write a resumable (and serving-complete) training step.

    ``trees`` is the raw stacked training forest of the completed rounds,
    stored as it is; ``packed`` the same rounds through
    `forest.pack_forest`, so `load_forest_checkpoint` and `ForestServer`
    read the step unchanged.  ``generator`` is the fit's draws' generator
    AT the round boundary (before the next round draws); its state goes
    under ``train/generator``.  ``cfg_meta`` is the config snapshot the
    resuming fit is checked against (``extra_meta`` goes to the manifest's
    top level)."""
    forest_dict = {k: v for k, v in packed._asdict().items()
                   if v is not None and k != "depth"}
    tree_dict = {k: v for k, v in trees._asdict().items() if v is not None}
    train: Dict[str, Any] = {"trees": tree_dict, "F": F,
                             "generator": generator.get_state()}
    if Fv is not None:
        train["Fv"] = Fv
    state: Dict[str, Any] = {"forest": forest_dict, "train": train}
    if quantizer is not None:
        state["quantizer"] = {"edges": quantizer.edges,
                              "n_bins": np.int32(quantizer.n_bins)}
    meta = dict(cfg_meta.get("extra_meta") or {})
    meta.update(
        kind="packed_forest", fields=list(forest_dict),
        has_quantizer=quantizer is not None, depth=int(packed.depth),
        format_version=FOREST_FORMAT_VERSION,
        loss=cfg_meta.get("loss", meta.get("loss")),
        train={
            "round": int(round_done),
            "tree_kind": type(trees).__name__,      # "Forest" | "NodeTree"
            "tree_fields": list(tree_dict),
            "has_eval": Fv is not None,
            "history": history,
            # JSON has no inf: None encodes "no eval seen yet".
            "best_loss": (None if not np.isfinite(best_loss)
                          else float(best_loss)),
            "best_round": int(best_round),
            "generator_device": generator.device.type,
            "cfg": {k: v for k, v in cfg_meta.items() if k != "extra_meta"},
        })
    CheckpointManager(root, keep_n=keep_n, async_save=False).save(
        round_done, state, metadata=meta)


def load_boost_checkpoint(root: str, step: Optional[int] = None, *,
                          device=None) -> BoostState:
    """Restore a training step onto ``device`` (the device rule): a step
    `save_boost_checkpoint` wrote, or one the JAX package wrote (its
    threefry key comes back as ``key``, and ``generator`` is None)."""
    from repro_torch.core import tree as T
    from repro_torch.core.forest import PackedForest
    from repro_torch.core.quantize import Quantizer

    device = resolve_device(device)
    mgr = CheckpointManager(root, async_save=False)
    step = mgr._resolve(step)
    meta = dict(mgr.manifest(step).get("metadata", {}))
    train_meta = meta.get("train")
    if meta.get("kind") != "packed_forest" or train_meta is None:
        raise ValueError(
            f"checkpoint step_{step} under {root} has no train state "
            f"(kind={meta.get('kind')!r}, format_version="
            f"{meta.get('format_version', 1)}): it is a serving-only "
            "checkpoint and cannot seed a resume — retrain with "
            "cfg.save_every > 0 to produce resumable (v4) steps")
    raw, _ = mgr.restore_raw(step)
    forest = {f: raw[f"forest/{f}"].to(device) for f in meta["fields"]}
    forest["lr"] = raw["forest/lr"]
    packed = PackedForest(**forest, depth=int(meta["depth"]))
    quantizer = None
    if meta.get("has_quantizer"):
        quantizer = Quantizer(edges=raw["quantizer/edges"].to(device),
                              n_bins=int(raw["quantizer/n_bins"]))
    tree_cls = {"Forest": T.Forest, "NodeTree": T.NodeTree}[
        train_meta["tree_kind"]]
    trees = tree_cls(**{f: raw[f"train/trees/{f}"].to(device)
                        for f in train_meta["tree_fields"]})
    best = train_meta.get("best_loss")
    gen = raw.get("train/generator")
    key = raw.get("train/key")
    return BoostState(
        packed=packed, quantizer=quantizer, trees=trees, F=raw["train/F"],
        Fv=raw.get("train/Fv"),
        generator=None if gen is None else gen.to(torch.uint8),
        generator_device=train_meta.get("generator_device"),
        key=None if key is None else key.numpy(),
        round=int(train_meta["round"]),
        history=list(train_meta.get("history", [])),
        best_loss=(float("inf") if best is None else float(best)),
        best_round=int(train_meta.get("best_round", -1)),
        meta=meta)
