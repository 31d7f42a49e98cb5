"""Checkpoints: atomic, optionally asynchronous, in the JAX package's format.

Port of the JAX package's ``io/checkpoint.py`` (`CheckpointManager` and the
serving-forest half).  The format needs no framework: each step is one
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
from typing import Any, Dict, List, Optional, Tuple

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
    if dtype is None:
        return torch.from_numpy(np.ascontiguousarray(arr))
    target = getattr(torch, dtype, None)
    if not isinstance(target, torch.dtype):
        raise ValueError(f"checkpoint holds dtype {dtype!r}, which torch "
                         "has no dtype for")
    size = arr.dtype.itemsize
    ints = np.ascontiguousarray(arr).view(_VIEW_UINT[size]).view(
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
