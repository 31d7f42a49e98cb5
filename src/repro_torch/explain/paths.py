"""Root-to-leaf path extraction from a `PackedForest` (host numpy).

Port of the JAX package's ``explain/paths.py``, array for array, so the
pack is bitwise the reference's for the same forest.  TreeSHAP consumes
trees path by path: each (tree, terminal node) pair is a path whose edges
carry a split condition and a cover ratio.  The pointer forest is
flattened once per model into fixed-shape per-(tree, path, slot) tensors:

  * the path axis enumerates each tree's root-reachable terminal nodes
    (pruned orphans are excluded), padded to the forest-wide maximum and
    rounded up to a multiple of 8; ancestor chains come from inverting the
    child pointers (children carry larger ids than their parent) and are
    stored root to leaf;
  * duplicate features along a path merge into the slot of their first
    occurrence: intervals intersect to ``lo < code <= hi`` and cover
    ratios multiply into one zero-fraction ``z``;
  * every path is padded to ``depth`` slots with inert null players
    (``feat = -1``, ``lo = -1``, ``hi = BIG_BIN``, ``z = 1``), and ragged
    terminal counts pad with zero-leaf paths; empty subtrees get ``z = 0``
    edges.

The work is host numpy; the tensors then go to the forest's device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.ref import SHAP_BIG_BIN as BIG_BIN


class PathPack(NamedTuple):
    """Per-(tree, terminal, slot) path tensors, ``(T, L, D)`` unless noted.

    ``o = (code[slot_feat] > slot_lo) & (code[slot_feat] <= slot_hi)`` is a
    slot's one-fraction and ``slot_z`` its zero-fraction; ``leaf_weight``
    (T, L) is ``prod_s z_s``, the probability mass reaching each terminal;
    ``leaf`` (T, L, w) the terminal leaf blocks.
    """
    slot_feat: torch.Tensor    # int32, -1 on padding slots
    slot_lo: torch.Tensor      # int32 (exclusive lower bin bound)
    slot_hi: torch.Tensor      # int32 (inclusive upper bin bound)
    slot_z: torch.Tensor       # float32
    leaf_weight: torch.Tensor  # (T, L) float32
    leaf: torch.Tensor         # (T, L, w) float32


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _parent_tables(left: np.ndarray, right: np.ndarray):
    """Invert child pointers: ``(parent, came_from_right)`` per (tree, node).

    Roots (and inert padded slots) get parent ``-1``.  Terminal self-loops
    are redirected to a dummy column so they never register as parents.
    """
    n_trees, n = left.shape
    ids = np.arange(n)
    internal = left != ids[None, :]
    rows = np.broadcast_to(ids[None, :], (n_trees, n))
    parent = np.full((n_trees, n + 1), -1, np.int64)
    came_right = np.zeros((n_trees, n + 1), np.int64)
    l_tgt = np.where(internal, left, n)            # no-ops -> dummy column
    r_tgt = np.where(internal, right, n)
    np.put_along_axis(parent, l_tgt, rows, axis=1)
    np.put_along_axis(parent, r_tgt, rows, axis=1)
    np.put_along_axis(came_right, r_tgt, np.ones_like(rows), axis=1)
    return parent[:, :n], came_right[:, :n].astype(bool)


def _terminal_slots(left: np.ndarray, right: np.ndarray, node_count):
    """Per-tree real terminal node ids, padded to the forest-wide maximum.

    Padding slots at or after ``node_count`` and root-unreachable slots
    (orphans of `core.forest.prune_forest`) are excluded.  Returns ``(slots
    (T, L) int64, valid (T, L) bool)`` with ``L`` rounded up to a multiple
    of 8; padding entries point at node 0 and are masked by the caller.
    """
    n_trees, n = left.shape
    ids = np.arange(n)
    reach = np.zeros((n_trees, n), bool)
    if n:
        reach[:, 0] = True
        rows = np.arange(n_trees)
        for i in range(n):
            internal = reach[:, i] & (left[:, i] != i)
            r = rows[internal]
            reach[r, left[internal, i]] = True
            reach[r, right[internal, i]] = True
    terminal = (left == ids[None, :]) & reach
    if node_count is not None:
        terminal &= ids[None, :] < _np(node_count)[:, None]
    counts = terminal.sum(axis=1)
    L = int(counts.max()) if n_trees else 0
    L = max(L + (-L) % 8, 8)
    slots = np.zeros((n_trees, L), np.int64)
    valid = np.arange(L)[None, :] < counts[:, None]
    for t in range(n_trees):
        tids = np.flatnonzero(terminal[t])
        slots[t, :tids.size] = tids
    return slots, valid


def build_path_pack(pf, *, need_cover: bool = True) -> PathPack:
    """Merged path slots of a `PackedForest`, on its device.

    ``need_cover=False`` (interventional SHAP: zero-fractions come from
    background rows) accepts a cover-less forest and fills ``slot_z`` and
    ``leaf_weight`` with ones.
    """
    if pf.cover is None and need_cover:
        raise ValueError(
            "PackedForest has no per-node cover tensor — it was packed from "
            "cover-less buffers (e.g. a format_version 1 checkpoint). "
            "Path-dependent SHAP and cover importances need a forest trained "
            "and checkpointed by this version; interventional SHAP "
            "(algorithm='interventional', background=...) still works.")
    depth, n = pf.depth, pf.n_nodes
    n_trees = pf.n_trees
    feat = _np(pf.feat)                            # (T, N)
    thr = _np(pf.thr).astype(np.int64)
    left = _np(pf.left).astype(np.int64)
    right = _np(pf.right).astype(np.int64)
    leaf = _np(pf.leaf)
    cover = (np.ones((n_trees, n)) if pf.cover is None
             else _np(pf.cover).astype(np.float64))
    parent, came_right = _parent_tables(left, right)
    slots, valid_slot = _terminal_slots(left, right, pf.node_count)
    n_paths = slots.shape[1]

    # Walk every terminal's ancestor chain leaf to root; edges beyond a
    # path's depth are inert.  The slot axis is then flipped to root to leaf
    # (before merging).
    cur = slots.copy()
    feat_e = np.full((n_trees, n_paths, depth), -1, np.int64)
    lo_e = np.full((n_trees, n_paths, depth), -1, np.int64)
    hi_e = np.full((n_trees, n_paths, depth), BIG_BIN, np.int64)
    z_e = np.ones((n_trees, n_paths, depth))
    for s in range(depth):
        p = np.take_along_axis(parent, cur, axis=1)         # (T, L)
        valid = (p >= 0) & valid_slot
        pc = np.where(valid, p, 0)
        f_s = np.take_along_axis(feat, pc, axis=1)
        t_s = np.take_along_axis(thr, pc, axis=1)
        isr = np.take_along_axis(came_right, cur, axis=1)
        c_par = np.take_along_axis(cover, pc, axis=1)
        c_ch = np.take_along_axis(cover, cur, axis=1)
        z_s = np.where(c_par > 0, c_ch / np.where(c_par > 0, c_par, 1.0),
                       0.0)
        feat_e[..., s] = np.where(valid, f_s, -1)
        lo_e[..., s] = np.where(valid & isr, t_s, -1)       # right: code > thr
        hi_e[..., s] = np.where(valid & ~isr, t_s, BIG_BIN)  # left: code <= thr
        z_e[..., s] = np.where(valid, z_s, 1.0)
        cur = np.where(valid, pc, cur)
    feat_e = feat_e[..., ::-1]
    lo_e = lo_e[..., ::-1]
    hi_e = hi_e[..., ::-1]
    z_e = z_e[..., ::-1]

    # Merge duplicate features into the slot of their first occurrence:
    # z multiplies, intervals intersect; non-first edges become padding.
    lvl = np.arange(depth)
    same = feat_e[:, :, :, None] == feat_e[:, :, None, :]   # (T, L, D, D)
    first = np.argmax(same, axis=3)               # first slot with this feat
    group = first[:, :, None, :] == lvl[None, None, :, None]  # slot <- edge
    is_first = first == lvl[None, None, :]
    z_slot = np.prod(np.where(group, z_e[:, :, None, :], 1.0), axis=3)
    lo_slot = np.max(np.where(group, lo_e[:, :, None, :], -1), axis=3)
    hi_slot = np.min(np.where(group, hi_e[:, :, None, :], BIG_BIN), axis=3)

    real = is_first & (feat_e >= 0)
    slot_feat = np.where(real, feat_e, -1).astype(np.int32)
    slot_lo = np.where(real, lo_slot, -1).astype(np.int32)
    slot_hi = np.where(real, hi_slot, BIG_BIN).astype(np.int32)
    slot_z = np.where(real, z_slot, 1.0).astype(np.float32)
    leaf_weight = np.prod(slot_z, axis=2, dtype=np.float64)
    leaf_weight = np.where(valid_slot, leaf_weight, 0.0)
    leaf_v = np.take_along_axis(leaf, slots[:, :, None], axis=1)
    leaf_v = np.where(valid_slot[:, :, None], leaf_v, 0.0).astype(np.float32)

    device = pf.feat.device

    def out(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return PathPack(slot_feat=out(slot_feat), slot_lo=out(slot_lo),
                    slot_hi=out(slot_hi), slot_z=out(slot_z),
                    leaf_weight=out(leaf_weight.astype(np.float32)),
                    leaf=out(leaf_v))
