"""PackedForest: the pointer-topology ensemble format, its host-side
surgery (prune, compact, slice) and its traversal.

Port of the JAX package's ``core/forest.py``.  All arrays carry a leading
tree axis ``T`` over a node axis of size ``N`` (``2^(D+1) - 1`` for heap
trees of the level-wise grower; any multiple of 8 after `compact_forest`):

  feat, thr    (T, N) int32     split feature / threshold (left if code <= thr)
  left, right  (T, N) int32     child pointers; terminal nodes self-loop
  leaf         (T, N, w) float32 node-indexed leaf blocks (0 on internal nodes)
  out_col      (T,) int32       first output column of each leaf block
  base         (d,) float32     base score
  lr           () float32       learning rate (a host scalar)
  cover, gain  (T, N) float32   node covers / split gains
  node_count   (T,) int32       nodes used per tree
  depth        int              walk bound

Both producers (heap trees of the level-wise grower, `tree.NodeTree`s of
the leaf-wise grower, numbered in creation order) number children after
their parent, so one forward sweep over node ids visits every parent
before its children.  Prune and compact
are numpy array surgery on the host, as in the reference, and their result
goes back to the forest's device.

Every prediction goes through a traversal kernel's wrapper, tree by tree in
index order: `predict_kernel.forest_traverse` (B3) for a float32 forest,
`predict_quant_kernel.forest_traverse_quant` (B5) for a
`core.quantize.QuantizedForest`, recognised by its ``leaf_scale`` field.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import losses as L
from repro_torch.core import tree as T
from repro_torch.kernels import predict_kernel, predict_quant_kernel

# Fields with a leading tree axis, for `PackedForest` and `QuantizedForest`
# (which adds ``leaf_scale``); base, lr and depth belong to the whole forest.
_TREE_AXIS_FIELDS = ("feat", "thr", "left", "right", "leaf", "leaf_scale",
                     "out_col", "cover", "gain", "node_count")


class PackedForest(NamedTuple):
    feat: torch.Tensor
    thr: torch.Tensor
    left: torch.Tensor
    right: torch.Tensor
    leaf: torch.Tensor
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
        """Size N of the node axis (>= node_count everywhere)."""
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
    def is_heap(self) -> bool:
        """Whether every tree is a canonical perfect heap (checked on all
        trees and both pointer tensors, on the host)."""
        n = self.n_nodes
        d = (n + 1).bit_length() - 2
        if n != 2 ** (d + 1) - 1:
            return False
        h = 2 ** d - 1
        for ptr, step in ((self.left, 1), (self.right, 2)):
            expect = np.concatenate([2 * np.arange(h) + step,
                                     np.arange(h, n)])
            if not np.array_equal(_np(ptr),
                                  np.broadcast_to(expect, ptr.shape)):
                return False
        return (self.node_count is None
                or bool(np.all(_np(self.node_count) == n)))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _heap_cover(leaf_cover: torch.Tensor) -> torch.Tensor:
    """(T, 2^D) leaf covers -> (T, 2^(D+1) - 1) node covers in global node
    order (internal covers are the sums of their leaves)."""
    levels = [leaf_cover.to(torch.float32)]
    while levels[0].shape[1] > 1:
        top = levels[0]
        levels.insert(0, top[:, 0::2] + top[:, 1::2])
    return torch.cat(levels, 1)


def _fold_outputs(forest, strategy: str):
    """``one_vs_all`` buffers ``(T, d, ...)`` -> ``(T * d, ...)``, folded
    round-major (round 0 output 0, round 0 output 1, ...), with each
    tree's output column; ``single_tree`` buffers as they are, column 0."""
    if strategy == "single_tree":
        return forest, torch.zeros(forest.feat.shape[0], dtype=torch.int32,
                                   device=forest.feat.device)
    if strategy != "one_vs_all":
        raise ValueError(f"unknown strategy {strategy!r}")
    n_rounds, d = forest.feat.shape[:2]
    folded = type(forest)(*[
        None if x is None else x.reshape((n_rounds * d,) + x.shape[2:])
        for x in forest])
    out_col = torch.arange(d, dtype=torch.int32,
                           device=forest.feat.device).repeat(n_rounds)
    return folded, out_col


def pack_forest(forest, base_score: torch.Tensor, learning_rate: float, *,
                strategy: str = "single_tree",
                max_depth: Optional[int] = None) -> PackedForest:
    """Canonicalize stacked training trees into a `PackedForest`: heap
    `tree.Forest` buffers map onto the global node numbering; a stacked
    `tree.NodeTree` packs as it is.  ``single_tree`` buffers arrive as
    ``(T, ...)``; ``one_vs_all`` buffers carry a per-output axis ``(T, d,
    ...)``, folded into the tree axis round-major with ``out_col`` the
    output of each width-1 tree, so that `slice_rounds` and each column's
    order of adds match the training loop.  ``max_depth`` overrides the
    walk bound (the leaf-wise trainer passes its depth limit); by default
    it comes from the heap's shape or, for node trees, from a host-side
    sweep of the pointers."""
    forest, out_col = _fold_outputs(forest, strategy)
    if isinstance(forest, T.NodeTree):
        left = forest.left.to(torch.int32)
        right = forest.right.to(torch.int32)
        if max_depth is None:
            max_depth = _pointer_max_depth(_np(left), _np(right))
        return PackedForest(
            feat=forest.feat.to(torch.int32), thr=forest.thr.to(torch.int32),
            left=left, right=right, leaf=forest.value.to(torch.float32),
            out_col=out_col, base=base_score.to(torch.float32).reshape(-1),
            lr=torch.tensor(learning_rate, dtype=torch.float32),
            cover=forest.cover.to(torch.float32),
            gain=forest.gain.to(torch.float32),
            node_count=forest.node_count.to(torch.int32),
            depth=int(max_depth))
    feat, thr, left, right, leaf = T.heap_to_node_arrays(
        forest.feat.to(torch.int32), forest.thr.to(torch.int32),
        forest.value.to(torch.float32))
    n_trees, h = forest.feat.shape
    device = feat.device
    n_leaves = h + 1
    gain = None if forest.gain is None else torch.cat(
        [forest.gain.to(torch.float32),
         torch.zeros((n_trees, n_leaves), dtype=torch.float32,
                     device=device)], 1)
    cover = None if forest.cover is None else _heap_cover(forest.cover)
    return PackedForest(
        feat=feat, thr=thr, left=left, right=right, leaf=leaf,
        out_col=out_col, base=base_score.to(torch.float32).reshape(-1),
        lr=torch.tensor(learning_rate, dtype=torch.float32),
        cover=cover, gain=gain,
        node_count=torch.full((n_trees,), h + n_leaves, dtype=torch.int32,
                              device=device),
        depth=(n_leaves.bit_length() - 1 if max_depth is None
               else int(max_depth)))


def unpack_forest(pf: PackedForest):
    """Inverse of `pack_forest`: ``(forest, strategy)``.  A heap-canonical
    forest unpacks into heap `tree.Forest` buffers (leaf covers as packed;
    internal covers were derived), any other into a stacked
    `tree.NodeTree`.  A one-vs-all forest (width-1 leaves) comes back with
    a per-output axis, ``(rounds, d, ...)``."""
    one_vs_all = pf.leaf_width != pf.n_outputs
    d = pf.n_outputs
    strategy = "one_vs_all" if one_vs_all else "single_tree"

    def unfold(x):
        if x is None or not one_vs_all:
            return x
        return x.reshape((pf.n_trees // d, d) + tuple(x.shape[1:]))
    if pf.is_heap:
        h = (pf.n_nodes - 1) // 2
        fields = dict(
            feat=pf.feat[:, :h], thr=pf.thr[:, :h], value=pf.leaf[:, h:],
            gain=None if pf.gain is None else pf.gain[:, :h],
            cover=None if pf.cover is None else pf.cover[:, h:])
        return T.Forest(**{k: unfold(v) for k, v in fields.items()}), \
            strategy
    fields = dict(feat=pf.feat, thr=pf.thr, left=pf.left, right=pf.right,
                  value=pf.leaf, gain=pf.gain, cover=pf.cover,
                  node_count=pf.node_count)
    return T.NodeTree(**{k: unfold(v) for k, v in fields.items()}), strategy


def _pointer_max_depth(left, right) -> int:
    """Max root-to-leaf depth from the pointer arrays (host-side sweep)."""
    left = np.asarray(left)
    right = np.asarray(right)
    n_trees, n = left.shape
    d = np.zeros((n_trees, n), np.int32)
    rows = np.arange(n_trees)
    for i in range(n):
        internal = left[:, i] != i
        r = rows[internal]
        d[r, left[internal, i]] = d[r, i] + 1
        d[r, right[internal, i]] = d[r, i] + 1
    return int(d.max()) if n else 0


def heap_packed_to_pointer(feat, thr, leaf, out_col, base, lr, cover=None,
                           gain=None) -> PackedForest:
    """Implicit-heap arrays of checkpoint formats v1/v2 -> pointer
    `PackedForest`, on ``feat``'s device.  ``feat``/``thr`` are (T, 2^D - 1)
    internal-node arrays, ``leaf`` is (T, 2^D, w) leaf-indexed, ``cover`` is
    already in global node order.  Predictions are unchanged."""
    feat = feat.to(torch.int32)
    h = feat.shape[1]
    n_leaves = h + 1
    feat_n, thr_n, left, right, leaf_n = T.heap_to_node_arrays(
        feat, thr.to(torch.int32), leaf.to(torch.float32))
    gain_n = None if gain is None else torch.cat(
        [gain.to(torch.float32),
         torch.zeros((feat.shape[0], n_leaves), dtype=torch.float32,
                     device=feat.device)], 1)
    return PackedForest(
        feat=feat_n, thr=thr_n, left=left, right=right, leaf=leaf_n,
        out_col=out_col.to(torch.int32),
        base=base.to(torch.float32).reshape(-1),
        lr=lr.to(torch.float32).reshape(()),
        cover=None if cover is None else cover.to(torch.float32),
        gain=gain_n,
        node_count=torch.full((feat.shape[0],), h + n_leaves,
                              dtype=torch.int32, device=feat.device),
        depth=n_leaves.bit_length() - 1)


def slice_rounds(pf, n_rounds: int, *, tighten_depth: bool = False):
    """The first ``n_rounds`` boosting rounds of a float32 or quantized
    forest: a slice of every tree-axis field.  ``tighten_depth`` recomputes
    the walk bound from the sliced pointers."""
    t = n_rounds * pf.trees_per_round
    out = pf._replace(**{k: v[:t] for k, v in pf._asdict().items()
                         if k in _TREE_AXIS_FIELDS and v is not None})
    if tighten_depth:
        out = out._replace(depth=max(
            _pointer_max_depth(_np(out.left), _np(out.right)), 1))
    return out


def prune_forest(pf: PackedForest, alpha: float) -> PackedForest:
    """Cost-complexity post-pruning over the packed ``gain``/``cover``.

    One reverse sweep over node ids collapses, bottom-up, every internal
    node whose children are both terminal and whose split gain is
    ``<= alpha``.  The merged leaf is the cover-weighted mean of its
    children, taken in float64 and cast once to float32; a zero-cover
    child hands the other child's leaf through exactly.  Orphaned slots
    become inert (zero leaves, self-loops); `compact_forest` drops them.
    """
    if pf.gain is None or pf.cover is None:
        raise ValueError(
            "prune_forest needs the packed gain AND cover tensors; this "
            "forest was packed/checkpointed without them (format_version "
            "< 2) — re-checkpoint from a freshly trained model")
    feat = _np(pf.feat).copy()
    thr = _np(pf.thr).copy()
    left = _np(pf.left).copy()
    right = _np(pf.right).copy()
    leaf = _np(pf.leaf).astype(np.float64)
    gain = _np(pf.gain).astype(np.float32)
    cover = _np(pf.cover).astype(np.float64)
    n_trees, n = feat.shape
    for t in range(n_trees):
        for i in range(n - 1, -1, -1):
            l, r = left[t, i], right[t, i]
            if l == i:                                     # already terminal
                continue
            if left[t, l] != l or left[t, r] != r:         # child still splits
                continue
            if gain[t, i] > alpha:
                continue
            cl, cr = cover[t, l], cover[t, r]
            if cl <= 0.0:                  # pass-through: keep live child
                v = leaf[t, r]
            elif cr <= 0.0:
                v = leaf[t, l]
            else:
                v = (cl * leaf[t, l] + cr * leaf[t, r]) / (cl + cr)
            leaf[t, i] = v
            leaf[t, l] = 0.0
            leaf[t, r] = 0.0
            left[t, i] = right[t, i] = i                   # now terminal
            feat[t, i] = 0
            thr[t, i] = 0
            gain[t, i] = 0.0
    device = pf.feat.device

    def back(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)
    return pf._replace(
        feat=back(feat, torch.int32), thr=back(thr, torch.int32),
        left=back(left, torch.int32), right=back(right, torch.int32),
        leaf=back(leaf.astype(np.float32), torch.float32),
        gain=back(gain, torch.float32))


def _reachable_nodes(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """(T, N) bool: node slots reachable from each tree's root (node 0)."""
    n_trees, n = left.shape
    reach = np.zeros((n_trees, n), bool)
    if n == 0:
        return reach
    reach[:, 0] = True
    rows = np.arange(n_trees)
    for i in range(n):
        internal = reach[:, i] & (left[:, i] != i)
        r = rows[internal]
        reach[r, left[internal, i]] = True
        reach[r, right[internal, i]] = True
    return reach


def compact_forest(pf):
    """Drop unreachable node slots and shrink the node axis: a pure
    renumbering, predictions unchanged.

    Reachable nodes keep their ascending order (parents before children),
    pointers are remapped, the node axis is padded to a multiple of 8 with
    inert self-loop slots, and ``depth`` is recomputed.  Float32 and
    quantized forests alike: node fields keep their dtype.
    """
    left = _np(pf.left)
    right = _np(pf.right)
    n_trees, n = left.shape
    reach = _reachable_nodes(left, right)
    counts = reach.sum(axis=1).astype(np.int32)            # (T,)
    k_max = int(counts.max()) if n_trees else 0
    n_new = max(k_max + (-k_max) % 8, 8)
    iota = np.arange(n_new, dtype=np.int32)
    left_n = np.broadcast_to(iota, (n_trees, n_new)).copy()
    right_n = left_n.copy()
    # Node fields are gathered as torch tensors on the host: a bfloat16
    # leaf block has no numpy dtype.
    src = {k: getattr(pf, k).cpu() for k in ("feat", "thr", "leaf", "cover",
                                              "gain")
           if getattr(pf, k) is not None}
    dst = {k: v.new_zeros((n_trees, n_new) + tuple(v.shape[2:]))
           for k, v in src.items()}
    for t in range(n_trees):
        keep = np.flatnonzero(reach[t])                    # ascending old ids
        k = keep.size
        remap = np.zeros(n, np.int64)
        remap[keep] = np.arange(k)
        idx = torch.from_numpy(keep)
        for name, v in src.items():
            dst[name][t, :k] = v[t, idx]
        lk, rk = left[t, keep], right[t, keep]
        term = lk == keep
        left_n[t, :k] = np.where(term, np.arange(k), remap[lk])
        right_n[t, :k] = np.where(term, np.arange(k), remap[rk])
    device = pf.feat.device
    upd = {k: v.to(device) for k, v in dst.items()}
    upd.update(left=torch.from_numpy(left_n).to(device),
               right=torch.from_numpy(right_n).to(device),
               node_count=torch.from_numpy(counts).to(device),
               depth=max(_pointer_max_depth(left_n, right_n), 1))
    return pf._replace(**upd)


def _apply(pf, F: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Add the forest to ``F`` in place through the traversal kernel for
    its storage: B5 for a quantized forest (``leaf_scale``), else B3."""
    scale = getattr(pf, "leaf_scale", None)
    if scale is None:
        return predict_kernel.forest_traverse(
            F, codes, pf.feat, pf.thr, pf.left, pf.right, pf.leaf,
            pf.out_col, float(pf.lr), depth=pf.depth)
    return predict_quant_kernel.forest_traverse_quant(
        F, codes, pf.feat, pf.thr, pf.left, pf.right, pf.leaf, scale,
        pf.out_col, float(pf.lr), depth=pf.depth)


def predict_raw(pf, codes: torch.Tensor, *,
                row_chunk: int = 0) -> torch.Tensor:
    """Raw scores ``base + lr * sum_t f_t(x)`` for (n, m) uint8 codes on
    the forest's device, scored in chunks of ``row_chunk`` rows (0 = all
    at once).  ``pf`` is a `PackedForest` or a `QuantizedForest`."""
    n, d = codes.shape[0], pf.n_outputs
    out = pf.base.to(codes.device).expand(n, d).contiguous()
    chunk = n if row_chunk <= 0 else min(row_chunk, n)
    for s in range(0, n, max(chunk, 1)):
        _apply(pf, out[s:s + chunk], codes[s:s + chunk])
    return out


def predict_raw_pipelined(pf, rows, *, row_chunk: int = 8192,
                          prepare=None) -> torch.Tensor:
    """`predict_raw` in ``row_chunk``-row chunks, with each chunk's
    host-to-device copy overlapping the work on the chunk before it.

    ``rows`` (n, ...) are (n, m) uint8 codes, or whatever ``prepare`` turns
    into codes on the forest's device chunk by chunk (the server passes raw
    features and bins them there).  Host rows (a numpy array or a CPU
    tensor) on a CUDA forest pass through two pinned staging buffers: the
    host fills one while the other's copy runs on a side stream, an event
    orders each copy before its chunk's work on the current stream and
    tells the host when the buffer may be refilled, and ``record_stream``
    keeps the copied chunk alive until that work is done.  Rows already on
    the forest's device, or a forest on the CPU, have nothing to stage and
    go through `predict_raw`.  The arithmetic per row is `predict_raw`'s,
    so the scores are bitwise equal.
    """
    prepare = prepare or (lambda x: x)
    device = pf.feat.device
    n = rows.shape[0]
    chunk = min(max(int(row_chunk), 1), n) if n else 1
    host = rows if torch.is_tensor(rows) else torch.from_numpy(
        np.ascontiguousarray(rows))
    if device.type != "cuda" or host.device == device:
        return predict_raw(pf, prepare(host.to(device)), row_chunk=chunk)
    host = host.contiguous()
    out = pf.base.expand(n, pf.n_outputs).contiguous()
    side = torch.cuda.Stream(device=device)
    main = torch.cuda.current_stream(device)
    bufs = [torch.empty((chunk,) + tuple(host.shape[1:]), dtype=host.dtype,
                        pin_memory=True) for _ in range(2)]
    copied = [None, None]       # each buffer's last copy to the card

    def stage(i, s):
        buf = bufs[i % 2][:min(chunk, n - s)]
        if copied[i % 2] is not None:
            copied[i % 2].synchronize()
        buf.copy_(host[s:s + chunk])
        with torch.cuda.stream(side):
            part = buf.to(device, non_blocking=True)
            copied[i % 2] = torch.cuda.Event()
            copied[i % 2].record(side)
        return part, copied[i % 2]

    nxt = stage(0, 0) if n else None
    for i, s in enumerate(range(0, n, chunk)):
        part, ready = nxt
        if s + chunk < n:
            nxt = stage(i + 1, s + chunk)   # the next copy starts now
        main.wait_event(ready)
        part.record_stream(main)
        _apply(pf, out[s:s + chunk], prepare(part))
    return out


def _round_groups(pf):
    """Each boosting round's trees as a forest of their own, in order."""
    k = pf.trees_per_round
    for r in range(pf.n_rounds):
        yield pf._replace(**{f: v[r * k:(r + 1) * k]
                             for f, v in pf._asdict().items()
                             if f in _TREE_AXIS_FIELDS and v is not None})


def predict_staged(pf, codes: torch.Tensor) -> torch.Tensor:
    """Cumulative raw scores after every boosting round: ``(n_rounds, n,
    d)``.  One traversal launch per round group adds that round's trees to
    the running scores, so ``staged[r]`` equals `predict_raw` of
    `slice_rounds` ``(pf, r + 1)`` bit for bit.  Holds the whole trajectory:
    meant for validation-sized inputs."""
    n, d = codes.shape[0], pf.n_outputs
    F = pf.base.to(codes.device).expand(n, d).contiguous()
    staged = torch.empty((pf.n_rounds, n, d), dtype=torch.float32,
                         device=codes.device)
    for r, group in enumerate(_round_groups(pf)):
        F = _apply(group, F, codes)
        staged[r] = F
    return staged


def staged_eval(pf, codes: torch.Tensor, Y: torch.Tensor,
                loss_name: str) -> torch.Tensor:
    """Validation loss after every boosting round, ``(n_rounds,)`` float32,
    without holding the staged scores: the arg-min gives the best
    iteration.  The scores are `predict_staged`'s."""
    loss = L.get_loss(loss_name)
    n, d = codes.shape[0], pf.n_outputs
    F = pf.base.to(codes.device).expand(n, d).contiguous()
    out = torch.zeros(pf.n_rounds, dtype=torch.float32, device=codes.device)
    for r, group in enumerate(_round_groups(pf)):
        F = _apply(group, F, codes)
        out[r] = loss.value(F, Y)
    return out
