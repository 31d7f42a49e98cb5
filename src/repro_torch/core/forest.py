"""PackedForest: the pointer-topology ensemble format and its traversal.

Port of the JAX package's ``core/forest.py`` for heap trees of the
level-wise grower.  All arrays carry a leading tree axis ``T`` over a node
axis of size ``N = 2^(D+1) - 1``:

  feat, thr    (T, N) int32     split feature / threshold (left if code <= thr)
  left, right  (T, N) int32     child pointers; terminal nodes self-loop
  leaf         (T, N, w) float32 node-indexed leaf blocks (0 on internal nodes)
  out_col      (T,) int32       first output column of each leaf block
  base         (d,) float32     base score
  lr           () float32       learning rate
  cover, gain  (T, N) float32   node covers / split gains
  node_count   (T,) int32       nodes used per tree
  depth        int              walk bound

Every prediction goes through the traversal kernel's wrapper
`repro_torch.kernels.predict_kernel.forest_traverse` (the reference's
``forest_apply``), tree by tree in index order.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import tree as T
from repro_torch.kernels import predict_kernel


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
    def leaf_width(self) -> int:
        return self.leaf.shape[2]

    @property
    def n_outputs(self) -> int:
        return self.base.shape[0]

    @property
    def trees_per_round(self) -> int:
        return 1 if self.leaf_width == self.n_outputs else self.n_outputs


def _heap_cover(leaf_cover: torch.Tensor) -> torch.Tensor:
    """(T, 2^D) leaf covers -> (T, 2^(D+1) - 1) node covers in global node
    order (internal covers are the sums of their leaves)."""
    levels = [leaf_cover.to(torch.float32)]
    while levels[0].shape[1] > 1:
        top = levels[0]
        levels.insert(0, top[:, 0::2] + top[:, 1::2])
    return torch.cat(levels, 1)


def pack_forest(forest: T.Forest, base_score: torch.Tensor,
                learning_rate: float) -> PackedForest:
    """Canonicalize stacked heap trees (``single_tree``) into a
    `PackedForest` over the global node numbering."""
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
        out_col=torch.zeros(n_trees, dtype=torch.int32, device=device),
        base=base_score.to(torch.float32).reshape(-1),
        lr=torch.tensor(learning_rate, dtype=torch.float32),
        cover=cover, gain=gain,
        node_count=torch.full((n_trees,), h + n_leaves, dtype=torch.int32,
                              device=device),
        depth=n_leaves.bit_length() - 1)


def slice_rounds(pf: PackedForest, n_rounds: int) -> PackedForest:
    """The first ``n_rounds`` boosting rounds: a slice of the tree axis."""
    t = n_rounds * pf.trees_per_round
    tree_axis = ("feat", "thr", "left", "right", "leaf", "out_col", "cover",
                 "gain", "node_count")
    return pf._replace(**{k: getattr(pf, k)[:t] for k in tree_axis
                          if getattr(pf, k) is not None})


def predict_raw(pf: PackedForest, codes: torch.Tensor, *,
                row_chunk: int = 0) -> torch.Tensor:
    """Raw scores ``base + lr * sum_t f_t(x)`` for (n, m) uint8 codes,
    scored in chunks of ``row_chunk`` rows (0 = all at once)."""
    n, d = codes.shape[0], pf.n_outputs
    out = pf.base.to(codes.device).expand(n, d).contiguous()
    chunk = n if row_chunk <= 0 else min(row_chunk, n)
    for s in range(0, n, max(chunk, 1)):
        predict_kernel.forest_traverse(
            out[s:s + chunk], codes[s:s + chunk], pf.feat, pf.thr, pf.left,
            pf.right, pf.leaf, pf.out_col, float(pf.lr), depth=pf.depth)
    return out
