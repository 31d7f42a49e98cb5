"""Multioutput SHAP values over a `PackedForest`.

Port of the JAX package's ``explain/shap.py``.  Two exact algorithms:

  * ``path_dependent`` (default): TreeSHAP with the packed per-node covers
    as the background distribution, through the B6 wrapper
    `kernels.shap_kernel.tree_shap` (the CUDA kernel on the card, its plain
    version on the CPU);
  * ``interventional``: exact interventional TreeSHAP against background
    rows (`kernels.ref.tree_shap_interventional_ref`, plain PyTorch on
    either device: the JAX package has no kernel for it); its base value
    is the mean background prediction.

Both satisfy local accuracy: ``base_values + phi.sum(1) == predict_raw``
up to float32 rounding.  Sums that the reference leaves to XLA run in a
fixed order here (tree order, path order), so a result has the same bits
run to run.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import forest as FO
from repro_torch.explain.paths import PathPack, build_path_pack
from repro_torch.kernels import ref, shap_kernel

ALGORITHMS = ("path_dependent", "interventional")


def expected_values(pf, pack: Optional[PathPack] = None) -> torch.Tensor:
    """Path-dependent expected prediction ``E[F]`` as a ``(d,)`` vector:
    ``base + lr * sum_t sum_l leaf_weight * leaf``, each tree's block at
    its output column; leaves are summed in path order, trees in index
    order."""
    pack = build_path_pack(pf) if pack is None else pack
    T, L, w = pack.leaf.shape
    e_tree = torch.zeros((T, w), dtype=torch.float32, device=pack.leaf.device)
    for l in range(L):
        e_tree = e_tree + pack.leaf_weight[:, l, None] * pack.leaf[:, l]
    acc = torch.zeros(pf.n_outputs, dtype=torch.float32,
                      device=pack.leaf.device)
    for t, col in enumerate(pf.out_col.tolist()):
        acc[col:col + w] += e_tree[t]
    return pf.base + pf.lr.to(acc.device) * acc


def shap_values(pf, codes: torch.Tensor, *,
                algorithm: str = "path_dependent",
                background: Optional[torch.Tensor] = None,
                row_chunk: int = 0, pack: Optional[PathPack] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SHAP attributions for all outputs at once.

    Args:
      pf:         `core.forest.PackedForest` (cover-carrying for
                  ``path_dependent``), on the device the work runs on.
      codes:      (n, m) uint8 binned features on the forest's device.
      algorithm:  "path_dependent" | "interventional".
      background: (B, m) binned background rows (interventional only).
      row_chunk:  rows per call (0 = all at once).
      pack:       optional pre-built `PathPack` (a server's cache).
    Returns:
      ``(phi, base_values)``: (n, m, d) float32 attributions and the (d,)
      expected value they are measured against.
    """
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unknown SHAP algorithm {algorithm!r}; "
                         f"expected one of {ALGORITHMS}")
    if pack is None:
        pack = build_path_pack(pf,
                               need_cover=(algorithm == "path_dependent"))
    d, lr = pf.n_outputs, float(pf.lr)
    if algorithm == "interventional":
        if background is None:
            raise ValueError("interventional SHAP needs a background "
                             "dataset (binned codes)")
        base = FO.predict_raw(pf, background).mean(0)

        def run(part):
            phi = torch.zeros(part.shape + (d,), dtype=torch.float32,
                              device=part.device)
            return ref.tree_shap_interventional_ref(
                phi, part, background, pack.slot_feat, pack.slot_lo,
                pack.slot_hi, pack.leaf, pf.out_col, lr)
    else:
        base = expected_values(pf, pack)

        def run(part):
            return shap_kernel.tree_shap(
                part, pack.slot_feat, pack.slot_lo, pack.slot_hi,
                pack.slot_z, pack.leaf, pf.out_col, lr, n_outputs=d)

    n = codes.shape[0]
    chunk = n if row_chunk <= 0 else min(row_chunk, n)
    outs = [run(codes[s:s + chunk]) for s in range(0, n, max(chunk, 1))]
    phi = outs[0] if len(outs) == 1 else torch.cat(outs, 0)
    return phi, base
