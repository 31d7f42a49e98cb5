#!/usr/bin/env python3
"""B2's picks on the card against its plain version on the CPU, on the
histograms of a one-vs-all fit.

    python3 tools/split_ties.py

Fits 2 rounds of ``strategy="one_vs_all"`` (multiclass, 3,000 x 12, d = 8,
depth 4) on the card with `ops.split_scan` wrapped so that every call's
histograms and results are kept, then runs the plain version
(`ref.split_scan_ref`) on the CPU on each kept histogram and prints, for
up to 4 nodes a call where the two pick different (feature, bin) indices,
the card's index and gain, the plain version's, the plain gain at the
card's index and one float32 ulp of the plain gain.  A one-vs-all tree's
first gradients take two values, and a node at depth 3 holds few rows, so
empty bins and exact ties are common there: this shows how each side
breaks them.  Ends with the number of calls and of differing picks.
"""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> int:
    import numpy as np
    import torch
    from repro_torch.core import split as S
    from repro_torch.core.boosting import GBDTConfig, SketchBoost
    from repro_torch.data.pipeline import make_tabular
    from repro_torch.kernels import ops, ref
    if not torch.cuda.is_available():
        print("split_ties: no CUDA device", file=sys.stderr)
        return 2
    X, y = make_tabular("multiclass", 3000, 12, 8, seed=3, n_informative=12)
    kept = []
    scan = ops.split_scan

    def spy(hist, lam, min_data, feature_mask=None):
        g, i = scan(hist, lam, min_data, feature_mask)
        kept.append((hist.cpu(), g.cpu(), i.cpu(), lam, min_data))
        return g, i

    ops.split_scan = spy
    try:
        cfg = GBDTConfig(strategy="one_vs_all", n_trees=2, depth=4,
                         min_data_in_leaf=20)
        SketchBoost(cfg, device="cuda").fit(X[:2400], y[:2400])
    finally:
        ops.split_scan = scan
    shown = 0
    for hist, g, i, lam, min_data in kept:
        pg, pi = ref.split_scan_ref(hist, lam, min_data,
                                    torch.ones(hist.shape[1]))
        for v in torch.nonzero(pi != i)[:, 0].tolist()[:4]:
            sc = S.split_scores(hist[v:v + 1], lam, min_data).reshape(-1)
            print(f"node {v}: card idx {int(i[v])} gain {float(g[v])!r}; "
                  f"plain idx {int(pi[v])} gain {float(pg[v])!r}; plain gain "
                  f"at the card's idx {float(sc[int(i[v])])!r}; ulp "
                  f"{float(np.spacing(np.float32(pg[v])))!r}")
            shown += 1
    print(f"calls {len(kept)}, differing picks shown {shown}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
