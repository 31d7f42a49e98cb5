"""Quickstart: SketchBoost (the paper's algorithm) in five lines.

Trains the sketched single-tree GBDT on a synthetic multiclass problem and
compares every sketch strategy against SketchBoost Full, the paper's
Table 1 in miniature.

  PYTHONPATH=src python -m repro_torch.examples.quickstart
  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.core import losses as L
from repro_torch.core.boosting import GBDTConfig, SketchBoost
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import make_tabular, train_test_split

METHODS = (("none", 0), ("top_outputs", 3), ("random_sampling", 3),
           ("random_projection", 3))


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--rows", type=int, default=8000)
    ap.add_argument("--features", type=int, default=40)
    ap.add_argument("--classes", type=int, default=9)
    ap.add_argument("--trees", type=int, default=80)
    ap.add_argument("--depth", type=int, default=5)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    a = parse_args(argv)
    device = resolve_device(a.device)
    # Otto-like: 9 classes.  (The paper's datasets need Kaggle access; the
    # synthetic generator follows its App. B.7 protocol.)
    X, y = make_tabular("multiclass", n=a.rows, m=a.features, d=a.classes,
                        seed=0)
    Xtr, Xte, ytr, yte = train_test_split(X, y, seed=0)
    yte_t = torch.as_tensor(yte, device=device).long()

    print(f"{'method':<20} {'k':>3} {'test_loss':>10} {'acc':>7} {'time':>7}")
    rows = []
    for method, k in METHODS:
        cfg = GBDTConfig(loss="multiclass", sketch_method=method, sketch_k=k,
                         n_trees=a.trees, depth=a.depth, learning_rate=0.1,
                         early_stopping_rounds=20)
        t0 = time.perf_counter()
        model = SketchBoost(cfg, device=device).fit(Xtr, ytr,
                                                     eval_set=(Xte, yte))
        dt = time.perf_counter() - t0
        acc = float(L.accuracy(model.predict_raw(Xte), yte_t))
        loss = model.eval_loss(Xte, yte)
        name = method if method != "none" else "full (no sketch)"
        print(f"{name:<20} {k:>3} {loss:>10.4f} {acc:>7.3f} {dt:>6.1f}s")
        rows.append(dict(method=method, k=k, test_loss=loss, accuracy=acc,
                         fit_s=dt, rounds=len(model.history),
                         best_iteration=model.best_iteration))
    return {"device": str(device), "methods": rows}


if __name__ == "__main__":
    main()
