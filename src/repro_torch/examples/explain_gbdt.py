"""Train -> checkpoint -> load -> explain, end to end.

Trains a small multiclass SketchBoost model, checkpoints it (per-node
covers and gains ride along), reloads it in a fresh `ForestServer`, and
produces a top-k per-class attribution report from the checkpoint alone,
asserting the TreeSHAP local-accuracy invariant (base + sum of
attributions == raw prediction) along the way.  The attributions run
through the TreeSHAP kernel (B6), the predictions through B3.

  PYTHONPATH=src python -m repro_torch.examples.explain_gbdt
  PYTHONPATH=src python -m repro_torch.examples.explain_gbdt --device cpu
"""
from __future__ import annotations

import argparse
import tempfile
from typing import Any, Dict, Optional, Sequence

import numpy as np

from repro_torch import explain as EX
from repro_torch.core.boosting import GBDTConfig, SketchBoost
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import make_tabular, train_test_split
from repro_torch.io.checkpoint import save_forest_checkpoint
from repro_torch.training.serve_lib import ForestServer


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--rows", type=int, default=4000)
    ap.add_argument("--trees", type=int, default=40)
    ap.add_argument("--explain-rows", type=int, default=256)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    a = parse_args(argv)
    device = resolve_device(a.device)
    d, topk = 6, 3
    X, y = make_tabular("multiclass", a.rows, 20, d, seed=0)
    Xtr, Xte, ytr, yte = train_test_split(X, y, seed=0)

    cfg = GBDTConfig(loss="multiclass", sketch_method="random_projection",
                     sketch_k=3, n_trees=a.trees, depth=5, learning_rate=0.1,
                     seed=0)
    model = SketchBoost(cfg, device=device).fit(Xtr, ytr)
    loss = model.eval_loss(Xte, yte)
    print(f"trained {model.packed.n_trees} trees "
          f"(depth {model.packed.depth}, d={d}), test loss {loss:.4f}")

    with tempfile.TemporaryDirectory(prefix="repro_torch_explain_") as ckpt:
        save_forest_checkpoint(ckpt, model.packed, model.quantizer,
                               metadata={"loss": cfg.loss})
        server = ForestServer.from_checkpoint(ckpt, device=device)
    assert server.explainable, "the checkpoint must carry covers"

    rows = Xte[:a.explain_rows]
    phi, base = server.explain(rows)                   # (n, m, d), (d,)

    # Local accuracy: the attributions decompose the raw scores exactly.
    raw = server.predict_raw(rows).cpu().numpy()
    err = float(np.max(np.abs(base + phi.sum(axis=1) - raw)))
    assert err < 1e-4, f"local accuracy violated: {err}"
    print(f"local accuracy: max |base + sum(phi) - raw| = {err:.2e} "
          f"over {rows.shape[0]} rows")

    # Per-class report for the most confident row of each class.
    proba = server.predict(rows).cpu().numpy()
    print(f"\ntop-{topk} feature attributions (most confident row per class)")
    for j in range(d):
        i = int(np.argmax(proba[:, j]))
        order = np.argsort(-np.abs(phi[i, :, j]))[:topk]
        feats = "  ".join(f"x{f}={phi[i, f, j]:+.4f}" for f in order)
        print(f"  class {j}: row {i:3d} p={proba[i, j]:.3f}  "
              f"base {base[j]:+.3f}  {feats}")

    imp = server.feature_importances("gain")
    order = np.argsort(-imp)[:topk]
    print("\nglobal gain importances: "
          + ", ".join(f"x{f}={imp[f]:.3f}" for f in order))
    emb = EX.apply_forest(server.packed,
                          server._codes(rows[:4])).cpu().numpy()
    print(f"leaf embeddings for 4 rows: shape {emb.shape}, "
          f"first row {emb[0][:6].tolist()}...")
    return {"device": str(device), "test_loss": loss,
            "local_accuracy_err": err, "phi_shape": list(phi.shape),
            "top_gain_features": order.tolist(),
            "embedding_shape": list(emb.shape)}


if __name__ == "__main__":
    main()
