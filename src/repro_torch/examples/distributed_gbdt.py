"""Distributed SketchBoost: the paper's algorithm on a (data, model) mesh
of ranks: rows sharded over ``data``, output classes over ``model``.

Shows the distributed feature set: leaf-wise (best-first) growth, the
`fit_distributed` entry point (bit-compatible with the single-device
fit), and the optional JL-compressed histogram collective with its
analytic byte budget.  The ranks are fresh processes joined over gloo through a
``FileStore`` (`launch.dist.spawn`); on the card they all share it.

  PYTHONPATH=src python -m repro_torch.examples.distributed_gbdt
  PYTHONPATH=src python -m repro_torch.examples.distributed_gbdt \\
      --device cpu --mesh 2,1
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import tempfile
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import distributed as GD
from repro_torch.core import quantize as Q
from repro_torch.core.boosting import GBDTConfig
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import make_tabular
from repro_torch.launch.dist import spawn
from repro_torch.launch.mesh import make_mesh

AXES = ("data", "model")


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="each rank's torch device (default: the CUDA "
                         "card, shared by every rank)")
    ap.add_argument("--mesh", default="4,2",
                    help="data,model: the mesh's shape, one rank a slot")
    ap.add_argument("--rows", type=int, default=16384)
    ap.add_argument("--trees", type=int, default=30)
    ap.add_argument("--compressed-trees", type=int, default=10)
    return ap.parse_args(argv)


def _config(trees: int) -> GBDTConfig:
    return GBDTConfig(loss="multiclass", n_outputs=16, depth=6, n_bins=64,
                      growth="leafwise", max_leaves=24,  # best-first trees
                      sketch_method="random_projection", sketch_k=4,
                      learning_rate=0.2, n_trees=trees)


def rank_main(payload: Dict[str, Any], ctx) -> Optional[Dict[str, Any]]:
    """One rank's share of both fits; mesh rank 0 returns the results."""
    shape = tuple(payload["mesh"])
    mesh = make_mesh(shape, AXES, device=ctx.device)
    if mesh is None:
        return None
    codes, y = payload["codes"], payload["y"]
    cfg = _config(payload["trees"])
    t0 = time.perf_counter()
    F_l, forest, history = GD.fit_distributed(cfg, mesh, codes, y,
                                              eval_every=10)
    F = mesh.gather(F_l, ("data",), "model")
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    fit_s = time.perf_counter() - t0
    acc = float((F.argmax(1).cpu().numpy() == y).mean())

    # Optional: compress the histogram all-reduce itself (beyond the paper;
    # the count channel stays exact and leaf values are never sketched).
    # With the stats already sketched to k=4 a JL width of 4 passes through
    # unchanged, so it is shown on unsketched stats, where it bites.
    cfg_c = dataclasses.replace(cfg, sketch_method="none", sketch_k=0,
                                dist_hist_compression="sketch", dist_hist_k=6,
                                n_trees=payload["compressed_trees"])
    m, d = codes.shape[1], cfg.n_outputs
    bytes_model = GD.round_collective_bytes(cfg_c, m, d)
    F_c, _, _ = GD.fit_distributed(cfg_c, mesh, codes, y)
    F_c = mesh.gather(F_c, ("data",), "model")
    acc_c = float((F_c.argmax(1).cpu().numpy() == y).mean())
    if mesh.rank != 0:
        return None
    return {"history": history, "fit_s": fit_s, "n_trees":
            int(forest.feat.shape[0]), "accuracy": acc,
            "compressed_accuracy": acc_c, "bytes_model": bytes_model}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    a = parse_args(argv)
    device = resolve_device(a.device)
    shape = tuple(int(s) for s in a.mesh.split(","))
    cfg = _config(a.trees)
    d, m = cfg.n_outputs, 32
    X, y = make_tabular("multiclass", a.rows, m, d, seed=0)
    q = Q.fit_quantizer(X, cfg.n_bins, device="cpu")
    codes = Q.codes_rows(Q.apply_quantizer(q, torch.from_numpy(X))).numpy()
    print(f"[dist-gbdt] mesh {dict(zip(AXES, shape))}; d={d} sharded over "
          f"'model', {a.rows} rows over 'data'; sketch k={cfg.sketch_k}, "
          f"growth={cfg.growth} (max_leaves={cfg.max_leaves}); ranks on "
          f"{device}")
    payload = {"mesh": shape, "codes": codes, "y": y, "trees": a.trees,
               "compressed_trees": a.compressed_trees}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="repro_torch_dist_") as work:
        res = spawn("repro_torch.examples.distributed_gbdt:rank_main",
                    math.prod(shape), work, backend="gloo",
                    device=str(device), payload=payload)[0]
    wall_s = time.perf_counter() - t0
    for rec in res["history"]:
        print(f"  round {rec['round']:3d} train_loss={rec['train_loss']:.4f}")
    print(f"[dist-gbdt] {a.trees} rounds in {res['fit_s']:.1f}s; "
          f"forest of {res['n_trees']} leaf-wise trees")
    print(f"[dist-gbdt] train accuracy {res['accuracy']:.3f}")
    bm = res["bytes_model"]
    print(f"[dist-gbdt] compressed collective: moved {bm['moved_bytes']}B "
          f"of {bm['exact_bytes']}B per round-direction; "
          f"{a.compressed_trees}-round accuracy "
          f"{res['compressed_accuracy']:.3f}")
    return dict(res, device=str(device), mesh=list(shape), wall_s=wall_s)


if __name__ == "__main__":
    main()
