"""GBDT serving driver: checkpointed forest -> batched request stream.

Port of the JAX package's ``launch/serve.py``.  Loads a serving checkpoint
written by `io.checkpoint.save_forest_checkpoint` (or, with ``--demo``,
trains a small synthetic model with the port and checkpoints it), stands up
a `training.serve_lib.ForestServer` on ``--device`` (default: the CUDA
card), and drives a simulated request stream through it in micro-batched
windows, reporting latency percentiles and throughput.

With ``--chaos`` it runs the overload drill instead: a deterministic burst
on a virtual clock that forces queue shedding, a deadline drop and
fallback-forest scoring, checks every degradation counter, and writes the
stats to ``--stats-out``.

  PYTHONPATH=src python -m repro_torch.launch.serve --demo --requests 64
  PYTHONPATH=src python -m repro_torch.launch.serve --demo --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --ckpt CKPT --quantize int8
  PYTHONPATH=src python -m repro_torch.launch.serve --demo --chaos \\
      --stats-out results/serve_chaos_torch.json
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np


def train_demo(ckpt_dir: str, seed: int, device=None) -> int:
    """Train a small synthetic multiclass model with the port on
    ``device`` and checkpoint it; returns its feature count."""
    from repro_torch.core.boosting import GBDTConfig, SketchBoost
    from repro_torch.data.pipeline import make_tabular
    from repro_torch.io.checkpoint import save_forest_checkpoint

    X, y = make_tabular("multiclass", 4000, 20, 6, seed=seed)
    cfg = GBDTConfig(loss="multiclass", sketch_method="random_projection",
                     sketch_k=3, n_trees=40, depth=5, learning_rate=0.1,
                     seed=seed)
    t0 = time.perf_counter()
    model = SketchBoost(cfg, device=device).fit(X, y)
    print(f"[serve] demo model trained in {time.perf_counter() - t0:.1f}s "
          f"({model.packed.n_trees} trees, depth {model.packed.depth}, "
          f"{model.device})")
    save_forest_checkpoint(ckpt_dir, model.packed, model.quantizer,
                           metadata={"loss": cfg.loss,
                                     "n_features": X.shape[1]})
    print(f"[serve] checkpoint written to {ckpt_dir}")
    return X.shape[1]


def chaos_drill(ckpt: str, *, rows: int = 32, requests: int = 8,
                max_batch: int = 4096, seed: int = 0, features: int = 0,
                device=None) -> Dict:
    """Deterministic overload drill on a virtual clock: overwhelm the
    admission queue, expire a deadline, trip the fallback forest.  Returns
    ``{"ok", "stats", "best_iteration", "fallback_rounds"}``; ``ok`` holds
    when every degradation path fired and kept serving."""
    from repro_torch.runtime.chaos import VirtualClock
    from repro_torch.training.serve_lib import ForestServer

    clock = VirtualClock()
    server = ForestServer.from_checkpoint(
        ckpt, max_batch=max_batch, max_queue_rows=4 * rows,
        deadline_ms=50.0, overload_rows=2 * rows, clock=clock,
        device=device)
    m = features or server.quantizer.edges.shape[0]
    rng = np.random.default_rng(seed)
    reqs = [rng.normal(size=(rows, m)).astype(np.float32)
            for _ in range(max(8, requests))]

    # Burst 1: six requests into a four-request queue -> two shed; the four
    # admitted exceed overload_rows -> fallback-forest scoring.
    admitted = [server.submit(r) for r in reqs[:6]]
    outs = server.drain()
    served = sum(o is not None for o in outs)
    # Burst 2: admit two, expire one on the virtual clock before draining.
    server.submit(reqs[6], deadline_ms=10.0)
    server.submit(reqs[7], deadline_ms=500.0)
    clock.advance(0.1)
    outs2 = server.drain()

    s = server.stats
    print(f"[serve-chaos] admitted={sum(admitted)}/6 served={served} "
          f"shed={s['shed_requests']} deadline={s['deadline_requests']} "
          f"fallback_batches={s['fallback_batches']} errors={s['errors']}")
    ok = (s["shed_requests"] == 2 and s["deadline_requests"] == 1
          and s["fallback_batches"] >= 1 and s["errors"] == 0
          and served == 4 and outs2[0] is None and outs2[1] is not None)
    return {"ok": ok, "stats": dict(s),
            "best_iteration": server.best_iteration,
            "fallback_rounds": server._fallback_packed().n_rounds}


def drive_stream(server, requests: List[np.ndarray], window: int) -> Dict:
    """Warm up on one window, zero the counters, then serve ``requests`` in
    windows of ``window``.  Returns rows/s end to end and in predict, and
    p50/p99 latency per request in ms (each request of a window waits for
    the whole window)."""
    server.serve(requests[:window])
    server.reset_stats()
    lat = []
    t0 = time.perf_counter()
    for ofs in range(0, len(requests), window):
        w0 = time.perf_counter()
        outs = server.serve(requests[ofs:ofs + window])
        lat.extend([(time.perf_counter() - w0) * 1e3] * len(outs))
    wall = time.perf_counter() - t0
    n_rows = sum(r.shape[0] for r in requests)
    return {"rows_per_s": n_rows / wall,
            "predict_rows_per_s": server.throughput(),
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99))}


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_serve_gbdt"),
                    help="serving checkpoint directory")
    ap.add_argument("--demo", action="store_true",
                    help="train + checkpoint a synthetic model first")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch versions of the kernels)")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--rows", type=int, default=32,
                    help="rows per request (feature blocks)")
    ap.add_argument("--window", type=int, default=8,
                    help="requests micro-batched per forest pass")
    ap.add_argument("--features", type=int, default=0,
                    help="request feature count (default: from the model)")
    ap.add_argument("--max-batch", type=int, default=4096)
    ap.add_argument("--prune-alpha", type=float, default=None,
                    help="cost-complexity post-pruning threshold (0.0 "
                         "removes gainless splits; default: no pruning)")
    ap.add_argument("--quantize", default="none",
                    choices=("none", "bfloat16", "int8"),
                    help="leaf-block storage dtype (thresholds stay "
                         "split-exact uint8 bin codes)")
    ap.add_argument("--max-buckets", type=int, default=0,
                    help="LRU cap on padded-batch buckets (0 = unbounded)")
    ap.add_argument("--double-buffer", action="store_true",
                    help="overlap host->device copies with traversal on "
                         "streamed oversize batches")
    ap.add_argument("--explain", action="store_true",
                    help="the SHAP endpoint (comes with the explain slice)")
    ap.add_argument("--chaos", action="store_true",
                    help="run the deterministic overload/admission drill "
                         "instead of the throughput driver")
    ap.add_argument("--stats-out", default="",
                    help="write the --chaos stats artifact (JSON) here")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.explain:
        from repro_torch.training.serve_lib import EXPLAIN_SLICE
        raise SystemExit(f"[serve] --explain: {EXPLAIN_SLICE}")
    if args.demo:
        train_demo(args.ckpt, args.seed, args.device)

    if args.chaos:
        res = chaos_drill(args.ckpt, rows=args.rows, requests=args.requests,
                          max_batch=args.max_batch, seed=args.seed,
                          features=args.features, device=args.device)
        if args.stats_out:
            os.makedirs(os.path.dirname(args.stats_out) or ".",
                        exist_ok=True)
            with open(args.stats_out, "w") as f:
                json.dump(res, f, indent=1)
            print(f"[serve-chaos] stats written to {args.stats_out}")
        if not res["ok"]:
            raise SystemExit(f"[serve-chaos] FAIL: degradation counters "
                             f"off: {res['stats']}")
        print("[serve-chaos] OK: shed, deadline-drop, and fallback paths "
              "all fired; no errors")
        return

    from repro_torch.training.serve_lib import ForestServer
    server = ForestServer.from_checkpoint(
        args.ckpt, max_batch=args.max_batch, prune_alpha=args.prune_alpha,
        quantize=args.quantize, max_buckets=args.max_buckets,
        double_buffer=args.double_buffer, device=args.device)
    if server.quantizer is None:
        ap.error(f"checkpoint {args.ckpt} has no quantizer; this driver "
                 "sends raw float features (re-save with the quantizer, or "
                 "serve pre-binned codes via ForestServer.predict_codes)")
    m = args.features or server.quantizer.edges.shape[0]
    pf = server.packed
    print(f"[serve] loaded forest: {pf.n_trees} trees, depth {pf.depth}, "
          f"d={pf.n_outputs}, on {server.device}")
    comp = server.compression
    if comp["prune_alpha"] is not None or comp["quantize"] != "none":
        print(f"[serve] compression: {comp['nodes_before']} -> "
              f"{comp['nodes_after']} nodes, depth {comp['depth_before']} "
              f"-> {comp['depth_after']}, {comp['bytes_before']:,} -> "
              f"{comp['bytes_after']:,} bytes "
              f"(prune_alpha={comp['prune_alpha']}, "
              f"quantize={comp['quantize']})")

    rng = np.random.default_rng(args.seed)
    requests = [rng.normal(size=(args.rows, m)).astype(np.float32)
                for _ in range(args.requests)]
    res = drive_stream(server, requests, args.window)
    print(f"[serve] {args.requests} requests x {args.rows} rows: "
          f"{res['rows_per_s']:,.0f} rows/s end-to-end, "
          f"{res['predict_rows_per_s']:,.0f} rows/s in-predict")
    print(f"[serve] latency/request: p50 {res['p50_ms']:.2f}ms  "
          f"p99 {res['p99_ms']:.2f}ms  (window={args.window}, "
          f"max_batch={args.max_batch})")


if __name__ == "__main__":
    main()
