"""End-to-end GBDT serving example: two models, one registry, compressed twin.

Walks the production path on synthetic data:

  1. train TWO SketchBoost models (an Otto-like multiclass and a smaller
     second task), checkpoint each,
  2. load both into one `ModelRegistry`, and register the first model a
     SECOND time as a pruned + int8-quantized variant of the same
     checkpoint (compressed at load; nothing is retrained or re-saved),
  3. serve micro-batched requests against every model through the shared
     bucket cache, and check the float32 path against the in-memory model
     bit for bit,
  4. compare full-precision vs compressed latency and footprint.

The float32 servers walk the forest with the traversal kernel (B3), the
int8 twin with its quantized twin (B5).

  PYTHONPATH=src python -m repro_torch.examples.serve_gbdt
  PYTHONPATH=src python -m repro_torch.examples.serve_gbdt --device cpu
"""
from __future__ import annotations

import argparse
import tempfile
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np

from repro_torch.core.boosting import GBDTConfig, SketchBoost
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import make_tabular, train_test_split
from repro_torch.io.checkpoint import save_forest_checkpoint
from repro_torch.training.serve_lib import ModelRegistry


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--rows", type=int, default=4000,
                    help="the first model's rows (the second's: half)")
    ap.add_argument("--trees", type=int, default=60,
                    help="the first model's rounds (the second's: half)")
    return ap.parse_args(argv)


def _train(name, n, m, d, trees, depth, seed, device, root):
    X, y = make_tabular("multiclass", n, m, d, seed=seed)
    Xtr, Xte, ytr, yte = train_test_split(X, y, seed=seed)
    cfg = GBDTConfig(loss="multiclass", sketch_method="random_projection",
                     sketch_k=3, n_trees=trees, depth=depth,
                     learning_rate=0.1, early_stopping_rounds=15, seed=seed)
    t0 = time.perf_counter()
    model = SketchBoost(cfg, device=device).fit(Xtr, ytr,
                                                 eval_set=(Xte, yte))
    print(f"[train] {name}: {model.packed.n_trees} trees in "
          f"{time.perf_counter() - t0:.1f}s, "
          f"test loss {model.eval_loss(Xte, yte):.4f}")
    ckpt = f"{root}/{name}"
    save_forest_checkpoint(ckpt, model.packed, model.quantizer,
                           metadata={"loss": cfg.loss})
    return model, Xte, ckpt


def _latency(reg, name, requests):
    for size in {r.shape[0] for r in requests}:        # warm every bucket
        reg.predict(name, requests[[r.shape[0]
                                    for r in requests].index(size)])
    lat = []
    for r in requests:
        t0 = time.perf_counter()
        reg.predict(name, r).cpu()                 # the answer on the host
        lat.append((time.perf_counter() - t0) * 1e3)
    return float(np.percentile(lat, 50)), float(np.percentile(lat, 99))


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    a = parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="repro_torch_serve_") as root:
        return _run(a, resolve_device(a.device), root)


def _run(a, device, root) -> Dict[str, Any]:
    # 1. Two independent models, two checkpoints.
    otto, X_otto, ckpt_otto = _train("otto", a.rows, 20, 6, trees=a.trees,
                                     depth=5, seed=0, device=device,
                                     root=root)
    moa, X_moa, ckpt_moa = _train("moa", a.rows // 2, 12, 4,
                                  trees=a.trees // 2, depth=4, seed=1,
                                  device=device, root=root)

    # 2. One registry, three servers: "otto_int8" is the SAME checkpoint as
    #    "otto", compressed at load (alpha = 0 drops gainless splits, the
    #    slots are compacted, the leaves int8).  All three share one bucket
    #    cache, so equal request shapes reuse buckets across models.
    reg = ModelRegistry(max_buckets=8, device=device)
    reg.load("otto", ckpt_otto)
    reg.load("otto_int8", ckpt_otto, prune_alpha=0.0, quantize="int8")
    reg.load("moa", ckpt_moa)
    comp = reg.get("otto_int8").compression
    print(f"[load]  otto_int8 compressed at load: "
          f"{comp['nodes_before']} -> {comp['nodes_after']} nodes, "
          f"{comp['bytes_before']:,} -> {comp['bytes_after']:,} bytes "
          f"(quantize={comp['quantize']})")

    # 3. Serve micro-batched requests against every model.
    rng = np.random.default_rng(2)
    reqs_otto = [X_otto[rng.integers(0, len(X_otto),
                                     size=rng.integers(1, 64))]
                 for _ in range(32)]
    reqs_moa = [X_moa[rng.integers(0, len(X_moa), size=rng.integers(1, 64))]
                for _ in range(16)]
    proba = np.concatenate(reg.serve("otto", reqs_otto), axis=0)
    _ = reg.serve("moa", reqs_moa)

    # float32 served probabilities == in-memory model, bit for bit.
    expect = otto.predict(np.concatenate(reqs_otto, axis=0)).cpu().numpy()
    np.testing.assert_array_equal(proba, expect)
    print("[check] fp32 served outputs match the in-memory model exactly")

    # The quantized twin: the same argmax on most rows, a smaller forest.
    p_q = np.concatenate(reg.serve("otto_int8", reqs_otto), axis=0)
    agree = float((p_q.argmax(1) == expect.argmax(1)).mean())
    print(f"[check] int8+pruned twin agrees with fp32 argmax on "
          f"{agree:.1%} of rows")

    # 4. Latency on a fixed replay of single-row + 32-row mixes.
    replay = [X_otto[rng.integers(0, len(X_otto), size=s)]
              for s in (1, 32) * 20]
    p50_f, p99_f = _latency(reg, "otto", replay)
    p50_q, p99_q = _latency(reg, "otto_int8", replay)
    print(f"[lat ]  otto      p50 {p50_f:6.2f}ms  p99 {p99_f:6.2f}ms")
    print(f"[lat ]  otto_int8 p50 {p50_q:6.2f}ms  p99 {p99_q:6.2f}ms")

    st = reg.stats()["bucket_cache"]
    print(f"[cache] shared buckets {st['active_buckets']} "
          f"(hits {st['hits']}, admissions {st['admissions']}, "
          f"upgrades {st['upgrades']}, evictions {st['evictions']})")
    groups = reg.shared_signatures()
    print(f"[reg ]  {len(reg)} models, "
          f"{len(groups)} distinct compile signatures")
    return {"device": str(device), "fp32_bitwise": True,
            "int8_argmax_agree": agree, "compression": comp,
            "latency_ms": {"otto": [p50_f, p99_f],
                           "otto_int8": [p50_q, p99_q]},
            "bucket_cache": st, "models": len(reg),
            "signatures": len(groups)}


if __name__ == "__main__":
    main()
