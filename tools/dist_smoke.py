#!/usr/bin/env python3
"""Phase 12 of ``chip_smoke.py`` alone: distributed SketchBoost on one card.

    python3 tools/dist_smoke.py

Builds the kernels the distributed path runs (B1, B1-bf16, B2, B2-wide, B3,
B4), makes phase 4's data on the card (2,097,152 training rows, 262,144
test rows, 100 features, d = 512) and runs `chip_smoke.distributed_phase`:
the one-rank NCCL world, the four-rank gloo world on the one card and the
two-rank resume world, with every check of phase 12.  Prints the card, the
phase's lines and its record as one JSON line; about two minutes of
command time.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> int:
    import torch

    import chip_smoke as CS
    from repro_torch.configs import sketchboost_tabular as paper
    from repro_torch.kernels import _build, hist_kernel, predict_kernel
    from repro_torch.kernels import split_kernel

    if not torch.cuda.is_available():
        print("dist_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    kernels = [hist_kernel.KERNEL, hist_kernel.KERNEL_BF16,
               hist_kernel.DIRECT_KERNEL, split_kernel.KERNEL,
               split_kernel.WIDE_KERNEL, predict_kernel.KERNEL]
    t0 = time.perf_counter()
    _build.build(kernels)
    print(f"built in {time.perf_counter() - t0:.2f} s")
    n_tr, n_ev = CS.N_TRAIN, CS.N_EVAL
    X, y = CS.make_data(torch, dev, n_tr + n_ev + CS.N_TEST,
                        paper.N_FEATURES, paper.CONFIG.n_outputs, seed=0)
    rec, _ = CS.distributed_phase(
        torch, dev, X[:n_tr], y[:n_tr], X[n_tr + n_ev:], y[n_tr + n_ev:],
        paper.CONFIG)
    print(json.dumps({"distributed": rec, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
