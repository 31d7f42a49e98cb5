#!/usr/bin/env python3
"""Phase 17 of ``chip_smoke.py`` alone: the rest of the reference's
surface on the card.

    python3 tools/surface_smoke.py

Builds the GBDT kernels (B1, B2, B3, B4, B5 and B6), makes phase 4's data
on the card, fits phase 4's model (the paper's configuration at full
width, all 100 rounds) and runs `chip_smoke.surface_phase` on it: the
forest replay and leaf walk against B3, `boost_scan` against the per-round
loop at full width, B2 against the brute-force oracle, the metrics and
the four examples at their default sizes, with every check.  Prints the
card, the phase's lines and its record as one JSON line; about three
minutes of command time.
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
    from repro_torch.core.boosting import SketchBoost
    from repro_torch.kernels import (_build, hist_kernel, predict_kernel,
                                     predict_quant_kernel, shap_kernel,
                                     split_kernel)

    if not torch.cuda.is_available():
        print("surface_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    every = [hist_kernel.KERNEL, split_kernel.KERNEL, predict_kernel.KERNEL,
             predict_quant_kernel.KERNELS[torch.int8],
             predict_quant_kernel.KERNELS[torch.bfloat16],
             shap_kernel.KERNEL, hist_kernel.DIRECT_KERNEL,
             split_kernel.WIDE_KERNEL]
    t0 = time.perf_counter()
    _build.build(every)
    print(f"built in {time.perf_counter() - t0:.2f} s")
    n_tr, n_ev = CS.N_TRAIN, CS.N_EVAL
    X, y = CS.make_data(torch, dev, n_tr + n_ev + CS.N_TEST,
                        paper.N_FEATURES, paper.CONFIG.n_outputs, seed=0)
    t0 = time.perf_counter()
    model = SketchBoost(paper.CONFIG, device=dev).fit(
        X[:n_tr], y[:n_tr], eval_set=(X[n_tr:n_tr + n_ev],
                                      y[n_tr:n_tr + n_ev]))
    torch.cuda.synchronize()
    print(f"phase 4's fit: {len(model.history)} rounds in "
          f"{time.perf_counter() - t0:.2f} s")
    rec = CS.surface_phase(torch, dev, model, X[:n_tr], y[:n_tr],
                           X[n_tr + n_ev:], y[n_tr + n_ev:], every)
    print(json.dumps({"surface": rec, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
