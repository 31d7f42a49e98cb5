#!/usr/bin/env python3
"""Phases 14 (a) and 16 of ``chip_smoke.py`` alone: LM training on one
card, then on a (data, model) mesh.

    python3 tools/mesh_smoke.py

Builds B7 and its backward, runs `chip_smoke.training_phase` (phase 14:
h2o-danube-3-4b at full width in bf16, its float32 copy against the CPU
and the GBDT launcher) and `chip_smoke.mesh_training_phase` (phase 16:
the one-rank NCCL mesh repeating phase 14 (a), and four gloo ranks at
mesh (2, 2) held to the one-device step), with every check of both.
Prints the card, the phases' lines and phase 16's record as one JSON
line; a few minutes of command time.
"""
from __future__ import annotations

import gc
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
    from repro_torch.kernels import _build, flash_attention

    if not torch.cuda.is_available():
        print("mesh_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    b7, b7b = flash_attention.KERNEL, flash_attention.BWD_KERNEL
    t0 = time.perf_counter()
    _build.build([b7, b7b])
    print(f"built in {time.perf_counter() - t0:.2f} s")
    _, _, after14 = CS.training_phase(torch, dev, b7, b7b, [b7, b7b])
    gc.collect()
    torch.cuda.empty_cache()
    rec = CS.mesh_training_phase(torch, dev, b7, b7b, [b7, b7b], after14)
    print(json.dumps({"mesh_training": rec, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
