#!/usr/bin/env python3
"""Profile one long prefill of an SSM-family model (mamba2, zamba2) on one
CUDA card: where `lm.forward`'s time goes.

    python3 tools/profile_ssm_prefill.py [--arch mamba2-370m zamba2-1.2b]
        [--tokens 32768] [--requests 3] [--src DIR] [--tag NAME]

``--src`` names the directory that ``repro_torch`` is imported from (this
checkout's ``src`` by default), so that two versions of the package can be
timed in one call, in turns.  Each model runs at its published widths and
depth in bf16, random weights from a seeded ``torch.Generator``, tokens from
``lm_batches(seed=0)``, batch 1:

- one untimed request, then ``--requests`` timed ones through
  ``make_prefill_step`` (host clock, ending in ``torch.cuda.synchronize``),
  with CUDA events around every ``ssm._ssd_chunked`` call (the SSD scan)
  and every ``ssm.ssm_apply`` call (the whole Mamba2 block, the scan
  included);
- one more request under ``torch.profiler``: the device time summed over
  every kernel, the host wall time of the request, and the kernels that
  take the most device time.

Prints one JSON line a model and writes the profiler's whole table to
``chiprun_out/profile_ssm_prefill_<tag>_<arch>.txt``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile(torch, arch: str, tokens: int, requests: int, tag: str):
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import lm_batches
    from repro_torch.models import lm, ssm
    from repro_torch.training.lm_serve import make_prefill_step

    cfg = get_config(arch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = lm.init(cfg, gen)
    stream = lm_batches(cfg.vocab_size, 1, tokens, seed=0)
    step = make_prefill_step(cfg)

    spans = {"ssd": [], "ssm_apply": []}
    real = {"ssd": ssm._ssd_chunked, "ssm_apply": ssm.ssm_apply}

    def timed(name):
        def call(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real[name](*args, **kw)
            end.record()
            spans[name].append((start, end))
            return out
        return call

    step(params, next(stream))                    # untimed: warms the caches
    torch.cuda.synchronize()
    wall, ssd_ms, block_ms = [], [], []
    ssm._ssd_chunked, ssm.ssm_apply = timed("ssd"), timed("ssm_apply")
    try:
        for _ in range(requests):
            batch = next(stream)
            for v in spans.values():
                v.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = step(params, batch)
            torch.cuda.synchronize()
            wall.append(1e3 * (time.perf_counter() - t0))
            assert bool(logits.isfinite().all()), f"{arch}: not finite"
            ssd_ms.append(sum(s.elapsed_time(e) for s, e in spans["ssd"]))
            block_ms.append(sum(s.elapsed_time(e)
                                for s, e in spans["ssm_apply"]))
        n_ssd = len(spans["ssd"])
    finally:
        ssm._ssd_chunked, ssm.ssm_apply = real["ssd"], real["ssm_apply"]

    batch = next(stream)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(params, batch)
        torch.cuda.synchronize()
        prof_wall = 1e3 * (time.perf_counter() - t0)
    table = prof.key_averages()
    kernels = [e for e in table if _device_us(e) > 0
               and getattr(e, "device_type", None) is not None
               and "CUDA" in str(e.device_type)]
    # Without device events (no CUPTI) the busy share is not measured.
    device_ms = sum(_device_us(e) for e in kernels) / 1e3 if kernels else None
    top = sorted(kernels, key=_device_us, reverse=True)[:8]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    path = os.path.join(ROOT, "chiprun_out",
                        f"profile_ssm_prefill_{tag}_{arch}.txt")
    with open(path, "w") as f:
        try:
            f.write(table.table(sort_by="self_device_time_total",
                                row_limit=60))
        except (AttributeError, KeyError):
            f.write(table.table(sort_by="self_cuda_time_total", row_limit=60))
    rec = dict(tag=tag, arch=arch, tokens=tokens, layers=cfg.n_layers,
               chunk=cfg.ssm_chunk, wall_ms=wall,
               wall_ms_median=statistics.median(wall),
               ssd_ms=ssd_ms, ssd_ms_median=statistics.median(ssd_ms),
               ssd_calls=n_ssd, ssm_block_ms=block_ms,
               ssm_block_ms_median=statistics.median(block_ms),
               profiled_wall_ms=prof_wall, profiled_device_ms=device_ms,
               profiled_kernel_launches=sum(e.count for e in kernels),
               device_busy_share=(None if device_ms is None
                                  else device_ms / prof_wall),
               top_kernels=[dict(name=e.key[:80], calls=e.count,
                                 ms=_device_us(e) / 1e3) for e in top])
    print(json.dumps(rec), flush=True)
    del params, logits
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", nargs="+",
                    default=["mamba2-370m", "zamba2-1.2b"])
    ap.add_argument("--tokens", type=int, default=32_768)
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--tag", default="source")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("profile_ssm_prefill: no CUDA card", file=sys.stderr)
        return 1
    for arch in args.arch:
        profile(torch, arch, args.tokens, args.requests, args.tag)
    return 0


if __name__ == "__main__":
    sys.exit(main())
