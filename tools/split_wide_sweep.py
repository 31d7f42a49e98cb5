#!/usr/bin/env python3
"""Time B2's wide entry point (``split.cu``'s ``split_scan_wide_launch``)
at other designs, beside its first version and the narrow entry point, on
one CUDA card.

    python3 tools/split_wide_sweep.py [--quick]

Builds into ``build/split_sweep/`` (one nvcc a library, all started
together):

- ``first``: ``tools/split_wide_first.cu``, a verbatim copy of the first
  wide design (one 128-thread block a (node, feature), a block reduction
  at every bin);
- ``repo``: the repo's ``split.cu`` as it is, called with the wrapper's
  scan blocks (``split_kernel.WIDE_WARPS`` warps, ``WIDE_CHUNKS`` chunks
  of 32 gradient channels);
- ``repo W x K``: the same build called with W scan warps a block and
  spans of K chunks of 32 gradient channels (another grouping of the
  channels, so another order of the sums: held to the plain version, not
  bitwise to the repo build).

At each of SketchBoost Full's level shapes (1, 2, 4, 8, 16 and 32 nodes x
100 features x 256 bins x 513 channels) every build is timed in turns:
first, repo, each variant, repo, first.  Indices are held to the plain
version's (``ref.split_scan_ref``), and the repo build's second call
bitwise to its first.
Then the repo build is called under ``torch.profiler`` at each shape and
its device time split by kernel (scan, score, pick), beside ``hist.sum()``
(one PyTorch read of the same bytes, a yardstick of the read rate).  Then,
for the narrow/wide threshold, the repo build's narrow and wide entry
points at C = 17 and 32 (the narrow one takes at most 32 channels, one
lane each), at 1, 2 and 32 nodes, in turns.  One JSON line a (shape, variant), in ms (CUDA
events around 20 calls straight, after one warm-up), with the card's name
and power limit first.  ``--quick`` times 1 and 32 nodes only.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, os.path.join(ROOT, "src"))

OUT = os.path.join(ROOT, "build", "split_sweep")
NODES = (1, 2, 4, 8, 16, 32)
# Scan blocks (warps a block, chunks of 32 channels a span) beside the
# wrapper's.
BLOCKS = ((1, 4), (1, 16), (2, 8), (4, 8))
THRESHOLD_C = (17, 32)
THRESHOLD_NODES = (1, 2, 32)
V, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def sources() -> dict:
    """{name: source text} of every build."""
    from repro_torch.kernels import _build
    repo = open(_build.CSRC / "split.cu").read()
    return {"first": open(os.path.join(HERE, "split_wide_first.cu")).read(),
            "repo": repo}


def build(found: dict) -> dict:
    """Compile every build, one nvcc each, all together; {name: .so}."""
    from repro_torch.kernels import _build
    os.makedirs(OUT, exist_ok=True)
    procs = []
    for i, (name, text) in enumerate(found.items()):
        cu = os.path.join(OUT, f"v{i}.cu")
        with open(cu, "w") as fh:
            fh.write(text)
        so = cu[:-3] + ".so"
        procs.append((name, so, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", so, cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for name, so, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}:\n{out}")
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                print(json.dumps({"build": name, "ptxas": line.strip()}))
        libs[name] = so
    return libs


def events_ms(fn, reps: int = 20) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def runner(lib, entry: str, hist, mask, block=None):
    """A no-argument call of one entry point straight (no wrapper) at one
    case, and its outputs.  ``entry``: "first" (the first wide design's
    arguments), "wide" (scan blocks of ``block`` = (warps, chunks), the
    wrapper's by default) or "narrow"."""
    import torch
    from repro_torch.kernels import split_kernel as SK
    warps, chunks = block or (SK.WIDE_WARPS, SK.WIDE_CHUNKS)
    nodes, m, B, C = hist.shape
    dev = hist.device
    gain = torch.empty(nodes, device=dev)
    idx = torch.empty(nodes, dtype=torch.int32, device=dev)
    ptrs = [hist, mask, gain, idx, torch.empty((nodes, m), device=dev),
            torch.empty((nodes, m), dtype=torch.int32, device=dev)]
    ints = [nodes, m, B, C]
    if entry == "wide":
        groups = -(-(C - 1) // (32 * chunks))
        ptrs.append(torch.empty((nodes, m, groups, B, 2),
                                dtype=torch.float64, device=dev))
        ints += [warps, chunks]
    fn = (lib.split_scan_launch if entry == "narrow"
          else lib.split_scan_wide_launch)
    fn.argtypes = [V] * len(ptrs) + [I] * len(ints) + [Fl] * 2 + [V]
    fn.restype = I
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = fn(*[p.data_ptr() for p in ptrs], *ints, 1.0, 1.0, stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")
    return run, (gain, idx)


def by_kernel(run, reps: int = 3) -> dict:
    """Device ms a call of ``run`` by kernel name, under torch.profiler,
    and the launches the profiler saw of each."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            name = re.search(r"(\w+)(<[^(]*>)?\(", e.key)
            key = name.group(1) if name else e.key[:60]
            ms, n = out.get(key, (0.0, 0))
            out[key] = (ms + e.self_device_time_total / 1e3 / reps,
                        n + e.count)
    return out


def case(torch, gen, dev, nodes, C, m=100, B=256):
    """``chip_smoke.check_split_wide``'s inputs: normal gradient sums,
    counts 0-39, feature 7 masked."""
    hist = torch.randn((nodes, m, B, C), generator=gen, device=dev)
    hist[..., -1] = torch.randint(0, 40, (nodes, m, B), generator=gen,
                                  device=dev).float()
    mask = torch.ones(m, device=dev)
    mask[7] = 0.0
    return hist, mask


def main() -> int:
    import torch
    from repro_torch.kernels import ref
    quick = "--quick" in sys.argv
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi}))
    found = sources()
    libs = {k: ctypes.CDLL(v) for k, v in build(found).items()}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    variants = [("first", "first", None), ("repo", "wide", None)]
    variants += [(f"repo {w} x {k}", "wide", (w, k)) for w, k in BLOCKS]
    variants += [("repo", "wide", None), ("first", "first", None)]
    for nodes in ((1, 32) if quick else NODES):
        hist, mask = case(torch, gen, dev, nodes, 513)
        pg, pi = ref.split_scan_ref(hist, 1.0, 1.0, mask)
        want = None
        for name, entry, block in variants:
            lib = libs["repo" if name.startswith("repo") else name]
            run, (gain, idx) = runner(lib, entry, hist, mask, block)
            ms = events_ms(run)
            rec = {"shape": f"n{nodes}_c513", "variant": name, "ms": ms,
                   "idx_equal": bool(torch.equal(idx, pi)),
                   "max_abs_err": float((gain - pg).abs().max())}
            assert rec["idx_equal"], f"{name} at {nodes} nodes differs"
            if block is None and entry == "wide":
                if want is None:
                    want = gain.clone()
                rec["bitwise_repo"] = bool(torch.equal(gain, want))
                assert rec["bitwise_repo"], f"{name} n{nodes} differs"
            print(json.dumps(rec))
        run, _ = runner(libs["repo"], "wide", hist, mask)
        print(json.dumps({"shape": f"n{nodes}_c513", "variant": "repo",
                          "device_ms_by_kernel": by_kernel(run),
                          "torch_sum_ms": events_ms(lambda: hist.sum())}))
        del hist
        torch.cuda.empty_cache()
    for C in THRESHOLD_C:
        for nodes in THRESHOLD_NODES:
            hist, mask = case(torch, gen, dev, nodes, C)
            pg, pi = ref.split_scan_ref(hist, 1.0, 1.0, mask)
            for entry in ("narrow", "wide", "wide", "narrow"):
                lib = libs["repo"]
                run, (gain, idx) = runner(lib, entry, hist, mask)
                ms = events_ms(run)
                same_idx = bool(torch.equal(idx, pi))
                print(json.dumps({"shape": f"n{nodes}_c{C}",
                                  "variant": entry, "ms": ms,
                                  "idx_equal": same_idx}))
                assert same_idx, f"{entry} n{nodes} C={C}: indices differ"
    return 0


if __name__ == "__main__":
    sys.exit(main())
