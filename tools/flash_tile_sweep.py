#!/usr/bin/env python3
"""Time B7's bf16 body (``flash_attention.cu``) on one CUDA card with parts
of its tile loop taken out, to see where a tile's time goes.

    python3 tools/flash_tile_sweep.py

Builds copies of ``src/repro_torch/kernels/csrc/flash_attention.cu`` into
``build/flash_sweep/`` (one nvcc a copy, all at once), each with one change
to the tensor-core body:

- ``source``: as it is (held within one bf16 ulp plus 1e-5 of the plain
  version);
- ``ring4``: a K/V ring of 4 tiles where the source keeps 2 (held as the
  source);
- ``pv_hi_only``: P V from the hi part alone (one bf16 product, not three);
- ``no_pv``: no P V products;
- ``no_exp``: the probabilities' exp2 left out;
- ``no_split``: mid and lo left as zeros (hi alone computed);
- ``qk_only``: no P V, no exp2, no split: the staging, QK^T and the masks;
- ``no_loads``, ``qk_only_no_loads``: the same two with the ring's tiles
  copied in only before the loop (later tiles computed on stale stages);
- ``no_proxy_fence``: without the async-proxy fence before each tile's
  barrier;
- ``turns``: the two warpgroups take turns, warpgroup 1 issuing its QK^T
  only once warpgroup 0's is done (a named barrier), so that one's softmax
  may run beside the other's products (held as the source);
- ``split_trunc``: P split by truncation (bit masks and byte permutes, no
  conversions; exact too, held as the source);
- ``trace``: the source with SM clock stamps at five points of the tile
  loop, run once: the median cycles of each phase of a tile.

The copies held as the source compute the function; the others do not.
Times each at the prefill's layer (1 x 32 query heads over 8 kv heads x
32,768 rows x dh 120, bf16, causal, window 4,096), twice in turns, and
prints each build's registers and one JSON line a timing.
"""
from __future__ import annotations

import ctypes
import json
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, os.path.join(ROOT, "src"))

OUT = os.path.join(ROOT, "build", "flash_sweep")
PV = ["        wgmma_rs(o[a], pl[kk], dv);\n",
      "        wgmma_rs(o[a], pm[kk], dv);\n",
      "        wgmma_rs(o[a], ph[kk], dv);\n"]
NO_EXP = [("          s[i] = exp2_ftz(s[i] - m[r]);",
           "          s[i] = s[i] - m[r];")]
SPLIT_CALL = """\
        split_bf16x3(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1], ph[kk][x],
                     pm[kk][x], pl[kk][x]);
"""
NO_SPLIT = [(SPLIT_CALL, """\
      {
        uint32_t mid, lo;
        split_bf16x3(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1], ph[kk][x],
                     mid, lo);
        pm[kk][x] = 0u;
        pl[kk][x] = 0u;
      }
""")]
# The traced copy: SM clock stamps by each warpgroup's first thread at five
# points of the tile loop, for 16 blocks (query tiles 100-103 of heads 0-3)
# and their first 80 iterations.
TRACE_DEFS = r"""
__device__ long long g_b7_trace[16 * 2 * 80 * 5];
#define B7_T(ph)                                                          \
  do {                                                                    \
    if ((threadIdx.x & 127) == 0 && blockIdx.x >= 100 &&                  \
        blockIdx.x < 104 && blockIdx.y < 4 && blockIdx.z == 0 && t < 79)  \
      g_b7_trace[(((blockIdx.y * 4 + blockIdx.x - 100) * 2 +              \
                   (threadIdx.x >> 7)) * 80 + t + 1) * 5 + (ph)] =        \
          clock64();                                                      \
  } while (0)
"""
TRACE_READ = r"""
extern "C" int b7_trace_read(long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_b7_trace,
                                               sizeof(g_b7_trace)));
}
"""
TRACE = [
    ('#include "common.cuh"\n', '#include "common.cuh"\n' + TRACE_DEFS),
    ("    cp_async_wait<STAGES - 2>();",
     "    B7_T(0);\n    cp_async_wait<STAGES - 2>();"),
    ("    if (w_rows <= 0 || k0 >= whi", "    B7_T(1);\n    if (w_rows <= 0 || k0 >= whi"),
    ("    wgmma_wait_all();\n    fence_regs(s);\n",
     "    wgmma_wait_all();\n    fence_regs(s);\n    B7_T(2);\n"),
    ("    // O += P V, the smaller parts first.\n",
     "    B7_T(3);\n    // O += P V, the smaller parts first.\n"),
    ("    for (int a = 0; a < NA; ++a) fence_regs(o[a]);\n  }\n",
     "    for (int a = 0; a < NA; ++a) fence_regs(o[a]);\n    B7_T(4);\n  }\n"),
]
PHASES = ["wait + barrier + copies issued", "QK^T issued and waited",
          "masks, softmax, split", "P V issued and waited",
          "to the next tile's top"]


# The same exact split by truncation, in place of wgmma.cuh's
# `split_bf16x3` (rounding to nearest): bit masks and byte permutes on the
# ALU pipes, no conversions.
SPLIT_TRUNC = """\
      {
        const float p0 = s[8 * kk + 2 * x], p1 = s[8 * kk + 2 * x + 1];
        const uint32_t h0 = __float_as_uint(p0) & 0xffff0000u;
        const uint32_t h1 = __float_as_uint(p1) & 0xffff0000u;
        const float r0 = p0 - __uint_as_float(h0);
        const float r1 = p1 - __uint_as_float(h1);
        const uint32_t m0 = __float_as_uint(r0) & 0xffff0000u;
        const uint32_t m1 = __float_as_uint(r1) & 0xffff0000u;
        const uint32_t l0 = __float_as_uint(r0 - __uint_as_float(m0));
        const uint32_t l1 = __float_as_uint(r1 - __uint_as_float(m1));
        ph[kk][x] = __byte_perm(h0, h1, 0x7632);
        pm[kk][x] = __byte_perm(m0, m1, 0x7632);
        pl[kk][x] = __byte_perm(l0, l1, 0x7632);
      }
"""
RING = "constexpr int STAGES = 2;      // K/V tiles in the ring"
NO_LOADS = [("    if (t + STAGES - 1 < n_tiles) stage_tile(t + STAGES - 1);\n",
             "")]
# Warpgroup 1's QK^T after warpgroup 0's: named barrier 1 of 256 threads.
TURNS = [
    ("    if (w_rows <= 0 || k0 >= whi || k0 + BK <= wlo) continue;\n",
     "    if (wg == 1) asm volatile(\"bar.sync 1, 256;\" ::: \"memory\");\n"
     "    if (w_rows <= 0 || k0 >= whi || k0 + BK <= wlo) {\n"
     "      if (wg == 0) asm volatile(\"bar.arrive 1, 256;\" ::: \"memory\");\n"
     "      continue;\n    }\n"),
    ("    wgmma_wait_all();\n    fence_regs(s);\n",
     "    wgmma_wait_all();\n    fence_regs(s);\n"
     "    if (wg == 0) asm volatile(\"bar.arrive 1, 256;\" ::: \"memory\");\n"),
]
VARIANTS = {
    "source": [],
    "ring4": [(RING, "constexpr int STAGES = 4;")],
    "pv_hi_only": [(PV[0], ""), (PV[1], "")],
    "no_pv": [(line, "") for line in PV],
    "no_exp": NO_EXP,
    "no_split": NO_SPLIT,
    "qk_only": [(line, "") for line in PV] + NO_EXP + NO_SPLIT,
    "no_loads": NO_LOADS,
    "qk_only_no_loads": [(line, "") for line in PV] + NO_EXP + NO_SPLIT
                        + NO_LOADS,
    "no_proxy_fence": [("    fence_proxy_async();\n    __syncthreads();",
                        "    __syncthreads();")],
    "turns": TURNS,
    "trace": TRACE,
    "split_trunc": [(SPLIT_CALL, SPLIT_TRUNC)],
}


def build():
    """Write and compile every copy; returns {name: C entry point}."""
    from repro_torch.kernels import _build
    csrc = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
    with open(os.path.join(csrc, "flash_attention.cu")) as fh:
        source = fh.read()
    os.makedirs(OUT, exist_ok=True)
    procs = []
    for name, subs in VARIANTS.items():
        text = source
        for old, new in subs:
            assert old in text, f"{name}: {old!r} not in the source"
            text = text.replace(old, new)
        if name == "trace":
            text += TRACE_READ
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as fh:
            fh.write(text)
        so = os.path.join(OUT, f"{name}.so")
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", so, cu]
        procs.append((name, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    fns = {}
    for name, so, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        regs, tc = [], False
        for line in out.splitlines():
            if "Compiling entry function" in line:
                tc = "flash_attention_tc_kernel" in line
            elif tc and "registers" in line:
                regs.append(line.split(":", 1)[1].strip())
        print(json.dumps({"variant": name, "ptxas_tc": regs}))
        fn = ctypes.CDLL(so).flash_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
        if name == "trace":
            fn.trace_read = ctypes.CDLL(so).b7_trace_read
    return fns


def show_trace(fn, call):
    """Run the traced copy once and print the median SM cycles of each
    phase of a tile, over the traced warpgroups' tiles that ran them all."""
    import numpy as np
    call()
    import torch
    torch.cuda.synchronize()
    host = np.zeros(16 * 2 * 80 * 5, dtype=np.int64)
    err = fn.trace_read(host.ctypes.data_as(ctypes.c_void_p))
    assert err == 0, err
    stamps = host.reshape(32, 80, 5)
    deltas = {name: [] for name in PHASES}
    for w in range(32):
        for t in range(79):
            a, nxt = stamps[w, t], stamps[w, t + 1]
            if (a > 0).all() and nxt[0] > 0:
                for i, name in enumerate(PHASES):
                    end = a[i + 1] if i < 4 else nxt[0]
                    deltas[name].append(int(end - a[i]))
    print(json.dumps({"trace_tiles": len(deltas[PHASES[0]]),
                      "median_cycles": {k: float(np.median(v))
                                        for k, v in deltas.items() if v}}))


def main() -> int:
    import torch

    from repro_torch.kernels import ref
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    fns = build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, hq, hkv, s, dh, window = 1, 32, 8, 32_768, 120, 4096
    q, k, v = (torch.randn((b, h, s, dh), generator=gen, device=dev,
                           dtype=torch.bfloat16) for h in (hq, hkv, hkv))
    out = torch.empty_like(q)
    plain = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    m, e = torch.frexp(plain.float())
    limit = torch.where(m == 0, torch.zeros_like(m),
                        torch.ldexp(torch.ones_like(m), e - 8)) + 1e-5

    def cuda_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    for turn in range(2):
        for name, fn in fns.items():
            if name == "trace":
                continue
            def call():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), None, b, hq, hkv, s, s, dh, 1, window, 1,
                         1.0 / math.sqrt(dh),
                         torch.cuda.current_stream().cuda_stream)
                assert err == 0, err
            row = {"turn": turn, "variant": name, "ms": cuda_ms(call)}
            if name in ("source", "ring4", "split_trunc", "turns"):
                worst = float(((out.float() - plain.float()).abs()
                               / limit).max())
                assert worst <= 1.0, worst
                row["share_of_bf16_ulp_limit"] = worst
            print(json.dumps(row))
    fn = fns["trace"]
    show_trace(fn, lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              out.data_ptr(), None, b, hq, hkv, s, s, dh, 1,
                              window,
                              1, 1.0 / math.sqrt(dh),
                              torch.cuda.current_stream().cuda_stream))
    return 0


if __name__ == "__main__":
    sys.exit(main())
