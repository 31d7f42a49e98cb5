#!/usr/bin/env python3
"""Time B8 (``decode_attention.cu``) on one CUDA card in other shapes of
its ring, and what bounds it.

    python3 tools/decode_ring_sweep.py

Builds copies of ``src/repro_torch/kernels/csrc/decode_attention.cu`` into
``build/decode_sweep/`` (one nvcc a copy, all at once), each with one thing
changed:

- ``source``: as it is;
- ``stages2``, ``stages4``: a ring of 2 or 4 tiles (the source keeps 3);
- ``keys8``: 8 keys a stream a tile (64 a tile; the source takes 4), with
  3 and with 2 stages;
- ``load_only`` and ``keys8_load_only``: the ring's copies and barriers
  alone, no scores, softmax or P V (its output is not the function).

Prints each build's registers, then times each copy at decode_32k's layer
(q 128 x 32 x 120 against a full 4,096-slot ring, 128 x 4,096 x 8 x 120,
bf16, window 4,096) with 1, 2, 3, 4 and 8 key splits, twice in turns, each
working copy held within one bf16 ulp plus 1e-5 of the plain version.
Beside them: one read of the same 2.01 GB by a PyTorch reduction
(``sum`` of k and of v), and one SDPA call on views of the cache.  One
JSON line a timing.
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

OUT = os.path.join(ROOT, "build", "decode_sweep")
LOOP = ("    if (t + STAGES - 1 < n_tiles) stage_tile(t + STAGES - 1);\n"
        "    cp_async_commit();\n")
KEYS8 = [("nch == 1 ? 4 : 2", "nch == 1 ? 8 : 4"),
         ("constexpr int UNROLL = NCH == 1 ? 4 : 2;",
          "constexpr int UNROLL = NCH == 1 ? 8 : 4;")]
LOAD_ONLY = [(LOOP, LOOP + "    if (dh > 0) continue;\n")]
STAGES = "constexpr int STAGES = 3;"
VARIANTS = {
    "source": [],
    "stages2": [(STAGES, "constexpr int STAGES = 2;")],
    "stages4": [(STAGES, "constexpr int STAGES = 4;")],
    "keys8": KEYS8,
    "keys8_stages2": KEYS8 + [(STAGES, "constexpr int STAGES = 2;")],
    "load_only": LOAD_ONLY,
    "keys8_load_only": KEYS8 + LOAD_ONLY,
}


def build():
    """Write and compile every copy; returns {name: C entry point}."""
    from repro_torch.kernels import _build
    csrc = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
    with open(os.path.join(csrc, "decode_attention.cu")) as fh:
        source = fh.read()
    os.makedirs(OUT, exist_ok=True)
    procs = []
    for name, subs in VARIANTS.items():
        text = source
        for old, new in subs:
            assert old in text, f"{name}: {old!r} not in the source"
            text = text.replace(old, new)
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
        regs = [line.split(":", 1)[1].strip() for line in out.splitlines()
                if "registers" in line]
        print(json.dumps({"variant": name, "ptxas": regs}))
        fn = ctypes.CDLL(so).decode_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_void_p, ctypes.c_int]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    import torch
    import torch.nn.functional as F

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
    b, hq, hkv, s, dh = 128, 32, 8, 4096, 120
    q = torch.randn((b, hq, dh), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    k, v = (torch.randn((b, s, hkv, dh), generator=gen, device=dev,
                        dtype=torch.bfloat16) for _ in "kv")
    full = torch.full((b,), s, dtype=torch.int32, device=dev)
    plain = ref.decode_attention_ref(q, k, v, full, window=s)
    m, e = torch.frexp(plain.float())
    limit = torch.where(m == 0, torch.zeros_like(m),
                        torch.ldexp(torch.ones_like(m), e - 8)) + 1e-5
    part = torch.empty(b * hq * 8 * (dh + 2), dtype=torch.float32,
                       device=dev)
    out = torch.empty_like(q)

    def cuda_ms(fn, reps=20):
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
            for splits in (1, 2, 3, 4, 8):
                def call():
                    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                             s, out.data_ptr(), part.data_ptr(), b, hq, hkv,
                             s, dh, s, splits, 1, 1, 1.0 / math.sqrt(dh),
                             torch.cuda.current_stream().cuda_stream)
                    assert err == 0, err
                ms = cuda_ms(call)
                row = {"turn": turn, "variant": name, "splits": splits,
                       "ms": ms}
                if "load_only" not in name:
                    worst = float(((out.float() - plain.float()).abs()
                                   / limit).max())
                    assert worst <= 1.0, (name, splits, worst)
                    row["share_of_bf16_ulp_limit"] = worst
                print(json.dumps(row))
    read = cuda_ms(lambda: (k.sum(dtype=torch.float32),
                            v.sum(dtype=torch.float32)))
    kpos = torch.arange(s, device=dev)[None, :]
    mask = (kpos < full[:, None])[:, None, None, :]
    sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
        attn_mask=mask, enable_gqa=True))
    print(json.dumps({"torch_sum_of_k_and_v_ms": read, "sdpa_ms": sdpa,
                      "cache_bytes": 2 * k.numel() * 2}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
