#!/usr/bin/env python3
"""Time B1 and B4 on one CUDA card at other tile lengths.

    python3 tools/hist_tile_sweep.py [R ...]      (default 8192 16384 32768)
    python3 tools/hist_tile_sweep.py --trace      (the built-in R, traced)

For each R (``kTileRows``) it builds ``hist.cu`` and ``hist_direct.cu``
with that constant of ``hist_common.cuh`` changed into
``build/hist_sweep/`` (one nvcc a source, all at once), prints each
build's registers and spills, then times, at
the shapes of ``chip_smoke.py``'s phase 3: B1 at level 1 (943k of 2,097,152
rows, m=100, B=256, C=6), B1 over the same rows at SketchBoost Full's width
(C=513), and B4 at level 5 (32 nodes, every row, C=6).  B4 is held bitwise
to ``ref.histogram_ref`` at the same R, and B1 at C=6 within rtol 1e-5 of
``ref.hist_nodes_ref`` at the same R.  Prints one JSON line a variant.

With ``--trace`` it builds one variant at the source's own R with a
``%globaltimer`` stamp taken by each block where its tile body starts and
ends, where its turn in the fold's first slice comes and where its fold
ends, runs B1 at level 1 and B4 at level 5 once each, and prints where the
blocks' time went: the body, the wait for the turn, the fold, and the
launch's span.
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
sys.path.insert(0, ROOT)


# Stamps of the traced build: slot i of the block's four.
TRACE = r"""
__device__ long long g_trace[1 << 22];
__device__ __forceinline__ long long trace_now() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define HIST_T(i)                                                  \
  do {                                                             \
    if (threadIdx.x == 0 && blockIdx.x < (1u << 20))               \
      g_trace[blockIdx.x * 4ll + (i)] = trace_now();               \
  } while (0)
extern "C" int hist_trace_read(long long* host, long long n) {
  return cudaMemcpyFromSymbol(host, g_trace, n * sizeof(long long));
}
extern "C" int hist_trace_clear() {
  void* p = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&p, g_trace);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(g_trace));
  return e;
}
"""


def traced(s):
    """hist_common.cuh with the four stamps in the body and the fold."""
    subs = [("namespace hist {\n", "namespace hist {\n" + TRACE),
            ("  zero_hist(s, n_bins);\n  for (int off = 0;",
             "  HIST_T(0);\n  zero_hist(s, n_bins);\n  for (int off = 0;"),
            ("                            int* flags, int k, int slice_bins) {\n",
             "                            int* flags, int k, int slice_bins) {\n"
             "  HIST_T(1);\n"),
            ("    wait_turn(flags + j, k);\n",
             "    wait_turn(flags + j, k);\n    if (j == 0) HIST_T(2);\n"),
            ("    if (t == 0) store_release(flags + j, k + 1);\n  }\n}",
             "    if (t == 0) store_release(flags + j, k + 1);\n  }\n"
             "  HIST_T(3);\n}")]
    for a, b in subs:
        assert a in s, a
        s = s.replace(a, b, 1)
    return s


def build(variants, trace=False):
    """One library per (R, source), all nvcc runs started together."""
    from repro_torch.kernels import _build
    procs, libs = [], {}
    for r in variants:
        d = os.path.join(ROOT, "build", "hist_sweep",
                         f"{r}{'_trace' if trace else ''}")
        os.makedirs(d, exist_ok=True)
        for name in ("common.cuh", "hist_common.cuh", "hist.cu",
                     "hist_direct.cu"):
            s = open(os.path.join(_build.CSRC, name)).read()
            s = re.sub(r"constexpr int kTileRows = \d+;",
                       f"constexpr int kTileRows = {r};", s)
            if trace and name == "hist_common.cuh":
                s = traced(s)
            open(os.path.join(d, name), "w").write(s)
        for src in ("hist", "hist_direct"):
            lib = os.path.join(d, f"{src}.so")
            libs[(r, src)] = lib
            procs.append((r, src, subprocess.Popen(
                [_build.nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                 os.path.join(d, f"{src}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    for r, src, pr in procs:
        out, _ = pr.communicate()
        if pr.returncode:
            raise RuntimeError(out)
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                print(f"R={r} {src}: {line.strip()}")
    return libs


def main() -> int:
    import torch
    import chip_smoke as CS
    from repro_torch.kernels import ref
    if not torch.cuda.is_available():
        print("hist_tile_sweep: no CUDA device", file=sys.stderr)
        return 2
    trace = sys.argv[1:] == ["--trace"]
    variants = ([ref.TILE_ROWS] if trace else
                [int(a) for a in sys.argv[1:]] or [8192, 16384, 32768])
    libs = build(variants, trace)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    case = CS.hist_case(torch, gen, dev)
    m, B, C = case["m"], case["B"], case["C"]
    st = case["state"]
    wide = torch.rand((st.order.shape[0], 513), generator=gen, device=dev)
    n = CS.N_TRAIN
    codes4 = case["codes_t"]
    node_pos = torch.randint(0, 32, (n,), generator=gen, device=dev,
                             dtype=torch.int32)
    stats4 = torch.randn((n, C), generator=gen, device=dev)
    stats4[:, -1] = 1.0
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    V, I = ctypes.c_void_p, ctypes.c_int
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    for r in variants:
        b1 = ctypes.CDLL(libs[(r, "hist")])
        b4 = ctypes.CDLL(libs[(r, "hist_direct")])
        b1.hist_nodes_launch.argtypes = [V] * 7 + [I] * 7 + [V]
        b4.hist_direct_launch.argtypes = ([V] * 5 + [ctypes.c_longlong] * 2
                                          + [I] * 4 + [V])

        def nodes(stats_p, c):
            nn = st.counts.shape[0]
            out = torch.empty((nn, m, B, c), device=dev)
            scr = torch.empty(b1.hist_nodes_scratch_ints(nn, m, c),
                              dtype=torch.int32, device=dev)
            err = b1.hist_nodes_launch(
                codes4.data_ptr(), st.order.data_ptr(), stats_p.data_ptr(),
                st.counts.data_ptr(), case["build_counts"].data_ptr(),
                out.data_ptr(), scr.data_ptr(), scr.numel(), n,
                st.order.shape[0], m, nn, B, c, stream())
            assert err == 0, err
            return out

        def direct():
            out = torch.empty((32, m, B, C), device=dev)
            scr = torch.empty(b4.hist_direct_scratch_ints(n, m, 32, C),
                              dtype=torch.int32, device=dev)
            err = b4.hist_direct_launch(
                codes4.data_ptr(), node_pos.data_ptr(), stats4.data_ptr(),
                out.data_ptr(), scr.data_ptr(), scr.numel(), n, m, 32, B, C,
                stream())
            assert err == 0, err
            return out

        out = nodes(case["stats_p"], C)
        plain = ref.hist_nodes_ref(codes4, st.order, case["stats_p"],
                                   st.counts, case["build_counts"], n_bins=B,
                                   row_tile=r)
        torch.testing.assert_close(out, plain, rtol=1e-5, atol=0)
        d = direct()
        plain = ref.histogram_ref(codes4, node_pos, stats4, n_nodes=32,
                                  n_bins=B, chunk_rows=r)
        assert torch.equal(d, plain), "B4 differs from plain"
        assert torch.equal(d, direct()), "B4 not deterministic"
        del plain, d
        if trace:
            for name, lib, fn in (("B1 level 1", b1, lambda: nodes(
                    case["stats_p"], C)), ("B4 level 5", b4, direct)):
                print(json.dumps(dict(R=r, card=smi, kernel=name,
                                      **trace_summary(torch, lib, fn))))
            continue
        rec = dict(R=r, card=smi,
                   b1_ms=CS.cuda_ms(lambda: nodes(case["stats_p"], C)),
                   b1_full_ms=CS.cuda_ms(lambda: nodes(wide, 513), 3),
                   b4_ms=CS.cuda_ms(direct))
        print(json.dumps(rec), flush=True)
    return 0


def trace_summary(torch, lib, fn):
    """Run ``fn`` once with the stamps cleared, then sum up the blocks that
    stamped: microseconds in the body, waiting for the turn and folding
    (median and max), and the launch's span from the first stamp to the
    last."""
    import statistics
    lib.hist_trace_read.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    fn()
    torch.cuda.synchronize()
    assert lib.hist_trace_clear() == 0
    fn()
    torch.cuda.synchronize()
    n = 4 << 20
    host = (ctypes.c_longlong * n)()
    assert lib.hist_trace_read(host, n) == 0
    rows = [host[i:i + 4] for i in range(0, n, 4)]
    rows = [r for r in rows if r[0] and r[3]]
    t0 = min(r[0] for r in rows)
    span = (max(r[3] for r in rows) - t0) / 1e3

    def stat(xs):
        xs = [x / 1e3 for x in xs]
        return dict(median=statistics.median(xs), max=max(xs),
                    total=sum(xs))
    return dict(blocks=len(rows), span_us=span,
                body_us=stat([r[1] - r[0] for r in rows]),
                wait_us=stat([r[2] - r[1] for r in rows]),
                fold_us=stat([r[3] - r[2] for r in rows]),
                last_body_start_us=(max(r[0] for r in rows) - t0) / 1e3)


if __name__ == "__main__":
    sys.exit(main())
