#!/usr/bin/env python3
"""Time B1 and B4 on one CUDA card at other tile lengths.

    python3 tools/hist_tile_sweep.py [R ...]      (default 8192 16384 32768)
    python3 tools/hist_tile_sweep.py --trace      (the built-in R, traced)
    python3 tools/hist_tile_sweep.py --ova        (one-vs-all level 5, traced)

For each R (``kTileRows``) it builds ``hist.cu`` and ``hist_direct.cu``
with that constant of ``hist_common.cuh`` changed into
``build/hist_sweep/`` (one nvcc a source, all at once), prints each
build's registers and spills, then times, at
the shapes of ``chip_smoke.py``'s phase 3: B1 at level 1 (943k of 2,097,152
rows, m=100, B=256, C=6), B1 over the same rows at SketchBoost Full's width
(C=513), and B4 at level 5 (32 nodes, every row, C=6).  B4 is held bitwise
to ``ref.histogram_ref`` at the same R, and B1 at C=6 bitwise to
``ref.hist_nodes_ref`` run on the CPU at the same R.  Prints one JSON line a
variant.

With ``--trace`` it builds one variant at the source's own R with a
``%globaltimer`` stamp taken by each block where its tile body starts and
ends, where its turn in the fold's first slice comes and where its fold
ends, runs B1 at level 1 and B4 at level 5 once each, and prints where the
blocks' time went: the body, the wait for the turn, the fold, and the
launch's span.  B1's blocks also stamp where they start, so the time from
there to the body (the ticket and the tile -> node lookup, `find_tile`) is
reported as ``lookup_us``.

With ``--ova`` it times B1 at ``chip_smoke.py``'s one-vs-all level 5 of
one group (128 trees x 32 nodes over 2,097,152 rows each, C=2, the
subtract engine's build counts: 4,096 node counts for `find_tile` to
scan), as built and traced, and prints the traced split.
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


# Stamps of the traced build: slot i of the block's five (B4's blocks
# leave slot 4 empty).
STAMPS = 5
TRACE = r"""
__device__ long long g_trace[5 << 20];
__device__ __forceinline__ long long trace_now() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define HIST_T(i)                                                  \
  do {                                                             \
    if (threadIdx.x == 0 && blockIdx.x < (1u << 20))               \
      g_trace[blockIdx.x * 5ll + (i)] = trace_now();               \
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
            if trace and name == "hist.cu":
                a = "  const int ticket = take_ticket(scratch);\n"
                assert a in s
                s = s.replace(a, "  HIST_T(4);\n" + a, 1)
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
    trace = sys.argv[1:] in (["--trace"], ["--ova"])
    variants = ([ref.TILE_ROWS] if trace else
                [int(a) for a in sys.argv[1:]] or [8192, 16384, 32768])
    libs = build(variants, trace)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    if sys.argv[1:] == ["--ova"]:
        return ova(torch, CS, dev, gen, libs[(ref.TILE_ROWS, "hist")])
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
        # On the CPU the plain version adds in B1's order (index_add_ in
        # row order), so B1 is held to it bit for bit.
        plain = ref.hist_nodes_ref(
            *[t.cpu() for t in (codes4, st.order, case["stats_p"], st.counts,
                                case["build_counts"])], n_bins=B, row_tile=r)
        assert torch.equal(out.cpu(), plain), "B1 differs from plain"
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


def ova(torch, CS, dev, gen, traced_lib):
    """B1 at the one-vs-all level 5 of one group, as built (the repo's
    kernel through its wrapper) and traced."""
    from repro_torch.kernels import _build, hist_kernel
    _build.build([hist_kernel.KERNEL])
    codes_t, st, stats_p, counts, build_counts = CS.ova_level_case(
        torch, gen, dev)
    args = (codes_t, st.order, stats_p, counts, build_counts)
    lib = ctypes.CDLL(traced_lib)
    V, I = ctypes.c_void_p, ctypes.c_int
    lib.hist_nodes_launch.argtypes = [V] * 7 + [I] * 7 + [V]
    nn, (m, n), B = counts.shape[0], codes_t.shape, 256

    def traced():
        out = torch.empty((nn, m, B, 2), device=dev)
        scr = torch.empty(lib.hist_nodes_scratch_ints(nn, m, 2),
                          dtype=torch.int32, device=dev)
        err = lib.hist_nodes_launch(
            codes_t.data_ptr(), st.order.data_ptr(), stats_p.data_ptr(),
            counts.data_ptr(), build_counts.data_ptr(), out.data_ptr(),
            scr.data_ptr(), scr.numel(), n, st.order.shape[0], m, nn, B, 2,
            torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return out
    assert torch.equal(traced(), hist_kernel.hist_nodes(*args, n_bins=B))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps(dict(
        card=smi, shape="one_vs_all level 5", nodes=nn,
        built_entries=int(build_counts.sum()),
        b1_ms=CS.cuda_ms(lambda: hist_kernel.hist_nodes(*args, n_bins=B)),
        traced_ms=CS.cuda_ms(traced),
        **trace_summary(torch, lib, traced))))
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
    n = STAMPS << 20
    host = (ctypes.c_longlong * n)()
    assert lib.hist_trace_read(host, n) == 0
    rows = [host[i:i + STAMPS] for i in range(0, n, STAMPS)]
    rows = [r for r in rows if r[0] and r[3]]
    lookup = [r[0] - r[4] for r in rows if r[4]]
    t0 = min(r[0] for r in rows)
    span = (max(r[3] for r in rows) - t0) / 1e3

    def stat(xs):
        xs = [x / 1e3 for x in xs]
        return dict(median=statistics.median(xs), max=max(xs),
                    total=sum(xs))
    extra = {"lookup_us": stat(lookup)} if lookup else {}
    return dict(blocks=len(rows), span_us=span, **extra,
                body_us=stat([r[1] - r[0] for r in rows]),
                wait_us=stat([r[2] - r[1] for r in rows]),
                fold_us=stat([r[3] - r[2] for r in rows]),
                last_body_start_us=(max(r[0] for r in rows) - t0) / 1e3)


if __name__ == "__main__":
    sys.exit(main())
