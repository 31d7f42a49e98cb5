#!/usr/bin/env python3
"""Time B3 and B5 (``predict.cu``) on one CUDA card at other tiles, with
leaf-slab staging on and off, beside the first version of the kernel.

    python3 tools/traverse_sweep.py

Builds into ``build/traverse_sweep/`` (one nvcc a library, all at once):

- ``first``: ``tools/predict_first.cu``, a verbatim copy of the first
  ``predict.cu`` (one block of 16 rows x 512 columns walking the trees one
  after another, the F tile in shared memory);
- ``repo``: the repo's ``predict.cu`` as it is, which picks one of its
  tiles for each call (the pick is printed);
- ``R x C / G vV bB``: the repo's ``predict.cu`` built with one tile of R
  rows x C columns, tree groups of G, V columns a vector and registers
  capped so that B blocks fit an SM (its ``PREDICT_TILES`` defined in a
  file that includes the source);
- ``... slab``: the same with each listed tree's leaves at the tile's
  columns staged in shared memory before its adds (N x C x s bytes), for
  tiles whose rows outnumber a tree's leaves;
- ``... no_walk`` and ``... no_leaf``: the picked tiles with the walk
  replaced by a leaf index made from the row and tree, or with the leaf
  loads replaced by zeros.  Neither is the function (not held to the plain
  version): they show what the walk and the leaf loads cost.

Prints each build's registers and spills, then at each of ``chip_smoke.py``'s
`TRAVERSE_SHAPES` ((a) 262,144 rows x 8 trees, (b) the 256-row serving
window x 100 trees, (c) a 4,096-row chunk x 100 trees, (d) 131,072 rows x 1
tree; D = W = 512, depth 6) times B3, B5 int8 and B5 bf16 in every build,
in turns: the first version, the repo's build, every other variant, then
the repo's build and the first version again.  Every output
but the two diagnostics' is held bitwise to the plain version on the card.
One JSON line a (shape, kernel, variant), in ms.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "build", "traverse_sweep")
# (rows, columns, tree group, columns a vector, blocks an SM).
TILES = [(8, 64, 32, 2, 1), (8, 64, 32, 1, 1), (8, 64, 16, 2, 1),
         (8, 64, 64, 2, 1), (4, 64, 64, 1, 1), (8, 32, 32, 1, 1),
         (16, 64, 16, 4, 1), (8, 128, 32, 4, 1),
         (16, 128, 16, 4, 4), (16, 128, 16, 1, 4), (16, 128, 16, 4, 1),
         (16, 128, 16, 4, 6), (32, 128, 8, 4, 4), (32, 128, 8, 1, 4),
         (32, 64, 8, 4, 4), (16, 256, 16, 4, 4), (32, 256, 8, 4, 2),
         (64, 128, 4, 4, 2), (8, 512, 32, 4, 4), (16, 512, 16, 4, 2),
         (64, 64, 4, 4, 4), (128, 64, 2, 1, 1), (8, 64, 32, 2, 4),
         (16, 128, 16, 4, 8), (16, 128, 32, 4, 6), (16, 128, 8, 4, 6),
         (16, 256, 16, 4, 6), (8, 256, 32, 4, 6), (8, 512, 32, 4, 6),
         (8, 512, 32, 4, 8), (32, 128, 8, 4, 6)]
SLAB_TILES = [(128, 64, 2, 1, 1)]
DIAGNOSED = [(8, 64, 32, 2, 1), (16, 128, 16, 4, 4)]

ADD_HEAD = "  auto add = [&](int g, int count, int buf) {"
ADD_TAIL = "\n  for (int base = 0; base < a.T; base += kThreads) {"
# The slab variant's add: the tree's leaves at the tile's columns go to
# shared memory after the staged codes, then each thread adds from there.
SLAB_ADD = r"""  auto add = [&](int g, int count, int buf) {
    const int size = min(kGroup, count - g);
    const int32_t* pos = s_pos + buf * kGroup * kRows;
    LeafT* slab = reinterpret_cast<LeafT*>(s_codes + codes_bytes(kRows, M));
    for (int j = 0; j < size; ++j) {
      const long long tn = s_tree[g + j] * N;
      const int col = s_col[g + j];
      const int lo = max(col, c0), w = min(col + W, c0 + cols) - lo;
      __syncthreads();
      for (int i = tid; i < a.N * w; i += kThreads) {
        const int node = i / w, jc = i % w;
        slab[node * kCols + (lo - c0) + jc] =
            leaf[(tn + node) * W + (lo - col) + jc];
      }
      __syncthreads();
      float scale = 1.0f;
      if constexpr (kScaled) scale = s_scale[g + j];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int q = tid + k * kThreads, r = q / kRowVecs;
        const int c = q % kRowVecs * kVec;
#pragma unroll
        for (int v = 0; v < kVec; ++v)
          if (r < rows && c0 + c + v >= lo && c0 + c + v < lo + w)
            add_one(acc[k][v], slab[pos[j * kRows + r] * kCols + c + v],
                    scale);
      }
    }
  };
"""
SMEM = "((a.flags & kStageCodes) ? codes_bytes(kRows, a.M) : 0)"
SLAB_SMEM = "codes_bytes(kRows, a.M) + sizeof(LeafT) * kCols * a.N"
NO_WALK = [("      for (int s = 0; s < a.depth; ++s) {",
            "      pos = 63 + ((r * 7 + j * 13) & 63);\n"
            "      for (int s = 0; s < 0; ++s) {")]
NO_LEAF = [("            load_leaves<kVec>(lp + j_col, x);",
            "            for (int v = 0; v < kVec; ++v) x[v] = LeafT{};")]


def slab_source(text: str) -> str:
    """``predict.cu`` with the slab variant's add and shared bytes."""
    i, j = text.index(ADD_HEAD), text.index(ADD_TAIL)
    assert SMEM in text, "the shared bytes line moved"
    return (text[:i] + SLAB_ADD + text[j:]).replace(SMEM, SLAB_SMEM)


def patched(text: str, subs) -> str:
    for old, new in subs:
        assert old in text, old
        text = text.replace(old, new)
    return text


def tiles_define(tiles) -> str:
    """The ``PREDICT_TILES`` line of a variant (nvcc would cut a ``-D``
    value at its commas)."""
    return "#define PREDICT_TILES " + " ".join(
        f"TILE({r}, {c}, {g}, {v}, {b})" for r, c, g, v, b in tiles) + "\n"


def name_of(tile, extra="") -> str:
    r, c, g, v, b = tile
    return f"{r}x{c}/{g} v{v} b{b}" + (f" {extra}" if extra else "")


def variants(source: str) -> dict:
    """{name: (source text, held to the plain version)}."""
    with open(os.path.join(HERE, "predict_first.cu")) as fh:
        out = {"first": (fh.read(), True), "repo": (source, True)}
    for t in TILES:
        out[name_of(t)] = (tiles_define([t]) + '#include "predict.cu"\n', True)
    for t in SLAB_TILES:
        out[name_of(t, "slab")] = (tiles_define([t]) + slab_source(source),
                                   True)
    for t in DIAGNOSED:
        for extra, subs in (("no_walk", NO_WALK), ("no_leaf", NO_LEAF)):
            out[name_of(t, extra)] = (tiles_define([t])
                                      + patched(source, subs), False)
    return out


def build(found: dict) -> dict:
    """Compile every variant, one nvcc each, all started together; returns
    {name: library path}."""
    from repro_torch.kernels import _build
    csrc = str(_build.CSRC)
    os.makedirs(OUT, exist_ok=True)
    flags = [*_build.NVCC_FLAGS, "-fmad=false", "-I", csrc]
    procs = []
    for i, (name, (text, _)) in enumerate(found.items()):
        cu = os.path.join(OUT, f"v{i}.cu")
        with open(cu, "w") as fh:
            fh.write(text)
        so = cu[:-3] + ".so"
        procs.append((name, so, subprocess.Popen(
            [_build.nvcc(), *flags, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}:\n{out}")
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                print(f"{name}: {line.strip()}")
        libs[name] = so
    return libs


SYMBOLS = {"float32": "forest_traverse_launch",
           "int8": "forest_traverse_quant_int8_launch",
           "bfloat16": "forest_traverse_quant_bf16_launch"}


def bind(libs: dict) -> tuple:
    """{(variant, kind): C function}, and the repo build's
    ``forest_traverse_info``."""
    V, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    calls = {}
    for name, so in libs.items():
        lib = ctypes.CDLL(so)
        for kind, sym in SYMBOLS.items():
            fn = getattr(lib, sym)
            ptrs = 8 if kind == "float32" else 9
            fn.argtypes = [V] * ptrs + [Fl] + [I] * 7 + [V]
            fn.restype = I
            calls[(name, kind)] = fn
    info = ctypes.CDLL(libs["repo"]).forest_traverse_info
    info.argtypes = [I] * 4 + [V]
    info.restype = I
    return calls, info


def main() -> int:
    import torch

    import chip_smoke as CS
    from repro_torch.core import quantize as Q
    from repro_torch.kernels import _build
    from repro_torch.kernels import ref
    if not torch.cuda.is_available():
        print("traverse_sweep: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    with open(os.path.join(_build.CSRC, "predict.cu")) as fh:
        source = fh.read()
    found = variants(source)
    calls, repo_info = bind(build(found))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    lr = 0.05
    for key, (n, T) in CS.TRAVERSE_SHAPES.items():
        codes, pf, F0 = CS.traverse_case(torch, gen, dev, n, T)
        M = codes.shape[1]
        for kind_id, kind in enumerate(SYMBOLS):
            info = (ctypes.c_int * 9)()
            assert repo_info(kind_id, n, 512, M, info) == 0
            picked = "x".join(map(str, info[4:6])) + f"/{info[6]} v{info[7]}"
            if kind == "float32":
                trees = (pf.feat, pf.thr, pf.left, pf.right, pf.leaf)
                want = ref.forest_apply_ref(F0.clone(), codes, *trees,
                                            pf.out_col, lr, depth=pf.depth)
                ptrs = [t.data_ptr() for t in (codes, *trees, pf.out_col)]
            else:
                qf = Q.quantize_forest(pf, kind)
                trees = (qf.feat, qf.thr, qf.left, qf.right, qf.leaf)
                scale = qf.leaf_scale.reshape(-1).contiguous()
                want = ref.forest_apply_quant_ref(
                    F0.clone(), codes, *trees, scale, pf.out_col, lr,
                    depth=pf.depth)
                ptrs = [t.data_ptr() for t in (codes, *trees, scale,
                                               pf.out_col)]
            N, W = pf.leaf.shape[1:]
            others = [v for (v, k) in calls if k == kind
                      and v not in ("first", "repo")]
            order = ["first", "repo", *others, "repo", "first"]
            for variant in order:
                fn = calls[(variant, kind)]
                ints = [n, 512, M, T, N, W, pf.depth]

                def launch(F):
                    err = fn(F.data_ptr(), *ptrs, lr, *ints, stream)
                    assert err == 0, (variant, kind, err)
                    return F
                out = launch(F0.clone())
                torch.cuda.synchronize()
                if found[variant][1]:
                    assert torch.equal(out, want), (key, kind, variant)
                F = F0.clone()
                ms = CS.cuda_ms(lambda: launch(F), CS.traverse_reps(n, T))
                print(json.dumps(dict(shape=key, rows=n, trees=T, kernel=kind,
                                      variant=variant, repo_tile=picked,
                                      ms=ms, card=smi)), flush=True)
                del out, F
            del want
        del codes, pf, F0
    return 0


if __name__ == "__main__":
    sys.exit(main())
