#!/usr/bin/env python3
"""Time B6 (``shap.cu``) at other scatter configurations and B2 (``split.cu``)
on one CUDA card, beside the first version of each.

    python3 tools/shap_split_sweep.py [--quick]

Builds into ``build/shap_sweep/`` (one nvcc a library, all started
together):

- ``first``: ``tools/shap_first.cu`` and ``tools/split_first.cu``, verbatim
  copies of the first versions (B6: one row a block, res in a second
  shared tile; B2: one block a node, a thread a feature);
- ``repo``: the repo's ``shap.cu`` and ``split.cu`` as they are; B6 picks
  its configuration per call (printed);
- ``fw.. ...``: ``shap.cu`` with the scatter's configuration fixed
  (``SHAP_FORCE_CONFIG``: warps across the features, tables staged or read
  in place, and trees a staging buffer), defined in a file that includes
  the source;
- ``unroll N``: the repo's ``shap.cu`` with its entry loop unrolled N
  times, not 4;
- ``diag psi only`` and ``diag no sums``: the repo's ``shap.cu`` with the
  scatter not launched, or launched without its sums (staging and barriers
  only).  Neither is the function: they show what the parts cost;
- ``split batched``: the repo's ``split.cu`` with each channel's left
  sums loaded 8 bins at a time ahead of the chain, not one bin at a time.

Then, at each of ``chip_smoke.py``'s `SHAP_SHAPES` ((a) 4,096 rows x 8
trees, (b) the 256-row endpoint window x 100 trees, (c) the 4,096 rows of
``shap_values`` x 100 trees; depth 6, 100 features, d = 512), times every
B6 build in turns: first, repo, each variant, repo, first.  Every output
but the diagnostics' is held bitwise to the repo build's (which
``chip_smoke.py`` holds to the plain version).  B2 is timed at
`SPLIT_NODES` (1, 2 and 32 nodes x 100 x 256 x 6), at C = 17 and 32 (the
narrow entry point's widest) and
at the one-vs-all level 5 of one group (4,096 nodes x 100 x 256 x 2),
first, repo and batched in turns, indices held to the plain
version's.  One JSON
line a (kernel, shape, variant), in ms, with the card's name and power
limit first.  ``--quick`` times (b) and (c) only.
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

OUT = os.path.join(ROOT, "build", "shap_sweep")
# (feature warps, tables staged, trees a staging buffer); each warp holds
# 8 features.
CONFIGS = [(16, 1, 2), (16, 1, 1), (8, 1, 4), (16, 0, 1)]
# The repo's build with the entry loop unrolled otherwise (held bitwise).
UNROLLS = (2, 8)
# Diagnostics of the repo's build (not the function, so not held to it):
# the plan and Psi kernels alone, and the scatter without its sums (staging
# and barriers only).
DIAGNOSED = {
    "psi only": [("    e = c.staged ? run_scatter<true>(sc, smem, st)\n"
                  "                 : run_scatter<false>(sc, smem, st);",
                  "    e = 0;\n    (void)sc;")],
    "no sums": [("      for (int m = 0; m < MF; ++m) {\n        const int2 se",
                 "      for (int m = 0; m < 0; ++m) {\n        const int2 se")]}
# B2's narrow left sums as the repo loads them (one bin at a time in the
# chain) and 8 bins at a time ahead of it.
BATCHED = """      for (int j0 = 0; j0 < nb; j0 += 8) {
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = j0 + j < nb ? e[(j0 + j) * C] : 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j0 + j < nb) {
            acc += static_cast<double>(v[j]);
            e[(j0 + j) * C] = static_cast<float>(acc);
          }
        }
      }"""
ONE_BIN = """      for (int j = 0; j < nb; ++j) {
        acc += static_cast<double>(e[j * C]);
        e[j * C] = static_cast<float>(acc);
      }"""
V, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def name_of(cfg) -> str:
    nwf, staged, group = cfg
    return f"fw{nwf}" + (f" staged {group}" if staged else " in-place")


def sources() -> dict:
    """{name: (source text, kind)} of every build."""
    from repro_torch.kernels import _build
    read = lambda p: open(p).read()                      # noqa: E731
    out = {"shap first": (read(os.path.join(HERE, "shap_first.cu")), "shap0"),
           "split first": (read(os.path.join(HERE, "split_first.cu")),
                           "split0"),
           "shap repo": (read(_build.CSRC / "shap.cu"), "shap"),
           "split repo": (read(_build.CSRC / "split.cu"), "split")}
    split = out["split repo"][0]
    assert ONE_BIN in split
    out["split batched"] = (split.replace(ONE_BIN, BATCHED), "split")
    repo = out["shap repo"][0]
    for name, subs in DIAGNOSED.items():
        text = repo
        for old, new in subs:
            assert old in text, old
            text = text.replace(old, new)
        out["shap diag " + name] = (text, "shap")
    loop = "#pragma unroll 4\n        for (int k = se.x; k < se.y; ++k) {"
    assert loop in repo
    for u in UNROLLS:
        out[f"shap unroll {u}"] = (repo.replace(loop, loop.replace(
            "unroll 4", f"unroll {u}")), "shap")
    for cfg in CONFIGS:
        nwf, staged, group = cfg
        out["shap " + name_of(cfg)] = (
            f"#define SHAP_FORCE_CONFIG {{{nwf}, {staged}, {group}}}\n"
            '#include "shap.cu"\n', "shap")
    return out


def build(found: dict) -> dict:
    """Compile every build, one nvcc each, all together; {name: .so}."""
    from repro_torch.kernels import _build
    os.makedirs(OUT, exist_ok=True)
    procs = []
    for i, (name, (text, kind)) in enumerate(found.items()):
        cu = os.path.join(OUT, f"v{i}.cu")
        with open(cu, "w") as fh:
            fh.write(text)
        flags = [*_build.NVCC_FLAGS, "-I", str(_build.CSRC)]
        if kind.startswith("shap"):
            flags.append("-fmad=false")
        so = cu[:-3] + ".so"
        procs.append((name, so, subprocess.Popen(
            [_build.nvcc(), *flags, "-o", so, cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
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


def events_ms(fn, reps: int) -> float:
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


def shap_runner(lib, kind, codes, pack, cols, d):
    """A no-argument call of one build at one case, and its output."""
    import torch
    from repro_torch.kernels import ref
    n, M = codes.shape
    T, L, D = pack.slot_feat.shape
    W = pack.leaf.shape[2]
    phi = torch.empty((n, M, d), device=codes.device)
    wts = torch.tensor(ref._unwind_weights(D), dtype=torch.float32,
                       device=codes.device)
    ptrs = [phi, codes, pack.slot_feat, pack.slot_lo, pack.slot_hi,
            pack.slot_z, pack.leaf, cols, wts]
    if kind == "shap":
        size = lib.tree_shap_scratch_kib
        size.argtypes, size.restype = [I] * 7, I
        scratch = torch.empty(size(n, M, d, T, L, D, W) * 256,
                              device=codes.device)
        ptrs.append(scratch)
    fn = lib.tree_shap_launch
    fn.argtypes = [V] * len(ptrs) + [Fl] + [I] * 7 + [V]
    fn.restype = I
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = fn(*[p.data_ptr() for p in ptrs], 0.05, n, M, d, T, L, D, W,
                 stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")
    return run, phi


def split_runner(lib, kind, hist, mask):
    import torch
    nodes, m, B, C = hist.shape
    gain = torch.empty(nodes, device=hist.device)
    idx = torch.empty(nodes, dtype=torch.int32, device=hist.device)
    ptrs = [hist, mask, gain, idx]
    if kind == "split":
        ptrs += [torch.empty((nodes, m), device=hist.device),
                 torch.empty((nodes, m), dtype=torch.int32,
                             device=hist.device)]
    fn = lib.split_scan_launch
    fn.argtypes = [V] * len(ptrs) + [I] * 4 + [Fl] * 2 + [V]
    fn.restype = I
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = fn(*[p.data_ptr() for p in ptrs], nodes, m, B, C, 1.0, 1.0,
                 stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")
    return run, (gain, idx)


def main() -> int:
    import torch
    import chip_smoke as CS
    from repro_torch.kernels import ref
    from repro_torch.kernels.shap_kernel import INFO_KEYS
    quick = "--quick" in sys.argv
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi}))
    found = sources()
    libs = {k: ctypes.CDLL(v) for k, v in build(found).items()}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    shap_builds = [k for k, (_, kind) in found.items()
                   if kind.startswith("shap")]
    order = (["shap first", "shap repo"]
             + [k for k in shap_builds if k not in ("shap first",
                                                    "shap repo")]
             + ["shap repo", "shap first"])
    for key, (n, T) in CS.SHAP_SHAPES.items():
        if quick and key == "a_trees8":
            continue
        codes, pack, cols = CS.shap_case(torch, gen, dev, n, T)
        M = codes.shape[1]
        L, D = pack.slot_feat.shape[1:]
        out = (ctypes.c_int * len(INFO_KEYS))()
        pick = libs["shap repo"].tree_shap_info
        pick.argtypes, pick.restype = [I] * 7 + [V], I
        assert pick(n, M, 512, T, L, D, 512, ctypes.addressof(out)) == 0
        print(json.dumps({"shape": key,
                          "repo_pick": dict(zip(INFO_KEYS, out))}))
        run, want = shap_runner(libs["shap repo"], "shap", codes, pack, cols,
                                512)
        run()
        want = want.clone()
        reps = 5 if n * T <= 4096 * 8 else 2
        for name in order:
            kind = found[name][1]
            try:
                run, phi = shap_runner(libs[name], kind, codes, pack, cols,
                                       512)
                ms = events_ms(run, reps)
            except RuntimeError as exc:
                print(json.dumps({"kernel": "tree_shap", "shape": key,
                                  "variant": name, "error": str(exc)}))
                continue
            same = bool(torch.equal(phi, want))
            print(json.dumps({"kernel": "tree_shap", "shape": key,
                              "variant": name, "ms": ms, "bitwise": same}))
            assert same or " diag " in name, \
                f"{name} at {key} differs from the repo build"
            del phi
        del want
        torch.cuda.empty_cache()
    cases = [(k, nodes, 6) for k, nodes in CS.SPLIT_NODES.items()]
    cases += [("n2_c17", 2, 17), ("n32_c17", 32, 17), ("n2_c32", 2, 32),
              ("n32_c32", 32, 32), ("ova_l5_c2", 4096, 2)]
    for key, nodes, C in cases:
        hist = torch.randn((nodes, 100, 256, C), generator=gen, device=dev)
        hist[..., -1] = torch.randint(0, 40, (nodes, 100, 256),
                                      generator=gen, device=dev).float()
        mask = torch.ones(100, device=dev)
        mask[7] = 0.0
        pg, pi = ref.split_scan_ref(hist, 1.0, 1.0, mask)
        for name in ("split first", "split repo", "split batched",
                     "split repo", "split batched", "split first"):
            run, (gain, idx) = split_runner(libs[name], found[name][1], hist,
                                            mask)
            ms = events_ms(run, 50)
            same = bool(torch.equal(idx, pi))
            print(json.dumps({"kernel": "split_scan", "shape": key,
                              "variant": name, "ms": ms, "idx_equal": same}))
            assert same, f"{name} at {key}: indices differ from plain"
    return 0


if __name__ == "__main__":
    sys.exit(main())
