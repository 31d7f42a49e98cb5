#!/usr/bin/env python3
"""Run the PyTorch port of SketchBoost, and its dense-LM prefill and
decode, on one CUDA card, end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. the card (nvidia-smi name and power limit) and the torch / CUDA build;
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
     per source, in parallel; B1 and B1-bf16 share ``hist.cu``, B3 and both
     B5 entry points ``predict.cu``; B4 is ``hist_direct.cu``, built with
     B1 on ``hist_common.cuh``; B6 ``shap.cu``, B7 ``flash_attention.cu``,
     B8 ``decode_attention.cu``; and the first versions of B2, B2-wide
     and B6 from ``tools/``) and time the build;
  3. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes (B1 and B1-bf16 bitwise against the plain version
     run on the CPU from host copies, where ``index_add_`` keeps their
     order of the sums; B1-bf16 at B1's level-1 shape also bitwise against
     fp32 B1 fed the bf16-rounded statistics, and timed beside it; B4
     bitwise at level 5 of the paper's tree, both summing in tiles of
     ``ref.TILE_ROWS`` rows, with each build's registers, shared memory a
     block and blocks an SM; B2's
     wide path at each of SketchBoost Full's levels (1, 2, 4, 8, 16 and 32
     nodes x 100 x 256 x 513), indices equal to the plain version's, gains
     within rtol 1e-5, equal run to run, beside its first design
     (``tools/split_wide_first.cu``); B3, B5 int8 and B5
     bf16 at the four shapes of ``TRAVERSE_SHAPES`` (262,144 rows x 8 trees,
     the 256-row serving window x 100, a 4,096-row chunk x 100, 131,072 x
     1), each bitwise its plain version and the same run to run, B5 also
     against B3 on the dequantized forest, narrow blocks at the first two,
     with each shape's tile and its build's registers, spills, shared bytes
     and blocks an SM; B2 at 1, 2 and 32 nodes (100 x 256 x 6: a level-wise
     tree's root and deepest level, a leaf-wise expansion), indices equal
     to the plain version's, gains within rtol 1e-5, equal run to run; B6
     at the three shapes of ``SHAP_SHAPES`` (4,096 rows x 8 trees, the
     256-row endpoint window x 100 trees, the 4,096 rows of ``shap_values``
     x 100 trees), bitwise and equal run to run, narrow blocks at per-tree
     columns at the first two, with the configuration ``shap.cu`` picks;
     B2 and B6 each beside its first version (``tools/split_first.cu``,
     ``tools/shap_first.cu``, built with the kernels) on the same inputs;
     B7 at the prefill's layer, 1 x 32 heads over 8 x 32,768 x 120 with a
     4,096 window, in bf16 (the tensor-core body) each output
     within one bf16 ulp of its own plain value plus 1e-5 and the same run
     to run, in float32 (the CUDA-core body, also timed) within 1e-5, and in
     float32 without the causal mask at 1,000 rows; B8 at decode_32k's
     layer, q 128 x 32 x 120 against a full 4,096-slot ring 128 x 4,096 x 8
     x 120 in bf16 within one bf16 ulp plus 1e-5, float32 q against it
     within 1e-5, a ragged 8,192-slot cache with a 4,096 window, and
     long_500k's batch-1 layer through the split path; B1 and B2 at the
     one-vs-all level 5 of one group, 128 trees x 32 nodes x 100 x 256 x 2
     over 2^28 partition entries, B1 bitwise its plain version on the
     first and last tree's nodes, B2's indices equal), and time kernel,
     plain version and, where one PyTorch call computes the same function,
     that call;
  4. fit the paper's configuration (``configs/sketchboost_tabular.py``) at
     full width, 2,097,152 rows x 100 features, d = 512, k = 5, depth 6,
     256 bins, all 100 rounds, with a 131,072-row eval set;
  5. predict 262,144 held-out rows through the traversal kernel;
  6. profile two more rounds of the loop body (device time by kernel,
     the device's busy share);
  7. serve the fitted model: checkpoint it, load four servers (float32,
     int8, bfloat16, pruned int8), drive a request stream and a streamed
     262,144-row batch through each (plain and double-buffered), check
     exactness against the model and the dequantized twins, run the
     overload drill, then measure a window that bucket padding nearly
     doubles (8 x 33 rows, padded to 512);
  8. explain the fitted model: path-dependent SHAP of 4,096 held-out rows
     with its additivity check, 64 of them against the port on the CPU,
     leaf ids against a CPU walk, importances of each kind, interventional
     SHAP of 256 rows against 64 background rows, and the SHAP endpoint of
     the float32 and int8 servers of phase 7 (windows of 8 x 32 rows);
  9. the other histogram engines and sketch methods at full width on phase
     4's data: 3 rounds each of ``hist_engine`` "direct" (B4), "partition"
     and "subtract" with the same per-round Pi (valid losses agree within
     1e-4 relative; split nodes that differ are counted, ties are legal),
     then 3 rounds each of ``sketch_method`` "top_outputs",
     "random_sampling" and "truncated_svd" and 2 of "none" (SketchBoost
     Full, B2's wide kernel); seconds per round, valid loss and peak memory
     of each; then one more round of Full under the profiler, as in 6,
     with B2-wide's kernels' share of the device time;
  9b. leaf-wise growth, bf16 statistics and staged prediction on phase 4's
     data, 3 rounds a fit with one set of per-round Pi: (a) leaf-wise at
     ``max_leaves=64`` (= 2^6) against level-wise ``"subtract"``: every
     tree puts the rows into the same leaves and the eval predictions are
     bitwise equal; (b) leaf-wise at ``max_leaves=32``: seconds per round,
     valid loss, peak memory, launches, and each tree's host syncs
     (counted under CUDA's sync debug mode, as in every fit here); (c)
     ``hist_dtype="bfloat16"`` level-wise and leaf-wise at 32 beside their
     fp32 fits (valid losses within 1e-3 relative, node slots that split
     differently counted, B1-bf16 launched and fp32 B1 not); (d)
     ``forest.predict_staged`` and ``staged_eval`` of (b)'s model on the
     eval set (the history within 1e-5 relative, the last stage bitwise
     ``predict_raw``); (e) one leaf-wise round under the profiler (device
     busy share, B1's and B2's shares) and the host syncs of one more;
  9c. ``strategy="one_vs_all"`` on phase 4's data (the memory of phases 4
     to 9b freed first), d = 512 univariate trees a round in groups of 128:
     (a) level-wise "subtract", 2 rounds: seconds per round, valid loss,
     peak memory, B1 and B2 launched once a level for each group (24 a
     round), one profiled round (busy share; B1's, B2's and PyTorch's
     partition/gather/leaf kernels' shares), and its seconds per round
     beside phase 9's Full and random_projection (the paper's three
     columns); (b) leaf-wise at ``max_leaves=32``, 1 round, with its host
     syncs; (c) 65,536 x 100, d = 16, depth 6, 3 rounds: the card against
     the CPU (predictions within 1e-4, the same best round), a second card
     fit bitwise, and leaf-wise at 64 leaves against level-wise on the card
     (the same leaves, eval predictions bitwise);
 10. the dense-LM prefill (memory of phases 4-9c freed first):
     h2o-danube-3-4b at full width in bf16 (24 layers, d_model 3840, 3.84 B
     parameters from a seeded ``torch.Generator``) through
     ``lm_serve.make_prefill_step``, 4 requests of 1 x 32,768 tokens (the
     first untimed) and 2 of 8 x 2,048 from ``lm_batches(seed=0)``: ms a
     request, tokens/s, peak memory, greedy next token, finite logits, 24
     B7 launches a request; one more 32k request under the profiler (B7's
     share of device time); a 2-layer float32 copy with a 256-token window
     at 1 x 640 tokens on the card against the CPU, logits within 1e-4 of
     the largest;
 11. the dense-LM decode (phase 10's memory freed first): h2o-danube-3-4b
     at full width in bf16 through ``lm_serve.make_serve_step`` over caches
     from ``lm.init_cache``: 8 prompts of 128 tokens from
     ``lm_batches(seed=0)`` fed token by token, then 64 greedy tokens;
     decode_32k (batch 128, ``max_seq_len`` 32,768: a 4,096-slot bf16 ring,
     45 GiB, filled at random at length 32,767; 16 timed steps, peak
     memory, one profiled step with B8's and the matmuls' shares); long_500k
     (batch 1 at length 524,287; 16 timed steps); ms a step and tokens/s of
     each, 24 B8 launches a step, finite logits; then a 2-layer float32 copy
     with a 256-token window over 320 tokens (the ring wraps): decode vs
     ``forward`` on the card and card vs CPU with a float32 cache, logits
     within 1e-4 of the largest; with the default bf16 cache, the CPU
     attending over the card's cache bits within 1e-4 of it, and card vs
     CPU running free within 1e-3 of it;
 12. print the kernel table as one JSON line, the card's line, and last
     ``{"ok": true, "device": {...}}``.

Phase 4's data are made on the card from a seeded ``torch.Generator``
(the Guyon scheme of ``data/pipeline.make_tabular``; numpy would take
minutes at this size).  Kernel launch counts are set to zero just before
phase 4 and read just after phase 5 (the fit -> predict path), again just
before and after phase 7 (the serving path), again around phase 8 (the
explain path), again around each fit of phase 9 (the direct engine's
B4, Full's B2-wide), of phase 9b (B1-bf16 in the bf16 fits) and of phase
9c (B1 and B2 on the one-vs-all path), again
around phase 10's prefill requests (B7), and again around phase 11's
decode steps (B8).
"""
from __future__ import annotations

import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 dense tensor cores
N_TRAIN, N_EVAL, N_TEST = 2_097_152, 131_072, 262_144


def bound_ms(n_bytes: float, n_ops: float, n_bf16_ops: float = 0.0):
    """The least time for the work: bytes over the memory rate, or ``n_ops``
    at the fp32 rate plus ``n_bf16_ops`` (products of bf16 inputs, exact on
    the tensor cores) at the bf16 tensor-core rate, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / FP32_OPS_PER_S + n_bf16_ops / BF16_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean milliseconds of ``fn()`` on the card, after one warm-up."""
    import torch
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


def hist_case(torch, gen, dev):
    """B1's inputs at the main path's level 1: m=100, B=256, C=6, the
    smaller child of a 2,097,152-row root (S ~ n/2), and the flat
    (node, feature, bin) cells of its rows for one ``index_add_``."""
    from repro_torch.core import histogram as H
    n, m, B, C = N_TRAIN, 100, 256, 6
    codes_t = torch.randint(0, B, (m, n), generator=gen, device=dev,
                            dtype=torch.int32).to(torch.uint8)
    # Positive statistics keep the check free of cancellation, so rtol
    # measures summation order alone; the count channel is exact.
    stats = torch.rand((n, C), generator=gen, device=dev)
    stats[:, -1] = 1.0
    go_right = torch.rand(n, generator=gen, device=dev) < 0.45
    state = H.advance_level_state(H.init_level_state(n, device=dev), go_right)
    side, is_built = H.smaller_children(state.counts)
    build_counts = torch.where(is_built, state.counts, 0).to(torch.int32)
    stats_p = stats[state.order.long()].contiguous()
    pos = torch.arange(n, device=dev)
    node = state.node_perm.long()
    keep = build_counts.long()[node] > 0
    pos, node = pos[keep], node[keep]
    flat = ((node[None, :] * m + torch.arange(m, device=dev)[:, None]) * B
            + codes_t.long()[:, state.order.long()[pos]]).reshape(-1)
    return dict(codes_t=codes_t, state=state, build_counts=build_counts,
                stats_p=stats_p, pos=pos, flat=flat, m=m, B=B, C=C)


def check_hist(torch, case):
    """B1 at the main path's level 1 (`hist_case`)."""
    from repro_torch.kernels import hist_kernel, ref
    m, B, C = case["m"], case["B"], case["C"]
    state, build_counts = case["state"], case["build_counts"]
    stats_p = case["stats_p"]
    args = (case["codes_t"], state.order, stats_p, state.counts,
            build_counts)
    out = hist_kernel.hist_nodes(*args, n_bins=B)
    again = hist_kernel.hist_nodes(*args, n_bins=B)
    torch.cuda.synchronize()
    assert torch.equal(out, again), "B1 is not deterministic run to run"
    # The plain version on the CPU keeps B1's order of the sums (index_add_
    # adds in row order there; on the card it is atomic), so B1 is held to
    # it bit for bit.
    plain = ref.hist_nodes_ref(*[a.cpu() for a in args], n_bins=B)
    err = float((out.cpu() - plain).abs().max())
    assert torch.equal(out.cpu(), plain), (
        f"B1 differs from its plain version by up to {err!r}")
    del plain
    s_b = int(build_counts.sum())
    # One PyTorch call for the same function: index_add_ over flat
    # (node, feature, bin) cells, indices prepared outside the timing.
    src = stats_p[case["pos"]].repeat(m, 1)
    cells = torch.zeros((2 * m * B, C), device=stats_p.device)
    library = cuda_ms(lambda: cells.zero_().index_add_(0, case["flat"], src),
                      3)
    # The yardstick adds atomically on the card, in no fixed order: its
    # sums are held to B1's within rtol 1e-5.
    torch.testing.assert_close(cells.reshape(out.shape), out, rtol=1e-5,
                               atol=0)
    del src, cells
    b_ms, b_by = bound_ms(s_b * (m + 4 + 4 * C) + 2 * m * B * C * 4,
                          s_b * m * C)
    return dict(
        name="hist_nodes", route="cuda",
        source="src/repro_torch/kernels/csrc/hist.cu",
        replaces="src/repro/kernels/hist_kernel.py:120",
        max_abs_err=err,
        ms=cuda_ms(lambda: hist_kernel.hist_nodes(*args, n_bins=B)),
        plain_ms=cuda_ms(lambda: ref.hist_nodes_ref(*args, n_bins=B), 2),
        bound_ms=b_ms, bound_by=b_by, library_ms=library,
        build=hist_kernel.launch_info(hist_kernel.KERNEL, c=C,
                                      n_bins=B))


def check_hist_bf16(torch, case):
    """B1-bf16 on `hist_case`'s inputs with the statistics in bf16: bitwise
    fp32 B1 fed the bf16-rounded statistics, the same run to run, and held
    bitwise to its plain version on the CPU as B1 is; timed beside fp32 B1
    at the same shape."""
    from repro_torch.kernels import hist_kernel, ref
    m, B, C = case["m"], case["B"], case["C"]
    state, build_counts = case["state"], case["build_counts"]
    stats_bf = case["stats_p"].to(torch.bfloat16)
    rounded = stats_bf.float()
    args = (case["codes_t"], state.order, stats_bf, state.counts,
            build_counts)
    kw = dict(n_bins=B, hist_dtype="bfloat16")
    out = hist_kernel.hist_nodes(*args, **kw)
    again = hist_kernel.hist_nodes(*args, **kw)
    fp32_args = (case["codes_t"], state.order, rounded, state.counts,
                 build_counts)
    fp32 = hist_kernel.hist_nodes(*fp32_args, n_bins=B)
    torch.cuda.synchronize()
    assert torch.equal(out, again), "B1-bf16 is not deterministic"
    assert torch.equal(out, fp32), "B1-bf16 differs from fp32 B1 on bf16 stats"
    plain = ref.hist_nodes_ref(*[a.cpu() for a in args], **kw)
    err = float((out.cpu() - plain).abs().max())
    assert torch.equal(out.cpu(), plain), (
        f"B1-bf16 differs from its plain version by up to {err!r}")
    del plain
    s_b = int(build_counts.sum())
    src = rounded[case["pos"]].repeat(m, 1)
    cells = torch.zeros((2 * m * B, C), device=rounded.device)
    library = cuda_ms(lambda: cells.zero_().index_add_(0, case["flat"], src),
                      3)
    torch.testing.assert_close(cells.reshape(out.shape), out, rtol=1e-5,
                               atol=0)
    del src, cells
    b_ms, b_by = bound_ms(s_b * (m + 4 + 2 * C) + 2 * m * B * C * 4,
                          s_b * m * C)
    return dict(
        name="hist_nodes_bf16", route="cuda",
        source="src/repro_torch/kernels/csrc/hist.cu",
        replaces="src/repro/kernels/hist_kernel.py:150",
        max_abs_err=err,
        ms=cuda_ms(lambda: hist_kernel.hist_nodes(*args, **kw)),
        plain_ms=cuda_ms(lambda: ref.hist_nodes_ref(*args, **kw), 2),
        bound_ms=b_ms, bound_by=b_by, library_ms=library,
        fp32_b1_ms=cuda_ms(lambda: hist_kernel.hist_nodes(*fp32_args,
                                                          n_bins=B)),
        build=hist_kernel.launch_info(hist_kernel.KERNEL_BF16, c=C,
                                      n_bins=B))


# The one-vs-all path's level 5 for one group of trees: OVA_TREES
# univariate trees (tree.OVA_GROUP_ENTRIES // N_TRAIN) x 32 nodes over
# N_TRAIN rows each, C = 2 ([g, 1]), one partition of OVA_TREES * N_TRAIN
# entries.
OVA_TREES = 128


def ova_level_case(torch, gen, dev):
    """B1's inputs at the one-vs-all level 5 of one group: `OVA_TREES`
    trees over `N_TRAIN` rows each, m=100, B=256, the partition made by
    five advances of a batched `LevelState` on random bits (45% right),
    the subtract engine's build counts, statistics ``[g, 1]`` in partition
    order.  Returns ``(codes_t, state, stats_p, counts, build_counts)``;
    ``state.order`` is B1's ``order``."""
    from repro_torch.core import histogram as H
    n, trees, lvl, m, B = N_TRAIN, OVA_TREES, 5, 100, 256
    codes_t = torch.randint(0, B, (m, n), generator=gen, device=dev,
                            dtype=torch.int32).to(torch.uint8)
    state = H.init_level_state(n, device=dev, trees=trees)
    for _ in range(lvl):
        bits = torch.rand(trees * n, generator=gen, device=dev) < 0.45
        state = H.advance_level_state(state, bits, permuted=True)
        del bits
    _, is_built = H.smaller_children(state.counts)
    build = torch.where(is_built, state.counts, 0).to(torch.int32)
    stats_p = torch.stack([torch.randn(trees * n, generator=gen, device=dev),
                           torch.ones(trees * n, device=dev)], 1)
    return codes_t, state, stats_p, state.counts, build


def check_ova_level(torch, gen, dev):
    """B1 and B2 at the one-vs-all level 5 of one group (`OVA_TREES` trees
    x 32 nodes, m=100, B=256, C=2): the partition made by five advances of
    a batched `LevelState` on random bits, the subtract engine's build
    counts.  B1 is the same run to run and bitwise its plain version, run
    on the CPU from host copies for the first and the last tree's 32
    nodes (a tree's sums depend on its segment alone; the plain version
    of the whole group would gather m * S codes, 200 GB); B2's indices
    equal its plain version's on the card, gains within rtol 1e-5.  Times
    both beside their bounds.  Returns the two shape records."""
    from repro_torch.core import tree as TR
    from repro_torch.kernels import hist_kernel, ref, split_kernel
    n, m, B, trees, lvl = N_TRAIN, 100, 256, OVA_TREES, 5
    assert TR.ova_groups(512, n)[0] == (0, trees)
    codes_t, state, stats_p, counts, build = ova_level_case(torch, gen, dev)
    args = (codes_t, state.order, stats_p, counts, build)
    nodes = trees * 2 ** lvl
    out = hist_kernel.hist_nodes(*args, n_bins=B)
    again = hist_kernel.hist_nodes(*args, n_bins=B)
    torch.cuda.synchronize()
    assert torch.equal(out, again), "B1 over trees is not deterministic"
    del again
    per, err = 2 ** lvl, 0.0
    for t in (0, trees - 1):
        sl = slice(t * n, (t + 1) * n)
        nd = slice(t * per, (t + 1) * per)
        plain = ref.hist_nodes_ref(
            codes_t.cpu(), state.order[sl].cpu(), stats_p[sl].cpu(),
            state.counts[nd].cpu(), build[nd].cpu(), n_bins=B)
        err = max(err, float((out[nd].cpu() - plain).abs().max()))
        assert torch.equal(out[nd].cpu(), plain), (
            f"B1 over trees differs from its plain version in tree {t} by "
            f"up to {err!r}")
        del plain
    s_b = int(build.sum())
    b_ms, b_by = bound_ms(s_b * (m + 4 + 4 * 2) + nodes * m * B * 2 * 4,
                          s_b * m * 2)
    b1 = dict(nodes=nodes, entries=trees * n, built_entries=s_b,
              max_abs_err=err, ms=cuda_ms(
                  lambda: hist_kernel.hist_nodes(*args, n_bins=B), 5),
              plain_ms=None, bound_ms=b_ms, bound_by=b_by,
              library_ms=None,
              note="plain version and index_add_ not timed at this shape: "
                   "each gathers the m * S codes (200 GB)")
    del args, stats_p, state, build, codes_t
    # B2 on the level's histograms as B1 built them (nodes not built are
    # empty and have no legal split, as the subtract engine derives them).
    hist = out
    mask = torch.ones(m, device=dev)
    gain, idx = split_kernel.split_scan(hist, 1.0, 1.0, mask)
    gain2, idx2 = split_kernel.split_scan(hist, 1.0, 1.0, mask)
    pg, pi = ref.split_scan_ref(hist, 1.0, 1.0, mask)
    torch.cuda.synchronize()
    assert torch.equal(idx, pi), "B2 over trees: split indices differ"
    torch.testing.assert_close(gain, pg, rtol=1e-5, atol=0)
    assert torch.equal(gain, gain2) and torch.equal(idx, idx2)
    b_ms, b_by = bound_ms(nodes * m * B * 2 * 4 + m * 4 + nodes * 8,
                          nodes * m * B * (4 * 2 + 12))
    legal = pg.isfinite()            # the empty nodes have none: -inf
    assert torch.equal(legal, gain.isfinite())
    b2 = dict(nodes=nodes, legal_nodes=int(legal.sum()),
              max_abs_err=float((gain[legal] - pg[legal]).abs().max()),
              ms=cuda_ms(lambda: split_kernel.split_scan(hist, 1.0, 1.0,
                                                         mask), 20),
              plain_ms=cuda_ms(lambda: ref.split_scan_ref(hist, 1.0, 1.0,
                                                          mask), 3),
              bound_ms=b_ms, bound_by=b_by, library_ms=None)
    del hist, out, pg, pi
    gc.collect()
    torch.cuda.empty_cache()
    return b1, b2


def check_hist_direct(torch, gen, dev):
    """B4 at level 5 of a 2,097,152-row root: 32 nodes, m=100, B=256, C=6,
    each row's node drawn on the card; bitwise against its plain version
    (each cell's rows added in row order within chunks of
    ``ref.TILE_ROWS`` rows, chunks in order) and from run to run."""
    from repro_torch.kernels import hist_kernel, ref
    n, m, B, C, nodes = N_TRAIN, 100, 256, 6, 32
    codes_t = torch.randint(0, B, (m, n), generator=gen, device=dev,
                            dtype=torch.int32).to(torch.uint8)
    node_pos = torch.randint(0, nodes, (n,), generator=gen, device=dev,
                             dtype=torch.int32)
    stats = torch.randn((n, C), generator=gen, device=dev)
    stats[:, -1] = 1.0
    args = (codes_t, node_pos, stats)
    kw = dict(n_nodes=nodes, n_bins=B)
    out = hist_kernel.hist_direct(*args, **kw)
    again = hist_kernel.hist_direct(*args, **kw)
    plain = ref.histogram_ref(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, again), "B4 is not deterministic run to run"
    err = float((out - plain).abs().max())
    assert torch.equal(out, plain), f"B4 differs from plain by {err!r}"
    del again, plain
    plain_ms = cuda_ms(lambda: ref.histogram_ref(*args, **kw), 2)
    # One PyTorch call for the same function: index_add_ over the flat
    # (node, feature, bin) cells, indices prepared outside the timing.
    flat = ((node_pos.long()[None, :] * m
             + torch.arange(m, device=dev)[:, None]) * B
            + codes_t.long()).reshape(-1)
    src = stats.repeat(m, 1)
    cells = torch.zeros((nodes * m * B, C), device=dev)
    library = cuda_ms(lambda: cells.zero_().index_add_(0, flat, src), 3)
    torch.testing.assert_close(cells.reshape(out.shape), out, rtol=1e-4,
                               atol=1e-3)
    del flat, src, cells
    b_ms, b_by = bound_ms(m * n + 4 * n + 4 * n * C + 4 * nodes * m * B * C,
                          m * n * C)
    return dict(
        name="hist_direct", route="cuda",
        source="src/repro_torch/kernels/csrc/hist_direct.cu",
        replaces="src/repro/kernels/hist_kernel.py:70",
        max_abs_err=err,
        ms=cuda_ms(lambda: hist_kernel.hist_direct(*args, **kw)),
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library,
        build=hist_kernel.launch_info(hist_kernel.DIRECT_KERNEL, c=C,
                                      n_bins=B))


def first_kernels():
    """``(split, split_wide, shap)``: the first versions of B2, B2-wide and
    B6 (``tools/split_first.cu``, ``tools/split_wide_first.cu``,
    ``tools/shap_first.cu``) as ``CudaKernel``s, built beside the repo's
    kernels and timed in phase 3 on the same inputs; their launches count
    on themselves, never on the repo's kernels."""
    import ctypes
    from repro_torch.kernels._build import CSRC, CudaKernel
    V, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tools = os.path.join(HERE, "tools")
    split = CudaKernel("split_scan_first",
                       os.path.join(tools, "split_first.cu"),
                       "split_scan_launch", [V] * 4 + [I] * 4 + [Fl] * 2,
                       extra_flags=("-I", str(CSRC)))
    split_wide = CudaKernel("split_scan_wide_first",
                            os.path.join(tools, "split_wide_first.cu"),
                            "split_scan_wide_launch",
                            [V] * 6 + [I] * 4 + [Fl] * 2,
                            extra_flags=("-I", str(CSRC)))
    shap = CudaKernel("tree_shap_first", os.path.join(tools, "shap_first.cu"),
                      "tree_shap_launch", [V] * 9 + [Fl] + [I] * 7,
                      extra_flags=("-fmad=false", "-I", str(CSRC)))
    return split, split_wide, shap


# B2's device kernels, as the profiler names them: up to 32 channels, and
# above (SketchBoost Full); both end in `split_pick_kernel`.
B2_KERNELS = ("split_unit_kernel", "split_pick_kernel")
B2_WIDE_KERNELS = ("split_wide_scan_kernel", "split_wide_score_kernel",
                   "split_pick_kernel")

# B2's shapes at the main path's widths (m=100, B=256, C=6): a level-wise
# tree's level 0 and level 5, and a leaf-wise expansion (2 nodes).
SPLIT_NODES = {"n1_root": 1, "n2_leafwise": 2, "n32_level5": 32}


def first_split_ms(torch, first, hist, mask, reps=50):
    """``tools/split_first.cu`` (B2's first version, one block a node) on
    the same inputs: (ms, idx)."""
    nodes, m, B, C = hist.shape
    gain = torch.empty(nodes, dtype=torch.float32, device=hist.device)
    idx = torch.empty(nodes, dtype=torch.int32, device=hist.device)

    def run():
        first.launch(hist.data_ptr(), mask.data_ptr(), gain.data_ptr(),
                     idx.data_ptr(), nodes, m, B, C, 1.0, 1.0)
    return cuda_ms(run, reps), idx


def check_split(torch, gen, dev, first):
    """B2 at each of `SPLIT_NODES` (x 100 features x 256 bins x 6
    channels): idx equal to the plain version's, gains within rtol 1e-5,
    two runs equal; timed beside the plain version and the first version
    (``tools/split_first.cu``, the kernel ``first``) on the same inputs.
    The row's top-level numbers are 32 nodes'."""
    from repro_torch.kernels import ref, split_kernel
    m, B, C = 100, 256, 6
    shapes, errs = {}, []
    for key, nodes in SPLIT_NODES.items():
        hist = torch.randn((nodes, m, B, C), generator=gen, device=dev)
        hist[..., -1] = torch.randint(0, 40, (nodes, m, B), generator=gen,
                                      device=dev).float()
        mask = torch.ones(m, device=dev)
        mask[7] = 0.0
        gain, idx = split_kernel.split_scan(hist, 1.0, 1.0, mask)
        gain2, idx2 = split_kernel.split_scan(hist, 1.0, 1.0, mask)
        pg, pi = ref.split_scan_ref(hist, 1.0, 1.0, mask)
        torch.cuda.synchronize()
        assert torch.equal(idx, pi), f"B2 {key}: split indices differ"
        torch.testing.assert_close(gain, pg, rtol=1e-5, atol=0)
        assert torch.equal(gain, gain2) and torch.equal(idx, idx2), \
            f"B2 {key} is not the same run to run"
        first_ms, fi = first_split_ms(torch, first, hist, mask)
        assert torch.equal(fi, pi), f"B2's first version {key} differs"
        errs.append(float((gain - pg).abs().max()))
        # Masked features are skipped: only the others' histograms count.
        used = int((mask > 0).sum())
        b_ms, b_by = bound_ms(nodes * used * B * C * 4 + m * 4 + nodes * 8,
                              nodes * used * B * (4 * C + 12))
        shapes[key] = dict(
            nodes=nodes, ms=cuda_ms(
                lambda: split_kernel.split_scan(hist, 1.0, 1.0, mask), 50),
            first_ms=first_ms,
            plain_ms=cuda_ms(lambda: ref.split_scan_ref(hist, 1.0, 1.0,
                                                        mask), 5),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=errs[-1])
    top = shapes["n32_level5"]
    return dict(
        name="split_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/split.cu",
        replaces="src/repro/kernels/split_kernel.py:95",
        max_abs_err=max(errs), ms=top["ms"], first_ms=top["first_ms"],
        plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
        bound_by=top["bound_by"], library_ms=None, shapes=shapes)


# B2-wide's shapes: SketchBoost Full's levels 0 to 5 on the paper's
# configuration (m=100, B=256, C = d + 1 = 513), one launch a level.
WIDE_NODES = (1, 2, 4, 8, 16, 32)


def first_split_wide_ms(torch, first, hist, mask, reps=20):
    """``tools/split_wide_first.cu`` (B2-wide's first design, a block a
    (node, feature)) on the same inputs: (ms, idx)."""
    nodes, m, B, C = hist.shape
    gain = torch.empty(nodes, dtype=torch.float32, device=hist.device)
    idx = torch.empty(nodes, dtype=torch.int32, device=hist.device)
    part_gain = torch.empty((nodes, m), device=hist.device)
    part_idx = torch.empty((nodes, m), dtype=torch.int32, device=hist.device)

    def run():
        first.launch(hist.data_ptr(), mask.data_ptr(), gain.data_ptr(),
                     idx.data_ptr(), part_gain.data_ptr(),
                     part_idx.data_ptr(), nodes, m, B, C, 1.0, 1.0)
    return cuda_ms(run, reps), idx


def check_split_wide(torch, gen, dev, first):
    """B2's wide path (C > 32) at each of SketchBoost Full's levels
    (`WIDE_NODES` x 100 x 256 x 513: d = 512 gradient channels and the
    count): idx equal to the plain version's, gains within rtol 1e-5, two
    runs bitwise equal; timed beside the plain version and the first design
    (``tools/split_wide_first.cu``, the kernel ``first``) on the same
    inputs.  The row's top-level numbers are 32 nodes'."""
    from repro_torch.kernels import ref, split_kernel
    m, B, C = 100, 256, 513
    shapes, errs = {}, []
    for nodes in WIDE_NODES:
        hist = torch.randn((nodes, m, B, C), generator=gen, device=dev)
        hist[..., -1] = torch.randint(0, 40, (nodes, m, B), generator=gen,
                                      device=dev).float()
        mask = torch.ones(m, device=dev)
        mask[7] = 0.0
        before = split_kernel.WIDE_KERNEL.launches
        gain, idx = split_kernel.split_scan(hist, 1.0, 1.0, mask)
        gain2, idx2 = split_kernel.split_scan(hist, 1.0, 1.0, mask)
        assert split_kernel.WIDE_KERNEL.launches == before + 2, \
            "not the wide path"
        pg, pi = ref.split_scan_ref(hist, 1.0, 1.0, mask)
        torch.cuda.synchronize()
        assert torch.equal(idx, pi), \
            f"B2-wide at {nodes} nodes: split indices differ from plain"
        torch.testing.assert_close(gain, pg, rtol=1e-5, atol=0)
        assert torch.equal(gain, gain2) and torch.equal(idx, idx2), \
            f"B2-wide at {nodes} nodes is not the same run to run"
        first_ms, fi = first_split_wide_ms(torch, first, hist, mask)
        assert torch.equal(fi, pi), \
            f"B2-wide's first design at {nodes} nodes differs"
        errs.append(float((gain - pg).abs().max()))
        del pg, pi
        # Masked features are skipped: only the others' histograms count.
        used = int((mask > 0).sum())
        b_ms, b_by = bound_ms(nodes * used * B * C * 4 + m * 4 + nodes * 8,
                              nodes * used * B * (4 * C + 12))
        shapes[f"n{nodes}"] = dict(
            nodes=nodes, ms=cuda_ms(
                lambda: split_kernel.split_scan(hist, 1.0, 1.0, mask), 20),
            first_ms=first_ms,
            plain_ms=cuda_ms(lambda: ref.split_scan_ref(hist, 1.0, 1.0,
                                                        mask), 2),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=errs[-1])
        del hist
    top = shapes["n32"]
    return dict(
        name="split_scan_wide", route="cuda",
        source="src/repro_torch/kernels/csrc/split.cu",
        replaces="src/repro/kernels/split_kernel.py:95",
        max_abs_err=max(errs), ms=top["ms"], first_ms=top["first_ms"],
        plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
        bound_by=top["bound_by"], library_ms=None, shapes=shapes)


# Phase 3's traversal shapes (rows, trees), all at D = W = 512 over 100
# codes a row with depth-6 trees (N = 127): (a) predict's 262,144 rows of
# 8 trees, timed since the first version; (b) one 256-row serving window of
# the 100-tree model; (c) one 4,096-row chunk of the streamed batch; (d) the
# fit's eval call, 131,072 rows of one tree.
TRAVERSE_SHAPES = {"a_predict": (N_TEST, 8), "b_window": (256, 100),
                   "c_chunk": (4096, 100), "d_eval": (N_EVAL, 1)}


def traverse_case(torch, gen, dev, n, T, M=100, depth=6, D=512):
    """``T`` random depth-``depth`` trees of width ``D`` over ``n`` rows of
    ``M`` codes.  Returns ``(codes, PackedForest, F0)``."""
    from repro_torch.core.forest import PackedForest
    from repro_torch.core.tree import heap_to_node_arrays
    feat = torch.randint(0, M, (T, 2 ** depth - 1), generator=gen,
                         device=dev, dtype=torch.int32)
    thr = torch.randint(0, 256, (T, 2 ** depth - 1), generator=gen,
                        device=dev, dtype=torch.int32)
    value = torch.randn((T, 2 ** depth, D), generator=gen, device=dev)
    feat, thr, left, right, leaf = heap_to_node_arrays(feat, thr, value)
    codes = torch.randint(0, 256, (n, M), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    pf = PackedForest(feat=feat, thr=thr, left=left, right=right, leaf=leaf,
                      out_col=torch.zeros(T, dtype=torch.int32, device=dev),
                      base=torch.zeros(D, device=dev),
                      lr=torch.tensor(0.05), depth=depth)
    return codes, pf, torch.randn((n, D), generator=gen, device=dev)


def traverse_cases(torch, gen, dev):
    return {k: traverse_case(torch, gen, dev, n, T)
            for k, (n, T) in TRAVERSE_SHAPES.items()}


def traverse_touched(torch, codes, pf):
    """``(nodes, leaves)``: the (tree, node) pairs at which this run's rows
    take a step of the walk, whose node arrays are read, and the (tree,
    node) pairs they end at, whose leaf rows are added; each counted once.
    B5's trees (`quantize_forest` of the same) take the same branches."""
    T, N = pf.feat.shape
    read = torch.zeros((T, N), dtype=torch.bool, device=codes.device)
    reached = torch.zeros_like(read)
    for t in range(T):
        feat, thr = pf.feat[t].long(), pf.thr[t].long()
        left, right = pf.left[t].long(), pf.right[t].long()
        pos = torch.zeros(codes.shape[0], dtype=torch.long,
                          device=codes.device)
        for _ in range(pf.depth):
            read[t, pos] = True
            code = codes.gather(1, feat[pos][:, None])[:, 0].long()
            pos = torch.where(code > thr[pos], right[pos], left[pos])
        reached[t, pos] = True
    return int(read.sum()), int(reached.sum())


def traverse_bytes(n, M, T, D, W, s, nodes, leaves):
    """Bytes each input read once and F written once, counting only what
    this run's walks touch (`traverse_touched`): F twice, the codes, the
    node arrays of ``nodes`` nodes (int32, or B5's uint8 thresholds), the
    leaf rows of ``leaves`` nodes, the columns (and B5's float32 scale a
    tree)."""
    node_bytes = 16 if s == 4 else 13
    return (8 * n * D + n * M + nodes * node_bytes + leaves * W * s
            + 4 * T * (1 if s == 4 else 2))


def traverse_reps(n, T) -> int:
    """Timed launches: more for the small shapes, whose times are µs."""
    return 5 if n * T >= 1 << 20 else 50


def check_traverse(torch, cases, dtype="float32"):
    """B3 (``dtype`` float32) or B5 (int8, bfloat16: ``quantize_forest``
    of the same trees) at each shape of `TRAVERSE_SHAPES`: bitwise its
    plain version and equal run to run, B5 bitwise B3 on the dequantized
    twin, and at (a) and (b) narrow blocks (the one-vs-all layout: width 1
    at per-tree columns 60 apart) bitwise too.  Times kernel and plain
    version at each shape, with its bytes bound and the leaf bytes it
    gathers (n T W s), the tile ``predict.cu`` picks at each shape and its
    build's registers, spills, shared bytes and blocks an SM; the serving
    window's grid must give every SM a block.  The row's top-level numbers
    are shape (a)'s."""
    from repro_torch.core import quantize as Q
    from repro_torch.kernels import predict_kernel as PK
    from repro_torch.kernels import predict_quant_kernel as PQ
    from repro_torch.kernels import ref
    quant = dtype != "float32"
    kind = {"float32": 0, "int8": 1, "bfloat16": 2}[dtype]
    shapes, errs = {}, []
    for key, (codes, pf, F0) in cases.items():
        n, M = codes.shape
        lr = 0.05
        touched = traverse_touched(torch, codes, pf)
        if quant:
            qf = Q.quantize_forest(pf, dtype)
            twin = Q.dequantize_forest(qf)
            trees = (qf.feat, qf.thr, qf.left, qf.right)
            leaf, scale = qf.leaf, qf.leaf_scale
            kernel = PQ.KERNELS[leaf.dtype]

            def run(F, leaf=leaf, cols=pf.out_col, trees=trees,
                    scale=scale):
                return PQ.forest_traverse_quant(F, codes, *trees, leaf,
                                                scale, cols, lr,
                                                depth=pf.depth)

            def plain(F, leaf=leaf, cols=pf.out_col, trees=trees,
                      scale=scale):
                return ref.forest_apply_quant_ref(F, codes, *trees, leaf,
                                                  scale, cols, lr,
                                                  depth=pf.depth)
        else:
            trees = (pf.feat, pf.thr, pf.left, pf.right)
            leaf, kernel = pf.leaf, PK.KERNEL

            def run(F, leaf=leaf, cols=pf.out_col, trees=trees):
                return PK.forest_traverse(F, codes, *trees, leaf, cols, lr,
                                          depth=pf.depth)

            def plain(F, leaf=leaf, cols=pf.out_col, trees=trees):
                return ref.forest_apply_ref(F, codes, *trees, leaf, cols, lr,
                                            depth=pf.depth)
        out, want = run(F0.clone()), plain(F0.clone())
        again = run(F0.clone())
        torch.cuda.synchronize()
        errs.append(float((out - want).abs().max()))
        assert torch.equal(out, want), f"{kernel.name} {key} != plain"
        assert torch.equal(out, again), f"{kernel.name} {key} run to run"
        if quant:
            b3 = PK.forest_traverse(F0.clone(), codes, twin.feat, twin.thr,
                                    twin.left, twin.right, twin.leaf,
                                    twin.out_col, lr, depth=twin.depth)
            assert torch.equal(out, b3), f"{kernel.name} {key} != B3 twin"
        T, N, W = leaf.shape
        if key in ("a_predict", "b_window"):
            narrow = leaf[:, :, :1].contiguous()
            cols = torch.arange(T, dtype=torch.int32,
                                device=codes.device) * 60 % W
            k_n = run(F0.clone(), narrow, cols)
            assert torch.equal(k_n, plain(F0.clone(), narrow, cols)), \
                f"{kernel.name} {key}: narrow blocks differ from plain"
        del out, want, again
        s = leaf.element_size()
        b_ms, b_by = bound_ms(traverse_bytes(n, M, T, W, W, s, *touched),
                              (3 if quant else 2) * n * T * W)
        info = PK.launch_info(kernel, kind, n, W, M)
        plan = {k: info.pop(k) for k in ("rows", "cols", "group", "vec",
                                         "grid", "stage_codes")}
        if key == "b_window":
            sms = torch.cuda.get_device_properties(
                codes.device).multi_processor_count
            assert plan["grid"][0] * plan["grid"][1] >= sms, \
                f"{kernel.name}: the serving window leaves SMs idle: {plan}"
        Fw = F0.clone()
        shapes[key] = dict(
            rows=n, trees=T, ms=cuda_ms(lambda: run(Fw),
                                        traverse_reps(n, T)),
            plain_ms=cuda_ms(lambda: plain(Fw), 2), bound_ms=b_ms,
            bound_by=b_by, leaf_bytes=n * T * W * s,
            touched=dict(zip(("nodes", "leaves"), touched)), plan=plan,
            build=info)
        del Fw
    a = shapes["a_predict"]
    name = PK.KERNEL.name if not quant else PQ.KERNELS[
        torch.int8 if dtype == "int8" else torch.bfloat16].name
    return dict(
        name=name, route="cuda",
        source="src/repro_torch/kernels/csrc/predict.cu",
        replaces=("src/repro/kernels/predict_kernel.py:237" if quant
                  else "src/repro/kernels/predict_kernel.py:182"),
        max_abs_err=max(errs), ms=a["ms"], plain_ms=a["plain_ms"],
        bound_ms=a["bound_ms"], bound_by=a["bound_by"], library_ms=None,
        shapes=shapes)


def shap_ops(depth: int) -> int:
    """Floating-point operations of one path's factors in ``shap.cu``:
    suffix and prefix products, the weighted convolutions, ``(o - z) * Ψ``
    (duplicate-feature sums excluded: merged packs have none)."""
    ext = sum(3 * k - 1 for k in range(1, depth + 1))      # one EXTEND each
    conv = 0
    for s in range(depth):
        ls, lp = depth - s, s + 1
        for k in range(depth):
            terms = min(k, lp - 1) - max(0, k - ls + 1) + 1
            conv += 2 * terms - 1 + 1 + (k > 0)
    return 2 * ext - (3 * depth - 1) + conv + 2 * depth


# B6's shapes (rows, trees), all of depth-6 trees (L=64 paths, D=6 slots)
# over 100 features at W = d = 512: (a) the 8-tree shape timed since the
# first version; (b) one 256-row endpoint window of the explain path's
# 100-tree model; (c) the 4,096 rows of its ``shap_values``.
SHAP_SHAPES = {"a_trees8": (4096, 8), "b_window": (256, 100),
               "c_explain": (4096, 100)}


def shap_case(torch, gen, dev, n, T, M=100, depth=6, d=512):
    """``T`` random depth-``depth`` trees with covers (empty subtrees
    included) over ``n`` rows of ``M`` codes: ``(codes, pack, out_col)``."""
    from repro_torch.core import forest as FO
    from repro_torch.core.tree import heap_to_node_arrays
    from repro_torch.explain import build_path_pack
    h = 2 ** depth - 1
    feat, thr, left, right, leaf = heap_to_node_arrays(
        torch.randint(0, M, (T, h), generator=gen, device=dev,
                      dtype=torch.int32),
        torch.randint(0, 255, (T, h), generator=gen, device=dev,
                      dtype=torch.int32),
        torch.randn((T, h + 1, d), generator=gen, device=dev))
    leaf_cover = torch.randint(0, 40, (T, h + 1), generator=gen, device=dev,
                               dtype=torch.int32).float()
    pf = FO.PackedForest(
        feat=feat, thr=thr, left=left, right=right, leaf=leaf,
        out_col=torch.zeros(T, dtype=torch.int32, device=dev),
        base=torch.zeros(d, device=dev), lr=torch.tensor(0.05),
        cover=FO._heap_cover(leaf_cover), node_count=None, depth=depth)
    codes = torch.randint(0, 256, (n, M), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    return codes, build_path_pack(pf), pf.out_col


def shap_bound(pack, n, M, d):
    """B6's bound from this case's own tables: phi written once, the codes
    and the tables read once; the scatter's ``2 n W`` operations per real
    slot and each real path's Psi (`shap_ops`)."""
    T, L, D = pack.slot_feat.shape
    real_slots = int((pack.slot_feat >= 0).sum())
    real_paths = int((pack.slot_feat >= 0).any(2).sum())
    return bound_ms(4 * n * M * d + n * M + 16 * T * L * D
                    + 4 * T * L * d + 4 * T + 4 * D,
                    2 * n * real_slots * d + n * real_paths * shap_ops(D))


def first_shap_ms(torch, first, codes, pack, cols, d, reps):
    """``tools/shap_first.cu`` (B6's first version, one row a block) on the
    same inputs: (ms, phi)."""
    from repro_torch.kernels import ref
    n, M = codes.shape
    T, L, D = pack.slot_feat.shape
    phi = torch.empty((n, M, d), dtype=torch.float32, device=codes.device)
    wts = torch.tensor(ref._unwind_weights(D), dtype=torch.float32,
                       device=codes.device)

    def run():
        first.launch(phi.data_ptr(), codes.data_ptr(),
                     pack.slot_feat.data_ptr(), pack.slot_lo.data_ptr(),
                     pack.slot_hi.data_ptr(), pack.slot_z.data_ptr(),
                     pack.leaf.data_ptr(), cols.data_ptr(), wts.data_ptr(),
                     0.05, n, M, d, T, L, D, pack.leaf.shape[2])
    return cuda_ms(run, reps), phi


def check_shap(torch, gen, dev, first):
    """B6 at each of `SHAP_SHAPES`: bitwise against the plain version on
    the card (same sums in the same order, two roundings) and the same run
    to run, W=1 blocks at per-tree columns at (a) and (b); timed beside the
    plain version (one call after the checking one, host clock) and the
    first version (``tools/shap_first.cu``, the kernel ``first``, also
    bitwise), with each shape's bound from its own slots and paths and the
    configuration ``shap.cu`` picks.  The row's top-level numbers are the
    endpoint window's (b)."""
    from repro_torch.kernels import ref, shap_kernel
    d, lr = 512, 0.05
    shapes, errs = {}, []
    for key, (n, T) in SHAP_SHAPES.items():
        codes, pack, cols = shap_case(torch, gen, dev, n, T, d=d)
        M = codes.shape[1]
        tables = (pack.slot_feat, pack.slot_lo, pack.slot_hi, pack.slot_z)

        def kernel(leaf_v, cols):
            return shap_kernel.tree_shap(codes, *tables, leaf_v, cols, lr,
                                         n_outputs=d)

        def plain(leaf_v, cols):
            phi = torch.zeros((n, M, d), device=dev)
            return ref.tree_shap_ref(phi, codes, *tables, leaf_v, cols, lr)
        out, again = kernel(pack.leaf, cols), kernel(pack.leaf, cols)
        torch.cuda.synchronize()
        assert torch.equal(out, again), f"B6 {key} is not the same run to run"
        del again
        want = plain(pack.leaf, cols)
        torch.cuda.synchronize()
        errs.append(float((out - want).abs().max()))
        assert torch.equal(out, want), f"B6 {key} differs from plain by " \
            f"{errs[-1]!r}"
        del want
        reps = 5 if n * T <= 4096 * 8 else 2
        first_ms, first_out = first_shap_ms(torch, first, codes, pack, cols,
                                            d, reps)
        assert torch.equal(out, first_out), \
            f"B6's first version {key} differs"
        del out, first_out
        if key != "c_explain":
            narrow = pack.leaf[:, :, :1].contiguous()
            ncols = torch.arange(T, dtype=torch.int32, device=dev) * 60 % d
            k_n, p_n = kernel(narrow, ncols), plain(narrow, ncols)
            torch.cuda.synchronize()
            assert torch.equal(k_n, p_n), f"B6 {key}: narrow blocks differ"
            del k_n, p_n
        L, D = pack.slot_feat.shape[1:]
        b_ms, b_by = shap_bound(pack, n, M, d)
        t0 = time.perf_counter()
        plain(pack.leaf, cols)
        torch.cuda.synchronize()
        shapes[key] = dict(
            rows=n, trees=T, real_slots=int((pack.slot_feat >= 0).sum()),
            ms=cuda_ms(lambda: kernel(pack.leaf, cols), reps),
            first_ms=first_ms,
            plain_ms=1e3 * (time.perf_counter() - t0), bound_ms=b_ms,
            bound_by=b_by, max_abs_err=errs[-1],
            plan=shap_kernel.launch_info(n, M, d, T, L, D, d))
        gc.collect()
    top = shapes["b_window"]
    return dict(
        name="tree_shap", route="cuda",
        source="src/repro_torch/kernels/csrc/shap.cu",
        replaces="src/repro/kernels/shap_kernel.py:109",
        max_abs_err=max(errs), ms=top["ms"], first_ms=top["first_ms"],
        plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
        bound_by=top["bound_by"], library_ms=None, shapes=shapes)


def attention_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """Unmasked (query, key) pairs of one head: what B7 must compute."""
    import numpy as np
    qpos = np.arange(sq, dtype=np.int64)
    hi = np.minimum(qpos + 1, sk) if causal else np.full(sq, sk)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def bf16_ulps(x):
    """One bf16 ulp of each element's own magnitude (0 where it is 0)."""
    import torch
    m, e = torch.frexp(x.float())
    return torch.where(m == 0, torch.zeros_like(m),
                       torch.ldexp(torch.ones_like(m), e - 8))


def check_flash(torch, gen, dev):
    """B7 at the prefill's layer shape: b=1, hq=32, hkv=8, sq=sk=32,768,
    dh=120, causal, window 4,096.  In bf16 (the tensor-core body) each
    output within one bf16 ulp of its own plain value plus 1e-5 (the
    float32 limit) and the same from run to run; in float32 (the CUDA-core
    body) within atol 1e-5 of plain at the same shape, and timed.  Also
    float32 at (1, 8, 2, 1,000, 120) without the causal mask (keys past sk
    masked) within atol 1e-5."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref
    b, hq, hkv, s, dh, window = 1, 32, 8, 32_768, 120, 4096
    kw = dict(causal=True, window=window)
    q32, k32, v32 = (torch.randn((b, h, s, dh), generator=gen, device=dev)
                     for h in (hq, hkv, hkv))
    o32 = FA.flash_attention(q32, k32, v32, **kw)
    p32 = ref.flash_attention_ref(q32, k32, v32, **kw)
    torch.cuda.synchronize()
    err_layer32 = float((o32 - p32).abs().max())
    assert err_layer32 <= 1e-5, (
        f"B7 float32 at the layer shape differs from plain by "
        f"{err_layer32!r}")
    f32_ms = cuda_ms(lambda: FA.flash_attention(q32, k32, v32, **kw), 2)
    q, k, v = (t.to(torch.bfloat16) for t in (q32, k32, v32))
    del q32, k32, v32, o32, p32
    out = FA.flash_attention(q, k, v, **kw)
    again = FA.flash_attention(q, k, v, **kw)
    plain = ref.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, again), "B7 bf16 is not deterministic run to run"
    del again
    diff = (out.float() - plain.float()).abs()
    limit = bf16_ulps(plain) + 1e-5
    err = float(diff.max())
    worst = float((diff / limit).max())
    assert worst <= 1.0, (
        f"B7 differs from plain by up to {worst!r} of one bf16 ulp of each "
        f"output plus 1e-5 (max abs err {err!r})")
    del diff, limit
    qf, kf, vf = (torch.randn((1, h, 1000, dh), generator=gen, device=dev)
                  for h in (8, 2, 2))
    of = FA.flash_attention(qf, kf, vf, causal=False)
    pf = ref.flash_attention_ref(qf, kf, vf, causal=False)
    torch.cuda.synchronize()
    err32 = float((of - pf).abs().max())
    assert err32 <= 1e-5, f"B7 float32 differs from plain by {err32!r}"
    pairs = attention_pairs(s, s, True, window)
    # QK^T takes bf16 inputs (exact on the tensor cores).  PV takes the
    # float32 probabilities: the kernel's bf16 body splits them into three
    # bf16 parts, three products at the tensor-core rate (the bound held);
    # beside it PV at the fp32 rate of the CUDA cores (the first design's
    # bound) and one bf16 PV product (the all-bf16 bound).
    half_ops = 2 * dh * hq * b * pairs
    n_bytes = 2 * (2 * b * hq * s * dh + 2 * b * hkv * s * dh)
    b_ms, b_by = bound_ms(n_bytes, 0, n_bf16_ops=4 * half_ops)
    fp32_pv_ms, _ = bound_ms(n_bytes, half_ops, n_bf16_ops=half_ops)
    # The library yardstick, used nowhere in the port: one SDPA call with
    # GQA and a boolean band mask, on a fused kernel (the math one would
    # hold every score).  It skips no masked block.
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qpos = torch.arange(s, device=dev)[:, None]
    kpos = torch.arange(s, device=dev)[None, :]
    mask = (kpos <= qpos) & (qpos - kpos < window)

    def library():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              enable_gqa=True)
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                      SDPBackend.EFFICIENT_ATTENTION,
                      SDPBackend.CUDNN_ATTENTION]):
        lib_err = float((library().float() - plain.float()).abs().max())
        lib_ms = cuda_ms(library, 3)
    del mask, plain, out
    return dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:76",
        max_abs_err=err, share_of_bf16_ulp_limit=worst,
        f32_layer_max_abs_err=err_layer32,
        f32_tail_mask_max_abs_err=err32,
        ms=cuda_ms(lambda: FA.flash_attention(q, k, v, **kw)),
        plain_ms=cuda_ms(lambda: ref.flash_attention_ref(q, k, v, **kw), 2),
        bound_ms=b_ms, bound_by=b_by, pairs_per_head=pairs, ops=4 * half_ops,
        fp32_pv_bound_ms=fp32_pv_ms,
        all_bf16_bound_ms=1e3 * 2 * half_ops / BF16_OPS_PER_S,
        f32_ms=f32_ms, library_ms=lib_ms, library_max_abs_err=lib_err)


def check_decode(torch, gen, dev, b=128, hq=32, hkv=8, s=4096, dh=120):
    """B8 at decode_32k's layer: q (128, 32, 120) bf16 against a full ring
    of 4,096 slots, (128, 4,096, 8, 120) bf16 in the cache's layout, window
    4,096: each output within one bf16 ulp of its own plain value plus 1e-5,
    and equal from run to run.  Also float32 q against the same bf16 cache
    within 1e-5; a ragged 8,192-slot cache without a ring (window 4,096,
    lengths drawn in [1, 8,192]) in bf16; and long_500k's layer, batch 1,
    whose 8 (row, kv head) pairs take the split path; both also equal from
    run to run.  Times the kernel,
    the plain version and one SDPA call (GQA, boolean length mask, on
    views of the cache)."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import ref
    window, bf = s, torch.bfloat16

    def cache(b, s):
        return [torch.randn((b, s, hkv, dh), generator=gen, device=dev,
                            dtype=bf) for _ in "kv"]

    def held(out, plain):
        diff = (out.float() - plain.float()).abs()
        worst = float((diff / (bf16_ulps(plain) + 1e-5)).max())
        assert worst <= 1.0, (
            f"B8 differs from plain by up to {worst!r} of one bf16 ulp of "
            f"each output plus 1e-5 (max abs err {float(diff.max())!r})")
        return float(diff.max()), worst

    def n_bytes(b, lengths, win):
        seen = int(torch.clamp(lengths, max=win).sum())
        return 2 * 2 * seen * hkv * dh + 2 * 2 * b * hq * dh, seen

    q32 = torch.randn((b, hq, dh), generator=gen, device=dev)
    q = q32.to(bf)
    k, v = cache(b, s)
    full = torch.full((b,), s, dtype=torch.int32, device=dev)
    out = DA.decode_attention(q, k, v, s, window=window)
    again = DA.decode_attention(q, k, v, s, window=window)
    plain = ref.decode_attention_ref(q, k, v, full, window=window)
    torch.cuda.synchronize()
    assert torch.equal(out, again), "B8 is not deterministic run to run"
    err, worst = held(out, plain)
    o32 = DA.decode_attention(q32, k, v, s, window=window)
    p32 = ref.decode_attention_ref(q32, k, v, full, window=window)
    torch.cuda.synchronize()
    err32 = float((o32 - p32).abs().max())
    assert err32 <= 1e-5, f"B8 float32 q differs from plain by {err32!r}"
    ms = cuda_ms(lambda: DA.decode_attention(q, k, v, s, window=window), 20)
    plain_ms = cuda_ms(
        lambda: ref.decode_attention_ref(q, k, v, full, window=window), 3)
    # The library yardstick, used nowhere in the port: one SDPA call with
    # GQA and a boolean length mask on (b, hq, 1, dh) q and (b, hkv, s, dh)
    # views of the cache.
    kpos = torch.arange(s, device=dev)[None, :]
    mask = ((kpos < full[:, None]) & (full[:, None] - 1 - kpos < window)
            )[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(
            q[:, :, None], k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
            attn_mask=mask, enable_gqa=True)
    lib_err = float((library()[:, :, 0].float() - plain.float()).abs().max())
    lib_ms = cuda_ms(library, 5)
    nb, seen = n_bytes(b, full, window)
    b_ms, b_by = bound_ms(nb, 4 * dh * (hq // hkv) * hkv * seen)
    del k, v, out, again, plain, o32, p32, mask

    # Ragged, no ring: 8,192 slots, window 4,096.
    k, v = cache(b, 2 * s)
    lengths = torch.randint(1, 2 * s + 1, (b,), generator=gen, device=dev,
                            dtype=torch.int32)
    out = DA.decode_attention(q, k, v, lengths, window=window)
    again = DA.decode_attention(q, k, v, lengths, window=window)
    plain = ref.decode_attention_ref(q, k, v, lengths, window=window)
    torch.cuda.synchronize()
    assert torch.equal(out, again), "B8 is not deterministic on ragged rows"
    err_ragged, worst_ragged = held(out, plain)
    ragged_ms = cuda_ms(
        lambda: DA.decode_attention(q, k, v, lengths, window=window), 20)
    ragged_bound, _ = bound_ms(n_bytes(b, lengths, window)[0], 0)
    del k, v, out, again, plain

    # long_500k's layer: batch 1, the same full ring.
    k, v = cache(1, s)
    q1 = q[:1].contiguous()
    out = DA.decode_attention(q1, k, v, s, window=window)
    again = DA.decode_attention(q1, k, v, s, window=window)
    plain = ref.decode_attention_ref(q1, k, v, full[:1], window=window)
    torch.cuda.synchronize()
    assert torch.equal(out, again), "B8's split path is not deterministic"
    err_long, worst_long = held(out, plain)
    long_ms = cuda_ms(lambda: DA.decode_attention(q1, k, v, s, window=window),
                      50)
    long_bound, _ = bound_ms(n_bytes(1, full[:1], window)[0], 0)
    splits = DA.splits_for(dev, hkv, s)
    del k, v, out, again, plain
    torch.cuda.empty_cache()
    return dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:66",
        max_abs_err=err, share_of_bf16_ulp_limit=worst,
        f32_q_max_abs_err=err32, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, cache_bytes=nb,
        library_ms=lib_ms, library_max_abs_err=lib_err,
        ragged=dict(max_abs_err=err_ragged,
                    share_of_bf16_ulp_limit=worst_ragged, ms=ragged_ms,
                    bound_ms=ragged_bound),
        long_500k=dict(max_abs_err=err_long,
                       share_of_bf16_ulp_limit=worst_long, ms=long_ms,
                       bound_ms=long_bound, splits=splits))


def check_small_fit(torch):
    """The whole path at a small size: the CUDA fit against the CPU fit
    (plain versions), same data and injected sketches, predictions within
    atol 1e-4."""
    import numpy as np
    from repro_torch.core.boosting import GBDTConfig, SketchBoost
    from repro_torch.data.pipeline import make_tabular
    X, y = make_tabular("multiclass", 3000, 12, 8, seed=3, n_informative=12)
    rng = np.random.default_rng(0)
    pis = [rng.normal(size=(8, 3)).astype(np.float32) / np.sqrt(3.0)
           for _ in range(6)]
    cfg = GBDTConfig(n_trees=6, depth=4, sketch_k=3, min_data_in_leaf=20,
                     early_stopping_rounds=2)
    fits = [SketchBoost(cfg, device=dev).fit(
        X[:2400], y[:2400], eval_set=(X[2400:], y[2400:]), sketch_mats=pis)
        for dev in ("cuda", "cpu")]
    pred = [f.predict_raw(X[2400:]).cpu() for f in fits]
    err = float((pred[0] - pred[1]).abs().max())
    assert err <= 1e-4, f"CUDA fit differs from CPU fit by {err}"
    assert fits[0].best_round == fits[1].best_round
    return err


def profile_rounds(torch, model, dev, Xtr, ytr, Xev, yev, rounds=2,
                   tag="[6]", b2_keys=B2_KERNELS):
    """Where a full-width round's time goes: ``rounds`` more rounds of the
    fitted model's loop body (``boosting.boost_round`` plus the eval
    update and loss) under ``torch.profiler``, after the path's counts
    were read.  Prints device time by kernel, B2's device time (the
    kernels named in ``b2_keys``) and its share, and the device's busy time
    over the wall time of those rounds, and returns them."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import boosting as BO
    from repro_torch.core import losses as L
    cfg = model.cfg
    loss = L.get_loss(cfg.loss)
    codes, codes_t = model._codes(Xtr)
    codes_v, _ = model._codes(Xev)
    Y, Yv = model._targets(ytr), model._targets(yev)
    F = model.base_score.expand(len(Xtr), -1).contiguous()
    Fv = model.base_score.expand(len(Xev), -1).contiguous()
    gen = torch.Generator(device=dev).manual_seed(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            tree = BO.boost_round(F, codes, codes_t, Y, cfg, generator=gen)
            Fv = BO._apply_tree(tree, codes_v, Fv, cfg)
            float(loss.value(Fv, Yv))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    b2 = [e for e in events if any(k in e.key for k in b2_keys)]
    b2_s = sum(e.self_device_time_total for e in b2) / 1e6
    print(f"{tag} profiled {rounds} rounds (profiler on): wall {wall:.4f} "
          f"s, device busy {busy:.4f} s = {busy / wall:.3f} of wall; B2 "
          f"{b2_s * 1e3:.3f} ms = {b2_s / busy:.4f} of device time in "
          f"{sum(e.count for e in b2)} launches of {len(b2)} kernels")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:14]
    for e in top:
        print(f"{tag}   {e.self_device_time_total / 1e3:10.3f} ms "
              f"x{e.count:<5d} {e.key[:90]}")
    return dict(rounds=rounds, wall_s=wall, device_busy_s=busy,
                b2_s=b2_s, b2_share=b2_s / busy,
                b2_ms=[[e.key[:90], e.self_device_time_total / 1e3, e.count]
                       for e in b2],
                top_ms=[[e.key[:90], e.self_device_time_total / 1e3, e.count]
                        for e in top])


def engines_phase(torch, dev, Xtr, ytr, Xev, yev, cfg, kernels, rounds=3):
    """Phase 9: the histogram engines and the sketch methods at full width
    on phase 4's data, and one profiled round of SketchBoost Full.  Returns
    the record and the kernel launches of the direct engine's fit and of
    Full's (counts set to zero just before each)."""
    import dataclasses

    from repro_torch.core import sketch as SK
    from repro_torch.core.boosting import SketchBoost
    gen = torch.Generator(device=dev).manual_seed(9)
    pis = [SK.random_projection_matrix(cfg.n_outputs, cfg.sketch_k, gen,
                                       device=dev).cpu().numpy()
           for _ in range(rounds)]

    def run(n_rounds, draws=None, **kw):
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated() / 2 ** 30
        c = dataclasses.replace(cfg, n_trees=n_rounds, **kw)
        model = SketchBoost(c, device=dev).fit(
            Xtr, ytr, eval_set=(Xev, yev), sketch_mats=draws)
        torch.cuda.synchronize()
        times = [h["train_time_s"] for h in model.history]
        return model, dict(
            round_s=[b - a for a, b in zip([0.0] + times[:-1], times)],
            valid_loss=[h["valid_loss"] for h in model.history],
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            resident_before_gib=resident,
            launches={k.name: k.launches for k in kernels})

    rec, models = {}, {}
    for engine in ("direct", "partition", "subtract"):
        models[engine], rec[engine] = run(rounds, pis, hist_engine=engine)
        assert models[engine].cfg.hist_engine == engine
        print(f"[9] hist_engine={engine}: seconds per round "
              f"{rec[engine]['round_s']}, valid loss "
              f"{rec[engine]['valid_loss']}, peak "
              f"{rec[engine]['peak_gib']:.2f} GiB ("
              f"{rec[engine]['resident_before_gib']:.2f} resident before), "
              f"launches "
              f"{rec[engine]['launches']}")
    direct_launches = rec["direct"]["launches"]
    assert direct_launches["hist_direct"] == cfg.depth * rounds, \
        direct_launches
    assert direct_launches["hist_nodes"] == 0, direct_launches
    ref_loss = rec["direct"]["valid_loss"]
    heap = models["direct"].forest
    for engine in ("partition", "subtract"):
        rel = max(abs(a - b) / abs(b)
                  for a, b in zip(rec[engine]["valid_loss"], ref_loss))
        f = models[engine].forest
        differ = int(((f.feat != heap.feat) | (f.thr != heap.thr)).sum())
        rec[engine].update(valid_loss_rel_to_direct=rel,
                           split_nodes_differing=differ)
        print(f"[9] {engine} vs direct: valid loss within {rel!r} relative "
              f"(limit 1e-4); {differ} of {heap.feat.numel()} split nodes "
              f"differ (ties are legal)")
        assert rel <= 1e-4, (engine, rel)
    del models, heap
    for method, n_rounds in (("top_outputs", rounds),
                             ("random_sampling", rounds),
                             ("truncated_svd", rounds), ("none", 2)):
        model, r = run(n_rounds, sketch_method=method)
        rec[method] = r
        assert all(math.isfinite(v) for v in r["valid_loss"]), (method, r)
        print(f"[9] sketch_method={method}: seconds per round "
              f"{r['round_s']}, valid loss {r['valid_loss']}, peak "
              f"{r['peak_gib']:.2f} GiB ({r['resident_before_gib']:.2f} "
              f"resident before), launches {r['launches']}")
    full_launches = rec["none"]["launches"]
    assert full_launches["split_scan_wide"] == cfg.depth * 2, full_launches
    # Full's d + 1 = 513 channels go in one B1 launch a level.
    assert full_launches["hist_nodes"] == cfg.depth * 2, full_launches
    assert full_launches["split_scan"] == 0, full_launches
    assert direct_launches["split_scan_wide"] == 0, direct_launches
    rec["none"]["profile"] = profile_rounds(torch, model, dev, Xtr, ytr, Xev,
                                            yev, rounds=1, tag="[9] Full:",
                                            b2_keys=B2_WIDE_KERNELS)
    return rec, direct_launches, full_launches


def same_leaves(torch, ids_a, ids_b) -> bool:
    """Whether two forests put the rows into the same leaves, tree by
    tree: ``(n, T)`` leaf ids whose pairs map one to one."""
    for t in range(ids_a.shape[1]):
        a, b = ids_a[:, t].long(), ids_b[:, t].long()
        pairs = torch.unique(a * (int(b.max()) + 1) + b).numel()
        if not pairs == torch.unique(a).numel() == torch.unique(b).numel():
            return False
    return True


def count_syncs(torch, fn, out):
    """Run ``fn()`` with CUDA's sync debug mode warning at every host
    sync, append the number of those warnings to ``out`` and return
    ``fn()``'s result."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(1)
        try:
            result = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    out.append(sum("synchroniz" in str(w.message) for w in caught))
    return result


def leafwise_phase(torch, dev, Xtr, ytr, Xev, yev, cfg, kernels, rounds=3):
    """Phase 9b: leaf-wise growth, bf16 statistics and staged prediction
    at full width on phase 4's data, 3 rounds a fit with one set of
    per-round Pi.  Returns the record and the kernel launches of the
    bf16 fits (counts set to zero just before each fit)."""
    import dataclasses

    from repro_torch import explain as EX
    from repro_torch.core import boosting as BO
    from repro_torch.core import forest as FO
    from repro_torch.core import sketch as SK
    from repro_torch.core import tree as TR
    from repro_torch.core.boosting import SketchBoost
    gen = torch.Generator(device=dev).manual_seed(19)
    pis = [SK.random_projection_matrix(cfg.n_outputs, cfg.sketch_k, gen,
                                       device=dev).cpu().numpy()
           for _ in range(rounds)]

    def run(**kw):
        """A fit, each tree's grower run under CUDA's sync debug mode so
        that its host syncs (reads of the card, blocking copies) are
        counted tree by tree."""
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        c = dataclasses.replace(cfg, n_trees=rounds, **kw)
        name = ("grow_tree_leafwise" if c.growth == "leafwise"
                else "grow_tree")
        grower, syncs = getattr(TR, name), []
        setattr(TR, name, lambda *a, **k: count_syncs(
            torch, lambda: grower(*a, **k), syncs))
        try:
            model = SketchBoost(c, device=dev).fit(
                Xtr, ytr, eval_set=(Xev, yev), sketch_mats=pis)
        finally:
            setattr(TR, name, grower)
        torch.cuda.synchronize()
        times = [h["train_time_s"] for h in model.history]
        nc = (model.packed.node_count.tolist()
              if c.growth == "leafwise" else None)
        return model, dict(
            round_s=[b - a for a, b in zip([0.0] + times[:-1], times)],
            valid_loss=[h["valid_loss"] for h in model.history],
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            launches={k.name: k.launches for k in kernels}, node_count=nc,
            host_syncs_per_tree=syncs)

    def show(tag, r):
        print(f"[9b] {tag}: seconds per round {r['round_s']}, valid loss "
              f"{r['valid_loss']}, peak {r['peak_gib']:.2f} GiB, launches "
              f"{r['launches']}, node counts {r['node_count']}, host syncs "
              f"per tree (measured) {r['host_syncs_per_tree']}")

    rec = {}
    # (a) leaf-wise at the full budget = level-wise subtract, bit for bit.
    lvl, rec["levelwise"] = run(hist_engine="subtract")
    lw64, rec["leafwise_64"] = run(growth="leafwise",
                                   max_leaves=2 ** cfg.depth)
    show("levelwise subtract", rec["levelwise"])
    show(f"leafwise max_leaves={2 ** cfg.depth}", rec["leafwise_64"])
    codes_tr = lvl._bin(Xtr)
    same = same_leaves(torch, EX.apply_forest(lvl.packed, codes_tr),
                       EX.apply_forest(lw64.packed, codes_tr))
    raw_lvl, raw_lw = lvl.predict_raw(Xev), lw64.predict_raw(Xev)
    bitwise = bool(torch.equal(raw_lvl, raw_lw))
    print(f"[9b] (a) leaf-wise at {2 ** cfg.depth} leaves vs level-wise: "
          f"same rows in every tree {same}, eval predictions bitwise equal "
          f"{bitwise}, valid losses equal "
          f"{rec['levelwise']['valid_loss'] == rec['leafwise_64']['valid_loss']}")
    assert same and bitwise, "leaf-wise at the full budget is not level-wise"
    del lw64, raw_lw
    # (b) leaf-wise under budget.
    lw32, rec["leafwise_32"] = run(growth="leafwise", max_leaves=32)
    show("(b) leafwise max_leaves=32", rec["leafwise_32"])
    assert rec["leafwise_32"]["launches"]["hist_nodes"] > 0
    assert all(math.isfinite(v) for v in rec["leafwise_32"]["valid_loss"])
    assert len(rec["leafwise_32"]["host_syncs_per_tree"]) == rounds
    # (c) bf16 statistics, both growth modes, the fp32 fits' Pi.
    bf16_launches = {}
    for tag, kw, fp32_model, fp32_rec in (
            ("levelwise", dict(hist_engine="subtract"), lvl,
             rec["levelwise"]),
            ("leafwise_32", dict(growth="leafwise", max_leaves=32), lw32,
             rec["leafwise_32"])):
        m16, r = run(hist_dtype="bfloat16", **kw)
        rec[f"{tag}_bf16"] = r
        bf16_launches[tag] = r["launches"]
        a, b = m16.forest, fp32_model.forest
        differ = (a.feat != b.feat) | (a.thr != b.thr)
        if tag != "levelwise":
            differ |= a.left != b.left
        rel = max(abs(x - y) / abs(y) for x, y in
                  zip(r["valid_loss"], fp32_rec["valid_loss"]))
        r.update(split_nodes_differing=int(differ.sum()),
                 valid_loss_rel_to_fp32=rel)
        show(f"(c) {tag} bf16", r)
        print(f"[9b] (c) {tag}: bf16 valid loss {r['valid_loss']} beside "
              f"fp32 {fp32_rec['valid_loss']}, within {rel!r} relative "
              f"(limit 1e-3); {int(differ.sum())} of {differ.numel()} node "
              f"slots split differently (near-ties may flip)")
        assert r["launches"]["hist_nodes_bf16"] > 0, r["launches"]
        assert r["launches"]["hist_nodes"] == 0, r["launches"]
        # Leaf values come from the full float32 gradients, so bf16 moves
        # the loss only through the splits: a near-tie closer than bf16's
        # 2^-8 rounding may flip, trading one split for another of nearly
        # equal gain.  1e-3 of the loss is a few percent of what a round
        # gains here; B1-bf16's sums themselves are held bitwise in phase 3.
        assert rel <= 1e-3, (tag, rel)
        del m16
    # (d) staged prediction of (b)'s model on the eval set.
    codes_v = lw32._bin(Xev)
    Yv = lw32._targets(yev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    staged = FO.predict_staged(lw32.packed, codes_v)
    torch.cuda.synchronize()
    staged_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    vloss = FO.staged_eval(lw32.packed, codes_v, Yv, cfg.loss)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    hist = torch.tensor(rec["leafwise_32"]["valid_loss"])
    err = float(((vloss.cpu() - hist).abs() / hist.abs()).max())
    last_bitwise = bool(torch.equal(staged[-1], lw32.predict_raw(Xev)))
    rec["staged"] = dict(predict_staged_s=staged_s, staged_eval_s=eval_s,
                         staged_eval_rel_to_history=err,
                         last_bitwise_predict_raw=last_bitwise)
    print(f"[9b] (d) predict_staged {tuple(staged.shape)} in {staged_s:.4f} "
          f"s, staged_eval in {eval_s:.4f} s, within {err!r} relative of the "
          f"fit's history (limit 1e-5), staged[-1] bitwise predict_raw "
          f"{last_bitwise}")
    assert err <= 1e-5 and last_bitwise
    del staged
    # (e) one leaf-wise round under the profiler, and the host syncs of
    # one more round (CUDA's sync debug mode warns at each).
    codes, codes_t = lw32._codes(Xtr)
    Y = lw32._targets(ytr)
    F = lw32.base_score.expand(len(Xtr), -1).contiguous()
    c = lw32.cfg
    gen = torch.Generator(device=dev).manual_seed(2)
    prof = profile_step(
        torch, lambda: BO.boost_round(F, codes, codes_t, Y, c,
                                      generator=gen),
        "hist_nodes_kernel<float>", extra_keys=B2_KERNELS)
    torch.cuda.synchronize()
    counted = []
    tree = count_syncs(torch, lambda: BO.boost_round(
        F, codes, codes_t, Y, c, generator=gen), counted)
    syncs = counted[0]
    prof.update(host_syncs_per_round=syncs,
                node_count=int(tree.node_count),
                b2_s=sum(prof["by_key"][k] for k in B2_KERNELS),
                b2_share=sum(prof["by_key"][k] for k in B2_KERNELS)
                / prof["device_busy_s"])
    rec["profile"] = prof
    print(f"[9b] (e) one leaf-wise round (max_leaves=32) profiled: wall "
          f"{prof['wall_s']:.4f} s, device busy {prof['device_busy_s']:.4f} "
          f"s = {prof['busy_share']:.3f}, B1 {prof['kernel_s']:.4f} s = "
          f"{prof['kernel_share']:.3f} of device time, B2 "
          f"{prof['b2_s']:.4f} s = {prof['b2_share']:.3f}; host syncs in "
          f"one more round {syncs} ({int(tree.node_count)} nodes)")
    for name, ms, count in prof["top_ms"]:
        print(f"[9b]   {ms:10.3f} ms x{count:<5d} {name}")
    del lw32, lvl, codes, codes_t, F, Y, codes_tr
    return rec, bf16_launches


def ova_phase(torch, dev, Xtr, ytr, Xev, yev, cfg, kernels, engines):
    """Phase 9c: ``strategy="one_vs_all"`` at full width on phase 4's data
    (d = 512 univariate trees a round, in groups of `OVA_TREES`): (a)
    level-wise "subtract", 2 rounds, and one profiled round; (b) leaf-wise
    at ``max_leaves=32``, 1 round, its host syncs counted; (c) at a reduced
    size, the card against the CPU, and leaf-wise at 64 leaves against
    level-wise on the card.  Returns the record and the kernel launches of
    (a) (counts set to zero just before it)."""
    import dataclasses

    from repro_torch import explain as EX
    from repro_torch.core import boosting as BO
    from repro_torch.core import tree as TR
    from repro_torch.core.boosting import GBDTConfig, SketchBoost
    groups = len(TR.ova_groups(cfg.n_outputs, len(Xtr)))
    ova = dataclasses.replace(cfg, strategy="one_vs_all")

    def run(n_rounds, syncs=None, **kw):
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        c = dataclasses.replace(ova, n_trees=n_rounds, **kw)
        name = ("grow_trees_leafwise" if c.growth == "leafwise"
                else "grow_trees_levelwise")
        grower = getattr(TR, name)
        if syncs is not None:
            setattr(TR, name, lambda *a, **k: count_syncs(
                torch, lambda: grower(*a, **k), syncs))
        try:
            model = SketchBoost(c, device=dev).fit(Xtr, ytr,
                                                   eval_set=(Xev, yev))
        finally:
            setattr(TR, name, grower)
        torch.cuda.synchronize()
        times = [h["train_time_s"] for h in model.history]
        return model, dict(
            round_s=[b - a for a, b in zip([0.0] + times[:-1], times)],
            valid_loss=[h["valid_loss"] for h in model.history],
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            launches={k.name: k.launches for k in kernels})

    rec = {"groups": groups, "trees_per_group": -(-cfg.n_outputs // groups)}
    # (a) level-wise subtract at full width.
    model, r = run(2)
    rec["levelwise"] = r
    launches = r["launches"]
    print(f"[9c] (a) one_vs_all levelwise subtract, d={cfg.n_outputs} in "
          f"{groups} groups: seconds per round {r['round_s']}, valid loss "
          f"{r['valid_loss']}, peak {r['peak_gib']:.2f} GiB, launches "
          f"{launches}")
    assert all(math.isfinite(v) for v in r["valid_loss"])
    # One B1 and one B2 launch a level for each group, not each tree.
    assert launches["hist_nodes"] == cfg.depth * groups * 2, launches
    assert launches["split_scan"] == cfg.depth * groups * 2, launches
    assert launches["forest_traverse"] == 2, launches
    codes, codes_t = model._codes(Xtr)
    Y = model._targets(ytr)
    F = model.base_score.expand(len(Xtr), -1).contiguous()
    prof = profile_step(
        torch, lambda: BO.boost_round(F, codes, codes_t, Y, model.cfg),
        "hist_nodes_kernel<float>", extra_keys=B2_KERNELS)
    b2_s = sum(prof["by_key"][k] for k in B2_KERNELS)
    other = prof["device_busy_s"] - prof["kernel_s"] - b2_s
    prof.update(b2_s=b2_s, b2_share=b2_s / prof["device_busy_s"],
                torch_ops_s=other,
                torch_ops_share=other / prof["device_busy_s"])
    rec["profile"] = prof
    print(f"[9c] (a) one round profiled: wall {prof['wall_s']:.4f} s, "
          f"device busy {prof['device_busy_s']:.4f} s = "
          f"{prof['busy_share']:.3f} of wall; B1 {prof['kernel_s']:.4f} s = "
          f"{prof['kernel_share']:.3f}, B2 {b2_s:.4f} s = "
          f"{prof['b2_share']:.4f}, the partition, gather and leaf passes "
          f"(PyTorch's kernels) {other:.4f} s = {prof['torch_ops_share']:.3f} "
          f"of device time")
    for name, ms, count in prof["top_ms"]:
        print(f"[9c]   {ms:10.3f} ms x{count:<5d} {name}")
    med = statistics.median
    cols = {"one_vs_all": med(r["round_s"]),
            "full": med(engines["none"]["round_s"]),
            "random_projection": med(engines["subtract"]["round_s"])}
    rec["paper_columns_round_s"] = cols
    print(f"[9c] (a) seconds per round (median), the paper's three columns "
          f"at d={cfg.n_outputs}: one_vs_all {cols['one_vs_all']:.4f}, "
          f"SketchBoost Full {cols['full']:.4f}, random_projection k="
          f"{cfg.sketch_k} {cols['random_projection']:.4f}")
    del model, codes, codes_t, Y, F
    gc.collect()
    torch.cuda.empty_cache()
    # (b) leaf-wise at 32 leaves, one round, host syncs counted.
    syncs = []
    model, r = run(1, syncs=syncs, growth="leafwise", max_leaves=32)
    r.update(host_syncs_per_group=syncs,
             host_syncs_per_round=sum(syncs),
             node_count_mean=float(model.packed.node_count.float().mean()))
    rec["leafwise_32"] = r
    print(f"[9c] (b) one_vs_all leafwise max_leaves=32: seconds per round "
          f"{r['round_s']}, valid loss {r['valid_loss']}, peak "
          f"{r['peak_gib']:.2f} GiB, launches {r['launches']}, host syncs "
          f"a round {sum(syncs)} ({syncs} a group), mean node count "
          f"{r['node_count_mean']}")
    assert 0 < r["launches"]["hist_nodes"] <= 32 * groups, r["launches"]
    assert math.isfinite(r["valid_loss"][0])
    del model
    gc.collect()
    torch.cuda.empty_cache()
    # (c) a reduced size: the card against the CPU, and leaf-wise at the
    # full budget against level-wise on the card.  Regression targets: a
    # multiclass tree's first gradients take two values, so splits tie in
    # exact arithmetic and B2 (gains within rtol 1e-5 of its plain version)
    # may break a tie otherwise than the CPU; the multiclass fit is
    # compared too, and its differences printed.
    n, nv, d = 65_536, 16_384, 16
    X, y = make_data(torch, dev, n + nv, 100, d, seed=7,
                     task="multitask_mse")
    small = GBDTConfig(loss="multitask_mse", strategy="one_vs_all",
                       n_trees=3, depth=6, early_stopping_rounds=2)
    fit = {}
    for dv in ("cuda", "cpu"):
        t0 = time.perf_counter()
        fit[dv] = SketchBoost(small, device=dv).fit(
            X[:n], y[:n], eval_set=(X[n:], y[n:]))
        fit[dv + "_s"] = time.perf_counter() - t0
    pred = [fit[dv].predict_raw(X[n:]).cpu() for dv in ("cuda", "cpu")]
    err = float((pred[0] - pred[1]).abs().max())
    again = SketchBoost(small, device=dev).fit(X[:n], y[:n],
                                               eval_set=(X[n:], y[n:]))
    rerun_bitwise = bool(torch.equal(again.predict_raw(X[n:]).cpu(),
                                     pred[0]))
    lw = SketchBoost(dataclasses.replace(small, growth="leafwise",
                                         max_leaves=64), device=dev).fit(
        X[:n], y[:n], eval_set=(X[n:], y[n:]))
    codes_small = fit["cuda"]._bin(X[:n])
    same = same_leaves(torch, EX.apply_forest(fit["cuda"].packed,
                                              codes_small),
                       EX.apply_forest(lw.packed, codes_small))
    bitwise = bool(torch.equal(lw.predict_raw(X[n:]),
                               fit["cuda"].predict_raw(X[n:])))
    rec["small"] = dict(rows=n, d=d, card_vs_cpu_max_abs=err,
                        best_round=[fit["cuda"].best_round,
                                    fit["cpu"].best_round],
                        card_s=fit["cuda_s"], cpu_s=fit["cpu_s"],
                        rerun_bitwise=rerun_bitwise,
                        leafwise64_same_leaves=same,
                        leafwise64_eval_bitwise=bitwise)
    print(f"[9c] (c) {n} x 100, d={d}, depth 6, 3 rounds, multitask_mse: "
          f"fit {fit['cuda_s']:.3f} s on the card, {fit['cpu_s']:.3f} s on "
          f"the CPU; card vs CPU max |diff| {err!r} (limit 1e-4), best rounds "
          f"{rec['small']['best_round']}, a second card fit bitwise "
          f"{rerun_bitwise}; leaf-wise at 64 leaves vs level-wise: same "
          f"rows in every tree {same}, eval predictions bitwise {bitwise}")
    assert err <= 1e-4, f"one_vs_all on the card differs from the CPU: {err}"
    assert fit["cuda"].best_round == fit["cpu"].best_round
    assert rerun_bitwise, "one_vs_all on the card is not the same run to run"
    assert same and bitwise, "leaf-wise at the full budget is not level-wise"
    del fit, again, lw, X, y, codes_small
    Xc, yc = make_data(torch, dev, n + nv, 100, d, seed=7)
    mc = dataclasses.replace(small, loss="multiclass")
    fits = [SketchBoost(mc, device=dv).fit(Xc[:n], yc[:n],
                                           eval_set=(Xc[n:], yc[n:]))
            for dv in ("cuda", "cpu")]
    a, b = fits[0].packed, fits[1].packed
    differ = int(((a.feat.cpu() != b.feat) | (a.thr.cpu() != b.thr)).sum())
    losses = [[h["valid_loss"] for h in f.history] for f in fits]
    rec["small_multiclass"] = dict(
        split_nodes_differing=differ, valid_loss=losses,
        max_abs=float((fits[0].predict_raw(Xc[n:]).cpu()
                       - fits[1].predict_raw(Xc[n:])).abs().max()))
    print(f"[9c] (c) multiclass, the same sizes: {differ} of "
          f"{a.feat.numel()} node slots split differently on the card and "
          f"the CPU (ties of two-valued gradients), valid losses {losses}, "
          f"max |diff| {rec['small_multiclass']['max_abs']!r}")
    del fits, a, b, Xc, yc
    gc.collect()
    torch.cuda.empty_cache()
    return rec, launches


def make_data(torch, dev, n, m, d, seed, task="multiclass"):
    """Guyon-scheme multiclass table on the card (make_tabular's recipe);
    with ``task="multitask_mse"`` the targets are the d noisy logits."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    ni = max(m // 10, 2)
    nc = min(2 * ni, max(m - ni, 0))
    base = torch.randn((n, ni), generator=gen, device=dev)
    combo = base @ torch.randn((ni, nc), generator=gen, device=dev)
    rest = torch.randn((n, m - ni - nc), generator=gen, device=dev)
    X = torch.cat([base, combo, rest], 1)
    W = torch.randn((ni, d), generator=gen, device=dev)
    mse = task == "multitask_mse"
    y = torch.empty((n, d) if mse else n,
                    dtype=torch.float32 if mse else torch.int64, device=dev)
    for s in range(0, n, 1 << 18):                 # logits in slices
        e = min(s + (1 << 18), n)
        logits = base[s:e] @ W + 0.5 * torch.randn(
            (e - s, d), generator=gen, device=dev)
        y[s:e] = logits if mse else logits.argmax(1)
    return X.cpu().numpy(), (y if mse else y.to(torch.int32)).cpu().numpy()


def serve_phase(torch, model, dev, Xte, raw, kernels):
    """Phase 7: the serving path on the card, from a checkpoint of the
    fitted model.  Returns the serving record, the kernel launches of this
    phase (counts set to zero just before it) and the servers."""
    import numpy as np

    from repro_torch.core import forest as FO
    from repro_torch.core import quantize as Q
    from repro_torch.io.checkpoint import save_forest_checkpoint
    from repro_torch.launch import serve as LS
    from repro_torch.training.serve_lib import ForestServer
    variants = {"float32": dict(quantize="none"),
                "int8": dict(quantize="int8"),
                "bfloat16": dict(quantize="bfloat16"),
                "int8_pruned": dict(quantize="int8", prune_alpha=0.0)}
    rng = np.random.default_rng(0)
    requests = [rng.normal(size=(32, Xte.shape[1])).astype(np.float32)
                for _ in range(512)]
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    for k in kernels:
        k.launches = 0
    record = {}
    t0 = time.perf_counter()
    save_forest_checkpoint(ckpt, model.packed, model.quantizer,
                           metadata={"loss": model.cfg.loss,
                                     "best_iteration": model.best_iteration})
    print(f"[7] checkpoint of {model.packed.n_trees} trees written in "
          f"{time.perf_counter() - t0:.3f} s")
    servers = {}
    for name, kw in variants.items():
        t0 = time.perf_counter()
        srv = ForestServer.from_checkpoint(ckpt, device=dev, **kw)
        servers[name] = srv
        load_s = time.perf_counter() - t0
        print(f"[7] {name}: loaded + compressed in {load_s:.3f} s, "
              f"compression {srv.compression}")
        # (b) the request stream of launch/serve.py: 512 x 32 rows, windows
        # of 8 requests.
        stream = LS.drive_stream(srv, requests, 8)
        # (c) one streamed 262,144-row batch in chunks of max_batch, double
        # buffered (raw features staged chunk by chunk), against the same
        # server without double buffering, timed in turns.
        big = {db: ForestServer.from_checkpoint(
            ckpt, device=dev, max_batch=4096, double_buffer=db, **kw)
            for db in (False, True)}
        secs, out = {False: [], True: []}, {}
        for db in (False, True):
            big[db].predict_raw(Xte[:8192])                 # warm up
        for db in (False, True, True, False, False, True):
            t0 = time.perf_counter()
            out[db] = big[db].predict_raw(Xte)
            secs[db].append(time.perf_counter() - t0)
        assert big[True].stats["pipelined_batches"] == 4
        assert big[False].stats["pipelined_batches"] == 0
        assert torch.equal(out[True], out[False]), \
            f"{name}: double-buffered batch differs"
        if name == "float32":        # (d) the fp32 server is the model
            assert torch.equal(out[True], raw), "fp32 server != model"
        del big, out
        record[name] = dict(
            stream, load_s=load_s, compression=srv.compression,
            streamed_rows_per_s=[len(Xte) / t for t in secs[True]],
            streamed_plain_rows_per_s=[len(Xte) / t for t in secs[False]])
        print(f"[7] {name}: stream {stream['rows_per_s']:.1f} rows/s, p50 "
              f"{stream['p50_ms']:.4f} ms, p99 {stream['p99_ms']:.4f} ms per "
              f"request; streamed batch {len(Xte)} rows, rows/s: "
              f"double-buffered {record[name]['streamed_rows_per_s']}, plain "
              f"{record[name]['streamed_plain_rows_per_s']}")

    # (d) exactness on 4,096 held-out rows (one padded bucket).
    Xs = Xte[:4096]
    fp32 = servers["float32"].predict_raw(Xs)
    assert torch.equal(fp32, raw[:4096]), "fp32 server != model.predict_raw"
    for name in ("int8", "bfloat16", "int8_pruned"):
        srv = servers[name]
        codes = srv._codes(Xs)
        got = srv.predict_codes(codes)
        twin = FO.predict_raw(Q.dequantize_forest(srv.packed), codes)
        assert torch.equal(got, twin), f"{name} != B3 on its dequantized twin"
    int8 = servers["int8"].predict_raw(Xs)
    lr = float(servers["int8"].packed.lr)
    bound = lr * float(servers["int8"].packed.leaf_scale.sum()) / 2 + 1e-5
    err = float((int8 - fp32).abs().max())
    print(f"[7] int8 vs float32: max |diff| {err!r} <= bound {bound!r}; "
          f"bfloat16 vs float32: max |diff| "
          f"{float((servers['bfloat16'].predict_raw(Xs) - fp32).abs().max())!r}")
    assert err <= bound, (err, bound)

    # (e) the overload drill of launch/serve.py, on the card.
    drill = LS.chaos_drill(ckpt, device=dev)
    st = drill["stats"]
    assert drill["ok"] and st["shed_requests"] == 2 \
        and st["deadline_requests"] == 1 and st["fallback_batches"] >= 1 \
        and st["errors"] == 0, drill
    record["chaos"] = {k: st[k] for k in ("shed_requests", "deadline_requests",
                                          "fallback_batches", "errors")}
    shutil.rmtree(ckpt)
    launches = {k.name: k.launches for k in kernels}
    print(f"[7] launches in the serving phase: {launches}")

    # Device time of one window of the stream (256 rows, one bucket) and of
    # its traversal alone, after the counts were read.  Then the cost of
    # bucket padding: a window of 8 x 33 rows (264, padded to 512) through
    # the server's stream, and its traversal on the card padded and not.
    window = np.concatenate(requests[:8])
    odd = [np.concatenate([r, r[:1]]) for r in requests[:256]]
    for name, srv in servers.items():
        codes = srv._codes(window)
        rec = record[name]
        rec["window_bin_traverse_ms"] = cuda_ms(
            lambda: FO.predict_raw(srv.packed, srv._codes(window)), 20)
        rec["window_traverse_ms"] = cuda_ms(
            lambda: FO.predict_raw(srv.packed, codes), 20)
        print(f"[7] {name}: one 256-row window on the card: traversal "
              f"{rec['window_traverse_ms']:.4f} ms, binning + traversal "
              f"{rec['window_bin_traverse_ms']:.4f} ms")
        rec["stream_33"] = LS.drive_stream(srv, odd, 8)
        codes = srv._codes(np.concatenate(odd[:8]))
        padded = torch.nn.functional.pad(codes, (0, 0, 0, 512 - 264))
        rec["window_264_traverse_ms"] = cuda_ms(
            lambda: FO.predict_raw(srv.packed, codes), 20)
        rec["window_264_padded_traverse_ms"] = cuda_ms(
            lambda: FO.predict_raw(srv.packed, padded), 20)
        print(f"[7] {name}: 8 x 33-row stream {rec['stream_33']}; one "
              f"264-row window's traversal {rec['window_264_traverse_ms']:.4f}"
              f" ms, padded to 512 rows "
              f"{rec['window_264_padded_traverse_ms']:.4f} ms")
    return record, launches, servers


def explain_phase(torch, model, dev, Xte, raw, pf_cpu, servers, kernels):
    """Phase 8: the explain path on the card, on the fitted model and on
    the float32 and int8 servers of phase 7.  Returns the record and the
    kernel launches of this phase (counts set to zero just before it)."""
    import numpy as np

    from repro_torch import explain as EX
    from repro_torch.launch import serve as LS
    for k in kernels:
        k.launches = 0
    rec = {}
    Xs = Xte[:4096]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    phi, base = model.shap_values(Xs, check_additivity=True)
    torch.cuda.synchronize()
    rec["shap_4096_s"] = time.perf_counter() - t0       # pack + check incl.
    assert phi.shape == (len(Xs), Xte.shape[1], model.cfg.n_outputs)
    assert bool(phi.isfinite().all())
    err = float((base + phi.sum(1) - raw[:4096]).abs().max())
    rec["local_accuracy_err"] = err
    print(f"[8] SHAP of 4,096 rows x {Xte.shape[1]} features x "
          f"{phi.shape[2]} outputs in {rec['shap_4096_s']:.4f} s (path pack "
          f"and additivity check included); max |base + sum(phi) - "
          f"predict_raw| {err!r} <= 1e-3")
    assert err <= 1e-3, err
    # 64 rows against the port on the CPU (the plain version).
    codes = model._bin(Xs)
    t0 = time.perf_counter()
    phi_c, base_c = EX.shap_values(pf_cpu, codes[:64].cpu())
    cpu_s = time.perf_counter() - t0
    d_phi = float((phi[:64].cpu() - phi_c).abs().max())
    d_base = float((base.cpu() - base_c).abs().max())
    rec.update(cpu_phi_err=d_phi, cpu_base_err=d_base,
               cpu_bitwise=bool(torch.equal(phi[:64].cpu(), phi_c)))
    print(f"[8] 64 rows against the CPU's plain version ({cpu_s:.2f} s): "
          f"max |diff| phi {d_phi!r}, base {d_base!r}, bitwise "
          f"{rec['cpu_bitwise']} (tolerance atol 1e-5 + rtol 1e-5)")
    torch.testing.assert_close(phi[:64].cpu(), phi_c, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(base.cpu(), base_c, atol=1e-5, rtol=1e-5)
    del phi, phi_c
    # Leaf ids against a walk on the CPU; importances of each kind.
    assert torch.equal(model.apply(Xs).cpu(),
                       EX.apply_forest(pf_cpu, codes.cpu())), "apply differs"
    for kind in EX.IMPORTANCE_KINDS:
        imp = model.feature_importances(kind)
        assert abs(float(imp.sum()) - 1.0) <= 1e-5, (kind, float(imp.sum()))
        top = torch.argsort(imp, descending=True)[:3].tolist()
        print(f"[8] {kind} importances sum {float(imp.sum())!r}, top "
              f"features {top}")
    # Interventional SHAP: 256 rows against 64 background rows.
    bg = Xte[-64:]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    phi, base = model.shap_values(Xte[:256], algorithm="interventional",
                                  background=bg)
    torch.cuda.synchronize()
    rec["interventional_256x64_s"] = time.perf_counter() - t0
    assert torch.equal(base, model.predict_raw(bg).mean(0)), "base differs"
    ierr = float((base + phi.sum(1) - raw[:256]).abs().max())
    rec["interventional_local_accuracy_err"] = ierr
    print(f"[8] interventional SHAP, 256 rows x 64 background rows, in "
          f"{rec['interventional_256x64_s']:.3f} s; base == mean background "
          f"prediction; max |base + sum(phi) - predict_raw| {ierr!r} <= 1e-3")
    assert ierr <= 1e-3, ierr
    del phi
    # The SHAP endpoint of the float32 and int8 servers: windows of 8
    # requests x 32 rows.
    rng = np.random.default_rng(1)
    requests = [rng.normal(size=(32, Xte.shape[1])).astype(np.float32)
                for _ in range(256)]
    for name in ("float32", "int8"):
        srv = servers[name]
        ex = LS.drive_explain(srv, requests, 8)
        last = ex.pop("last_window")
        phi = np.concatenate([p for p, _ in last])
        own = srv.predict_raw(np.concatenate(requests[-8:])).cpu().numpy()
        lerr = float(np.abs(last[0][1] + phi.sum(1) - own).max())
        rec[f"serve_{name}"] = dict(ex, local_accuracy_err=lerr)
        print(f"[8] {name} server SHAP endpoint: p50 {ex['p50_ms']:.3f} ms, "
              f"p99 {ex['p99_ms']:.3f} ms per request, "
              f"{ex['shap_rows_per_s']:.1f} rows/s in SHAP; local accuracy "
              f"against its own predictions {lerr!r} <= 1e-3")
        assert lerr <= 1e-3, (name, lerr)
    launches = {k.name: k.launches for k in kernels}
    print(f"[8] launches in the explain phase: {launches}")
    # Device time of one 256-row window's SHAP (B6 and the expected
    # values) on the float32 server, after the counts were read.
    srv = servers["float32"]
    codes = srv._codes(np.concatenate(requests[:8]))
    rec["window_shap_ms"] = cuda_ms(lambda: EX.shap_values(
        srv.explain_packed, codes, pack=srv._path_pack), 5)
    print(f"[8] float32: one 256-row window's SHAP on the card "
          f"{rec['window_shap_ms']:.4f} ms")
    return rec, launches


def profile_step(torch, fn, kernel_key: str, extra_keys=()):
    """Run ``fn()`` once under ``torch.profiler``: wall seconds, device
    busy seconds, the device seconds of the kernels whose name holds
    ``kernel_key`` (and, in ``by_key``, each of ``extra_keys``) and of the
    matmuls, and the top 12 kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    kernel_s = sum(e.self_device_time_total for e in events
                   if kernel_key in e.key) / 1e6
    mm_s = sum(e.self_device_time_total for e in events
               if any(n in e.key.lower() for n in
                      ("gemm", "gemv", "nvjet", "cutlass", "xmma"))) / 1e6
    by_key = {k: sum(e.self_device_time_total for e in events
                     if k in e.key) / 1e6 for k in extra_keys}
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    return dict(wall_s=wall, device_busy_s=busy, busy_share=busy / wall,
                by_key=by_key,
                kernels=sum(e.count for e in events),
                kernel_s=kernel_s, kernel_share=kernel_s / busy,
                matmul_s=mm_s,
                matmul_share=mm_s / busy,
                top_ms=[[e.key[:90], e.self_device_time_total / 1e3, e.count]
                        for e in top])


def prefill_phase(torch, dev, b7, kernels, arch="h2o-danube-3-4b",
                  mixes=((1, 32_768, 4), (8, 2_048, 2)), check_tokens=640):
    """Phase 10: the dense-LM prefill at full width.  ``arch`` in bf16 from
    a seeded ``torch.Generator`` on the card, then ``make_prefill_step``
    over requests from ``lm_batches(seed=0)`` for each mix (batch, tokens,
    requests; the first request of the first mix is untimed).  Every
    kernel count is set to 0 just before the requests and read just after;
    B7 must launch once a layer a request.  Then one more request of the
    first mix under ``torch.profiler`` (B7's share of device time), and
    the card-vs-CPU check: a 2-layer copy at full width in float32 with a
    256-token window, ``check_tokens`` tokens, on the card and through the
    port's plain path on the CPU, logits within 1e-4 max|logit|."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import lm_batches
    from repro_torch.models import lm
    from repro_torch.training.lm_serve import make_prefill_step
    cfg = get_config(arch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in lm._flatten(params).values())
    assert n_params == cfg.n_params(), (n_params, cfg.n_params())
    print(f"[10] {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim_}, d_ff "
          f"{cfg.d_ff}, window {cfg.window}; {n_params} parameters in "
          f"{cfg.dtype} made on the card in {time.perf_counter() - t0:.2f} s "
          f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB resident)")
    step = make_prefill_step(cfg)
    rec = {"arch": arch, "n_params": n_params}
    for k in kernels:
        k.launches = 0
    for i, (b, s, n_req) in enumerate(mixes):
        stream = lm_batches(cfg.vocab_size, b, s, seed=0)
        torch.cuda.reset_peak_memory_stats()
        times, next_tok = [], []
        for r in range(n_req):
            batch = next(stream)
            before = b7.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = step(params, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            assert b7.launches - before == cfg.n_layers, b7.launches
            assert logits.shape == (b, cfg.padded_vocab), logits.shape
            assert bool(logits.isfinite().all()), "prefill logits not finite"
            next_tok.append(logits.argmax(-1).tolist())
        timed = times[1:] if i == 0 else times
        ms = 1e3 * statistics.median(timed)
        mix = dict(batch=b, tokens=s, requests=n_req, request_s=times,
                   ms_per_request=ms, tokens_per_s=b * s / (ms / 1e3),
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   greedy_next_token=next_tok, logits_finite=True)
        rec[f"{b}x{s}"] = mix
        print(f"[10] prefill {b} x {s}: seconds a request {times} "
              f"({'first untimed, ' if i == 0 else ''}median "
              f"{ms:.2f} ms = {mix['tokens_per_s']:.0f} tokens/s), peak "
              f"{mix['peak_gib']:.2f} GiB, greedy next token {next_tok}, "
              f"logits finite")
    launches = {k.name: k.launches for k in kernels}
    print(f"[10] launches in the prefill phase: {launches}")
    b, s, _ = mixes[0]
    batch = next(lm_batches(cfg.vocab_size, b, s, seed=1))
    # Both bodies' names hold it: flash_attention_kernel (float32) and
    # tc::flash_attention_tc_kernel (bf16).
    prof = profile_step(torch, lambda: step(params, batch),
                        "flash_attention")
    assert prof["kernel_s"] > 0, "the prefill's profile holds no B7 kernel"
    print(f"[10] profiled prefill {b} x {s} (profiler on): wall "
          f"{prof['wall_s']:.4f} s, device busy {prof['device_busy_s']:.4f} s"
          f" = {prof['busy_share']:.3f} of wall; B7 {prof['kernel_s']:.4f} s"
          f" = {prof['kernel_share']:.3f} of device time")
    for key, t, count in prof["top_ms"]:
        print(f"[10]   {t:10.3f} ms x{count:<5d} {key}")
    rec["profile"] = dict(prof, b7_s=prof["kernel_s"],
                          b7_share=prof["kernel_share"])
    del params
    torch.cuda.empty_cache()

    small = dataclasses.replace(cfg, n_layers=2, dtype="float32", window=256)
    model = lm.TransformerLM.random(
        small, torch.Generator(device=dev).manual_seed(2))
    toks = next(lm_batches(cfg.vocab_size, 1, check_tokens, seed=2))
    on_card = model.forward(toks)
    on_cpu = model.to("cpu").forward(toks)
    scale = float(on_cpu.abs().max())
    err = float((on_card.cpu() - on_cpu).abs().max())
    print(f"[10] 2 layers at full width, float32, window 256, 1 x "
          f"{check_tokens} tokens: card vs CPU max |diff| {err!r}, max "
          f"|logit| {scale!r} (limit 1e-4 of it)")
    assert err <= 1e-4 * scale, (err, scale)
    rec["card_vs_cpu"] = dict(max_abs_diff=err, max_abs_logit=scale)
    return rec, launches


def decode_phase(torch, dev, b8, kernels, arch="h2o-danube-3-4b",
                 requests=(8, 128, 64),
                 mixes=(("decode_32k", 128, 32_768),
                        ("long_500k", 1, 524_288)), check_tokens=320):
    """Phase 11: the dense-LM decode at full width through
    ``lm_serve.make_serve_step`` over caches from ``lm.init_cache``.
    ``arch`` in bf16 from a seeded ``torch.Generator`` on the card.  Every
    kernel count is set to 0 just before (a) and read just after (c); B8
    must launch once a layer a step.
    (a) 8 prompts of 128 tokens from ``lm_batches(seed=0)`` fed through the
        cache token by token, then 64 greedy tokens (ms a step, tokens/s),
        and one more ``decode_step`` whose logits must be finite;
    (b) decode_32k: batch 128, ``max_seq_len`` 32,768 (a 4,096-slot ring,
        45 GiB of bf16 cache), filled at random at length 32,767; 1 untimed
        and 16 timed steps (ms a step, tokens/s, peak memory), then one
        profiled step (B8's and the matmuls' shares of device time, the
        device's busy share);
    (c) long_500k: batch 1 at length 524,287 over the same ring; 16 timed
        steps (ms a token) and one profiled.
    (d) A 2-layer float32 copy at full width with a 256-token window over
        ``check_tokens`` tokens (the ring wraps): decode logits at every
        position against ``forward``'s (B7) on the card, and against the
        CPU's decode, with a float32 cache, each within 1e-4 of the largest
        logit.  With the default bf16 cache: the CPU attending at every
        position over the card's cache bits (each layer's new k and v
        replaced by the card's before B8's plain version reads them) within
        1e-4 of it, and card against CPU, each running free, within 1e-3 of
        it.  A k or v whose float32 value differs in its last bits between
        the card's and the CPU's matmuls can round to the neighbouring bf16
        value (2^-8 relative) on one side only; the new values apart are
        counted.  Also printed: the CPU starting each step from the card's
        bits but attending over its own new k and v."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import lm_batches
    from repro_torch.models import layers as Ly
    from repro_torch.models import lm
    from repro_torch.training.lm_serve import ServeConfig, make_serve_step
    cfg = get_config(arch)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = lm.init(cfg, gen)
    torch.cuda.synchronize()
    print(f"[11] {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim_}, window "
          f"{cfg.window}; parameters in {cfg.dtype} made on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    rec = {"arch": arch}
    n_steps = 0

    def timed(step, cache, tokens, n):
        """n serve steps, each synchronised and timed; token i is
        ``tokens[i]`` while there are any, then the step's own output."""
        nonlocal n_steps
        times, tok = [], None
        for i in range(n):
            before = b8.launches
            tin = tokens[i] if i < len(tokens) else tok
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tok, cache = step(params, cache, tin)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            assert b8.launches - before == cfg.n_layers, b8.launches
            n_steps += 1
        return times, tok

    def fill(b, s_max, length):
        cache = lm.init_cache(cfg, b, s_max)
        for t in (cache["layers"]["k"], cache["layers"]["v"]):
            for i in range(cfg.n_layers):
                t[i].normal_(generator=gen)
        cache["length"] = length
        return cache

    for k in kernels:
        k.launches = 0
    # (a) requests: prompts through the cache, then greedy tokens.
    b, n_prompt, n_new = requests
    prompt = torch.as_tensor(next(lm_batches(cfg.vocab_size, b, n_prompt,
                                             seed=0))["inputs"], device=dev)
    scfg = ServeConfig(max_seq_len=n_prompt + n_new + 1)
    cache = lm.init_cache(cfg, b, scfg.max_seq_len)
    times, tok = timed(make_serve_step(cfg, scfg), cache, list(prompt.t()),
                       n_prompt + n_new)
    logits, _ = lm.decode_step(params, cfg, cache, tok)
    n_steps += 1
    assert logits.shape == (b, cfg.padded_vocab), logits.shape
    assert bool(logits.isfinite().all()), "decode logits not finite"
    ms = 1e3 * statistics.median(times[1:])
    rec["requests"] = dict(
        batch=b, prompt_tokens=n_prompt, new_tokens=n_new,
        ms_per_step=ms, ms_per_step_prompt=1e3 * statistics.median(
            times[1:n_prompt]),
        ms_per_step_generate=1e3 * statistics.median(times[n_prompt:]),
        tokens_per_s=b / (ms / 1e3), last_token=tok.tolist(),
        logits_finite=True)
    print(f"[11] requests {b} x ({n_prompt} prompt + {n_new} greedy) tokens:"
          f" median {ms:.3f} ms a step = {b / (ms / 1e3):.0f} tokens/s "
          f"(prompt {rec['requests']['ms_per_step_prompt']:.3f}, generate "
          f"{rec['requests']['ms_per_step_generate']:.3f} ms), last tokens "
          f"{tok.tolist()}, logits finite")
    del cache, logits

    # (b) decode_32k and (c) long_500k over a random 4,096-slot ring.
    for name, b, s_max in mixes:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        scfg = ServeConfig(max_seq_len=s_max)
        step = make_serve_step(cfg, scfg)
        cache = fill(b, scfg.max_seq_len, s_max - 1)
        torch.cuda.synchronize()
        fill_s = time.perf_counter() - t0
        cache_gib = 2 * cache["layers"]["k"].numel() * 2 / 2**30
        toks = [torch.randint(0, cfg.vocab_size, (b,), generator=gen,
                              device=dev, dtype=torch.int32)]
        times, tok = timed(step, cache, toks, 17)
        ms = 1e3 * statistics.median(times[1:])
        prof = profile_step(torch, lambda: step(params, cache, tok),
                            "decode_attention_kernel")
        assert prof["kernel_s"] > 0, "the step's profile holds no B8 kernel"
        n_steps += 1
        mix = dict(batch=b, max_seq_len=s_max,
                   ring_slots=cache["layers"]["k"].shape[2],
                   cache_gib=cache_gib, fill_s=fill_s, step_s=times,
                   ms_per_step=ms, tokens_per_s=b / (ms / 1e3),
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   profile=prof)
        rec[name] = mix
        print(f"[11] {name}: batch {b} at length {s_max - 1}, "
              f"{mix['ring_slots']}-slot ring ({cache_gib:.2f} GiB, filled in"
              f" {fill_s:.2f} s); seconds a step {times} (first untimed, "
              f"median {ms:.3f} ms = {mix['tokens_per_s']:.0f} tokens/s), "
              f"peak {mix['peak_gib']:.2f} GiB")
        print(f"[11] {name} profiled step (profiler on): wall "
              f"{prof['wall_s'] * 1e3:.3f} ms, device busy "
              f"{prof['device_busy_s'] * 1e3:.3f} ms = "
              f"{prof['busy_share']:.3f} of wall, {prof['kernels']} kernels;"
              f" B8 {prof['kernel_share']:.3f}"
              f" and matmuls {prof['matmul_share']:.3f} of device time")
        for key, t, count in prof["top_ms"]:
            print(f"[11]   {t:10.3f} ms x{count:<5d} {key}")
        del cache
    launches = {k.name: k.launches for k in kernels}
    print(f"[11] launches in the decode phase ({n_steps} steps): {launches}")
    assert launches[b8.name] == cfg.n_layers * n_steps, launches
    assert sum(launches.values()) == launches[b8.name], launches
    del params
    torch.cuda.empty_cache()

    # (d) a 2-layer float32 copy: decode vs forward, card vs CPU.
    small = dataclasses.replace(cfg, n_layers=2, dtype="float32", window=256)
    model = lm.TransformerLM.random(
        small, torch.Generator(device=dev).manual_seed(2))
    toks = torch.as_tensor(next(lm_batches(cfg.vocab_size, 1, check_tokens,
                                           seed=2))["inputs"])

    def decode_all(model, dtype=torch.bfloat16, forced=None):
        """Logits at every position, and each step's new k and v (L, 1,
        hkv, dh each) copied to the CPU.  With ``forced`` (another run's
        new k and v), each step's own write is replaced by that run's after
        the step, so every step starts from that run's cache bits."""
        cache = model.init_cache(1, check_tokens, dtype=dtype)
        ks, vs = cache["layers"]["k"], cache["layers"]["v"]
        dev_t = toks.to(ks.device)
        out, wrote = [], []
        for i in range(check_tokens):
            out.append(model.decode_step(cache, dev_t[:, i])[0][0])
            slot = i % ks.shape[2]
            wrote.append((ks[:, :, slot].to("cpu", copy=True),
                          vs[:, :, slot].to("cpu", copy=True)))
            if forced is not None:
                ks[:, :, slot], vs[:, :, slot] = forced[i]
        return torch.stack(out), wrote

    def on_card_bits(model, card_w):
        """The CPU's bf16-cache decode with each layer's new k and v
        replaced by the card's (``card_w``) before B8's plain version reads
        them, so that every step attends over the card's cache bits, its
        own token's included.  Returns the logits and the CPU's own new k
        and v, as `decode_all` does."""
        real, calls, own = Ly.decode_attention, [0], []

        def attend(q, k, v, lengths, *, window=None):
            i, j = divmod(calls[0], small.n_layers)
            calls[0] += 1
            slot = i % k.shape[1]
            if j == 0:
                own.append(([], []))
            own[i][0].append(k[:, slot].clone())
            own[i][1].append(v[:, slot].clone())
            k[:, slot], v[:, slot] = card_w[i][0][j], card_w[i][1][j]
            return real(q, k, v, lengths, window=window)

        Ly.decode_attention = attend
        try:
            logits, _ = decode_all(model)
        finally:
            Ly.decode_attention = real
        return logits, [(torch.stack(a), torch.stack(b)) for a, b in own]

    def apart(w1, w2):
        """Over every step's new k and v: the values that differ, the share
        of those one bf16 ulp apart (the bits mapped to an order in which
        neighbouring values differ by 1), the largest gap and the largest
        value."""
        def ordered(t):
            i = t.view(torch.int16).to(torch.int32)
            return torch.where(i < 0, -(i & 0x7FFF), i)
        pairs = [(a, b) for x, y in zip(w1, w2) for a, b in zip(x, y)]
        ulps = torch.cat([(ordered(a) - ordered(b)).abs().flatten()
                          for a, b in pairs])
        n = int((ulps > 0).sum())
        return dict(values=n,
                    one_ulp_share=int((ulps == 1).sum()) / max(n, 1),
                    max_gap=max(float((a.float() - b.float()).abs().max())
                                for a, b in pairs),
                    max_abs=max(float(b.float().abs().max())
                                for _, b in pairs))

    fwd = model.forward({"inputs": toks})[0]
    card32, _ = decode_all(model, torch.float32)
    scale = float(fwd.abs().max())
    err_fwd = float((card32 - fwd).abs().max())
    card32 = card32.cpu()
    card16, card_w = decode_all(model)
    card16 = card16.cpu()
    model.to("cpu")
    cpu32, _ = decode_all(model, torch.float32)
    cpu16, cpu_w = decode_all(model)
    forced16, _ = decode_all(model, forced=card_w)
    subst16, subst_w = on_card_bits(model, card_w)
    scale_cpu = float(cpu32.abs().max())
    err_cpu32 = float((card32 - cpu32).abs().max())
    err_cpu16 = float((card16 - cpu16).abs().max())
    err_forced = float((card16 - forced16).abs().max())
    err_subst = float((card16 - subst16).abs().max())
    at = int((card16 - cpu16).abs().amax(-1).argmax())
    free, subst = apart(cpu_w, card_w), apart(subst_w, card_w)
    n_kv = 2 * check_tokens * card_w[0][0].numel()
    print(f"[11] 2 layers at full width, float32, window 256, 1 x "
          f"{check_tokens} tokens, max |logit| {scale!r}: decode vs forward "
          f"on the card (float32 cache) max |diff| {err_fwd!r}; card vs CPU "
          f"max |diff| {err_cpu32!r} with a float32 cache, {err_subst!r} "
          f"with the bf16 cache and the CPU attending over the card's cache "
          f"bits, its own token's included (limits 1e-4 of the largest "
          f"logit); {err_cpu16!r} with the bf16 cache, each running free, "
          f"largest at position {at} (limit 1e-3 of it); {err_forced!r} with "
          f"the CPU starting each step from the card's cache bits but "
          f"writing its own (no limit)")
    print(f"[11] bf16 cache, of {n_kv} new k and v values: running free, "
          f"{free['values']} differ between card and CPU; attending over "
          f"the card's bits, the CPU's own differ in {subst['values']}, "
          f"{subst['one_ulp_share']:.4f} of them one bf16 ulp apart, the "
          f"largest gap {subst['max_gap']!r} against values up to "
          f"{subst['max_abs']!r}")
    assert err_fwd <= 1e-4 * scale, (err_fwd, scale)
    assert err_cpu32 <= 1e-4 * scale_cpu, (err_cpu32, scale_cpu)
    assert err_subst <= 1e-4 * scale_cpu, (err_subst, scale_cpu)
    assert err_cpu16 <= 1e-3 * scale_cpu, (err_cpu16, scale_cpu)
    rec["checks"] = dict(max_abs_logit=scale, decode_vs_forward=err_fwd,
                         card_vs_cpu_f32_cache=err_cpu32,
                         card_vs_cpu_bf16_cache=err_cpu16,
                         card_vs_cpu_bf16_cache_position=at,
                         card_vs_cpu_bf16_cache_on_card_bits=err_subst,
                         card_vs_cpu_bf16_cache_from_card_bits=err_forced,
                         bf16_kv_values=n_kv, bf16_kv_apart_free=free,
                         bf16_kv_apart_on_card_bits=subst)
    return rec, launches


def main() -> int:
    import torch
    from repro_torch.configs import sketchboost_tabular as paper
    from repro_torch.core import losses as L
    from repro_torch.core.boosting import SketchBoost
    from repro_torch.kernels import _build, hist_kernel, predict_kernel
    from repro_torch.kernels import (decode_attention, flash_attention,
                                     predict_quant_kernel, shap_kernel,
                                     split_kernel)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[1] card: {smi}")
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    b5 = [predict_quant_kernel.KERNELS[torch.int8],
          predict_quant_kernel.KERNELS[torch.bfloat16]]
    kernels = [hist_kernel.KERNEL, split_kernel.KERNEL, predict_kernel.KERNEL]
    b6 = shap_kernel.KERNEL
    b4 = hist_kernel.DIRECT_KERNEL
    b2w = split_kernel.WIDE_KERNEL
    b7 = flash_attention.KERNEL
    b8 = decode_attention.KERNEL
    b1bf = hist_kernel.KERNEL_BF16
    every = kernels + b5 + [b6, b4, b2w, b7, b8, b1bf]
    first_split, first_wide, first_shap = first_kernels()
    t0 = time.perf_counter()
    reports = _build.build(every + [first_split, first_wide, first_shap])
    print(f"[2] built {sorted(reports)} in {time.perf_counter() - t0:.2f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[2] {name}: {line.strip()}")

    gen = torch.Generator(device=dev).manual_seed(0)
    hcase = hist_case(torch, gen, dev)
    rows = [check_hist(torch, hcase), check_hist_bf16(torch, hcase)]
    del hcase
    rows.append(check_split(torch, gen, dev, first_split))
    b1_row, b2_row = rows[0], rows[-1]
    ova_level = check_ova_level(torch, gen, dev)
    for name, sh in zip(("hist_nodes", "split_scan"), ova_level):
        print(f"[3] {name} ova_level5: {json.dumps(sh)}")
    cases = traverse_cases(torch, gen, dev)
    rows += [check_traverse(torch, cases, dt)
             for dt in ("float32", "int8", "bfloat16")]
    del cases
    rows.append(check_shap(torch, gen, dev, first_shap))
    rows.append(check_hist_direct(torch, gen, dev))
    rows.append(check_split_wide(torch, gen, dev, first_wide))
    rows.append(check_flash(torch, gen, dev))
    rows.append(check_decode(torch, gen, dev))
    for r in rows:
        for key, sh in r.get("shapes", {}).items():
            if "leaf_bytes" not in sh:           # B2, B2-wide and B6
                print(f"[3] {r['name']} {key}: {json.dumps(sh)}")
                continue
            print(f"[3] {r['name']} {key} ({sh['rows']} rows x "
                  f"{sh['trees']} trees): kernel {sh['ms']:.4f} ms plain "
                  f"{sh['plain_ms']:.4f} ms bound {sh['bound_ms']:.4f} ms "
                  f"({sh['bound_by']}), leaf bytes gathered "
                  f"{sh['leaf_bytes']}, plan {sh['plan']}, build "
                  f"{sh['build']}")
        print(f"[3] {r['name']}: max_abs_err {r['max_abs_err']!r} kernel "
              f"{r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}) library "
              f"{r['library_ms']}" + (f" build {r['build']}"
                                      if "build" in r else ""))
        if r["library_ms"] is not None:
            print(f"[3] {r['name']}: library / kernel time "
                  f"{r['library_ms'] / r['ms']:.3f}")
    print(f"[3] small fit, cuda vs cpu: max |diff| {check_small_fit(torch)!r}")

    t0 = time.perf_counter()
    X, y = make_data(torch, dev, N_TRAIN + N_EVAL + N_TEST,
                     paper.N_FEATURES, paper.CONFIG.n_outputs, seed=0)
    print(f"[4] data made on the card (seeded torch.Generator): "
          f"{X.shape} in {time.perf_counter() - t0:.2f} s")
    Xtr, ytr = X[:N_TRAIN], y[:N_TRAIN]
    Xev, yev = X[N_TRAIN:N_TRAIN + N_EVAL], y[N_TRAIN:N_TRAIN + N_EVAL]
    Xte = X[N_TRAIN + N_EVAL:]
    cfg = paper.CONFIG
    for k in every:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = SketchBoost(cfg, device=dev).fit(Xtr, ytr, eval_set=(Xev, yev))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    times = [h["train_time_s"] for h in model.history]
    per_round = [b - a for a, b in zip([0.0] + times[:-1], times)]
    round_s = {"min": min(per_round), "median": statistics.median(per_round),
               "max": max(per_round)}
    print(f"[4] fit {len(model.history)} rounds in {fit_s:.3f} s; seconds "
          f"per round {round_s}")
    vl = [h["valid_loss"] for h in model.history]
    print(f"[4] valid loss {vl[0]!r} after round 1, {vl[-1]!r} after round "
          f"{len(vl)}")
    print(f"[4] peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    fit_launches = {k.name: k.launches for k in kernels}
    print(f"[4] launches in fit: {fit_launches}")
    # One B1 launch a level, every channel in it.
    assert fit_launches["hist_nodes"] == cfg.depth * len(model.history), \
        fit_launches

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    raw = model.predict_raw(Xte)
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    assert raw.shape == (N_TEST, cfg.n_outputs) and bool(raw.isfinite().all())
    print(f"[5] predict {N_TEST} rows in {pred_s:.4f} s = "
          f"{N_TEST / pred_s:.1f} rows/s (binning included)")
    assert all(v > 0 for v in launches.values()), launches

    # Right by the repo's own means: the kernel's scores equal the plain
    # traversal's on the CPU, bit for bit, on a small slice.
    from repro_torch.core import forest as FO
    pf_cpu = model.packed._replace(**{
        k: v.cpu() for k, v in model.packed._asdict().items()
        if isinstance(v, torch.Tensor)})
    codes_te, _ = model._codes(Xte[:4096])
    cpu_raw = FO.predict_raw(pf_cpu, codes_te.cpu())
    assert torch.equal(cpu_raw, raw[:4096].cpu()), "predict differs from CPU"
    loss = L.get_loss(cfg.loss)
    Ytr = torch.as_tensor(ytr, device=dev).long()
    base_loss = float(loss.value(model.base_score.expand(N_TRAIN, -1), Ytr))
    train_loss = model.eval_loss(Xtr, ytr)
    print(f"[5] train loss {train_loss!r} after {cfg.n_trees} rounds, base-score "
          f"loss {base_loss!r}")
    assert math.isfinite(train_loss) and train_loss < base_loss

    profile_rounds(torch, model, dev, Xtr, ytr, Xev, yev)
    serve, serve_launches, servers = serve_phase(
        torch, model, dev, Xte, raw, [predict_kernel.KERNEL] + b5)
    assert all(v > 0 for v in serve_launches.values()), serve_launches
    explain, explain_launches = explain_phase(
        torch, model, dev, Xte, raw, pf_cpu, servers,
        [predict_kernel.KERNEL, b6])
    assert explain_launches[b6.name] > 0, explain_launches
    del servers
    engines, direct_launches, full_launches = engines_phase(
        torch, dev, Xtr, ytr, Xev, yev, cfg, kernels + [b4, b2w])
    leafwise, bf16_launches = leafwise_phase(
        torch, dev, Xtr, ytr, Xev, yev, cfg, kernels + [b1bf])
    # Phase 9c: free phases 4-9b's memory first.
    del model, raw, pf_cpu, codes_te, Ytr
    gc.collect()
    torch.cuda.empty_cache()
    one_vs_all, ova_launches = ova_phase(torch, dev, Xtr, ytr, Xev, yev,
                                         cfg, kernels, engines)
    # Phase 10 runs alone on the card: free the tabular phases' memory.
    del X, y, Xtr, ytr, Xev, yev, Xte
    gc.collect()
    torch.cuda.empty_cache()
    prefill, prefill_launches = prefill_phase(torch, dev, b7, every)
    assert prefill_launches[b7.name] == 24 * 6, prefill_launches
    assert sum(prefill_launches.values()) == 24 * 6, prefill_launches
    # Phase 11 runs alone on the card too: free phase 10's memory.
    gc.collect()
    torch.cuda.empty_cache()
    decode, decode_launches = decode_phase(torch, dev, b8, every)
    for r in rows:
        if r["name"] in launches:            # B1-B3: the fit -> predict path
            r["launches"], r["path"] = launches[r["name"]], "fit+predict"
        elif r["name"] == b6.name:           # B6: the explain path
            r["launches"], r["path"] = explain_launches[r["name"]], "explain"
        elif r["name"] == b4.name:           # B4: the direct engine's fit
            r["launches"] = direct_launches[r["name"]]
            r["path"] = "fit (hist_engine='direct')"
        elif r["name"] == b2w.name:          # B2-wide: SketchBoost Full's fit
            r["launches"] = full_launches[r["name"]]
            r["path"] = "fit (sketch_method='none', d=512)"
        elif r["name"] == b7.name:           # B7: the LM prefill
            r["launches"], r["path"] = prefill_launches[r["name"]], "lm prefill"
        elif r["name"] == b8.name:           # B8: the LM decode
            r["launches"], r["path"] = decode_launches[r["name"]], "lm decode"
        elif r["name"] == b1bf.name:         # B1-bf16: the bf16 fits
            r["launches"] = sum(v[r["name"]] for v in bf16_launches.values())
            r["path"] = "fit (hist_dtype='bfloat16', levelwise + leafwise)"
        else:                                # B5: the serving path
            r["launches"], r["path"] = serve_launches[r["name"]], "serve"
    b3_row = next(r for r in rows if r["name"] == predict_kernel.KERNEL.name)
    b3_row["serve_launches"] = serve_launches[b3_row["name"]]
    b3_row["explain_launches"] = explain_launches[b3_row["name"]]
    for r in rows:                           # B1-B3 on the one-vs-all fit
        if r["name"] in ova_launches:
            r["one_vs_all_launches"] = ova_launches[r["name"]]
    for r, sh in zip((b1_row, b2_row), ova_level):
        r.setdefault("shapes", {})["ova_level5"] = sh
    print(json.dumps({"kernels": rows, "fit_s": fit_s,
                      "fit_round_s": round_s, "predict_rows_per_s":
                      N_TEST / pred_s, "serve": serve, "explain": explain,
                      "engines_and_sketches": engines,
                      "leafwise_bf16_staged": leafwise,
                      "one_vs_all": one_vs_all, "prefill": prefill,
                      "decode": decode, "card": smi}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
