#!/usr/bin/env python3
"""Run the PyTorch port of SketchBoost, and its dense-LM prefill, on one
CUDA card, end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. the card (nvidia-smi name and power limit) and the torch / CUDA build;
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
     per source, in parallel; B3 and both B5 entry points share
     ``predict.cu``; B4 is ``hist_direct.cu``, B6 ``shap.cu``, B7
     ``flash_attention.cu``) and time the build;
  3. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes (B4 bitwise at level 5 of the paper's tree; B2's
     wide kernel at SketchBoost Full's level 5, C = 513; B5 also against B3
     on the dequantized forest; B6 wide and with narrow blocks at per-tree
     columns; B7 at the prefill's layer, 1 x 32 heads over 8 x 32,768 x
     120 with a 4,096 window, in bf16 each output within one bf16 ulp of
     its own plain value plus 1e-5 and in float32 within 1e-5, and in
     float32 without the causal mask at 1,000 rows), and time kernel, plain
     version and, where one PyTorch call computes the same function, that
     call;
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
     of each; then one more round of Full under the profiler, as in 6;
 10. the dense-LM prefill (memory of phases 4-9 freed first):
     h2o-danube-3-4b at full width in bf16 (24 layers, d_model 3840, 3.84 B
     parameters from a seeded ``torch.Generator``) through
     ``lm_serve.make_prefill_step``, 4 requests of 1 x 32,768 tokens (the
     first untimed) and 2 of 8 x 2,048 from ``lm_batches(seed=0)``: ms a
     request, tokens/s, peak memory, greedy next token, finite logits, 24
     B7 launches a request; one more 32k request under the profiler (B7's
     share of device time); a 2-layer float32 copy with a 256-token window
     at 1 x 640 tokens on the card against the CPU, logits within 1e-4 of
     the largest;
 11. print the kernel table as one JSON line, the card's line, and last
     ``{"ok": true, "device": {...}}``.

Phase 4's data are made on the card from a seeded ``torch.Generator``
(the Guyon scheme of ``data/pipeline.make_tabular``; numpy would take
minutes at this size).  Kernel launch counts are set to zero just before
phase 4 and read just after phase 5 (the fit -> predict path), again just
before and after phase 7 (the serving path), again around phase 8 (the
explain path), again around each fit of phase 9 (the direct engine's
B4, Full's B2-wide), and again around phase 10's prefill requests (B7).
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


def check_hist(torch, gen, dev):
    """B1 at the main path's level 1: m=100, B=256, C=6, the smaller child
    of a 2,097,152-row root (S ~ n/2)."""
    from repro_torch.core import histogram as H
    from repro_torch.kernels import hist_kernel, ref
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
    args = (codes_t, state.order, stats_p, state.counts, build_counts)
    out = hist_kernel.hist_nodes(*args, n_bins=B)
    again = hist_kernel.hist_nodes(*args, n_bins=B)
    torch.cuda.synchronize()
    assert torch.equal(out, again), "B1 is not deterministic run to run"
    plain = ref.hist_nodes_ref(*args, n_bins=B)
    torch.testing.assert_close(out[..., :-1], plain[..., :-1], rtol=1e-5,
                               atol=0)
    assert torch.equal(out[..., -1], plain[..., -1]), "B1 counts differ"
    s_b = int(build_counts.sum())
    # One PyTorch call for the same function: index_add_ over flat
    # (node, feature, bin) cells, indices prepared outside the timing.
    pos = torch.arange(n, device=dev)
    node = state.node_perm.long()
    keep = build_counts.long()[node] > 0
    pos, node = pos[keep], node[keep]
    flat = ((node[None, :] * m + torch.arange(m, device=dev)[:, None]) * B
            + codes_t.long()[:, state.order.long()[pos]]).reshape(-1)
    src = stats_p[pos].repeat(m, 1)
    cells = torch.zeros((2 * m * B, C), device=dev)
    library = cuda_ms(lambda: cells.zero_().index_add_(0, flat, src), 3)
    torch.testing.assert_close(cells.reshape(out.shape), out, rtol=1e-5,
                               atol=0)
    del flat, src, cells
    b_ms, b_by = bound_ms(s_b * (m + 4 + 4 * C) + 2 * m * B * C * 4,
                          s_b * m * C)
    return dict(
        name="hist_nodes", route="cuda",
        source="src/repro_torch/kernels/csrc/hist.cu",
        replaces="src/repro/kernels/hist_kernel.py:120",
        max_abs_err=float((out - plain).abs().max()),
        ms=cuda_ms(lambda: hist_kernel.hist_nodes(*args, n_bins=B)),
        plain_ms=cuda_ms(lambda: ref.hist_nodes_ref(*args, n_bins=B), 2),
        bound_ms=b_ms, bound_by=b_by, library_ms=library)


def check_hist_direct(torch, gen, dev):
    """B4 at level 5 of a 2,097,152-row root: 32 nodes, m=100, B=256, C=6,
    each row's node drawn on the card; bitwise against its plain version
    (each cell's rows added in row order) and from run to run."""
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
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library)


def check_split(torch, gen, dev):
    """B2 at the main path's deepest level: 32 nodes x 100 x 256 x 6."""
    from repro_torch.kernels import ref, split_kernel
    nodes, m, B, C = 32, 100, 256, 6
    hist = torch.randn((nodes, m, B, C), generator=gen, device=dev)
    hist[..., -1] = torch.randint(0, 40, (nodes, m, B), generator=gen,
                                  device=dev).float()
    mask = torch.ones(m, device=dev)
    mask[7] = 0.0
    gain, idx = split_kernel.split_scan(hist, 1.0, 1.0, mask)
    pg, pi = ref.split_scan_ref(hist, 1.0, 1.0, mask)
    torch.cuda.synchronize()
    assert torch.equal(idx, pi), "B2 split indices differ from plain"
    torch.testing.assert_close(gain, pg, rtol=1e-5, atol=0)
    b_ms, b_by = bound_ms(hist.numel() * 4 + m * 4 + nodes * 8,
                          nodes * m * B * (4 * C + 12))
    return dict(
        name="split_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/split.cu",
        replaces="src/repro/kernels/split_kernel.py:95",
        max_abs_err=float((gain - pg).abs().max()),
        ms=cuda_ms(lambda: split_kernel.split_scan(hist, 1.0, 1.0, mask)),
        plain_ms=cuda_ms(lambda: ref.split_scan_ref(hist, 1.0, 1.0, mask)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)


def check_split_wide(torch, gen, dev):
    """B2's wide kernel (C > 64) at SketchBoost Full's deepest level: 32
    nodes x 100 x 256 x 513 (d = 512 gradient channels and the count)."""
    from repro_torch.kernels import ref, split_kernel
    nodes, m, B, C = 32, 100, 256, 513
    hist = torch.randn((nodes, m, B, C), generator=gen, device=dev)
    hist[..., -1] = torch.randint(0, 40, (nodes, m, B), generator=gen,
                                  device=dev).float()
    mask = torch.ones(m, device=dev)
    mask[7] = 0.0
    before = split_kernel.WIDE_KERNEL.launches
    gain, idx = split_kernel.split_scan(hist, 1.0, 1.0, mask)
    assert split_kernel.WIDE_KERNEL.launches == before + 1, "not the wide path"
    pg, pi = ref.split_scan_ref(hist, 1.0, 1.0, mask)
    torch.cuda.synchronize()
    assert torch.equal(idx, pi), "B2-wide split indices differ from plain"
    torch.testing.assert_close(gain, pg, rtol=1e-5, atol=0)
    err = float((gain - pg).abs().max())
    del pg, pi
    b_ms, b_by = bound_ms(hist.numel() * 4 + m * 4 + nodes * 8,
                          nodes * m * B * (4 * C + 12))
    return dict(
        name="split_scan_wide", route="cuda",
        source="src/repro_torch/kernels/csrc/split.cu",
        replaces="src/repro/kernels/split_kernel.py:95",
        max_abs_err=err,
        ms=cuda_ms(lambda: split_kernel.split_scan(hist, 1.0, 1.0, mask)),
        plain_ms=cuda_ms(lambda: ref.split_scan_ref(hist, 1.0, 1.0, mask), 2),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)


def predict_case(torch, gen, dev):
    """Predict's shape: 262,144 rows x 100 codes, 8 depth-6 trees (N=127),
    D = W = 512.  Returns ``(codes, PackedForest, F0)``."""
    from repro_torch.core.forest import PackedForest
    from repro_torch.core.tree import heap_to_node_arrays
    n, M, T, depth, D = N_TEST, 100, 8, 6, 512
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


def check_predict(torch, case):
    """B3 at predict's shape, bitwise against the plain version."""
    from repro_torch.kernels import predict_kernel, ref
    codes, pf, F0 = case
    n, M = codes.shape
    T, N, D = pf.leaf.shape
    depth, dev = pf.depth, codes.device
    feat, thr, left, right, leaf = pf.feat, pf.thr, pf.left, pf.right, pf.leaf
    tree_args = (codes, feat, thr, left, right, leaf, pf.out_col, 0.05)
    out = predict_kernel.forest_traverse(F0.clone(), *tree_args, depth=depth)
    plain = ref.forest_apply_ref(F0.clone(), *tree_args, depth=depth)
    torch.cuda.synchronize()
    assert torch.equal(out, plain), "B3 is not bitwise equal to plain"
    # A narrow block (one_vs_all layout): width 1 at per-tree columns.
    narrow = leaf[:, :, :1].contiguous()
    cols = torch.arange(T, dtype=torch.int32, device=dev) * 60
    k_n = predict_kernel.forest_traverse(
        F0.clone(), codes, feat, thr, left, right, narrow, cols, 0.05,
        depth=depth)
    p_n = ref.forest_apply_ref(F0.clone(), codes, feat, thr, left, right,
                               narrow, cols, 0.05, depth=depth)
    assert torch.equal(k_n, p_n), "B3 narrow blocks differ from plain"
    b_ms, b_by = bound_ms(8 * n * D + n * M + T * N * (16 + 4 * D) + 4 * T,
                          2 * n * T * D)
    Fw = F0.clone()
    return dict(
        name="forest_traverse", route="cuda",
        source="src/repro_torch/kernels/csrc/predict.cu",
        replaces="src/repro/kernels/predict_kernel.py:182",
        max_abs_err=float((out - plain).abs().max()),
        ms=cuda_ms(lambda: predict_kernel.forest_traverse(
            Fw, *tree_args, depth=depth)),
        plain_ms=cuda_ms(lambda: ref.forest_apply_ref(
            Fw, *tree_args, depth=depth), 2),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)


def check_predict_quant(torch, case, dtype):
    """B5 at B3's shape with ``dtype`` leaves (``quantize_forest`` of the
    same trees): bitwise against its plain version, and against B3 on the
    dequantized twin."""
    from repro_torch.core import quantize as Q
    from repro_torch.kernels import predict_kernel, predict_quant_kernel, ref
    codes, pf, F0 = case
    qf = Q.quantize_forest(pf, dtype)
    twin = Q.dequantize_forest(qf)
    n, M = codes.shape
    T, N, D = qf.leaf.shape
    args = (codes, qf.feat, qf.thr, qf.left, qf.right, qf.leaf, qf.leaf_scale,
            qf.out_col, 0.05)
    out = predict_quant_kernel.forest_traverse_quant(F0.clone(), *args,
                                                     depth=qf.depth)
    plain = ref.forest_apply_quant_ref(F0.clone(), *args, depth=qf.depth)
    b3 = predict_kernel.forest_traverse(
        F0.clone(), codes, twin.feat, twin.thr, twin.left, twin.right,
        twin.leaf, twin.out_col, 0.05, depth=twin.depth)
    torch.cuda.synchronize()
    assert torch.equal(out, plain), f"B5 {dtype} is not bitwise plain"
    assert torch.equal(out, b3), f"B5 {dtype} differs from B3 on its twin"
    # A narrow block at per-tree columns.
    cols = torch.arange(T, dtype=torch.int32, device=codes.device) * 60
    narrow = qf.leaf[:, :, :1].contiguous()
    k_n = predict_quant_kernel.forest_traverse_quant(
        F0.clone(), codes, qf.feat, qf.thr, qf.left, qf.right, narrow,
        qf.leaf_scale, cols, 0.05, depth=qf.depth)
    p_n = ref.forest_apply_quant_ref(
        F0.clone(), codes, qf.feat, qf.thr, qf.left, qf.right, narrow,
        qf.leaf_scale, cols, 0.05, depth=qf.depth)
    assert torch.equal(k_n, p_n), f"B5 {dtype} narrow blocks differ"
    s = qf.leaf.element_size()
    b_ms, b_by = bound_ms(8 * n * D + n * M + T * N * (13 + D * s) + 4 * T * 2,
                          3 * n * T * D)
    Fw = F0.clone()
    return dict(
        name=predict_quant_kernel.KERNELS[qf.leaf.dtype].name, route="cuda",
        source="src/repro_torch/kernels/csrc/predict.cu",
        replaces="src/repro/kernels/predict_kernel.py:237",
        max_abs_err=float((out - plain).abs().max()),
        ms=cuda_ms(lambda: predict_quant_kernel.forest_traverse_quant(
            Fw, *args, depth=qf.depth)),
        plain_ms=cuda_ms(lambda: ref.forest_apply_quant_ref(
            Fw, *args, depth=qf.depth), 2),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)


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


def check_shap(torch, gen, dev):
    """B6 at the main model's tree shape: 4,096 rows x 100 features, 8
    depth-6 trees (L=64, D=6), W = d = 512, covers with empty subtrees;
    then W=1 blocks at per-tree columns.  Bitwise against the plain
    version on the card (same sums in the same order, two roundings)."""
    from repro_torch.core import forest as FO
    from repro_torch.core.tree import heap_to_node_arrays
    from repro_torch.explain import build_path_pack
    from repro_torch.kernels import ref, shap_kernel
    n, M, T, depth, d = 4096, 100, 8, 6, 512
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
    pack = build_path_pack(pf)
    codes = torch.randint(0, 256, (n, M), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    tables = (pack.slot_feat, pack.slot_lo, pack.slot_hi, pack.slot_z)

    def kernel(leaf_v, cols):
        return shap_kernel.tree_shap(codes, *tables, leaf_v, cols, 0.05,
                                     n_outputs=d)

    def plain(leaf_v, cols):
        phi = torch.zeros((n, M, d), device=dev)
        return ref.tree_shap_ref(phi, codes, *tables, leaf_v, cols, 0.05)
    out, again = kernel(pack.leaf, pf.out_col), kernel(pack.leaf, pf.out_col)
    want = plain(pack.leaf, pf.out_col)
    torch.cuda.synchronize()
    assert torch.equal(out, again), "B6 is not deterministic run to run"
    err = float((out - want).abs().max())
    assert torch.equal(out, want), f"B6 differs from plain by {err!r}"
    del out, again, want
    narrow = pack.leaf[:, :, :1].contiguous()
    cols = torch.arange(T, dtype=torch.int32, device=dev) * 60
    k_n, p_n = kernel(narrow, cols), plain(narrow, cols)
    torch.cuda.synchronize()
    assert torch.equal(k_n, p_n), "B6 narrow blocks differ from plain"
    del k_n, p_n
    L, D = pack.slot_feat.shape[1:]
    real_slots = int((pack.slot_feat >= 0).sum())
    real_paths = int((pack.slot_feat >= 0).any(2).sum())
    b_ms, b_by = bound_ms(4 * n * M * d + n * M + 16 * T * L * D
                          + 4 * T * L * d + 4 * T + 4 * D,
                          2 * n * real_slots * d
                          + n * real_paths * shap_ops(D))
    return dict(
        name="tree_shap", route="cuda",
        source="src/repro_torch/kernels/csrc/shap.cu",
        replaces="src/repro/kernels/shap_kernel.py:109",
        max_abs_err=err,
        ms=cuda_ms(lambda: kernel(pack.leaf, pf.out_col)),
        plain_ms=cuda_ms(lambda: plain(pack.leaf, pf.out_col), 2),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)


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
    dh=120, causal, window 4,096.  In bf16 each output within one bf16 ulp
    of its own plain value plus 1e-5 (the float32 limit); in float32 within
    atol 1e-5 of plain at the same shape.  Also float32 at (1, 8, 2, 1,000,
    120) without the causal mask (keys past sk masked) within atol 1e-5."""
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
    q, k, v = (t.to(torch.bfloat16) for t in (q32, k32, v32))
    del q32, k32, v32, o32, p32
    out = FA.flash_attention(q, k, v, **kw)
    plain = ref.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
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
    # QK^T takes bf16 inputs (exact on the tensor cores); PV takes the
    # float32 probabilities, so it is held to the fp32 rate.
    half_ops = 2 * dh * hq * b * pairs
    n_bytes = 2 * (2 * b * hq * s * dh + 2 * b * hkv * s * dh)
    b_ms, b_by = bound_ms(n_bytes, half_ops, n_bf16_ops=half_ops)
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
        bound_ms=b_ms, bound_by=b_by, pairs_per_head=pairs, ops=2 * half_ops,
        bf16_tensor_core_bound_ms=1e3 * 2 * half_ops / BF16_OPS_PER_S,
        library_ms=lib_ms, library_max_abs_err=lib_err)


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
                   tag="[6]"):
    """Where a full-width round's time goes: ``rounds`` more rounds of the
    fitted model's loop body (``boosting.boost_round`` plus the eval
    update and loss) under ``torch.profiler``, after the path's counts
    were read.  Prints device time by kernel and the device's busy time
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
    print(f"{tag} profiled {rounds} rounds (profiler on): wall {wall:.4f} "
          f"s, device busy {busy:.4f} s = {busy / wall:.3f} of wall")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:14]
    for e in top:
        print(f"{tag}   {e.self_device_time_total / 1e3:10.3f} ms "
              f"x{e.count:<5d} {e.key[:90]}")
    return dict(rounds=rounds, wall_s=wall, device_busy_s=busy,
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
    assert full_launches["split_scan"] == 0, full_launches
    assert direct_launches["split_scan_wide"] == 0, direct_launches
    rec["none"]["profile"] = profile_rounds(torch, model, dev, Xtr, ytr, Xev,
                                            yev, rounds=1, tag="[9] Full:")
    return rec, direct_launches, full_launches


def make_data(torch, dev, n, m, d, seed):
    """Guyon-scheme multiclass table on the card (make_tabular's recipe)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    ni = max(m // 10, 2)
    nc = min(2 * ni, max(m - ni, 0))
    base = torch.randn((n, ni), generator=gen, device=dev)
    combo = base @ torch.randn((ni, nc), generator=gen, device=dev)
    rest = torch.randn((n, m - ni - nc), generator=gen, device=dev)
    X = torch.cat([base, combo, rest], 1)
    W = torch.randn((ni, d), generator=gen, device=dev)
    y = torch.empty(n, dtype=torch.int64, device=dev)
    for s in range(0, n, 1 << 18):                 # logits in slices
        e = min(s + (1 << 18), n)
        logits = base[s:e] @ W + 0.5 * torch.randn(
            (e - s, d), generator=gen, device=dev)
        y[s:e] = logits.argmax(1)
    return X.cpu().numpy(), y.to(torch.int32).cpu().numpy()


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

    from torch.profiler import ProfilerActivity, profile

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
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    b7_s = sum(e.self_device_time_total for e in events
               if "flash_attention_kernel" in e.key) / 1e6
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    print(f"[10] profiled prefill {b} x {s} (profiler on): wall {wall:.4f} "
          f"s, device busy {busy:.4f} s = {busy / wall:.3f} of wall; B7 "
          f"{b7_s:.4f} s = {b7_s / busy:.3f} of device time")
    for e in top:
        print(f"[10]   {e.self_device_time_total / 1e3:10.3f} ms "
              f"x{e.count:<5d} {e.key[:90]}")
    rec["profile"] = dict(wall_s=wall, device_busy_s=busy, b7_s=b7_s,
                          b7_share=b7_s / busy,
                          top_ms=[[e.key[:90], e.self_device_time_total / 1e3,
                                   e.count] for e in top])
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


def main() -> int:
    import torch
    from repro_torch.configs import sketchboost_tabular as paper
    from repro_torch.core import losses as L
    from repro_torch.core.boosting import SketchBoost
    from repro_torch.kernels import _build, hist_kernel, predict_kernel
    from repro_torch.kernels import (flash_attention, predict_quant_kernel,
                                     shap_kernel, split_kernel)

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
    t0 = time.perf_counter()
    reports = _build.build(kernels + b5 + [b6, b4, b2w, b7])
    print(f"[2] built {sorted(reports)} in {time.perf_counter() - t0:.2f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[2] {name}: {line.strip()}")

    gen = torch.Generator(device=dev).manual_seed(0)
    case = predict_case(torch, gen, dev)
    rows = [check_hist(torch, gen, dev), check_split(torch, gen, dev),
            check_predict(torch, case),
            check_predict_quant(torch, case, "int8"),
            check_predict_quant(torch, case, "bfloat16")]
    del case
    rows.append(check_shap(torch, gen, dev))
    rows.append(check_hist_direct(torch, gen, dev))
    rows.append(check_split_wide(torch, gen, dev))
    rows.append(check_flash(torch, gen, dev))
    for r in rows:
        print(f"[3] {r['name']}: max_abs_err {r['max_abs_err']!r} kernel "
              f"{r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}) library "
              f"{r['library_ms']}")
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
    for k in kernels + b5 + [b6, b4, b2w, b7]:
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
    # Phase 10 runs alone on the card: free the tabular phases' memory.
    del X, y, Xtr, ytr, Xev, yev, Xte, model, raw, pf_cpu, codes_te, Ytr
    gc.collect()
    torch.cuda.empty_cache()
    prefill, prefill_launches = prefill_phase(
        torch, dev, b7, kernels + b5 + [b6, b4, b2w, b7])
    assert prefill_launches[b7.name] == 24 * 6, prefill_launches
    assert sum(prefill_launches.values()) == 24 * 6, prefill_launches
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
        else:                                # B5: the serving path
            r["launches"], r["path"] = serve_launches[r["name"]], "serve"
    rows[2]["serve_launches"] = serve_launches[rows[2]["name"]]
    rows[2]["explain_launches"] = explain_launches[rows[2]["name"]]
    print(json.dumps({"kernels": rows, "fit_s": fit_s,
                      "fit_round_s": round_s, "predict_rows_per_s":
                      N_TEST / pred_s, "serve": serve, "explain": explain,
                      "engines_and_sketches": engines, "prefill": prefill,
                      "card": smi}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
