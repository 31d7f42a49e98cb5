#!/usr/bin/env python3
"""Run the PyTorch port of SketchBoost on one CUDA card, end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. the card (nvidia-smi name and power limit) and the torch / CUDA build;
  2. build the three CUDA kernels from ``src/repro_torch/kernels/csrc``
     (one nvcc each, in parallel) and time the build;
  3. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes, and time kernel, plain version and, where one
     PyTorch call computes the same function, that call;
  4. fit the paper's configuration (``configs/sketchboost_tabular.py``) at
     full width, 2,097,152 rows x 100 features, d = 512, k = 5, depth 6,
     256 bins, cut to 8 of its 100 rounds, with a 131,072-row eval set;
  5. predict 262,144 held-out rows through the traversal kernel;
  6. profile two more rounds of the loop body (device time by kernel,
     the device's busy share);
  7. print the kernel table as one JSON line, the card's line, and last
     ``{"ok": true, "device": {...}}``.

Phase 4's data are made on the card from a seeded ``torch.Generator``
(the Guyon scheme of ``data/pipeline.make_tabular``; numpy would take
minutes at this size).  Kernel launch counts are set to zero just before
phase 4 and read just after phase 5: they count the main path only.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
N_TRAIN, N_EVAL, N_TEST = 2_097_152, 131_072, 262_144
ROUNDS = 8


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
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


def check_predict(torch, gen, dev):
    """B3 at predict's shape: 262,144 rows, 8 depth-6 trees (N=127),
    D = W = 512, bitwise against the plain version."""
    from repro_torch.core.tree import heap_to_node_arrays
    from repro_torch.kernels import predict_kernel, ref
    n, M, T, depth, D = N_TEST, 100, 8, 6, 512
    feat = torch.randint(0, M, (T, 2 ** depth - 1), generator=gen,
                         device=dev, dtype=torch.int32)
    thr = torch.randint(0, 256, (T, 2 ** depth - 1), generator=gen,
                        device=dev, dtype=torch.int32)
    value = torch.randn((T, 2 ** depth, D), generator=gen, device=dev)
    feat, thr, left, right, leaf = heap_to_node_arrays(feat, thr, value)
    codes = torch.randint(0, 256, (n, M), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    out_col = torch.zeros(T, dtype=torch.int32, device=dev)
    F0 = torch.randn((n, D), generator=gen, device=dev)
    tree_args = (codes, feat, thr, left, right, leaf, out_col, 0.05)
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
    N = feat.shape[1]
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


def profile_rounds(torch, model, dev, Xtr, ytr, Xev, yev, rounds=2):
    """Where a full-width round's time goes: ``rounds`` more rounds of the
    fitted model's loop body (``boosting.boost_round`` plus the eval
    update and loss) under ``torch.profiler``, after the main path's counts
    were read.  Prints device time by kernel and the device's busy time
    over the wall time of those rounds."""
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
    print(f"[6] profiled {rounds} rounds (profiler on): wall {wall:.4f} s, "
          f"device busy {busy:.4f} s = {busy / wall:.3f} of wall")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:14]:
        print(f"[6]   {e.self_device_time_total / 1e3:10.3f} ms "
              f"x{e.count:<5d} {e.key[:90]}")


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


def main() -> int:
    import torch
    from repro_torch.configs import sketchboost_tabular as paper
    from repro_torch.core import losses as L
    from repro_torch.core.boosting import SketchBoost
    from repro_torch.kernels import _build, hist_kernel, predict_kernel
    from repro_torch.kernels import split_kernel

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

    kernels = [hist_kernel.KERNEL, split_kernel.KERNEL, predict_kernel.KERNEL]
    t0 = time.perf_counter()
    reports = _build.build(kernels)
    print(f"[2] built {sorted(reports)} in {time.perf_counter() - t0:.2f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[2] {name}: {line.strip()}")

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = [check_hist(torch, gen, dev), check_split(torch, gen, dev),
            check_predict(torch, gen, dev)]
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
    cfg = dataclasses.replace(paper.CONFIG, n_trees=ROUNDS)
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = SketchBoost(cfg, device=dev).fit(Xtr, ytr, eval_set=(Xev, yev))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    times = [h["train_time_s"] for h in model.history]
    per_round = [b - a for a, b in zip([0.0] + times[:-1], times)]
    print(f"[4] fit {len(model.history)} rounds in {fit_s:.3f} s; per-round "
          f"s {[round(t, 4) for t in per_round]}")
    print(f"[4] valid loss {[round(h['valid_loss'], 5) for h in model.history]}")
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
    print(f"[5] train loss {train_loss!r} after {ROUNDS} rounds, base-score "
          f"loss {base_loss!r}")
    assert math.isfinite(train_loss) and train_loss < base_loss

    profile_rounds(torch, model, dev, Xtr, ytr, Xev, yev)
    for r in rows:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": rows, "fit_s": fit_s,
                      "fit_round_s": per_round, "predict_rows_per_s":
                      N_TEST / pred_s, "card": smi}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
