"""Dry run: count every (architecture x shape x mesh) cell of the port on
fake tensors, and put its roofline on H100 constants.

The JAX package's ``launch/dryrun.py`` lowers and compiles each cell for 512
fake host devices and reads XLA's analyses.  The port has no compiler
artefact, so each cell runs the port's own step once, at the cell's global
shapes, on fake tensors (``torch._subclasses.fake_tensor.FakeTensorMode``:
shapes and dtypes, no storage, no device), under the roofline counter
(`roofline.analysis.Counter`):

  train    `train_lib.make_train_step`'s step: `lm.lm_loss`,
           ``torch.autograd.grad`` and `optimizer.opt_update`;
  prefill  `lm_serve.make_prefill_step`'s body;
  decode   `lm_serve.make_serve_step`'s step on `lm.abstract_cache`, filled
           to ``seq_len - 1`` tokens.

The mesh is abstract (`launch.mesh.make_production_mesh`: 16 x 16, or
2 x 16 x 16 with ``--multi-pod``) and enters through the partition specs
alone: a rank's argument bytes from the shard shapes
(`models.params.tree_shard_shapes`, `lm.cache_pspecs`, the batch specs) and
the collective bytes by closed form (`roofline.analysis.lm_collectives`).
The model code never sees a sharded tensor.  ``temp_bytes`` and
``peak_bytes`` are None: nothing counts the live fake bytes of a step.

The GBDT cell (``--gbdt``) cannot run a round on fake tensors (the growers
read the leaves' counts to the host), so it counts real CPU rounds at two
cut row counts and extrapolates linearly to the paper's 2,097,152 rows.

Importing this module sets no environment variable and touches no device.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun_torch.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --gbdt            # paper's cell
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import (ARCH_NAMES, get_config, get_gbdt_config,
                                 smoke_config)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import lm
from repro_torch.models.config import (LM_SHAPES, ModelConfig, ShapeCell,
                                       shape_by_name)
from repro_torch.models.params import batch_axes, shard_shape
from repro_torch.roofline import analysis as RA
from repro_torch.training import lm_serve, train_lib
from repro_torch.training import optimizer as opt

SKIP_LONG = "skip: long_500k needs sub-quadratic attention (DESIGN.md §4)"


def cell_is_legal(cfg: ModelConfig, cell: ShapeCell) -> Tuple[bool, str]:
    if cell.name == "long_500k" and not cfg.is_subquadratic:
        return False, SKIP_LONG
    return True, ""


def _batch_axes(mesh, cfg: Optional[ModelConfig] = None) -> Tuple[str, ...]:
    return batch_axes(mesh, cfg is not None and cfg.tp_strategy == "dp_only")


def probe_depths(cfg: ModelConfig) -> Tuple[int, int]:
    """Two reduced depths (multiples of any periodic-block period)."""
    period = (cfg.attn_every if cfg.family == "hybrid"
              else cfg.cross_attn_every if cfg.family == "vlm" else 1)
    return period, 2 * period


def reduced(cfg: ModelConfig, n_layers: int) -> ModelConfig:
    """The reduced-depth probe config: ``remat`` as configured (recompute
    shows in MODEL_FLOPS / FLOPs), one microbatch (one full-batch pass has
    the FLOPs of the microbatches')."""
    return dataclasses.replace(cfg, n_layers=n_layers, scan_layers=False,
                               microbatches=1)


def useful_model_flops(cfg: ModelConfig, cell: ShapeCell) -> float:
    """MODEL_FLOPS: 6·N·D (dense) / 6·N_active·D (MoE) plus the causal
    attention quadratic term the 6ND rule omits (PaLM-style MFU
    accounting)."""
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    n = cfg.active_params() if cfg.n_experts else cfg.n_params()
    if cell.kind == "train":
        base = RA.model_flops_train(n, tokens)
    elif cell.kind == "decode":
        base = RA.model_flops_decode(n, tokens)
    else:
        base = RA.model_flops_train(n, tokens) / 3.0
    h, dh = cfg.n_heads, cfg.head_dim_
    if cfg.family == "ssm":
        n_attn_layers = 0
    elif cfg.family == "hybrid":
        n_attn_layers = lm.n_sites(cfg)
    else:
        n_attn_layers = cfg.n_layers
    if n_attn_layers:
        s = cell.seq_len
        kv_span = min(s, cfg.window) if cfg.window is not None else s
        if cell.kind == "decode":
            per_layer = 4.0 * cell.global_batch * h * kv_span * dh
        else:
            fwd = 2.0 * cell.global_batch * s * kv_span * h * dh  # causal 1/2
            per_layer = fwd * (3.0 if cell.kind == "train" else 1.0)
        base += per_layer * n_attn_layers
    return base


# ---------------------------------------------------------------------------
# Counting a cell on fake tensors
# ---------------------------------------------------------------------------

def _fake_like(tree):
    """Each ``meta`` tensor of a tree as a fake CPU tensor (call under
    ``FakeTensorMode``); other leaves as they are."""
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype)
    if isinstance(tree, dict):
        return {k: _fake_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_fake_like(v) for v in tree]
    return tree


def _counted(make_inputs, step) -> RA.Counter:
    """``step(*make_inputs())`` on fake tensors, the step alone counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        inputs = make_inputs()
        with RA.Counter() as counter:
            step(*inputs)
    return counter


def _inputs(cfg: ModelConfig, cell: ShapeCell) -> Dict[str, Any]:
    return _fake_like(train_lib.input_specs(
        cfg, seq_len=cell.seq_len, global_batch=cell.global_batch,
        kind=cell.kind))


def count_train_cell(cfg: ModelConfig, cell: ShapeCell,
                     tcfg: Optional[train_lib.TrainConfig] = None
                     ) -> RA.Counter:
    """One training step at the cell's global batch: loss, gradients and
    the optimizer's update."""
    tcfg = tcfg or train_lib.TrainConfig(opt=train_lib.default_opt_config(cfg))

    def make():
        params = _fake_like(lm.abstract(cfg)[0])
        return params, opt.opt_init(params, tcfg.opt), _inputs(cfg, cell), 0
    return _counted(make, train_lib.make_train_step(cfg, tcfg))


def count_prefill_cell(cfg: ModelConfig, cell: ShapeCell) -> RA.Counter:
    """One prefill of the cell's batch to its last-position logits."""
    return _counted(lambda: (_fake_like(lm.abstract(cfg)[0]),
                             _inputs(cfg, cell)),
                    lm_serve.make_prefill_step(cfg))


def count_decode_cell(cfg: ModelConfig, cell: ShapeCell) -> RA.Counter:
    """One greedy decode step of the cell's batch against a cache of
    ``seq_len`` slots holding ``seq_len - 1`` tokens."""
    scfg = lm_serve.ServeConfig(max_seq_len=cell.seq_len, temperature=0.0)

    def make():
        cache = _fake_like(lm.abstract_cache(cfg, cell.global_batch,
                                             cell.seq_len)[0])
        cache["length"] = cell.seq_len - 1
        return (_fake_like(lm.abstract(cfg)[0]), cache,
                _inputs(cfg, cell)["token"])
    return _counted(make, lm_serve.make_serve_step(cfg, scfg))


def count_cell(cfg: ModelConfig, cell: ShapeCell) -> RA.Counter:
    if cell.kind == "decode":
        return count_decode_cell(cfg, cell)
    if cell.kind == "prefill":
        return count_prefill_cell(cfg, cell)
    return count_train_cell(cfg, cell)


# ---------------------------------------------------------------------------
# A rank's bytes, the collectives and the analysis of a cell
# ---------------------------------------------------------------------------

def _shard_bytes(values, specs, mesh) -> int:
    """Bytes of one rank's shards of a tree of (meta) tensors laid out by
    a tree of specs of the same structure."""
    if isinstance(values, torch.Tensor):
        return math.prod(shard_shape(values.shape, specs, mesh)) * \
            values.element_size()
    if isinstance(values, dict):
        return sum(_shard_bytes(values[k], specs[k], mesh) for k in specs)
    if isinstance(values, list):
        return sum(_shard_bytes(v, s, mesh) for v, s in zip(values, specs))
    return 0


def memory(cfg: ModelConfig, cell: ShapeCell, mesh,
           tcfg: Optional[train_lib.TrainConfig] = None) -> Dict[str, Any]:
    """``argument_bytes``: one rank's shards of what the step takes, exact
    from the shard shapes: the parameters, and the optimizer state and the
    batch (train), the batch (prefill), or the cache and the token
    (decode).  ``temp_bytes`` and ``peak_bytes`` are None: nothing counts
    the live bytes of the step."""
    params, pspecs = lm.abstract(cfg, mesh)
    total = _shard_bytes(params, pspecs, mesh)
    if cell.kind == "decode":
        cache, cspecs = lm.abstract_cache(cfg, cell.global_batch,
                                          cell.seq_len, mesh,
                                          batch_axes=_batch_axes(mesh, cfg))
        total += _shard_bytes(cache, cspecs, mesh)
    else:
        if cell.kind == "train":
            tcfg = tcfg or train_lib.TrainConfig(
                opt=train_lib.default_opt_config(cfg))
            state, sspecs = opt.opt_abstract(
                lm.param_decls(cfg), tcfg.opt, mesh,
                rules=lm.sharding_rules(cfg, mesh))
            total += _shard_bytes(state, sspecs, mesh)
    batch, bspecs = train_lib.input_specs(
        cfg, seq_len=cell.seq_len, global_batch=cell.global_batch,
        kind=cell.kind, mesh=mesh)
    total += _shard_bytes(batch, bspecs, mesh)
    return {"output_bytes": None, "temp_bytes": None,
            "argument_bytes": total, "peak_bytes": None}


def analyze(counter: RA.Counter, coll: RA.CollectiveStats, chips: int,
            count_s: float, mem: Optional[Dict] = None,
            model_flops: float = 0.0) -> Dict[str, Any]:
    """A cell's record: the counted FLOPs and bytes (the whole step, all
    chips), the collectives (per rank, times ``chips``) and the terms."""
    terms = counter.terms(chips=chips,
                          collective_bytes=float(coll.total_bytes) * chips,
                          model_flops=model_flops)
    return {"count_s": round(count_s, 2), "memory": mem or {},
            "collectives": {"bytes": coll.bytes_by_op,
                            "count": coll.count_by_op},
            "kernels": counter.kernels, **terms.to_dict()}


def analyze_cell(cfg: ModelConfig, cell: ShapeCell, mesh,
                 model_flops: float = 0.0) -> Dict[str, Any]:
    t0 = time.perf_counter()
    counter = count_cell(cfg, cell)
    count_s = time.perf_counter() - t0
    coll = RA.lm_collectives(cfg, cell.kind, cell.seq_len,
                             cell.global_batch, mesh)
    return analyze(counter, coll, mesh.size, count_s,
                   memory(cfg, cell, mesh), model_flops)


def roofline_cell(arch: str, cell: ShapeCell, mesh, chips: int,
                  cfg: Optional[ModelConfig] = None) -> Dict[str, Any]:
    """Two-point depth extrapolation of FLOPs / bytes / collective bytes,
    as the reference probes its cells."""
    cfg = cfg or get_config(arch)
    l1, l2 = probe_depths(cfg)
    probes = [analyze_cell(reduced(cfg, L), cell, mesh) for L in (l1, l2)]
    full_L = cfg.n_layers
    ex = lambda k: RA.extrapolate(probes[0][k], probes[1][k], l1, l2, full_L)
    mf = useful_model_flops(cfg, cell)
    terms = RA.RooflineTerms(
        flops=ex("flops"), hbm_bytes=ex("hbm_bytes"),
        collective_bytes=ex("collective_bytes"), chips=chips, model_flops=mf)
    keys = ("flops", "hbm_bytes", "collective_bytes", "count_s")
    return {"probe_l1": {k: probes[0][k] for k in keys},
            "probe_l2": {k: probes[1][k] for k in keys},
            "probe_depths": [l1, l2],
            **terms.to_dict()}


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             do_full: bool = True, do_roofline: bool = True,
             smoke: bool = False) -> Dict[str, Any]:
    cfg = smoke_config(arch) if smoke else get_config(arch)
    cell = shape_by_name(shape_name)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": "2x16x16" if multi_pod else "16x16"}
    legal, why = cell_is_legal(cfg, cell)
    if not legal:
        rec["status"] = why
        return rec
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    try:
        if do_full:
            rec["full"] = analyze_cell(cfg, cell, mesh,
                                       useful_model_flops(cfg, cell))
        if do_roofline and not multi_pod:
            rec["roofline"] = roofline_cell(arch, cell, mesh, chips, cfg)
        rec["status"] = "ok"
    except Exception as e:
        rec["status"] = f"FAIL: {type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def gbdt_round_inputs(cfg, n: int, m: int, seed: int = 0,
                      device="cpu") -> Dict[str, Any]:
    """One round's inputs at ``n`` rows: random codes (n, m) and their
    transpose, labels (multiclass) or targets, F at zero; and the round's
    config as `boosting.SketchBoost.fit` runs it."""
    from repro_torch.core import histogram as H
    gen = torch.Generator(device=device).manual_seed(seed)
    d = cfg.n_outputs
    codes = torch.randint(0, cfg.n_bins, (n, m), generator=gen,
                          device=device, dtype=torch.int32).to(torch.uint8)
    if cfg.loss == "multiclass":
        Y = torch.randint(0, d, (n,), generator=gen, device=device)
    else:
        Y = torch.randn((n, d), generator=gen, device=device)
    run_cfg = dataclasses.replace(
        cfg, hist_engine=H.resolve_hist_engine(cfg.hist_engine)).strip_io()
    return dict(F=torch.zeros((n, d), device=device), codes=codes,
                codes_t=codes.t().contiguous(), Y=Y, cfg=run_cfg,
                generator=gen)


def count_gbdt_round(F, codes, codes_t, Y, cfg, generator=None,
                     eval_set=None) -> RA.Counter:
    """One boosting round (`boosting.boost_round`) under the counter, on
    real tensors of any device; with ``eval_set = (codes_v, Fv, Yv)`` also
    the fit's eval of the round (the tree applied to ``Fv`` through B3 and
    the loss on it), as `SketchBoost.fit` times a round."""
    from repro_torch.core import boosting as BO
    from repro_torch.core import losses as L
    counter = RA.Counter()
    with counter:
        tree = BO.boost_round(F, codes, codes_t, Y, cfg, generator=generator)
        if eval_set is not None:
            codes_v, Fv, Yv = eval_set
            Fv = BO._apply_tree(tree, codes_v, Fv, cfg)
            float(L.get_loss(cfg.loss).value(Fv, Yv))
    return counter


def run_gbdt(*, multi_pod: bool = False,
             probe_rows: Tuple[int, int] = (16_384, 32_768)
             ) -> Dict[str, Any]:
    """The paper's cell: one round's FLOPs and bytes from real CPU rounds
    at the two ``probe_rows`` row counts, extrapolated linearly in the
    rows to the cell's 2,097,152 (the work of the round itself; the ranks'
    repeated per-node work is not added); a rank's input bytes from
    `core.distributed.gbdt_input_specs`; the histogram all-reduce's bytes
    from `core.distributed.round_collective_bytes`."""
    from repro_torch.core import distributed as GD
    mesh = make_production_mesh(multi_pod=multi_pod)
    cfg, n_rows, n_features = get_gbdt_config()
    rec: Dict[str, Any] = {
        "arch": "sketchboost-gbdt", "mesh": "2x16x16" if multi_pod else "16x16",
        "shape": f"2Mx100 d={cfg.n_outputs} "
                 f"sketch={'off' if cfg.sketch_method == 'none' else 'on'}"}
    try:
        t0 = time.perf_counter()
        baxes = _batch_axes(mesh)
        probes = []
        for n in probe_rows:
            inp = gbdt_round_inputs(cfg, n, n_features)
            probes.append(count_gbdt_round(
                inp["F"], inp["codes"], inp["codes_t"], inp["Y"],
                inp["cfg"], inp["generator"]))
        ex = lambda v1, v2: RA.extrapolate(v1, v2, *probe_rows, n_rows)
        counter = RA.Counter()
        counter.flops = ex(probes[0].flops, probes[1].flops)
        counter.hbm_bytes = ex(probes[0].hbm_bytes, probes[1].hbm_bytes)
        counter.kernels = {
            name: {k: v if k == "calls" else ex(probes[0].kernels[name][k], v)
                   for k, v in k2.items()}
            for name, k2 in probes[1].kernels.items()}
        coll = RA.gbdt_collectives(cfg, n_features, cfg.n_outputs, mesh,
                                   baxes)
        specs = GD.gbdt_input_specs(n_rows, n_features, cfg.n_outputs, mesh,
                                    cfg, row_axes=baxes)
        arg = sum(_shard_bytes(v[0], v[1], mesh) for v in specs.values()
                  if v is not None)
        mem = {"output_bytes": None, "temp_bytes": None,
               "argument_bytes": arg, "peak_bytes": None}
        rec["full"] = analyze(counter, coll, mesh.size,
                              time.perf_counter() - t0, mem)
        rec["full"]["probe_rows"] = list(probe_rows)
        rec["status"] = "ok"
    except Exception as e:
        rec["status"] = f"FAIL: {type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=[s.name for s in LM_SHAPES])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--gbdt", action="store_true")
    ap.add_argument("--no-full", action="store_true",
                    help="skip the full-depth count (roofline probes only)")
    ap.add_argument("--no-roofline", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    results = []
    if args.gbdt:
        results.append(run_gbdt(multi_pod=args.multi_pod))
        print(json.dumps(results[-1], indent=2, default=str))
    elif args.all:
        for arch in ARCH_NAMES:
            for cell in LM_SHAPES:
                print(f"=== {arch} x {cell.name} "
                      f"({'multi' if args.multi_pod else 'single'}-pod)",
                      flush=True)
                rec = run_cell(arch, cell.name, multi_pod=args.multi_pod,
                               do_full=not args.no_full,
                               do_roofline=not args.no_roofline)
                print(json.dumps({k: v for k, v in rec.items()
                                  if k not in ("traceback",)},
                                 default=str)[:600], flush=True)
                results.append(rec)
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape (or --all / --gbdt) required")
        rec = run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                       do_full=not args.no_full,
                       do_roofline=not args.no_roofline)
        results.append(rec)
        print(json.dumps(rec, indent=2, default=str))

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=str)
        print(f"wrote {args.out}")
    n_fail = sum(1 for r in results
                 if str(r.get("status", "")).startswith("FAIL"))
    print(f"[dryrun] {len(results)} cells, {n_fail} failures")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
