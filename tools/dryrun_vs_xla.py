#!/usr/bin/env python3
"""The port's counted FLOPs beside XLA's ``cost_analysis`` of the JAX
package's same step, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/dryrun_vs_xla.py [--arch h2o-danube-3-4b]
        [--batch 8] [--seq 256]

One smoke cell: ``smoke_config(arch)`` unrolled (``scan_layers=False``, so
XLA counts every layer) with one microbatch, a train step and a prefill at
``batch x seq`` tokens.  The reference's step (``repro.training.train_lib``,
``lm_serve.make_prefill_step``) is lowered and compiled once for a single CPU
device, its abstract inputs from ``repro.models.lm.abstract``; the port's is
counted on fake tensors by ``repro_torch.launch.dryrun``.  Prints one JSON
line: each package's FLOPs and their ratio.  XLA counts elementwise and
transcendental ops as FLOPs as well and runs its ``use_pallas=False``
chunked attention; the port counts matrix products (``FlopCounterMode``'s
rule) and B7 by its design's formula.  A comparison, not a test: this
imports both packages.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))


def reference_flops(arch: str, batch: int, seq: int) -> dict:
    import jax
    import jax.numpy as jnp
    from repro.configs import smoke_config
    from repro.models import lm
    from repro.training import lm_serve, optimizer, train_lib
    cfg = dataclasses.replace(smoke_config(arch), scan_layers=False,
                              microbatches=1)
    tcfg = train_lib.TrainConfig(opt=train_lib.default_opt_config(cfg))
    params = lm.abstract(cfg)
    out = {}
    for kind in ("train", "prefill"):
        specs = train_lib.input_specs(cfg, seq_len=seq, global_batch=batch,
                                      kind=kind)
        if kind == "train":
            state = optimizer.opt_abstract(lm.param_decls(cfg), tcfg.opt)
            lowered = jax.jit(train_lib.make_train_step(cfg, tcfg)).lower(
                params, state, specs, jax.ShapeDtypeStruct((), jnp.int32))
        else:
            lowered = jax.jit(lm_serve.make_prefill_step(cfg)).lower(
                params, specs)
        cost = lowered.compile().cost_analysis()
        cost = cost[0] if isinstance(cost, (list, tuple)) else cost
        out[kind] = float(cost.get("flops", 0.0))
    return out


def port_flops(arch: str, batch: int, seq: int) -> dict:
    from repro_torch.configs import smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.models.config import ShapeCell
    cfg = dataclasses.replace(smoke_config(arch), scan_layers=False,
                              microbatches=1)
    return {kind: float(dryrun.count_cell(
        cfg, ShapeCell(f"smoke_{kind}", seq, batch, kind)).flops)
        for kind in ("train", "prefill")}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="h2o-danube-3-4b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    args = ap.parse_args()
    ref = reference_flops(args.arch, args.batch, args.seq)
    port = port_flops(args.arch, args.batch, args.seq)
    print(json.dumps({"arch": args.arch, "batch": args.batch,
                      "seq": args.seq, "xla_flops": ref, "port_flops": port,
                      "port_over_xla": {k: port[k] / ref[k] for k in ref}}))


if __name__ == "__main__":
    main()
