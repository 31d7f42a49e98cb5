"""Training launcher: any assigned LM arch, or the GBDT workload, end to end
with checkpoint/restart.

The port of the JAX package's ``launch/train.py``, with its arguments and
printed lines, plus ``--device`` (the device rule: the card unless
``--device cpu``).  Reduced configs by default; ``--full-config`` on the
card.  Examples:

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-7b \\
      --steps 20 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch sketchboost-gbdt \\
      --rows 20000 --outputs 16 --trees 50
  PYTHONPATH=src python -m repro_torch.launch.train --arch sketchboost-gbdt \\
      --dist --device cpu

The LM loop runs on `runtime.fault.RestartableLoop` when ``--ckpt-dir`` is
given.  It draws the step's batch by index from one stream, so a resumed
run skips the batches its checkpoint already consumed and continues bit
for bit; the reference's loop restarts its stream instead.  ``--dist``
fits through `core.distributed.fit_distributed` on a ``(data, model)``
mesh of the ``torch.distributed`` world: under ``torchrun`` the world
comes from its ``env://`` variables, otherwise this process starts a
one-rank world itself (NCCL on the card, gloo on the CPU).

``--mesh`` trains an LM on `launch.mesh.host_device_mesh(--model-parallel)`
of the same kind of world (`train_lib.make_train_step` on a mesh: FSDP
over ``data``, tensor and expert parallelism over ``model``), e.g. on
four CPU ranks:

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch h2o-danube-3-4b --mesh --model-parallel 2 --device cpu

Every rank draws the same parameters from ``--seed``, keeps its blocks,
and keeps its rows of each global batch.  Rank 0 prints and logs.  With
``--ckpt-dir`` rank 0 writes the gathered parameters and optimizer state,
and a resumed run cuts them to its blocks again.  ``--compress`` has
nothing to port for an LM (`train_lib.COMPRESS_NOT_PORTED`) and raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import ARCH_NAMES, get_config, smoke_config
from repro_torch.core.device import resolve_device
from repro_torch.data import pipeline as data
from repro_torch.models import lm
from repro_torch.runtime.fault import RestartableLoop
from repro_torch.training import optimizer as opt
from repro_torch.training import train_lib


class _BatchCursor:
    """Batch ``i`` of a stream, for steps asked in increasing order: the
    batches before it are drawn and dropped."""

    def __init__(self, it):
        self.it = it
        self.next = 0

    def get(self, i: int):
        while self.next < i:
            next(self.it)
            self.next += 1
        self.next += 1
        return next(self.it)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_lm(args, chaos: Any = None) -> Dict[str, Any]:
    """``chaos`` takes `runtime.chaos` injections for the restartable loop
    (a kill at a step, for tests)."""
    cfg = get_config(args.arch) if args.full_config else smoke_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if args.d_model:
        hd = max(32, args.d_model // cfg.n_heads)
        cfg = dataclasses.replace(cfg, d_model=args.d_model, head_dim=hd,
                                  d_ff=0 if cfg.d_ff == 0 else 4 * args.d_model)
    if args.compress:
        raise NotImplementedError(train_lib.COMPRESS_NOT_PORTED)
    if args.mesh:
        import torch.distributed as dist
        started = not dist.is_initialized()
        with tempfile.TemporaryDirectory() as workdir:
            _world(resolve_device(args.device), workdir)
            try:
                return _train_lm(args, cfg, chaos, mesh=True)
            finally:
                if started:
                    dist.destroy_process_group()
    return _train_lm(args, cfg, chaos)


def _train_lm(args, cfg, chaos, mesh: bool = False) -> Dict[str, Any]:
    from repro_torch.models import params as PM
    tcfg = train_lib.TrainConfig(
        opt=opt.OptConfig(name=args.optimizer, lr=args.lr,
                          warmup_steps=min(100, args.steps // 10 + 1),
                          decay_steps=args.steps))
    device = resolve_device(args.device)
    m = None
    if mesh:
        from repro_torch.launch.mesh import host_device_mesh
        m = host_device_mesh(args.model_parallel, device=device)
        device = m.device
    step_fn = train_lib.make_train_step(cfg, tcfg, m)
    params = lm.init(cfg, torch.Generator(device=device).manual_seed(
        args.seed), device=device)
    n_params = sum(x.numel() for x in opt.tree_leaves(params))
    layout = train_lib.mesh_layout(cfg, m)
    if m is not None:
        params = PM.shard_tree(params, layout.specs, m)
    opt_state = opt.opt_init(params, tcfg.opt, layout)
    lead = m is None or m.rank == 0
    say = print if lead else (lambda *a, **k: None)
    say(f"[train] {cfg.name}: {n_params/1e6:.1f}M params, "
        f"batch={args.batch} seq={args.seq}"
        + ("" if m is None else f" mesh={m.shape}"))

    index, count = ((0, 1) if m is None else m.block_index(
        train_lib.make_axis_ctx(m, cfg).batch_axes))
    batches = data.ShardedPrefetcher(data.lm_batches(
        cfg.vocab_size, args.batch, args.seq, seed=args.seed,
        embed_dim=cfg.d_model if cfg.embed_inputs else 0,
        image_tokens=cfg.n_image_tokens if cfg.family == "vlm" else 0,
        d_model=cfg.d_model), device=device, process_index=index,
        process_count=count)
    cursor = _BatchCursor(batches)

    def loop_step(state, i):
        params, opt_state, step = state
        step = int(step)
        params, opt_state, metrics = step_fn(params, opt_state,
                                             cursor.get(i), step)
        _sync(device)
        return (params, opt_state, step + 1), metrics

    extra = {} if m is None else _mesh_checkpoints(
        args.ckpt_dir, m, layout, opt.opt_state_specs(params, tcfg.opt,
                                                      layout),
        (params, opt_state, 0))
    loop = RestartableLoop(args.ckpt_dir, loop_step,
                           save_every=args.save_every, chaos=chaos,
                           device=device, **extra) if args.ckpt_dir else None
    logs = []

    def on_metrics(step, m):
        rec = {"step": step, "loss": float(m["loss"]),
               "grad_norm": float(m["grad_norm"]),
               "step_time_s": m["step_time_s"]}
        logs.append(rec)
        if step % args.log_every == 0:
            say(f"[train] step {step} loss={rec['loss']:.4f} "
                f"gnorm={rec['grad_norm']:.2f} {rec['step_time_s']:.2f}s")

    state = (params, opt_state, 0)
    try:
        if loop is not None:
            state, _ = loop.run(state, None, args.steps, on_metrics)
        else:
            for i in range(args.steps):
                t0 = time.perf_counter()
                state, metrics = loop_step(state, i)
                on_metrics(i, {**metrics,
                               "step_time_s": time.perf_counter() - t0})
    finally:
        batches.close()
    final_loss = logs[-1]["loss"] if logs else float("nan")
    first_loss = logs[0]["loss"] if logs else float("nan")
    say(f"[train] done: loss {first_loss:.4f} -> {final_loss:.4f}")
    return {"first_loss": first_loss, "final_loss": final_loss, "logs": logs,
            "state": state, "mesh": m}


def _mesh_checkpoints(ckpt_dir: str, m, layout, opt_specs, like):
    """`RestartableLoop`'s ``save_fn``/``restore_fn`` on a mesh: every
    rank gathers the state, rank 0 writes it, the ranks wait for it; a
    restore reads the whole state (of ``like``'s structure) on every rank
    and cuts its blocks."""
    from repro_torch.distributed import collectives as C
    from repro_torch.io.checkpoint import CheckpointManager
    from repro_torch.models import params as PM
    mgr = CheckpointManager(ckpt_dir, async_save=False) if ckpt_dir else None

    def save_fn(step, state):
        params, opt_state, i = state
        whole = (PM.gather_tree(params, layout.specs, m),
                 PM.gather_tree(opt_state, opt_specs, m), i)
        if m.rank == 0:
            mgr.save(step, whole)
        C.barrier(m)

    def restore_fn():
        if mgr.latest_step() is None:
            return None
        (params, opt_state, i), step = mgr.restore(like, device="cpu")
        return (PM.shard_tree(params, layout.specs, m),
                PM.shard_tree(opt_state, opt_specs, m), i), step + 1

    return dict(save_fn=save_fn, restore_fn=restore_fn)



def _gbdt_data(args):
    X, y = data.make_tabular("multiclass", args.rows, args.features,
                             args.outputs, seed=args.seed)
    return data.train_test_split(X, y, seed=args.seed)


def train_gbdt(args) -> Dict[str, Any]:
    from repro_torch.core.boosting import GBDTConfig, SketchBoost
    if args.dist:
        return train_gbdt_dist(args)
    device = resolve_device(args.device)
    Xtr, Xte, ytr, yte = _gbdt_data(args)
    cfg = GBDTConfig(loss="multiclass", n_trees=args.trees, depth=6,
                     sketch_method=args.sketch, sketch_k=args.sketch_k,
                     learning_rate=args.lr if args.lr != 3e-4 else 0.1,
                     early_stopping_rounds=50,
                     guard_policy=args.guard_policy,
                     save_every=args.save_every if args.ckpt_dir else 0,
                     ckpt_dir=args.ckpt_dir,
                     resume_from=args.ckpt_dir if args.resume else "")
    _sync(device)
    t0 = time.perf_counter()
    model = SketchBoost(cfg, device=device).fit(
        Xtr, ytr, eval_set=(Xte, yte), verbose=True)
    _sync(device)
    dt = time.perf_counter() - t0
    loss = model.eval_loss(Xte, yte)
    acc = float((model.predict(Xte).argmax(1).cpu().numpy() == yte).mean())
    print(f"[gbdt] {args.sketch} k={args.sketch_k}: loss={loss:.4f} "
          f"acc={acc:.4f} time={dt:.1f}s")
    return {"loss": loss, "acc": acc, "time_s": dt}


def _world(device: torch.device, workdir: Optional[str]) -> str:
    """Join ``torchrun``'s world, or start a one-rank world through a
    ``FileStore`` in ``workdir``; returns the backend."""
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_backend()
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend=backend, init_method="env://")
    else:
        store = dist.FileStore(os.path.join(workdir, "store"), 1)
        dist.init_process_group(backend=backend, store=store, rank=0,
                                world_size=1)
    return backend


def train_gbdt_dist(args) -> Dict[str, Any]:
    """GBDT through `core.distributed` on a (data, model) mesh of the
    world's ranks: rows sharded over the data axis, outputs over the model
    axis; the trees are the single-device fit's on a (1, 1) mesh.
    ``--compress`` routes the histogram collective through the JL sketch
    (``--compress-rank`` is the channel width).  A world this call starts
    is ended before it returns."""
    import torch.distributed as dist
    from repro_torch.core import distributed as GD
    from repro_torch.core import forest as FO
    from repro_torch.core import quantize as Q
    from repro_torch.core.boosting import GBDTConfig
    from repro_torch.launch.mesh import device_subset_mesh

    device = resolve_device(args.device)
    Xtr, Xte, ytr, yte = _gbdt_data(args)
    started = not dist.is_initialized()
    with tempfile.TemporaryDirectory() as workdir:
        backend = _world(device, workdir)
        try:
            n_dev = dist.get_world_size()
            mp = args.model_parallel
            dp = max(n_dev // mp, 1)
            # fit_distributed shards rows over the data axis: trim the
            # ragged tail.
            n_tr = (len(ytr) // dp) * dp
            Xtr, ytr = Xtr[:n_tr], ytr[:n_tr]
            mesh = device_subset_mesh(dp * mp, mp, backend=backend,
                                      device=device)
            cfg = GBDTConfig(
                loss="multiclass", n_outputs=args.outputs,
                n_trees=args.trees, depth=6, sketch_method=args.sketch,
                sketch_k=args.sketch_k,
                learning_rate=args.lr if args.lr != 3e-4 else 0.1,
                seed=args.seed,
                dist_hist_compression="sketch" if args.compress else "none",
                dist_hist_k=args.compress_rank if args.compress else 0,
                guard_policy=args.guard_policy,
                save_every=args.save_every if args.ckpt_dir else 0,
                ckpt_dir=args.ckpt_dir,
                resume_from=args.ckpt_dir if args.resume else "")
            q = Q.fit_quantizer(Xtr, cfg.n_bins, device="cpu")
            codes_tr = Q.apply_quantizer(q, torch.as_tensor(Xtr)).t()
            _sync(device)
            t0 = time.perf_counter()
            F, forest, history = GD.fit_distributed(
                cfg, mesh, codes_tr.contiguous().numpy(), ytr, eval_every=10)
            _sync(device)
            dt = time.perf_counter() - t0
            pf = FO.pack_forest(forest, torch.zeros(args.outputs,
                                                    device=device),
                                cfg.learning_rate)
            codes_te = Q.apply_quantizer(q, torch.as_tensor(Xte)).t()
            scores = FO.predict_raw(pf, codes_te.contiguous().to(device))
            acc = float((scores.argmax(1).cpu().numpy() == yte).mean())
            bytes_model = GD.round_collective_bytes(cfg, args.features,
                                                    args.outputs)
            print(f"[gbdt-dist] mesh={dp}x{mp} {args.sketch} "
                  f"k={args.sketch_k} compress={cfg.dist_hist_compression}: "
                  f"acc={acc:.4f} time={dt:.1f}s "
                  f"moved={bytes_model['moved_bytes']}B/round")
        finally:
            if started:
                dist.destroy_process_group()
    return {"acc": acc, "time_s": dt, "mesh": f"{dp}x{mp}",
            "collective": bytes_model, "history": history}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True,
                    choices=ARCH_NAMES + ["sketchboost-gbdt"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor", "sgd"])
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--mesh", action="store_true",
                    help="LM: train on a (data, model) mesh of the "
                         "torch.distributed world's ranks (torchrun's, or a "
                         "one-rank world); --model-parallel sets the model "
                         "axis")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--compress", action="store_true",
                    help="with --dist, the GBDT histogram collective's "
                         "sketch (LM: nothing to port, raises)")
    ap.add_argument("--compress-rank", type=int, default=32)
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint directory; for the GBDT this enables "
                         "resumable round-boundary (format-v4) checkpoints")
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true",
                    help="resume the GBDT fit from --ckpt-dir's latest "
                         "round checkpoint (bit-identical continuation)")
    ap.add_argument("--guard-policy", default="off",
                    choices=["off", "raise", "skip_round", "clip"],
                    help="non-finite gradient guard")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain versions of the kernels)")
    # gbdt
    ap.add_argument("--rows", type=int, default=20000)
    ap.add_argument("--features", type=int, default=50)
    ap.add_argument("--outputs", type=int, default=16)
    ap.add_argument("--trees", type=int, default=100)
    ap.add_argument("--sketch", default="random_projection",
                    choices=["none", "top_outputs", "random_sampling",
                             "random_projection", "truncated_svd"])
    ap.add_argument("--sketch-k", type=int, default=5)
    ap.add_argument("--dist", action="store_true",
                    help="train the GBDT through core.distributed on a "
                         "(data, model) mesh of the torch.distributed world "
                         "(torchrun's, or a one-rank world); "
                         "--model-parallel sets the model axis, "
                         "--compress/--compress-rank the histogram-"
                         "collective compression")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    res = (train_gbdt(args) if args.arch == "sketchboost-gbdt"
           else train_lm(args))
    res.pop("state", None)
    m = res.pop("mesh", None)
    if args.out and (m is None or m.rank == 0):
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
