"""Start a ``torch.distributed`` world of local processes and run a named
function on every rank.

    results = spawn("repro_torch.launch.dist:run_cases", 4, workdir,
                    backend="gloo", device="cpu", payload={...})

`spawn` writes the payload to ``workdir``, starts ``world_size`` fresh
interpreters (``python -m repro_torch.launch.dist``), each of which joins
the world through a ``FileStore`` in ``workdir`` (no TCP port to pick, so
several worlds can run side by side), calls ``fn(payload, ctx)`` and saves
what it returns.  A rank that fails fails the call: the others are
stopped and the rank's error is raised.  A rank imports neither ``jax``
nor the JAX package; `spawn` checks that too.

The backend is the caller's: NCCL with one card a rank, gloo where ranks
share a card (each rank then sets its card with ``torch.cuda.set_device``)
or on the CPU.  Under ``torchrun`` no spawn is needed: `launch.mesh.
make_mesh` joins the world from its ``env://`` variables.

`run_cases` is the function ``chip_smoke.py`` and the tests run on every
rank: a list of distributed fits, each on its own mesh over the first
ranks of the world.  A caller with cases of other kinds runs them through
its own function, which hands them to `run_cases` as ``other``.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.device import resolve_device

SRC = str(Path(__file__).resolve().parents[2])


class RankContext(NamedTuple):
    rank: int
    world_size: int
    backend: str
    device: torch.device


def _tail(path: Path, n: int = 4000) -> str:
    try:
        return path.read_text(errors="replace")[-n:]
    except OSError:
        return ""


def spawn(fn: str, world_size: int, workdir, *, backend: str,
          device=None, payload: Any = None, timeout: float = 600.0,
          threads: int = 1, pythonpath: Sequence[str] = ()) -> List[Any]:
    """Run ``fn`` (``"module:function"``) on every rank of a new world of
    ``world_size`` processes; returns each rank's result, in rank order.
    ``device`` is each rank's device, resolved here by the port's device
    rule (None is CUDA, and raises without a card; ``"cuda:0"`` puts every
    rank on card 0).  ``pythonpath`` adds directories the ranks import
    ``fn``'s module from.  Raises RuntimeError if a rank fails, or when
    ``timeout`` seconds pass; every process it started has ended when it
    returns."""
    device = str(resolve_device(device))
    work = Path(workdir)
    work.mkdir(parents=True, exist_ok=True)
    store = work / "store"
    if store.exists():
        store.unlink()
    torch.save(payload, work / "payload.pt")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [SRC] + [str(p) for p in pythonpath]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    env["OMP_NUM_THREADS"] = str(threads)
    procs = []
    for r in range(world_size):
        out = open(work / f"rank{r}.log", "w")
        cmd = [sys.executable, "-m", "repro_torch.launch.dist",
               "--fn", fn, "--rank", str(r), "--world-size", str(world_size),
               "--backend", backend, "--device", device,
               "--threads", str(threads), "--workdir", str(work)]
        procs.append((subprocess.Popen(cmd, env=env, stdout=out,
                                       stderr=subprocess.STDOUT), out))
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while True:
            codes = [p.poll() for p, _ in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = bad[0]
                break
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"world of {world_size} ranks running {fn} passed its "
                    f"{timeout} s limit; rank 0 said:\n"
                    + _tail(work / "rank0.log"))
            time.sleep(0.05)
    finally:
        for p, out in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            out.close()
    if failed is not None:
        raise RuntimeError(
            f"rank {failed} of {world_size} running {fn} exited with code "
            f"{procs[failed][0].returncode}:\n"
            + _tail(work / f"rank{failed}.log"))
    results = []
    for r in range(world_size):
        res = torch.load(work / f"result{r}.pt", weights_only=False)
        if res["imported"]:
            raise RuntimeError(f"rank {r} imported {res['imported']}")
        results.append(res["result"])
    return results


def _worker(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fn", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--backend", required=True)
    ap.add_argument("--device", required=True)
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--workdir", required=True)
    a = ap.parse_args(argv)
    import importlib
    import torch.distributed as dist

    torch.set_num_threads(a.threads)
    device = torch.device(a.device)
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
        device = torch.device("cuda", torch.cuda.current_device())
    work = Path(a.workdir)
    dist.init_process_group(
        a.backend, store=dist.FileStore(str(work / "store"), a.world_size),
        rank=a.rank, world_size=a.world_size)
    try:
        module, name = a.fn.split(":")
        fn = getattr(importlib.import_module(module), name)
        payload = torch.load(work / "payload.pt", weights_only=False)
        result = fn(payload, RankContext(a.rank, a.world_size, a.backend,
                                         device))
        imported = sorted(k for k in sys.modules
                          if k.split(".")[0] in ("jax", "repro"))
        tmp = work / f"result{a.rank}.pt.tmp"
        torch.save({"result": result, "imported": imported}, tmp)
        os.replace(tmp, work / f"result{a.rank}.pt")
    finally:
        dist.destroy_process_group()
    return 0


# -- the cases a world runs --------------------------------------------------------

def _launch_counts() -> Dict[str, int]:
    from repro_torch.kernels import hist_kernel, predict_kernel, split_kernel
    ks = (hist_kernel.KERNEL, hist_kernel.KERNEL_BF16,
          hist_kernel.DIRECT_KERNEL, split_kernel.KERNEL,
          split_kernel.WIDE_KERNEL, predict_kernel.KERNEL)
    return {k.name: k.launches for k in ks}


def _host(x):
    """Tensors (in nests) as numpy arrays."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(_host(v) for v in x)
    if hasattr(x, "_fields"):
        return {f: _host(getattr(x, f)) for f in x._fields}
    return x


def _sha256(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().numpy()
                          .tobytes()).hexdigest()


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _fit_case(case, arrays, mesh, ctx) -> Dict[str, Any]:
    import dataclasses
    from repro_torch.core import boosting as B
    from repro_torch.core import distributed as D
    from repro_torch.core import forest as FO
    from repro_torch.core import losses as L
    from repro_torch.runtime import chaos as CH
    from repro_torch.runtime import fault as FT

    cfg = B.GBDTConfig(**case["cfg"])
    kw = dict(case.get("kw", {}))
    for key in ("sketch_mats", "collective_mats", "base_score"):
        if isinstance(kw.get(key), str):
            kw[key] = arrays[kw[key]]
    row_axes = tuple(kw.pop("row_axes", ("data",)))
    chaos = []
    if case.get("kill_at") is not None:
        chaos.append(CH.KillAtRound(case["kill_at"]))
    if case.get("nan_at") is not None:
        chaos.append(CH.NaNAtRow(*case["nan_at"]))
    watchdog = FT.StragglerWatchdog(window=10_000)
    out: Dict[str, Any] = {}
    before = _launch_counts()
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    mesh.reset_counts()
    _sync(ctx.device)
    t0 = time.perf_counter()
    try:
        F_l, forest, history = D.fit_distributed(
            cfg, mesh, arrays[case["codes"]], arrays[case["Y"]],
            row_axes=row_axes, chaos=chaos, watchdog=watchdog, **kw)
    except CH.ChaosKill as e:           # the case asked for this kill
        return {"killed_at": e.round}
    except (ValueError, NotImplementedError) as e:
        if not case.get("expect_error"):
            raise
        return {"error": f"{type(e).__name__}: {e}"}
    if case.get("expect_error"):
        raise AssertionError(f"case {case['name']} expected an error")
    _sync(ctx.device)
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = {k: v - before[k] for k, v in _launch_counts().items()}
    out["round_s"] = list(watchdog.times)
    out["bytes"] = {f"{ax}/{tag}": v for (ax, tag), v in mesh.counted.items()}
    out["coords"] = dict(mesh.coords)
    if ctx.device.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(ctx.device)
    out["F_local_sha256"] = _sha256(F_l)
    if case.get("return_F"):
        F = mesh.gather(F_l, row_axes, "model")
        if mesh.rank == 0:
            out["F"] = F.cpu().numpy()
    if mesh.rank == 0:
        out["forest"] = _host(forest)
        out["history"] = history
    pred = case.get("predict")
    if pred and mesh.rank == 0:
        codes = torch.as_tensor(arrays[pred["codes"]]).to(ctx.device)
        base = torch.as_tensor(np.asarray(
            kw.get("base_score", np.zeros(cfg.n_outputs, np.float32)),
            np.float32)).to(ctx.device)
        packed = FO.pack_forest(
            forest, base, cfg.learning_rate, strategy=cfg.strategy,
            max_depth=cfg.depth if cfg.growth == "leafwise" else None)
        b3 = _launch_counts()
        _sync(ctx.device)
        t0 = time.perf_counter()
        raw = FO.predict_raw(packed, codes,
                             row_chunk=cfg.predict_row_chunk)
        _sync(ctx.device)
        out["predict_s"] = time.perf_counter() - t0
        out["predict_launches"] = {k: v - b3[k]
                                   for k, v in _launch_counts().items()}
        Yv = torch.as_tensor(arrays[pred["labels"]]).to(ctx.device)
        if cfg.loss == "multiclass" and Yv.ndim == 1:
            Yv = Yv.long()
        out["valid_loss"] = float(L.get_loss(cfg.loss).value(raw, Yv))
        out["predict_finite"] = bool(torch.isfinite(raw).all())
        out["predict_shape"] = tuple(raw.shape)
    if case.get("bytes_model"):
        # The model of the histogram all-reduces of this run's rounds (a
        # leaf-wise tree counted at the leaves it grew).
        m = int(np.asarray(arrays[case["codes"]]).shape[1])
        tp = mesh.axis_size("model")
        m_b = m // tp if kw.get("feature_shard") else m
        d_b = (cfg.n_outputs // tp if cfg.strategy == "one_vs_all"
               else cfg.n_outputs)
        counts = getattr(forest, "node_count", None)
        if cfg.growth == "leafwise" and cfg.strategy == "one_vs_all":
            # This rank's trees, a leaf count each.
            mi = mesh.index("model")
            counts = counts.reshape(counts.shape[0], -1)[
                :, mi * d_b:(mi + 1) * d_b]
            d_b = 1
        leaves = ([int(c + 1) // 2 for c in counts.reshape(-1)]
                  if cfg.growth == "leafwise" else [0] * forest.feat.shape[0])
        out["hist_bytes_model"] = sum(
            D.round_collective_bytes(dataclasses.replace(
                cfg, max_leaves=lv or cfg.max_leaves), m_b, d_b)
            ["moved_bytes"] for lv in leaves)
        out["hist_bytes"] = sum(v for (ax, tag), v in mesh.counted.items()
                                if tag == "hist" and ax in row_axes)
    return out


def _lm_case(case, arrays, mesh, ctx) -> Dict[str, Any]:
    """One rank's share of LM training steps on ``mesh``
    (`training.train_lib.make_train_step`): the parameters from
    ``arrays[case["params"]]`` (a whole tree) or drawn from
    ``case["seed"]`` on the CPU, cut to this rank's blocks; the batch
    ``{name: arrays key}`` cut to its rows.  With ``grads`` the gradients
    of the first batch are gathered first; with ``plans`` every MoE
    routing plan of that gradient's forward is recorded.  Returns the
    losses, grad norms, the first step's counted collectives (``by_op``,
    ``calls``), B7's forward and backward launches, the seconds and peak
    memory, and this rank's q and kv heads; on mesh rank 0 also the
    gathered gradients and the parameters after the steps."""
    import dataclasses
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import lm
    from repro_torch.models import moe as Moe
    from repro_torch.models import params as PM
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_lib

    base = (smoke_config(case["arch"]) if case.get("smoke", True)
            else get_config(case["arch"]))
    cfg = dataclasses.replace(base, **case.get("cfg", {}))
    ocfg = opt.OptConfig(**case.get("opt", {}))
    dev = ctx.device
    specs = train_lib.mesh_specs(cfg, mesh)
    layout = train_lib.mesh_layout(cfg, mesh)
    full = (arrays[case["params"]] if case.get("params") else
            lm.init(cfg, torch.Generator().manual_seed(case.get("seed", 0)),
                    device="cpu"))
    params = PM.shard_tree(full, specs, mesh, device=dev)
    del full
    top = mesh.rank == 0
    whole = {k: arrays[v] for k, v in case["batch"].items()}
    batch = train_lib.local_batch(whole, mesh, cfg)
    attn = params["blocks"][0].get("attn")
    hd = cfg.head_dim_
    out: Dict[str, Any] = {"coords": dict(mesh.coords), "local_heads": (
        None if attn is None else (attn["wq"].shape[1] // hd,
                                   attn["wk"].shape[1] // hd))}
    if case.get("grads"):
        plans, plan = [], Moe.moe_plan

        def recording(*a, **kw):
            res = plan(*a, **kw)
            plans.append({k: res[k].cpu().numpy()
                          for k in ("gidx", "slot", "in_cap")})
            return res
        Moe.moe_plan = recording if case.get("plans") else plan
        try:
            loss, grads = train_lib.make_grad_fn(cfg, mesh)(params, batch)
        finally:
            Moe.moe_plan = plan
        full_g = PM.gather_tree(grads, specs, mesh)
        if top:
            out["grad_loss"] = float(loss)
            out["grads"] = _host(full_g)
            out["plans"] = plans
        del grads, full_g
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    state = opt.opt_init(params, ocfg, layout)
    step_fn = train_lib.make_train_step(
        cfg, train_lib.TrainConfig(opt=ocfg), mesh)
    launches0 = (FA.KERNEL.launches, FA.BWD_KERNEL.launches)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, norms, secs = [], [], []
    for i in range(case.get("steps", 1)):
        mesh.reset_counts()
        _sync(dev)
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, batch,
                                   case.get("step", 0) + i)
        _sync(dev)
        secs.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if i == 0:
            out["by_op"] = dict(mesh.by_op)
            out["calls"] = dict(mesh.calls)
            out["launches"] = {
                FA.KERNEL.name: FA.KERNEL.launches - launches0[0],
                FA.BWD_KERNEL.name: FA.BWD_KERNEL.launches - launches0[1]}
    out.update(losses=losses, grad_norms=norms, step_s=secs)
    if dev.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    if case.get("return_params", True):
        full_p = PM.gather_tree(params, specs, mesh)
        if top:
            out["params"] = _host(full_p)
        del full_p
    return out


def run_cases(payload: Dict[str, Any], ctx: RankContext,
              other: Optional[Callable] = None) -> Dict[str, Any]:
    """Run every case of ``payload["cases"]`` on this rank, in order, and
    return ``{name: result}`` (None where the rank is outside the case's
    mesh).  A case names its mesh ``(shape, axes)`` over the first ranks
    of the world, its kind (``"fit"``, the default, runs `core.distributed.
    fit_distributed`; ``"lm"`` LM training steps, `_lm_case`; any other
    kind goes to ``other(case, arrays, mesh, ctx)``) and its arrays by key
    into ``payload["arrays"]``."""
    from repro_torch.launch.mesh import make_mesh

    arrays = payload.get("arrays", {})
    meshes: Dict[Any, Any] = {}
    results: Dict[str, Any] = {}
    for case in payload["cases"]:
        shape, axes = case["mesh"]
        key = (tuple(shape), tuple(axes))
        if key not in meshes:
            meshes[key] = make_mesh(key[0], key[1], device=ctx.device)
        mesh = meshes[key]
        if mesh is None:
            results[case["name"]] = None
            continue
        kind = case.get("kind", "fit")
        if kind == "fit":
            results[case["name"]] = _fit_case(case, arrays, mesh, ctx)
        elif kind == "lm":
            results[case["name"]] = _lm_case(case, arrays, mesh, ctx)
        elif other is not None:
            results[case["name"]] = other(case, arrays, mesh, ctx)
        else:
            raise ValueError(f"unknown case kind {kind!r}")
    return results


if __name__ == "__main__":
    try:
        sys.exit(_worker())
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        raise
