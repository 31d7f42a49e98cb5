"""The cases of kinds other than a fit that the port's distributed tests
run on every rank of a spawned world: the collectives, the mesh helpers,
the compressor, the sharded sketch, the eval, the elastic layouts, the
restores and the LM launcher on a mesh, each on this rank's blocks.

A rank imports this module by name (``spawn(..., pythonpath=[HERE])``), so
it imports neither ``jax`` nor the JAX package, as no rank may.
"""
from pathlib import Path
from typing import Any, Dict

import torch

from repro_torch.launch import dist as LD

HERE = str(Path(__file__).resolve().parent)
FN = "_torch_dist_cases:run_cases"


def run_cases(payload, ctx):
    """`launch.dist.run_cases`, with this module's kinds beside the fits."""
    return LD.run_cases(payload, ctx, other=_case)


def _case(case, arrays, mesh, ctx) -> Dict[str, Any]:
    """Checks of the collectives, the compressor, the sketch, the eval,
    the elastic layouts and the LM launcher on this rank's blocks."""
    from repro_torch.core import distributed as D
    from repro_torch.core import boosting as B
    from repro_torch.core import sketch as SK
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import compression as CP
    from repro_torch.io import checkpoint as CK
    from repro_torch.runtime import elastic as E
    from repro_torch.runtime import fault as FT

    kind = case["kind"]
    dev = ctx.device
    rows_l = E.Layout(mesh, ("data",))
    block_l = E.Layout(mesh, ("data",), "model")
    if kind == "sketched_psum":
        # Each data rank holds its own gradients: arrays[name][data index].
        g = {k: torch.as_tensor(v[mesh.index("data")]).to(dev)
             for k, v in arrays[case["grads"]].items()}
        Pis = [None if p is None else torch.as_tensor(p).to(dev)
               for p in arrays[case["Pis"]]]
        res = None
        outs = []
        for _ in range(case.get("steps", 1)):
            out, res = CP.sketched_psum(g, mesh, "data", k=case["k"],
                                        residuals=res, Pis=Pis)
            outs.append(LD._host(out))
        exact = CP.exact_psum(g, mesh, "data")
        return {"outs": outs, "residuals": LD._host(res),
                "exact": LD._host(exact),
                "ratio": CP.compression_ratio(g, case["k"])}
    if kind == "eval":
        cfg = B.GBDTConfig(**case["cfg"])
        F_l = E.remesh(torch.as_tensor(arrays[case["F"]]), block_l)
        Yh = torch.as_tensor(arrays[case["Y"]])
        Y_l = (E.remesh(Yh, rows_l).long() if Yh.ndim == 1
               else E.remesh(Yh, block_l).to(torch.float32))
        return {"loss": D.make_distributed_eval(mesh, cfg)(F_l, Y_l)}
    if kind == "sketch":
        G = torch.as_tensor(arrays[case["G"]])
        draw = case.get("draw")
        out = SK.sketch_sharded(
            E.remesh(G, block_l), method=case["method"], k=case["k"],
            mesh=mesh, draw=None if draw is None else
            torch.as_tensor(arrays[draw]))
        return {"sketch": mesh.gather(out, ("data",), None).cpu().numpy()}
    if kind == "collectives":
        x = torch.arange(6, dtype=torch.float32, device=dev) * (
            mesh.rank + 1)
        neg = torch.full((3,), -0.0, device=dev)
        gathered = C.all_gather(neg if mesh.index("data") == 0
                                else neg.abs(), mesh, "data")
        mesh.reset_counts()
        s = C.psum(x, mesh, "data", tag="t")
        mx = C.pmax(x, mesh, ("data", "model"), tag="t")
        g = C.all_gather(x[:2].to(torch.int64), mesh, "model", tag="t")
        return {"psum": LD._host(s), "pmax": LD._host(mx), "gather": LD._host(g),
                "signbits": LD._host(torch.signbit(gathered)),
                "bytes": {f"{a}/{t}": v
                          for (a, t), v in mesh.counted.items()}}
    if kind == "mesh_helpers":
        from repro_torch.launch import mesh as LM
        sub = LM.device_subset_mesh(4, model_parallel=2, device=dev)
        host = LM.host_device_mesh(model_parallel=2, device=dev)
        pods = LM.host_device_mesh(model_parallel=2, pods=2, device=dev)
        return {m_.axes: (m_.shape, dict(m_.coords))
                for m_ in (sub, pods) if m_ is not None} | {
                    "host": (host.shape, dict(host.coords))}
    if kind == "remesh":
        tree = {"F": arrays[case["F"]], "y": arrays[case["y"]],
                "w": arrays[case["w"]]}
        lay = {"F": block_l, "y": rows_l, "w": None}
        return {"blocks": LD._host(E.remesh(tree, lay)),
                "coords": dict(mesh.coords)}
    if kind == "restore":
        # Rank 0 writes a step; every rank restores its block of it, through
        # the manager and through a RestartableLoop.
        root = case["dir"]
        F = torch.as_tensor(arrays[case["F"]])
        if mesh.rank == 0:
            CK.CheckpointManager(root, async_save=False).save(
                4, {"F": F, "w": torch.ones(3)})
        C.barrier(mesh)
        like = {"F": 0, "w": 0}
        lay = {"F": block_l, "w": None}
        got, step = CK.CheckpointManager(root, async_save=False).restore(
            like, shardings=lay)
        loop = FT.RestartableLoop(root, lambda s, b: (s, {}), save_every=0,
                                  shardings=lay, device=dev)
        state, start = loop.resume_or_init(like)
        return {"manager": LD._host(got), "step": step, "loop": LD._host(state),
                "start": start, "coords": dict(mesh.coords)}
    if kind == "train_cli":
        # `launch.train --mesh` on this world's (data, model) mesh: an
        # unbroken run, and a run killed at step 3 and resumed from its
        # checkpoint; each rank compares its blocks of the two ends.
        from repro_torch.launch import train as TTR
        from repro_torch.runtime import chaos as CH
        from repro_torch.training import optimizer as opt

        def args(tag):
            return TTR.parser().parse_args(case["argv"] + [
                "--device", str(dev), "--ckpt-dir", f"{case['dir']}/{tag}"])
        whole = TTR.train_lm(args("whole"))
        killed = False
        try:
            TTR.train_lm(args("killed"), chaos=CH.KillAtRound(3))
        except CH.ChaosKill:
            killed = True
        resumed = TTR.train_lm(args("killed"))
        a, b = whole["state"], resumed["state"]
        same = all(torch.equal(x.detach(), y.detach()) for x, y in zip(
            opt.tree_leaves(a[:2]), opt.tree_leaves(b[:2])))
        return {"killed": killed, "same": same, "steps": (int(a[2]),
                                                          int(b[2])),
                "whole_logs": whole["logs"], "resumed_logs": resumed["logs"],
                "shape": whole["mesh"].shape}
    raise ValueError(f"unknown case kind {kind!r}")
