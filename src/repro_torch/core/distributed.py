"""Distributed SketchBoost on ``torch.distributed`` (the JAX package's
``core/distributed.py``).

Layout on a ``(data, model)`` or ``(pod, data, model)`` `launch.mesh.Mesh`:

  rows     n -> sharded over the row axes (``("data",)`` or ``("pod",
              "data")``): each rank holds ``n / R`` rows of codes and F;
  outputs  d -> sharded over ``"model"``: each rank holds ``d / tp`` columns
              of F, G and H and of the leaf values;
  features m -> optionally sharded over ``"model"`` for the histograms
              (``feature_shard=True``).

Each rank runs the single-device engines on its rows (B1 or B1-bf16, or
B4, then B2 or B2-wide, the leaf pass, and B3 for the forest's
prediction), with collectives at the reference's decision points:

  1. gradients  — local; softmax cross-entropy takes a max and a sum over
     the model axis.  On a model axis of one rank grad/hess is the
     single-device `losses` op itself, so a (1, 1) mesh fits bit for bit
     what `boosting.SketchBoost` fits.
  2. sketch     — `sketch.sketch_sharded`: ``psum_model(G_local @
     Pi_local)``.
  3. histograms — all-reduced over the row axes BETWEEN the build and the
     split scan (`ops.build_level` / `ops.combine_scan`): under
     ``"subtract"`` each rank builds its rows of the globally smaller child
     of every parent (the counts summed first), so the all-reduce moves
     half a level; the sibling is ``parent - built``.  With
     ``dist_hist_compression="sketch"`` the gradient channels go through
     the JL compressor (`sketched_hist_psum`); the count channel is always
     exact.
  4. split scan — on the all-reduced histograms, the same on every rank;
     under ``feature_shard`` each rank scans its features and the winners
     are gathered over the model axis.
  5. leaf sums  — the full gradients' sums and the covers, summed over the
     row axes; the leaf values stay sharded over the model axis.

RNG seam: a round's draws (the sketch's, and under ``"sketch"``
compression one JL matrix a level or expansion) are passed in
(``sketch_mats``, ``collective_mats``), or come from a ``torch.Generator``
seeded with ``cfg.seed`` on every rank, so they replicate without being
sent.  The reference derives the collective's from ``fold_in(fold_in(sub,
7919), level)`` (level-wise) and ``fold_in(fold_in(sub, 7919), t + 1)``
(leaf-wise expansion t; the root at 0).

Every collective is an ``all_reduce`` (`distributed.collectives`), so the
same code runs under NCCL, gloo on CUDA tensors and gloo on the CPU, and
each axis counts the bytes it all-reduces: `round_collective_bytes` is
the model of the ``"hist"`` ones.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import boosting as B
from repro_torch.core import forest as FO
from repro_torch.core import guards as GU
from repro_torch.core import histogram as H
from repro_torch.core import losses as L
from repro_torch.core import sketch as SK
from repro_torch.core import split as S
from repro_torch.core import tree as T
from repro_torch.distributed import collectives as C
from repro_torch.distributed import compression as CP
from repro_torch.models.params import spec_entry
from repro_torch.runtime import chaos as CH
from repro_torch.runtime import elastic as E
from repro_torch.runtime import fault as FT

ROW_AXES = ("data",)


# -- sharded losses --------------------------------------------------------------

def sharded_softmax(F_l: torch.Tensor, mesh, model_axis: str) -> torch.Tensor:
    """Softmax over outputs sharded across ``model_axis``."""
    m = C.pmax(F_l.max(-1, keepdim=True).values, mesh, model_axis,
               tag="loss")
    e = torch.exp(F_l.to(torch.float32) - m)
    z = C.psum(e.sum(-1, keepdim=True), mesh, model_axis, tag="loss")
    return e / z


def sharded_grad_hess(loss_name: str, F_l: torch.Tensor, Y_l: torch.Tensor,
                      mesh, model_axis: str):
    """(G, H) of this rank's block of outputs.  Only softmax cross-entropy
    couples the outputs; on a model axis of one rank, and for the other
    losses, it is `losses.get_loss(loss_name).grad_hess` itself."""
    loss = L.get_loss(loss_name)
    if loss_name != "multiclass" or mesh.axis_size(model_axis) == 1:
        return loss.grad_hess(F_l, Y_l)
    P = sharded_softmax(F_l, mesh, model_axis)
    Hd = P * (1.0 - P)
    if Y_l.ndim == 1:
        # P - onehot, formed in place on P: subtracting 0 elsewhere is exact.
        d_loc = F_l.shape[1]
        col = Y_l.long() - mesh.index(model_axis) * d_loc
        rows = torch.nonzero((col >= 0) & (col < d_loc))[:, 0]
        P[rows, col[rows]] -= 1.0
        return P, Hd
    return P - Y_l, Hd


def sharded_loss_value(loss_name: str, F_l: torch.Tensor, Y_l: torch.Tensor,
                       mesh, model_axis: str,
                       row_axes: Sequence[str]) -> torch.Tensor:
    """The mean loss over the whole (sharded) batch, the same 0-d tensor
    on every rank."""
    Fl = F_l.to(torch.float32)
    if loss_name == "multiclass":
        m = C.pmax(Fl.max(-1, keepdim=True).values, mesh, model_axis,
                   tag="eval")
        lse = torch.log(C.psum(torch.exp(Fl - m).sum(-1, keepdim=True), mesh,
                               model_axis, tag="eval")) + m
        if Y_l.ndim == 1:
            d_loc = F_l.shape[1]
            col = Y_l.long() - mesh.index(model_axis) * d_loc
            hit = (col >= 0) & (col < d_loc)
            own = Fl.gather(1, col.clamp(0, d_loc - 1)[:, None])
            picked = torch.where(hit[:, None], own, torch.zeros_like(own))
            weight = torch.ones_like(lse)
        else:
            picked = (Y_l * Fl).sum(-1, keepdim=True)
            weight = Y_l.sum(-1, keepdim=True)
        picked = C.psum(picked, mesh, model_axis, tag="eval")
        if Y_l.ndim == 2:
            weight = C.psum(weight, mesh, model_axis, tag="eval")
        total = (lse * weight - picked).sum()
        count = torch.tensor(float(F_l.shape[0]), device=F_l.device)
    else:
        if loss_name == "multilabel":
            v = (torch.clamp(Fl, min=0) - Fl * Y_l
                 + torch.log1p(torch.exp(-Fl.abs())))
        elif loss_name == "multitask_mse":
            v = 0.5 * torch.square(Fl - Y_l)
        else:
            raise ValueError(f"unknown loss {loss_name!r}")
        total = C.psum(v.sum(), mesh, model_axis, tag="eval")
        count = C.psum(torch.tensor(float(v.numel()), device=F_l.device),
                       mesh, model_axis, tag="eval")
    total = C.psum(total, mesh, row_axes, tag="eval")
    count = C.psum(count, mesh, row_axes, tag="eval")
    return total / count


# -- the histogram collective --------------------------------------------------

def sketched_hist_psum(hist: torch.Tensor, mesh, row_axes: Sequence[str],
                       k: int, Pi: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    """All-reduce a ``(..., c)`` histogram ``[g_1 .. g_{c-1} | count]``
    with the gradient channels JL-compressed: ``g @ Pi`` is all-reduced at
    ``k / (c - 1)`` of their bytes and reconstructed by least squares
    (`compression.decompress_block`).  Both steps are linear, so the result
    is the projection of the EXACT sum onto colspace(Pi).  The count
    channel is summed exactly; with ``c - 1 <= k`` the whole histogram is
    (the compressor is the identity)."""
    c = hist.shape[-1]
    if c - 1 <= k:
        return C.psum(hist, mesh, row_axes, tag="hist")
    g, cnt = hist[..., :-1], hist[..., -1:]
    sk, Pi, shape = CP.compress_block(g.reshape(-1, c - 1), k, Pi=Pi,
                                      generator=generator)
    g_hat = CP.decompress_block(C.psum(sk, mesh, row_axes, tag="hist"), Pi,
                                shape).reshape(g.shape)
    return torch.cat([g_hat, C.psum(cnt, mesh, row_axes, tag="hist")], -1)


def round_collective_bytes(cfg: B.GBDTConfig, m: int, d: int
                           ) -> Dict[str, int]:
    """The histogram all-reduce's bytes in ONE round (float32), per rank
    and reduce direction: ``exact_bytes`` what the configured sketch
    all-reduces without compression, ``moved_bytes`` what it all-reduces
    under ``dist_hist_compression``, ``full_bytes`` the unsketched
    (``sketch_method="none"``) payload.  ``m`` is the features a rank
    builds (``m / tp`` under ``feature_shard``); under one-vs-all ``d`` is
    the trees a rank grows (its outputs).  Leaf-wise counts the root and
    ``max_leaves - 1`` expansions.  The per-node count all-reduces, the
    leaf sums and the sketch's own are not counted (the reference's
    model)."""
    Bn = cfg.n_bins
    if cfg.strategy == "one_vs_all":
        c_full, trees = 2, d
    else:
        k = cfg.sketch_k
        sketched = cfg.sketch_method != "none" and 0 < k < d
        c_full, trees = (k + 1 if sketched else d + 1), 1
    if cfg.growth == "leafwise":
        cells = cfg.max_leaves * m * Bn
    else:
        subtract = H.resolve_hist_engine(cfg.hist_engine) == "subtract"
        cells = 0
        for lvl in range(cfg.depth):
            nodes = 2 ** lvl
            built = nodes // 2 if (subtract and lvl > 0) else nodes
            cells += built * m * Bn
    c_moved = c_full
    if cfg.dist_hist_compression == "sketch":
        c_moved = min(c_full - 1, cfg.dist_hist_k_effective) + 1
    full_bytes = (4 * cells * (d + 1) if cfg.strategy == "single_tree"
                  else 4 * cells * 2 * d)
    return {"hist_cells": cells * trees,
            "exact_bytes": 4 * cells * c_full * trees,
            "moved_bytes": 4 * cells * c_moved * trees,
            "full_bytes": full_bytes}


def gbdt_input_specs(n: int, m: int, d: int, mesh, cfg: B.GBDTConfig, *,
                     row_axes=("data",), model_axis="model"
                     ) -> Dict[str, Any]:
    """The dry-run cell's inputs as ``(meta tensor, partition spec)``
    pairs: F (n, d) float32 over ``(row_axes, model_axis)``, the codes
    (n, m) uint8 over the rows, Y ((n,) int32 class ids for multiclass,
    else (n, d) float32 like F); ``key`` None (the port's draws come from a
    generator or are passed in)."""
    rows = spec_entry(tuple(row_axes))
    f_spec, row_spec = (rows, model_axis), (rows,)

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    if cfg.loss == "multiclass":
        y = (meta((n,), torch.int32), row_spec)
    else:
        y = (meta((n, d), torch.float32), f_spec)
    return dict(F=(meta((n, d), torch.float32), f_spec),
                codes=(meta((n, m), torch.uint8), row_spec), Y=y, key=None)


class RowReduce:
    """One rank's collectives inside a distributed tree (the growers'
    ``reduce``): counts, histograms and leaf sums summed over the row axes,
    and under ``feature_shard`` the winners gathered over the model axis.

    ``draws`` are the round's collective JL matrices, one a step (a level,
    or the root and the expansions of a leaf-wise tree), each (c - 1, k);
    without them a step that compresses draws from ``generator``."""

    def __init__(self, mesh, row_axes: Sequence[str], *,
                 compression: str = "none", k: int = 0, draws=None,
                 generator: Optional[torch.Generator] = None,
                 model_axis: str = "model",
                 feature_offset: Optional[int] = None, n_bins: int = 256,
                 min_gain: float = 0.0):
        self.mesh = mesh
        self.row_axes = tuple(row_axes)
        self.compression = compression
        self.k = k
        self.draws = draws
        self.generator = generator
        self.model_axis = model_axis
        self.feature_offset = feature_offset
        self.n_bins = n_bins
        self.min_gain = min_gain

    def counts(self, c: torch.Tensor) -> torch.Tensor:
        out = C.psum(c.to(self.mesh.device), self.mesh, self.row_axes,
                     tag="counts")
        return out.to(c.device)

    def sums(self, x: torch.Tensor) -> torch.Tensor:
        return C.psum(x, self.mesh, self.row_axes, tag="leaf")

    def hist(self, h: torch.Tensor, step: int) -> torch.Tensor:
        if self.compression != "sketch":
            return C.psum(h, self.mesh, self.row_axes, tag="hist")
        Pi = None
        if h.shape[-1] - 1 > self.k and self.draws is not None:
            Pi = B._draw_tensor(self.draws[step], h.device)
        return sketched_hist_psum(h, self.mesh, self.row_axes, self.k, Pi,
                                  self.generator)

    def pick(self, sp: S.Splits) -> S.Splits:
        """The global winner of each node from the ranks' local ones (the
        first of equal gains, so the lowest feature, as one scan over every
        feature picks)."""
        if self.feature_offset is None:
            return sp
        local = torch.stack([sp.gain, (sp.feat + self.feature_offset).to(
            torch.float32), sp.thr.to(torch.float32)], -1)
        allb = C.all_gather(local, self.mesh, self.model_axis, tag="winner")
        win = allb[..., 0].argmax(0)
        picked = allb.gather(0, win[None, :, None].expand(1, -1, 3))[0]
        g = picked[:, 0]
        is_leaf = ~(g > self.min_gain)
        return S.Splits(
            feat=torch.where(is_leaf, 0, picked[:, 1].to(torch.int32)).to(
                torch.int32),
            thr=torch.where(is_leaf, self.n_bins - 1,
                            picked[:, 2].to(torch.int32)).to(torch.int32),
            gain=torch.where(is_leaf, 0.0, g), is_leaf=is_leaf)


def _all_bad(flag: Optional[torch.Tensor], mesh) -> Optional[torch.Tensor]:
    """A rank's non-finite flag -> the mesh's (every rank must take the
    same skip decision, or the forests part ways)."""
    if flag is None:
        return None
    b = C.pmax(flag.to(torch.float32).reshape(1), mesh, mesh.axes,
               tag="guard")
    return b[0] > 0


# -- the distributed round -------------------------------------------------------

def check_layout(cfg: B.GBDTConfig, mesh, *, m: int,
                 feature_shard: bool = False,
                 model_axis: str = "model") -> None:
    """The reference's refusals of a sharded layout."""
    if feature_shard and cfg.strategy == "one_vs_all":
        raise ValueError(
            "feature_shard=True shards the histogram feature axis over the "
            "model axis, which one_vs_all already uses for its per-output "
            "trees: the two layouts conflict; use strategy='single_tree' "
            "or feature_shard=False")
    if feature_shard and cfg.growth == "leafwise":
        raise ValueError(
            "feature_shard=True has no leaf-wise implementation (the "
            "best-first frontier would need a per-expansion winner gather); "
            "use growth='levelwise' or feature_shard=False")
    tp = mesh.axis_size(model_axis)
    if feature_shard and m % tp:
        raise ValueError(
            f"feature_shard=True needs the feature count ({m}) divisible by "
            f"the model axis ({tp}); pad the feature matrix or use "
            "feature_shard=False")


def distributed_round(F_l: torch.Tensor, codes_l: torch.Tensor,
                      codes_lt: torch.Tensor, Y_l: torch.Tensor,
                      cfg: B.GBDTConfig, mesh, *,
                      row_axes: Sequence[str] = ROW_AXES,
                      model_axis: str = "model",
                      feature_shard: bool = False, draw=None,
                      collective_draws=None,
                      generator: Optional[torch.Generator] = None):
    """One boosting round on this rank's blocks: ``F_l`` (n_loc, d_loc)
    (updated in place: ``F += lr * value[leaf]``), ``codes_l`` (n_loc, m)
    and ``codes_lt`` (m, n_loc) uint8, ``Y_l`` the labels (n_loc,) or this
    block of dense targets.  Returns the round's tree with this rank's
    columns of the leaf values (one-vs-all: this rank's trees).  ``draw``
    and ``collective_draws`` are the round's sketch draw and collective JL
    matrices (see the module docstring); what is not given comes from
    ``generator``, the sketch's draw first.  Mirrors
    `boosting.boost_round` step for step."""
    m = codes_l.shape[1]
    check_layout(cfg, mesh, m=m, feature_shard=feature_shard,
                 model_axis=model_axis)
    device = F_l.device
    n_loc = F_l.shape[0]
    tp = mesh.axis_size(model_axis)
    G, Hd = sharded_grad_hess(cfg.loss, F_l, Y_l, mesh, model_axis)
    G, Hd, bad = GU.guard_grad_hess(G, Hd, cfg.guard_policy, cfg.guard_clip,
                                    cfg.hessian_floor)
    bad = _all_bad(bad, mesh)
    codes_ht, f_off = codes_lt, None
    if feature_shard:
        m_loc = m // tp
        f_off = mesh.index(model_axis) * m_loc
        codes_ht = codes_lt[f_off:f_off + m_loc].contiguous()
    reduce = RowReduce(mesh, row_axes, compression=cfg.dist_hist_compression,
                       k=cfg.dist_hist_k_effective, draws=collective_draws,
                       generator=generator, model_axis=model_axis,
                       feature_offset=f_off, n_bins=cfg.n_bins,
                       min_gain=cfg.min_gain)
    if cfg.strategy == "one_vs_all":
        return B._one_vs_all_round(F_l, codes_l, codes_lt, G, Hd, cfg,
                                   bad=bad, reduce=reduce)
    Gk = SK.sketch_sharded(G, method=cfg.sketch_method, k=cfg.sketch_k,
                           mesh=mesh, model_axis=model_axis,
                           data_axes=row_axes, d_global=F_l.shape[1] * tp,
                           draw=B._draw_tensor(draw, device),
                           generator=generator)
    stats = torch.cat([Gk, torch.ones((n_loc, 1), dtype=torch.float32,
                                      device=device)], 1)
    del Gk
    # Again after the sketch: a projection can overflow on its own.
    stats, bad = GU.guard_stats(stats, cfg.guard_policy, cfg.guard_clip, bad)
    if cfg.guard_policy in ("skip_round", "clip"):
        bad = _all_bad(bad, mesh)
    kw = dict(depth=cfg.depth, n_bins=cfg.n_bins, lam=cfg.lambda_l2,
              min_data_in_leaf=cfg.min_data_in_leaf, min_gain=cfg.min_gain,
              hist_dtype=cfg.hist_dtype, reduce=reduce)
    if cfg.growth == "leafwise":
        tree, leaf_pos = T.grow_tree_leafwise(
            codes_l, codes_lt, stats, G, Hd, max_leaves=cfg.max_leaves, **kw)
    else:
        tree, leaf_pos = T.grow_tree(codes_l, codes_ht, stats, G, Hd,
                                     hist_engine=cfg.hist_engine, **kw)
    del G, Hd, stats
    if cfg.guard_policy == "skip_round":
        scale = GU.skip_scale(bad, cfg.guard_policy, device)
        tree = tree._replace(value=tree.value * scale,
                             gain=tree.gain * scale)
    contrib = tree.value[leaf_pos.long()]
    contrib.mul_(torch.tensor(cfg.learning_rate, dtype=torch.float32,
                              device=device))        # lr * v, then the add
    F_l.add_(contrib)
    return tree


def make_distributed_eval(mesh, cfg: B.GBDTConfig, *,
                          row_axes: Sequence[str] = ROW_AXES,
                          model_axis: str = "model"):
    """``(F_l, Y_l) -> float``: the mean loss of the sharded scores."""
    cfg.validate(distributed=True)

    def evaluate(F_l, Y_l) -> float:
        return float(sharded_loss_value(cfg.loss, F_l, Y_l, mesh, model_axis,
                                        row_axes))
    return evaluate


# -- the trees of a fit ----------------------------------------------------------

def _model_cols(mesh, model_axis: str, d: int) -> Tuple[int, int]:
    tp = mesh.axis_size(model_axis)
    d_loc = d // tp
    return mesh.index(model_axis) * d_loc, d_loc


def gather_forest(stacked, mesh, strategy: str, model_axis: str = "model"):
    """The whole stacked forest from every rank's columns (single tree:
    the values' last axis; one-vs-all: the trees' axis after the rounds)."""
    def cat(x, dim):
        return torch.cat(list(C.all_gather(x, mesh, model_axis,
                                           tag="gather")), dim)
    if strategy == "one_vs_all":
        return type(stacked)(*[None if f is None else cat(f, 1)
                               for f in stacked])
    return stacked._replace(value=cat(stacked.value, -1))


def _local_forest(stacked, strategy: str, c0: int, d_loc: int):
    """This rank's columns of a whole stacked forest (`gather_forest`'s
    inverse)."""
    if strategy == "one_vs_all":
        return type(stacked)(*[None if f is None else
                               f[:, c0:c0 + d_loc].contiguous()
                               for f in stacked])
    return stacked._replace(value=stacked.value[..., c0:c0 + d_loc]
                            .contiguous())


def _local_chaos(chaos, r0: int, n_loc: int, c0: int, d_loc: int):
    """Chaos with each target corruption narrowed to this rank's block."""
    return tuple(c.localize(r0, n_loc, c0, d_loc)
                 if hasattr(c, "localize") else c for c in chaos)


def fit_distributed(cfg: B.GBDTConfig, mesh, codes, Y, *,
                    row_axes: Sequence[str] = ROW_AXES,
                    model_axis: str = "model",
                    feature_shard: bool = False,
                    base_score=None,
                    n_rounds: Optional[int] = None,
                    eval_every: int = 0,
                    chaos: Any = None,
                    watchdog: Any = None,
                    sketch_mats: Optional[Sequence] = None,
                    collective_mats: Optional[Sequence] = None):
    """Distributed training: ``cfg.n_trees`` (or ``n_rounds``) rounds of
    `distributed_round` on this rank.

    ``codes`` (n, m) uint8 pre-binned features (`core.quantize`) and ``Y``
    (labels (n,) or targets (n, d)) are the WHOLE arrays, host arrays or
    CPU tensors, on every rank; the rank puts its block on
    ``mesh.device``.  ``cfg.n_outputs`` must be set (the outputs are
    sharded before any label is read); n must divide by the row shards and
    d by the model axis.  ``base_score`` (d,) is the constant start (zeros
    by default).  ``sketch_mats[r]`` and ``collective_mats[r]`` are round
    r's draws (module docstring); the rest come from a generator seeded
    with ``cfg.seed`` on the mesh's device.

    The round loop is a `runtime.fault.RestartableLoop`: ``chaos`` takes
    `runtime.chaos` injections, ``watchdog`` a `fault.StragglerWatchdog`
    (its ``times`` are the rounds' seconds).  With ``cfg.save_every > 0``
    mesh rank 0 writes format-v4 steps of `io.checkpoint.
    save_boost_checkpoint` into ``cfg.ckpt_dir`` (F and the forest
    gathered over the mesh; the other ranks wait), and
    ``cfg.resume_from`` restores one onto THIS mesh, which may be smaller
    than the one that wrote it (`runtime.elastic.remesh`).

    Returns ``(F_local, forest, history)``: this rank's block of the raw
    scores, the whole stacked forest (the same on every rank; the layout
    `SketchBoost.fit` builds, for `forest.pack_forest`) and the
    ``{"round", "train_loss"}`` records of every ``eval_every`` rounds.
    ``mesh.gather(F_local, row_axes, model_axis)`` assembles F."""
    cfg.validate(distributed=True)
    if cfg.n_outputs < 1:
        raise ValueError(
            "fit_distributed needs cfg.n_outputs set explicitly (the "
            "sharded round shards the output axis before seeing labels); "
            "e.g. dataclasses.replace(cfg, n_outputs=d)")
    d = cfg.n_outputs
    n, m = int(codes.shape[0]), int(codes.shape[1])
    check_layout(cfg, mesh, m=m, feature_shard=feature_shard,
                 model_axis=model_axis)
    r_idx, n_row = mesh.block_index(row_axes)
    tp = mesh.axis_size(model_axis)
    if n % n_row or d % tp:
        raise ValueError(
            f"{n} rows over {n_row} row shards and {d} outputs over a model "
            f"axis of {tp}: both must divide evenly")
    run_cfg = dataclasses.replace(
        cfg.strip_io(), hist_engine=H.resolve_hist_engine(cfg.hist_engine))
    device = mesh.device
    rows = E.Layout(mesh, tuple(row_axes))
    block = E.Layout(mesh, tuple(row_axes), model_axis)
    codes_l = E.remesh(torch.as_tensor(np.asarray(codes)), rows).to(
        torch.uint8)
    codes_lt = codes_l.t().contiguous()
    Yh = torch.as_tensor(np.asarray(Y))
    if run_cfg.loss == "multiclass" and Yh.ndim == 1:
        Y_l = E.remesh(Yh, rows).to(torch.int64)
    else:
        Y_l = E.remesh(Yh, block).to(torch.float32)
    n_loc = n // n_row
    c0, d_loc = _model_cols(mesh, model_axis, d)
    base = (torch.zeros(d, dtype=torch.float32) if base_score is None
            else torch.as_tensor(np.asarray(base_score, np.float32)))
    base = base.to(device)
    F0 = base[c0:c0 + d_loc].expand(n_loc, d_loc).contiguous()
    rounds = int(n_rounds) if n_rounds else cfg.n_trees
    chaos = _local_chaos(CH.as_chaos_list(chaos), r_idx * n_loc, n_loc, c0,
                         d_loc)
    evaluate = (make_distributed_eval(mesh, run_cfg, row_axes=row_axes,
                                      model_axis=model_axis)
                if eval_every else None)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    history: List[Dict[str, Any]] = []
    Y_box = [Y_l]

    def whole_forest(trees):
        if not trees:
            return None
        return gather_forest(T.stack_trees(trees), mesh, cfg.strategy,
                             model_axis)

    save_fn = None
    if cfg.save_every > 0 and cfg.ckpt_dir:
        from repro_torch.io import checkpoint as CK

        def save_fn(step_idx, state):
            forest = whole_forest(state["trees"])
            F = mesh.gather(state["F"], row_axes, model_axis)
            if mesh.rank == 0:
                packed = FO.pack_forest(
                    forest, base, cfg.learning_rate, strategy=cfg.strategy,
                    max_depth=cfg.depth if cfg.growth == "leafwise"
                    else None)
                CK.save_boost_checkpoint(
                    cfg.ckpt_dir, round_done=step_idx + 1, packed=packed,
                    quantizer=None, trees=forest, F=F, Fv=None,
                    generator=gen, history=list(history),
                    best_loss=float("inf"), best_round=-1,
                    cfg_meta=dict(B._resume_cfg_snapshot(cfg),
                                  loss=cfg.loss),
                    keep_n=cfg.ckpt_keep)
            C.barrier(mesh)

    restore_fn = None
    if cfg.resume_from:
        from repro_torch.io import checkpoint as CK

        def restore_fn():
            st = CK.load_boost_checkpoint(cfg.resume_from, device=device)
            B._check_resume_compat(cfg, st)
            if tuple(st.F.shape) != (n, d):
                raise ValueError(
                    f"resume_from checkpoint holds training scores of shape "
                    f"{tuple(st.F.shape)} but codes/cfg give ({n}, {d}); "
                    "resume must use the same training data")
            if st.generator is not None:
                if st.generator_device != device.type:
                    raise ValueError(
                        f"resume_from checkpoint holds the draws' generator "
                        f"of a fit on {st.generator_device!r}, but this fit "
                        f"runs on {device.type!r}; resume on that device "
                        "type")
                gen.set_state(st.generator)
            elif sketch_mats is None and B._draws_sketch(cfg):
                raise ValueError(
                    "resume_from checkpoint holds no 'train/generator' (the "
                    "JAX package wrote it); pass the remaining rounds' "
                    "sketch_mats")
            history.extend(st.history)
            # Elastic restart: the step's host arrays laid out on THIS mesh,
            # possibly a survivor subset of the one that wrote it.
            F = E.remesh(st.F.to(torch.float32), block)
            prefix = _local_forest(st.trees, cfg.strategy, c0, d_loc)
            return {"F": F, "trees": T.unstack_trees(prefix)}, st.round

    def step_fn(state, it):
        for c in chaos:
            mutate = getattr(c, "mutate_targets", None)
            if mutate is not None:
                Y_box[0] = mutate(Y_box[0], it)
        F = state["F"]
        tree = distributed_round(
            F, codes_l, codes_lt, Y_box[0], run_cfg, mesh,
            row_axes=row_axes, model_axis=model_axis,
            feature_shard=feature_shard,
            draw=B._round_draw(sketch_mats, it),
            collective_draws=B._round_draw(collective_mats, it),
            generator=gen)
        if cfg.guard_policy == "raise":
            flag = (~torch.isfinite(F).all()).to(torch.float32).reshape(1)
            if float(C.pmax(flag, mesh, mesh.axes, tag="guard")[0]) > 0:
                raise GU.NonFiniteError(it)
        metrics: Dict[str, Any] = {}
        if eval_every and it % eval_every == 0:
            tl = evaluate(F, Y_box[0])
            history.append({"round": it, "train_loss": tl})
            metrics["train_loss"] = tl
        return {"F": F, "trees": state["trees"] + [tree]}, metrics

    loop = FT.RestartableLoop(
        "", step_fn, save_every=cfg.save_every, keep_n=cfg.ckpt_keep,
        async_save=False, save_fn=save_fn, restore_fn=restore_fn,
        chaos=chaos, watchdog=watchdog, device=device)
    state, _ = loop.run({"F": F0, "trees": []}, None, rounds)
    return state["F"], whole_forest(state["trees"]), history

