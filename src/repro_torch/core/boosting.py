"""SketchBoost: the gradient-boosting trainer, on PyTorch.

Port of the JAX package's ``core/boosting.py`` for the slices ported so
far: ``strategy="single_tree"`` and ``"one_vs_all"`` (d univariate trees a
round, grown together in groups: `tree.grow_trees`), level-wise growth
with any histogram engine (``"direct"``, ``"partition"``, ``"subtract"``)
and leaf-wise (best-first) growth under a ``max_leaves`` budget, float32
or bfloat16 histogram statistics, every sketch method, no row or column
sampling, no guards and no checkpoints.
Options outside the slice raise a ValueError that names the slice that
brings them.  The fitted model explains itself as the reference's does:
`SketchBoost.shap_values`, `apply` and `feature_importances` (``explain/``).

The loop runs one round per iteration for both ``loop="scan"`` (the
default) and ``loop="python"``: the reference guarantees that its two loops
train bit-identical forests, so one loop stands for both here (PyTorch
runs eagerly; there is nothing to compile).  ``scan_chunk`` has no effect.

RNG seam: the reference draws each round's sketch from threefry keys, which
``torch.Generator`` cannot reproduce.  A free-running fit makes each round's
draw from a generator seeded with ``cfg.seed`` on the fit's device;
``fit(..., sketch_mats=...)`` takes the per-round draws instead (the parity
tests replay the reference's draws through it): Pi (d, k) for
``random_projection``, the Gumbel noise (k, d) for ``random_sampling``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import explain as EX
from repro_torch.core import forest as FO
from repro_torch.core import histogram as H
from repro_torch.core import losses as L
from repro_torch.core import quantize as Q
from repro_torch.core import sketch as SK
from repro_torch.core import tree as T
from repro_torch.core.device import resolve_device
from repro_torch.kernels import predict_kernel
from repro_torch.kernels.ref import HIST_DTYPES


@dataclasses.dataclass(frozen=True)
class GBDTConfig:
    """Hyperparameters: the same fields and defaults as the JAX package's
    ``GBDTConfig`` (paper App. B setup)."""
    loss: str = "multiclass"
    n_outputs: int = 0
    strategy: str = "single_tree"
    sketch_method: str = "random_projection"
    sketch_k: int = 5
    n_trees: int = 100
    depth: int = 6
    growth: str = "levelwise"
    max_leaves: int = 0
    learning_rate: float = 0.05
    lambda_l2: float = 1.0
    n_bins: int = 256
    min_data_in_leaf: float = 1.0
    min_gain: float = 0.0
    subsample: float = 1.0
    goss_a: float = 0.0
    goss_b: float = 0.0
    colsample: float = 1.0
    early_stopping_rounds: int = 0
    eval_every: int = 1
    use_kernel: Any = True
    hist_engine: str = "auto"
    hist_dtype: str = "float32"
    loop: str = "scan"
    scan_chunk: int = 32
    predict_row_chunk: int = 65536
    dist_hist_compression: str = "none"
    dist_hist_k: int = 0
    guard_policy: str = "off"
    guard_clip: float = 1e6
    hessian_floor: float = 0.0
    save_every: int = 0
    ckpt_dir: str = ""
    ckpt_keep: int = 3
    resume_from: str = ""
    seed: int = 0

    def validate(self) -> None:
        """Reject options this slice of the port does not implement, naming
        the slice that brings each, and unknown values."""
        later = [
            (self.subsample < 1.0 or self.goss_a > 0.0 or self.goss_b > 0.0
             or self.colsample < 1.0, "subsample / goss_* / colsample",
             "the sampling slice"),
            (self.guard_policy != "off" or self.hessian_floor > 0.0,
             "guard_policy / hessian_floor", "the robustness slice"),
            (self.save_every != 0 or bool(self.ckpt_dir)
             or bool(self.resume_from), "save_every / ckpt_dir / resume_from",
             "the checkpoint slice"),
            (self.dist_hist_compression != "none", "dist_hist_compression",
             "the distributed slice"),
        ]
        for out_of_slice, what, slice_name in later:
            if out_of_slice:
                raise ValueError(f"{what} is not ported yet: it comes with "
                                 f"{slice_name} of repro_torch")
        leafwise = self.growth == "leafwise"
        checks = [
            (self.loss in L.LOSSES, f"unknown loss {self.loss!r}"),
            (self.strategy in ("single_tree", "one_vs_all"),
             f"unknown strategy {self.strategy!r}"),
            (self.growth in ("levelwise", "leafwise"),
             f"unknown growth {self.growth!r}; expected 'levelwise' or "
             "'leafwise'"),
            (leafwise or not self.max_leaves,
             f"max_leaves={self.max_leaves} is set but growth='levelwise' "
             "grows full 2^depth-leaf levels and would silently ignore it; "
             "set growth='leafwise' or drop max_leaves"),
            (not leafwise or self.max_leaves >= 2,
             "growth='leafwise' needs max_leaves >= 2 (the leaf budget of "
             f"each best-first tree); got {self.max_leaves}"),
            (not leafwise or self.max_leaves <= 2 ** self.depth,
             f"max_leaves={self.max_leaves} exceeds 2^depth="
             f"{2 ** self.depth}: the depth bound makes the extra budget "
             "unreachable; raise depth or lower max_leaves"),
            (not leafwise or self.hist_engine in ("auto", "subtract"),
             f"hist_engine={self.hist_engine!r} has no leaf-wise "
             "implementation (the best-first grower is node-partitioned "
             "with sibling subtraction); use 'auto'/'subtract' or "
             "growth='levelwise'"),
            (self.hist_engine in ("auto",) + H.HIST_ENGINES,
             f"unknown hist_engine {self.hist_engine!r}"),
            (self.hist_dtype in HIST_DTYPES,
             f"unknown hist_dtype {self.hist_dtype!r}; expected one of "
             f"{tuple(HIST_DTYPES)}"),
            (self.sketch_method in SK.SKETCH_METHODS,
             f"unknown sketch_method {self.sketch_method!r}"),
            (self.loop in ("scan", "python"), f"unknown loop {self.loop!r}; "
             "expected 'scan' or 'python'"),
            (self.use_kernel is True, "use_kernel selects Pallas modes of the "
             "JAX package; the port picks kernels by device (pass "
             "device='cpu' for the plain versions)"),
            (2 <= self.n_bins <= Q.MAX_BINS,
             f"n_bins must be in [2, {Q.MAX_BINS}]"),
            (self.depth >= 1, f"depth must be >= 1, got {self.depth}"),
        ]
        for ok, msg in checks:
            if not ok:
                raise ValueError(msg)


def validate_features(X, *, n_features: Optional[int] = None,
                      where: str = "X") -> np.ndarray:
    """Numeric 2-D features with no +/-inf (NaN encodes missing), as
    float32; ``n_features`` pins the column count of a fitted model."""
    X = np.asarray(X)
    if X.dtype.kind not in "fiub":
        raise ValueError(f"{where} has non-numeric dtype {X.dtype}")
    if X.ndim != 2:
        raise ValueError(f"{where} must be 2-D (rows, features); got shape "
                         f"{tuple(X.shape)}")
    if n_features is not None and X.shape[1] != n_features:
        raise ValueError(f"{where} has {X.shape[1]} features but the model "
                         f"was fit with {n_features}")
    X = np.ascontiguousarray(X, dtype=np.float32)
    if np.isinf(X).any():
        cols = np.flatnonzero(np.isinf(X).any(axis=0))
        raise ValueError(f"{where} contains +/-inf in feature column(s) "
                         f"{cols[:8].tolist()}; only NaN encodes missing")
    return X


def validate_targets(y, *, loss: str, n_rows: int, where: str = "y"
                     ) -> np.ndarray:
    """Numeric, row-aligned, finite targets; 1-D multiclass labels are
    non-negative integers."""
    y = np.asarray(y)
    if y.dtype.kind not in "fiub" or y.ndim not in (1, 2):
        raise ValueError(f"{where} must be numeric and 1-D or 2-D; got "
                         f"dtype {y.dtype}, shape {tuple(y.shape)}")
    if y.shape[0] != n_rows:
        raise ValueError(f"{where} has {y.shape[0]} rows but X has {n_rows}")
    if y.dtype.kind == "f" and not np.isfinite(y).all():
        raise ValueError(f"{where} contains non-finite values")
    if loss == "multiclass" and y.ndim == 1:
        if y.dtype.kind == "f" and not np.all(y == np.floor(y)):
            raise ValueError(f"{where} holds non-integer class ids")
        if y.size and int(y.min()) < 0:
            raise ValueError(f"{where} has negative class ids")
    return y


class SketchBoost:
    """Estimator: fit / predict with an eval set and early stopping.

    >>> model = SketchBoost(GBDTConfig(sketch_k=5))      # on CUDA
    >>> model.fit(X, y, eval_set=(Xv, yv))
    >>> proba = model.predict(X_test)
    """

    def __init__(self, cfg: GBDTConfig, device=None):
        cfg.validate()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.quantizer: Optional[Q.Quantizer] = None
        self.forest: Optional[T.Forest] = None
        self.packed: Optional[FO.PackedForest] = None
        self.base_score: Optional[torch.Tensor] = None
        self.history: List[Dict[str, Any]] = []
        self.best_round: int = -1
        self._path_pack: Optional[EX.PathPack] = None

    # -- data prep ----------------------------------------------------------
    def _codes(self, X: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """Binned features in both layouts: (n, m) and (m, n) uint8."""
        Xd = torch.as_tensor(X, dtype=torch.float32, device=self.device)
        codes_t = Q.apply_quantizer(self.quantizer, Xd)
        return Q.codes_rows(codes_t), codes_t

    def _targets(self, y) -> torch.Tensor:
        y = torch.as_tensor(np.asarray(y), device=self.device)
        if self.cfg.loss == "multiclass" and y.ndim == 1:
            return y.to(torch.int64)
        return y.to(torch.float32)

    def _infer_d(self, y) -> int:
        if self.cfg.n_outputs:
            return self.cfg.n_outputs
        y = np.asarray(y)
        if self.cfg.loss == "multiclass" and y.ndim == 1:
            return int(y.max()) + 1
        return int(y.shape[1])

    def _base(self, Y: torch.Tensor, d: int) -> torch.Tensor:
        """Constant base score: log-priors (classification) or target mean."""
        if self.cfg.loss == "multiclass":
            if Y.ndim == 1:
                counts = torch.bincount(Y, minlength=d).to(torch.float32) + 1.0
                return torch.log(counts / counts.sum())
            return torch.log(Y.mean(0) + 1e-6)
        if self.cfg.loss == "multilabel":
            p = torch.clamp(Y.mean(0), 1e-6, 1 - 1e-6)
            return torch.log(p / (1 - p))
        return Y.mean(0)

    # -- training -----------------------------------------------------------
    def fit(self, X, y, eval_set: Optional[Tuple] = None,
            verbose: bool = False, *,
            sketch_mats: Optional[Sequence] = None) -> "SketchBoost":
        """Train the ensemble.

        ``sketch_mats`` optionally gives round r's sketch draw
        ``sketch_mats[r]`` (a numpy array): the (d, k) projection for
        ``random_projection``, the (k, d) Gumbel noise for
        ``random_sampling``; the other methods draw nothing and ignore it.
        Without it the draws come from a generator seeded with
        ``cfg.seed``.
        """
        cfg = self.cfg
        X = validate_features(X)
        y = validate_targets(y, loss=cfg.loss, n_rows=X.shape[0])
        d = self._infer_d(y)
        cfg = dataclasses.replace(
            cfg, n_outputs=d,
            hist_engine=H.resolve_hist_engine(cfg.hist_engine))
        loss = L.get_loss(cfg.loss)
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)

        self.quantizer = Q.fit_quantizer(X, cfg.n_bins, seed=cfg.seed,
                                         device=self.device)
        codes, codes_t = self._codes(X)
        Y = self._targets(y)
        self.base_score = self._base(Y, d).to(torch.float32)
        n = codes.shape[0]
        F = self.base_score.expand(n, d).contiguous()
        has_eval = eval_set is not None
        if has_eval:
            Xv = validate_features(eval_set[0], n_features=X.shape[1],
                                   where="eval_set X")
            codes_v, _ = self._codes(Xv)
            Yv = self._targets(validate_targets(
                eval_set[1], loss=cfg.loss, n_rows=Xv.shape[0],
                where="eval_set y"))
            Fv = self.base_score.expand(Xv.shape[0], d).contiguous()

        trees: List[T.Tree] = []
        best_loss, best_round = np.inf, -1
        self.history = []
        t0 = time.perf_counter()
        for it in range(cfg.n_trees):
            draw = (None if sketch_mats is None
                    else np.array(sketch_mats[it], np.float32))
            tree = boost_round(F, codes, codes_t, Y, cfg, draw=draw,
                               generator=gen)
            trees.append(tree)
            rec = {"round": it, "train_time_s": time.perf_counter() - t0}
            if has_eval:
                Fv = _apply_tree(tree, codes_v, Fv, cfg)
            if has_eval and it % cfg.eval_every == 0:
                vloss = float(loss.value(Fv, Yv))
                rec["valid_loss"] = vloss
                if vloss < best_loss - 1e-9:
                    best_loss, best_round = vloss, it
                if (cfg.early_stopping_rounds
                        and it - best_round >= cfg.early_stopping_rounds):
                    self.history.append(rec)
                    if verbose:
                        print(f"[sketchboost] early stop @ {it} "
                              f"(best {best_loss:.5f} @ {best_round})")
                    break
            self.history.append(rec)
            if verbose and it % 20 == 0:
                msg = f"[sketchboost] round {it}"
                if "valid_loss" in rec:
                    msg += f" valid_loss={rec['valid_loss']:.5f}"
                print(msg)

        if best_round >= 0 and cfg.early_stopping_rounds:
            trees = trees[:best_round + 1]
        self.best_round = best_round if best_round >= 0 else len(trees) - 1
        self.cfg = cfg
        self.forest = T.stack_trees(trees)
        self.packed = FO.pack_forest(
            self.forest, self.base_score, cfg.learning_rate,
            strategy=cfg.strategy,
            max_depth=cfg.depth if cfg.growth == "leafwise" else None)
        self._path_pack = None
        return self

    # -- inference ----------------------------------------------------------
    @property
    def best_iteration(self) -> int:
        return self.best_round + 1

    def predict_raw(self, X, iteration: Optional[int] = None) -> torch.Tensor:
        """Raw scores through the traversal kernel, ``predict_row_chunk``
        rows at a time; ``iteration`` keeps the first rounds only."""
        return FO.predict_raw(self._sliced_packed(iteration), self._bin(X),
                              row_chunk=self.cfg.predict_row_chunk)

    def predict(self, X, iteration: Optional[int] = None) -> torch.Tensor:
        return L.get_loss(self.cfg.loss).transform(
            self.predict_raw(X, iteration))

    # -- explainability (repro_torch.explain) --------------------------------
    def _bin(self, X) -> torch.Tensor:
        """(n, m) uint8 codes of fitted-model features, on the model's
        device."""
        if self.quantizer is None:
            raise ValueError("model is not fitted; call fit() first")
        X = validate_features(X, n_features=self.quantizer.edges.shape[0])
        return self._codes(X)[0]

    def _sliced_packed(self, iteration: Optional[int]) -> FO.PackedForest:
        return (self.packed if iteration is None
                else FO.slice_rounds(self.packed, iteration))

    def shap_values(self, X, *, algorithm: str = "path_dependent",
                    background=None, iteration: Optional[int] = None,
                    check_additivity: bool = False):
        """Per-output SHAP attributions ``(phi, base_values)``: phi (n, m, d),
        base_values (d,), with ``base_values + phi.sum(1) ==
        predict_raw(X)`` up to float32 rounding.  ``"path_dependent"`` is
        TreeSHAP over the packed covers (the B6 kernel on the card);
        ``"interventional"`` explains against ``background`` (raw features,
        binned with the model's quantizer).  The path pack is built once
        per fit; ``iteration`` keeps a prefix of its tree axis.
        ``check_additivity`` raises when local accuracy is off by more than
        1e-3."""
        codes = self._bin(X)
        bg = None if background is None else self._bin(background)
        pf = self._sliced_packed(iteration)
        if self._path_pack is None:            # host-side extraction: once
            self._path_pack = EX.build_path_pack(self.packed)
        pack = self._path_pack
        if iteration is not None:              # pure prefix of the tree axis
            t = iteration * self.packed.trees_per_round
            pack = EX.PathPack(*(a[:t] for a in pack))
        phi, base = EX.shap_values(
            pf, codes, algorithm=algorithm, background=bg,
            row_chunk=self.cfg.predict_row_chunk, pack=pack)
        if check_additivity:
            raw = self.predict_raw(X, iteration)
            err = float((base + phi.sum(1) - raw).abs().max())
            if err > 1e-3:
                raise AssertionError(
                    f"SHAP additivity violated: max |base + sum(phi) - "
                    f"predict_raw| = {err:.2e}")
        return phi, base

    def apply(self, X, iteration: Optional[int] = None) -> torch.Tensor:
        """Terminal-node embeddings: ``(n, T)`` int32 node ids per tree in
        the packed forest's numbering (leaf ``j`` of a level-wise tree is
        ``2^depth - 1 + j``)."""
        return EX.apply_forest(self._sliced_packed(iteration), self._bin(X))

    def feature_importances(self, kind: str = "gain") -> torch.Tensor:
        """Normalised per-feature importances from the packed buffers
        (``kind`` in {"gain", "cover", "split_count"})."""
        m = self.quantizer.edges.shape[0]
        return EX.feature_importances(self.packed, kind=kind, n_features=m)

    @property
    def feature_importances_(self) -> torch.Tensor:
        """sklearn-style alias for gain importances."""
        return self.feature_importances("gain")

    def eval_loss(self, X, y) -> float:
        return float(L.get_loss(self.cfg.loss).value(self.predict_raw(X),
                                                     self._targets(y)))


def boost_round(F: torch.Tensor, codes: torch.Tensor, codes_t: torch.Tensor,
                Y: torch.Tensor, cfg: GBDTConfig, *,
                draw: Optional[np.ndarray] = None,
                generator: Optional[torch.Generator] = None):
    """One boosting round: gradients -> sketch -> tree -> leaf values,
    adding the tree's ``lr * value`` to the training scores ``F`` in place.
    The tree is a heap `tree.Tree` (level-wise) or a `tree.NodeTree`
    (``growth="leafwise"``); under ``strategy="one_vs_all"`` its fields
    carry a leading axis of the d univariate trees (no sketch).

    ``draw`` is this round's sketch draw (see `SketchBoost.fit`), else it
    is drawn from ``generator``.  Sample weights are all ones in this
    slice, so the count channel is ones and ``G * w`` is ``G``.
    """
    loss = L.get_loss(cfg.loss)
    G, Hd = loss.grad_hess(F, Y)
    if cfg.strategy == "one_vs_all":
        return _one_vs_all_round(F, codes, codes_t, G, Hd, cfg)
    draw_t = None if draw is None else torch.as_tensor(draw, device=F.device)
    Gk = SK.build_sketch(G, method=cfg.sketch_method, k=cfg.sketch_k,
                         draw=draw_t, generator=generator)
    ones = torch.ones((F.shape[0], 1), dtype=torch.float32, device=F.device)
    stats = torch.cat([Gk, ones], 1)
    del Gk
    kw = dict(depth=cfg.depth, n_bins=cfg.n_bins, lam=cfg.lambda_l2,
              min_data_in_leaf=cfg.min_data_in_leaf, min_gain=cfg.min_gain,
              hist_dtype=cfg.hist_dtype)
    if cfg.growth == "leafwise":
        tree, leaf_pos = T.grow_tree_leafwise(
            codes, codes_t, stats, G, Hd, max_leaves=cfg.max_leaves, **kw)
    else:
        tree, leaf_pos = T.grow_tree(codes, codes_t, stats, G, Hd,
                                     hist_engine=cfg.hist_engine, **kw)
    del G, Hd, stats
    contrib = tree.value[leaf_pos.long()]
    contrib.mul_(torch.tensor(cfg.learning_rate, dtype=torch.float32,
                              device=F.device))      # lr * v, then the add
    F.add_(contrib)
    return tree


def _one_vs_all_round(F: torch.Tensor, codes: torch.Tensor,
                      codes_t: torch.Tensor, G: torch.Tensor,
                      Hd: torch.Tensor, cfg: GBDTConfig):
    """A one-vs-all round: output j's univariate tree grows from ``g_j``
    and ``h_j``, the outputs in groups (`tree.ova_groups`), and each
    group's ``lr * value`` is added to its columns of ``F`` (two
    roundings, as the reference's ``F + lr * delta.T``).  Returns the
    round's trees, fields ``(d, ...)``."""
    n, d = G.shape
    lr = torch.tensor(cfg.learning_rate, dtype=torch.float32,
                      device=F.device)
    parts = []
    for t0, t1 in T.ova_groups(d, n):
        tree, leaf_pos = T.grow_trees(
            codes, codes_t, G[:, t0:t1], Hd[:, t0:t1], growth=cfg.growth,
            hist_engine=cfg.hist_engine, depth=cfg.depth,
            max_leaves=cfg.max_leaves, n_bins=cfg.n_bins,
            lam=cfg.lambda_l2, min_data_in_leaf=cfg.min_data_in_leaf,
            min_gain=cfg.min_gain, hist_dtype=cfg.hist_dtype)
        contrib = tree.value[..., 0].gather(1, leaf_pos.long())
        del leaf_pos
        contrib.mul_(lr)                       # lr * v, then the add
        F[:, t0:t1].add_(contrib.t())
        del contrib
        parts.append(tree)
    if len(parts) == 1:
        return parts[0]
    return type(parts[0])(*[torch.cat(f) for f in zip(*parts)])


def _apply_tree(tree, codes: torch.Tensor, F: torch.Tensor,
                cfg: GBDTConfig) -> torch.Tensor:
    """Add one round's tree to the raw scores ``F`` of new data, through
    the same traversal kernel as serving (in place).  A heap tree is
    mapped onto pointer nodes; a `tree.NodeTree` carries its pointers.  A
    one-vs-all round goes in one launch as d width-1 trees, tree j adding
    into column j."""
    if isinstance(tree, T.NodeTree):
        feat, thr, left, right, leaf = (tree.feat, tree.thr, tree.left,
                                        tree.right, tree.value)
    else:
        feat, thr, left, right, leaf = T.heap_to_node_arrays(
            tree.feat, tree.thr, tree.value)
    if cfg.strategy == "one_vs_all":
        out_col = torch.arange(feat.shape[0], dtype=torch.int32,
                               device=F.device)
    else:
        feat, thr, left, right, leaf = (feat[None], thr[None], left[None],
                                        right[None], leaf[None])
        out_col = torch.zeros(1, dtype=torch.int32, device=F.device)
    return predict_kernel.forest_traverse(
        F, codes, feat.contiguous(), thr.contiguous(), left.contiguous(),
        right.contiguous(), leaf.contiguous(), out_col, cfg.learning_rate,
        depth=cfg.depth)
