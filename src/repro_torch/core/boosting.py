"""SketchBoost: the gradient-boosting trainer, on PyTorch.

Port of the JAX package's ``core/boosting.py`` for the slices ported so
far: ``strategy="single_tree"`` and ``"one_vs_all"`` (d univariate trees a
round, grown together in groups: `tree.grow_trees`), level-wise growth
with any histogram engine (``"direct"``, ``"partition"``, ``"subtract"``)
and leaf-wise (best-first) growth under a ``max_leaves`` budget, float32
or bfloat16 histogram statistics, every sketch method, row sampling (SGB
``subsample``, GOSS ``goss_a``/``goss_b``: per-row weights in the count
channel) and column sampling (``colsample``: a feature mask in the split
scan), the non-finite guards (`core.guards`), round checkpoints and
resuming (``save_every``/``ckpt_dir``/``resume_from``, format v4 of
`io.checkpoint`) and the chaos hooks of `runtime.chaos`.
``dist_hist_compression="sketch"`` is legal only in the distributed fit
(`core.distributed`); here it raises, as the reference's does.  The fitted model explains itself as the reference's does:
`SketchBoost.shap_values`, `apply` and `feature_importances` (``explain/``).

Two loops, as the reference's, train the same forest bit for bit.
``loop="scan"`` (the default) runs `boost_scan` segments of ``scan_chunk``
rounds (cut at ``save_every`` and chaos rounds): each segment stacks its
trees, keeps every round's validation loss on the device and reads them
once, and the host replays early stopping and ``eval_every`` from them.
``loop="python"`` runs one `boost_round` a round and reads the loss each
evaluated round.  Under ``guard_policy="raise"`` the scan loop checks the
scores once a segment and names the segment's last round, as the
reference's does.

RNG seam: the reference splits each round's key into a sketch, a sample
and a column key, threefry streams that ``torch.Generator`` cannot
reproduce.  A free-running fit makes each round's draws from a generator
seeded with ``cfg.seed`` on the fit's device, in this order: the rows'
uniforms (row sampling only), the features' uniforms (``colsample < 1``
only), the sketch's draw; a checkpoint stores the generator's state at the
round boundary, so a resumed fit draws what the uninterrupted one drew.
``fit`` takes the per-round draws instead (the parity tests replay the
reference's draws through them): ``sketch_mats`` (Pi (d, k) for
``random_projection``, the Gumbel noise (k, d) for ``random_sampling``),
``sample_draws`` (round r's ``uniform(s_key, (n,))``) and
``feature_draws`` (round r's ``uniform(c_key, (m,))``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import explain as EX
from repro_torch.core import forest as FO
from repro_torch.core import guards as GU
from repro_torch.core import histogram as H
from repro_torch.core import losses as L
from repro_torch.core import quantize as Q
from repro_torch.core import sketch as SK
from repro_torch.core import tree as T
from repro_torch.core.device import resolve_device
from repro_torch.kernels import predict_kernel
from repro_torch.kernels.ref import HIST_DTYPES
from repro_torch.runtime import chaos as CH


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

    @property
    def dist_hist_k_effective(self) -> int:
        """JL width the sketched histogram collective actually uses."""
        return self.dist_hist_k if self.dist_hist_k > 0 else self.sketch_k

    def validate(self, *, distributed: bool = False) -> None:
        """Reject unknown or illegal values and options that would be
        silently ignored (the reference's checks of the options the port
        takes).  The distributed entry points (`core.distributed`) call it
        with ``distributed=True``: the histogram collective's options are
        legal there only, and row and column sampling are single-device
        only."""
        leafwise = self.growth == "leafwise"
        sampled = (self.subsample < 1.0 or self.goss_a > 0.0
                   or self.colsample < 1.0)
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
            (self.guard_policy in GU.GUARD_POLICIES,
             f"unknown guard_policy {self.guard_policy!r}; expected one of "
             f"{GU.GUARD_POLICIES} (see core.guards)"),
            (self.guard_clip > 0.0,
             "guard_clip must be > 0 (the clamp magnitude for the 'clip' "
             f"policy), got {self.guard_clip}"),
            (self.hessian_floor >= 0.0,
             f"hessian_floor must be >= 0, got {self.hessian_floor}"),
            (self.save_every >= 0,
             f"save_every must be >= 0, got {self.save_every}"),
            (self.save_every == 0 or bool(self.ckpt_dir),
             f"save_every={self.save_every} checkpoints every "
             f"{self.save_every} rounds but ckpt_dir is empty — there is "
             "nowhere to write; set ckpt_dir or save_every=0"),
            (self.ckpt_keep >= 1,
             "ckpt_keep must be >= 1 (at least the newest checkpoint "
             f"survives pruning), got {self.ckpt_keep}"),
            (self.dist_hist_compression in ("none", "sketch"),
             "unknown dist_hist_compression "
             f"{self.dist_hist_compression!r}; expected 'none' (exact "
             "all-reduce) or 'sketch' (JL-compressed collective)"),
            (self.dist_hist_k >= 0,
             f"dist_hist_k must be >= 0, got {self.dist_hist_k}"),
            (distributed or self.dist_hist_compression == "none",
             "dist_hist_compression='sketch' compresses the multi-device "
             "histogram collective; the single-device path has no "
             "collective and would silently ignore it: train through "
             "core.distributed (fit_distributed) or keep 'none'"),
            (not distributed or self.dist_hist_compression == "none"
             or self.dist_hist_k_effective >= 1,
             "dist_hist_compression='sketch' needs a JL width for the "
             "collective: set dist_hist_k >= 1 (or leave it 0 with "
             "sketch_k >= 1)"),
            (not distributed or not sampled,
             "row and column sampling (subsample, goss_a/goss_b, "
             "colsample) are single-device only: the distributed round "
             "would silently ignore them; train through SketchBoost.fit "
             "or drop them"),
        ]
        for ok, msg in checks:
            if not ok:
                raise ValueError(msg)

    def resolve(self, d: int) -> "GBDTConfig":
        """Validate, bind the output dimension ``d`` and normalise
        ``hist_engine`` (`histogram.resolve_hist_engine`).  ``use_kernel``
        stays as it is: the port picks kernels by device."""
        self.validate()
        return dataclasses.replace(
            self, n_outputs=d,
            hist_engine=H.resolve_hist_engine(self.hist_engine))

    def strip_io(self) -> "GBDTConfig":
        """The config without its checkpoint knobs: what the rounds run
        under (where and how often a fit checkpoints changes no round)."""
        return dataclasses.replace(self, save_every=0, ckpt_dir="",
                                   ckpt_keep=3, resume_from="")


#: The hyperparameters a resumed fit must share with the run that wrote the
#: checkpoint (the reference's list): each changes gradients, sketches,
#: tree shapes or the draws, so a mismatch breaks bit-identity.
RESUME_CFG_KEYS = (
    "loss", "strategy", "sketch_method", "sketch_k", "growth", "max_leaves",
    "depth", "n_bins", "learning_rate", "lambda_l2", "min_data_in_leaf",
    "min_gain", "subsample", "goss_a", "goss_b", "colsample", "hist_dtype",
    "guard_policy", "guard_clip", "hessian_floor", "seed")


def _resume_cfg_snapshot(cfg: GBDTConfig) -> Dict[str, Any]:
    return {k: getattr(cfg, k) for k in RESUME_CFG_KEYS}


def _check_resume_compat(cfg: GBDTConfig, state) -> None:
    """Refuse to resume under a config that breaks bit-identity."""
    saved = dict(state.meta.get("train", {}).get("cfg", {}))
    want = _resume_cfg_snapshot(cfg)
    diffs = [f"{k}: checkpoint={saved[k]!r} != fit={want[k]!r}"
             for k in RESUME_CFG_KEYS if k in saved and saved[k] != want[k]]
    if diffs:
        raise ValueError(
            "resume_from checkpoint was written under a different config — "
            "the resumed rounds would not reproduce the uninterrupted run:"
            "\n  " + "\n  ".join(diffs))
    if state.round > cfg.n_trees:
        raise ValueError(
            f"resume_from checkpoint already holds {state.round} completed "
            f"rounds but cfg.n_trees={cfg.n_trees}; raise n_trees past the "
            "checkpoint to continue training")


def _draws_rows(cfg: GBDTConfig) -> bool:
    """Does a round draw row uniforms (SGB or GOSS)?"""
    return cfg.goss_a > 0.0 or cfg.subsample < 1.0


def _draws_sketch(cfg: GBDTConfig) -> bool:
    return (cfg.strategy == "single_tree" and cfg.sketch_method in
            ("random_projection", "random_sampling"))


# -- fault-injection hooks (duck-typed; see runtime.chaos) -------------------

def _chaos_mutate(chaos, Y, round_idx: int):
    """Apply data-corruption injections (e.g. NaN-at-row) due at or before
    ``round_idx``; the corruption persists from its trigger round on."""
    for c in chaos:
        mutate = getattr(c, "mutate_targets", None)
        if mutate is not None:
            Y = mutate(Y, round_idx)
    return Y


# -- row and column sampling ---------------------------------------------------

def _sample_weights(G: torch.Tensor, cfg: GBDTConfig,
                    u: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Per-row weights of SGB / GOSS from the round's row uniforms ``u``
    (n,): (n,) float32, or None without row sampling (all ones).  GOSS
    (Ke et al., 2017) keeps every row whose squared gradient norm reaches
    the ``max(int(goss_a n), 1)``-th largest (rows tied at the threshold
    all stay), and of the rest those with ``u < goss_b``, amplified by
    ``(1 - goss_a) / goss_b``; SGB keeps the rows with ``u <
    subsample``."""
    n = G.shape[0]
    if cfg.goss_a > 0.0:
        gnorm = torch.square(G).sum(1)
        n_top = max(int(cfg.goss_a * n), 1)
        thresh = torch.kthvalue(gnorm, n - n_top + 1).values
        top = gnorm >= thresh
        amp = (1.0 - cfg.goss_a) / max(cfg.goss_b, 1e-12)
        zero = torch.zeros((), dtype=torch.float32, device=G.device)
        rand = torch.where(u < cfg.goss_b, torch.full_like(zero, amp), zero)
        return torch.where(top, torch.ones_like(zero), rand)
    if cfg.subsample < 1.0:
        return (u < cfg.subsample).to(torch.float32)
    return None


def _feature_mask(cfg: GBDTConfig, u: Optional[torch.Tensor]
                  ) -> Optional[torch.Tensor]:
    """The round's feature mask from its feature uniforms ``u`` (m,):
    ``u < colsample`` (bool), or None with every feature."""
    if cfg.colsample >= 1.0:
        return None
    return u < cfg.colsample


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
        raise ValueError(
            f"{where} contains non-finite values; targets must be finite — "
            "clean them, or pass check_input=False with a guard_policy to "
            "exercise the non-finite guards deliberately")
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
            verbose: bool = False, *, check_input: bool = True, chaos=None,
            sketch_mats: Optional[Sequence] = None,
            sample_draws: Optional[Sequence] = None,
            feature_draws: Optional[Sequence] = None) -> "SketchBoost":
        """Train the ensemble.

        ``check_input`` routes X/y (and the eval set) through
        `validate_features` / `validate_targets`; turn it off only to feed
        corrupt data to the non-finite guards on purpose.  ``chaos`` takes
        `runtime.chaos` injections (or a list), consulted at every round
        boundary.  With ``cfg.save_every > 0`` the fit checkpoints every
        ``save_every`` rounds into ``cfg.ckpt_dir``; ``cfg.resume_from``
        restores such a checkpoint and continues the run bit for bit (same
        data, same config, same device).

        ``sketch_mats``, ``sample_draws`` and ``feature_draws`` optionally
        give round r's draws (numpy arrays or tensors, indexed by the
        absolute round): ``sketch_mats[r]`` the (d, k) projection for
        ``random_projection`` or the (k, d) Gumbel noise for
        ``random_sampling`` (other methods draw nothing),
        ``sample_draws[r]`` the (n,) row uniforms of SGB/GOSS,
        ``feature_draws[r]`` the (m,) feature uniforms of ``colsample``.
        A draw not given comes from a generator seeded with ``cfg.seed``.
        """
        if check_input:
            X = validate_features(X)
            y = validate_targets(y, loss=self.cfg.loss, n_rows=X.shape[0])
        else:
            X = np.ascontiguousarray(X, dtype=np.float32)
        d = self._infer_d(y)
        cfg = self.cfg.resolve(d)
        chaos = CH.as_chaos_list(chaos)
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)

        state = None
        if cfg.resume_from:
            from repro_torch.io import checkpoint as CK
            state = CK.load_boost_checkpoint(cfg.resume_from,
                                             device=self.device)
            _check_resume_compat(cfg, state)
            if state.quantizer is None:
                raise ValueError(
                    f"checkpoint under {cfg.resume_from!r} carries no "
                    "quantizer; resume needs the binning saved at fit time "
                    "(cfg.save_every checkpoints store it automatically)")
            # The saved binning and base score: refitting them would risk
            # drift and break bit-identity.
            self.quantizer = state.quantizer
            self.base_score = state.packed.base.to(torch.float32)
        else:
            self.quantizer = Q.fit_quantizer(X, cfg.n_bins, seed=cfg.seed,
                                             device=self.device)
        codes, codes_t = self._codes(X)
        Y = self._targets(y)
        if state is None:
            self.base_score = self._base(Y, d).to(torch.float32)
        n = codes.shape[0]
        if state is not None:
            if tuple(state.F.shape) != (n, d):
                raise ValueError(
                    f"resume_from checkpoint holds training scores of shape "
                    f"{tuple(state.F.shape)} but X/y give ({n}, {d}); "
                    "resume must rerun fit() on the same training data")
            F = state.F.to(self.device, torch.float32).contiguous()
        else:
            F = self.base_score.expand(n, d).contiguous()
        has_eval = eval_set is not None
        Fv = codes_v = Yv = None
        if has_eval:
            m = self.quantizer.edges.shape[0]
            Xv = (validate_features(eval_set[0], n_features=m,
                                    where="eval_set X") if check_input
                  else np.ascontiguousarray(eval_set[0], dtype=np.float32))
            codes_v, _ = self._codes(Xv)
            yv = (validate_targets(eval_set[1], loss=cfg.loss,
                                   n_rows=Xv.shape[0], where="eval_set y")
                  if check_input else eval_set[1])
            Yv = self._targets(yv)
            if state is not None:
                if state.Fv is None:
                    raise ValueError(
                        "resume_from checkpoint was saved without an eval "
                        "set but fit() got one; the early-stopping "
                        "trajectory cannot be reconstructed — drop eval_set "
                        "or refit from scratch")
                if tuple(state.Fv.shape) != (Xv.shape[0], d):
                    raise ValueError(
                        f"resume_from checkpoint holds eval scores of shape "
                        f"{tuple(state.Fv.shape)} but eval_set gives "
                        f"({Xv.shape[0]}, {d}); resume must use the same "
                        "eval set")
                Fv = state.Fv.to(self.device, torch.float32).contiguous()
            else:
                Fv = self.base_score.expand(Xv.shape[0], d).contiguous()
        elif state is not None and state.Fv is not None:
            raise ValueError(
                "resume_from checkpoint carries eval scores but fit() got "
                "no eval_set; pass the same eval_set so early stopping "
                "replays bit-identically")

        if state is not None:
            self._resume_generator(gen, state, cfg, sketch_mats,
                                   sample_draws, feature_draws)
            prefix = state.trees
            best = (state.best_loss, state.best_round)
            self.history = list(state.history)
        else:
            prefix, best = None, (np.inf, -1)
            self.history = []
        loop = self._fit_scan if cfg.loop == "scan" else self._fit_python
        forest, best_round = loop(
            cfg.strip_io(), F, codes, codes_t, Y, Fv, codes_v, Yv, has_eval,
            gen, verbose, start=0 if state is None else state.round,
            prefix=prefix, best=best, chaos=chaos,
            saver=self._make_saver(cfg, has_eval, gen),
            save_every=cfg.save_every,
            draws=(sketch_mats, sample_draws, feature_draws))
        if best_round >= 0 and cfg.early_stopping_rounds:
            forest = _head(forest, best_round + 1)
        self.best_round = (best_round if best_round >= 0
                           else forest.feat.shape[0] - 1)
        self.cfg = cfg
        self.forest = forest
        self.packed = self._pack(self.forest, cfg)
        self._path_pack = None
        return self

    def _fit_scan(self, cfg: GBDTConfig, F, codes, codes_t, Y, Fv, codes_v,
                  Yv, has_eval: bool, gen, verbose: bool, *, start: int,
                  prefix, best, chaos, saver, save_every: int, draws):
        """The default loop: `boost_scan` segments of ``scan_chunk`` rounds,
        cut at checkpoint (``save_every``) and chaos rounds so that saves
        and injections land on round boundaries.  The validation losses are
        read once a segment, and early stopping and ``eval_every`` are
        replayed from them on the host; ``train_time_s`` is interpolated
        within a segment.  Returns the stacked forest of every round run
        and the best round."""
        n_total = cfg.n_trees
        chunk = cfg.scan_chunk if cfg.scan_chunk > 0 else n_total
        chunk = max(1, min(chunk, max(n_total - start, 1)))
        best_loss, best_round = best
        chunks = [] if prefix is None else [prefix]
        done, stop = start, False
        t0 = time.perf_counter()
        seg_start = 0.0
        while done < n_total and not stop:
            CH.check_round_all(chaos, done)
            Y = _chaos_mutate(chaos, Y, done)
            steps = min(chunk, n_total - done)
            if save_every > 0:
                steps = min(steps, (done // save_every + 1) * save_every
                            - done)
            nxt = _next_chaos_round(chaos, done)
            if nxt is not None:
                steps = min(steps, nxt - done)
            F, Fv, trees, vloss = boost_scan(
                F, codes, codes_t, Y, Fv, codes_v, Yv, cfg, n_steps=steps,
                has_eval=has_eval, generator=gen,
                draws=_segment_draws(draws, done, steps))
            vl = _to_host(vloss)           # the segment's one host read
            if cfg.guard_policy == "raise":
                GU.check_scores_host(F, done + steps - 1)
            elapsed = time.perf_counter() - t0
            keep = steps
            for j in range(steps):
                it = done + j
                rec = {"round": it, "train_time_s":
                       seg_start + (elapsed - seg_start) * (j + 1) / steps}
                if has_eval and it % cfg.eval_every == 0:
                    rec["valid_loss"] = vl[j]
                    if vl[j] < best_loss - 1e-9:
                        best_loss, best_round = vl[j], it
                    if (cfg.early_stopping_rounds
                            and it - best_round >= cfg.early_stopping_rounds):
                        self.history.append(rec)
                        keep, stop = j + 1, True
                        if verbose:
                            print(f"[sketchboost] early stop @ {it} "
                                  f"(best {best_loss:.5f} @ {best_round})")
                        break
                self.history.append(rec)
            chunks.append(trees if keep == steps else _head(trees, keep))
            done += keep
            seg_start = elapsed
            if saver is not None and not stop and done % save_every == 0:
                saver(done, _concat_chunks(chunks), F, Fv, best_loss,
                      best_round, list(self.history))
            if verbose and not stop:
                msg = f"[sketchboost] round {done - 1}"
                if has_eval:
                    msg += f" valid_loss={vl[keep - 1]:.5f}"
                print(msg)
        return _concat_chunks(chunks), best_round

    def _fit_python(self, cfg: GBDTConfig, F, codes, codes_t, Y, Fv,
                    codes_v, Yv, has_eval: bool, gen, verbose: bool, *,
                    start: int, prefix, best, chaos, saver, save_every: int,
                    draws):
        """One `boost_round` a round, the validation loss read every
        evaluated round; trains the forest of `_fit_scan` bit for bit."""
        loss = L.get_loss(cfg.loss)
        trees = [] if prefix is None else T.unstack_trees(prefix)
        best_loss, best_round = best
        t0 = time.perf_counter()
        for it in range(start, cfg.n_trees):
            CH.check_round_all(chaos, it)
            Y = _chaos_mutate(chaos, Y, it)
            draw, sample_draw, feature_draw = _round_draws(draws, it)
            tree = boost_round(F, codes, codes_t, Y, cfg, draw=draw,
                               generator=gen, sample_draw=sample_draw,
                               feature_draw=feature_draw)
            if cfg.guard_policy == "raise":
                GU.check_scores_host(F, it)
            trees.append(tree)
            rec = {"round": it, "train_time_s": time.perf_counter() - t0}
            if has_eval:
                Fv = _apply_tree(tree, codes_v, Fv, cfg)
            if has_eval and it % cfg.eval_every == 0:
                vloss = _to_host(loss.value(Fv, Yv))
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
            if saver is not None and (it + 1) % save_every == 0:
                saver(it + 1, T.stack_trees(trees), F, Fv, best_loss,
                      best_round, list(self.history))
            if verbose and it % 20 == 0:
                msg = f"[sketchboost] round {it}"
                if "valid_loss" in rec:
                    msg += f" valid_loss={rec['valid_loss']:.5f}"
                print(msg)
        return T.stack_trees(trees), best_round

    def _pack(self, forest, cfg: GBDTConfig) -> FO.PackedForest:
        return FO.pack_forest(
            forest, self.base_score, cfg.learning_rate,
            strategy=cfg.strategy,
            max_depth=cfg.depth if cfg.growth == "leafwise" else None)

    def _resume_generator(self, gen: torch.Generator, state,
                          cfg: GBDTConfig, sketch_mats, sample_draws,
                          feature_draws) -> None:
        """Put the fit's generator where the checkpointed run's was at its
        round boundary.  A step the JAX package wrote holds a threefry key
        instead, which torch cannot continue: such a step resumes only with
        every draw the remaining rounds make injected."""
        if state.generator is not None:
            if state.generator_device != self.device.type:
                raise ValueError(
                    f"resume_from checkpoint holds the draws' generator of "
                    f"a fit on {state.generator_device!r}, but this fit runs "
                    f"on {self.device.type!r}; resume on the device that "
                    "wrote it")
            gen.set_state(state.generator)
            return
        missing = [name for name, needed, given in (
            ("sketch_mats", _draws_sketch(cfg), sketch_mats),
            ("sample_draws", _draws_rows(cfg), sample_draws),
            ("feature_draws", cfg.colsample < 1.0, feature_draws))
            if needed and given is None]
        if missing and state.round < cfg.n_trees:
            raise ValueError(
                f"resume_from checkpoint under {cfg.resume_from!r} was "
                "written by the JAX package: it holds a threefry key "
                "('train/key') and no 'train/generator', and torch cannot "
                "continue a threefry stream; pass the remaining rounds' "
                f"draws ({', '.join(missing)}) to fit()")

    def _make_saver(self, cfg: GBDTConfig, has_eval: bool,
                    gen: torch.Generator):
        """Round-boundary checkpoint closure (None when checkpointing is
        off).  Every save is a format-v4 step: the packed serving prefix
        plus the raw resume state, with the generator's state at the
        boundary under ``train/generator``."""
        if not (cfg.save_every > 0 and cfg.ckpt_dir):
            return None
        from repro_torch.io import checkpoint as CK

        def save(round_done, forest, F, Fv, best_loss, best_round, history):
            packed = self._pack(forest, cfg)
            meta = _resume_cfg_snapshot(cfg)
            meta["extra_meta"] = {
                "best_iteration": int(best_round) + 1 if best_round >= 0
                else int(round_done)}
            CK.save_boost_checkpoint(
                cfg.ckpt_dir, round_done=int(round_done), packed=packed,
                quantizer=self.quantizer, trees=forest, F=F,
                Fv=(Fv if has_eval else None), generator=gen,
                history=history, best_loss=float(best_loss),
                best_round=int(best_round), cfg_meta=meta,
                keep_n=cfg.ckpt_keep)

        return save

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


def _round_draw(draws: Optional[Sequence], it: int):
    """Round ``it``'s injected draw, or None."""
    return None if draws is None else draws[it]


def _round_draws(draws: Tuple, it: int) -> Tuple:
    """Round ``it``'s (sketch, sample, feature) draws from ``fit``'s
    ``(sketch_mats, sample_draws, feature_draws)``."""
    return tuple(_round_draw(d, it) for d in draws)


def _segment_draws(draws: Tuple, start: int, steps: int):
    """The per-round draw triples of rounds ``start .. start + steps - 1``
    for `boost_scan`, or None when nothing is injected."""
    if all(d is None for d in draws):
        return None
    return [_round_draws(draws, it) for it in range(start, start + steps)]


def _next_chaos_round(chaos, done: int) -> Optional[int]:
    """The earliest chaos trigger round after ``done`` (a scan segment
    ends there, so the injection lands on a round boundary)."""
    rounds = [int(c.round) for c in chaos
              if getattr(c, "round", None) is not None and int(c.round) > done]
    return min(rounds) if rounds else None


def _to_host(t: torch.Tensor):
    """A device value read to the host (a float, or a list of them): the
    loops' one read of the validation loss, a round's or a segment's."""
    return t.tolist()


def _head(stacked, n: int):
    """The first ``n`` rounds of a stacked `Forest` or `NodeTree`."""
    return type(stacked)(*[None if f is None else f[:n] for f in stacked])


def _concat_chunks(chunks):
    """Stacked segments (and a resumed prefix) joined along the round
    axis."""
    if len(chunks) == 1:
        return chunks[0]
    return type(chunks[0])(*[None if f[0] is None else torch.cat(f)
                             for f in zip(*chunks)])


def _draw_tensor(draw, device) -> Optional[torch.Tensor]:
    """An injected draw (numpy array or tensor) as float32 on ``device``."""
    if draw is None:
        return None
    if not torch.is_tensor(draw):
        draw = torch.from_numpy(np.array(draw, np.float32))
    return draw.to(device=device, dtype=torch.float32)


def boost_round(F: torch.Tensor, codes: torch.Tensor, codes_t: torch.Tensor,
                Y: torch.Tensor, cfg: GBDTConfig, *,
                draw=None, generator: Optional[torch.Generator] = None,
                sample_draw=None, feature_draw=None):
    """One boosting round: gradients -> guards -> sample weights and
    feature mask -> sketch -> tree -> leaf values, adding the tree's ``lr *
    value`` to the training scores ``F`` in place.  The tree is a heap
    `tree.Tree` (level-wise) or a `tree.NodeTree` (``growth="leafwise"``);
    under ``strategy="one_vs_all"`` its fields carry a leading axis of the
    d univariate trees (no sketch).

    ``draw``, ``sample_draw`` and ``feature_draw`` are this round's sketch
    draw, row uniforms (n,) and feature uniforms (m,) (see
    `SketchBoost.fit`); a draw the round needs and is not given comes from
    ``generator``: the row uniforms first, then the feature uniforms, then
    the sketch's.  Under ``guard_policy="skip_round"`` a round that met a
    non-finite value has its leaf values and gains multiplied by 0 (a
    device flag: no host read), so F is unchanged.
    """
    loss = L.get_loss(cfg.loss)
    device = F.device
    G, Hd = loss.grad_hess(F, Y)
    G, Hd, bad = GU.guard_grad_hess(G, Hd, cfg.guard_policy, cfg.guard_clip,
                                    cfg.hessian_floor)
    n, m = codes.shape
    u_rows = _draw_tensor(sample_draw, device)
    if u_rows is None and _draws_rows(cfg):
        u_rows = torch.rand((n,), generator=generator, dtype=torch.float32,
                            device=device)
    w = _sample_weights(G, cfg, u_rows)
    del u_rows
    u_feat = _draw_tensor(feature_draw, device)
    if u_feat is None and cfg.colsample < 1.0:
        u_feat = torch.rand((m,), generator=generator, dtype=torch.float32,
                            device=device)
    fmask = _feature_mask(cfg, u_feat)
    if cfg.strategy == "one_vs_all":
        return _one_vs_all_round(F, codes, codes_t, G, Hd, cfg, w, fmask,
                                 bad)
    Gk = SK.build_sketch(G if w is None else G * w[:, None],
                         method=cfg.sketch_method, k=cfg.sketch_k,
                         draw=_draw_tensor(draw, device),
                         generator=generator)
    count = (torch.ones((n, 1), dtype=torch.float32, device=device)
             if w is None else w[:, None])
    stats = torch.cat([Gk, count], 1)
    del Gk, count
    # Again after the sketch: a projection can overflow on its own.
    stats, bad = GU.guard_stats(stats, cfg.guard_policy, cfg.guard_clip, bad)
    kw = dict(depth=cfg.depth, n_bins=cfg.n_bins, lam=cfg.lambda_l2,
              min_data_in_leaf=cfg.min_data_in_leaf, min_gain=cfg.min_gain,
              feature_mask=fmask, hist_dtype=cfg.hist_dtype, weights=w)
    if cfg.growth == "leafwise":
        tree, leaf_pos = T.grow_tree_leafwise(
            codes, codes_t, stats, G, Hd, max_leaves=cfg.max_leaves, **kw)
    else:
        tree, leaf_pos = T.grow_tree(codes, codes_t, stats, G, Hd,
                                     hist_engine=cfg.hist_engine, **kw)
    del G, Hd, stats, w
    if cfg.guard_policy == "skip_round":
        scale = GU.skip_scale(bad, cfg.guard_policy, device)
        tree = tree._replace(value=tree.value * scale,
                             gain=tree.gain * scale)
    contrib = tree.value[leaf_pos.long()]
    contrib.mul_(torch.tensor(cfg.learning_rate, dtype=torch.float32,
                              device=device))        # lr * v, then the add
    F.add_(contrib)
    return tree


def boost_scan(F: torch.Tensor, codes: torch.Tensor, codes_t: torch.Tensor,
               Y: torch.Tensor, Fv: Optional[torch.Tensor],
               codes_v: Optional[torch.Tensor], Yv: Optional[torch.Tensor],
               cfg: GBDTConfig, *, n_steps: int, has_eval: bool,
               generator: Optional[torch.Generator] = None,
               draws: Optional[Sequence] = None):
    """``n_steps`` boosting rounds, one segment of the default loop.

    Each round is a `boost_round` (F updated in place); with an eval set
    the round's tree is added to ``Fv`` through the traversal kernel and
    its validation loss kept on the device.  ``draws`` is None or
    ``n_steps`` ``(draw, sample_draw, feature_draw)`` triples, round j's
    injected draws (`boost_round`); what is not given comes from
    ``generator``.  Nothing here reads a value to the host that the rounds
    do not read themselves.

    Returns ``(F, Fv, trees, vloss)``: ``trees`` the segment's trees
    stacked with a leading ``n_steps`` axis (`tree.stack_trees`), ``vloss``
    an ``(n_steps,)`` float32 tensor on the device (zeros without an eval
    set).
    """
    loss = L.get_loss(cfg.loss)
    trees, vloss = [], []
    zero = torch.zeros((), dtype=torch.float32, device=F.device)
    for j in range(n_steps):
        draw, sample_draw, feature_draw = (
            (None, None, None) if draws is None else draws[j])
        tree = boost_round(F, codes, codes_t, Y, cfg, draw=draw,
                           generator=generator, sample_draw=sample_draw,
                           feature_draw=feature_draw)
        trees.append(tree)
        if has_eval:
            Fv = _apply_tree(tree, codes_v, Fv, cfg)
            vloss.append(loss.value(Fv, Yv).to(torch.float32))
        else:
            vloss.append(zero)
    return F, Fv, T.stack_trees(trees), torch.stack(vloss)


def _one_vs_all_round(F: torch.Tensor, codes: torch.Tensor,
                      codes_t: torch.Tensor, G: torch.Tensor,
                      Hd: torch.Tensor, cfg: GBDTConfig,
                      w: Optional[torch.Tensor] = None,
                      fmask: Optional[torch.Tensor] = None, bad=None,
                      reduce=None):
    """A one-vs-all round: output j's univariate tree grows from ``g_j w``,
    ``w`` and ``h_j``, the outputs in groups (`tree.ova_groups`), and each
    group's ``lr * value`` is added to its columns of ``F`` (two
    roundings, as the reference's ``F + lr * delta.T``).  Under
    ``skip_round`` a round that met a non-finite value zeroes every
    output's tree (the statistics are the sanitized gradients: no sketch
    to check again).  ``reduce`` (`core.distributed.RowReduce`) makes the
    groups this rank's share of distributed trees.  Returns the round's
    trees, fields ``(d, ...)``."""
    n, d = G.shape
    lr = torch.tensor(cfg.learning_rate, dtype=torch.float32,
                      device=F.device)
    scale = (GU.skip_scale(bad, cfg.guard_policy, F.device)
             if cfg.guard_policy == "skip_round" else None)
    parts = []
    for t0, t1 in T.ova_groups(d, n):
        tree, leaf_pos = T.grow_trees(
            codes, codes_t, G[:, t0:t1], Hd[:, t0:t1], growth=cfg.growth,
            hist_engine=cfg.hist_engine, depth=cfg.depth,
            max_leaves=cfg.max_leaves, n_bins=cfg.n_bins,
            lam=cfg.lambda_l2, min_data_in_leaf=cfg.min_data_in_leaf,
            min_gain=cfg.min_gain, feature_mask=fmask,
            hist_dtype=cfg.hist_dtype, weights=w, reduce=reduce)
        if scale is not None:
            tree = tree._replace(value=tree.value * scale,
                                 gain=tree.gain * scale)
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
