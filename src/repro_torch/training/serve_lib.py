"""GBDT forest serving: batched scoring with admission control.

Port of the JAX package's ``training/serve_lib.py``.  `ForestServer` loads
a checkpointed `PackedForest` (+ quantizer), optionally prunes, compacts and
quantizes it, micro-batches requests into zero-padded power-of-two buckets,
and scores them through the traversal kernels on the card: B3 for a float32
forest, B5 for an int8 or bfloat16 one.

Overload behaviour is explicit: a bounded admission queue sheds requests
past ``max_queue_rows``, per-request deadlines drop work that waited too
long, and batches past ``overload_rows`` score on a prefix of the forest
(`core.forest.slice_rounds` at half of ``best_iteration``), each counted in
``stats``.  All knobs default off.

Where the port departs from the reference: the server follows the port's
device rule (``device=None`` is CUDA); ``use_kernel`` accepts only True (the
port picks kernels by device); nothing is compiled per shape, so a bucket
saves no compile here and its padding only adds rows to traverse, but the
buckets and every ``stats`` counter behave as the reference's do.

Explanations: `ForestServer.explain` / `serve_explain` return TreeSHAP
attributions of the float32 twin of the served forest (`explain_packed`:
the dequantized forest of a quantized server), through the B6 kernel on
the card, under `predict_codes`'s bucket and chunk policy;
`feature_importances` reads the packed gains and covers.  A cover-less
(format_version 1) checkpoint serves interventional SHAP only.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as TF

from repro_torch import explain as EX
from repro_torch.core import forest as FO
from repro_torch.core import quantize as Q
from repro_torch.core.boosting import validate_features
from repro_torch.core.device import resolve_device
from repro_torch.core.losses import get_loss
from repro_torch.io.checkpoint import dtype_name, load_forest_checkpoint


@dataclasses.dataclass(frozen=True)
class ForestServeConfig:
    """Knobs for `ForestServer`, with the reference's fields and defaults.

    ``max_batch`` caps the padded micro-batch (requests up to it pad to the
    next power of two); larger batches stream in ``min(row_chunk,
    max_batch)`` chunks; with ``double_buffer`` their raw features go to
    the card chunk by chunk, each copy overlapping the binning and
    traversal of the chunk before it.
    ``prune_alpha`` (None = off) prunes and compacts the float32 forest,
    ``quantize`` ("none", "bfloat16", "int8") stores it quantized;
    ``max_buckets`` caps the LRU bucket set (0 = unbounded).  Admission:
    ``max_queue_rows``, ``deadline_ms``, ``overload_rows``,
    ``fallback_rounds`` and ``best_iteration`` (0 = all rounds).
    """
    loss: str = "multiclass"
    max_batch: int = 4096
    row_chunk: int = 65536
    use_kernel: Any = True
    prune_alpha: Optional[float] = None
    quantize: str = "none"
    max_buckets: int = 0
    double_buffer: bool = False
    max_queue_rows: int = 0
    deadline_ms: float = 0.0
    overload_rows: int = 0
    fallback_rounds: int = 0
    best_iteration: int = 0


class BucketCache:
    """LRU set of power-of-two padded batch sizes in active use.

    A miss on a full cache first UPGRADES to the smallest cached bucket
    that fits, and only then evicts the least recently used one.  Shared by
    every server of a `ModelRegistry`.
    """

    def __init__(self, max_buckets: int = 0):
        self.max_buckets = int(max_buckets)
        self._lru: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        self.hits = 0
        self.admissions = 0
        self.upgrades = 0
        self.evictions = 0

    def bucket_for(self, n: int, max_batch: int) -> Tuple[int, str]:
        """Padded bucket for an ``n``-row request: ``(bucket, event)`` with
        event one of ``"hit" | "admit" | "upgrade" | "evict"``."""
        want = max(8, 1 << (max(n, 1) - 1).bit_length())
        if want in self._lru:
            self._lru.move_to_end(want)
            self.hits += 1
            return want, "hit"
        if self.max_buckets and len(self._lru) >= self.max_buckets:
            bigger = [b for b in self._lru if want < b <= max_batch]
            if bigger:
                b = min(bigger)
                self._lru.move_to_end(b)
                self.upgrades += 1
                return b, "upgrade"
            self._lru.popitem(last=False)
            self.evictions += 1
            self._lru[want] = None
            return want, "evict"
        self._lru[want] = None
        self.admissions += 1
        return want, "admit"

    @property
    def active_buckets(self) -> List[int]:
        return sorted(self._lru)

    def stats(self) -> Dict[str, Any]:
        return {"hits": self.hits, "admissions": self.admissions,
                "upgrades": self.upgrades, "evictions": self.evictions,
                "active_buckets": self.active_buckets,
                "max_buckets": self.max_buckets}


def _forest_bytes(pf) -> int:
    """Model bytes at rest (threshold, pointer and leaf tensors + scales)."""
    fields = [pf.feat, pf.thr, pf.left, pf.right, pf.leaf, pf.out_col,
              pf.base]
    scale = getattr(pf, "leaf_scale", None)
    if scale is not None:
        fields.append(scale)
    return int(sum(x.numel() * x.element_size() for x in fields))


def _to_device(pf, device: torch.device):
    """The forest with every tensor field but the host scalar ``lr`` on
    ``device``."""
    return pf._replace(**{k: v.to(device) for k, v in pf._asdict().items()
                          if torch.is_tensor(v) and k != "lr"})


class ForestServer:
    """Batched GBDT inference over a `PackedForest` on one device.

    >>> server = ForestServer.from_checkpoint("/ckpts/otto")    # on cuda
    >>> proba = server.predict(X)                   # raw features in
    >>> outs = server.serve([req1, req2, req3])     # micro-batched requests

    With admission knobs set, `submit` / `drain` apply backpressure.
    """

    _ZERO_STATS = {"requests": 0, "rows": 0, "batches": 0,
                   "predict_time_s": 0.0, "explain_requests": 0,
                   "explain_rows": 0, "explain_time_s": 0.0,
                   "shed_requests": 0, "shed_rows": 0,
                   "deadline_requests": 0, "deadline_rows": 0,
                   "fallback_batches": 0, "fallback_rows": 0,
                   "bucket_upgrades": 0, "bucket_evictions": 0,
                   "pipelined_batches": 0, "errors": 0}

    @staticmethod
    def _concat_requests(requests: Sequence):
        """Row-block requests -> one batch + the per-request sizes."""
        blocks = [np.atleast_2d(np.asarray(r, np.float32)) for r in requests]
        return np.concatenate(blocks, axis=0), [b.shape[0] for b in blocks]

    def __init__(self, packed, quantizer=None,
                 cfg: ForestServeConfig = ForestServeConfig(), *,
                 clock=None, bucket_cache: Optional[BucketCache] = None,
                 device=None):
        if cfg.use_kernel is not True:
            raise ValueError("use_kernel selects Pallas modes of the JAX "
                             "package; the port picks kernels by device "
                             "(pass device='cpu' for the plain versions)")
        self.device = resolve_device(device)
        packed = _to_device(packed, self.device)
        self.quantizer = (None if quantizer is None else quantizer._replace(
            edges=quantizer.edges.to(self.device)))
        self.cfg = cfg
        # Compression, once at construction: prune -> compact on a float32
        # forest, then quantize its storage.  A forest that arrives
        # quantized (a v5 checkpoint) serves as stored.
        nodes0 = int(packed.node_count.sum())
        depth0, bytes0 = packed.depth, _forest_bytes(packed)
        already_quantized = getattr(packed, "leaf_scale", None) is not None
        if cfg.prune_alpha is not None and not already_quantized:
            packed = FO.compact_forest(FO.prune_forest(packed,
                                                       cfg.prune_alpha))
        if cfg.quantize not in (None, "none") and not already_quantized:
            packed = Q.quantize_forest(packed, cfg.quantize)
        self.packed = packed
        self.compression = {
            "nodes_before": nodes0,
            "nodes_after": int(self.packed.node_count.sum()),
            "depth_before": int(depth0), "depth_after": int(self.packed.depth),
            "bytes_before": int(bytes0),
            "bytes_after": int(_forest_bytes(self.packed)),
            "prune_alpha": cfg.prune_alpha,
            "quantize": self.quantized or "none"}
        self._explain_packed = None     # lazy float32 twin
        self._path_pack = None          # lazy path pack of the twin
        self._fallback = None           # lazy sliced overload forest
        self.buckets = (bucket_cache if bucket_cache is not None
                        else BucketCache(cfg.max_buckets))
        # Injectable clock (chaos.VirtualClock in tests) so deadlines are
        # deterministic; wall time in production.
        self._now = clock.time if hasattr(clock, "time") else time.monotonic
        self._queue: List[Tuple[Optional[float], np.ndarray]] = []
        self._queued_rows = 0
        self.stats: Dict[str, Any] = dict(self._ZERO_STATS)

    @property
    def quantized(self) -> Optional[str]:
        """Leaf storage dtype when serving a quantized forest, else None."""
        if getattr(self.packed, "leaf_scale", None) is None:
            return None
        return dtype_name(self.packed.leaf)

    @property
    def explain_packed(self):
        """The float32 forest that predicts as the served one does: the
        dequantized twin of a quantized forest, else the forest itself."""
        if self._explain_packed is None:
            self._explain_packed = (Q.dequantize_forest(self.packed)
                                    if self.quantized is not None
                                    else self.packed)
        return self._explain_packed

    @property
    def signature(self) -> Tuple:
        """Shape signature of this server's traversals (the reference's,
        with the device type in place of its kernel mode)."""
        pf = self.packed
        return (pf.n_trees, pf.n_nodes, pf.leaf_width, pf.n_outputs,
                int(pf.depth), dtype_name(pf.leaf), self.device.type)

    def _bucket(self, n: int) -> int:
        bucket, event = self.buckets.bucket_for(n, self.cfg.max_batch)
        if event == "upgrade":
            self.stats["bucket_upgrades"] += 1
        elif event == "evict":
            self.stats["bucket_evictions"] += 1
        return bucket

    @property
    def explainable(self) -> bool:
        """Whether the forest carries per-node covers (format >= 2)."""
        return self.packed.cover is not None

    @property
    def best_iteration(self) -> int:
        """Early-stopped round count used to size the fallback forest."""
        return self.cfg.best_iteration or self.packed.n_rounds

    @property
    def queue_depth(self) -> int:
        """Rows currently admitted and waiting for `drain`."""
        return self._queued_rows

    @classmethod
    def from_checkpoint(cls, root: str, step: Optional[int] = None, *,
                        device=None, **overrides) -> "ForestServer":
        """A server over a `save_forest_checkpoint` directory, on
        ``device``; the checkpoint's metadata supplies the loss (and
        ``best_iteration``) unless overridden."""
        device = resolve_device(device)
        packed, quantizer, meta = load_forest_checkpoint(root, step,
                                                         device=device)
        if "loss" in meta:
            overrides.setdefault("loss", meta["loss"])
        if "best_iteration" in meta:
            overrides.setdefault("best_iteration",
                                 int(meta["best_iteration"]))
        clock = overrides.pop("clock", None)
        bucket_cache = overrides.pop("bucket_cache", None)
        return cls(packed, quantizer, ForestServeConfig(**overrides),
                   clock=clock, bucket_cache=bucket_cache, device=device)

    # -- scoring ------------------------------------------------------------
    def _features(self, X) -> np.ndarray:
        """Request features, validated on the host as (n, m) float32."""
        if self.quantizer is None:
            raise ValueError("server has no quantizer; pass raw bin codes "
                             "via predict_codes or checkpoint the quantizer")
        return validate_features(np.atleast_2d(np.asarray(X, np.float32)),
                                 n_features=self.quantizer.edges.shape[0],
                                 where="request X")

    def _bin(self, X: torch.Tensor) -> torch.Tensor:
        """(n, m) float32 features on the card -> (n, m) uint8 codes."""
        return Q.codes_rows(Q.apply_quantizer(self.quantizer, X))

    def _codes(self, X) -> torch.Tensor:
        return self._bin(torch.as_tensor(self._features(X),
                                         device=self.device))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def predict_codes(self, codes, *, packed=None,
                      prepare=None) -> torch.Tensor:
        """Raw scores for (n, m) uint8 bin codes.  ``packed`` overrides the
        scored forest (the overload fallback passes its prefix).  With
        ``prepare``, ``codes`` are host rows that ``prepare`` turns into
        codes on the card, chunk by chunk (double buffering of raw
        features; ``prepare``'s time then counts in ``predict_time_s``)."""
        pf = self.packed if packed is None else packed
        n = codes.shape[0]
        t0 = time.perf_counter()
        if n > self.cfg.max_batch:
            chunk = min(self.cfg.row_chunk, self.cfg.max_batch)
            if self.cfg.double_buffer:
                out = FO.predict_raw_pipelined(pf, codes, row_chunk=chunk,
                                               prepare=prepare)
                self.stats["pipelined_batches"] += 1
            else:
                out = FO.predict_raw(pf, codes.to(self.device),
                                     row_chunk=chunk)
        else:
            bucket = self._bucket(n)
            padded = TF.pad(codes.to(self.device), (0, 0, 0, bucket - n))
            out = FO.predict_raw(pf, padded)[:n]
        self._sync()
        self.stats["rows"] += int(n)
        self.stats["batches"] += 1
        self.stats["predict_time_s"] += time.perf_counter() - t0
        return out

    def _scores(self, X, packed=None) -> torch.Tensor:
        """Raw scores for request features.  A batch that streams with
        double buffering goes to the card as raw features, chunk by chunk,
        each chunk's copy overlapping the binning and traversal of the one
        before it; every other batch is binned on the card at once."""
        X = self._features(X)
        if self.cfg.double_buffer and X.shape[0] > self.cfg.max_batch:
            return self.predict_codes(X, packed=packed, prepare=self._bin)
        return self.predict_codes(
            self._bin(torch.as_tensor(X, device=self.device)), packed=packed)

    def predict_raw(self, X) -> torch.Tensor:
        return self._scores(X)

    def predict(self, X) -> torch.Tensor:
        """Transformed outputs (probabilities for classification losses)."""
        return get_loss(self.cfg.loss).transform(self.predict_raw(X))

    # -- admission control ---------------------------------------------------
    def _fallback_packed(self):
        """Overload forest: the first ``fallback_rounds`` rounds (default
        half of ``best_iteration``), built once."""
        if self._fallback is None:
            rounds = self.cfg.fallback_rounds or max(1,
                                                     self.best_iteration // 2)
            rounds = min(rounds, self.packed.n_rounds)
            self._fallback = FO.slice_rounds(self.packed, rounds)
        return self._fallback

    def submit(self, X, deadline_ms: Optional[float] = None) -> bool:
        """Admit one row-block request, or shed it (returns False) when the
        queue bound would be exceeded.  The deadline (this request's, else
        ``cfg.deadline_ms``, else none) is stamped on the injected clock."""
        block = np.atleast_2d(np.asarray(X, np.float32))
        rows = block.shape[0]
        cap = self.cfg.max_queue_rows
        if cap and self._queued_rows + rows > cap:
            self.stats["shed_requests"] += 1
            self.stats["shed_rows"] += rows
            return False
        dl = self.cfg.deadline_ms if deadline_ms is None else deadline_ms
        deadline = None if not dl else self._now() + dl / 1e3
        self._queue.append((deadline, block))
        self._queued_rows += rows
        return True

    def drain(self) -> List[Optional[np.ndarray]]:
        """Score everything admitted since the last drain, one result per
        `submit` in order: ``None`` for a request whose deadline expired in
        the queue; batches past ``overload_rows`` score on the fallback
        forest.  A scoring failure counts in ``errors`` and re-raises."""
        queue, self._queue = self._queue, []
        self._queued_rows = 0
        if not queue:
            return []
        now = self._now()
        results: List[Optional[np.ndarray]] = [None] * len(queue)
        live: List[int] = []
        for i, (deadline, block) in enumerate(queue):
            if deadline is not None and now > deadline:
                self.stats["deadline_requests"] += 1
                self.stats["deadline_rows"] += block.shape[0]
            else:
                live.append(i)
        if not live:
            return results
        batch, sizes = self._concat_requests([queue[i][1] for i in live])
        fallback = bool(self.cfg.overload_rows
                        and batch.shape[0] > self.cfg.overload_rows)
        packed = self._fallback_packed() if fallback else None
        try:
            out = get_loss(self.cfg.loss).transform(
                self._scores(batch, packed))
        except Exception:
            self.stats["errors"] += 1
            raise
        if fallback:
            self.stats["fallback_batches"] += 1
            self.stats["fallback_rows"] += batch.shape[0]
        self.stats["requests"] += len(live)
        for i, part in zip(live, _split(out, sizes)):
            results[i] = part
        return results

    def serve(self, requests: Sequence) -> List[Optional[np.ndarray]]:
        """Micro-batch row-block requests through ONE forest pass and split
        the results back per request (numpy arrays).  With admission knobs
        set, each request goes through `submit`/`drain`: shed or
        deadline-dropped requests come back as ``None``."""
        if not requests:
            return []
        cfg = self.cfg
        if not (cfg.max_queue_rows or cfg.deadline_ms or cfg.overload_rows):
            batch, sizes = self._concat_requests(requests)
            out = self.predict(batch)
            self.stats["requests"] += len(requests)
            return _split(out, sizes)
        admitted = [i for i, r in enumerate(requests) if self.submit(r)]
        drained = self.drain()
        results: List[Optional[np.ndarray]] = [None] * len(requests)
        for i, out in zip(admitted, drained):
            results[i] = out
        return results

    # -- explanation serving --------------------------------------------------
    def explain(self, X, *, algorithm: str = "path_dependent",
                background=None) -> Tuple[np.ndarray, np.ndarray]:
        """Micro-batched SHAP endpoint: ``(phi (n, m, d), base_values (d,))``
        as numpy arrays.

        The batch and chunk policy of `predict_codes`: requests up to
        ``max_batch`` pad to their power-of-two bucket, larger inputs run
        in ``min(row_chunk, max_batch)``-row chunks.  SHAP runs on the
        float32 twin of the served forest, so local accuracy holds against
        what `predict` returns; its path pack is built once per server.
        """
        if algorithm == "path_dependent" and not self.explainable:
            raise RuntimeError(
                "this checkpoint has no cover tensor (format_version 1): "
                "path-dependent SHAP is disabled; re-checkpoint the model "
                "or pass algorithm='interventional' with a background set")
        codes = self._codes(X)
        bg = None if background is None else self._codes(background)
        epf = self.explain_packed
        if self._path_pack is None:
            self._path_pack = EX.build_path_pack(
                epf, need_cover=(epf.cover is not None))
        n = codes.shape[0]
        t0 = time.perf_counter()
        if n > self.cfg.max_batch:
            phi, base = EX.shap_values(
                epf, codes, algorithm=algorithm, background=bg,
                row_chunk=min(self.cfg.row_chunk, self.cfg.max_batch),
                pack=self._path_pack)
        else:
            bucket = self._bucket(n)
            padded = TF.pad(codes, (0, 0, 0, bucket - n))
            phi, base = EX.shap_values(epf, padded, algorithm=algorithm,
                                       background=bg, pack=self._path_pack)
            phi = phi[:n]
        self._sync()
        self.stats["explain_rows"] += int(n)
        self.stats["explain_time_s"] += time.perf_counter() - t0
        return phi.cpu().numpy(), base.cpu().numpy()

    def serve_explain(self, requests: Sequence, *,
                      algorithm: str = "path_dependent", background=None
                      ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Micro-batch explanation requests through ONE SHAP pass; one
        ``(phi_i, base_values)`` pair per request (base is shared)."""
        if not requests:
            return []
        batch, sizes = self._concat_requests(requests)
        phi, base = self.explain(batch, algorithm=algorithm,
                                 background=background)
        self.stats["explain_requests"] += len(requests)
        offsets = np.cumsum([0] + list(sizes))
        return [(phi[a:b], base) for a, b in zip(offsets[:-1], offsets[1:])]

    def feature_importances(self, kind: str = "gain") -> Optional[np.ndarray]:
        """Importances from the checkpoint alone; ``None`` when the forest
        has no covers (format_version 1)."""
        if not self.explainable:
            return None
        m = (None if self.quantizer is None
             else self.quantizer.edges.shape[0])
        return EX.feature_importances(self.explain_packed, kind=kind,
                                      n_features=m).cpu().numpy()

    def throughput(self) -> float:
        """Rows/sec over everything served so far."""
        t = self.stats["predict_time_s"]
        return self.stats["rows"] / t if t > 0 else 0.0

    def reset_stats(self) -> None:
        """Zero the counters (e.g. after a warm-up pass)."""
        self.stats = dict(self._ZERO_STATS)


def _split(out: torch.Tensor, sizes: Sequence[int]) -> List[np.ndarray]:
    """One host copy of the batch's results, cut back into requests."""
    host = out.cpu().numpy()
    offsets = np.cumsum([0] + list(sizes))
    return [host[a:b] for a, b in zip(offsets[:-1], offsets[1:])]


class ModelRegistry:
    """Serve many checkpointed forests from one process, behind one SHARED
    `BucketCache`; routing is by model name, admission control stays per
    server.

    >>> reg = ModelRegistry(max_buckets=4)
    >>> reg.load("otto", "/ckpts/otto")
    >>> reg.load("otto_int8", "/ckpts/otto", quantize="int8",
    ...          prune_alpha=0.0)
    >>> proba = reg.predict("otto_int8", X)
    >>> reg.shared_signatures()          # models with equal shapes
    """

    def __init__(self, *, max_buckets: int = 0,
                 bucket_cache: Optional[BucketCache] = None, clock=None,
                 device=None):
        self.bucket_cache = (bucket_cache if bucket_cache is not None
                             else BucketCache(max_buckets))
        self._clock = clock
        self.device = resolve_device(device)
        self._servers: Dict[str, ForestServer] = {}

    # -- membership ---------------------------------------------------------
    def register(self, name: str, server: ForestServer) -> ForestServer:
        """Add an existing server under ``name`` (its buckets then come
        from the registry's shared cache)."""
        server.buckets = self.bucket_cache
        self._servers[name] = server
        return server

    def load(self, name: str, root: str, step: Optional[int] = None,
             **overrides) -> ForestServer:
        """`ForestServer.from_checkpoint` on the registry's device +
        register; the overrides take every `ForestServeConfig` knob."""
        server = ForestServer.from_checkpoint(
            root, step, clock=self._clock, bucket_cache=self.bucket_cache,
            device=self.device, **overrides)
        self._servers[name] = server
        return server

    def unregister(self, name: str) -> None:
        del self._servers[name]

    def get(self, name: str) -> ForestServer:
        try:
            return self._servers[name]
        except KeyError:
            raise KeyError(
                f"no model {name!r} in registry (have: "
                f"{sorted(self._servers)})") from None

    def names(self) -> List[str]:
        return sorted(self._servers)

    def __contains__(self, name: str) -> bool:
        return name in self._servers

    def __len__(self) -> int:
        return len(self._servers)

    # -- routing ------------------------------------------------------------
    def predict(self, name: str, X) -> torch.Tensor:
        return self.get(name).predict(X)

    def predict_raw(self, name: str, X) -> torch.Tensor:
        return self.get(name).predict_raw(X)

    def serve(self, name: str, requests: Sequence):
        return self.get(name).serve(requests)

    def explain(self, name: str, X, **kw):
        return self.get(name).explain(X, **kw)

    # -- introspection ------------------------------------------------------
    def signatures(self) -> Dict[str, Tuple]:
        return {name: srv.signature for name, srv in self._servers.items()}

    def shared_signatures(self) -> Dict[Tuple, List[str]]:
        """Shape signature -> model names with that signature."""
        groups: Dict[Tuple, List[str]] = {}
        for name in sorted(self._servers):
            groups.setdefault(self._servers[name].signature, []).append(name)
        return groups

    def stats(self) -> Dict[str, Any]:
        """Shared bucket-cache counters + per-model stats and compression
        records."""
        return {
            "bucket_cache": self.bucket_cache.stats(),
            "models": {name: {"stats": dict(srv.stats),
                              "compression": dict(srv.compression),
                              "signature": list(srv.signature)}
                       for name, srv in self._servers.items()}}
