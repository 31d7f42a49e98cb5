"""Roofline analysis of the port's steps, counted on the H100's constants.

The three roofline terms, as in the JAX package's ``roofline/analysis.py``:

  compute term    = flops            / (chips * PEAK_FLOPS)
  memory term     = hbm_bytes        / (chips * HBM_BW)
  collective term = collective_bytes / (chips * link_bw(chips))

The reference reads FLOPs and bytes from XLA's ``cost_analysis`` and parses
the compiled HLO for its collectives.  The port has no compiler artefact,
so it counts its own eager step instead: `Counter` is a
``TorchDispatchMode`` that sees every aten op the step runs (on real
tensors, or on fake ones at the global shapes of a dry-run cell, with no
storage) and adds

  * FLOPs as ``torch.utils.flop_counter`` counts them (matrix products,
    convolutions, attention; elementwise ops count none);
  * bytes as each op's inputs plus its outputs: the port runs eagerly, so
    nothing is fused and every op reads and writes memory.  Views count
    nothing; an input counts the elements it addresses (a broadcast
    dimension once); gathers, embedding lookups, advanced indexing,
    scatters and in-place writes into a slot count only the index and the
    elements they read or write, never the whole source tensor.

A hand-written kernel's call is counted once, by its own formula
(`kernels.work`): its wrapper suspends the op-by-op count for its body, so
the count is the same whether it launches the kernel or runs the plain
version.  Collective bytes come from the partition specs by a closed form
(`lm_collectives`; the GBDT cell's from
`core.distributed.round_collective_bytes`).

``lax.scan`` bodies are counted once by ``cost_analysis``, so the reference
probes each cell at two reduced unrolled depths and extrapolates
(`extrapolate`); the port's eager count has no scan, and the dry run keeps
the same two probes so the two packages' tables read alike.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import work
from repro_torch.models import ssm

# --- H100 SXM5 constants (per GPU) -------------------------------------------
PEAK_FLOPS = 989e12          # H100 SXM5 datasheet: bf16 dense tensor cores
HBM_BW = 3.35e12             # H100 SXM5 datasheet: HBM3, bytes/s
NVLINK_BW = 450e9            # H100 SXM5 datasheet: NVLink 4, 900 GB/s a GPU
                             # both ways; bytes/s a GPU a direction, within
                             # a node of 8 GPUs
NET_BW = 50e9                # DGX H100 datasheet: one 400 Gb/s ConnectX-7
                             # port a GPU; bytes/s a GPU a direction, across
                             # nodes
GPUS_PER_NODE = 8            # DGX H100 / HGX H100: 8 GPUs on one NVLink


def link_bw(chips: int) -> float:
    """The collective term's link rate for a mesh of ``chips`` GPUs:
    NVLink when the mesh fits in one node, else the network.  Every axis
    of the 256- and 512-rank production meshes (16 x 16, 2 x 16 x 16)
    spans more than one node of 8 GPUs, so each collective of their steps
    crosses the network: NET_BW."""
    return NVLINK_BW if chips <= GPUS_PER_NODE else NET_BW


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_op: Dict[str, int]
    count_by_op: Dict[str, int]

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_op.values())


# ---------------------------------------------------------------------------
# Terms
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RooflineTerms:
    flops: float                 # total FLOPs for the step (all chips)
    hbm_bytes: float             # total bytes moved (all chips)
    collective_bytes: float      # total bytes the ranks send (all chips)
    chips: int
    model_flops: float = 0.0     # 6*N*D analytic useful FLOPs

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / (self.chips * link_bw(self.chips))

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Roofline lower bound on step time: max of the three terms (perfect
        overlap assumption)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_fraction(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of peak at the roofline bound: useful FLOPs per second at
        t_bound over peak FLOPs (the MFU the roofline permits)."""
        if self.t_bound == 0:
            return 0.0
        return (self.model_flops / self.t_bound) / (self.chips * PEAK_FLOPS)

    def to_dict(self) -> Dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes, "chips": self.chips,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck, "t_bound_s": self.t_bound,
            "useful_fraction": self.useful_fraction,
            "roofline_fraction": self.roofline_fraction,
        }


def extrapolate(v1: float, v2: float, l1: int, l2: int, l_full: int) -> float:
    """Two-point linear depth extrapolation: per-layer slope + intercept."""
    if l2 == l1:
        return v2
    slope = (v2 - v1) / (l2 - l1)
    intercept = v1 - slope * l1
    return max(intercept + slope * l_full, 0.0)


def model_flops_train(n_params: int, tokens: int) -> float:
    """6*N*D: fwd 2ND + bwd 4ND."""
    return 6.0 * n_params * tokens


def model_flops_decode(n_params: int, tokens: int) -> float:
    """Decode forward only: 2*N per token."""
    return 2.0 * n_params * tokens


def format_table(rows: List[Dict], keys: List[str]) -> str:
    widths = {k: max(len(k), *(len(str(r.get(k, ""))) for r in rows))
              for k in keys}
    line = " | ".join(k.ljust(widths[k]) for k in keys)
    sep = "-+-".join("-" * widths[k] for k in keys)
    body = "\n".join(" | ".join(str(r.get(k, "")).ljust(widths[k])
                                for k in keys) for r in rows)
    return f"{line}\n{sep}\n{body}"


# ---------------------------------------------------------------------------
# The counter
# ---------------------------------------------------------------------------

aten = torch.ops.aten

# Ops that move no data: views the schema does not mark as such,
# allocation without a write, metadata reads.
_NO_BYTES = {aten._unsafe_view, aten.lift_fresh, aten.empty,
             aten.empty_like, aten.empty_strided,
             aten.new_empty, aten.new_empty_strided, aten.sym_size,
             aten.sym_stride, aten.sym_numel, aten.sym_storage_offset,
             aten._local_scalar_dense, aten.is_same_size, aten.resize_,
             aten.set_, aten.record_stream}
# In-place ops that overwrite their first argument without reading it.
_OVERWRITE = {aten.fill_, aten.zero_, aten.copy_, aten.uniform_,
              aten.normal_, aten.random_, aten.exponential_,
              aten.bernoulli_, aten.geometric_, aten.cauchy_,
              aten.log_normal_}
# Gathers: the index read, the elements gathered read and written out.
_GATHER = {aten.index: 1, aten.gather: 2, aten.index_select: 2,
           aten.embedding: 1, aten.take: 1}


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in _tensors(item)]
    if isinstance(x, dict):
        return [t for item in x.values() for t in _tensors(item)]
    return []


def addressed_bytes(t: torch.Tensor) -> int:
    """The bytes an op reading ``t`` must touch: its elements, a broadcast
    (stride 0) dimension once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size() if t.numel() else 0


def _out_bytes(out) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(out))


def _mask_count(m: torch.Tensor) -> int:
    """True entries of a boolean index: read from a real tensor, all of
    them for a fake one (its data is unknown)."""
    try:
        return int(m.sum())
    except Exception:                      # fake tensor: no data
        return m.numel()


def _index_put_bytes(args) -> int:
    """``self[indices] = values`` (or ``+=`` with accumulate): the indices
    and values read, and the slots written (read too when accumulating)."""
    self, indices, values = args[0], args[1], args[2]
    accumulate = len(args) > 3 and bool(args[3])
    n_slots, shape, pos = 1, (), 0
    for i in indices:
        if i is None:                      # a full slice of this dimension
            n_slots *= self.shape[pos]
            pos += 1
        elif i.dtype in (torch.bool, torch.uint8):
            n_slots *= _mask_count(i)
            pos += i.dim()
        else:
            shape = torch.broadcast_shapes(shape, tuple(i.shape))
            pos += 1
    n_slots *= math.prod(shape) * math.prod(self.shape[pos:])
    idx = sum(addressed_bytes(i) for i in indices if i is not None)
    slot = self.element_size() * n_slots
    return idx + addressed_bytes(values) + slot * (2 if accumulate else 1)


def _scatter_bytes(func, args) -> int:
    """In-place scatters: the index and the source read, the slots they
    name written (and read for the reducing ones)."""
    self = args[0]
    if func in (aten.index_add_, aten.index_copy_):
        index, source = args[2], args[3]
        slots = source.numel()
        src = addressed_bytes(source)
    elif func is aten.index_fill_:
        index = args[2]
        slots = index.numel() * (self.numel() // max(self.shape[args[1]], 1)
                                 if self.dim() else 1)
        src = 0
    else:                                  # scatter_, scatter_add_, _reduce_
        index = args[2]
        slots = index.numel()
        src = (addressed_bytes(args[3]) if len(args) > 3
               and isinstance(args[3], torch.Tensor) else 0)
    rmw = func in (aten.index_add_, aten.scatter_add_, aten.scatter_reduce_)
    return (addressed_bytes(index) + src
            + self.element_size() * slots * (2 if rmw else 1))


_SCATTER = {aten.index_add_, aten.index_copy_, aten.index_fill_,
            aten.scatter_, aten.scatter_add_, aten.scatter_reduce_}
_INDEX_PUT = {aten.index_put_, aten._index_put_impl_}


def op_flops(func, args, kwargs, out) -> int:
    """FLOPs of one aten op as ``FlopCounterMode`` counts them."""
    f = flop_registry.get(func.overloadpacket)
    return int(f(*args, **kwargs, out_val=out)) if f is not None else 0


def op_bytes(func, args, kwargs, out) -> int:
    """Bytes one aten op moves (see the module's rules); an op that gives
    no tensor (a metadata query) moves none."""
    packet = func.overloadpacket
    if func.is_view or packet in _NO_BYTES or not _tensors(out):
        return 0
    if packet in _GATHER:
        index = args[_GATHER[packet]]
        idx = sum(addressed_bytes(i) for i in _tensors(index))
        return idx + 2 * _out_bytes(out)
    if packet in _INDEX_PUT:
        return _index_put_bytes(args)
    if packet in _SCATTER:
        return _scatter_bytes(packet, args)
    ins = _tensors(args) + _tensors(kwargs)
    if packet in _OVERWRITE:
        ins = ins[1:]
    return sum(addressed_bytes(t) for t in ins) + _out_bytes(out)


class Counter(TorchDispatchMode):
    """Counts the FLOPs and bytes of every aten op run under it (see the
    module's rules), and each hand-written kernel's call by its formula
    (`kernels.work`), adding the formula's ``flops`` (the count its bound
    in the kernel table reads): ``kernels`` maps a kernel's name to its
    calls, flops, useful and design flops, and bytes.  Works on real tensors on either device
    and on fake ones (under ``FakeTensorMode``, entered before it)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.hbm_bytes = 0
        self.suspended = 0
        self.kernels: Dict[str, Dict[str, float]] = {}

    def __enter__(self):
        work.push(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            work.pop(self)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "aten" and \
                torch._C._dispatch_has_kernel_for_dispatch_key(
                    func.name(),
                    torch._C.DispatchKey.CompositeImplicitAutograd):
            # Under inference mode a composite op (matmul, to, einsum)
            # arrives whole: count the ops it is made of.
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if not self.suspended:
            self.flops += op_flops(func, args, kwargs, out)
            self.hbm_bytes += op_bytes(func, args, kwargs, out)
        return out

    def add_kernel(self, name: str, *, flops: float, bytes: float,
                   useful_flops: float, design_flops: float,
                   **extra) -> None:
        self.flops += flops
        self.hbm_bytes += bytes
        k = self.kernels.setdefault(name, dict(
            calls=0, flops=0.0, useful_flops=0.0, design_flops=0.0,
            bytes=0.0))
        k["calls"] += 1
        k["flops"] += flops
        k["useful_flops"] += useful_flops
        k["design_flops"] += design_flops
        k["bytes"] += bytes

    def terms(self, chips: int = 1, collective_bytes: float = 0.0,
              model_flops: float = 0.0) -> RooflineTerms:
        return RooflineTerms(flops=float(self.flops),
                             hbm_bytes=float(self.hbm_bytes),
                             collective_bytes=collective_bytes, chips=chips,
                             model_flops=model_flops)


# ---------------------------------------------------------------------------
# Collective bytes by closed form
# ---------------------------------------------------------------------------

def _spec_axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _ring(op: str, n: int, payload: float) -> float:
    """Bytes one rank sends for ``op`` over ``n`` ranks by a ring:
    all-gather of a ``payload``-byte shard (n - 1) x; reduce-scatter and
    all-to-all of a ``payload``-byte buffer (n - 1) / n x; all-reduce
    2 (n - 1) / n x."""
    if n <= 1:
        return 0.0
    if op == "all-gather":
        return (n - 1) * payload
    if op == "all-reduce":
        return 2 * (n - 1) / n * payload
    return (n - 1) / n * payload


def counted_collectives(by_op, calls, sizes: Dict[str, int]
                        ) -> CollectiveStats:
    """A run's counted collectives (`launch.mesh.Mesh`'s ``by_op`` and
    ``calls``, keyed ``(op, axis, tag)``, payload bytes) as the bytes each
    rank sends by a ring (`_ring`) and the calls, by op: what
    `lm_collectives` reckons for a step."""
    out: Dict[str, float] = {}
    count: Dict[str, int] = {}
    for (op, axis, _), payload in by_op.items():
        out[op] = out.get(op, 0.0) + _ring(op, sizes[axis], payload)
    for (op, axis, _), n in calls.items():
        if sizes[axis] > 1:
            count[op] = count.get(op, 0) + n
    return CollectiveStats({k: int(v) for k, v in out.items()}, count)


def lm_collectives(cfg, kind: str, seq_len: int, global_batch: int,
                   mesh) -> CollectiveStats:
    """One step's collectives on ``mesh``, per rank: bytes each rank sends
    (ring algorithms, the link's one direction) and the count, by op, as
    the port's step on a mesh of ranks runs them (`training.train_lib`,
    `models.lm.lm_loss` with an `AxisCtx`).  Every collective is over one
    axis; a tuple of axes is one call an axis, the inner axis first.

    For ``kind`` "train", each of ``cfg.microbatches`` microbatches of the
    rank's ``b/dp`` rows (the batch whole where it does not divide,
    long_500k) gathers and scatters:
      * the all-gather of each parameter over the FSDP axes that split it:
        once (the gathered weights serve the backward), and once more for
        a layer's under remat, whose recomputed forward gathers again; the
        embedding not at all where nothing reads it (an untied model fed
        embeddings);
      * the reduce-scatter of each gathered gradient over those axes;
      * under tensor parallelism over ``model``, for each layer whose
        heads, ``d_ff`` or ``d_inner`` are split: the row-parallel sum of
        its output activations (forward, and again under remat but for
        the sum that ends the block: the recomputed forward stops at the
        last tensor the backward reads) and the sum of its input's
        gradient (backward); an SSM block's gated-norm
        squares (float32, one a token) forward and backward, and its
        replicated leaves' gradients; the MoE gate values' gradients
        (float32, ``top_k`` a token); experts split over ``model``: two
        all-to-alls of the (tp, G, E/tp, C, D) slot buffers in each pass
        and the all-gather of the combined tokens (forward); kv
        weights split over ``model`` but not by whole heads: their
        all-gather over it (forward, remat) and reduce-scatter;
      * the vocabulary split over ``model``: the lookup's sum (forward),
        the head input's gradient (backward) and the log-softmax's max, sum
        of exponentials and label logit (float32, one a token);
      * the loss weights' sum, one float32 a batch axis.
    Once a step: each gradient's all-reduce over the batch axes that do
    not split its parameter (float32 with microbatches), the loss (one
    float32 a batch axis) and the global norm (one float32 an axis of
    each set of axes that splits leaves).  Adafactor's row, column and
    RMS sums are not counted.
    "prefill" and "decode" count a forward's gathers and sums: every
    token of the sequence, or one a sequence."""
    from repro_torch.models import lm
    from repro_torch.models.params import (decl_dtype, mesh_axes,
                                           partition_spec, shard_shape)
    from repro_torch.training import train_lib

    sizes = mesh_axes(mesh)
    rules = lm.sharding_rules(cfg, mesh)
    ctx = train_lib.make_axis_ctx(mesh, cfg)
    fsdp = set(_spec_axes(rules.get("fsdp")))
    batch_axes = [a for a in ctx.batch_axes if sizes[a] > 1]
    n_rows = math.prod(sizes[a] for a in ctx.batch_axes)
    b_local = (global_batch // n_rows if global_batch % n_rows == 0
               else global_batch)
    train = kind == "train"
    mb = max(cfg.microbatches, 1) if train else 1
    remat = train and cfg.remat
    # A microbatch's share of the rank's tokens (a fraction of a row where
    # the rank's rows do not split into the microbatches: llama3-405b's 8
    # rows a rank into 16 on the 2 x 16 x 16 mesh, which the port's step
    # refuses and the reference spreads over the data ranks).
    tokens = b_local * (1 if kind == "decode" else seq_len) / mb
    dtype = lm.model_dtype(cfg)
    esize = torch.empty((), dtype=dtype).element_size()
    act = tokens * cfg.d_model * esize
    model_ax = ctx.model_axis
    tp = sizes[model_ax] if model_ax is not None else 1
    by_op: Dict[str, float] = {}
    count: Dict[str, int] = {}

    def add(op: str, n_ranks: int, payload: float, times: int) -> None:
        if n_ranks <= 1 or times <= 0 or payload <= 0:
            return
        by_op[op] = by_op.get(op, 0.0) + times * _ring(op, n_ranks, payload)
        count[op] = count.get(op, 0) + times

    def walk(tree, path):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from walk(tree[k], path + (k,))
        else:
            yield path, tree

    def n_uses(path) -> int:
        """Calls of the layer that reads leaf ``path``: each layer's own,
        each cross site's own, the shared block at every site."""
        return (cfg.n_layers if path[0] == "blocks" else lm.n_sites(cfg)
                if path[0] in ("cross", "shared_attn") else 1)

    # Per leaf: gathers, scatters, gradient all-reduces.
    norm_sets = set()
    for path, d in walk(lm.param_decls(cfg), ()):
        if path == ("embed",) and cfg.embed_inputs and \
                not cfg.tie_embeddings:
            continue
        spec = partition_spec(d, mesh, rules)
        shape = list(shard_shape(d.shape, spec, mesh))
        stacked = path[0] in ("blocks", "cross")
        uses = n_uses(path)
        leaves = uses if stacked else 1      # the shared block: one leaf
        if stacked:
            shape = shape[1:]
        el = torch.empty((), dtype=decl_dtype(d, dtype)).element_size()
        nbytes = math.prod(shape) * el
        entries = spec[1:] if stacked else spec
        used = {a for e in spec for a in _spec_axes(e)}
        split = tuple(a for a in used if sizes[a] > 1)
        if split:
            norm_sets.add(frozenset(split))
        gathered = nbytes
        calls = 1 if kind != "train" else mb * (
            1 + int(remat and path[0] == "blocks"))
        for e in entries:
            for a in reversed(_spec_axes(e)):
                if a in fsdp and sizes[a] > 1:
                    add("all-gather", sizes[a], gathered, leaves * calls)
                    if train:
                        add("reduce-scatter", sizes[a],
                            gathered * sizes[a], leaves * mb)
                    gathered *= sizes[a]
        if train:
            grad_el = 4 if mb > 1 else el
            for a in batch_axes:
                if a not in used:
                    add("all-reduce", sizes[a],
                        math.prod(shape) * grad_el, leaves)
        # A leaf replicated over ``model`` inside split work: its
        # gradient summed over the axis (backward).
        if train and tp > 1 and _model_summed(cfg, path, tp):
            add("all-reduce", tp, gathered, uses * mb)
        # kv weights split over ``model`` but not by whole heads.
        if tp > 1 and path[-1] in ("wk", "wv") and \
                cfg.n_kv_heads % tp and model_ax in used:
            add("all-gather", tp, gathered, uses * calls)
            if train:
                add("reduce-scatter", tp, gathered * tp, uses * mb)
    if train:
        for a in batch_axes:                 # the loss: den, then metric
            add("all-reduce", sizes[a], 4, mb + 1)
        for key in norm_sets:
            for a in key:
                add("all-reduce", sizes[a], 4, 1)

    # Activations under tensor parallelism.  A remat'd layer's recomputed
    # forward stops at the last tensor its backward reads, so the sum that
    # ends the layer (``last``) runs once.
    if tp > 1:
        fwd = 1 if kind != "train" else mb * (1 + int(remat))
        last = 1 if kind != "train" else mb
        bwd = mb if train else 0
        hd = cfg.head_dim_
        attn_split = (cfg.n_heads * hd) % tp == 0

        def dense_pair(split: bool, n: int, f_times: int,
                       b_times: int) -> None:
            if split:
                add("all-reduce", tp, act, n * f_times)
                add("all-reduce", tp, act, n * b_times)

        n_attn_layers = 0 if lm._is_ssm(cfg) else cfg.n_layers
        dense_pair(attn_split, n_attn_layers, fwd, bwd)
        if cfg.family == "hybrid" and cfg.attn_every:
            sites = lm.n_sites(cfg)
            once = 1 if kind != "train" else mb
            dense_pair(attn_split, sites, once, bwd)
            dense_pair((cfg.d_ff or 4 * cfg.d_model) % tp == 0, sites,
                       once, bwd)
        if cfg.family == "vlm" and cfg.cross_attn_every:
            once = 1 if kind != "train" else mb
            dense_pair(attn_split, lm.n_sites(cfg), once, bwd)
        if lm._is_ssm(cfg) and cfg.d_inner % tp == 0:
            dense_pair(True, cfg.n_layers, last, bwd)
            add("all-reduce", tp, tokens * 4, cfg.n_layers * (fwd + bwd))
        if not lm._is_ssm(cfg) and not cfg.n_experts:
            dense_pair(cfg.d_ff % tp == 0, cfg.n_layers, last, bwd)
        if cfg.n_experts:
            L, E, k = cfg.n_layers, cfg.n_experts, cfg.top_k
            gate = tokens * k * 4
            if cfg.moe_shard == "ep" and E % tp == 0:
                t = max(int(tokens), 1)
                g = min(cfg.router_group, t)
                while t % g:
                    g //= 2
                cap = max(int(cfg.capacity_factor * g * k / E), 1)
                slots = (t // g) * E * cap * cfg.d_model * esize
                add("all-to-all", tp, slots, 2 * L * (fwd + bwd))
                add("all-gather", tp, act // tp, L * last)
                add("all-reduce", tp, act, L * bwd)
                add("all-reduce", tp, gate, L * bwd)
            elif cfg.moe_shard != "ep" and cfg.d_ff % tp == 0:
                dense_pair(True, L, last, bwd)
                add("all-reduce", tp, gate, L * bwd)
        if cfg.padded_vocab % tp == 0:
            once = 1 if kind != "train" else mb
            if not cfg.embed_inputs:
                add("all-reduce", tp, act, once)
            if train:
                add("all-reduce", tp, act, mb)
                add("all-reduce", tp, tokens * 4, 3 * mb)
    return CollectiveStats({k: int(v) for k, v in by_op.items()}, count)


def _model_summed(cfg, path, tp: int) -> bool:
    """Whether the step sums leaf ``path``'s gradient over ``model``: an
    SSM block's replicated leaves when ``d_inner`` is split, kv weights
    replicated where heads are split."""
    if path[-1] in ssm.REPLICATED and "ssm" in path:
        return cfg.d_inner % tp == 0
    if path[-1] in ("wk", "wv"):
        return ((cfg.n_heads * cfg.head_dim_) % tp == 0
                and (cfg.n_kv_heads * cfg.head_dim_) % tp != 0)
    return False


def gbdt_collectives(cfg, m: int, d: int, mesh,
                     row_axes=("data",)) -> CollectiveStats:
    """One round's histogram all-reduce over ``row_axes``, per rank:
    `core.distributed.round_collective_bytes`'s payload (what the
    configured sketch, or its compressor, all-reduces), sent by a ring,
    one all-reduce a level (a leaf-wise tree's root and expansions)."""
    from repro_torch.core import distributed as GD
    from repro_torch.models.params import mesh_axes
    sizes = mesh_axes(mesh)
    n = math.prod(sizes[a] for a in row_axes)
    payload = GD.round_collective_bytes(cfg, m, d)["moved_bytes"]
    steps = cfg.max_leaves if cfg.growth == "leafwise" else cfg.depth
    if n <= 1:
        return CollectiveStats({}, {})
    return CollectiveStats({"all-reduce": int(_ring("all-reduce", n,
                                                     payload))},
                           {"all-reduce": steps})
