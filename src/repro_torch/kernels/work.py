"""The work of each hand-written kernel, by formula, and the hook through
which a counter reads it.

Each function below gives one kernel call's floating-point operations and
the bytes it must move (each input read once, each output written once),
from its arguments alone, counting what this call's data needs where the
work depends on the data.  They are the bounds of the kernel table:
``chip_smoke.py`` phase 3 divides them by the card's rates, and the
roofline counter (`roofline.analysis.Counter`) adds them for each call.

``flops`` is the count the bound reads, the one the counter adds to a
step: the function's own work, except that B7's bf16 body cannot do with
less than 8 dh a seen pair (its float32 P goes through PV as three exact
bf16 parts).  ``useful_flops`` beside it is what the function needs (B7
4 dh a pair), and ``design_flops`` what the design computes (B7's
backward 13 products a pair on the tensor cores, P and dS in three bf16
parts and S and dP again for dQ; 7 on the CUDA cores; where they match,
``flops``).

`kernel` is the hook: each wrapper runs its kernel, or its plain version,
inside ``with work.kernel(name, lambda: <formula>, *inputs):``.  With no
counter active it does nothing.  With one, it adds the formula's work to
the counter and suspends the counter's own op-by-op count for the body, so
a call is counted once, by its formula, whether it goes to the kernel or
to the plain version; on fake tensors (the dry run) the wrapper returns
outputs of the right shape without running the body.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

# The active counters, innermost last.  The wrappers are reached through the
# model and growers' code, which passes no counter down, so a counter
# registers itself here while it is entered (as a dispatch mode sits on
# torch's mode stack).
_COUNTERS: List = []


def push(counter) -> None:
    _COUNTERS.append(counter)


def pop(counter) -> None:
    _COUNTERS.remove(counter)


@contextlib.contextmanager
def suspended():
    """Every active counter's op-by-op count off for the body."""
    live = list(_COUNTERS)
    for c in live:
        c.suspended += 1
    try:
        yield
    finally:
        for c in live:
            c.suspended -= 1


@contextlib.contextmanager
def kernel(name: str, work: Callable[[], Dict[str, float]], *inputs):
    """Count one call of kernel ``name`` as ``work()`` (a formula below) in
    every active counter, and nothing of what the body runs.  Yields True
    when the body need not run: a counter is active and every one of
    ``inputs`` is a fake tensor (a dry run at shapes alone), so only the
    output's shape matters."""
    live = [c for c in _COUNTERS if not c.suspended]
    if not live:
        yield False
        return
    with suspended():
        w = work()
        for c in live:
            c.add_kernel(name, **w)
        yield _all_fake(inputs)


def _all_fake(inputs) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return bool(inputs) and all(isinstance(t, FakeTensor) for t in inputs)


def _work(flops: float, n_bytes: float, useful: Optional[float] = None,
          design: Optional[float] = None, **extra) -> Dict[str, float]:
    return dict(flops=float(flops), bytes=float(n_bytes),
                useful_flops=float(flops if useful is None else useful),
                design_flops=float(flops if design is None else design),
                **extra)


# -- B7 and its backward --------------------------------------------------------

def attention_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """Unmasked (query, key) pairs of one head: query i sees the keys
    before ``sk``, at or before i (``causal``) and less than ``window``
    behind it."""
    qpos = np.arange(sq, dtype=np.int64)
    hi = np.minimum(qpos + 1, sk) if causal else np.full(sq, sk)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def flash_fwd(b: int, hq: int, hkv: int, sq: int, sk: int, dh: int,
              causal: bool, window, itemsize: int,
              lse: bool = False) -> Dict[str, float]:
    """B7: q and out (b, hq, sq, dh), k and v (b, hkv, sk, dh) of
    ``itemsize`` bytes, and the float32 lse when written.  The bf16 body
    takes 2 dh for QK^T and 3 x 2 dh for PV on three bf16 parts of P a seen
    pair; float32 2 dh each."""
    pairs = attention_pairs(sq, sk, causal, window) * b * hq
    n_bytes = (itemsize * (2 * b * hq * sq * dh + 2 * b * hkv * sk * dh)
               + (4 * b * hq * sq if lse else 0))
    per_pair = 8 * dh if itemsize == 2 else 4 * dh
    return _work(per_pair * pairs, n_bytes, 4 * dh * pairs, pairs=pairs)


def flash_bwd(b: int, hq: int, hkv: int, sq: int, sk: int, dh: int,
              causal: bool, window, itemsize: int) -> Dict[str, float]:
    """B7's backward: q, out, dout and dq (b, hq, sq, dh), k, v, dk and dv
    (b, hkv, sk, dh), and the float32 lse.  The gradient needs 5 products
    of 2 dh a seen pair (S, dP, dV, dK, dQ: ``flops``); the bf16 body with
    dh <= 128 runs 13 on the tensor cores (P and dS in three bf16 parts, S
    and dP again for dQ), the CUDA-core body 7 (``design_flops``)."""
    pairs = attention_pairs(sq, sk, causal, window) * b * hq
    ops = 5 * 2 * dh * pairs
    tensor_cores = itemsize == 2 and dh <= 128
    design = (13 if tensor_cores else 7) * ops // 5
    n_bytes = (itemsize * (4 * b * hq * sq * dh + 4 * b * hkv * sk * dh)
               + 4 * b * hq * sq)
    return _work(ops, n_bytes, design=design, pairs=pairs)


# -- B8 ------------------------------------------------------------------------

def decode(b: int, hq: int, hkv: int, dh: int, seen: int, q_itemsize: int,
           kv_itemsize: int) -> Dict[str, float]:
    """B8: ``seen`` cache slots read in all (the rows' lengths, each cut to
    the window), k and v at ``kv_itemsize``; q read and out written at
    ``q_itemsize``; 4 dh operations a (query head, seen slot)."""
    n_bytes = 2 * kv_itemsize * seen * hkv * dh + 2 * q_itemsize * b * hq * dh
    return _work(4 * dh * hq * seen, n_bytes)


# -- B1, B2, B3 ----------------------------------------------------------------

def hist_nodes(built_rows: int, m: int, n_nodes: int, n_bins: int, c: int,
               stats_itemsize: int) -> Dict[str, float]:
    """B1 (and B1-bf16): each built row's m codes, its int32 entry of
    ``order`` and its C statistics read once, the (n_nodes, m, n_bins, C)
    float32 histograms written once; one add a (row, feature, channel)."""
    n_bytes = (built_rows * (m + 4 + stats_itemsize * c)
               + n_nodes * m * n_bins * c * 4)
    return _work(built_rows * m * c, n_bytes)


def split_scan(nodes: int, used: int, m: int, n_bins: int,
               c: int) -> Dict[str, float]:
    """B2: the histograms of the ``used`` (unmasked) features read once,
    the (m,) mask, one gain and one index a node; 4 C + 12 operations a
    (node, feature, bin)."""
    n_bytes = nodes * used * n_bins * c * 4 + m * 4 + nodes * 8
    return _work(nodes * used * n_bins * (4 * c + 12), n_bytes)


def traverse_touched(codes: torch.Tensor, feat: torch.Tensor,
                     thr: torch.Tensor, left: torch.Tensor,
                     right: torch.Tensor, depth: int):
    """``(nodes, leaves)``: the (tree, node) pairs at which the rows of
    ``codes`` take a step of the walk, whose node arrays are read, and the
    (tree, node) pairs they end at, whose leaf rows are added; each counted
    once."""
    T, N = feat.shape
    read = torch.zeros((T, N), dtype=torch.bool, device=codes.device)
    reached = torch.zeros_like(read)
    for t in range(T):
        f, th = feat[t].long(), thr[t].long()
        lt, rt = left[t].long(), right[t].long()
        pos = torch.zeros(codes.shape[0], dtype=torch.long,
                          device=codes.device)
        for _ in range(depth):
            read[t, pos] = True
            code = codes.gather(1, f[pos][:, None])[:, 0].long()
            pos = torch.where(code > th[pos], rt[pos], lt[pos])
        reached[t, pos] = True
    return int(read.sum()), int(reached.sum())


def traverse(n: int, M: int, T: int, D: int, W: int, leaf_itemsize: int,
             nodes: int, leaves: int) -> Dict[str, float]:
    """B3 (and B5 with int8 or bf16 leaves): F (n, D) read and written, the
    codes, the node arrays of the ``nodes`` touched (int32, or B5's uint8
    thresholds), the leaf rows of the ``leaves`` reached, the columns (and
    B5's float32 scale a tree); 2 operations a (row, tree, column), 3 with
    B5's scale."""
    quant = leaf_itemsize != 4
    node_bytes = 13 if quant else 16
    n_bytes = (8 * n * D + n * M + nodes * node_bytes
               + leaves * W * leaf_itemsize + 4 * T * (2 if quant else 1))
    return _work((3 if quant else 2) * n * T * W, n_bytes)
