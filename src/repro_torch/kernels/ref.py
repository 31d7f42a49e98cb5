"""Plain PyTorch versions of the CUDA kernels.

Each function computes what its kernel computes, with the same inputs, in
plain tensor operations: the CPU path of the wrappers and the yardstick the
kernels are held to on the card.  Counterparts in the JAX package's
``kernels/ref.py``: `hist_nodes_ref` is ``histogram_tiles_ref`` followed by
the tile->node ``segment_sum`` of ``ops.histogram_splits_level``, with
tiles of `TILE_ROWS` rows (the reference's are 256);
`histogram_ref` (the direct engine), `split_scan_ref`, `node_walk_ref`,
`forest_apply_ref`, `forest_apply_quant_ref`, the TreeSHAP helpers,
`tree_shap_ref` and `tree_shap_interventional_ref` are their namesakes;
`flash_attention_ref` is B7's function (``_flash_kernel``, checked there
against ``mha_ref``); `decode_attention_ref` is B8's (``_decode_kernel``,
checked there against ``decode_attention_ref``), in the cache's own
``(b, s, hkv, dh)`` layout.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import split as S


# Rows a tile: B1 cuts each node's segment into tiles of this many rows,
# B4 the dataset order into chunks of it (``kTileRows`` in
# ``csrc/hist_common.cuh``).  Within a tile every cell adds its rows in row
# order from 0.0; the tiles' partial sums are added in tile order from 0.0.
TILE_ROWS = 16384

# The statistics' storage type for each ``hist_dtype``: float32 for B1,
# bfloat16 for B1-bf16.
HIST_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def stats_dtype(hist_dtype: str) -> torch.dtype:
    """The statistics' storage type of ``hist_dtype``; any other name
    raises, as the reference's ``hist_tiles_pallas`` does."""
    if hist_dtype not in HIST_DTYPES:
        raise ValueError(f"unknown hist_dtype {hist_dtype!r}; "
                         f"expected one of {tuple(HIST_DTYPES)}")
    return HIST_DTYPES[hist_dtype]


def hist_nodes_ref(codes_t: torch.Tensor, order: torch.Tensor,
                   stats_p: torch.Tensor, counts: torch.Tensor,
                   build_counts: torch.Tensor, *, n_bins: int,
                   row_tile: int = TILE_ROWS,
                   hist_dtype: str = "float32") -> torch.Tensor:
    """Plain B1: per-node histograms of node-contiguous rows.

    Node ``v`` contributes the first ``build_counts[v]`` rows of its
    segment of the partition (``order``, segment sizes ``counts``); the rows
    are cut into ``row_tile`` tiles from the segment's start
    (`ops.tile_plan`), each tile histogrammed in row order (``index_add_``,
    which keeps that order on the CPU), and the tiles added into their node
    in tile order from 0.0, the k-th tile of every node in step k.
    ``stats_p`` is (n, C) in partition order.  With ``hist_dtype
    = "bfloat16"`` (B1's bf16 variant) the statistics are first rounded to
    bfloat16, to nearest even, and the sums stay float32: the one-hot
    products of the reference's bf16 contraction are exact, so this is its
    function.  Returns ``(n_nodes, m, n_bins, C)`` float32.
    """
    from repro_torch.kernels.ops import tile_plan
    stats_p = stats_p.to(stats_dtype(hist_dtype)).to(torch.float32)
    n = order.shape[0]
    m = codes_t.shape[0]
    n_nodes = counts.shape[0]
    c = stats_p.shape[1]
    dev = stats_p.device
    per_node = torch.clamp((build_counts.long() + row_tile - 1) // row_tile,
                           min=1)
    n_tiles = int(per_node.sum())
    tile_node, src, valid = tile_plan(counts, build_counts, n=n,
                                      n_tiles=n_tiles, row_tile=row_tile)
    slot = torch.nonzero(valid)[:, 0]
    tile = slot // row_tile
    src = src.long()[slot]
    codes_g = codes_t[:, order.long()[src]].long()
    stats_g = stats_p[src]
    tiles = torch.zeros((m, n_tiles * n_bins, c), dtype=torch.float32,
                        device=dev)
    for f in range(m):
        tiles[f].index_add_(0, tile * n_bins + codes_g[f], stats_g)
    tiles = tiles.reshape(m, n_tiles, n_bins, c).transpose(0, 1)
    tile_node = tile_node.long()
    k_of = (torch.arange(n_tiles, device=dev)
            - (torch.cumsum(per_node, 0) - per_node)[tile_node])
    out = torch.zeros((n_nodes, m, n_bins, c), dtype=torch.float32,
                      device=dev)
    for k in range(int(per_node.max()) if n_nodes else 0):
        sel = torch.nonzero(k_of == k)[:, 0]
        nodes = tile_node[sel]
        out[nodes] = out[nodes] + tiles[sel]
    return out


def _sums_in_order(key: torch.Tensor, values_of, width: int):
    """For each distinct ``key``, the float32 sum of ``values_of(e)`` (rows
    of ``width`` values) over its entries ``e`` in entry order, added one at
    a time from 0.0.  Returns the distinct keys, ascending, and their sums.
    Entries are stably sorted by key; the r-th entry of every key is added
    in step r, where no two adds share a key, so the result is the same on
    every device."""
    order = torch.sort(key, stable=True).indices
    sorted_key = key[order]
    pos = torch.arange(order.numel(), device=key.device)
    first = torch.ones_like(sorted_key, dtype=torch.bool)
    first[1:] = sorted_key[1:] != sorted_key[:-1]
    group = torch.cumsum(first, 0) - 1
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    by_rank = torch.sort(rank, stable=True).indices
    sums = torch.zeros((int(first.sum()), width), dtype=torch.float32,
                       device=key.device)
    s = 0
    for size in torch.bincount(rank).tolist():
        idx = by_rank[s:s + size]
        g = group[idx]
        sums[g] = sums[g] + values_of(order[idx])
        s += size
    return sorted_key[first], sums


def histogram_ref(codes_t: torch.Tensor, node_pos: torch.Tensor,
                  stats: torch.Tensor, *, n_nodes: int, n_bins: int,
                  chunk_rows: int = TILE_ROWS) -> torch.Tensor:
    """Plain B4: the direct engine's whole-level histograms.

    ``codes_t`` (m, n) codes, ``node_pos`` (n,) node of each row, ``stats``
    (n, C) float32, all in dataset row order.  ``out[v, f, b, c]`` sums
    ``stats[i, c]`` over the rows ``i`` with ``node_pos[i] == v`` and
    ``codes_t[f, i] == b``.  The rows are cut into chunks of ``chunk_rows``
    rows of the dataset order; within a chunk each cell adds its rows one
    at a time in row order from 0.0, and the chunks' partial sums are added
    into the cell in chunk order from 0.0 (the kernel keeps that order).
    Returns ``(n_nodes, m, n_bins, C)``.
    """
    m, n = codes_t.shape
    c = stats.shape[1]
    dev = stats.device
    n_cells = n_nodes * m * n_bins
    out = torch.zeros((n_cells, c), dtype=torch.float32, device=dev)
    if n == 0 or m == 0:
        return out.reshape(n_nodes, m, n_bins, c)
    feat = torch.arange(m, device=dev)[:, None]
    chunk = torch.arange(n, device=dev)[None, :] // chunk_rows
    cell = (node_pos.long()[None, :] * m + feat) * n_bins + codes_t.long()
    stats = stats.to(torch.float32)
    # Each (chunk, cell) in row order: entry f * n + i is row i.
    keys, part = _sums_in_order((chunk * n_cells + cell).reshape(-1),
                                lambda e: stats[e % n], c)
    # Each cell's chunk partials in chunk order (keys ascend chunk-major).
    cells, sums = _sums_in_order(keys % n_cells, lambda e: part[e], c)
    out[cells] = sums
    return out.reshape(n_nodes, m, n_bins, c)


def split_scan_ref(hist: torch.Tensor, lam: float, min_data: float,
                   mask: torch.Tensor):
    """Plain B2: (nodes, m, B, C) histograms -> per-node ``(best_gain,
    best_idx)``, idx = feature * B + bin, ``(-inf, 0)`` with no legal
    split.  ``mask`` (m,) float32; 0 disables a feature."""
    return S.flat_argmax(S.split_scores(hist, lam, min_data, mask))


def node_walk_ref(feat: torch.Tensor, thr: torch.Tensor, left: torch.Tensor,
                  right: torch.Tensor, codes: torch.Tensor, *,
                  depth: int) -> torch.Tensor:
    """Pointer walk of ONE tree for ``depth`` steps: (n,) terminal node ids.
    Terminal nodes self-loop, so extra steps are exact no-ops."""
    n = codes.shape[0]
    pos = torch.zeros(n, dtype=torch.long, device=codes.device)
    for _ in range(depth):
        code = codes.gather(1, feat.long()[pos][:, None])[:, 0].long()
        pos = torch.where(code > thr.long()[pos], right.long()[pos],
                          left.long()[pos])
    return pos


def forest_apply_ref(F: torch.Tensor, codes: torch.Tensor,
                     feat: torch.Tensor, thr: torch.Tensor,
                     left: torch.Tensor, right: torch.Tensor,
                     leaf: torch.Tensor, out_col: torch.Tensor, lr: float,
                     *, depth: int) -> torch.Tensor:
    """Plain B3: ``F[:, col:col+w] += lr * leaf[t, pos]`` tree by tree in
    index order, updating ``F`` (n, d) float32 in place and returning it.
    ``lr * leaf`` is rounded before the add, as in the reference."""
    w = leaf.shape[2]
    lr_t = torch.tensor(lr, dtype=torch.float32, device=F.device)
    for t, col in enumerate(out_col.tolist()):
        pos = node_walk_ref(feat[t], thr[t], left[t], right[t], codes,
                            depth=depth)
        F[:, col:col + w] += lr_t * leaf[t][pos]
    return F


def forest_apply_quant_ref(F: torch.Tensor, codes: torch.Tensor,
                           feat: torch.Tensor, thr: torch.Tensor,
                           left: torch.Tensor, right: torch.Tensor,
                           leaf: torch.Tensor, leaf_scale: torch.Tensor,
                           out_col: torch.Tensor, lr: float, *,
                           depth: int) -> torch.Tensor:
    """Plain B5: `forest_apply_ref` on quantized storage.  ``thr`` (T, N)
    uint8, ``leaf`` (T, N, W) int8 or bfloat16, ``leaf_scale`` (T, 1) or
    (T,) float32.  Each add rounds three times, in the reference's order:
    ``deq = leaf.float() * scale``, then ``lr * deq``, then the sum.  So it
    is bitwise `forest_apply_ref` on the dequantized twin of the forest."""
    w = leaf.shape[2]
    lr_t = torch.tensor(lr, dtype=torch.float32, device=F.device)
    scale = leaf_scale.reshape(-1).to(torch.float32)
    for t, col in enumerate(out_col.tolist()):
        pos = node_walk_ref(feat[t], thr[t], left[t], right[t], codes,
                            depth=depth)
        deq = leaf[t][pos].to(torch.float32) * scale[t]
        F[:, col:col + w] += lr_t * deq
    return F


# ---------------------------------------------------------------------------
# TreeSHAP over packed root-to-leaf paths (plain B6, `shap_kernel.py`).
# ---------------------------------------------------------------------------

# "No upper bin bound" sentinel of merged path conditions (``o = lo < code
# <= hi``), shared by the path extractor and the kernel's padding.  Codes are
# below 2^20 always; the kernel compares it as an int32.
SHAP_BIG_BIN = 2 ** 20


def _unwind_weights(depth: int) -> list:
    """Shapley permutation weights ``W(k, D) = k!(D-1-k)!/D!``, k=0..D-1."""
    f = math.factorial
    return [f(k) * f(depth - 1 - k) / f(depth) for k in range(depth)]


def _poly_extend(coeffs: list, z_s, o_s) -> list:
    """Multiply a coefficient list by ``(z_s + o_s * x)`` (Lundberg EXTEND)."""
    out = [coeffs[0] * z_s]
    for k in range(1, len(coeffs)):
        out.append(coeffs[k] * z_s + coeffs[k - 1] * o_s)
    out.append(coeffs[-1] * o_s)
    return out


def path_unwind_psis(o_slots: list, z_slots: list) -> list:
    """Per-slot UNWIND sums ``Ψ_s = Σ_k W(k, D) [x^k] Π_{j≠s} (z_j + o_j x)``
    of a root-to-leaf path with ``D`` slots, division-free: prefix and
    suffix products of the path polynomial (EXTEND), then slot ``s``'s
    convolution of prefix ``s`` with suffix ``s + 1``.  Safe at ``z = 0``;
    padding slots with ``o = z = 1`` leave Ψ unchanged.  Inputs are
    length-``D`` lists of broadcast-compatible float32 tensors; each
    product and sum rounds once, in the reference's order (the kernel
    repeats it)."""
    depth = len(o_slots)
    ones = torch.ones_like(o_slots[0])
    prefixes = [[ones]]
    for s in range(depth):
        prefixes.append(_poly_extend(prefixes[-1], z_slots[s], o_slots[s]))
    suffixes = [None] * (depth + 1)
    suffixes[depth] = [ones]
    for s in range(depth - 1, -1, -1):
        suffixes[s] = _poly_extend(suffixes[s + 1], z_slots[s], o_slots[s])
    W = torch.tensor(_unwind_weights(depth), dtype=torch.float32,
                     device=o_slots[0].device)
    psis = []
    for s in range(depth):
        pre, suf = prefixes[s], suffixes[s + 1]
        psi = None
        for k in range(depth):                 # degree-k coeff of pre ⊛ suf
            ck = None
            for j in range(max(0, k - len(suf) + 1),
                           min(k, len(pre) - 1) + 1):
                term = pre[j] * suf[k - j]
                ck = term if ck is None else ck + term
            if ck is None:
                continue
            wck = ck * W[k]
            psi = wck if psi is None else psi + wck
        psis.append(psi)
    return psis


def _path_contribs(codes_i: torch.Tensor, sf, lo, hi, z) -> torch.Tensor:
    """Per-(row, leaf, slot) Shapley factors ``(o - z) * Ψ`` as (n, L, D):
    ``o = lo < code[sf] <= hi`` (padding slots have ``sf = -1``, ``lo =
    -1``, so ``o = 1``; a feature id past the codes reads the last one),
    ``z`` (L, D) the zero-fractions."""
    depth = sf.shape[1]
    c = codes_i[:, sf.clamp(0, codes_i.shape[1] - 1).long()]   # (n, L, D)
    o = ((c > lo) & (c <= hi)).to(torch.float32)
    o_slots = [o[..., s] for s in range(depth)]
    z_slots = [z[..., s] for s in range(depth)]
    psis = path_unwind_psis(o_slots, z_slots)
    return torch.stack([(o_slots[s] - z_slots[s]) * psis[s]
                        for s in range(depth)], dim=-1)


def _scatter_contribs(acc: torch.Tensor, contrib: torch.Tensor, sf, leaf_v,
                      col: int, lr_t: torch.Tensor) -> torch.Tensor:
    """``acc[:, :, col:col+w] += lr * res`` in place, with ``res[n, f, c] =
    Σ_l a[n, l, f] * leaf_v[l, c]`` summed over leaves in ascending order;
    ``a[n, l, f]`` is the sum, in slot order, of leaf ``l``'s slots on
    feature ``f`` (one slot on a merged path).  Two roundings per add."""
    n, m, _ = acc.shape
    L, w = leaf_v.shape
    res = torch.zeros((n, m, w), dtype=torch.float32, device=acc.device)
    for l, row in enumerate(sf.tolist()):
        for s, f in enumerate(row):
            if not 0 <= f < m or f in row[:s]:
                continue
            a = contrib[:, l, s]
            for s2 in range(s + 1, len(row)):
                if row[s2] == f:
                    a = a + contrib[:, l, s2]
            res[:, f, :] += a[:, None] * leaf_v[l][None, :]
    acc[:, :, col:col + w] += lr_t * res
    return acc


def tree_shap_ref(phi: torch.Tensor, codes: torch.Tensor,
                  slot_feat: torch.Tensor, slot_lo: torch.Tensor,
                  slot_hi: torch.Tensor, slot_z: torch.Tensor,
                  leaf: torch.Tensor, out_col: torch.Tensor,
                  lr: float) -> torch.Tensor:
    """Plain B6: path-dependent TreeSHAP, ``phi += lr * shap_t(codes)`` tree
    by tree in index order, in place.  phi (n, m, d) float32, codes (n, m)
    integer, slot tensors (T, L, D) from `explain.paths.build_path_pack`,
    leaf (T, L, w) float32, out_col (T,) the first column of each tree's
    block.  The slot axis is the path depth."""
    codes_i = codes.long()
    lr_t = torch.tensor(lr, dtype=torch.float32, device=phi.device)
    for t, col in enumerate(out_col.tolist()):
        contrib = _path_contribs(codes_i, slot_feat[t], slot_lo[t],
                                 slot_hi[t], slot_z[t].to(torch.float32))
        _scatter_contribs(phi, contrib, slot_feat[t], leaf[t], col, lr_t)
    return phi


def tree_shap_interventional_ref(phi: torch.Tensor, codes: torch.Tensor,
                                 bg_codes: torch.Tensor,
                                 slot_feat: torch.Tensor,
                                 slot_lo: torch.Tensor, slot_hi: torch.Tensor,
                                 leaf: torch.Tensor, out_col: torch.Tensor,
                                 lr: float) -> torch.Tensor:
    """Interventional TreeSHAP against (B, m) background codes, in place.

    `tree_shap_ref`'s path machinery with a slot's zero-fraction taken from
    each background row's one-fraction, and the factors averaged over the
    background rows (all at once: Ψ over (n, B, L)), so ``sum(phi) = f(x) -
    mean_b f(b)``.  The JAX package has no kernel for it; this runs on the
    card as it is."""
    codes_i = codes.long()
    bg_i = bg_codes.long()
    n_bg = torch.tensor(bg_codes.shape[0], dtype=torch.float32,
                        device=phi.device)
    lr_t = torch.tensor(lr, dtype=torch.float32, device=phi.device)
    depth = slot_feat.shape[2]
    for t, col in enumerate(out_col.tolist()):
        idx = slot_feat[t].clamp(0, codes.shape[1] - 1).long()
        lo, hi = slot_lo[t], slot_hi[t]
        c, cb = codes_i[:, idx], bg_i[:, idx]              # (n|B, L, D)
        o = ((c > lo) & (c <= hi)).to(torch.float32)[:, None]
        ob = ((cb > lo) & (cb <= hi)).to(torch.float32)[None]
        o_slots = [o[..., s] for s in range(depth)]        # (n, 1, L)
        z_slots = [ob[..., s] for s in range(depth)]       # (1, B, L)
        psis = path_unwind_psis(o_slots, z_slots)          # (n, B, L)
        contrib = torch.stack([(o_slots[s] - z_slots[s]) * psis[s]
                               for s in range(depth)], dim=-1)
        _scatter_contribs(phi, contrib.sum(1) / n_bg, slot_feat[t], leaf[t],
                          col, lr_t)
    return phi


NEG_INF = -1e30         # B7's and B8's masked score


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window=None,
                        chunk: int = 512) -> torch.Tensor:
    """Plain B7: GQA attention of q (b, hq, sq, dh) over k, v (b, hkv, sk,
    dh), in float32, returned in q's dtype.

    Query head h reads kv head ``h // (hq // hkv)``.  Scores are ``(q . k)
    * (1 / sqrt(dh))``; a score is ``-1e30`` unless the key lies before
    ``sk``, at or before the query (``causal``) and less than ``window``
    behind it.  Each query row's softmax takes its max, ``p = exp(s - m)``,
    ``l = sum p`` and ``(p @ v) / max(l, 1e-30)``, as ``_flash_kernel``
    (flash_attention.py:28-70) does tile by tile.  Query rows go in chunks
    of ``chunk``, each against the band of keys its rows can see (every
    other key's probability is exactly 0), so a 32k prefill fits on the
    card.  Every query row must see a key."""
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(b, hkv, group, sq, dh)
    out = torch.empty((b, hkv, group, sq, dh), dtype=q.dtype, device=q.device)
    for q0 in range(0, sq, chunk):
        q1 = min(q0 + chunk, sq)
        lo = 0 if window is None else max(0, q0 - window + 1)
        hi = min(sk, q1) if causal else sk
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg[:, :, :, q0:q1].float(),
                         k[:, :, lo:hi].float()) * scale
        qpos = torch.arange(q0, q1, device=q.device)[:, None]
        kpos = torch.arange(lo, hi, device=q.device)[None, :]
        mask = torch.ones((q1 - q0, hi - lo), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= qpos - kpos < window
        s = torch.where(mask, s, NEG_INF)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        o = torch.einsum("bhgqk,bhkd->bhgqd", p, v[:, :, lo:hi].float())
        out[:, :, :, q0:q1] = (o / p.sum(-1, keepdim=True).clamp_min(1e-30)
                               ).to(q.dtype)
    return out.reshape(b, hq, sq, dh)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor, *, window=None) -> torch.Tensor:
    """Plain B8: one query token per sequence against a KV cache.

    q is (b, hq, dh); k and v are (b, s, hkv, dh), the cache's layout;
    ``lengths`` (b,) int holds each row's valid keys (ragged allowed).
    Query head h reads kv head ``h // (hq // hkv)``.  In float32: scores
    ``(q . k) * (1 / sqrt(dh))``, ``-1e30`` unless ``kpos < length`` and,
    with a window, ``length - 1 - kpos < window``; ``p = exp(s - m)`` and
    ``(p @ v) / max(sum p, 1e-30)``, as ``_decode_kernel``
    (decode_attention.py:25-61) does tile by tile; returned in q's dtype.
    Batch rows go in chunks that keep the float32 copy of their cache near
    256 MiB."""
    b, hq, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = 1.0 / math.sqrt(dh)
    kpos = torch.arange(s, device=q.device)[None, :]
    ln = lengths.to(device=q.device, dtype=torch.long)[:, None]
    valid = kpos < ln
    if window is not None:
        valid &= (ln - 1 - kpos) < window
    qg = q.reshape(b, hkv, group, dh)
    out = torch.empty((b, hkv, group, dh), dtype=q.dtype, device=q.device)
    rows = max(1, (1 << 26) // max(1, s * hkv * dh))
    for b0 in range(0, b, rows):
        b1 = min(b0 + rows, b)
        sc = torch.einsum("bhgd,bshd->bhgs", qg[b0:b1].float(),
                          k[b0:b1].float()) * scale
        sc = torch.where(valid[b0:b1, None, None, :], sc, NEG_INF)
        p = torch.exp(sc - sc.amax(-1, keepdim=True))
        o = torch.einsum("bhgs,bshd->bhgd", p, v[b0:b1].float())
        out[b0:b1] = (o / p.sum(-1, keepdim=True).clamp_min(1e-30)
                      ).to(q.dtype)
    return out.reshape(b, hq, dh)
