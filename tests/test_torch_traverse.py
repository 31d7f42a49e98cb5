"""B3 and B5's per-element order, on the CPU.

``csrc/predict.cu`` adds into each element of F the trees whose columns
cover it, in index order, whatever tile it picks.  The plain versions
(``ref.forest_apply_ref``, ``ref.forest_apply_quant_ref``) are held bitwise
to a numpy replay of that order with the kernel's roundings, at the serving
window.  The forests built here are the CUDA tests' too: the kernels are
held to the plain versions on the card (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import predict_kernel as PK
from repro_torch.kernels import predict_quant_kernel as PQ


def pointer_tree(rng, n_leaves: int, M: int):
    """One random pointer tree with ``n_leaves`` leaves (N = 2 n_leaves - 1
    nodes), grown by splitting a random leaf, the newest half the time, so
    that it runs deeper than a balanced tree.  Leaves self-loop.  Returns
    ``(feat, thr, left, right, depth)``."""
    N = 2 * n_leaves - 1
    feat = np.zeros(N, np.int32)
    thr = np.zeros(N, np.int32)
    left = np.arange(N, dtype=np.int32)
    right = np.arange(N, dtype=np.int32)
    level = np.zeros(N, np.int32)
    leaves, used = [0], 1
    while used < N:
        i = leaves.pop(-1 if rng.random() < 0.5 else
                       int(rng.integers(len(leaves))))
        feat[i] = rng.integers(M)
        thr[i] = rng.integers(0, 255)
        left[i], right[i] = used, used + 1
        level[used:used + 2] = level[i] + 1
        leaves += [used, used + 1]
        used += 2
    return feat, thr, left, right, int(level.max())


def random_forest(rng, layout: str, T: int, W: int, M: int, D: int,
                  depth: int = 6, n_leaves: int = 128):
    """numpy arrays of a random forest: ``layout`` "heap" (complete depth-
    ``depth`` trees, N = 2^(depth+1) - 1, the packed heap layout),
    "pointer" (leaf-wise trees with ``n_leaves`` leaves) or "compact"
    (heap trees with their node axis padded to a multiple of 8 by inert
    self-loops, as `forest.compact_forest` leaves them).  Columns: every
    tree at 0 when W = D, else random windows of width W."""
    if layout == "pointer":
        trees = [pointer_tree(rng, n_leaves, M) for _ in range(T)]
        feat, thr, left, right = (np.stack([t[k] for t in trees])
                                  for k in range(4))
        depth = max(t[4] for t in trees)
    else:
        h = 2 ** depth - 1
        N = 2 * h + 1
        idx = np.arange(N)
        feat = np.where(idx < h, rng.integers(0, M, (T, N)), 0)
        thr = np.where(idx < h, rng.integers(0, 256, (T, N)), 0)
        left = np.broadcast_to(np.where(idx < h, 2 * idx + 1, idx), (T, N))
        right = np.broadcast_to(np.where(idx < h, 2 * idx + 2, idx), (T, N))
        if layout == "compact":
            pad = -N % 8
            ext = np.arange(N, N + pad)
            feat, thr = (np.pad(a, ((0, 0), (0, pad))) for a in (feat, thr))
            left, right = (np.concatenate([a, np.broadcast_to(ext, (T, pad))],
                                          1) for a in (left, right))
    N = feat.shape[1]
    out_col = (np.zeros(T, np.int32) if W == D
               else rng.integers(0, D - W + 1, T).astype(np.int32))
    return dict(feat=np.ascontiguousarray(feat, np.int32),
                thr=np.ascontiguousarray(thr, np.int32),
                left=np.ascontiguousarray(left, np.int32),
                right=np.ascontiguousarray(right, np.int32),
                leaf=rng.normal(size=(T, N, W)).astype(np.float32),
                out_col=out_col, depth=depth)


def quantized(rng, f: dict, dtype: str) -> dict:
    """``f`` with B5's storage: uint8 thresholds, int8 leaves and a random
    per-tree scale, or bfloat16 leaves (as float32 values) and scale 1."""
    T = f["leaf"].shape[0]
    if dtype == "int8":
        leaf = np.clip(np.round(f["leaf"] * 60), -127, 127).astype(np.int8)
        scale = (rng.random(T) * 0.03).astype(np.float32)
    else:
        leaf = torch.from_numpy(f["leaf"]).to(torch.bfloat16)
        scale = np.ones(T, np.float32)
    return dict(f, thr=f["thr"].astype(np.uint8), leaf=leaf, scale=scale)


def replay(F0, codes, f, lr, scale=None):
    """The kernel's order in numpy: every element takes the trees whose
    columns cover it in index order; two roundings an add (B3), three with
    ``scale`` (B5)."""
    lr = np.float32(lr)
    F = F0.copy()
    leaf = f["leaf"]
    leaf = (leaf.float().numpy() if torch.is_tensor(leaf)
            else leaf.astype(np.float32))
    T, _, W = leaf.shape
    for t in range(T):
        col = int(f["out_col"][t])
        v = leaf[t][_walk(f, t, codes)]
        if scale is not None:
            v = v * scale[t]
        F[:, col:col + W] = F[:, col:col + W] + lr * v
    return F


def _walk(f, t, rows):
    pos = np.zeros(len(rows), np.int64)
    thr = f["thr"][t].astype(np.int64)
    for _ in range(f["depth"]):
        code = rows[np.arange(len(rows)), f["feat"][t][pos]].astype(np.int64)
        pos = np.where(code > thr[pos], f["right"][t][pos], f["left"][t][pos])
    return pos


def _plain(F0, codes, f, lr, scale=None):
    args = [torch.from_numpy(np.ascontiguousarray(f[k]))
            for k in ("feat", "thr", "left", "right")]
    leaf = f["leaf"] if torch.is_tensor(f["leaf"]) else torch.from_numpy(
        f["leaf"])
    cols = torch.from_numpy(f["out_col"])
    F = torch.from_numpy(F0.copy())
    if scale is None:
        return PK.forest_traverse(F, torch.from_numpy(codes), *args, leaf,
                                  cols, lr, depth=f["depth"]).numpy()
    return PQ.forest_traverse_quant(F, torch.from_numpy(codes), *args, leaf,
                                    torch.from_numpy(scale), cols, lr,
                                    depth=f["depth"]).numpy()


def _inputs(seed, n, D, W, T, M=100, layout="heap", **kw):
    rng = np.random.default_rng(seed)
    f = random_forest(rng, layout, T, W, M, D, **kw)
    codes = rng.integers(0, 256, (n, M)).astype(np.uint8)
    F0 = rng.normal(size=(n, D)).astype(np.float32)
    return rng, f, codes, F0


# (n, D, W): the serving window, 256 rows of a 100-tree model, full width
# and in the one-vs-all layout (width 1 at per-tree columns).
WINDOW_CASES = [(256, 512, 512), (256, 512, 1)]


@pytest.mark.parametrize("n,D,W", WINDOW_CASES)
def test_plain_traversal_matches_the_kernels_order(n, D, W):
    _, f, codes, F0 = _inputs(n + W, n, D, W, 100)
    want = replay(F0, codes, f, 0.05)
    np.testing.assert_array_equal(_plain(F0, codes, f, 0.05), want)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("n,D,W", WINDOW_CASES)
def test_plain_quant_traversal_matches_the_kernels_order(dtype, n, D, W):
    rng, f, codes, F0 = _inputs(n + W, n, D, W, 100)
    q = quantized(rng, f, dtype)
    want = replay(F0, codes, q, 0.05, scale=q["scale"])
    np.testing.assert_array_equal(_plain(F0, codes, q, 0.05, q["scale"]),
                                  want)
