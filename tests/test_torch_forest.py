"""Port vs reference: packed forest, traversal, and carried-over state.

A forest fitted by the JAX package is carried over with
`repro_torch.io.convert`, and the port's traversal (its plain version on the
CPU) is held to ``ref.forest_apply_ref``.

Rounding of the leaf add.  The reference's source adds ``acc + lr * v``:
two roundings, and the port (plain version and CUDA kernel alike) does
exactly that.  XLA's CPU backend, however, contracts the multiply-add of
``forest_apply_ref``'s scan body into a fused multiply-add (one rounding):
measured here, its output equals a float64 ``acc + lr * v`` rounded once to
float32 on every element, and differs from the two-rounding sum in about
16% of the elements by one float32 rounding step per tree.  So each test
holds the port BITWISE to a numpy replay of the reference's walk with two
roundings, holds the oracle bitwise to the same replay with one rounding
(the measured reason), and bounds the port's distance to the oracle by one
rounding step of the running sum per tree.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import boosting as JB
from repro.core import forest as JF
from repro.core import quantize as JQ
from repro.data.pipeline import make_tabular
from repro.kernels import ref as JR
from repro_torch.core import forest as TF
from repro_torch.core import quantize as TQ
from repro_torch.core import tree as TT
from repro_torch.io import convert
from repro_torch.kernels import predict_kernel


@functools.lru_cache(maxsize=1)
def _jax_model():
    X, y = make_tabular("multiclass", 600, 8, 5, seed=11)
    cfg = JB.GBDTConfig(n_trees=4, depth=4, sketch_k=2, use_kernel="jnp",
                        loop="python")
    return JB.SketchBoost(cfg).fit(X, y), X


def _arrays(pf):
    return {k: (None if v is None else np.array(v))
            for k, v in pf._asdict().items() if k != "depth"}


def _port_forest():
    jm, X = _jax_model()
    return convert.packed_forest_from_arrays(_arrays(jm.packed),
                                             depth=jm.packed.depth)


def _replay(jpf, codes, F0, leaf, cols, lr):
    """The reference's walk (``ref.node_walk_ref``) and leaf add replayed
    in numpy: ``(two_roundings, one_rounding)`` float32 results."""
    lr = np.float32(lr)
    two, one = F0.copy(), F0.copy()
    w = leaf.shape[2]
    for t, col in enumerate(cols):
        pos = np.asarray(JR.node_walk_ref(
            jpf.feat[t], jpf.thr[t], jpf.left[t], jpf.right[t],
            jnp.asarray(codes), depth=jpf.depth))
        v = leaf[t][pos]
        two[:, col:col + w] = two[:, col:col + w] + lr * v
        one[:, col:col + w] = (one[:, col:col + w].astype(np.float64)
                               + np.float64(lr) * v.astype(np.float64)
                               ).astype(np.float32)
    return two, one


def _check(got, want, jpf, codes, F0, leaf, cols, lr):
    two, one = _replay(jpf, codes, F0, leaf, cols, lr)
    np.testing.assert_array_equal(got, two)             # the port: bitwise
    np.testing.assert_array_equal(want, one)            # the oracle: FMA
    scale = np.abs(F0).max() + len(cols) * abs(lr) * np.abs(leaf).max()
    bound = len(cols) * np.spacing(np.float32(scale))
    assert np.abs(got - want).max() <= bound


def test_traversal_bitwise_full_width_on_fitted_forest():
    jm, X = _jax_model()
    pf = _port_forest()
    codes = np.array(JQ.apply_quantizer(jm.quantizer, jnp.asarray(X)))
    rng = np.random.default_rng(0)
    F0 = rng.normal(size=(codes.shape[0], pf.n_outputs)).astype(np.float32)
    want = JR.forest_apply_ref(jnp.asarray(F0), jnp.asarray(codes),
                               jm.packed.feat, jm.packed.thr, jm.packed.left,
                               jm.packed.right, jm.packed.leaf,
                               jm.packed.out_col, jnp.float32(jm.packed.lr),
                               depth=jm.packed.depth)
    got = predict_kernel.forest_traverse(
        torch.from_numpy(F0.copy()), torch.from_numpy(codes), pf.feat,
        pf.thr, pf.left, pf.right, pf.leaf, pf.out_col, float(pf.lr),
        depth=pf.depth)
    _check(got.numpy(), np.asarray(want), jm.packed, codes, F0,
           np.array(jm.packed.leaf), [0] * pf.n_trees, float(pf.lr))


@pytest.mark.parametrize("width", [1, 2])
def test_traversal_bitwise_narrow_blocks(width):
    """Narrow leaf blocks placed at per-tree columns (one_vs_all layout)."""
    jm, X = _jax_model()
    pf = _port_forest()
    codes = np.array(JQ.apply_quantizer(jm.quantizer, jnp.asarray(X)))
    d = pf.n_outputs
    leaf = np.array(jm.packed.leaf)[:, :, :width].copy()
    cols = (np.arange(pf.n_trees) * 2 % (d - width + 1)).astype(np.int32)
    F0 = np.random.default_rng(1).normal(size=(codes.shape[0], d)).astype(
        np.float32)
    want = JR.forest_apply_ref(jnp.asarray(F0), jnp.asarray(codes),
                               jm.packed.feat, jm.packed.thr, jm.packed.left,
                               jm.packed.right, jnp.asarray(leaf),
                               jnp.asarray(cols), jnp.float32(0.3),
                               depth=jm.packed.depth)
    got = predict_kernel.forest_traverse(
        torch.from_numpy(F0.copy()), torch.from_numpy(codes), pf.feat,
        pf.thr, pf.left, pf.right, torch.from_numpy(leaf),
        torch.from_numpy(cols), 0.3, depth=pf.depth)
    _check(got.numpy(), np.asarray(want), jm.packed, codes, F0, leaf,
           cols.tolist(), 0.3)


def test_pack_forest_matches_reference():
    """Trees carried over one by one pack into the reference's forest."""
    jm, _ = _jax_model()
    f = jm.forest
    trees = [convert.tree_from_arrays(f.feat[t], f.thr[t], f.value[t],
                                      f.gain[t], f.cover[t])
             for t in range(f.feat.shape[0])]
    forest = TT.stack_trees(trees)
    assert forest.depth == 4 and forest.n_trees == 4
    pf = TF.pack_forest(forest, torch.from_numpy(np.array(jm.base_score)),
                        jm.cfg.learning_rate)
    want = _arrays(jm.packed)
    for k, v in _arrays(pf).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    assert pf.depth == jm.packed.depth


@pytest.mark.parametrize("row_chunk", [0, 64, 1000])
def test_predict_raw_bitwise_with_carried_quantizer(row_chunk):
    jm, X = _jax_model()
    pf = _port_forest()
    q = convert.quantizer_from_edges(np.array(jm.quantizer.edges),
                                     jm.quantizer.n_bins)
    codes = TQ.codes_rows(TQ.apply_quantizer(q, torch.from_numpy(X)))
    got = TF.predict_raw(pf, codes, row_chunk=row_chunk)
    codes_r = JQ.apply_quantizer(jm.quantizer, jnp.asarray(X))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(codes_r))
    want = JF.predict_raw(jm.packed, codes_r, mode="jnp",
                          row_chunk=row_chunk)
    F0 = np.broadcast_to(np.array(jm.packed.base), got.shape).copy()
    _check(got.numpy(), np.asarray(want), jm.packed, codes.numpy(), F0,
           np.array(jm.packed.leaf), [0] * pf.n_trees, float(pf.lr))


def test_slice_rounds_matches_reference():
    jm, X = _jax_model()
    pf = TF.slice_rounds(_port_forest(), 2)
    want = JF.slice_rounds(jm.packed, 2)
    for k, v in _arrays(pf).items():
        np.testing.assert_array_equal(v, _arrays(want)[k], err_msg=k)


def test_heap_to_node_arrays_matches_reference():
    rng = np.random.default_rng(2)
    feat = rng.integers(0, 9, (3, 7)).astype(np.int32)
    thr = rng.integers(0, 255, (3, 7)).astype(np.int32)
    value = rng.normal(size=(3, 8, 4)).astype(np.float32)
    from repro.core import tree as JT
    want = JT.heap_to_node_arrays(jnp.asarray(feat), jnp.asarray(thr),
                                  jnp.asarray(value))
    got = TT.heap_to_node_arrays(torch.from_numpy(feat),
                                 torch.from_numpy(thr),
                                 torch.from_numpy(value))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
