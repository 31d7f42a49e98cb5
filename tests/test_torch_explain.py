"""Port vs reference: the explain path (path packs, TreeSHAP, importances,
leaf embeddings, the model's explain surface).

Forests fitted by the JAX package are carried over with
`repro_torch.io.convert`, so both packages explain the same trees; sizes are
those of tests/test_explain.py (300 x 6, 4 classes, depth 3, 4 rounds).

Tolerances.  The path pack, importances and leaf ids are bitwise the
reference's.  SHAP values agree within ``atol 1e-5 + rtol 1e-5``: the port
sums each tree's paths in ascending order with two roundings per add (its
CUDA kernel does the same, bitwise), while the reference's leaf contraction
is an XLA dot whose order, and whose contraction of multiply-adds into FMAs
on the CPU (see tests/test_torch_forest.py), are XLA's own.  Local accuracy
is held at 1e-4, as tests/test_explain.py holds the reference.
"""
import functools
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import explain as JEX
from repro.core import boosting as JB
from repro.core import forest as JF
from repro.core import quantize as JQ
from repro.data.pipeline import make_tabular
from repro.kernels import ref as JR
from repro_torch import explain as TEX
from repro_torch.core import boosting as TB
from repro_torch.core import forest as TF
from repro_torch.io import convert
from repro_torch.kernels import ref as TR
from repro_torch.kernels import shap_kernel
from test_torch_fit import _replayed_projections

TOL = dict(atol=1e-5, rtol=1e-5)
METHODS = ["none", "top_outputs", "random_sampling", "random_projection",
           "truncated_svd"]


@functools.lru_cache(maxsize=None)
def _jax_fit(strategy="single_tree", method="random_projection", seed=21,
             **kw):
    X, y = make_tabular("multiclass", 300, 6, 4, seed=seed)
    cfg = JB.GBDTConfig(loss="multiclass", strategy=strategy,
                        sketch_method=method, sketch_k=2, n_trees=4, depth=3,
                        learning_rate=0.3, use_kernel="jnp", **kw)
    return JB.SketchBoost(cfg).fit(X, y), X


def _port(jpf):
    arrays = {k: (None if v is None else np.array(v))
              for k, v in jpf._asdict().items() if k != "depth"}
    return convert.packed_forest_from_arrays(arrays, depth=jpf.depth,
                                             device="cpu")


def _codes(jm, X):
    return np.array(JQ.apply_quantizer(jm.quantizer, jnp.asarray(X)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _forest(variant):
    """A JAX forest of each topology the path pack must handle."""
    if variant == "one_vs_all":
        return _jax_fit("one_vs_all")[0].packed
    if variant == "leafwise":
        return _jax_fit(growth="leafwise", max_leaves=6, seed=5)[0].packed
    jpf = _jax_fit(seed=9)[0].packed
    if variant in ("pruned", "compacted"):
        alpha = float(np.quantile(np.asarray(jpf.gain)[:, :7], 0.5))
        jpf = JF.prune_forest(jpf, alpha)            # orphans in place
        if variant == "compacted":
            jpf = JF.compact_forest(jpf)
    return jpf


def _assert_same_pack(tp, jp):
    for name, a, b in zip(jp._fields, jp, tp):
        a = np.asarray(a)
        assert b.numpy().dtype == a.dtype, name
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)


# -- path pack, bitwise -------------------------------------------------------

@pytest.mark.parametrize("variant", ["heap", "one_vs_all", "pruned",
                                     "compacted", "leafwise", "coverless"])
def test_path_pack_bitwise(variant):
    jpf = _forest("heap" if variant == "coverless" else variant)
    if variant == "coverless":
        jpf = jpf._replace(cover=None)
        for build, pf in ((JEX.build_path_pack, jpf),
                          (TEX.build_path_pack, _port(jpf))):
            with pytest.raises(ValueError, match="cover"):
                build(pf)
    need = variant != "coverless"
    tp = TEX.build_path_pack(_port(jpf), need_cover=need)
    _assert_same_pack(tp, JEX.build_path_pack(jpf, need_cover=need))
    assert tp.slot_feat.shape[1] % 8 == 0
    if variant == "pruned":          # orphaned ex-terminals stay off the axis
        assert not _port(jpf).is_heap
    # The reference's own pack, carried over, is the port's.
    jp = JEX.build_path_pack(jpf, need_cover=need)
    _assert_same_pack(convert.path_pack_from_arrays(
        {k: np.asarray(v) for k, v in jp._asdict().items()}, device="cpu"),
        jp)


# -- TreeSHAP against the reference -------------------------------------------

@pytest.mark.parametrize("strategy", ["single_tree", "one_vs_all"])
def test_shap_matches_reference(strategy):
    jm, X = _jax_fit(strategy)
    codes = _codes(jm, X)
    jphi, jbase = JEX.shap_values(jm.packed, jnp.asarray(codes), mode="jnp")
    tphi, tbase = TEX.shap_values(_port(jm.packed), _t(codes))
    assert tphi.shape == (len(X), 6, 4) and tphi.dtype == torch.float32
    np.testing.assert_allclose(tphi.numpy(), np.asarray(jphi), **TOL)
    np.testing.assert_allclose(tbase.numpy(), np.asarray(jbase), **TOL)
    np.testing.assert_allclose(
        TEX.expected_values(_port(jm.packed)).numpy(),
        np.asarray(JEX.expected_values(jm.packed)), **TOL)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("strategy", ["single_tree", "one_vs_all"])
def test_shap_local_accuracy_on_converted_forests(method, strategy):
    jm, X = _jax_fit(strategy, method)
    pf = _port(jm.packed)
    codes = _t(_codes(jm, X))
    phi, base = TEX.shap_values(pf, codes)
    raw = np.asarray(jm.predict_raw(X))
    np.testing.assert_allclose(base.numpy() + phi.numpy().sum(1), raw,
                               atol=1e-4)
    np.testing.assert_allclose(base.numpy() + phi.numpy().sum(1),
                               TF.predict_raw(pf, codes).numpy(), atol=1e-4)


def test_shap_local_accuracy_with_sampling():
    """SGB weights flow into the covers; local accuracy must survive."""
    jm, X = _jax_fit(subsample=0.7, seed=5)
    codes = _codes(jm, X)
    phi, base = TEX.shap_values(_port(jm.packed), _t(codes))
    np.testing.assert_allclose(base.numpy() + phi.numpy().sum(1),
                               np.asarray(jm.predict_raw(X)), atol=1e-4)
    jphi, _ = JEX.shap_values(jm.packed, jnp.asarray(codes), mode="jnp")
    np.testing.assert_allclose(phi.numpy(), np.asarray(jphi), **TOL)


@pytest.mark.parametrize("strategy", ["single_tree", "one_vs_all"])
def test_interventional_matches_reference(strategy):
    jm, X = _jax_fit(strategy)
    codes = _codes(jm, X)
    bg, rows = codes[:13], codes[:60]
    jphi, jbase = JEX.shap_values(jm.packed, jnp.asarray(rows),
                                  algorithm="interventional",
                                  background=jnp.asarray(bg), mode="jnp")
    pf = _port(jm.packed)
    tphi, tbase = TEX.shap_values(pf, _t(rows), algorithm="interventional",
                                  background=_t(bg))
    np.testing.assert_allclose(tphi.numpy(), np.asarray(jphi), **TOL)
    np.testing.assert_allclose(tbase.numpy(), np.asarray(jbase), **TOL)
    np.testing.assert_allclose(
        tbase.numpy(), TF.predict_raw(pf, _t(bg)).mean(0).numpy(), atol=1e-6)
    np.testing.assert_allclose(tbase.numpy() + tphi.numpy().sum(1),
                               TF.predict_raw(pf, _t(rows)).numpy(),
                               atol=1e-4)
    # Cover-less forests explain interventionally; path-dependent raises.
    bare = pf._replace(cover=None)
    phi2, _ = TEX.shap_values(bare, _t(rows), algorithm="interventional",
                              background=_t(bg))
    assert torch.equal(phi2, tphi)
    with pytest.raises(ValueError, match="cover"):
        TEX.shap_values(bare, _t(rows))
    with pytest.raises(ValueError, match="background"):
        TEX.shap_values(pf, _t(rows), algorithm="interventional")
    with pytest.raises(ValueError, match="unknown SHAP algorithm"):
        TEX.shap_values(pf, _t(rows), algorithm="exact")


def test_row_chunk_invariance():
    jm, X = _jax_fit()
    pf, codes = _port(jm.packed), _t(_codes(jm, X))
    whole, base = TEX.shap_values(pf, codes)
    for chunk in (1, 41, 299, 1000):
        part, base2 = TEX.shap_values(pf, codes, row_chunk=chunk)
        assert torch.equal(part, whole) and torch.equal(base2, base)
    bg = codes[:9]
    whole, _ = TEX.shap_values(pf, codes[:50], algorithm="interventional",
                               background=bg)
    part, _ = TEX.shap_values(pf, codes[:50], algorithm="interventional",
                              background=bg, row_chunk=7)
    assert torch.equal(part, whole)


def test_iteration_prefix_of_the_pack():
    """The pack of the first rounds is the tree-axis prefix of the whole
    forest's pack, up to path-axis padding, and explains the sliced forest
    as the reference's sliced model does."""
    jm, X = _jax_fit(seed=9)
    pf = _port(jm.packed)
    full = TEX.build_path_pack(pf)
    prefix = TEX.PathPack(*(a[:2] for a in full))
    sliced = TF.slice_rounds(pf, 2)
    own = TEX.build_path_pack(sliced)
    L = own.slot_feat.shape[1]
    for name, a, b in zip(own._fields, prefix, own):
        assert torch.equal(a[:, :L], b), name
    assert bool((prefix.slot_feat[:, L:] == -1).all())
    assert not prefix.leaf[:, L:].any() and not prefix.leaf_weight[:, L:].any()
    codes = _t(_codes(jm, X[:40]))
    phi, base = TEX.shap_values(sliced, codes, pack=prefix)
    jphi, jbase = jm.shap_values(X[:40], iteration=2)
    np.testing.assert_allclose(phi.numpy(), np.asarray(jphi), **TOL)
    np.testing.assert_allclose(base.numpy(), np.asarray(jbase), **TOL)


def test_plain_shap_on_raw_tables_matches_reference():
    """The plain version on hand-made tables: duplicate features on a path
    (summed in slot order), z = 0 edges, padding slots and leaves, an
    out-of-range feature id, narrow blocks at per-tree columns."""
    rng = np.random.default_rng(4)
    T, L, D, M, n, d = 5, 8, 4, 7, 33, 6
    sf = rng.integers(-1, M, (T, L, D)).astype(np.int32)
    sf[0, 0] = [2, 2, 5, 2]
    sf[1, 3] = [M + 3, 1, -1, 1]
    lo = rng.integers(-1, 100, (T, L, D)).astype(np.int32)
    hi = (lo + rng.integers(1, 200, (T, L, D))).astype(np.int32)
    hi[sf == -1] = TR.SHAP_BIG_BIN
    lo[sf == -1] = -1
    z = rng.uniform(0, 1, (T, L, D)).astype(np.float32)
    z[rng.uniform(size=z.shape) < 0.2] = 0.0
    z[sf == -1] = 1.0
    codes = rng.integers(0, 256, (n, M)).astype(np.uint8)
    for W, cols in ((d, np.zeros(T, np.int32)),
                    (1, np.array([0, 3, 5, 3, 1], np.int32))):
        leaf = rng.normal(size=(T, L, W)).astype(np.float32)
        leaf[:, -2:] = 0.0
        want = JR.tree_shap_ref(
            jnp.zeros((n, M, d), jnp.float32), jnp.asarray(codes),
            jnp.asarray(sf), jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(z),
            jnp.asarray(leaf), jnp.asarray(cols), jnp.float32(0.3), depth=D)
        got = shap_kernel.tree_shap(_t(codes), _t(sf), _t(lo), _t(hi), _t(z),
                                    _t(leaf), _t(cols), 0.3, n_outputs=d)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@settings(deadline=None, max_examples=25)
@given(depth=st.integers(1, 8), seed=st.integers(0, 2 ** 16))
def test_path_unwind_psis_matches_reference(depth, seed):
    """Ψ of the port against the reference's, and per path the Shapley
    efficiency ``Σ_s (o_s - z_s) Ψ_s = Π o - Π z``."""
    rng = np.random.default_rng(seed)
    o = (rng.uniform(size=(depth, 16)) < 0.5).astype(np.float32)
    z = rng.uniform(size=(depth, 16)).astype(np.float32)
    z[rng.uniform(size=z.shape) < 0.15] = 0.0
    tp = TR.path_unwind_psis([_t(r) for r in o], [_t(r) for r in z])
    jp = JR.path_unwind_psis([jnp.asarray(r) for r in o],
                             [jnp.asarray(r) for r in z])
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    total = sum((o[s] - z[s]).astype(np.float64) * tp[s].numpy()
                for s in range(depth))
    np.testing.assert_allclose(total, o.prod(0, dtype=np.float64)
                               - z.prod(0, dtype=np.float64), atol=1e-5)


# -- importances and leaf embeddings ------------------------------------------

@pytest.mark.parametrize("kind", ["gain", "cover", "split_count"])
def test_feature_importances_match_reference(kind):
    for jpf in (_forest("heap"), _forest("one_vs_all"), _forest("pruned")):
        got = TEX.feature_importances(_port(jpf), kind=kind, n_features=6)
        want = np.asarray(JEX.feature_importances(jpf, kind=kind,
                                                  n_features=6))
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.shape == (6,) and float(got.sum()) == pytest.approx(1.0)
    raw = TEX.feature_importances(_port(jpf), kind=kind, normalize=False)
    np.testing.assert_array_equal(raw.numpy(), np.asarray(
        JEX.feature_importances(jpf, kind=kind, normalize=False)))
    with pytest.raises(ValueError, match="unknown importance kind"):
        TEX.feature_importances(_port(jpf), kind="nope")


def test_real_split_mask_excludes_pass_through():
    """Large min_data_in_leaf leaves pass-through nodes in the heap trees:
    they are internal by pointer but not real splits."""
    jm, _ = _jax_fit(seed=73, min_data_in_leaf=60.0)
    pf = _port(jm.packed)
    mask = TEX.real_split_mask(pf)
    np.testing.assert_array_equal(mask.numpy(),
                                  np.asarray(JEX.real_split_mask(jm.packed)))
    internal = pf.left != torch.arange(pf.n_nodes, dtype=torch.int32)
    assert bool((internal & ~mask).any())           # pass-through exists
    assert bool((pf.thr[mask] < jm.cfg.n_bins - 1).all())
    with pytest.raises(ValueError, match="cover"):
        TEX.real_split_mask(pf._replace(cover=None))
    with pytest.raises(ValueError, match="gain"):
        TEX.feature_importances(pf._replace(gain=None), kind="gain")


@pytest.mark.parametrize("variant", ["heap", "one_vs_all", "compacted",
                                     "leafwise"])
def test_apply_forest_bitwise(variant):
    jpf = _forest(variant)
    jm, X = _jax_fit()
    codes = _codes(jm, X)
    got = TEX.apply_forest(_port(jpf), _t(codes))
    want = np.asarray(JEX.apply_forest(jpf, jnp.asarray(codes)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# -- the model's surface, port fit against JAX fit ----------------------------

def test_port_fit_explain_surface_matches_reference():
    """A port-fitted model (CPU, the reference's sketches replayed) explains
    as the JAX-fitted one does: SHAP, its iteration slice, leaf ids and
    importances."""
    X, y = make_tabular("multiclass", 900, 8, 4, seed=3, n_informative=8)
    kw = dict(n_trees=5, depth=4, sketch_k=2, learning_rate=0.5,
              min_data_in_leaf=20.0)
    ref = JB.SketchBoost(JB.GBDTConfig(use_kernel="jnp", loop="python", **kw))
    ref.fit(X, y)
    port = TB.SketchBoost(TB.GBDTConfig(**kw), device="cpu")
    port.fit(X, y, sketch_mats=_replayed_projections(0, 5, 4, 2))
    Xe = X[:120]
    np.testing.assert_array_equal(port.apply(Xe).numpy(),
                                  np.asarray(ref.apply(Xe)))
    np.testing.assert_array_equal(port.apply(Xe, iteration=2).numpy(),
                                  np.asarray(ref.apply(Xe, iteration=2)))
    for it in (None, 2):
        phi, base = port.shap_values(Xe, iteration=it, check_additivity=True)
        jphi, jbase = ref.shap_values(Xe, iteration=it)
        np.testing.assert_allclose(phi.numpy(), np.asarray(jphi), atol=1e-4)
        np.testing.assert_allclose(base.numpy(), np.asarray(jbase), atol=1e-5)
        np.testing.assert_allclose(
            base.numpy() + phi.numpy().sum(1),
            port.predict_raw(Xe, iteration=it).numpy(), atol=1e-4)
    phi, base = port.shap_values(Xe[:30], algorithm="interventional",
                                 background=X[:10])
    jphi, jbase = ref.shap_values(Xe[:30], algorithm="interventional",
                                  background=X[:10])
    np.testing.assert_allclose(phi.numpy(), np.asarray(jphi), atol=1e-4)
    np.testing.assert_allclose(base.numpy(), np.asarray(jbase), atol=1e-4)
    for kind in TEX.IMPORTANCE_KINDS:
        np.testing.assert_allclose(port.feature_importances(kind).numpy(),
                                   np.asarray(ref.feature_importances(kind)),
                                   rtol=1e-5, atol=1e-7)
    assert torch.equal(port.feature_importances_,
                       port.feature_importances("gain"))
    # The pack is built once per fit and dropped by a refit.
    pack = port._path_pack
    assert pack is not None
    port.shap_values(Xe[:5])
    assert port._path_pack is pack
    port.fit(X[:600], y[:600], sketch_mats=_replayed_projections(0, 5, 4, 2))
    assert port._path_pack is None


def test_check_additivity_raises_on_a_broken_pack():
    port = TB.SketchBoost(TB.GBDTConfig(n_trees=3, depth=3), device="cpu")
    X, y = make_tabular("multiclass", 300, 6, 3, seed=1, n_informative=6)
    port.fit(X, y)
    pack = TEX.build_path_pack(port.packed)
    port._path_pack = pack._replace(leaf=pack.leaf * 2)
    with pytest.raises(AssertionError, match="additivity"):
        port.shap_values(X[:20], check_additivity=True)
    with pytest.raises(ValueError, match="not fitted"):
        TB.SketchBoost(TB.GBDTConfig(), device="cpu").shap_values(X)


def test_explain_imports_neither_jax_nor_repro():
    code = ("import sys\n"
            "import repro_torch.explain\n"
            "bad = [k for k in sys.modules\n"
            "       if k.split('.')[0] in ('jax', 'repro')]\n"
            "assert not bad, bad\n")
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
