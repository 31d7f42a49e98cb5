"""Port vs reference: config, quantizer, losses, sketch, package hygiene.

Inputs are made with numpy from a seed and go through the JAX package and
its PyTorch port (``src/repro_torch``) on the CPU.
"""
import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import boosting as JB
from repro.core import losses as JL
from repro.core import quantize as JQ
from repro.core import sketch as JS
from repro_torch.core import boosting as TB
from repro_torch.core import losses as TL
from repro_torch.core import quantize as TQ
from repro_torch.core import sketch as TS
from repro_torch.io import convert

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def test_config_fields_and_defaults_match_reference():
    ref = [(f.name, f.default) for f in dataclasses.fields(JB.GBDTConfig)]
    port = [(f.name, f.default) for f in dataclasses.fields(TB.GBDTConfig)]
    assert port == ref


# The sampling, robustness and checkpoint options are ported;
# dist_hist_compression is refused on one device, beside any of them, as
# the reference refuses it (it compresses the distributed fit's collective).
@pytest.mark.parametrize("option", [
    dict(strategy="one_vs_all", guard_policy="skip_round"),
    dict(hessian_floor=0.5),
    dict(ckpt_dir="ck"), dict(guard_policy="raise"),
    dict(subsample=0.5), dict(goss_a=0.2, goss_b=0.1), dict(colsample=0.5),
    dict(guard_policy="clip"), dict(save_every=2, ckpt_dir="ck"),
    dict(resume_from="ck"), dict()])
def test_out_of_slice_options_raise(option):
    with pytest.raises(ValueError, match="single-device"):
        TB.SketchBoost(TB.GBDTConfig(dist_hist_compression="sketch",
                                     **option), device="cpu")
    TB.GBDTConfig(**option).validate()


@pytest.mark.parametrize("option,slice_name", [
    (dict(strategy="one_vs_all", guard_policy="skip_round"), "distributed"),
    (dict(subsample=0.5), "distributed"), (dict(goss_a=0.2), "distributed"),
    (dict(colsample=0.5), "distributed"),
    (dict(guard_policy="skip_round"), "distributed"),
    (dict(resume_from="ck"), "distributed"),
    (dict(), "distributed")])
def test_refusals_name_their_slice(option, slice_name):
    with pytest.raises(ValueError,
                       match=f"train through core.{slice_name}"):
        TB.GBDTConfig(dist_hist_compression="sketch", **option).validate()


@pytest.mark.parametrize("option", [
    dict(hist_engine=e) for e in ("auto", "direct", "partition", "subtract")
] + [dict(sketch_method=s) for s in ("none", "top_outputs",
                                     "random_sampling", "random_projection",
                                     "truncated_svd")] + [
    dict(growth="leafwise", max_leaves=8), dict(hist_dtype="bfloat16"),
    dict(growth="leafwise", max_leaves=64, hist_dtype="bfloat16"),
    dict(growth="leafwise", max_leaves=2, hist_engine="subtract")])
def test_ported_options_are_accepted(option):
    TB.GBDTConfig(**option).validate()
    assert TB.SketchBoost(TB.GBDTConfig(**option), device="cpu").cfg == \
        TB.GBDTConfig(**option)


def test_unknown_values_raise():
    for bad in (dict(loop="eager"), dict(loss="hinge"),
                dict(use_kernel="jnp"), dict(hist_engine="tiles"),
                dict(sketch_method="pca")):
        with pytest.raises(ValueError):
            TB.SketchBoost(TB.GBDTConfig(**bad), device="cpu")


def test_device_rule_without_cuda():
    """No device given: CUDA, or an error when there is none."""
    if torch.cuda.is_available():
        assert TB.SketchBoost(TB.GBDTConfig()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TB.SketchBoost(TB.GBDTConfig())


@pytest.mark.parametrize("n_bins", [256, 17])
def test_quantizer_codes_bitwise(n_bins):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(900, 7)).astype(np.float32)
    X[rng.random(X.shape) < 0.05] = np.nan
    X[:, 3] = np.nan                                  # all-NaN column
    X[:, 5] = np.round(X[:, 5])                       # low cardinality
    q_ref = JQ.fit_quantizer(X, n_bins, sample_rows=500, seed=1)
    q = TQ.fit_quantizer(X, n_bins, sample_rows=500, seed=1, device="cpu")
    np.testing.assert_array_equal(q.edges.numpy(), np.asarray(q_ref.edges))
    codes_ref = np.asarray(JQ.apply_quantizer(q_ref, jnp.asarray(X)))
    codes_t = TQ.apply_quantizer(q, torch.from_numpy(X))
    assert codes_t.dtype == torch.uint8
    np.testing.assert_array_equal(codes_t.numpy().T, codes_ref)
    np.testing.assert_array_equal(TQ.codes_rows(codes_t).numpy(), codes_ref)
    assert (codes_t.numpy().T[np.isnan(X)] == TQ.MISSING_BIN).all()


def _loss_inputs(name, rng, n=64, d=6):
    F = rng.normal(size=(n, d)).astype(np.float32) * 3
    if name == "multiclass":
        return F, [rng.integers(0, d, n).astype(np.int32),
                   np.eye(d, dtype=np.float32)[rng.integers(0, d, n)]]
    if name == "multilabel":
        return F, [(rng.random((n, d)) > 0.5).astype(np.float32)]
    return F, [rng.normal(size=(n, d)).astype(np.float32)]


@pytest.mark.parametrize("name", ["multiclass", "multilabel",
                                  "multitask_mse"])
def test_losses_match_reference(name):
    rng = np.random.default_rng(2)
    F, Ys = _loss_inputs(name, rng)
    for Y in Ys:
        Gr, Hr = JL.get_loss(name).grad_hess(jnp.asarray(F), jnp.asarray(Y))
        G, H = TL.get_loss(name).grad_hess(torch.from_numpy(F),
                                           torch.from_numpy(Y))
        np.testing.assert_allclose(G.numpy(), np.asarray(Gr), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(H.numpy(), np.asarray(Hr), rtol=1e-6,
                                   atol=1e-7)
        vr = float(JL.get_loss(name).value(jnp.asarray(F), jnp.asarray(Y)))
        v = float(TL.get_loss(name).value(torch.from_numpy(F),
                                          torch.from_numpy(Y)))
        np.testing.assert_allclose(v, vr, rtol=1e-6)
        np.testing.assert_allclose(
            TL.get_loss(name).transform(torch.from_numpy(F)).numpy(),
            np.asarray(JL.get_loss(name).transform(jnp.asarray(F))),
            rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("d,k,method", [(16, 5, "random_projection"),
                                        (4, 5, "random_projection"),
                                        (16, 5, "none")])
def test_sketch_with_injected_projection(d, k, method):
    rng = np.random.default_rng(3)
    G = rng.normal(size=(50, d)).astype(np.float32)
    key = jax.random.key(7)
    ref = np.asarray(JS.build_sketch(jnp.asarray(G), method=method, k=k,
                                     key=key))
    Pi = np.array(JS.random_projection_matrix(d, k, key))
    out = TS.build_sketch(torch.from_numpy(G), method=method, k=k,
                          draw=torch.from_numpy(Pi))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_sketch_draws_from_generator():
    G = torch.randn(20, 12)
    a = TS.build_sketch(G, method="random_projection", k=3,
                        generator=torch.Generator().manual_seed(5))
    b = TS.build_sketch(G, method="random_projection", k=3,
                        generator=torch.Generator().manual_seed(5))
    assert a.shape == (20, 3) and torch.equal(a, b)


def test_port_imports_neither_jax_nor_repro():
    """Importing every module of the port loads no ``jax``, no ``repro``
    and no ``ml_dtypes``; no source file of the port names any of them."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules\n"
        "       if k.split('.')[0] in ('jax', 'repro', 'ml_dtypes')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro|ml_dtypes)(\s|\.|$)",
                         re.M)
    for root, _, files in os.walk(os.path.join(SRC, "repro_torch")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    assert not pattern.search(fh.read()), f


def test_port_calls_no_library_attention():
    """No source file of the port calls ``scaled_dot_product_attention``,
    ``torch.compile`` or ``torch.backends.cudnn``: attention goes through
    the port's own kernels, B7 and B8 (``chip_smoke.py`` times SDPA beside
    them as a yardstick, outside the package)."""
    pattern = re.compile(r"scaled_dot_product_attention|torch\.compile"
                         r"|torch\.backends\.cudnn")
    seen = 0
    for root, _, files in os.walk(os.path.join(SRC, "repro_torch")):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                with open(os.path.join(root, f)) as fh:
                    assert not pattern.search(fh.read()), f
                seen += 1
    assert seen > 50


@pytest.mark.parametrize("make", [
    lambda: TQ.fit_quantizer(np.zeros((4, 2), np.float32), 4),
    lambda: convert.quantizer_from_edges(np.zeros((2, 3), np.float32), 4),
    lambda: convert.tree_from_arrays(np.zeros(1), np.zeros(1),
                                     np.zeros((2, 1)), np.zeros(1))])
def test_helpers_follow_the_device_rule(make):
    """No device given: the helpers place their tensors on CUDA, or raise
    when there is none, as every entry point of the port does."""
    if torch.cuda.is_available():
        out = make()
        first = out.edges if hasattr(out, "edges") else out.feat
        assert first.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
