"""Port vs reference: the dry run and the roofline (`launch/dryrun.py`,
`roofline/`, and the partition specs of `models/params.py`, `models/lm.py`,
`training/optimizer.py`, `training/train_lib.py` and `core/distributed.py`).

The reference's spec functions take a ``jax.sharding.AbstractMesh`` (no
devices) and run in this process.  ``repro.launch.dryrun`` sets
``XLA_FLAGS`` to 512 host devices when imported, so its cell rules
(`cell_is_legal`, `probe_depths`, `reduced`, `useful_model_flops`) are read
in one subprocess that prints them as JSON.

Held equal, entry by entry: the partition specs of every registry config on
the reference's 16 x 16 and 2 x 16 x 16 meshes and under ``dp_only`` rules,
the cache specs at decode_32k and long_500k, the GBDT cell's input specs,
and a rank's argument bytes (the reference's per-layer ``length`` arrays,
which the port keeps as one host int, left out).  Held bitwise: the cell
rules, `extrapolate`, `RooflineTerms` under the reference's constants, and
the report's text.  The counter's FLOPs of a 2-layer float32 train step
equal the closed form of its matrix products plus B7's formulas exactly,
and each kernel wrapper reports its formula's work on the plain path with
nothing of the plain body counted.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from jax.sharding import AbstractMesh

from repro.configs import ARCH_NAMES as J_ARCHS
from repro.configs import get_config as j_config
from repro.configs import get_gbdt_config as j_gbdt_config
from repro.core import distributed as JD
from repro.core.boosting import GBDTConfig as JCfg
from repro.models import lm as JLM
from repro.models import params as JP
from repro.models.config import LM_SHAPES as J_SHAPES
from repro.roofline import analysis as JRA
from repro.roofline import report as JRR
from repro.training import optimizer as JO
from repro.training import train_lib as JT
from repro_torch import configs as TC
from repro_torch.core import boosting as TB
from repro_torch.core import distributed as TD
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import hist_kernel, predict_kernel, split_kernel
from repro_torch.kernels import work
from repro_torch.launch import dryrun as TDR
from repro_torch.launch import mesh as TM
from repro_torch.models import lm as TLM
from repro_torch.models import params as TP
from repro_torch.models.config import LM_SHAPES, shape_by_name
from repro_torch.roofline import analysis as TRA
from repro_torch.roofline import report as TRR
from repro_torch.training import train_lib as TT

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), TM.AbstractMesh(shape, axes)


def _specs_equal(want, got, path=()):
    """Walk the port's spec tree; each leaf equals the reference's
    PartitionSpec at the same key (the reference's ``length`` entries, which
    the port does not have, are not visited)."""
    if isinstance(got, dict):
        for k in got:
            _specs_equal(want[k], got[k], path + (k,))
    elif isinstance(got, list):
        assert len(got) == len(want), path
        for i, (w, g) in enumerate(zip(want, got)):
            _specs_equal(w, g, path + (i,))
    else:
        assert tuple(want) == got, (path, want, got)


def _drop_length(tree):
    if isinstance(tree, dict):
        return {k: _drop_length(v) for k, v in tree.items() if k != "length"}
    if isinstance(tree, list):
        return [_drop_length(v) for v in tree]
    return tree


# -- the cell rules, read from the reference in a subprocess -------------------

_RULES = """
import dataclasses, json
from repro.launch import dryrun as D
from repro.configs import ARCH_NAMES, get_config
from repro.models.config import LM_SHAPES
out = {}
for arch in ARCH_NAMES:
    cfg = get_config(arch)
    l1, l2 = D.probe_depths(cfg)
    out[arch] = {"probe": [l1, l2],
                 "reduced": [dataclasses.asdict(D.reduced(cfg, l))
                             for l in (l1, l2)],
                 "cells": {c.name: [list(D.cell_is_legal(cfg, c)),
                                    D.useful_model_flops(cfg, c)]
                           for c in LM_SHAPES}}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_rules():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _RULES], env=env, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    return json.loads(out.strip().splitlines()[-1])


def test_cell_rules_match_reference_bitwise(reference_rules):
    assert list(reference_rules) == TC.ARCH_NAMES == list(J_ARCHS)
    assert [c.name for c in LM_SHAPES] == [c.name for c in J_SHAPES]
    for arch, want in reference_rules.items():
        cfg = TC.get_config(arch)
        l1, l2 = TDR.probe_depths(cfg)
        assert [l1, l2] == want["probe"], arch
        for L, red in zip((l1, l2), want["reduced"]):
            assert dataclasses.asdict(TDR.reduced(cfg, L)) == red, arch
        for cell in LM_SHAPES:
            (legal, why), flops = want["cells"][cell.name]
            assert TDR.cell_is_legal(cfg, cell) == (legal, why), arch
            assert TDR.useful_model_flops(cfg, cell) == flops, (arch, cell)


# -- partition specs ------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_param_specs_match_reference(mesh_name):
    jm, tm = _meshes(mesh_name)
    assert TP.dp_only_rules(tm) == JP.dp_only_rules(jm)
    for arch in TC.ARCH_NAMES:
        jcfg, tcfg = j_config(arch), TC.get_config(arch)
        jd, td = JLM.param_decls(jcfg), TLM.param_decls(tcfg)
        assert TLM.sharding_rules(tcfg, tm) == JLM.sharding_rules(jcfg, jm)
        for jr, tr in ((JLM.sharding_rules(jcfg, jm),
                        TLM.sharding_rules(tcfg, tm)),
                       (JP.dp_only_rules(jm), TP.dp_only_rules(tm))):
            _specs_equal(JP.tree_pspecs(jd, jm, jr),
                         TP.tree_pspecs(td, tm, tr))
        # One rank's shard shapes, as the reference's shardings give them.
        want = JLM.abstract(jcfg, jm)
        shapes = TP.tree_shard_shapes(td, tm, TLM.sharding_rules(tcfg, tm))
        for key in ("embed", "final_norm"):
            assert shapes[key] == want[key].sharding.shard_shape(
                want[key].shape)
        for key, leaf in want["blocks"].items():
            if isinstance(leaf, dict):
                for k2, sds in leaf.items():
                    assert shapes["blocks"][key][k2] == \
                        sds.sharding.shard_shape(sds.shape), (arch, key, k2)
        # The port's abstract tree: meta tensors in init's layout, each
        # layer's spec the stacked one's without the layer entry.
        values, specs = TLM.abstract(tcfg, tm)
        stacked = TP.tree_pspecs(td, tm, TLM.sharding_rules(tcfg, tm))
        assert len(values["blocks"]) == tcfg.n_layers
        assert values["blocks"][0]["ln1"].device.type == "meta"
        assert specs["blocks"][-1]["ln1"] == stacked["blocks"]["ln1"][1:]
    d = TP.ParamDecl((7, 32), ("fsdp", "tp"))
    assert TP.partition_spec(d, None) == tuple(JP.partition_spec(
        JP.ParamDecl((7, 32), ("fsdp", "tp")), None)) == ()


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_cache_specs_match_reference(mesh_name, shape):
    jm, tm = _meshes(mesh_name)
    cell = shape_by_name(shape)
    baxes = TDR._batch_axes(tm)
    for arch in TC.ARCH_NAMES:
        jcfg, tcfg = j_config(arch), TC.get_config(arch)
        _specs_equal(_drop_length(JLM.cache_pspecs(
            jcfg, cell.global_batch, jm, batch_axes=baxes)),
            TLM.cache_pspecs(tcfg, cell.global_batch, tm, batch_axes=baxes))
        want = _drop_length(JLM.abstract_cache(
            jcfg, cell.global_batch, cell.seq_len, jm, batch_axes=baxes))
        cache, specs = TLM.abstract_cache(tcfg, cell.global_batch,
                                          cell.seq_len, tm, batch_axes=baxes)
        _specs_equal(jax.tree.map(lambda s: s.sharding.spec, want), specs)
        shapes = jax.tree.map(lambda s: tuple(s.shape), want)
        got = {k: v for k, v in cache.items() if k != "length"}

        def same(w, g):
            if isinstance(g, dict):
                for k in g:
                    same(w[k], g[k])
            elif isinstance(g, list):
                for a, b in zip(w, g):
                    same(a, b)
            else:
                assert tuple(g.shape) == tuple(w) and g.device.type == "meta"
        same(shapes, got)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("loss", ["multiclass", "multitask_mse"])
def test_gbdt_input_specs_match_reference(mesh_name, loss):
    jm, tm = _meshes(mesh_name)
    jcfg, n, m = j_gbdt_config()
    jcfg = dataclasses.replace(jcfg, loss=loss)
    tcfg = TB.GBDTConfig(**{f.name: getattr(jcfg, f.name)
                            for f in dataclasses.fields(TB.GBDTConfig)
                            if hasattr(jcfg, f.name)})
    baxes = TDR._batch_axes(tm)
    want = JD.gbdt_input_specs(n, m, jcfg.n_outputs, jm, jcfg, row_axes=baxes)
    got = TD.gbdt_input_specs(n, m, tcfg.n_outputs, tm, tcfg, row_axes=baxes)
    assert got["key"] is None and want["key"] is None
    for k in ("F", "codes", "Y"):
        t, spec = got[k]
        assert tuple(want[k].sharding.spec) == spec, k
        assert tuple(t.shape) == want[k].shape and t.device.type == "meta"
        assert str(t.dtype).removeprefix("torch.") == str(want[k].dtype)


def _reference_arg_bytes(arch, cell, jm):
    """A rank's argument bytes from the reference's abstract trees and
    their shardings (its ``length`` arrays left out)."""
    cfg = j_config(arch)

    def nbytes(tree):
        return sum(math.prod(s.sharding.shard_shape(s.shape))
                   * s.dtype.itemsize for s in jax.tree.leaves(tree))
    total = nbytes(JLM.abstract(cfg, jm))
    if cell.kind == "train":
        total += nbytes(JO.opt_abstract(
            JLM.param_decls(cfg), JT.default_opt_config(cfg), jm,
            rules=JLM.sharding_rules(cfg, jm)))
    if cell.kind == "decode":
        baxes = tuple(a for a in ("pod", "data") if a in jm.shape)
        total += nbytes(_drop_length(JLM.abstract_cache(
            cfg, cell.global_batch, cell.seq_len, jm, batch_axes=baxes)))
    total += nbytes(JT.input_specs(cfg, seq_len=cell.seq_len,
                                   global_batch=cell.global_batch,
                                   kind=cell.kind, mesh=jm))
    return total


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_argument_bytes_match_reference(mesh_name):
    jm, tm = _meshes(mesh_name)
    for arch in TC.ARCH_NAMES:
        cfg = TC.get_config(arch)
        for cell in LM_SHAPES:
            if not TDR.cell_is_legal(cfg, cell)[0]:
                continue
            got = TDR.memory(cfg, cell, tm)
            assert got["argument_bytes"] == _reference_arg_bytes(
                arch, cell, jm), (arch, cell.name)
            assert got["temp_bytes"] is None and got["peak_bytes"] is None


def test_input_specs_and_axis_ctx_on_a_mesh():
    jm, tm = _meshes("2x16x16")
    for arch in ("h2o-danube-3-4b", "musicgen-medium",
                 "llama-3.2-vision-11b"):
        jcfg, tcfg = j_config(arch), TC.get_config(arch)
        for kind in ("train", "prefill", "decode"):
            for b in (256, 1):
                want = JT.input_specs(jcfg, seq_len=64, global_batch=b,
                                      kind=kind, mesh=jm)
                batch, specs = TT.input_specs(tcfg, seq_len=64,
                                              global_batch=b, kind=kind,
                                              mesh=tm)
                assert set(specs) == set(want) == set(batch)
                for k, s in want.items():
                    assert tuple(s.sharding.spec) == specs[k], (arch, k)
        for dp_only in (False, True):
            jc = dataclasses.replace(jcfg, tp_strategy="dp_only"
                                     if dp_only else "tp")
            tc = dataclasses.replace(tcfg, tp_strategy=jc.tp_strategy)
            from repro.training.train_lib import make_axis_ctx
            w, g = make_axis_ctx(jm, jc), TT.make_axis_ctx(tm, tc)
            assert (w.batch_axes, w.model_axis) == (g.batch_axes,
                                                    g.model_axis)
            assert TDR._batch_axes(tm, tc) == w.batch_axes
    assert TT.batch_sharding(None) is None
    assert TT.make_axis_ctx(None, TC.get_config("gemma-7b")).mesh is None
    # A step runs on a mesh of ranks (`tests/test_torch_mesh_train.py`);
    # an abstract mesh, the dry run's, has none.
    with pytest.raises(ValueError, match="no ranks"):
        TT.make_train_step(TC.get_config("gemma-7b"), TT.TrainConfig(),
                           mesh=tm)


def test_production_meshes_are_the_reference_shapes():
    for multi in (False, True):
        m = TM.make_production_mesh(multi_pod=multi)
        jm, tm = _meshes("2x16x16" if multi else "16x16")
        assert (m.shape, m.axes, m.size) == (tm.shape, tm.axes, jm.size)
        assert TP.mesh_axes(m) == dict(jm.shape)


# -- the roofline's arithmetic and the report -------------------------------------

def test_extrapolate_and_terms_match_reference(monkeypatch):
    rng = np.random.default_rng(0)
    for _ in range(50):
        v1, v2 = (float(x) for x in rng.uniform(0, 1e15, 2))
        l1 = int(rng.integers(1, 4))
        l2 = l1 * int(rng.integers(1, 3))
        full = int(rng.integers(1, 130))
        assert TRA.extrapolate(v1, v2, l1, l2, full) == JRA.extrapolate(
            v1, v2, l1, l2, full)
    monkeypatch.setattr(TRA, "PEAK_FLOPS", JRA.PEAK_FLOPS)
    monkeypatch.setattr(TRA, "HBM_BW", JRA.HBM_BW)
    monkeypatch.setattr(TRA, "link_bw", lambda chips: JRA.ICI_BW)
    for args in ((3.8e16, 9.5e13, 3.5e13, 256, 2.6e16), (0.0, 0.0, 0.0, 1),
                 (1e12, 5e12, 0.0, 1, 7e11), (2e12, 1e9, 9e15, 512, 1e12)):
        assert TRA.RooflineTerms(*args).to_dict() == \
            JRA.RooflineTerms(*args).to_dict()
    assert TRA.model_flops_train(7, 11) == JRA.model_flops_train(7, 11)
    assert TRA.model_flops_decode(7, 11) == JRA.model_flops_decode(7, 11)
    rows = [{"a": 1, "b": "xx"}, {"a": 22}]
    assert TRA.format_table(rows, ["a", "b"]) == JRA.format_table(rows,
                                                                  ["a", "b"])


def test_h100_constants():
    assert (TRA.PEAK_FLOPS, TRA.HBM_BW) == (989e12, 3.35e12)
    assert TRA.link_bw(256) == TRA.link_bw(512) == TRA.NET_BW
    assert TRA.link_bw(1) == TRA.link_bw(8) == TRA.NVLINK_BW > TRA.NET_BW


def test_report_prints_the_reference_text():
    recs = [{"arch": "a", "shape": "s", "status": "ok",
             "full": {"compile_s": 1.0,
                      "memory": {"temp_bytes": 2e9, "argument_bytes": 1e9},
                      "collectives": {"count": {"all-reduce": 3,
                                                "all-gather": 2}}},
             "roofline": {"t_compute_s": 0.1, "t_memory_s": 0.2,
                          "t_collective_s": 0.05, "bottleneck": "memory",
                          "useful_fraction": 0.8,
                          "roofline_fraction": 0.4}},
            {"arch": "b", "shape": "t", "status": "FAIL: RuntimeError: x" * 3,
             "full": {}},
            {"arch": "c", "shape": "u", "status": "ok",
             "full": {"compile_s": 0.5, "memory": {"temp_bytes": None,
                                                   "argument_bytes": 12.0}},
             "roofline": {"t_compute_s": 2e-7, "t_memory_s": 3.0,
                          "t_collective_s": 0.0, "bottleneck": "memory",
                          "useful_fraction": 0.0,
                          "roofline_fraction": 0.0}}]
    assert TRR.dryrun_table(recs) == JRR.dryrun_table(recs)
    assert TRR.roofline_table(recs) == JRR.roofline_table(recs)
    for x in (None, 0.0, 3e-7, 0.002, 5.0, 12.0, 3e6, 4e9, 7e12):
        assert TRR.fmt_t(x) == JRR.fmt_t(x)
        assert TRR.fmt_b(x) == JRR.fmt_b(x)
    port = [{"arch": "a", "shape": "s", "status": "ok",
             "full": {"count_s": 2.5, "memory": {"argument_bytes": 1e9}}}]
    assert "| a | s | ok | 2.5 | - | 1.0GB | - |" in TRR.dryrun_table(port)


# -- the counter -----------------------------------------------------------------

def _narrow_dense(remat):
    return dataclasses.replace(
        TC.smoke_config("h2o-danube-3-4b"), n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
        window=16, dtype="float32", remat=remat, microbatches=1)


def _pairs(sq, sk, causal, window):
    """Seen (query, key) pairs of one head, by brute force."""
    q = np.arange(sq)[:, None]
    k = np.arange(sk)[None, :]
    seen = np.ones((sq, sk), bool)
    if causal:
        seen &= k <= q
    if window:
        seen &= q - k < window
    return int(seen.sum())


@pytest.mark.parametrize("remat", [False, True])
def test_counted_flops_of_a_train_step_are_the_closed_form(remat):
    cfg = _narrow_dense(remat)
    b, s = 2, 32
    T, D, F, V = b * s, cfg.d_model, cfg.d_ff, cfg.padded_vocab
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    layer = (2 * T * D * hq * dh + 2 * 2 * T * D * hkv * dh
             + 2 * T * hq * dh * D + 3 * 2 * T * D * F)
    head = 2 * T * D * V
    pairs = b * hq * _pairs(s, s, True, cfg.window)
    # Forward and the backward's two products of each matmul; under remat
    # each layer's forward again up to its last product (the MLP's ``wo``:
    # torch.utils.checkpoint stops recomputing once the tensors the
    # backward saved are back); B7's forward (float32: 4 dh a pair) once a
    # layer and again under remat, its backward (the gradient's 5 products
    # of 2 dh; the CUDA-core design's 7 beside it) once.
    recompute = layer - 2 * T * F * D
    want = (3 * (cfg.n_layers * layer + head) + remat * cfg.n_layers * recompute
            + cfg.n_layers * (1 + remat) * 4 * dh * pairs
            + cfg.n_layers * 10 * dh * pairs)
    params = TLM.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    from repro_torch.training import optimizer as TO
    tcfg = TT.TrainConfig(opt=TO.OptConfig(name="adamw"))
    state = TO.opt_init(params, tcfg.opt)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)))
             for k in ("inputs", "labels")}
    counter = TRA.Counter()
    with counter:
        TT.make_train_step(cfg, tcfg)(params, state, batch, 0)
    assert counter.flops == want
    k = counter.kernels
    assert k["flash_attention"]["calls"] == cfg.n_layers * (1 + remat)
    assert k["flash_attention_bwd"]["calls"] == cfg.n_layers
    assert k["flash_attention_bwd"]["design_flops"] == \
        cfg.n_layers * 14 * dh * pairs
    assert counter.hbm_bytes > 0


def _only(counter, name, flops, n_bytes, host_check_bytes=0):
    """The counter holds exactly one call of ``name`` and nothing of the
    plain body: only the wrapper's own checks' ops beside it."""
    assert set(counter.kernels) == {name}
    k = counter.kernels[name]
    assert (k["calls"], k["flops"], k["bytes"]) == (1, flops, n_bytes)
    assert (counter.flops, counter.hbm_bytes) == (flops, n_bytes
                                                  + host_check_bytes)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_wrappers_report_their_formulas(dtype):
    g = torch.Generator().manual_seed(0)
    b, hq, hkv, sq, sk, dh, win = 2, 4, 2, 40, 40, 16, 9
    q, do = (torch.randn((b, hq, sq, dh), generator=g).to(dtype)
             for _ in range(2))
    k, v = (torch.randn((b, hkv, sk, dh), generator=g).to(dtype)
            for _ in range(2))
    sz = q.element_size()
    pairs = b * hq * _pairs(sq, sk, True, win)
    fwd_bytes = sz * (2 * b * hq * sq * dh + 2 * b * hkv * sk * dh)
    per_pair = 8 * dh if dtype == torch.bfloat16 else 4 * dh
    with TRA.Counter() as c:
        FA.flash_attention(q, k, v, causal=True, window=win)
    _only(c, "flash_attention", per_pair * pairs, fwd_bytes)
    with TRA.Counter() as c:
        o, lse = FA.flash_attention_lse(q, k, v, causal=True, window=win)
    _only(c, "flash_attention", per_pair * pairs,
          fwd_bytes + 4 * b * hq * sq)
    with TRA.Counter() as c:
        FA.flash_attention_bwd(q, k, v, o, lse, do, causal=True, window=win)
    _only(c, "flash_attention_bwd", 10 * dh * pairs,
          sz * (4 * b * hq * sq * dh + 4 * b * hkv * sk * dh)
          + 4 * b * hq * sq)
    design = 13 if dtype == torch.bfloat16 else 7
    assert c.kernels["flash_attention_bwd"]["design_flops"] == \
        design * 2 * dh * pairs
    # Under grad the CPU path goes through FlashAttention too, and its
    # gradients are the plain backward's.
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    with TRA.Counter() as c:
        out = FA.flash_attention(qg, kg, vg, causal=True, window=win)
        grads = torch.autograd.grad(out, (qg, kg, vg), do)
    assert {n: c.kernels[n]["calls"] for n in c.kernels} == {
        "flash_attention": 1, "flash_attention_bwd": 1}
    want = FA.flash_attention_bwd(q, k, v, o, lse, do, causal=True,
                                  window=win)
    for a, w in zip(grads, want):
        assert torch.equal(a, w)
    # B8: lengths as an int and as a tensor, cut to the window.
    qd = torch.randn((b, hq, dh), generator=g).to(dtype)
    kc, vc = (torch.randn((b, 30, hkv, dh), generator=g).to(torch.bfloat16)
              for _ in range(2))
    # A tensor's lengths are checked by a min and a max (int64: 2 x 8 bytes
    # read, 8 written each).
    for lengths, window, seen, check in (
            (25, 12, b * 12, 0), (torch.tensor([5, 30]), 12, 5 + 12, 48),
            (torch.tensor([5, 30]), None, 5 + 30, 48)):
        with TRA.Counter() as c:
            DA.decode_attention(qd, kc, vc, lengths, window=window)
        _only(c, "decode_attention", 4 * dh * hq * seen,
              2 * 2 * seen * hkv * dh + 2 * sz * b * hq * dh, check)


def test_gbdt_wrappers_report_their_formulas():
    g = torch.Generator().manual_seed(1)
    n, m, B, C = 96, 5, 16, 4
    codes = torch.randint(0, B, (n, m), generator=g,
                          dtype=torch.int32).to(torch.uint8)
    codes_t = codes.t().contiguous()
    order = torch.randperm(n, generator=g).to(torch.int32)
    stats = torch.rand((n, C), generator=g)
    counts = torch.tensor([60, 36], dtype=torch.int32)
    build = torch.tensor([0, 36], dtype=torch.int32)
    for dt, name in ((torch.float32, "hist_nodes"),
                     (torch.bfloat16, "hist_nodes_bf16")):
        stats_dt = stats.to(dt)
        with TRA.Counter() as c:
            hist = hist_kernel.hist_nodes(
                codes_t, order, stats_dt, counts, build, n_bins=B,
                hist_dtype="bfloat16" if dt == torch.bfloat16
                else "float32")
        # On the CPU the wrapper checks order's max (n int32 read, one
        # written) and counts' sum (2 int32 read, one int64 written).
        _only(c, name, 36 * m * C, 36 * (m + 4 + (2 if dt == torch.bfloat16
                                                  else 4) * C)
              + 2 * m * B * C * 4, 4 * n + 4 + 8 + 8)
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0, 0.0])
    with TRA.Counter() as c:
        split_kernel.split_scan(hist, 1.0, 1.0, mask)
    _only(c, "split_scan", 2 * 3 * B * (4 * C + 12),
          2 * 3 * B * C * 4 + m * 4 + 2 * 8)
    T, depth, W = 3, 3, 4
    N = 2 ** depth - 1
    feat = torch.randint(0, m, (T, N), generator=g, dtype=torch.int32)
    thr = torch.randint(0, B, (T, N), generator=g, dtype=torch.int32)
    value = torch.randn((T, 2 ** depth, W), generator=g)
    from repro_torch.core.tree import heap_to_node_arrays
    feat, thr, left, right, leaf = heap_to_node_arrays(feat, thr, value)
    # The nodes the rows step through and end at, by a numpy walk.
    fa, ta, la, ra = (x.numpy() for x in (feat, thr, left, right))
    read, reached = set(), set()
    for t in range(T):
        for row in codes.numpy():
            pos = 0
            for _ in range(depth):
                read.add((t, pos))
                pos = ra[t, pos] if row[fa[t, pos]] > ta[t, pos] \
                    else la[t, pos]
            reached.add((t, pos))
    F0, cols = torch.zeros((n, W)), torch.zeros(T, dtype=torch.int32)
    with TRA.Counter() as c:
        predict_kernel.forest_traverse(F0, codes, feat, thr, left, right,
                                       leaf, cols, 0.1, depth=depth)
    _only(c, "forest_traverse", 2 * n * T * W,
          8 * n * W + n * m + 16 * len(read) + 4 * W * len(reached) + 4 * T)


def test_counter_rules_for_views_gathers_and_scatters():
    x = torch.randn(1000, 64)
    idx = torch.tensor([3, 7, 11])
    cases = [
        (lambda: x.t().reshape(64, 1000)[:, :10], None),   # clone of a view
        (lambda: x[idx], 3 * 8 + 2 * 3 * 64 * 4),
        (lambda: torch.nn.functional.embedding(idx, x), 3 * 8 + 2 * 3 * 64 * 4),
        (lambda: x.index_select(0, idx), 3 * 8 + 2 * 3 * 64 * 4),
        (lambda: x.view(10, 100, 64).transpose(0, 1), 0),
        (lambda: x.clone().index_add_(0, idx, torch.ones(3, 64)), None),
    ]
    for fn, want in cases:
        with TRA.Counter() as c:
            fn()
        if want is not None:
            assert c.hbm_bytes == want
    y, row, rows = torch.zeros(1000, 64), torch.ones(64), torch.ones(3, 64)
    with TRA.Counter() as c:
        y[5] = row                            # a slot written: 64 elements
    assert c.hbm_bytes == 2 * 64 * 4
    with TRA.Counter() as c:
        y.index_add_(0, idx, rows)
    assert c.hbm_bytes == 3 * 8 + 3 * 64 * 4 + 2 * 3 * 64 * 4
    with TRA.Counter() as c:
        y[idx] = rows
    assert c.hbm_bytes == 3 * 8 + 3 * 64 * 4 + 3 * 64 * 4
    with TRA.Counter() as c:
        torch.ones(4) + 1.0                   # a fill and one pass
    assert c.hbm_bytes == 16 + 16 + 16


# -- end to end --------------------------------------------------------------------

def test_run_cell_smoke_end_to_end():
    rec = TDR.run_cell("h2o-danube-3-4b", "train_4k", smoke=True)
    assert rec["status"] == "ok", rec.get("traceback")
    full, rl = rec["full"], rec["roofline"]
    assert full["chips"] == 256 and full["memory"]["argument_bytes"] > 0
    # Every layer adds the same work: the two probes extrapolate to the
    # full depth's count.
    for k in ("flops", "hbm_bytes", "collective_bytes"):
        assert rl[k] == pytest.approx(full[k], rel=1e-9), k
    assert full["kernels"]["flash_attention_bwd"]["calls"] == \
        TC.smoke_config("h2o-danube-3-4b").n_layers
    assert set(full["collectives"]["count"]) == {"all-gather",
                                                 "reduce-scatter",
                                                 "all-reduce"}
    assert "| h2o-danube-3-4b | train_4k | ok |" in TRR.dryrun_table([rec])


def test_run_gbdt_cut_rows_end_to_end():
    rows = (2048, 4096)
    rec = TDR.run_gbdt(probe_rows=rows)
    assert rec["status"] == "ok", rec.get("traceback")
    full = rec["full"]
    cfg, n, m = TC.get_gbdt_config()
    moved = TD.round_collective_bytes(cfg, m, cfg.n_outputs)["moved_bytes"]
    assert full["collectives"]["count"] == {"all-reduce": cfg.depth}
    assert full["collectives"]["bytes"]["all-reduce"] == int(
        2 * 15 / 16 * moved)
    assert full["memory"]["argument_bytes"] == (
        n * cfg.n_outputs * 4 // 256 + n * m // 16 + n * 4 // 16)
    assert full["flops"] > 0 and full["hbm_bytes"] > 0
    assert full["kernels"]["hist_nodes"]["calls"] == cfg.depth
    assert full["probe_rows"] == list(rows)


def test_collective_closed_form_by_hand():
    """`lm_collectives` on a one-layer model worked out by hand on the
    16 x 16 mesh: every matrix FSDP-sharded over ``data`` (16 ranks) and
    tensor-parallel over ``model`` (16), the norms replicated."""
    cfg = dataclasses.replace(
        TC.get_config("h2o-danube-3-4b"), n_layers=1, d_model=256,
        n_heads=16, n_kv_heads=16, head_dim=16, d_ff=512, vocab_size=256,
        window=None, remat=True)
    _, tm = _meshes("16x16")
    # bf16 shards: embed (16, 16), wq/wk/wv/wo (16, 16), wi/wg/wo (16, 32);
    # float32 norms (256,) whole.
    embed, attn, mlp, norm = 512, 4 * 512, 3 * 1024, 1024
    train = TRA.lm_collectives(cfg, "train", 4096, 256, tm)
    # All-gathers: the (tied) embedding once, a layer's 7 matrices in the
    # forward and again in the remat'd forward (the gathered weights serve
    # the backward); reduce-scatters: each gradient; all-reduces: the 3
    # norms' gradients over data; the attention's and the MLP's
    # row-parallel products in the forward, the attention's again in the
    # remat'd forward (which stops before the MLP's, the block's last),
    # and their inputs' gradients, the lookup's sum and the head
    # input's gradient, all (16, 4096, 256) bf16 activations over model;
    # the log-softmax's max, sum and label logit (float32, one a token);
    # the loss weights' sum and the loss over data; the global norm's
    # one set of axes, {data, model}.
    act = 16 * 4096 * 256 * 2
    tok = 16 * 4096 * 4
    ar = 2 * 15 / 16
    assert train.count_by_op == {"all-gather": 1 + 7 * 2,
                                 "reduce-scatter": 8,
                                 "all-reduce": 3 + 7 + 3 + 2 + 2}
    assert train.bytes_by_op == {
        "all-gather": 15 * (embed + 2 * (attn + mlp)),
        "reduce-scatter": 15 * (embed + attn + mlp),
        "all-reduce": int(ar * (3 * norm + 7 * act + 3 * tok + 4 * 4))}
    decode = TRA.lm_collectives(cfg, "decode", 4096, 128, tm)
    assert decode.count_by_op == {"all-gather": 8, "all-reduce": 3}
    assert decode.bytes_by_op == {
        "all-gather": 15 * (embed + attn + mlp),
        "all-reduce": int(3 * ar * (8 * 256 * 2))}
    # Experts sharded over model exchange their tokens (dispatch and
    # combine in each of three passes: the remat'd forward reads the
    # combine's output); grok-1's 8 experts do not divide
    # over 16 and stay whole.
    phi, grok = (TC.get_config(a) for a in ("phi3.5-moe-42b-a6.6b",
                                            "grok-1-314b"))
    assert TRA.lm_collectives(phi, "train", 4096, 256, tm).count_by_op[
        "all-to-all"] == 6 * phi.n_layers
    assert "all-to-all" not in TRA.lm_collectives(
        grok, "train", 4096, 256, tm).count_by_op
