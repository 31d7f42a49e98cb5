"""Port vs reference: the serving path.

Forest surgery (quantize, dequantize, prune, compact, slice) is held bitwise
to the JAX package's functions on a JAX-fitted forest.  B5's plain version
(`ref.forest_apply_quant_ref`) is held bitwise to a numpy replay of its own
three roundings and to `ref.forest_apply_ref` on the dequantized twin; the
reference's oracle is held to its own replay, in which XLA's CPU backend
contracts ``acc + lr * deq`` into one rounding (as for B3, see
tests/test_torch_forest.py), and the two sides differ by at most one
rounding step per tree.  `ForestServer` of both packages, built from one
checkpoint, must agree on predictions (atol 1e-4), on SHAP attributions
(atol 1e-5 + rtol 1e-5, see tests/test_torch_explain.py), on every
``stats`` counter and on the compression record.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import boosting as JB
from repro.core import forest as JF
from repro.core import quantize as JQ
from repro.data.pipeline import make_tabular
from repro.io import checkpoint as JC
from repro.kernels import ref as JR
from repro.runtime.chaos import VirtualClock as JClock
from repro.training import serve_lib as JS
from repro_torch import explain as TEX
from repro_torch.core import forest as TF
from repro_torch.core import quantize as TQ
from repro_torch.io import convert
from repro_torch.kernels import predict_quant_kernel, ref as TR
from repro_torch.launch import serve as launch_serve
from repro_torch.runtime.chaos import VirtualClock as TClock
from repro_torch.training import serve_lib as TS
from test_explain import save_legacy_heap_checkpoint
from test_torch_checkpoint import _bits, assert_same_forest

N_TREES, DEPTH, D, M = 6, 4, 5, 8


@pytest.fixture(scope="module")
def fitted():
    X, y = make_tabular("multiclass", 700, M, D, seed=21)
    cfg = JB.GBDTConfig(n_trees=N_TREES, depth=DEPTH, sketch_k=2,
                        use_kernel="jnp", loop="python")
    return JB.SketchBoost(cfg).fit(X, y), X


@pytest.fixture(scope="module")
def ckpt(fitted, tmp_path_factory):
    jm, _ = fitted
    root = str(tmp_path_factory.mktemp("serve_ckpt"))
    JC.save_forest_checkpoint(root, jm.packed, jm.quantizer,
                              metadata={"loss": "multiclass"})
    return root


def _port(jpf):
    """A JAX forest (float32 or quantized) carried over to the port."""
    arrays = {k: (None if v is None else _bits(v))
              for k, v in jpf._asdict().items() if k != "depth"}
    if getattr(jpf, "leaf_scale", None) is None:
        return convert.packed_forest_from_arrays(arrays, depth=jpf.depth,
                                                 device="cpu")
    return convert.quantized_forest_from_arrays(arrays, depth=jpf.depth,
                                                device="cpu")


def _codes(jm, X):
    return np.array(JQ.apply_quantizer(jm.quantizer, jnp.asarray(X)))


# -- forest surgery, bitwise --------------------------------------------------

@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_quantize_and_dequantize_match_reference(fitted, dtype):
    jm, _ = fitted
    jq = JQ.quantize_forest(jm.packed, dtype)
    tq = TQ.quantize_forest(_port(jm.packed), dtype)
    assert_same_forest(tq, jq)
    assert_same_forest(_port(jq), jq)                 # convert carries it
    assert_same_forest(TQ.dequantize_forest(tq), JQ.dequantize_forest(jq))
    assert tq.nbytes == jq.nbytes


@pytest.mark.parametrize("alpha", [0.0, 1e9])
def test_prune_and_compact_match_reference(fitted, alpha):
    jm, _ = fitted
    jp = JF.prune_forest(jm.packed, alpha)
    tp = TF.prune_forest(_port(jm.packed), alpha)
    assert_same_forest(tp, jp)
    jc, tc = JF.compact_forest(jp), TF.compact_forest(tp)
    assert_same_forest(tc, jc)
    assert tc.n_nodes % 8 == 0
    if alpha > 0:                        # every tree collapses to a stump
        assert tc.depth == 1 and tc.n_nodes == 8
    # Compaction of a quantized forest keeps its leaf dtype.
    jqc = JF.compact_forest(JQ.quantize_forest(jp, "bfloat16"))
    assert_same_forest(TF.compact_forest(TQ.quantize_forest(tp, "bfloat16")),
                       jqc)


def test_slice_rounds_tighten_depth_matches_reference(fitted):
    jm, _ = fitted
    jc = JF.compact_forest(JF.prune_forest(jm.packed, 0.0))
    tc = _port(jc)
    for rounds in (1, 3, N_TREES):
        assert_same_forest(TF.slice_rounds(tc, rounds, tighten_depth=True),
                           JF.slice_rounds(jc, rounds, tighten_depth=True))
    jq = JQ.quantize_forest(jm.packed, "int8")
    assert_same_forest(TF.slice_rounds(_port(jq), 2),
                       JF.slice_rounds(jq, 2))


def test_forest_properties_match_reference(fitted):
    jm, _ = fitted
    for jpf in (jm.packed, JF.compact_forest(JF.prune_forest(jm.packed, 0.0))):
        tpf = _port(jpf)
        assert (tpf.n_nodes, tpf.n_rounds, tpf.is_heap) == (
            jpf.n_nodes, jpf.n_rounds, jpf.is_heap)
    assert TF._pointer_max_depth(np.asarray(jm.packed.left),
                                 np.asarray(jm.packed.right)) == DEPTH


# -- B5's plain version ----------------------------------------------------------

def _replay(jq, codes, F0, cols, lr):
    """The reference's walk (``ref.node_walk_ref``) and dequantizing add,
    replayed in numpy: ``(three_roundings, fused)`` float32 results, the
    second with ``acc + lr * deq`` rounded once."""
    lr = np.float32(lr)
    deq = (_bits(jq.leaf).astype(np.float32) if jq.leaf.dtype == jnp.int8
           else (_bits(jq.leaf).astype(np.uint32) << 16).view(np.float32))
    deq = deq * np.asarray(jq.leaf_scale)[:, :, None]
    three, fused = F0.copy(), F0.copy()
    w = deq.shape[2]
    for t, col in enumerate(cols):
        pos = np.asarray(JR.node_walk_ref(
            jq.feat[t], jq.thr[t].astype(jnp.int32), jq.left[t],
            jq.right[t], jnp.asarray(codes), depth=jq.depth))
        v = deq[t][pos]
        three[:, col:col + w] = three[:, col:col + w] + lr * v
        fused[:, col:col + w] = (fused[:, col:col + w].astype(np.float64)
                                 + np.float64(lr) * v.astype(np.float64)
                                 ).astype(np.float32)
    return three, fused


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("width", [D, 1])
def test_quant_traversal_plain_version(fitted, dtype, width):
    jm, X = fitted
    jq = JQ.quantize_forest(jm.packed, dtype)
    if width < D:                        # narrow blocks at per-tree columns
        jq = jq._replace(leaf=jq.leaf[:, :, :width],
                         out_col=jnp.asarray(np.arange(N_TREES) % D,
                                             jnp.int32))
    tq = _port(jq)
    codes = _codes(jm, X)
    cols = np.asarray(jq.out_col).tolist()
    F0 = np.random.default_rng(3).normal(size=(len(X), D)).astype(np.float32)
    lr = float(np.asarray(jq.lr))
    got = predict_quant_kernel.forest_traverse_quant(
        torch.from_numpy(F0.copy()), torch.from_numpy(codes), tq.feat,
        tq.thr, tq.left, tq.right, tq.leaf, tq.leaf_scale, tq.out_col, lr,
        depth=tq.depth).numpy()
    want = np.asarray(JR.forest_apply_quant_ref(
        jnp.asarray(F0), jnp.asarray(codes), jq.feat, jq.thr, jq.left,
        jq.right, jq.leaf, jq.leaf_scale, jq.out_col, jnp.float32(lr),
        depth=jq.depth))
    three, fused = _replay(jq, codes, F0, cols, lr)
    np.testing.assert_array_equal(got, three)          # the port: bitwise
    twin = TQ.dequantize_forest(tq)
    np.testing.assert_array_equal(got, TR.forest_apply_ref(
        torch.from_numpy(F0.copy()), torch.from_numpy(codes), twin.feat,
        twin.thr, twin.left, twin.right, twin.leaf, twin.out_col, lr,
        depth=twin.depth).numpy())
    np.testing.assert_array_equal(want, fused)         # the oracle: FMA
    bound = (np.abs(F0).max()
             + N_TREES * abs(lr) * float(twin.leaf.abs().max()))
    assert np.abs(got - want).max() <= N_TREES * np.spacing(np.float32(bound))


@pytest.mark.parametrize("quantize", ["none", "int8"])
@pytest.mark.parametrize("row_chunk", [7, 64, 5000])
def test_predict_raw_pipelined_bitwise(fitted, quantize, row_chunk):
    jm, X = fitted
    pf = _port(jm.packed)
    if quantize != "none":
        pf = TQ.quantize_forest(pf, quantize)
    codes = torch.from_numpy(_codes(jm, X))
    want = TF.predict_raw(pf, codes)
    assert torch.equal(TF.predict_raw_pipelined(pf, codes,
                                                row_chunk=row_chunk), want)
    assert torch.equal(TF.predict_raw_pipelined(pf, codes.numpy(),
                                                row_chunk=row_chunk), want)


@pytest.mark.parametrize("row_chunk", [7, 5000])
def test_predict_raw_pipelined_bins_features(fitted, row_chunk):
    """With ``prepare``, raw features are binned chunk by chunk; the scores
    equal `predict_raw` of the reference's codes, bitwise."""
    jm, X = fitted
    pf = TQ.quantize_forest(_port(jm.packed), "bfloat16")
    q = convert.quantizer_from_edges(np.asarray(jm.quantizer.edges),
                                     int(jm.quantizer.n_bins), device="cpu")
    got = TF.predict_raw_pipelined(
        pf, X, row_chunk=row_chunk,
        prepare=lambda x: TQ.codes_rows(TQ.apply_quantizer(q, x)))
    assert torch.equal(got, TF.predict_raw(pf,
                                           torch.from_numpy(_codes(jm, X))))


# -- ForestServer: port and reference from one checkpoint ----------------------

def _stats(server):
    return {k: v for k, v in server.stats.items() if k != "predict_time_s"}


def _servers(ckpt, **kw):
    jclock, tclock = JClock(), TClock()
    j = JS.ForestServer.from_checkpoint(ckpt, clock=jclock, **kw)
    t = TS.ForestServer.from_checkpoint(ckpt, clock=tclock, device="cpu",
                                        **kw)
    return j, t, jclock, tclock


def _assert_servers_agree(j, t, got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-4)
    assert _stats(t) == _stats(j)
    assert t.compression == j.compression
    assert t.buckets.stats() == j.buckets.stats()


def _requests(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(s, M)).astype(np.float32) for s in sizes]


@pytest.mark.parametrize("quantize,prune_alpha", [("none", None),
                                                  ("int8", 0.0),
                                                  ("bfloat16", None)])
def test_serve_matches_reference(ckpt, quantize, prune_alpha):
    j, t, _, _ = _servers(ckpt, quantize=quantize, prune_alpha=prune_alpha,
                          max_batch=64, max_buckets=2)
    # Buckets 8, 32, 8 (hit), 64 (evicts 8), 16 (upgrades to 32); the last
    # batch is over max_batch and streams.
    for sizes in ([3, 5], [20, 12], [1], [50], [10], [40, 30]):
        reqs = _requests(sum(sizes), sizes)
        _assert_servers_agree(j, t, t.serve(reqs), j.serve(reqs))
    assert t.quantized == j.quantized
    assert t.stats["bucket_upgrades"] + t.stats["bucket_evictions"] > 0


@pytest.mark.parametrize("double_buffer", [False, True])
def test_streamed_batch_matches_reference(ckpt, fitted, double_buffer):
    jm, X = fitted
    j, t, _, _ = _servers(ckpt, quantize="int8", max_batch=32, row_chunk=48,
                          double_buffer=double_buffer)
    got, want = t.predict_raw(X), j.predict_raw(X)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert _stats(t) == _stats(j)
    assert t.stats["pipelined_batches"] == int(double_buffer)
    # Bitwise to the port's own B5 traversal of the served forest.
    assert torch.equal(got, TF.predict_raw(
        t.packed, torch.from_numpy(_codes(jm, X))))


def test_admission_control_matches_reference(ckpt):
    """Shedding, a deadline drop and the overload fallback under virtual
    clocks, step for step in both packages."""
    j, t, jclock, tclock = _servers(ckpt, max_queue_rows=40, deadline_ms=50.0,
                                    overload_rows=16)
    reqs = _requests(5, [10] * 6)
    assert [t.submit(r) for r in reqs] == [j.submit(r) for r in reqs]
    assert t.queue_depth == j.queue_depth == 40
    _assert_servers_agree(j, t, t.drain(), j.drain())
    for srv, clock in ((t, tclock), (j, jclock)):
        srv.submit(reqs[0], deadline_ms=10.0)
        srv.submit(reqs[1], deadline_ms=500.0)
        clock.advance(0.1)
    got, want = t.drain(), j.drain()
    assert got[0] is None and got[1] is not None
    _assert_servers_agree(j, t, got, want)
    assert t.stats["fallback_batches"] == 1 and t.stats["shed_requests"] == 2
    assert t._fallback_packed().n_rounds == j._fallback_packed().n_rounds
    # serve() goes through submit/drain when admission knobs are set.
    _assert_servers_agree(j, t, t.serve(reqs[:2]), j.serve(reqs[:2]))


def test_registry_matches_reference(ckpt):
    regs = (JS.ModelRegistry(max_buckets=3),
            TS.ModelRegistry(max_buckets=3, device="cpu"))
    for reg in regs:
        reg.load("fp32", ckpt)
        reg.load("int8", ckpt, quantize="int8")
        reg.load("int8_b", ckpt, quantize="int8")
        reg.load("pruned", ckpt, quantize="int8", prune_alpha=0.0)
    jreg, treg = regs
    assert treg.names() == jreg.names() and len(treg) == 4
    assert (sorted(treg.shared_signatures().values())
            == sorted(jreg.shared_signatures().values()))
    for name, sizes in (("fp32", [5, 9]), ("int8", [30]), ("int8_b", [2]),
                        ("pruned", [17, 3])):
        reqs = _requests(len(sizes), sizes)
        for a, b in zip(treg.serve(name, reqs), jreg.serve(name, reqs)):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-4)
    ts, js = treg.stats(), jreg.stats()
    assert ts["bucket_cache"] == js["bucket_cache"]
    for name in jreg.names():
        t_m, j_m = ts["models"][name], js["models"][name]
        t_m["stats"].pop("predict_time_s")
        j_m["stats"].pop("predict_time_s")
        assert (t_m["stats"], t_m["compression"]) == (j_m["stats"],
                                                      j_m["compression"])
    with pytest.raises(KeyError, match="no model"):
        treg.get("missing")


def test_explain_endpoints_name_their_slice(ckpt):
    """The explain endpoints, which the serving slice left as stubs naming
    the explain slice, now answer; the float32 twin of a quantized server
    predicts as it does."""
    t = TS.ForestServer.from_checkpoint(ckpt, device="cpu")
    X = _requests(0, [4])[0]
    phi, base = t.explain(X)
    assert phi.shape == (4, M, D) and base.shape == (D,)
    [(phi1, base1)] = t.serve_explain([X])
    np.testing.assert_array_equal(phi1, phi)
    assert t.feature_importances().shape == (M,)
    q = TS.ForestServer.from_checkpoint(ckpt, device="cpu",
                                        quantize="bfloat16")
    codes = q._codes(X)
    assert torch.equal(TF.predict_raw(q.explain_packed, codes),
                       q.predict_codes(codes))


def _explain_stats(server):
    return {k: v for k, v in server.stats.items()
            if not k.endswith("_time_s")}


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_forest_server_explain_matches_reference(ckpt, fitted, quantize):
    """`ForestServer.explain` / `serve_explain` / `feature_importances` of
    both packages on one checkpoint: attributions within the tolerance of
    tests/test_torch_explain.py, equal stats and bucket records, a split
    per request equal to the joint call."""
    jm, X = fitted
    j, t, _, _ = _servers(ckpt, quantize=quantize, max_batch=64,
                          max_buckets=2, row_chunk=48)
    for rows in (X[:11], X[:40], X[:150]):         # buckets 16, 64, streamed
        (tphi, tbase), (jphi, jbase) = t.explain(rows), j.explain(rows)
        np.testing.assert_allclose(tphi, np.asarray(jphi), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(tbase, np.asarray(jbase), atol=1e-5,
                                   rtol=1e-5)
        assert _explain_stats(t) == _explain_stats(j)
        assert t.buckets.stats() == j.buckets.stats()
    reqs = [X[s:s + n] for s, n in ((0, 1), (10, 5), (40, 9))]
    outs, jouts = t.serve_explain(reqs), j.serve_explain(reqs)
    assert [o[0].shape[0] for o in outs] == [1, 5, 9]
    joint, _ = t.explain(np.concatenate(reqs))
    j.explain(np.concatenate(reqs))
    np.testing.assert_array_equal(np.concatenate([o[0] for o in outs]),
                                  joint)
    for (a, _), (b, _) in zip(outs, jouts):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=1e-5)
    assert _explain_stats(t) == _explain_stats(j)
    assert t.stats["explain_requests"] == 3
    for kind in ("gain", "cover", "split_count"):
        imp = t.feature_importances(kind)
        np.testing.assert_array_equal(imp, np.asarray(
            j.feature_importances(kind)))
        np.testing.assert_allclose(imp.sum(), 1.0, rtol=1e-6)
    reg = TS.ModelRegistry(device="cpu")
    reg.register("m", t)
    np.testing.assert_array_equal(reg.explain("m", X[:11])[0],
                                  t.explain(X[:11])[0])


def test_quantized_server_explains_its_twin(ckpt, fitted):
    """An int8 server explains its dequantized twin: local accuracy holds
    against its own predictions, and its attributions are the twin's."""
    _, X = fitted
    t = TS.ForestServer.from_checkpoint(ckpt, device="cpu", quantize="int8",
                                        prune_alpha=0.0)
    phi, base = t.explain(X[:50])
    np.testing.assert_allclose(base + phi.sum(1), t.predict_raw(X[:50]),
                               atol=1e-4)
    want, wbase = TEX.shap_values(t.explain_packed, t._codes(X[:50]))
    np.testing.assert_array_equal(phi, want.numpy())
    np.testing.assert_array_equal(base, wbase.numpy())


def test_v1_checkpoint_disables_path_dependent_explain(fitted, tmp_path):
    """A format_version 1 checkpoint (no covers) serves, explains
    interventionally, returns no importances and refuses path-dependent
    SHAP, as the reference's server does."""
    jm, X = fitted
    save_legacy_heap_checkpoint(str(tmp_path), jm, version=1,
                                metadata={"loss": "multiclass"})
    t = TS.ForestServer.from_checkpoint(str(tmp_path), device="cpu")
    j = JS.ForestServer.from_checkpoint(str(tmp_path))
    assert not t.explainable and t.feature_importances() is None
    with pytest.raises(RuntimeError, match="cover"):
        t.explain(X[:4])
    phi, base = t.explain(X[:20], algorithm="interventional",
                          background=X[:8])
    jphi, jbase = j.explain(X[:20], algorithm="interventional",
                            background=X[:8])
    assert _explain_stats(t) == _explain_stats(j)
    np.testing.assert_allclose(phi, np.asarray(jphi), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(base, np.asarray(jbase), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(base + phi.sum(1), t.predict_raw(X[:20]),
                               atol=1e-4)


def test_server_options_and_device_rule(ckpt):
    with pytest.raises(ValueError, match="device"):
        TS.ForestServer.from_checkpoint(ckpt, device="cpu", use_kernel="jnp")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TS.ForestServer.from_checkpoint(ckpt)


# -- the driver -----------------------------------------------------------------

def test_launch_serve_demo_stream_and_chaos(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    launch_serve.main(["--demo", "--device", "cpu", "--ckpt", ck,
                       "--requests", "16", "--quantize", "int8",
                       "--prune-alpha", "0"])
    out = capsys.readouterr().out
    assert "compression:" in out and "p99" in out
    stats = tmp_path / "chaos.json"
    launch_serve.main(["--chaos", "--device", "cpu", "--ckpt", ck,
                       "--stats-out", str(stats)])
    assert "OK" in capsys.readouterr().out and stats.exists()
    launch_serve.main(["--explain", "--device", "cpu", "--ckpt", ck,
                       "--requests", "8", "--topk", "2"])
    out = capsys.readouterr().out
    assert "explain latency/request" in out and "rows/s in-shap" in out
    assert "output 5:" in out and "global gain importances" in out
