"""Distributed SketchBoost: the port's `core.distributed` on a gloo world of
4 CPU ranks against `repro.core.distributed` on a (2, 2) mesh of emulated
devices (``device_subset_mesh(4, model_parallel=2)``).

One world is spawned for the module (`repro_torch.launch.dist.spawn`,
4 ranks, one thread each, a ``FileStore`` in ``tmp_path``) and runs every
case; the reference's fits run in this process meanwhile.  Inputs are
``tests/test_distributed_parity.py``'s fixture (N 256, M 6, D 8, 16 bins)
made from a seed with numpy; the reference's draws are replayed into the
port: each round's sketch draw from ``split(sub, 3)[0]`` and the
compressed collective's JL matrices from ``fold_in(fold_in(sub, 7919),
step)`` (level, or 0 for the root and t + 1 for leaf-wise expansion t).

The contract, as the reference's own suite states it: on dyadic targets
one round is bitwise (F, and the leaf values and covers wherever the
structure is equal); the structure is equal but where two candidate
splits' gains agree to rounding (the sketches ``random_sampling`` and
``truncated_svd`` make non-dyadic statistics, whose sums the two packages
associate differently); otherwise values within rtol 1e-5.
"""
import concurrent.futures
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.core import distributed as GD
from repro.core import losses as JL
from repro.core import quantize as JQ
from repro.core import sketch as JS
from repro.core.boosting import GBDTConfig as JCfg
from repro.data.pipeline import make_tabular
from repro.launch.mesh import device_subset_mesh
from repro_torch.core import boosting as TB
from repro_torch.core import distributed as TD
from repro_torch.core import losses as TL
from repro_torch.core import tree as TT
from repro_torch.launch import dist as LD

import _torch_dist_cases as RANK_CASES

pytestmark = pytest.mark.skipif(
    jax.device_count() < 4,
    reason="needs >= 4 (emulated) devices; tests/conftest.py sets "
           "XLA_FLAGS=--xla_force_host_platform_device_count=8")

N, M, D, BINS = 256, 6, 8, 16
SKETCHES = ("none", "top_outputs", "random_sampling", "random_projection",
            "truncated_svd")
GROWTHS = (("levelwise", 0), ("leafwise", 6))
MESH22 = ((2, 2), ("data", "model"))
MESH11 = ((1, 1), ("data", "model"))
# Sketches whose statistics are not dyadic: their histogram sums depend on
# the order of the sums, so a split may flip where two gains agree to
# rounding (the reference exempts truncated_svd from structure for this).
REASSOC = ("random_sampling", "truncated_svd")


def _kw(**kw):
    base = dict(loss="multiclass", n_outputs=D, depth=3, n_bins=BINS,
                sketch_method="none", sketch_k=0, learning_rate=0.3,
                seed=0, n_trees=1)
    base.update(kw)
    return base


def _data():
    X, y = make_tabular("multiclass", N, M, D, seed=0)
    q = JQ.fit_quantizer(X, BINS)
    codes = np.asarray(JQ.apply_quantizer(q, jnp.asarray(X)))
    rng = np.random.default_rng(1)
    dyadic = (np.round(rng.normal(size=(N, D)) * 4) / 4).astype(np.float32)
    return codes, np.asarray(y), dyadic


def _fine_dyadic():
    """Targets on a grid of 2^-10: their gradients' sums over N rows are
    exact in float32 in any order, and most are not bfloat16 values."""
    rng = np.random.default_rng(5)
    return (np.round(rng.normal(size=(N, D)) * 1024) / 1024).astype(
        np.float32)


def replay(kw, rounds):
    """The reference fit_distributed's per-round draws for the port:
    ``(sketch_mats, collective_mats)`` (None where it draws nothing)."""
    cfg = JCfg(**kw)
    key = jax.random.key(cfg.seed)
    mats, coll = [], []
    c = (cfg.sketch_k if cfg.sketch_method != "none"
         and 0 < cfg.sketch_k < D else D) + 1
    k_c = cfg.dist_hist_k_effective
    steps = cfg.max_leaves if cfg.growth == "leafwise" else cfg.depth
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        k_key = jax.random.split(sub, 3)[0]
        if cfg.sketch_method == "random_sampling":
            mats.append(np.asarray(jax.random.gumbel(
                k_key, (cfg.sketch_k, D), jnp.float32)))
        elif cfg.sketch_method == "random_projection":
            mats.append(np.asarray(JS.random_projection_matrix(
                D, cfg.sketch_k, k_key)))
        ck = jax.random.fold_in(sub, 7919)
        coll.append([np.asarray(jax.random.normal(
            jax.random.fold_in(ck, s), (c - 1, k_c), jnp.float32)
            / np.sqrt(np.float32(k_c))) for s in range(steps)])
    draws_sketch = cfg.sketch_method in ("random_projection",
                                         "random_sampling")
    compressed = cfg.dist_hist_compression == "sketch" and c - 1 > k_c
    return (mats if draws_sketch else None), (coll if compressed else None)


# -- the cases ------------------------------------------------------------------

def _cases():
    """(name, config kwargs, targets key, rounds, fit kwargs), each run by
    the port on (2, 2); the reference runs those not in `PORT_ONLY`."""
    out = []
    for method in SKETCHES:
        for growth, leaves in GROWTHS:
            out.append((f"dyadic_{method}_{growth}", _kw(
                loss="multitask_mse", growth=growth, max_leaves=leaves,
                sketch_method=method, sketch_k=0 if method == "none" else 3,
                learning_rate=0.5), "dyadic", 1, {}))
    out.append(("dyadic_one_vs_all", _kw(
        loss="multitask_mse", strategy="one_vs_all", learning_rate=0.5),
        "dyadic", 1, {}))
    out.append(("dyadic_one_vs_all_leafwise", _kw(
        loss="multitask_mse", strategy="one_vs_all", growth="leafwise",
        max_leaves=6, learning_rate=0.5), "dyadic", 1, {}))
    out += [("multi_single_tree_none", _kw(), "y", 3, {}),
            ("multi_single_tree_top_outputs", _kw(
                sketch_method="top_outputs", sketch_k=3), "y", 3, {}),
            ("multi_one_vs_all_none", _kw(strategy="one_vs_all"), "y", 3,
             {}),
            ("multi_leafwise_none", _kw(growth="leafwise", max_leaves=6),
             "y", 3, {}),
            ("multi_one_vs_all_leafwise", _kw(strategy="one_vs_all",
                                              growth="leafwise",
                                              max_leaves=6), "y", 3, {}),
            ("feature_shard_none", _kw(), "y", 2, {"feature_shard": True}),
            ("feature_shard_top_outputs", _kw(sketch_method="top_outputs",
                                              sketch_k=3), "y", 2,
             {"feature_shard": True})]
    for growth, leaves in GROWTHS:
        ex = _kw(growth=growth, max_leaves=leaves)
        out.append((f"exact_{growth}", ex, "y", 5, {}))
        out.append((f"passthrough_{growth}", dict(
            ex, dist_hist_compression="sketch", dist_hist_k=D), "y", 5, {}))
        out.append((f"drift_{growth}", dict(
            ex, dist_hist_compression="sketch", dist_hist_k=6), "y", 5, {}))
        out.append((f"compressed_{growth}", dict(
            ex, dist_hist_compression="sketch", dist_hist_k=6), "y", 1, {}))
    return out


# Cases held to the port alone (the exact collective, its pass-through and
# the drift envelope), or whose reference fit adds nothing the others check.
PORT_ONLY = ("multi_single_tree_top_outputs", "feature_shard_top_outputs",
             "exact_levelwise", "exact_leafwise", "passthrough_levelwise",
             "passthrough_leafwise", "drift_levelwise", "drift_leafwise",
             "compressed_leafwise")
CASES = _cases()
FIT_KW = dict(loss="multiclass", n_outputs=D, depth=3, n_bins=BINS,
              sketch_method="none", sketch_k=0, learning_rate=0.3, seed=7,
              n_trees=3, growth="leafwise", max_leaves=6)
# (1, 1) against the port's single-device rounds, bitwise.
SINGLE = (("single_levelwise_rp", _kw(sketch_method="random_projection",
                                      sketch_k=3, n_trees=2)),
          ("single_leafwise", _kw(growth="leafwise", max_leaves=6,
                                  n_trees=2)),
          ("single_one_vs_all", _kw(strategy="one_vs_all", n_trees=2)),
          ("single_one_vs_all_leafwise", _kw(strategy="one_vs_all",
                                             growth="leafwise", max_leaves=6,
                                             n_trees=2)),
          ("single_direct", _kw(hist_engine="direct", sketch_method=
                                "top_outputs", sketch_k=3, n_trees=2)),
          ("single_bf16", _kw(hist_dtype="bfloat16", n_trees=2)))
ERRORS = (("err_ova_feature_shard", _kw(strategy="one_vs_all"),
           {"feature_shard": True}, "one_vs_all"),
          ("err_leafwise_feature_shard", _kw(growth="leafwise",
                                             max_leaves=4),
           {"feature_shard": True}, "leaf-wise"),
          ("err_indivisible", _kw(), {"feature_shard": True}, "divisible"))
EVALS = ("multiclass", "multilabel", "multitask_mse")
# The direct engine with each statistics type, on `_fine_dyadic` targets.
DIRECT_DTYPES = {f"direct_{dt}": _kw(loss="multitask_mse",
                                     hist_engine="direct", hist_dtype=dt,
                                     learning_rate=0.5)
                 for dt in ("float32", "bfloat16")}


def _port_payload(codes, y, dyadic):
    arrays = dict(codes=codes, y=y, dyadic=dyadic, fine=_fine_dyadic(),
                  codes7=np.zeros((N, 7), np.uint8))
    cases = []
    for name, kw, target, rounds, fit_kw in CASES:
        mats, coll = replay(kw, rounds)
        cases.append(dict(name=name, mesh=MESH22, cfg=dict(kw, n_trees=rounds),
                          codes="codes", Y=target, return_F=True,
                          bytes_model=True, kw=dict(
                              fit_kw, sketch_mats=mats,
                              collective_mats=coll)))
    cases.append(dict(name="fit", mesh=MESH22, cfg=FIT_KW, codes="codes",
                      Y="y", return_F=True, bytes_model=True,
                      kw=dict(eval_every=1)))
    for name, kw in SINGLE:
        cases.append(dict(name=name, mesh=MESH11, cfg=kw, codes="codes",
                          Y="y", return_F=True, bytes_model=True))
    pod = next(c for c in CASES if c[0] == "multi_single_tree_none")
    cases.append(dict(name="pod_mesh", mesh=((2, 1, 2), ("pod", "data",
                                                          "model")),
                      cfg=dict(pod[1], n_trees=pod[3]), codes="codes", Y="y",
                      return_F=True, bytes_model=True,
                      kw=dict(row_axes=("pod", "data"))))
    for name, kw, fit_kw, _ in ERRORS:
        cases.append(dict(name=name, mesh=MESH22, cfg=kw,
                          codes="codes7" if name == "err_indivisible"
                          else "codes", Y="y", kw=fit_kw,
                          expect_error=True))
    for name, kw in DIRECT_DTYPES.items():
        cases.append(dict(name=name, mesh=MESH22, cfg=kw, codes="codes",
                          Y="fine", return_F=True))
    rng = np.random.default_rng(3)
    arrays["F_eval"] = rng.normal(size=(N, D)).astype(np.float32)
    for loss in EVALS:
        _, yl = make_tabular(loss, N, M, D, seed=2)
        arrays[f"y_{loss}"] = np.asarray(yl)
        cases.append(dict(name=f"eval_{loss}", kind="eval", mesh=MESH22,
                          cfg=_kw(loss=loss), F="F_eval", Y=f"y_{loss}"))
    return dict(arrays=arrays, cases=cases)


def _reference(codes, y, dyadic):
    mesh = device_subset_mesh(4, model_parallel=2)
    out = {}
    targets = dict(y=jnp.asarray(y), dyadic=jnp.asarray(dyadic))
    for name, kw, target, rounds, fit_kw in CASES:
        if name in PORT_ONLY:
            continue
        F, forest, _ = GD.fit_distributed(
            JCfg(**dict(kw, n_trees=rounds, use_kernel=False)), mesh,
            jnp.asarray(codes), targets[target], **fit_kw)
        out[name] = (np.asarray(F), {k: np.asarray(v) for k, v in
                                     forest._asdict().items()})
    for name, kw in DIRECT_DTYPES.items():
        # The reference takes bf16 statistics only with a kernel mode; its
        # distributed builds are jnp and round the statistics themselves.
        F, forest, _ = GD.fit_distributed(
            JCfg(**dict(kw, use_kernel="interpret")), mesh,
            jnp.asarray(codes), jnp.asarray(_fine_dyadic()))
        out[name] = (np.asarray(F), {k: np.asarray(v) for k, v in
                                     forest._asdict().items()})
    rng = np.random.default_rng(3)
    Fe = jnp.asarray(rng.normal(size=(N, D)), jnp.float32)
    for loss in EVALS:
        _, yl = make_tabular(loss, N, M, D, seed=2)
        out[f"eval_{loss}"] = float(JL.get_loss(loss).value(
            Fe, jnp.asarray(yl)))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port rank results, reference results), the port's world running
    while the reference fits."""
    codes, y, dyadic = _data()
    payload = _port_payload(codes, y, dyadic)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(LD.spawn, RANK_CASES.FN, 4,
                          tmp_path_factory.mktemp("world"), backend="gloo",
                          device="cpu", payload=payload, timeout=300,
                          pythonpath=[RANK_CASES.HERE])
        ref = _reference(codes, y, dyadic)
        port = fut.result()
    return port, ref, payload["arrays"]


def _forest_equal(a, b, fields=("feat", "thr")):
    return all(np.array_equal(a[f], b[f]) for f in fields)


# -- parity with the reference ---------------------------------------------------

@pytest.mark.parametrize("growth", [g for g, _ in GROWTHS])
@pytest.mark.parametrize("method", SKETCHES)
def test_single_round_dyadic_bitwise(runs, method, growth):
    port, ref, _ = runs
    name = f"dyadic_{method}_{growth}"
    got, (F, forest) = port[0][name], ref[name]
    assert np.array_equal(got["F"], F)
    fields = ["feat", "thr"] + (["left", "right", "node_count"]
                                if growth == "leafwise" else [])
    np.testing.assert_allclose(got["forest"]["gain"], forest["gain"],
                               rtol=1e-4, atol=1e-5)
    if _forest_equal(got["forest"], forest, fields):
        assert np.array_equal(got["forest"]["value"], forest["value"])
        assert np.array_equal(got["forest"]["cover"], forest["cover"])
    else:
        assert method in REASSOC, name


def test_one_vs_all_first_round_bitwise(runs):
    port, ref, _ = runs
    got, (F, forest) = port[0]["dyadic_one_vs_all"], ref["dyadic_one_vs_all"]
    assert np.array_equal(got["F"], F)
    assert _forest_equal(got["forest"], forest)
    for f in ("value", "cover"):
        assert np.array_equal(got["forest"][f], forest[f])
    np.testing.assert_allclose(got["forest"]["gain"], forest["gain"],
                               rtol=1e-5, atol=1e-7)


def test_one_vs_all_leafwise_first_round_bitwise(runs):
    """One-vs-all leaf-wise under sharding on dyadic targets: the
    reference vmaps its leaf-wise grower over the output shard, the port
    grows a rank's trees in lockstep with the same collectives; F, the
    trees, their values and covers bit for bit."""
    port, ref, _ = runs
    name = "dyadic_one_vs_all_leafwise"
    got, (F, forest) = port[0][name], ref[name]
    assert np.array_equal(got["F"], F)
    assert _forest_equal(got["forest"], forest,
                         ("feat", "thr", "left", "right", "node_count"))
    for f in ("value", "cover"):
        assert np.array_equal(got["forest"][f], forest[f])
    np.testing.assert_allclose(got["forest"]["gain"], forest["gain"],
                               rtol=1e-5, atol=1e-7)


def test_direct_engine_ignores_bf16_unlike_the_reference(runs):
    """The port's distributed direct engine takes no bf16 rounding (as
    both packages' single-device direct engines): with
    ``hist_dtype="bfloat16"`` it fits bit for bit what it fits in float32,
    and, on targets whose sums are exact in float32, what the reference
    fits in float32.  The reference's distributed round rounds the
    statistics to bf16 for every engine, so its bf16 gains differ."""
    port, ref, _ = runs
    got16, got32 = port[0]["direct_bfloat16"], port[0]["direct_float32"]
    assert np.array_equal(got16["F"], got32["F"])
    for f in got32["forest"]:
        assert np.array_equal(got16["forest"][f], got32["forest"][f]), f
    (F32, ref32), (_, ref16) = ref["direct_float32"], ref["direct_bfloat16"]
    assert np.array_equal(got32["F"], F32)
    assert _forest_equal(got32["forest"], ref32)
    np.testing.assert_allclose(got32["forest"]["gain"], ref32["gain"],
                               rtol=1e-5, atol=1e-7)
    assert not np.allclose(ref16["gain"], ref32["gain"], rtol=1e-5,
                           atol=1e-7)


@pytest.mark.parametrize("name", [c[0] for c in CASES
                                  if c[0].startswith(("multi_",
                                                      "feature_shard_"))
                                  and c[0] not in PORT_ONLY])
def test_multiround_parity(runs, name):
    """Generic floats, 2-3 rounds: F within rtol 1e-5; the same splits
    (one-vs-all: in the first round; later its d trees meet exact ties of
    the fixture's duplicated features, which rounding decides, as the
    reference's suite notes)."""
    port, ref, _ = runs
    got, (F, forest) = port[0][name], ref[name]
    first = {k: v[:1] for k, v in got["forest"].items()}
    assert _forest_equal(first, {k: v[:1] for k, v in forest.items()})
    if "one_vs_all" not in name:
        assert _forest_equal(got["forest"], forest)
    np.testing.assert_allclose(got["F"], F, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("growth", [g for g, _ in GROWTHS])
def test_sketched_collective_passthrough_is_exact(runs, growth):
    """``dist_hist_k`` >= the gradient channels: the compressor is the
    identity, 5 rounds the exact collective's bit for bit."""
    port, _, _ = runs
    ex, sk = port[0][f"exact_{growth}"], port[0][f"passthrough_{growth}"]
    assert np.array_equal(ex["F"], sk["F"])
    for f in ex["forest"]:
        assert np.array_equal(ex["forest"][f], sk["forest"][f])


@pytest.mark.parametrize("growth", [g for g, _ in GROWTHS])
def test_sketched_collective_drift_envelope(runs, growth):
    """A lossy width (6 of 8 channels, JL matrices from the ranks'
    generators), 5 rounds: the splits may differ, but the count channel is
    exact and the leaf values never sketched, so the fit still learns and
    stays near the exact one (the reference suite's envelope)."""
    port, _, arrays = runs
    y = torch.from_numpy(arrays["y"]).long()
    loss = TL.get_loss("multiclass").value
    l0 = float(loss(torch.zeros((N, D)), y))
    le = float(loss(torch.from_numpy(port[0][f"exact_{growth}"]["F"]), y))
    Fs = port[0][f"drift_{growth}"]["F"]
    ls = float(loss(torch.from_numpy(Fs), y))
    assert np.isfinite(Fs).all()
    assert ls < l0 and ls <= 1.5 * le


def test_compressed_collective_matches_reference(runs):
    """``dist_hist_k=6`` of 8 channels with the reference's JL matrices:
    the same projection, the same splits, F within rtol 1e-5."""
    port, ref, _ = runs
    got, (F, forest) = port[0]["compressed_levelwise"], \
        ref["compressed_levelwise"]
    assert _forest_equal(got["forest"], forest)
    np.testing.assert_allclose(got["F"], F, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("name", [c[0] for c in CASES] + ["fit"]
                         + [s[0] for s in SINGLE])
def test_collective_bytes_equal_model(runs, name):
    """Every rank all-reduces, over the data axis, the histogram bytes
    `round_collective_bytes` models: half a level under ``"subtract"``,
    ``(k' + 1) / c`` of them compressed, a one-vs-all rank's trees only."""
    port, _, _ = runs
    ranks = [r[name] for r in port if r[name] is not None]
    assert ranks and all(r["hist_bytes"] == r["hist_bytes_model"]
                         for r in ranks)
    assert ranks[0]["hist_bytes"] > 0


def test_bytes_model_matches_reference():
    for kw in (_kw(), _kw(dist_hist_compression="sketch", dist_hist_k=5),
               _kw(growth="leafwise", max_leaves=6),
               _kw(strategy="one_vs_all"), _kw(hist_engine="partition"),
               _kw(sketch_method="random_projection", sketch_k=3)):
        want = GD.round_collective_bytes(JCfg(**kw), M, D)
        assert TD.round_collective_bytes(TB.GBDTConfig(**kw), M, D) == want


@pytest.mark.parametrize("loss", EVALS)
def test_eval_parity(runs, loss):
    port, ref, _ = runs
    got = [r[f"eval_{loss}"]["loss"] for r in port]
    assert len(set(got)) == 1                 # the same on every rank
    np.testing.assert_allclose(got[0], ref[f"eval_{loss}"], rtol=1e-6,
                               atol=1e-6)


def test_fit_distributed_matches_single_loop(runs):
    """`fit_distributed` on (2, 2), leaf-wise, 3 rounds with its history
    against the port's single-device rounds (`boost_round`, as
    `SketchBoost.fit` runs them): F within rtol 1e-5."""
    port, _, arrays = runs
    got = port[0]["fit"]
    assert [h["round"] for h in got["history"]] == [0, 1, 2]
    assert got["history"][-1]["train_loss"] < got["history"][0]["train_loss"]
    assert got["forest"]["feat"].shape[0] == 3
    # The port's single-device rounds on the same data.
    cfg = TB.GBDTConfig(**FIT_KW)
    codes = torch.from_numpy(arrays["codes"])
    F = torch.zeros((N, D))
    Y = torch.from_numpy(arrays["y"]).long()
    for _ in range(3):
        TB.boost_round(F, codes, codes.t().contiguous(), Y, cfg)
    np.testing.assert_allclose(got["F"], F.numpy(), rtol=1e-5, atol=2e-5)
    loss = TL.get_loss("multiclass").value
    np.testing.assert_allclose(got["history"][-1]["train_loss"],
                               float(loss(F, Y)), rtol=1e-5)


@pytest.mark.parametrize("name,kw", SINGLE, ids=[s[0] for s in SINGLE])
def test_one_rank_mesh_is_the_single_device_fit(runs, name, kw):
    """A (1, 1) mesh runs `boost_round`'s computations: forest and F bit
    for bit (the same generator draws)."""
    port, _, arrays = runs
    got = port[0][name]
    cfg = TB.GBDTConfig(**kw)
    codes = torch.from_numpy(arrays["codes"])
    F = torch.zeros((N, D))
    Y = torch.from_numpy(arrays["y"]).long()
    gen = torch.Generator().manual_seed(cfg.seed)
    trees = [TB.boost_round(F, codes, codes.t().contiguous(), Y, cfg,
                            generator=gen) for _ in range(cfg.n_trees)]
    forest = TT.stack_trees(trees)
    assert np.array_equal(got["F"], F.numpy())
    for f in forest._fields:
        if getattr(forest, f) is not None:
            assert np.array_equal(got["forest"][f],
                                  getattr(forest, f).numpy()), f
    assert all(r[name] is None for r in port[1:])


def test_pod_data_model_mesh(runs):
    """Rows over ``("pod", "data")`` of a (2, 1, 2) mesh: the blocks and
    sums of the (2, 2) mesh, so its fit bit for bit; the histograms are
    all-reduced over each row axis in turn, each moving the model's
    bytes."""
    port, _, _ = runs
    got, want = port[0]["pod_mesh"], port[0]["multi_single_tree_none"]
    assert np.array_equal(got["F"], want["F"])
    for f in want["forest"]:
        assert np.array_equal(got["forest"][f], want["forest"][f])
    for r in port:
        b = r["pod_mesh"]["bytes"]
        assert b["pod/hist"] == b["data/hist"] == \
            r["pod_mesh"]["hist_bytes_model"]


# -- refusals ---------------------------------------------------------------------

@pytest.mark.parametrize("name,match", [(e[0], e[3]) for e in ERRORS])
def test_layout_refusals(runs, name, match):
    port, _, _ = runs
    assert all(match in r[name]["error"] for r in port)


def test_fit_distributed_requires_n_outputs():
    cfg = TB.GBDTConfig(**dict(_kw(), n_outputs=0))
    with pytest.raises(ValueError, match="n_outputs"):
        TD.fit_distributed(cfg, None, np.zeros((N, M), np.uint8),
                           np.zeros(N, np.int64))


@pytest.mark.parametrize("kw,match", [
    (dict(dist_hist_compression="gzip"), "dist_hist_compression"),
    (dict(dist_hist_compression="sketch", dist_hist_k=-1), "dist_hist_k"),
    (dict(dist_hist_compression="sketch", dist_hist_k=0, sketch_k=0),
     "dist_hist_k"),
    (dict(subsample=0.5), "single-device only"),
    (dict(goss_a=0.2, goss_b=0.1), "single-device only"),
    (dict(colsample=0.5), "single-device only")])
def test_distributed_validate_refusals(kw, match):
    """The reference's refusals of the collective's options (sampling, which
    the reference's distributed round ignores, is refused here)."""
    with pytest.raises(ValueError, match=match):
        TB.GBDTConfig(**_kw(**kw)).validate(distributed=True)


def test_single_device_rejects_the_collective_knob():
    cfg = TB.GBDTConfig(**_kw(dist_hist_compression="sketch",
                              dist_hist_k=4))
    cfg.validate(distributed=True)
    with pytest.raises(ValueError, match="single-device"):
        cfg.validate()
    with pytest.raises(ValueError, match="single-device"):
        TB.SketchBoost(cfg, device="cpu")
    assert cfg.dist_hist_k_effective == 4
    assert dataclasses.replace(cfg, dist_hist_k=0).dist_hist_k_effective == 0


def test_ranks_import_neither_jax_nor_repro(runs):
    """`spawn` raises when a rank imported either; the results came back."""
    port, _, _ = runs
    assert len(port) == 4


def test_spawn_follows_the_device_rule(tmp_path):
    """`spawn` with no device is CUDA, and raises where there is no card
    before it starts a rank; a rank is never started without a device."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is CUDA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LD.spawn(RANK_CASES.FN, 2, tmp_path, backend="gloo")
    assert not (tmp_path / "rank0.log").exists()
    with pytest.raises(SystemExit):
        LD._worker(["--fn", RANK_CASES.FN, "--rank", "0", "--world-size",
                    "1", "--backend", "gloo", "--workdir", str(tmp_path)])
