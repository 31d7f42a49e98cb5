"""The collectives, the sketched all-reduce, the sharded sketch, elastic
layouts, restores onto a mesh and resuming on a smaller mesh: the port on a
gloo world of 4 CPU ranks (one world for the module, every case in it),
held to the JAX package where it has the same function
(`repro.distributed.compression.sketched_psum` under ``shard_map`` at the
same JL matrices) and to the port's single-device functions otherwise.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from repro.distributed import compression as JC
from repro.data.pipeline import make_tabular
from repro_torch.core import sketch as TS
from repro_torch.distributed import compression as TC
from repro_torch.launch import dist as LD
from repro_torch.launch import mesh as TM
from repro_torch.runtime import elastic as E

import _torch_dist_cases as RANK_CASES

pytestmark = pytest.mark.skipif(
    jax.device_count() < 2,
    reason="needs >= 2 (emulated) devices; tests/conftest.py sets "
           "XLA_FLAGS=--xla_force_host_platform_device_count=8")

N, M, D, BINS, K = 256, 6, 8, 16, 4
MESH22 = ((2, 2), ("data", "model"))
SHAPES = (((2, 2), ("data", "model")), ((4, 1), ("data", "model")),
          ((1, 4), ("data", "model")), ((1, 2), ("data", "model")))
SKETCHES = ("none", "top_outputs", "random_sampling", "random_projection",
            "truncated_svd")
# Leaves of the gradients the sketched all-reduce takes, each with a
# leading axis of the 2 data ranks: "w" and "v" are compressed to K
# columns, "b" (3 <= K columns) passes through.
GRAD_SHAPES = {"b": (2, 1, 3), "v": (2, 7, 9), "w": (2, 5, 12)}


def _grads():
    rng = np.random.default_rng(5)
    return {k: rng.normal(size=s).astype(np.float32)
            for k, s in GRAD_SHAPES.items()}


def _pis(key):
    """The reference's JL matrices: one key a leaf (sorted), N(0, 1/K)."""
    keys = jax.random.split(key, len(GRAD_SHAPES))
    out = []
    for kk, name in zip(keys, sorted(GRAD_SHAPES)):
        b = GRAD_SHAPES[name][-1]
        out.append(None if b <= K else np.asarray(
            jax.random.normal(kk, (b, K), jnp.float32) / jnp.sqrt(float(K))))
    return out


def _fixture():
    from repro.core import quantize as JQ
    X, y = make_tabular("multiclass", N, M, D, seed=0)
    q = JQ.fit_quantizer(X, BINS)
    codes = np.asarray(JQ.apply_quantizer(q, jnp.asarray(X)))
    # Piecewise-constant dyadic targets: with lambda_l2 = 0 every leaf is
    # pure, its value the mean of equal values, so F stays dyadic and every
    # sum is exact in any order, round after round.
    rng = np.random.default_rng(2)
    cell = ((codes[:, 0] > 7).astype(int) + 2 * (codes[:, 1] > 3)
            + 4 * (codes[:, 2] > 11))
    pure = (rng.integers(-8, 9, (8, D)) / 4.0)[cell].astype(np.float32)
    return codes, pure


def _resume_cases(tmp):
    pure = dict(loss="multitask_mse", n_outputs=D, depth=4, n_bins=BINS,
                sketch_method="top_outputs", sketch_k=3, learning_rate=0.5,
                lambda_l2=0.0, n_trees=4, seed=0)
    drawn = dict(pure, sketch_method="random_projection", lambda_l2=1.0)
    cut, cut_g = str(tmp / "cut"), str(tmp / "cut_gen")
    small = ((1, 2), ("data", "model"))
    return [
        dict(name="full", mesh=MESH22, cfg=pure, codes="codes", Y="pure",
             return_F=True),
        dict(name="cut", mesh=MESH22, cfg=dict(pure, save_every=1,
                                               ckpt_dir=cut, ckpt_keep=4),
             codes="codes", Y="pure", kill_at=2),
        dict(name="resumed", mesh=small, cfg=dict(pure, resume_from=cut),
             codes="codes", Y="pure", return_F=True),
        dict(name="full_gen", mesh=MESH22, cfg=drawn, codes="codes",
             Y="pure", return_F=True),
        dict(name="cut_gen", mesh=MESH22, codes="codes", Y="pure",
             cfg=dict(drawn, save_every=2, ckpt_dir=cut_g), kill_at=3),
        dict(name="resumed_gen", mesh=MESH22, codes="codes", Y="pure",
             cfg=dict(drawn, resume_from=cut_g), return_F=True),
        dict(name="skip_round", mesh=MESH22, codes="codes", Y="pure",
             cfg=dict(pure, n_trees=3, lambda_l2=1.0,
                      guard_policy="skip_round"),
             nan_at=(1, [5, 200]), return_F=True),
    ]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("compression")
    codes, pure = _fixture()
    rng = np.random.default_rng(4)
    G = (np.round(rng.normal(size=(N, D)) * 4) / 4).astype(np.float32)
    arrays = dict(grads=_grads(), pis=_pis(jax.random.key(11)), codes=codes,
                  pure=pure, G=G, F=rng.normal(size=(N, D)).astype(
                      np.float32), y=np.arange(N), w=np.ones(3),
                  pi=rng.normal(size=(D, 3)).astype(np.float32),
                  noise=rng.gumbel(size=(3, D)).astype(np.float32))
    cases = [dict(name="collectives", kind="collectives", mesh=MESH22),
             dict(name="mesh_helpers", kind="mesh_helpers", mesh=MESH22),
             dict(name="sketched_psum", kind="sketched_psum", mesh=MESH22,
                  grads="grads", Pis="pis", k=K, steps=2),
             dict(name="restore", kind="restore", mesh=MESH22, F="F",
                  dir=str(tmp / "restore"))]
    for method in SKETCHES:
        draw = {"random_projection": "pi", "random_sampling": "noise"}.get(
            method)
        cases.append(dict(name=f"sketch_{method}", kind="sketch",
                          mesh=MESH22, G="G", method=method, k=3, draw=draw))
    for shape in SHAPES:
        cases.append(dict(name=f"remesh_{shape[0]}", kind="remesh",
                          mesh=shape, F="F", y="y", w="w"))
    cases += _resume_cases(tmp)
    port = LD.spawn(RANK_CASES.FN, 4, tmp / "world",
                    backend="gloo", device="cpu",
                    payload=dict(arrays=arrays, cases=cases), timeout=300,
                    pythonpath=[RANK_CASES.HERE])
    return port, arrays


# -- collectives -----------------------------------------------------------------

def test_collectives_on_all_reduce(runs):
    """psum and pmax over an axis, and the gather done as an all-reduce of
    a buffer padded with -0.0 (exact: a -0.0 keeps its sign)."""
    port, _ = runs
    x = np.arange(6, dtype=np.float32)
    for rank, r in enumerate(port):
        c = r["collectives"]
        data, model = divmod(rank, 2)
        mates = [data * 2 + j for j in range(2)]      # the model axis
        column = [i * 2 + model for i in range(2)]    # the data axis
        np.testing.assert_array_equal(c["psum"],
                                      x * sum(q + 1 for q in column))
        np.testing.assert_array_equal(c["pmax"], x * 4)
        np.testing.assert_array_equal(
            c["gather"], np.stack([x[:2] * (q + 1) for q in mates]))
        assert c["signbits"].tolist() == [[True] * 3, [False] * 3]
        # psum of 6 floats over data; pmax of 6 over data, then model; the
        # gather's buffer of 2 x 2 int64 over model.
        assert c["bytes"] == {"data/t": 48, "model/t": 24 + 32}


def test_mesh_helpers_lay_ranks_out_row_major(runs):
    """`device_subset_mesh` and `host_device_mesh` over the 4-rank world:
    rank r at ``unravel_index(r, shape)``."""
    port, _ = runs
    for rank, r in enumerate(port):
        got = r["mesh_helpers"]
        assert got[("data", "model")] == ((2, 2), {"data": rank // 2,
                                                   "model": rank % 2})
        assert got["host"] == got[("data", "model")]
        assert got[("pod", "data", "model")] == (
            (2, 1, 2), {"pod": rank // 2, "data": 0, "model": rank % 2})


def test_axis_groups_are_the_mesh_lines():
    assert TM._axis_groups((2, 3), 0) == [[0, 3], [1, 4], [2, 5]]
    assert TM._axis_groups((2, 3), 1) == [[0, 1, 2], [3, 4, 5]]
    assert TM._axis_groups((2, 2, 2), 0)[0] == [0, 4]


def test_production_mesh_names_its_slice():
    """The dry run's meshes: abstract (axes and sizes, no ranks), the
    reference's 16 x 16 and 2 x 16 x 16."""
    single, multi = (TM.make_production_mesh(multi_pod=m)
                     for m in (False, True))
    assert isinstance(single, TM.AbstractMesh)
    assert (single.shape, single.axes) == ((16, 16), ("data", "model"))
    assert (multi.shape, multi.axes, multi.size) == (
        (2, 16, 16), ("pod", "data", "model"), 512)


# -- the sketched all-reduce -------------------------------------------------------

def test_sketched_psum_matches_reference(runs):
    """Two steps with error feedback at the reference's JL matrices: the
    means and residuals within rtol 1e-5 of `sketched_psum` under
    ``shard_map`` on 2 devices."""
    from jax.experimental.shard_map import shard_map
    port, arrays = runs
    mesh = JMesh(np.array(jax.devices()[:2]), ("data",))
    key = jax.random.key(11)

    def step(g, r):
        return JC.sketched_psum(g, key, "data", k=K, residuals=r)
    spec = {k: P("data") for k in GRAD_SHAPES}
    fn = shard_map(step, mesh=mesh, in_specs=(spec, spec),
                   out_specs=({k: P() for k in GRAD_SHAPES}, spec),
                   check_rep=False)
    g = {k: jnp.asarray(v) for k, v in arrays["grads"].items()}
    res = {k: jnp.zeros_like(v) for k, v in g.items()}
    outs = []
    for _ in range(2):
        out, res = fn(g, res)
        outs.append(out)
    for rank, r in enumerate(port):
        got = r["sketched_psum"]
        data = rank // 2
        for step_i in range(2):
            for k in GRAD_SHAPES:
                np.testing.assert_allclose(
                    got["outs"][step_i][k],
                    np.asarray(outs[step_i][k])[0], rtol=1e-5, atol=1e-6)
        for k in GRAD_SHAPES:
            np.testing.assert_allclose(got["residuals"][k],
                                       np.asarray(res[k])[data], rtol=1e-4,
                                       atol=1e-5)
            np.testing.assert_allclose(got["exact"][k],
                                       arrays["grads"][k].mean(0),
                                       rtol=1e-6, atol=1e-7)
        assert got["ratio"] == pytest.approx(JC.compression_ratio(
            {k: v[0] for k, v in g.items()}, K))


def test_passthrough_block_is_exact():
    g = torch.randn(5, 3)
    sk, Pi, shape = TC.compress_block(g, 4)
    assert Pi is None and torch.equal(TC.decompress_block(sk, Pi, shape), g)
    with pytest.raises(ValueError, match="Pi or a generator"):
        TC.compress_block(torch.randn(5, 9), 4)


def test_decompress_is_the_reference_projection():
    rng = np.random.default_rng(0)
    g = rng.normal(size=(6, 10)).astype(np.float32)
    Pi = (rng.normal(size=(10, 3)) / np.sqrt(3)).astype(np.float32)
    want = JC.decompress_block(jnp.asarray(g @ Pi), jnp.asarray(Pi), g.shape)
    sk, P_, shape = TC.compress_block(torch.from_numpy(g), 3,
                                      Pi=torch.from_numpy(Pi))
    got = TC.decompress_block(sk, P_, shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


# -- the sharded sketch -------------------------------------------------------------

@pytest.mark.parametrize("method", SKETCHES)
def test_sketch_sharded_matches_single_device(runs, method):
    """`sketch_sharded` on (2, 2) against `build_sketch` of the whole G
    (dyadic G; truncated_svd compared through G_k G_k^T, which the
    eigenvectors' signs do not change)."""
    port, arrays = runs
    draw = {"random_projection": arrays["pi"],
            "random_sampling": arrays["noise"]}.get(method)
    want = TS.build_sketch(torch.from_numpy(arrays["G"]), method=method, k=3,
                           draw=None if draw is None else
                           torch.from_numpy(draw)).numpy()
    for r in port:
        got = r[f"sketch_{method}"]["sketch"]
        if method == "truncated_svd":
            np.testing.assert_allclose(got @ got.T, want @ want.T,
                                       rtol=1e-4, atol=1e-3)
        elif method in ("none", "top_outputs"):
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# -- elastic layouts and restores ----------------------------------------------------

@pytest.mark.parametrize("shape", [s for s in SHAPES],
                         ids=[str(s[0]) for s in SHAPES])
def test_remesh_across_mesh_shapes(runs, shape):
    port, arrays = runs
    (dp, tp), _ = shape
    F = arrays["F"]
    for rank, r in enumerate(port):
        got = r[f"remesh_{shape[0]}"]
        if rank >= dp * tp:
            assert got is None
            continue
        i, j = got["coords"]["data"], got["coords"]["model"]
        rows, cols = N // dp, D // tp
        np.testing.assert_array_equal(
            got["blocks"]["F"], F[i * rows:(i + 1) * rows,
                                  j * cols:(j + 1) * cols])
        np.testing.assert_array_equal(got["blocks"]["y"],
                                      arrays["y"][i * rows:(i + 1) * rows])
        np.testing.assert_array_equal(got["blocks"]["w"], arrays["w"])


def test_restore_onto_a_mesh(runs):
    """`CheckpointManager.restore(shardings=...)` and `RestartableLoop(
    shardings=...)` give each rank its block of a step rank 0 wrote."""
    port, arrays = runs
    F = arrays["F"]
    for r in port:
        got = r["restore"]
        i, j = got["coords"]["data"], got["coords"]["model"]
        want = F[i * 128:(i + 1) * 128, j * 4:(j + 1) * 4]
        assert got["step"] == 4 and got["start"] == 5
        for part in (got["manager"], got["loop"]):
            np.testing.assert_array_equal(part["F"], want)
            np.testing.assert_array_equal(part["w"], np.ones(3))


def test_shrink_and_rebalance():
    spec = TM.MeshSpec((2, 4, 2), ("pod", "data", "model"))
    assert E.shrink_data_axis(spec, 1) == TM.MeshSpec((2, 3, 2),
                                                      spec.axes)
    with pytest.raises(ValueError, match="below one data slice"):
        E.shrink_data_axis(TM.MeshSpec((1, 2), ("data", "model")), 1)
    assert E.rebalance_batch(1000, spec) == 1000
    assert E.rebalance_batch(1001, E.shrink_data_axis(spec)) == 996


def test_restore_rejects_a_non_layout(tmp_path):
    from repro_torch.io import checkpoint as CK
    mgr = CK.CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {"F": torch.ones(2)})
    with pytest.raises(TypeError, match="Layout"):
        mgr.restore({"F": 0}, shardings={"F": 3})


# -- resuming ---------------------------------------------------------------------

def test_resume_on_a_smaller_mesh_is_bitwise(runs):
    """Saved every round on (2, 2), killed at round 2, resumed on (1, 2):
    the forest and F of the uninterrupted (2, 2) fit, bit for bit (the
    leaves no row reaches hold 0 / 0 at ``lambda_l2=0``: NaN in both)."""
    port, _ = runs
    assert all(r["cut"] == {"killed_at": 2} for r in port)
    full, resumed = port[0]["full"], port[0]["resumed"]
    assert np.array_equal(full["F"], resumed["F"])
    for f in full["forest"]:
        assert np.array_equal(full["forest"][f], resumed["forest"][f],
                              equal_nan=True), f
    assert full["forest"]["feat"].shape[0] == 4
    assert port[2]["resumed"] is None and port[3]["resumed"] is None


def test_resume_restores_the_draws_generator(runs):
    """random_projection drawn from the ranks' generators: a step saved at
    round 2 resumes the generator's state, bitwise the fit that ran
    through."""
    port, _ = runs
    assert all(r["cut_gen"] == {"killed_at": 3} for r in port)
    full, resumed = port[0]["full_gen"], port[0]["resumed_gen"]
    assert np.array_equal(full["F"], resumed["F"])
    for f in full["forest"]:
        assert np.array_equal(full["forest"][f], resumed["forest"][f]), f


def test_skip_round_is_taken_by_every_rank(runs):
    """NaN targets in two rows (of two row shards) from round 1 on: every
    rank skips rounds 1 and 2 (their values and gains zero) and keeps round
    0; F stays finite."""
    port, _ = runs
    got = port[0]["skip_round"]["forest"]
    assert not np.any(got["value"][1:]) and not np.any(got["gain"][1:])
    assert np.any(got["value"][0]) and np.any(got["gain"][0])
    assert np.isfinite(port[0]["skip_round"]["F"]).all()
    assert len({r["skip_round"]["F_local_sha256"] for r in port}) == 4
