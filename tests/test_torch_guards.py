"""The non-finite guards (``guard_policy``, ``hessian_floor``) and the chaos
injections that feed them: the port against the JAX package on the CPU.

Each guard function takes the same arrays with NaN and +/-inf in both
packages; whole fits run with `runtime.chaos.NaNAtRow` corrupting
``multitask_mse`` targets from a round on, under each policy and in both
strategies, the reference in its jnp mode with its draws replayed into the
port (``random_projection``'s Pi).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import boosting as JB
from repro.core import guards as JG
from repro.core import sketch as JS
from repro.data.pipeline import make_tabular
from repro.runtime import chaos as JC
from repro_torch.core import boosting as TB
from repro_torch.core import guards as TG
from repro_torch.runtime import chaos as TC


def _poisoned(seed, shape=(40, 5)):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 10.0 ** rng.uniform(-2, 7, shape)).astype(
        np.float32)
    flat = x.reshape(-1)
    idx = rng.choice(flat.size, 9, replace=False)
    flat[idx[:3]] = np.nan
    flat[idx[3:6]] = np.inf
    flat[idx[6:]] = -np.inf
    return x


def test_policies_match_reference():
    assert TG.GUARD_POLICIES == JG.GUARD_POLICIES


@pytest.mark.parametrize("clip", [1e6, 3.5])
def test_sanitize_matches_reference(clip):
    x = _poisoned(0)
    want = np.asarray(JG.sanitize(jnp.asarray(x), clip))
    got = TG.sanitize(torch.from_numpy(x), clip).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).all() and np.abs(got).max() <= np.float32(clip)


@pytest.mark.parametrize("policy", JG.GUARD_POLICIES)
@pytest.mark.parametrize("floor", [0.0, 1e-3])
@pytest.mark.parametrize("poison", [True, False])
def test_guard_grad_hess_matches_reference(policy, floor, poison):
    G = _poisoned(1) if poison else np.ones((40, 5), np.float32)
    H = np.abs(_poisoned(2)) if poison else np.full((40, 5), 1e-9,
                                                     np.float32)
    H[0, :2] = -3.0                               # negative: corruption
    jg, jh, jbad = JG.guard_grad_hess(jnp.asarray(G), jnp.asarray(H),
                                      policy, 1e6, floor)
    tg, th, tbad = TG.guard_grad_hess(torch.from_numpy(G.copy()),
                                      torch.from_numpy(H.copy()), policy,
                                      1e6, floor)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert (tbad is None) == (jbad is None)
    if tbad is not None:
        assert tbad.ndim == 0 and bool(tbad) == bool(jbad) == poison


@pytest.mark.parametrize("policy", JG.GUARD_POLICIES)
def test_guard_stats_and_skip_scale_match_reference(policy):
    stats = _poisoned(3, (30, 4))
    for prior in (None, False, True):
        jp = None if prior is None else jnp.asarray(prior)
        tp = None if prior is None else torch.tensor(prior)
        js, jbad = JG.guard_stats(jnp.asarray(stats), policy, 2.0, jp)
        ts, tbad = TG.guard_stats(torch.from_numpy(stats.copy()), policy,
                                  2.0, tp)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        assert (tbad is None) == (jbad is None)
        if tbad is not None:
            assert bool(tbad) == bool(jbad)
        want = float(JG.skip_scale(jbad, policy))
        got = TG.skip_scale(tbad, policy, "cpu")
        assert got.ndim == 0 and float(got) == want


def test_check_scores_host_names_the_round():
    F = torch.zeros(10, 3)
    TG.check_scores_host(F, 4)
    F[7, 1] = float("inf")
    with pytest.raises(TG.NonFiniteError, match="round 4") as err:
        TG.check_scores_host(F, 4)
    assert err.value.round == 4
    with pytest.raises(JG.NonFiniteError, match="round 4"):
        JG.check_scores_host(np.asarray(F), 4)


def test_nan_at_row_matches_reference():
    Y = np.arange(24, dtype=np.float32).reshape(8, 3)
    for outputs in (None, [0, 2]):
        j, t = (JC.NaNAtRow(2, rows=[1, 5], outputs=outputs),
                TC.NaNAtRow(2, rows=[1, 5], outputs=outputs))
        assert t.mutate_targets(torch.from_numpy(Y), 1) is not None
        assert not t.applied
        got = t.mutate_targets(torch.from_numpy(Y), 2).numpy()
        want = np.asarray(j.mutate_targets(jnp.asarray(Y), 2))
        np.testing.assert_array_equal(got, want)
        assert t.applied
    with pytest.raises(ValueError, match="integer class labels"):
        TC.NaNAtRow(0, rows=[0]).mutate_targets(torch.zeros(4, dtype=torch.int64), 0)


def test_nan_at_rows_features_matches_reference():
    X = np.random.default_rng(0).normal(size=(6, 4)).astype(np.float32)
    for cols in (None, [1, 3]):
        np.testing.assert_array_equal(TC.nan_at_rows(X, [0, 4], cols),
                                      JC.nan_at_rows(X, [0, 4], cols))


# -- fits ---------------------------------------------------------------------

N, M, D = 300, 6, 3
KW = dict(loss="multitask_mse", n_trees=4, depth=3, n_bins=16,
          learning_rate=0.3, sketch_k=2, min_data_in_leaf=10.0, seed=5)


@functools.lru_cache(maxsize=None)
def _data():
    X, y = make_tabular("multitask_mse", N + 80, M, D, seed=3,
                        n_informative=M)
    return X[:N], y[:N], X[N:], y[N:]


def _pi(n_rounds):
    """The reference's per-round Pi (its ``k_key`` draws)."""
    key, out = jax.random.key(KW["seed"]), []
    for _ in range(n_rounds):
        key, sub = jax.random.split(key)
        k_key, _, _ = jax.random.split(sub, 3)
        out.append(np.asarray(JS.random_projection_matrix(D, 2, k_key)))
    return out


@functools.lru_cache(maxsize=None)
def _ref(policy, strategy="single_tree", nan_round=1, **kw):
    X, y, _, _ = _data()
    cfg = JB.GBDTConfig(guard_policy=policy, strategy=strategy,
                        use_kernel="jnp", loop="python", **KW, **kw)
    chaos = None if nan_round is None else JC.NaNAtRow(nan_round, [0, 7])
    return JB.SketchBoost(cfg).fit(X, y, check_input=False, chaos=chaos)


def _port(policy, strategy="single_tree", nan_round=1, **kw):
    X, y, _, _ = _data()
    cfg = TB.GBDTConfig(guard_policy=policy, strategy=strategy, **KW, **kw)
    chaos = None if nan_round is None else TC.NaNAtRow(nan_round, [0, 7])
    return TB.SketchBoost(cfg, device="cpu").fit(
        X, y, check_input=False, chaos=chaos, sketch_mats=_pi(KW["n_trees"]))


@pytest.mark.parametrize("strategy", ["single_tree", "one_vs_all"])
@pytest.mark.parametrize("policy", ["skip_round", "clip"])
def test_guarded_fit_matches_reference(policy, strategy):
    """NaN targets from round 1 on: the same trees as the reference's,
    predictions within atol 1e-4, and finite."""
    ref_m, port = _ref(policy, strategy), _port(policy, strategy)
    X = _data()[2]
    np.testing.assert_array_equal(port.packed.feat.numpy(),
                                  np.asarray(ref_m.packed.feat))
    np.testing.assert_array_equal(port.packed.thr.numpy(),
                                  np.asarray(ref_m.packed.thr))
    got = port.predict_raw(X).numpy()
    np.testing.assert_allclose(got, np.asarray(ref_m.predict_raw(X)),
                               atol=1e-4)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("strategy", ["single_tree", "one_vs_all"])
def test_skip_round_zeroes_every_poisoned_round(strategy):
    """Rounds before the injection are those of a clean fit, bit for bit;
    from it on every tree's leaves and gains are 0 (under one-vs-all every
    output's tree), so the training scores stop moving."""
    clean = _port("skip_round", strategy, nan_round=None)
    hit = _port("skip_round", strategy, nan_round=1)
    t = hit.packed.trees_per_round
    np.testing.assert_array_equal(hit.packed.leaf[:t].numpy(),
                                  clean.packed.leaf[:t].numpy())
    assert (hit.packed.leaf[t:] == 0).all() and (hit.packed.gain[t:] == 0).all()
    X = _data()[0]
    assert torch.equal(hit.predict_raw(X), hit.predict_raw(X, iteration=1))


@pytest.mark.parametrize("strategy", ["single_tree", "one_vs_all"])
def test_raise_names_the_round(strategy):
    with pytest.raises(JG.NonFiniteError, match="round 1"):
        _ref("raise", strategy)
    with pytest.raises(TG.NonFiniteError, match="round 1") as err:
        _port("raise", strategy)
    assert err.value.round == 1


def test_off_lets_nan_poison_the_scores():
    """The failure mode the guards exist for, as in the reference."""
    port = _port("off")
    assert not torch.isfinite(port.predict_raw(_data()[2])).all()
    assert not np.isfinite(np.asarray(_ref("off").predict_raw(_data()[2]))).all()


@pytest.mark.parametrize("strategy", ["single_tree", "one_vs_all"])
def test_hessian_floor_matches_reference(strategy):
    """``hessian_floor`` with ``lambda_l2=0`` under every policy: the fit
    stays finite and matches the reference."""
    kw = dict(hessian_floor=1e-3, lambda_l2=0.0, nan_round=None)
    ref_m, port = _ref("off", strategy, **kw), _port("off", strategy, **kw)
    X = _data()[2]
    got = port.predict_raw(X).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(ref_m.predict_raw(X)),
                               atol=1e-4)


def test_floor_bounds_leaves_of_a_degenerate_hessian():
    """A loss whose hessians vanish: without the floor and lambda the
    leaves divide by 0; with it every leaf is finite."""
    G = torch.tensor([[1.0], [-2.0]])
    H = torch.zeros(2, 1)
    _, h, _ = TG.guard_grad_hess(G, H, "off", 1e6, 1e-3)
    assert torch.isfinite(-G / h).all() and float(h.min()) == np.float32(1e-3)


def test_guard_options_validated_as_the_reference():
    for bad, match in ((dict(guard_policy="panic"), "guard_policy"),
                       (dict(guard_clip=0.0), "guard_clip"),
                       (dict(hessian_floor=-1.0), "hessian_floor")):
        with pytest.raises(ValueError, match=match):
            JB.GBDTConfig(**bad).validate()
        with pytest.raises(ValueError, match=match):
            TB.GBDTConfig(**bad).validate()
    for policy in TG.GUARD_POLICIES:
        TB.GBDTConfig(guard_policy=policy, hessian_floor=0.1).validate()


def test_nonfinite_targets_need_check_input_off():
    X, y, _, _ = _data()
    y = y.copy()
    y[3, 0] = np.nan
    with pytest.raises(ValueError, match="check_input=False"):
        TB.SketchBoost(TB.GBDTConfig(**KW), device="cpu").fit(X, y)
