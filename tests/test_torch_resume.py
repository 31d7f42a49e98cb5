"""Kill and resume: round checkpoints (format v4), ``resume_from``, the
chaos kills, `CheckpointManager.restore`, `RestartableLoop` and
`StragglerWatchdog`, on the CPU.

A fit killed at a round boundary (`runtime.chaos.KillAtRound`) and resumed
from its last checkpoint gives the uninterrupted fit's forest, scores and
history bit for bit: the checkpoint holds the draws' generator state at
the boundary (``train/generator``).  The JAX package's steps cross over
both ways: a port-written step serves through the reference's
``load_forest_checkpoint``, and a JAX-written step (a threefry key, no
generator) resumes in the port with the reference's remaining draws
replayed.  The refusals mirror ``tests/test_fault_tolerance.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import boosting as JB
from repro.core import sketch as JS
from repro.data.pipeline import make_tabular
from repro.io import checkpoint as JK
from repro.runtime import chaos as JC
from repro_torch.core import boosting as TB
from repro_torch.io import checkpoint as TK
from repro_torch.runtime import chaos as TC
from repro_torch.runtime import fault as TF

N, M, D, BINS = 240, 6, 4, 16


def _cfg(**kw):
    base = dict(loss="multiclass", n_trees=6, depth=3, n_bins=BINS,
                learning_rate=0.3, sketch_k=2, seed=7)
    base.update(kw)
    return TB.GBDTConfig(**base)


@functools.lru_cache(maxsize=None)
def _data(task="multiclass"):
    X, y = make_tabular(task, N, M, D, seed=1, n_informative=M)
    Xv, yv = make_tabular(task, 80, M, D, seed=2, n_informative=M)
    return X, y, Xv, yv


def _fit(cfg, chaos=None, eval_set=True, task="multiclass", **kw):
    X, y, Xv, yv = _data(task)
    return TB.SketchBoost(cfg, device="cpu").fit(
        X, y, eval_set=(Xv, yv) if eval_set else None, chaos=chaos, **kw)


def _strip(history):
    """History records without their wall-clock times."""
    return [{k: v for k, v in r.items() if not k.endswith("_s")}
            for r in history]


def _assert_bitwise(a, b):
    for f in a.packed._fields:
        x, z = getattr(a.packed, f), getattr(b.packed, f)
        if torch.is_tensor(x):
            assert torch.equal(x, z), f
        else:
            assert x == z, f
    for x, z in zip(a.forest, b.forest):
        assert (x is None and z is None) or torch.equal(x, z)
    assert _strip(a.history) == _strip(b.history)
    assert a.best_round == b.best_round


def _kill_and_resume(tmp_path, cfg, kill, save_every=2, task="multiclass",
                     eval_set=True):
    ck = dataclasses.replace(cfg, save_every=save_every,
                             ckpt_dir=str(tmp_path))
    with pytest.raises(TC.ChaosKill):
        _fit(ck, TC.KillAtRound(kill), eval_set, task)
    step = TK.CheckpointManager(str(tmp_path)).latest_step()
    assert step == (kill // save_every) * save_every
    return _fit(dataclasses.replace(ck, resume_from=str(tmp_path)),
                eval_set=eval_set, task=task)


@pytest.mark.parametrize("kw", [
    dict(sketch_method="random_projection"),
    dict(sketch_method="random_sampling"),
    dict(sketch_method="top_outputs"),
    dict(growth="leafwise", max_leaves=6),
    dict(strategy="one_vs_all"),
    dict(goss_a=0.2, goss_b=0.1, colsample=0.7),
    dict(subsample=0.6, strategy="one_vs_all", growth="leafwise",
         max_leaves=5)], ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
def test_kill_resume_bitwise(tmp_path, kw):
    """Killed at round 3 (the last checkpoint at 2), resumed: the same
    forest, packed model, training scores and history as the fit that ran
    through, bit for bit."""
    cfg = _cfg(**kw)
    ref = _fit(cfg)
    resumed = _kill_and_resume(tmp_path, cfg, kill=3)
    _assert_bitwise(resumed, ref)


def test_kill_resume_with_early_stopping(tmp_path):
    """An eval set and early stopping: the resumed run stops where the
    uninterrupted one stops, with the same best round and history."""
    cfg = _cfg(n_trees=40, learning_rate=1.5, early_stopping_rounds=2)
    ref = _fit(cfg)
    assert len(ref.history) < 40                   # it stopped early
    resumed = _kill_and_resume(tmp_path, cfg, kill=len(ref.history) - 1)
    _assert_bitwise(resumed, ref)


def test_resumed_scores_are_the_uninterrupted_scores(tmp_path):
    """F after the last round: the checkpoint's F plus the replayed rounds
    equals the uninterrupted run's F (read back from its final step)."""
    cfg = _cfg(n_trees=4, goss_a=0.3, goss_b=0.2)
    full = tmp_path / "full"
    _fit(dataclasses.replace(cfg, save_every=4, ckpt_dir=str(full)))
    _kill_and_resume(tmp_path / "cut", cfg, kill=3)
    a = TK.load_boost_checkpoint(str(full), device="cpu")
    b = TK.load_boost_checkpoint(str(tmp_path / "cut"), device="cpu")
    assert a.round == b.round == 4
    assert torch.equal(a.F, b.F) and torch.equal(a.Fv, b.Fv)
    assert torch.equal(a.generator, b.generator)


def test_kill_fires_once_so_rerun_with_same_object_passes(tmp_path):
    cfg = _cfg(save_every=2, ckpt_dir=str(tmp_path))
    kill = TC.KillAtRound(4)
    with pytest.raises(TC.ChaosKill):
        _fit(cfg, kill)
    assert kill.fired
    resumed = _fit(dataclasses.replace(cfg, resume_from=str(tmp_path)), kill)
    assert resumed.packed.n_rounds == cfg.n_trees


def test_drop_host_fires_once(tmp_path):
    drop = TC.DropHost(2, host=3)
    with pytest.raises(TC.HostLost, match="host 3 lost at round 2"):
        _fit(_cfg(n_trees=3), drop)
    assert _fit(_cfg(n_trees=3), drop).packed.n_rounds == 3


# -- refusals (the reference's tests/test_fault_tolerance.py) -------------------

def test_resume_under_different_config_refused(tmp_path):
    cfg = _cfg(save_every=2, ckpt_dir=str(tmp_path))
    with pytest.raises(TC.ChaosKill):
        _fit(cfg, TC.KillAtRound(2))
    bad = dataclasses.replace(cfg, resume_from=str(tmp_path),
                              learning_rate=0.123)
    with pytest.raises(ValueError, match="learning_rate"):
        _fit(bad)
    few = dataclasses.replace(cfg, resume_from=str(tmp_path), n_trees=1)
    with pytest.raises(ValueError, match="n_trees"):
        _fit(few)


def test_resume_from_serving_only_checkpoint_refused(tmp_path):
    model = _fit(_cfg())
    TK.save_forest_checkpoint(str(tmp_path), model.packed, model.quantizer,
                              metadata={"loss": "multiclass"})
    with pytest.raises(ValueError, match="serving-only"):
        _fit(_cfg(resume_from=str(tmp_path)))


def test_resume_eval_set_must_match_checkpoint(tmp_path):
    X, y, Xv, yv = _data()
    cfg = _cfg(save_every=2, ckpt_dir=str(tmp_path))
    with pytest.raises(TC.ChaosKill):
        _fit(cfg, TC.KillAtRound(2))
    rs = dataclasses.replace(cfg, resume_from=str(tmp_path))
    with pytest.raises(ValueError, match="eval"):
        TB.SketchBoost(rs, device="cpu").fit(X, y)
    with pytest.raises(ValueError, match="eval"):
        TB.SketchBoost(rs, device="cpu").fit(X, y,
                                             eval_set=(Xv[:32], yv[:32]))
    with pytest.raises(ValueError, match="training scores of shape"):
        TB.SketchBoost(rs, device="cpu").fit(X[:100], y[:100],
                                             eval_set=(Xv, yv))


def test_checkpoint_options_validated_as_the_reference():
    for bad, match in ((dict(save_every=-1), "save_every"),
                       (dict(save_every=2), "ckpt_dir"),
                       (dict(ckpt_keep=0), "ckpt_keep")):
        with pytest.raises(ValueError, match=match):
            JB.GBDTConfig(**bad).validate()
        with pytest.raises(ValueError, match=match):
            TB.GBDTConfig(**bad).validate()
    assert TB.RESUME_CFG_KEYS == JB.RESUME_CFG_KEYS
    assert _cfg(save_every=3, ckpt_dir="x", resume_from="y").strip_io() == \
        _cfg()


# -- interop with the JAX package's steps --------------------------------------

def test_port_step_serves_in_the_reference(tmp_path):
    """A port-written v4 step is a serving checkpoint for the reference's
    ``load_forest_checkpoint``: its forest predicts what the port's
    model predicts, and ``best_iteration`` rides along."""
    from repro.core import forest as JF
    from repro.core.quantize import apply_quantizer
    cfg = _cfg(save_every=3, ckpt_dir=str(tmp_path), ckpt_keep=1)
    model = _fit(cfg)
    packed, quantizer, meta = JK.load_forest_checkpoint(str(tmp_path))
    assert meta["train"]["round"] == 6 and meta["loss"] == "multiclass"
    assert meta["best_iteration"] == model.best_round + 1
    Xv = _data()[2]
    codes = apply_quantizer(quantizer, jnp.asarray(Xv))
    want = np.asarray(JF.predict_raw(packed, codes, mode="jnp"))
    np.testing.assert_allclose(model.predict_raw(Xv).numpy(), want,
                               atol=1e-5)
    assert TK.CheckpointManager(str(tmp_path)).all_steps() == [6]


def _jax_draws(seed, n_rounds, d, k):
    """The reference's per-round (Pi, row uniforms) of a fit."""
    key, mats, rows = jax.random.key(seed), [], []
    for _ in range(n_rounds):
        key, sub = jax.random.split(key)
        k_key, s_key, _ = jax.random.split(sub, 3)
        mats.append(np.asarray(JS.random_projection_matrix(d, k, k_key)))
        rows.append(np.array(jax.random.uniform(s_key, (N,))))
    return mats, rows


def test_jax_step_resumes_in_the_port_with_replayed_draws(tmp_path):
    """The reference killed at round 3 leaves a step at round 2 holding a
    threefry key; the port resumes it only with the remaining draws
    injected, and then ends within atol 1e-4 of the reference's
    uninterrupted fit, with the same splits and best round."""
    X, y, Xv, yv = _data()
    kw = dict(loss="multiclass", n_trees=5, depth=3, n_bins=BINS,
              learning_rate=0.3, sketch_k=2, seed=7, goss_a=0.2, goss_b=0.1,
              min_data_in_leaf=10.0)
    jcfg = JB.GBDTConfig(use_kernel="jnp", loop="python", **kw)
    ref_m = JB.SketchBoost(jcfg).fit(X, y, eval_set=(Xv, yv))
    ck = dataclasses.replace(jcfg, save_every=2, ckpt_dir=str(tmp_path))
    with pytest.raises(JC.ChaosKill):
        JB.SketchBoost(ck).fit(X, y, eval_set=(Xv, yv),
                               chaos=JC.KillAtRound(3))
    tcfg = TB.GBDTConfig(resume_from=str(tmp_path), **kw)
    state = TK.load_boost_checkpoint(str(tmp_path), device="cpu")
    assert state.generator is None and state.key is not None
    assert state.round == 2
    with pytest.raises(ValueError, match="threefry"):
        TB.SketchBoost(tcfg, device="cpu").fit(X, y, eval_set=(Xv, yv))
    mats, rows = _jax_draws(7, 5, D, 2)
    port = TB.SketchBoost(tcfg, device="cpu").fit(
        X, y, eval_set=(Xv, yv), sketch_mats=mats, sample_draws=rows)
    np.testing.assert_array_equal(port.packed.feat.numpy(),
                                  np.asarray(ref_m.packed.feat))
    np.testing.assert_array_equal(port.packed.thr.numpy(),
                                  np.asarray(ref_m.packed.thr))
    np.testing.assert_allclose(port.predict_raw(Xv).numpy(),
                               np.asarray(ref_m.predict_raw(Xv)), atol=1e-4)
    assert port.best_round == ref_m.best_round
    # The two first rounds are the reference's, carried over from its step.
    assert [h["round"] for h in port.history] == list(range(5))


def test_generator_of_another_device_refused(tmp_path):
    cfg = _cfg(save_every=2, ckpt_dir=str(tmp_path))
    with pytest.raises(TC.ChaosKill):
        _fit(cfg, TC.KillAtRound(3))
    mgr = TK.CheckpointManager(str(tmp_path))
    man = mgr.manifest(2)
    man["metadata"]["train"]["generator_device"] = "cuda"
    import json
    import os
    with open(os.path.join(str(tmp_path), "step_2", "manifest.json"),
              "w") as f:
        json.dump(man, f)
    with pytest.raises(ValueError, match="resume on the device"):
        _fit(dataclasses.replace(cfg, resume_from=str(tmp_path)))


# -- CheckpointManager.restore, RestartableLoop, StragglerWatchdog -------------

def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32)),
            "opt": {"m": torch.zeros(8, 4), "step": torch.tensor(3)},
            "nested": [torch.arange(5), torch.tensor(2.5),
                       torch.ones(3, dtype=torch.bfloat16)]}


def test_checkpoint_restore_like(tmp_path):
    """Restore into the structure of a template, dtypes kept (bf16 too);
    the reference's restore reads the same step."""
    mgr = TK.CheckpointManager(str(tmp_path), async_save=False)
    state = _state()
    mgr.save(7, state, metadata={"note": "x"})
    restored, step = mgr.restore(_state(1), device="cpu")
    assert step == 7 and list(restored) == list(state)
    for a, b in zip(TK._flatten(state), TK._flatten(restored)):
        assert a[0] == b[0] and a[1].dtype == b[1].dtype
        assert torch.equal(a[1], b[1])
    assert mgr.manifest(7)["metadata"]["note"] == "x"
    like = {"w": 0, "opt": {"m": 0, "step": 0}}
    jrest, _ = JK.CheckpointManager(str(tmp_path)).restore(like)
    np.testing.assert_array_equal(np.asarray(jrest["w"]), state["w"].numpy())
    with pytest.raises(NotImplementedError, match="distributed slice"):
        mgr.restore(state, shardings=object())


def test_restartable_loop_resumes(tmp_path):
    """Killed after 5 steps; a fresh loop resumes at step 5 from the
    checkpoint and continues the same trajectory."""
    def step_fn(state, batch):
        w, i = state
        return (w + batch, i + 1), {"w_sum": float(w)}

    batches = [torch.tensor(float(x)) for x in range(10)]
    loop1 = TF.RestartableLoop(str(tmp_path), step_fn, save_every=2,
                               async_save=False, device="cpu")
    loop1.run((torch.tensor(0.0), 0), iter(batches[:5]), 5)
    loop2 = TF.RestartableLoop(str(tmp_path), step_fn, save_every=2,
                               async_save=False, device="cpu")
    _, start = loop2.resume_or_init((torch.tensor(0.0), 0))
    assert start == 5
    state2, n2 = loop2.run((torch.tensor(0.0), 0), iter(batches[5:]), 10)
    assert n2 == 10 and float(state2[0]) == sum(range(10))
    assert int(state2[1]) == 10


def test_restartable_loop_chaos_kill_and_save_fn(tmp_path):
    """Kill-style chaos fires at a step boundary; a ``save_fn`` /
    ``restore_fn`` pair takes the persistence over."""
    saved = {}

    def step_fn(state, batch):
        return state + batch, {}

    loop = TF.RestartableLoop("", step_fn, save_every=2,
                              save_fn=lambda s, st: saved.update({s: st}),
                              restore_fn=lambda: None,
                              chaos=TC.KillAtRound(3))
    with pytest.raises(TC.ChaosKill):
        loop.run(0, None, 6)
    assert saved == {1: 1}                      # steps 0 and 1: 0 + 0 + 1
    resumed = TF.RestartableLoop(
        "", step_fn, save_every=2, restore_fn=lambda: (saved[1], 2),
        save_fn=lambda s, st: saved.update({s: st}))
    state, n = resumed.run(0, None, 6)
    assert n == 6 and state == sum(range(6))


def test_straggler_watchdog_flags_outlier():
    wd = TF.StragglerWatchdog(window=8, threshold=2.0)
    assert not any(wd.observe(0.1) for _ in range(8))
    assert wd.observe(1.0) and wd.flagged == 1


def test_restartable_loop_virtual_delay_feeds_watchdog():
    """`DelayShard` adds virtual seconds to the watchdog's observations:
    straggler detection without sleeping, as in the reference."""
    def step_fn(state, batch):
        return state + 1, {}

    seen = []
    wd = TF.StragglerWatchdog(window=16, threshold=2.0)
    loop = TF.RestartableLoop("", step_fn, save_every=0,
                              chaos=TC.DelayShard(10, 60.0), watchdog=wd)
    _, n = loop.run(0, None, 12, on_metrics=lambda s, m: seen.append(
        (s, m["straggler"])))
    assert n == 12 and wd.flagged >= 1 and (10, True) in seen
    jd, td = JC.DelayShard(3, 2.0, every=4), TC.DelayShard(3, 2.0, every=4)
    assert ([td.extra_time(r) for r in range(20)]
            == [jd.extra_time(r) for r in range(20)])
    assert TC.total_extra_time((td, td), 7) == 4.0
