"""The default loop: `boost_scan` segments against the per-round loop.

The port of ``tests/test_boost_scan.py``.  ``loop="scan"`` runs rounds in
segments of ``scan_chunk`` (cut at ``save_every`` and chaos rounds), reads
each segment's validation losses once and replays early stopping on the
host; ``loop="python"`` runs and reads round by round.  Both must train
the same forest bit for bit, with the same history but for
``train_time_s``.  `boost_scan` itself is held to the reference's on the
same codes and the reference's projections.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import boosting as JB
from repro.core import sketch as JS
from repro.data.pipeline import make_tabular, train_test_split
from repro_torch.core import boosting as TB
from repro_torch.core import tree as TT
from repro_torch.io import checkpoint as TK
from repro_torch.runtime import chaos as TC


@functools.lru_cache(maxsize=None)
def _data():
    X, y = make_tabular("multiclass", 900, 10, 5, seed=11, n_informative=10)
    return train_test_split(X, y, seed=11)


def _fit(loop, eval_set=True, chaos=None, **kw):
    Xtr, Xte, ytr, yte = _data()
    kw = dict(dict(loss="multiclass", depth=3, learning_rate=0.3,
                   sketch_k=3, seed=7), **kw)
    cfg = TB.GBDTConfig(loop=loop, **kw)
    return TB.SketchBoost(cfg, device="cpu").fit(
        Xtr, ytr, eval_set=(Xte, yte) if eval_set else None, chaos=chaos)


def _strip(history):
    return [{k: v for k, v in r.items() if k != "train_time_s"}
            for r in history]


def _assert_same_fit(a, b):
    for x, z in zip(a.forest, b.forest):
        assert (x is None and z is None) or torch.equal(x, z)
    for f in ("feat", "thr", "leaf", "gain", "cover"):
        assert torch.equal(getattr(a.packed, f), getattr(b.packed, f)), f
    assert _strip(a.history) == _strip(b.history)
    assert a.best_round == b.best_round


CASES = {
    "chunk1": dict(n_trees=5, scan_chunk=1),
    "chunk3_uneven": dict(n_trees=8, scan_chunk=3),
    "chunk32_one_segment": dict(n_trees=8, scan_chunk=32),
    "early_stop_inside_a_segment": dict(n_trees=50, learning_rate=1.0,
                                        early_stopping_rounds=4,
                                        scan_chunk=8),
    "eval_every_3": dict(n_trees=24, learning_rate=1.0, eval_every=3,
                         early_stopping_rounds=6, scan_chunk=7),
    "sampled": dict(n_trees=7, subsample=0.8, colsample=0.7, scan_chunk=3),
    "one_vs_all": dict(n_trees=5, strategy="one_vs_all", scan_chunk=2),
    "leafwise": dict(n_trees=5, growth="leafwise", max_leaves=6,
                     scan_chunk=2),
}


@pytest.mark.parametrize("name", list(CASES))
def test_scan_loop_trains_the_python_loops_forest(name):
    kw = CASES[name]
    scan, py = _fit("scan", **kw), _fit("python", **kw)
    _assert_same_fit(scan, py)
    if kw.get("early_stopping_rounds"):
        n = len(scan.history)
        assert n < kw["n_trees"] and n % kw["scan_chunk"] != 0, n


def test_scan_segments_are_cut_at_checkpoints(tmp_path, monkeypatch):
    """``save_every=3`` over 10 rounds at ``scan_chunk=4``: segments of 3,
    3, 3 and 1 rounds, and each checkpoint the python loop's, bitwise."""
    steps, real = [], TB.boost_scan

    def spy(*a, **kw):
        steps.append(kw["n_steps"])
        return real(*a, **kw)
    monkeypatch.setattr(TB, "boost_scan", spy)
    kw = dict(n_trees=10, scan_chunk=4, save_every=3, ckpt_keep=5)
    scan = _fit("scan", ckpt_dir=str(tmp_path / "scan"), **kw)
    py = _fit("python", ckpt_dir=str(tmp_path / "py"), **kw)
    assert steps == [3, 3, 3, 1]
    _assert_same_fit(scan, py)
    a, b = (TK.CheckpointManager(str(tmp_path / d)) for d in ("scan", "py"))
    assert a.all_steps() == b.all_steps() == [3, 6, 9]
    for step in (3, 6, 9):
        sa = TK.load_boost_checkpoint(str(tmp_path / "scan"), step,
                                      device="cpu")
        sb = TK.load_boost_checkpoint(str(tmp_path / "py"), step,
                                      device="cpu")
        assert torch.equal(sa.F, sb.F) and torch.equal(sa.Fv, sb.Fv)
        for x, z in zip(sa.trees, sb.trees):
            assert (x is None and z is None) or torch.equal(x, z)
        assert torch.equal(sa.generator, sb.generator)


@pytest.mark.parametrize("loop,reads", [("scan", 2), ("python", 8)])
def test_validation_loss_is_read_once_a_segment(monkeypatch, loop, reads):
    """8 rounds at ``scan_chunk=4``: the scan loop reads the validation
    losses twice (a list of 4 each time), the python loop 8 times."""
    got, real = [], TB._to_host

    def spy(t):
        got.append(tuple(t.shape))
        return real(t)
    monkeypatch.setattr(TB, "_to_host", spy)
    _fit(loop, n_trees=8, scan_chunk=4)
    assert len(got) == reads
    assert got == ([(4,)] * 2 if loop == "scan" else [()] * 8)


def test_kill_and_resume_across_a_segment_boundary(tmp_path):
    """``scan_chunk=3``, ``save_every=4``: killed at round 5 (the segment
    [4, 5) ended there), resumed from round 4 in new segments; the forest,
    history and packed model of the fit that ran through, bit for bit, and
    that of the python loop."""
    kw = dict(n_trees=10, scan_chunk=3)
    full = _fit("scan", **kw)
    ck = dict(kw, save_every=4, ckpt_dir=str(tmp_path))
    with pytest.raises(TC.ChaosKill):
        _fit("scan", chaos=TC.KillAtRound(5), **ck)
    assert TK.CheckpointManager(str(tmp_path)).latest_step() == 4
    resumed = _fit("scan", resume_from=str(tmp_path), **ck)
    _assert_same_fit(resumed, full)
    _assert_same_fit(resumed, _fit("python", **kw))


def test_scan_history_times_are_monotone():
    m = _fit("scan", eval_set=False, n_trees=10, scan_chunk=4)
    times = [r["train_time_s"] for r in m.history]
    assert [r["round"] for r in m.history] == list(range(10))
    assert all(b >= a for a, b in zip(times, times[1:]))


def test_predict_matches_the_forest_replay_after_a_scan_fit():
    m = _fit("scan", eval_set=False, n_trees=6, scan_chunk=4,
             sketch_method="none")
    codes = m._bin(_data()[1])
    replay = TT.predict_forest(m.forest, codes, m.cfg.learning_rate,
                               m.base_score)
    assert torch.equal(m.predict_raw(_data()[1]), replay)


# -- boost_scan against the reference's ---------------------------------------

def _reference_projections(seed, n_rounds, d, k):
    """The reference's per-round Pi in `boost_scan`: the key is split once
    a round, and the round's key into (sketch, sample, column) keys."""
    key, out = jax.random.key(seed), []
    for _ in range(n_rounds):
        key, sub = jax.random.split(key)
        k_key, _, _ = jax.random.split(sub, 3)
        out.append(np.array(JS.random_projection_matrix(d, k, k_key)))
    return out


@pytest.mark.parametrize("has_eval", [False, True])
def test_boost_scan_stacks_trees_and_tracks_the_reference(has_eval):
    Xtr, Xte, ytr, yte = _data()
    d, steps = 5, 5
    jm = JB.SketchBoost(JB.GBDTConfig(n_trees=1, depth=3, use_kernel="jnp",
                                      loop="python")).fit(Xtr, ytr)
    jcfg = dataclasses.replace(jm.cfg, n_trees=steps, sketch_k=3,
                               min_data_in_leaf=20.0, learning_rate=0.3)
    codes, codes_v = np.array(jm._bin(Xtr)), np.array(jm._bin(Xte))
    n, nv = codes.shape[0], codes_v.shape[0]
    base = np.array(jm.base_score)
    F = np.broadcast_to(base, (n, d)).astype(np.float32)
    Fv = np.broadcast_to(base, (nv, d)).astype(np.float32)
    if has_eval:
        jF, jFv, _, jtrees, jvl = JB.boost_scan(
            F.copy(), codes, ytr, Fv.copy(), codes_v, yte,
            jax.random.key(0), cfg=jcfg, n_steps=steps, has_eval=True)
    else:
        jF, _, _, jtrees, jvl = JB.boost_scan(
            F.copy(), codes, ytr, F[:1].copy(), codes[:1], ytr[:1],
            jax.random.key(0), cfg=jcfg, n_steps=steps, has_eval=False)

    tcfg = TB.GBDTConfig(n_trees=steps, depth=3, sketch_k=3,
                         min_data_in_leaf=20.0,
                         learning_rate=0.3).resolve(d)
    c = torch.from_numpy(codes)
    cv = torch.from_numpy(codes_v)
    draws = [(p, None, None) for p in _reference_projections(0, steps, d, 3)]
    tF, tFv, trees, vloss = TB.boost_scan(
        torch.from_numpy(F.copy()), c, c.t().contiguous(),
        torch.from_numpy(ytr).long(),
        torch.from_numpy(Fv.copy()) if has_eval else None,
        cv if has_eval else None,
        torch.from_numpy(yte).long() if has_eval else None, tcfg,
        n_steps=steps, has_eval=has_eval, draws=draws)
    assert isinstance(trees, TT.Forest)
    assert trees.feat.shape == (steps, 7) and trees.thr.shape == (steps, 7)
    assert trees.value.shape == (steps, 8, d)
    assert vloss.shape == (steps,) and vloss.dtype == torch.float32
    np.testing.assert_array_equal(trees.feat.numpy(), np.asarray(jtrees.feat))
    np.testing.assert_array_equal(trees.thr.numpy(), np.asarray(jtrees.thr))
    np.testing.assert_allclose(trees.value.numpy(), np.asarray(jtrees.value),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tF.numpy(), np.asarray(jF), atol=1e-5)
    if has_eval:
        np.testing.assert_allclose(vloss.numpy(), np.asarray(jvl), rtol=1e-5)
        assert float(vloss[-1]) < float(vloss[0])
    else:
        assert tFv is None and (vloss == 0).all()
        assert (np.asarray(jvl) == 0).all()
