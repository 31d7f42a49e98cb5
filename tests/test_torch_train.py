"""Port vs reference: LM training (B7's backward, `lm.lm_loss` and its
gradients, the train step, the prefetcher, the launcher).

Inputs are made with seeded numpy generators; the reference's random
parameters (``repro.models.lm.init``) are carried over with
`repro_torch.io.convert.lm_params_from_arrays` and its optimizer state
with `convert.opt_state_from_arrays`; the port's trees go back through
`convert.lm_tree_to_arrays` (blocks stacked) to be compared.  Everything
runs in float32.  The reference's gradients come from XLA's autodiff of
its ``use_pallas=False`` forward (``chunked_attention``, which rounds the
probabilities to the model dtype: a no-op in float32); the port's from
autograd of its plain versions on the CPU.

Tolerances.  B7's plain backward against autograd of the plain forward:
atol 1e-5 + rtol 1e-5 (both float32; the sums run in other orders).
Against ``jax.vjp`` of ``chunked_attention``: atol 2e-5 + rtol 1e-4.  The
loss and each gradient leaf of a whole model within 1e-4 of the leaf's
largest magnitude (two libraries' matmul and transcendental rounding
through a few layers, forward and back).  Parameters after optimizer
steps, the same; microbatches and remat against their plain run within
1e-5 of each leaf's largest magnitude (one library, summed in another
order, or bitwise).
"""
import argparse
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.data import pipeline as JP
from repro.launch import train as JTR
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.training import optimizer as JO
from repro.training import train_lib as JT
from repro_torch import configs as TC
from repro_torch.data import pipeline as TP
from repro_torch.io import convert
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref as TR
from repro_torch.launch import train as TTR
from repro_torch.models import lm as TLM
from repro_torch.runtime import chaos as CH
from repro_torch.training import optimizer as TO
from repro_torch.training import train_lib as TT

LEAF_TOL = 1e-4


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a).view(np.uint16)
                        if a.dtype == jnp.bfloat16 else np.asarray(a), tree)


def _leaf_close(want, got, tol=LEAF_TOL):
    """Each leaf within ``tol`` of its largest magnitude."""
    wl, gl = jax.tree.leaves(want), jax.tree.leaves(got)
    assert len(wl) == len(gl)
    for a, b in zip(wl, gl):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert a.shape == b.shape
        err = float(np.max(np.abs(a - b)))
        assert err <= tol * max(float(np.max(np.abs(a))), 1e-30), err


# ---------------------------------------------------------------------------
# B7's backward
# ---------------------------------------------------------------------------

# (b, hq, hkv, sq, sk, dh, causal, window)
BWD_CASES = {
    "causal_mha": (2, 2, 2, 40, 40, 16, True, None),
    "causal_gqa": (1, 6, 2, 70, 70, 32, True, None),
    "windowed_gqa": (2, 4, 1, 90, 90, 24, True, 17),
    "cross": (2, 4, 2, 33, 50, 16, False, None),
    "dh120_window": (1, 4, 2, 64, 64, 120, True, 32),
    "chunked_rows": (1, 2, 1, 1100, 1100, 8, True, 600),
}


def _qkv(b, hq, hkv, sq, sk, dh, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=s).astype(np.float32) for s in
            ((b, hq, sq, dh), (b, hkv, sk, dh), (b, hkv, sk, dh),
             (b, hq, sq, dh)))


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_flash_bwd_ref_matches_autograd_and_reference_vjp(case):
    b, hq, hkv, sq, sk, dh, causal, window = BWD_CASES[case]
    q, k, v, do = _qkv(b, hq, hkv, sq, sk, dh)
    kw = dict(causal=causal, window=window)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = TR.flash_attention_ref(tq, tk, tv, **kw)
    want = torch.autograd.grad(out, (tq, tk, tv), torch.tensor(do))
    o, lse = FA.flash_attention_lse(*(torch.tensor(x) for x in (q, k, v)),
                                    **kw)
    assert torch.equal(o, out.detach())
    got = FA.flash_attention_bwd(*(torch.tensor(x) for x in (q, k, v)), o,
                                 lse, torch.tensor(do), **kw)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5,
                                   rtol=1e-5)
    # The reference's attention takes (b, s, h, dh).
    t = lambda x: jnp.asarray(np.swapaxes(x, 1, 2))

    @jax.jit
    def vjp(a, c, e, d):
        return jax.vjp(lambda a, c, e: JL.chunked_attention(
            a, c, e, chunk=256, **kw), a, c, e)[1](d)
    for w, g in zip(vjp(t(q), t(k), t(v), t(do)), got):
        np.testing.assert_allclose(g.numpy(), np.swapaxes(np.asarray(w), 1, 2),
                                   atol=2e-5, rtol=1e-4)


def test_flash_attention_is_differentiable_on_the_cpu():
    """The wrapper's CPU path is the plain version under autograd; its lse
    is the log-sum-exp of each row's scaled, masked scores."""
    q, k, v, _ = _qkv(1, 4, 2, 20, 20, 8, seed=3)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    FA.flash_attention(tq, tk, tv, causal=True, window=5).sum().backward()
    assert all(t.grad is not None and t.grad.abs().sum() > 0
               for t in (tq, tk, tv))
    _, lse = FA.flash_attention_lse(*(torch.tensor(x) for x in (q, k, v)),
                                    causal=True, window=5)
    s = np.einsum("hqd,hkd->hqk", q[0], np.repeat(k[0], 2, 0)) / math.sqrt(8)
    i, j = np.arange(20)[:, None], np.arange(20)[None, :]
    s = np.where((j <= i) & (i - j < 5), s, -np.inf)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    np.testing.assert_allclose(lse[0].numpy(), want, atol=1e-5, rtol=1e-6)


def test_flash_bwd_wrapper_checks_inputs():
    q, k, v, do = (torch.tensor(x) for x in _qkv(1, 2, 1, 8, 8, 4))
    o, lse = FA.flash_attention_lse(q, k, v)
    with pytest.raises(ValueError, match="lse must be float32"):
        FA.flash_attention_bwd(q, k, v, o, lse[:, :1], do)
    with pytest.raises(ValueError, match="dout must be"):
        FA.flash_attention_bwd(q, k, v, o, lse, do.to(torch.bfloat16))


def _bf16_ulps(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each element's own magnitude (0 where it is 0)."""
    m, e = torch.frexp(x.float())
    return torch.where(m == 0, torch.zeros_like(m),
                       torch.ldexp(torch.ones_like(m), e - 8))


def _exact_split(x: torch.Tensor) -> tuple:
    """`ref.split_bf16x3` of x, asserting hi + mid + lo == x bit for bit
    (a zero's sign aside: -0 comes back as +0, which adds the same); the
    parts as float32."""
    parts = tuple(t.float() for t in TR.split_bf16x3(x))
    hi, mid, lo = parts
    total, nz = (hi + mid) + lo, x != 0
    assert torch.equal(total[nz].view(torch.int32), x[nz].view(torch.int32))
    assert bool((total[~nz] == 0).all())
    return parts


def test_flash_bwd_split_arithmetic_is_within_the_plain_limit():
    """The arithmetic of B7's backward bf16 body (`csrc/flash_attention_bwd.cu`)
    on the CPU: P and dS split into three bf16 parts (`ref.split_bf16x3`),
    each part's product with the bf16 dO, Q or K summed in float32, dV =
    sum P_i^T dO, dK = scale sum dS_i^T Q, dQ = scale sum dS_i K.  The parts
    add up to P and dS bit for bit, dS's signed, small and near-zero values
    and edge values included, and the gradients, rounded once to bf16, are
    within the card's limit of `flash_attention_bwd_ref`: one bf16 ulp of
    each plain value plus 1e-5 of the largest magnitude."""
    b, hq, hkv, sq, sk, dh, causal, window = 1, 4, 2, 70, 70, 24, True, 30
    group, scale = hq // hkv, 1.0 / math.sqrt(dh)
    q, k, v, do = (torch.tensor(x).to(torch.bfloat16)
                   for x in _qkv(b, hq, hkv, sq, sk, dh, seed=5))
    kw = dict(causal=causal, window=window)
    o, lse = FA.flash_attention_lse(q, k, v, **kw)
    qf, dof, of = q.float(), do.float(), o.float()
    kf, vf = (t.float().repeat_interleave(group, 1) for t in (k, v))
    i, j = torch.arange(sq)[:, None], torch.arange(sk)[None, :]
    seen = (j <= i) & (i - j < window)
    p = torch.where(seen, torch.exp(qf @ kf.transpose(-1, -2) * scale
                                    - lse[..., None]), 0.0)
    dp = dof @ vf.transpose(-1, -2)
    ds = p * (dp - (dof * of).sum(-1, keepdim=True))
    assert bool((ds < 0).any()) and bool((ds.abs() < 1e-6).any())
    edges = torch.tensor([0.0, -0.0, 2.0 ** -100, -2.0 ** -100, 1e-30,
                          -3e-20, 7.3e-5, -1.5, 1e4, -1e4], dtype=torch.float32)
    _exact_split(edges)
    p_parts, ds_parts = _exact_split(p), _exact_split(ds)
    dv = sum(t.transpose(-1, -2) @ dof for t in reversed(p_parts))
    dk = scale * sum(t.transpose(-1, -2) @ qf for t in reversed(ds_parts))
    dq = scale * sum(t @ kf for t in reversed(ds_parts))
    got = (dq, dk.reshape(b, hkv, group, sk, dh).sum(2),
           dv.reshape(b, hkv, group, sk, dh).sum(2))
    want = FA.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    for name, g, w in zip("qkv", got, want):
        w = w.float()
        diff = (g.to(torch.bfloat16).float() - w).abs()
        limit = _bf16_ulps(w) + 1e-5 * float(w.abs().max())
        assert bool((diff <= limit).all()), (name, float((diff / limit).max()))


# ---------------------------------------------------------------------------
# lm_loss and its gradients, every family
# ---------------------------------------------------------------------------

FAMILIES = {
    "h2o-danube-3-4b": dict(n_kv_heads=2),    # dense, GQA 2, window 16
    "phi3.5-moe-42b-a6.6b": {},               # MoE, capacity drops
    "mamba2-370m": {},                        # SSD
    "zamba2-1.2b": {},                        # SSD + one shared block
    "llama-3.2-vision-11b": {},               # cross sites
}


def _pair(arch, **over):
    kw = dict(FAMILIES[arch], dtype="float32", **over)
    jcfg = dataclasses.replace(JC.smoke_config(arch), **kw)
    tcfg = dataclasses.replace(TC.smoke_config(arch), **kw)
    jp = JLM.init(jcfg, jax.random.key(0))
    if "cross" in jp:                     # gates nonzero: cross blocks seen
        jp["cross"]["gate"] = jnp.asarray(np.random.default_rng(11).normal(
            size=jp["cross"]["gate"].shape).astype(np.float32))
    return jcfg, tcfg, jp, convert.lm_params_from_arrays(tcfg, _np(jp),
                                                         device="cpu")


def _batch(cfg, b=2, s=32, seed=0, loss_mask=False):
    rng = np.random.default_rng(seed)
    out = {"inputs": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        out["image_embeds"] = rng.normal(
            size=(b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    if loss_mask:
        out["loss_mask"] = (rng.random((b, s)) < 0.7).astype(np.float32)
    return out


def _grads(params, cfg, batch):
    leaves = TO.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, aux = TLM.lm_loss(params, cfg, batch)
    g = torch.autograd.grad(loss, leaves)
    return loss, aux, TO.tree_unflatten(params, g)


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_lm_loss_and_grads_match_reference(arch):
    jcfg, tcfg, jp, tp = _pair(arch)
    batch = _batch(tcfg, loss_mask=arch == "h2o-danube-3-4b")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JLM.lm_loss(p, jcfg, b), has_aux=True))(jp, jb)
    loss, aux, grads = _grads(tp, tcfg, batch)
    assert aux["ce"] is loss and loss.dtype == torch.float32
    assert abs(float(loss.detach()) - float(jl)) <= LEAF_TOL * abs(float(jl))
    _leaf_close(jg, convert.lm_tree_to_arrays(grads))


def test_lm_loss_is_a_masked_mean_cross_entropy():
    """The loss by hand from `lm.forward`'s logits: the padded vocab
    masked, a float32 log-softmax, the labels' log-probabilities weighted
    by the loss mask; all-zero weights give 0 (the divisor is at least
    1).  `forward` itself records no gradient."""
    cfg = dataclasses.replace(TC.smoke_config("gemma-7b"), dtype="float32",
                              vocab_size=500)
    assert cfg.padded_vocab > cfg.vocab_size
    p = TLM.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = _batch(cfg, loss_mask=True)
    logits = TLM.forward(p, cfg, batch)
    assert not logits.requires_grad
    logp = torch.log_softmax(logits + TLM.vocab_mask(cfg), -1)
    picked = logp.gather(-1, torch.tensor(batch["labels"]).long()[..., None])
    w = torch.tensor(batch["loss_mask"])
    want = -(picked[..., 0] * w).sum() / w.sum()
    loss, _ = TLM.lm_loss(p, cfg, batch)
    assert abs(float(loss) - float(want)) <= 1e-6 * float(want)
    batch["loss_mask"] = np.zeros_like(batch["loss_mask"])
    assert float(TLM.lm_loss(p, cfg, batch)[0]) == 0.0


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,step", [("adamw", 50), ("sgd", 3),
                                       ("adafactor", 7)])
def test_two_train_steps_match_reference(name, step):
    """Two steps from the same parameters and optimizer state (AdamW's
    moments drawn nonzero, carried over by `convert.opt_state_from_arrays`)
    at steps ``step`` and ``step + 1``: metrics, parameters and state."""
    jcfg, tcfg, jp, tp = _pair("h2o-danube-3-4b")
    kw = dict(name=name, warmup_steps=10, decay_steps=100, lr=1e-3,
              factored_min_dim=64)
    jtc = JT.TrainConfig(opt=JO.OptConfig(**kw))
    ttc = TT.TrainConfig(opt=TO.OptConfig(**kw))
    js = JO.opt_init(jp, jtc.opt)
    if name == "adamw":
        rng = np.random.default_rng(2)
        js = {"m": jax.tree.map(lambda a: jnp.asarray(1e-3 * rng.normal(
                  size=a.shape), jnp.float32), js["m"]),
              "v": jax.tree.map(lambda a: jnp.asarray(1e-6 * rng.random(
                  a.shape), jnp.float32), js["v"])}
    ts = convert.opt_state_from_arrays(tcfg, _np(js), device="cpu")
    jstep = jax.jit(JT.make_train_step(jcfg, jtc))
    tstep = TT.make_train_step(tcfg, ttc)
    for i in range(2):
        batch = _batch(tcfg, seed=10 + i)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in
                                    batch.items()}, jnp.int32(step + i))
        tp, ts, tm = tstep(tp, ts, batch, step + i)
        for key in ("loss", "grad_norm", "lr"):
            assert tm[key].dtype == torch.float32
            assert abs(float(tm[key]) - float(jm[key])) <= \
                LEAF_TOL * abs(float(jm[key])), key
    _leaf_close(jp, convert.lm_tree_to_arrays(tp))
    _leaf_close(js, convert.lm_tree_to_arrays(ts))


def _run_steps(cfg, batches, n=2):
    p = TLM.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    tc = TT.TrainConfig(opt=TO.OptConfig(warmup_steps=1, decay_steps=10))
    s = TO.opt_init(p, tc.opt)
    step = TT.make_train_step(cfg, tc)
    ms = []
    for i in range(n):
        p, s, m = step(p, s, batches[i], i)
        ms.append({k: float(v) for k, v in m.items()})
    return p, s, ms


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "mamba2-370m"])
def test_microbatches_and_remat_do_not_change_the_step(arch):
    """Two microbatches sum float32 gradients and divide by 2: the same
    step as one, within the sums' order; remat (each layer recomputed in
    the backward, or all but its matrix products with "dots") against
    none: bitwise."""
    cfg = dataclasses.replace(TC.smoke_config(arch), dtype="float32",
                              remat=False)
    batches = [_batch(cfg, b=4, s=16, seed=i) for i in range(2)]
    p1, s1, m1 = _run_steps(cfg, batches)
    p2, s2, m2 = _run_steps(dataclasses.replace(cfg, microbatches=2),
                            batches)
    p3, s3, m3 = _run_steps(dataclasses.replace(cfg, remat=True), batches)
    p4, s4, m4 = _run_steps(dataclasses.replace(cfg, remat=True,
                                                remat_policy="dots"), batches)
    want = convert.lm_tree_to_arrays(p1)
    _leaf_close(want, convert.lm_tree_to_arrays(p2), tol=1e-5)
    _leaf_close(convert.lm_tree_to_arrays(s1),
                convert.lm_tree_to_arrays(s2), tol=1e-5)
    for a, b in zip(m1, m2):
        assert abs(a["loss"] - b["loss"]) <= 1e-6 * a["loss"]
    assert m1 == m3 == m4
    for p in (p3, p4):
        for a, b in zip(jax.tree.leaves(want),
                        jax.tree.leaves(convert.lm_tree_to_arrays(p))):
            assert np.array_equal(a, b)


def test_train_step_refuses_a_mesh_and_a_ragged_batch():
    cfg = dataclasses.replace(TC.smoke_config("h2o-danube-3-4b"),
                              dtype="float32", microbatches=3)
    with pytest.raises(NotImplementedError, match="next slice"):
        TT.make_train_step(cfg, TT.TrainConfig(), mesh=object())
    step = TT.make_train_step(cfg, TT.TrainConfig())
    p = TLM.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="microbatches"):
        step(p, {}, _batch(cfg, b=4), 0)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "musicgen-medium",
                                  "llama-3.2-vision-11b"])
def test_input_specs_match_reference(kind, arch):
    jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
    want = JT.input_specs(jcfg, seq_len=4096, global_batch=8, kind=kind)
    got = TT.input_specs(tcfg, seq_len=4096, global_batch=8, kind=kind)
    assert set(got) == set(want)
    for k, s in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == s.shape
        assert str(got[k].dtype).removeprefix("torch.") == str(s.dtype)
    assert TT.default_opt_config(tcfg) == TO.OptConfig(
        **dataclasses.asdict(JT.default_opt_config(jcfg)))


# ---------------------------------------------------------------------------
# The prefetcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("index,count", [(0, 1), (0, 2), (1, 2), (2, 3)])
def test_sharded_prefetcher_gives_this_ranks_rows(index, count):
    batches = list(zip(range(5), TP.lm_batches(100, 6, 8, seed=1,
                                                 image_tokens=2, d_model=4)))
    it = TP.ShardedPrefetcher((b for _, b in batches), device="cpu",
                              depth=2, process_index=index,
                              process_count=count)
    got = list(it)
    assert len(got) == 5
    rows = 6 // count
    for (_, host), dev in zip(batches, got):
        assert set(dev) == {"inputs", "labels", "image_embeds"}
        for k, v in host.items():
            assert isinstance(dev[k], torch.Tensor)
            assert np.array_equal(dev[k].numpy(),
                                  v[rows * index:rows * (index + 1)])
    assert TP.ShardedPrefetcher(iter([]), device="cpu").pi == 0


def test_sharded_prefetcher_raises_the_workers_error():
    def bad():
        yield {"labels": np.zeros((2, 3), np.int32)}
        raise RuntimeError("source failed")

    it = TP.ShardedPrefetcher(bad(), device="cpu")
    assert next(it)["labels"].shape == (2, 3)
    with pytest.raises(RuntimeError, match="source failed"):
        next(it)


def test_sharded_prefetcher_close_ends_its_worker():
    # An endless source keeps the worker blocked on a full queue; close()
    # must still end it and drop the batches in flight.
    it = TP.ShardedPrefetcher(TP.lm_batches(100, 2, 8, seed=0),
                              device="cpu", depth=1)
    assert next(it)["labels"].shape == (2, 8)
    it.close()
    assert not it._thread.is_alive()
    with pytest.raises(StopIteration):
        next(it)


def test_lm_batches_are_the_references():
    for a, b in zip(JP.lm_batches(300, 3, 10, seed=4, image_tokens=2,
                                  d_model=5),
                    TP.lm_batches(300, 3, 10, seed=4, image_tokens=2,
                                  d_model=5)):
        assert all(np.array_equal(a[k], b[k]) for k in a)
        break


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def _args(argv):
    return TTR.parser().parse_args(argv + ["--device", "cpu"])


def test_train_lm_killed_and_resumed_is_bitwise(tmp_path, capsys):
    """A run killed at step 3 of 5 (checkpoints every 2 steps) and resumed
    from its checkpoint ends bitwise where an unbroken run ends: the
    resumed loop restores step 2's state and draws batches 2 onward."""
    argv = ["--arch", "h2o-danube-3-4b", "--steps", "5", "--batch", "2",
            "--seq", "16", "--save-every", "2", "--log-every", "1"]
    whole = TTR.train_lm(_args(argv + ["--ckpt-dir", str(tmp_path / "a")]))
    out = capsys.readouterr().out
    assert "[train] step 4 loss=" in out and "[train] done: loss" in out
    args = _args(argv + ["--ckpt-dir", str(tmp_path / "b")])
    with pytest.raises(CH.ChaosKill):
        TTR.train_lm(args, chaos=CH.KillAtRound(3))
    resumed = TTR.train_lm(args)
    assert [r["step"] for r in resumed["logs"]] == [2, 3, 4]
    for r, w in zip(resumed["logs"], whole["logs"][2:]):
        assert r["loss"] == w["loss"] and r["grad_norm"] == w["grad_norm"]
    a, b = whole["state"], resumed["state"]
    assert int(a[2]) == int(b[2]) == 5
    for x, y in zip(TO.tree_leaves(a[:2]), TO.tree_leaves(b[:2])):
        assert torch.equal(x.detach(), y.detach())


def test_train_lm_runs_every_optimizer_without_a_checkpoint(capsys):
    for opt in ("adafactor", "sgd"):
        res = TTR.train_lm(_args(["--arch", "mamba2-370m", "--steps", "2",
                                  "--batch", "2", "--seq", "16",
                                  "--optimizer", opt]))
        assert len(res["logs"]) == 2
        assert all(math.isfinite(r["loss"]) for r in res["logs"])
    with pytest.raises(NotImplementedError, match="next slice"):
        TTR.train_lm(_args(["--arch", "mamba2-370m", "--mesh"]))
    with pytest.raises(NotImplementedError, match="GBDT's --dist"):
        TTR.train_lm(_args(["--arch", "mamba2-370m", "--compress"]))


GBDT = ["--arch", "sketchboost-gbdt", "--rows", "3000", "--features", "12",
        "--outputs", "4", "--trees", "8", "--sketch", "top_outputs",
        "--sketch-k", "2"]


@pytest.mark.parametrize("dist", [False, True])
def test_train_gbdt_matches_reference(dist, capsys):
    """`train_gbdt` (and ``--dist`` on a one-rank gloo world) against the
    reference's, on the deterministic top_outputs sketch: accuracy and
    loss within 1e-3 (ties can split otherwise in the two packages)."""
    argv = GBDT + (["--dist"] if dist else [])
    got = TTR.train_gbdt(_args(argv))
    want = JTR.train_gbdt(argparse.Namespace(**{
        **vars(_args(argv)), "device": None}))
    out = capsys.readouterr().out
    assert ("[gbdt-dist] mesh=1x1" if dist else "[gbdt] top_outputs") in out
    assert abs(got["acc"] - want["acc"]) <= 1e-3
    if not dist:
        assert abs(got["loss"] - want["loss"]) <= 1e-3 * want["loss"]
    else:
        # The reference's mesh spans the test process's CPU devices; its
        # trees are its single-device fit's on any mesh, as the port's.
        assert got["mesh"] == "1x1"
        assert got["collective"] == want["collective"]
