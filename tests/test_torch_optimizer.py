"""Port vs reference: the optimizers (`repro_torch.training.optimizer`).

Inputs are seeded numpy trees given to both packages: the reference's
holds a ``blocks`` subtree stacked over layers, the port's the same arrays
as a list of one dict a layer, as their LM parameters are laid out.  Each
rule takes two steps (steps 0 and 50 of a 10-step warmup and 100-step
decay, so both the warmup and the cosine are read) and the port's
parameters and state are held to the reference's in float32 within 1e-6
of each leaf's largest magnitude: both compute in float32, and the two
libraries round ``pow``, ``rsqrt`` and their sums in other orders.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import lm as JLM
from repro.models import params as JPA
from repro.training import optimizer as JO
from repro_torch import configs as TC
from repro_torch.io import convert
from repro_torch.models import lm as TLM
from repro_torch.models import params as TPA
from repro_torch.training import optimizer as TO

TOL = 1e-6
LAYERS = 3
# (shape of one layer's leaf or of a top-level leaf): factored leaves
# (both of the last two dims >= 128) and unfactored ones, 1-D to 3-D.
BLOCK = {"attn": {"wq": (130, 140), "norm": (7,)},
         "moe": {"wi": (2, 129, 131)}, "small": (5, 200)}
TOP = {"embed": (200, 129), "final_norm": (140,), "gate": (1,)}


def _trees(seed=0, scale=1.0):
    """(reference tree, port tree) of float32 normals."""
    rng = np.random.default_rng(seed)

    def draw(shapes, lead=()):
        if isinstance(shapes, dict):
            return {k: draw(v, lead) for k, v in shapes.items()}
        return (scale * rng.normal(size=lead + shapes)).astype(np.float32)

    blocks = draw(BLOCK, (LAYERS,))
    top = draw(TOP)
    ref = dict(top, blocks=blocks)
    per_layer = [jax.tree.map(lambda a: a[i], blocks) for i in range(LAYERS)]
    port = dict({k: torch.tensor(v) for k, v in top.items()},
                blocks=[jax.tree.map(torch.tensor, b) for b in per_layer])
    return ref, port


def _stack(port_tree):
    return convert.lm_tree_to_arrays(port_tree)


def _close(ref_tree, port_arrays):
    jl = jax.tree.leaves(ref_tree)
    tl = jax.tree.leaves(port_arrays)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        assert a.shape == b.shape and b.dtype == a.dtype
        err = np.max(np.abs(a - b)) / max(np.max(np.abs(a)), 1e-30)
        assert err <= TOL, err


CONFIGS = {
    "adamw": dict(name="adamw"),
    "adamw_no_clip": dict(name="adamw", grad_clip=0.0, weight_decay=0.0),
    "adafactor": dict(name="adafactor"),
    "adafactor_unfactored": dict(name="adafactor", factored_min_dim=1000),
    "adafactor_small_factored": dict(name="adafactor", factored_min_dim=5),
    "sgd": dict(name="sgd"),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_two_steps_match_reference(name):
    kw = dict(CONFIGS[name], warmup_steps=10, decay_steps=100, lr=1e-2)
    jcfg, tcfg = JO.OptConfig(**kw), TO.OptConfig(**kw)
    jp, tp = _trees(0)
    jp = jax.tree.map(jnp.asarray, jp)
    js, ts = JO.opt_init(jp, jcfg), TO.opt_init(tp, tcfg)
    for step, seed in ((0, 1), (50, 2)):
        jg, tg = _trees(seed, scale=0.5)
        jp, js = JO.opt_update(jax.tree.map(jnp.asarray, jg), js, jp,
                               jnp.int32(step), jcfg)
        tp2, ts2 = TO.opt_update(tg, ts, tp, step, tcfg)
        assert tp2 is tp and ts2 is ts            # updated in place
    _close(jp, _stack(tp))
    _close(js, _stack(ts) if ts else {})
    assert all(x.dtype == torch.float32 for x in TO.tree_leaves(ts))


def test_adafactor_clips_over_the_stacked_leaf():
    """The reference's RMS clipping reads a whole stacked leaf (every
    layer); one layer's large gradient then scales the others' updates
    down too, as it does in the port."""
    kw = dict(name="adafactor", warmup_steps=0, decay_steps=10, lr=0.1,
              weight_decay=0.0, grad_clip=0.0, factored_min_dim=1000)
    jcfg, tcfg = JO.OptConfig(**kw), TO.OptConfig(**kw)
    jp, tp = _trees(3)
    jg, tg = _trees(4)
    jg["blocks"]["attn"]["norm"][0] *= 1e3
    tg["blocks"][0]["attn"]["norm"].mul_(1e3)
    jp = jax.tree.map(jnp.asarray, jp)
    jp, js = JO.opt_update(jax.tree.map(jnp.asarray, jg),
                           JO.opt_init(jp, jcfg), jp, jnp.int32(3), jcfg)
    ts = TO.opt_init(tp, tcfg)
    TO.opt_update(tg, ts, tp, 3, tcfg)
    _close(jp, _stack(tp))


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 50, 99, 100, 150])
@pytest.mark.parametrize("warmup,decay", [(10, 100), (0, 100), (100, 100)])
def test_lr_schedule_matches_reference(step, warmup, decay):
    kw = dict(lr=3e-4, warmup_steps=warmup, decay_steps=decay)
    want = float(JO.lr_schedule(JO.OptConfig(**kw), jnp.int32(step)))
    got = TO.lr_schedule(TO.OptConfig(**kw), step)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - want) <= 1e-7 * max(abs(want), 1e-30)


@pytest.mark.parametrize("max_norm", [1e-3, 1.0, 1e6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_by_global_norm_matches_reference(max_norm, dtype):
    """The norm within 1e-5 (float32 sums of 10^5 squares in two orders);
    the clipped gradients within that in float32, and within one bf16 ulp
    in bfloat16, where the factor is rounded to bf16 first."""
    jg, tg = _trees(5)
    if dtype == "bfloat16":
        jg = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), jg)
        tg = TO.tree_map(lambda t: t.to(torch.bfloat16), tg)
    jc, jn = JO.clip_by_global_norm(jax.tree.map(jnp.asarray, jg), max_norm)
    tc, tn = TO.clip_by_global_norm(tg, max_norm)
    assert abs(float(tn) - float(jn)) <= 1e-5 * float(jn)
    assert float(TO.global_norm(tg)) == float(tn)
    rtol = 1e-5 if dtype == "float32" else 2.0 ** -8
    assert all(t.dtype == getattr(torch, dtype)
               for t in TO.tree_leaves(tc))
    got = _stack(TO.tree_map(lambda t: t.float(), tc))
    for a, b in zip(jax.tree.leaves(jc), jax.tree.leaves(got)):
        np.testing.assert_allclose(b, np.asarray(a, np.float32), rtol=rtol,
                                   atol=0)


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd"])
@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "zamba2-1.2b",
                                  "llama-3.2-vision-11b"])
def test_opt_state_decls_mirror_opt_init(name, arch):
    """The declared state has ``opt_init``'s structure and shapes on the
    parameters the same declarations make, and is the reference's
    declaration leaf for leaf."""
    cfg = dataclasses.replace(TC.smoke_config(arch), dtype="float32")
    ocfg = TO.OptConfig(name=name, factored_min_dim=64)
    decls = TLM.param_decls(cfg)
    state = TO.opt_init(TPA.init_params(decls, torch.Generator().manual_seed(
        0), device="cpu"), ocfg)
    sdecl = TO.opt_state_decls(decls, ocfg)
    shapes = TPA.map_decls(lambda d: d.shape, sdecl) if sdecl else {}
    assert shapes == TO.tree_map(lambda t: tuple(t.shape), state)
    jdecl = JO.opt_state_decls(JLM.param_decls(JC.smoke_config(arch)),
                               JO.OptConfig(name=name, factored_min_dim=64))
    want = jax.tree.map(dataclasses.astuple, jdecl,
                        is_leaf=lambda x: isinstance(x, JPA.ParamDecl))
    got = TPA.map_decls(dataclasses.astuple, sdecl) if sdecl else {}
    assert got == want


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd"])
def test_opt_state_converter_round_trips(name):
    """`convert.opt_state_from_arrays` carries the reference's state over
    (blocks unstacked) and `lm_tree_to_arrays` carries it back, bitwise."""
    cfg = dataclasses.replace(JC.smoke_config("h2o-danube-3-4b"),
                              dtype="float32")
    jcfg = JO.OptConfig(name=name, factored_min_dim=64)
    jp = JLM.init(cfg, jax.random.key(0))
    js = JO.opt_init(jp, jcfg)
    rng = np.random.default_rng(1)
    js = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                      js)
    tcfg = dataclasses.replace(TC.smoke_config("h2o-danube-3-4b"),
                               dtype="float32")
    ts = convert.opt_state_from_arrays(tcfg, js, device="cpu")
    tp = TLM.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    init = TO.opt_init(tp, TO.OptConfig(name=name, factored_min_dim=64))
    assert TO.tree_map(lambda t: tuple(t.shape), ts) == \
        TO.tree_map(lambda t: tuple(t.shape), init)
    back = convert.lm_tree_to_arrays(ts)
    assert jax.tree.structure(back) == jax.tree.structure(js)
    for a, b in zip(jax.tree.leaves(js), jax.tree.leaves(back)):
        assert np.array_equal(a, b)


def test_tree_unflatten_holds_no_leaf_past_its_tree():
    """A tree built by `tree_unflatten` frees its leaves with it, without
    the cyclic collector: the step's gradients go as soon as the caller
    drops them."""
    import gc
    import weakref
    leaves = [torch.zeros(4), torch.ones(2, 3), torch.full((1,), 2.0)]
    refs = [weakref.ref(t) for t in leaves]
    like = {"b": [None, {"c": None}], "a": None}
    gc.disable()
    try:
        tree = TO.tree_unflatten(like, leaves)
        assert list(tree) == ["b", "a"]
        assert TO.tree_leaves(tree) == leaves
        del tree, leaves
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
