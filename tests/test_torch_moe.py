"""Port vs reference: the MoE layer (`repro_torch.models.moe`).

Inputs are made with a seeded numpy generator and handed to both packages.
Routing is held bitwise: each (token, choice)'s expert, slot and in-capacity
flag equal the reference's ``_route`` + ``_slot_positions``, with cases
that drop tokens at capacity, in prefill groups and in decode's one group
of ``b`` tokens.  The layer's output is held to the reference's
``moe_apply`` in both ``dispatch_mode``s: float32 within atol 1e-4 + rtol
1e-4 (matmul rounding of two libraries), bfloat16 within the reference's
own bf16 envelope, atol 5e-2 + rtol 5e-2 (tests/test_models.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.models import moe as JM
from repro_torch.models import moe as TM
from repro_torch.models import params as TPA

F32 = dict(atol=1e-4, rtol=1e-4)
BF16_ENVELOPE = dict(atol=5e-2, rtol=5e-2)


def _params(d, f, e, act, seed):
    rng = np.random.default_rng(seed)
    p = {k: (rng.normal(size=decl.shape) / np.sqrt(decl.shape[-2])
             ).astype(np.float32)
         for k, decl in TM.moe_decls(d, f, e, act).items()}
    # A router wide enough that top-2 probabilities are far from ties.
    p["router"] = p["router"] * 4.0
    return p


def _both(p, dtype):
    tp = {k: torch.from_numpy(v).to(getattr(torch, dtype))
          for k, v in p.items()}
    jp = {k: jnp.asarray(v).astype(getattr(jnp, dtype)) for k, v in p.items()}
    return tp, jp


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("act,shard", [("swiglu", "ep"), ("gelu", "tp"),
                                       ("geglu", "ep")])
def test_moe_decls_match_reference(act, shard):
    t = TPA.map_decls(dataclasses.astuple,
                      TM.moe_decls(64, 96, 8, act, shard))
    j = jax.tree.map(dataclasses.astuple, JM.moe_decls(64, 96, 8, act, shard),
                     is_leaf=lambda x: hasattr(x, "axes"))
    assert t == j


def _reference_plan(x, router, n_experts, top_k, cf, group):
    """The reference's routing of x (B, S, D), as moe_apply computes it."""
    b, s, d = x.shape
    t = b * s
    g = min(group, t)
    while t % g:
        g //= 2
    cap = max(int(cf * g * top_k / n_experts), 1)
    gval, gidx = JM._route(jnp.asarray(x).reshape(t, d), jnp.asarray(router),
                           top_k)
    gidx = gidx.reshape(t // g, g, top_k)
    _, slot, in_cap = JM._slot_positions(gidx, n_experts, top_k, cap)
    return dict(g=g, cap=cap, gval=np.asarray(gval).reshape(t // g, g, top_k),
                gidx=np.asarray(gidx), slot=np.asarray(slot),
                in_cap=np.asarray(in_cap))


# (b, s, experts, top_k, capacity factor, router group): prefill groups,
# a t that the group does not divide (halved), decode's (b, 1) shape whose
# group is the batch, and capacity factors small enough to drop.
PLAN_CASES = [
    (2, 64, 4, 2, 4.0, 32), (2, 64, 4, 2, 0.5, 32), (1, 96, 8, 2, 1.0, 64),
    (3, 20, 16, 2, 2.0, 1024), (128, 1, 16, 2, 2.0, 1024),
    (8, 1, 16, 2, 2.0, 1024), (6, 1, 4, 2, 1.0, 32), (2, 40, 8, 1, 1.25, 16),
]


@pytest.mark.parametrize("b,s,e,k,cf,group", PLAN_CASES)
def test_slot_assignment_and_drops_bitwise(b, s, e, k, cf, group):
    """Experts, slots and in-capacity flags equal the reference's; the
    gate values within float32 rounding."""
    rng = np.random.default_rng(b * 100 + s + e)
    x = rng.normal(size=(b, s, 32)).astype(np.float32)
    router = rng.normal(size=(32, e)).astype(np.float32)
    plan = TM.moe_plan(torch.from_numpy(x), torch.from_numpy(router),
                       n_experts=e, top_k=k, capacity_factor=cf,
                       router_group=group)
    want = _reference_plan(x, router, e, k, cf, group)
    assert (plan["g"], plan["cap"]) == (want["g"], want["cap"])
    assert plan["slot"].dtype == torch.int32
    np.testing.assert_array_equal(plan["gidx"].numpy(), want["gidx"])
    np.testing.assert_array_equal(plan["slot"].numpy(), want["slot"])
    np.testing.assert_array_equal(plan["in_cap"].numpy(), want["in_cap"])
    np.testing.assert_allclose(plan["gval"].numpy(), want["gval"],
                               atol=1e-6, rtol=1e-6)
    if cf <= 1.0:
        assert not want["in_cap"].all()        # the case drops tokens


@settings(deadline=None, max_examples=15)
@given(n_groups=st.integers(1, 3), g=st.integers(1, 40),
       e=st.sampled_from([2, 4, 8, 16]), k=st.integers(1, 2),
       cap=st.integers(1, 12), seed=st.integers(0, 2 ** 16))
def test_slot_positions_property(n_groups, g, e, k, cap, seed):
    """Any expert choices (repeats across tokens, none within a token):
    `_slot_positions` is the reference's, bit for bit."""
    rng = np.random.default_rng(seed)
    gidx = np.stack([np.stack([rng.choice(e, k, replace=False)
                               for _ in range(g)]) for _ in range(n_groups)])
    slot, in_cap = TM._slot_positions(torch.from_numpy(gidx), e, k, cap)
    _, jslot, jin = JM._slot_positions(jnp.asarray(gidx), e, k, cap)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(in_cap.numpy(), np.asarray(jin))


def test_route_breaks_ties_to_the_lower_expert():
    """Equal probabilities: ``jax.lax.top_k`` takes the lower index, and so
    does the port (``torch.topk`` does not promise an order)."""
    tokens = np.zeros((5, 4), np.float32)
    router = np.zeros((4, 8), np.float32)
    router[:, 5] = router[:, 6] = 1.0            # one token: two tied tops
    tokens[0] = 1.0
    gval, gidx = TM._route(torch.from_numpy(tokens), torch.from_numpy(router),
                           3)
    jval, jidx = JM._route(jnp.asarray(tokens), jnp.asarray(router), 3)
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(jidx))
    assert gidx[0].tolist() == [5, 6, 0] and gidx[1].tolist() == [0, 1, 2]
    np.testing.assert_allclose(gval.numpy(), np.asarray(jval), atol=1e-7)


# (b, s, act, capacity factor, router group): swiglu and gelu experts,
# with and without drops, prefill and decode shapes.
APPLY_CASES = [
    (2, 48, "swiglu", 4.0, 32), (2, 48, "swiglu", 0.75, 32),
    (1, 64, "gelu", 1.0, 16), (8, 1, "geglu", 1.0, 1024),
]


@pytest.mark.parametrize("mode", ["einsum", "gather"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,act,cf,group", APPLY_CASES)
def test_moe_apply_matches_reference(b, s, act, cf, group, dtype, mode):
    e, d, f = 8, 64, 96
    p = _params(d, f, e, act, seed=b + s)
    x = np.random.default_rng(s).normal(size=(b, s, d)).astype(np.float32)
    tp, jp = _both(p, dtype)
    kw = dict(n_experts=e, top_k=2, act=act, capacity_factor=cf,
              router_group=group, dispatch_mode=mode)
    out = TM.moe_apply(tp, torch.from_numpy(x).to(getattr(torch, dtype)),
                       **kw)
    want = JM.moe_apply(jp, jnp.asarray(x).astype(getattr(jnp, dtype)), **kw)
    assert out.dtype == getattr(torch, dtype) and out.shape == (b, s, d)
    tol = F32 if dtype == "float32" else BF16_ENVELOPE
    np.testing.assert_allclose(_f32(out), _f32(want), **tol)


def test_dropped_choices_contribute_nothing():
    """A (token, choice) past capacity adds 0: with capacity 1 per expert,
    each token's output is the gated sum over its in-capacity choices
    alone, computed here expert by expert."""
    e, d, f = 4, 16, 24
    p = {k: torch.from_numpy(v) for k, v in _params(d, f, e, "swiglu",
                                                    seed=3).items()}
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(1, 12, d)).astype(np.float32))
    kw = dict(n_experts=e, top_k=2, capacity_factor=0.1, router_group=12)
    plan = TM.moe_plan(x, p["router"], **kw)
    assert plan["cap"] == 1 and int(plan["in_cap"].sum()) <= e
    out = TM.moe_apply(p, x, act="swiglu", dispatch_mode="gather", **kw)
    want = torch.zeros_like(x[0])
    for t in range(12):
        for c in range(2):
            if plan["in_cap"][0, t, c]:
                ex = int(plan["gidx"][0, t, c])
                xe = x[0, t][None, None]
                ye = TM._expert_ffn(xe, {n: w[ex:ex + 1] for n, w in
                                         p.items() if n != "router"},
                                    "swiglu")[0, 0]
                want[t] += plan["gval"][0, t, c] * ye
    torch.testing.assert_close(out[0], want, atol=1e-6, rtol=1e-6)
    dropped = ~plan["in_cap"][0].any(-1)
    assert dropped.any() and not out[0][dropped].any()


def test_dispatch_modes_differ_only_in_the_combine_cast():
    """In float32 the two modes are the same function; in bf16 einsum
    rounds the gate weights first, as the reference's does."""
    e, d, f = 8, 32, 48
    p = _params(d, f, e, "swiglu", seed=9)
    x = np.random.default_rng(9).normal(size=(2, 16, d)).astype(np.float32)
    kw = dict(n_experts=e, top_k=2, act="swiglu", router_group=32)
    t32 = {k: torch.from_numpy(v) for k, v in p.items()}
    a = TM.moe_apply(t32, torch.from_numpy(x), dispatch_mode="einsum", **kw)
    b = TM.moe_apply(t32, torch.from_numpy(x), dispatch_mode="gather", **kw)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="dispatch_mode"):
        TM.moe_apply(t32, torch.from_numpy(x), dispatch_mode="dense", **kw)


def test_aux_loss_matches_reference():
    p = _params(32, 48, 8, "swiglu", seed=5)
    x = np.random.default_rng(5).normal(size=(2, 24, 32)).astype(np.float32)
    out = TM.moe_aux_loss({k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(x), n_experts=8, top_k=2)
    want = JM.moe_aux_loss({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x), n_experts=8, top_k=2)
    np.testing.assert_allclose(float(out), float(want), atol=1e-6, rtol=1e-6)
