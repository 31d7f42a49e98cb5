"""Port vs reference: the LM decode path of every family (B8's plain
version, the decode attention layer, the caches and their converters,
``decode_step`` and the serving step).

Inputs are made with a seeded numpy generator; the reference's random
parameters and caches are carried over with `repro_torch.io.convert`, so
both packages run the same model from the same state.  The reference's
decode attention is its Pallas kernel B8 in interpret mode
(``use_pallas=True``), whose semantics the port implements; its VLM image
cross-attention is ``decode_attention_jnp``, B8's function, which the port
runs through B8.  A VLM's cross gates are drawn nonzero in both trees and
its image cache filled with the same random values in both.

Tolerances.  B8's plain version in float32 against the reference's oracle
and its interpret kernel: atol 1e-5 + rtol 1e-5 (both compute in float32;
the sums run in another order); a bf16 output within one bf16 ulp of the
reference's value plus 1e-5.  Layers and whole decode steps of a float32
model with a float32 cache: atol 1e-4 + rtol 1e-4, as the prefill's
(matmul and transcendental rounding of two libraries over a few layers).
A float32 model with a bf16 cache: atol 1e-3 + rtol 1e-3 over 40 free-running
steps, since a k or v value that differs in its last float32 bits can round
to the neighbouring bf16 value (a step of 2^-8 relative) in one package and
not the other; `test_decode_step_from_reference_bf16_cache` shows that this
is the cause: stepping from the reference's own cache bits, the logits agree
within 1e-4 and each cached value within one bf16 ulp.  A
bf16 model: the reference's own bf16 envelope, atol 5e-2 + rtol 5e-2
(tests/test_models.py).
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import configs as JC
from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.models import moe as JM
from repro.training import lm_serve as JS
from repro_torch import configs as TC
from repro_torch.io import convert
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import ref as TR
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.models import moe as TM
from repro_torch.training import lm_serve

F32 = dict(atol=1e-4, rtol=1e-4)
BF16_CACHE = dict(atol=1e-3, rtol=1e-3)
BF16_ENVELOPE = dict(atol=5e-2, rtol=5e-2)
ATTN = dict(atol=1e-5, rtol=1e-5)


def _np(tree):
    """A JAX tree as numpy arrays, bfloat16 as its uint16 bits."""
    return jax.tree.map(lambda a: np.asarray(a).view(np.uint16)
                        if a.dtype == jnp.bfloat16 else np.asarray(a), tree)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bf16_ulps(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp of each element's own magnitude (0 where it is 0)."""
    m, e = np.frexp(x.astype(np.float32))
    return np.where(m == 0, 0.0, np.ldexp(1.0, e - 8)).astype(np.float32)


# ---------------------------------------------------------------------------
# B8's plain version
# ---------------------------------------------------------------------------

DTYPES = {"f32/f32": (torch.float32, torch.float32),
          "f32/bf16": (torch.float32, torch.bfloat16),
          "bf16/bf16": (torch.bfloat16, torch.bfloat16)}


def _decode_inputs(b, hq, hkv, s, dh, seed, full=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, dh)).astype(np.float32)
    k, v = (rng.normal(size=(b, s, hkv, dh)).astype(np.float32)
            for _ in "kv")
    lengths = (np.full(b, s, np.int32) if full
               else rng.integers(1, s + 1, b).astype(np.int32))
    return q, k, v, lengths


def _to(a, dtype):
    return torch.from_numpy(a).to(dtype)


def _jnp(t: torch.Tensor):
    """A port tensor as the JAX array of the same dtype and bits."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


# (group, dh, s, window, full lengths, dtypes): groups 1/2/4, dh 32/120,
# s 8/200/519, window None/16, ragged and full lengths, each dtype pair.
DECODE_CASES = [
    (1, 32, 8, None, False, "f32/f32"), (2, 120, 200, 16, False, "f32/f32"),
    (4, 120, 519, None, False, "f32/f32"), (4, 32, 200, None, True,
                                            "f32/f32"),
    (1, 120, 519, 16, False, "f32/bf16"), (2, 32, 8, 16, False, "f32/bf16"),
    (4, 120, 200, None, False, "f32/bf16"), (4, 32, 519, 16, True,
                                             "f32/bf16"),
    (1, 120, 200, None, False, "bf16/bf16"), (2, 120, 519, None, True,
                                              "bf16/bf16"),
    (4, 32, 8, None, False, "bf16/bf16"), (4, 120, 519, 16, False,
                                           "bf16/bf16"),
]


@pytest.mark.parametrize("group,dh,s,window,full,dtypes", DECODE_CASES)
def test_decode_attention_ref_matches_reference(group, dh, s, window, full,
                                                dtypes):
    """The plain version (the wrapper on CPU tensors) against the
    reference's oracle ``ref.decode_attention_ref`` and its kernel
    ``ops.decode_attention`` in interpret mode, both in their
    ``(b, hkv, s, dh)`` layout."""
    qt, kt = DTYPES[dtypes]
    hkv = 2
    q, k, v, lengths = _decode_inputs(3, hkv * group, hkv, s, dh,
                                      seed=s + dh + group, full=full)
    tq, tk, tv = _to(q, qt), _to(k, kt), _to(v, kt)
    out = DA.decode_attention(tq, tk, tv, torch.from_numpy(lengths),
                              window=window)
    assert out.dtype == qt and out.shape == q.shape
    jq, jk, jv = _jnp(tq), _jnp(tk).transpose(0, 2, 1, 3), \
        _jnp(tv).transpose(0, 2, 1, 3)
    jl = jnp.asarray(lengths)
    for want in (JR.decode_attention_ref(jq, jk, jv, jl, window=window),
                 JO.decode_attention(jq, jk, jv, jl, window=window,
                                     interpret=True)):
        want = _f32(want)
        if qt == torch.float32:
            np.testing.assert_allclose(_f32(out), want, **ATTN)
        else:
            assert (np.abs(_f32(out) - want)
                    <= _bf16_ulps(want) + 1e-5).all()


@settings(deadline=None, max_examples=12)
@given(b=st.integers(1, 3), group=st.sampled_from([1, 2, 4]),
       s=st.integers(1, 60), dh=st.integers(1, 40),
       window=st.one_of(st.none(), st.integers(1, 40)),
       seed=st.integers(0, 2 ** 16))
def test_decode_attention_ref_property(b, group, s, dh, window, seed):
    """Any batch, length and head width: the plain version is a numpy
    softmax over each row's visible keys."""
    q, k, v, lengths = _decode_inputs(b, 2 * group, 2, s, dh, seed)
    out = DA.decode_attention(*map(torch.from_numpy, (q, k, v)),
                              torch.from_numpy(lengths), window=window)
    want = np.zeros_like(q)
    for i in range(b):
        n = int(lengths[i])
        lo = 0 if window is None else max(0, n - window)
        for h in range(2 * group):
            kh = k[i, lo:n, h // group].astype(np.float64)
            sc = kh @ q[i, h].astype(np.float64) / np.sqrt(dh)
            p = np.exp(sc - sc.max())
            want[i, h] = (p / p.sum()) @ v[i, lo:n, h // group]
    np.testing.assert_allclose(out.numpy(), want, **ATTN)


@pytest.mark.parametrize("bad,match", [
    (dict(q=torch.zeros(1, 3, 8), k=torch.zeros(1, 5, 2, 8),
          v=torch.zeros(1, 5, 2, 8)), "multiple of kv heads"),
    (dict(q=torch.zeros(1, 2, 8, dtype=torch.float16)), "float32 or bf"),
    (dict(v=torch.zeros(1, 5, 1, 8, dtype=torch.bfloat16)), "v must be"),
    (dict(k=torch.zeros(1, 5, 1, 4)), "k must be"),
    (dict(window=0), "window 0"),
    (dict(lengths=0), r"lengths must lie in \[1, 5\]"),
    (dict(lengths=torch.tensor([6], dtype=torch.int32)), r"\[1, 5\]"),
    (dict(lengths=torch.tensor([1, 2])), "lengths must be an integer"),
    (dict(lengths=torch.tensor([1.0])), "lengths must be an integer"),
    (dict(q=torch.zeros(1, 2, 300), k=torch.zeros(1, 5, 1, 300),
          v=torch.zeros(1, 5, 1, 300)), "dh <= 256"),
    (dict(q=torch.zeros(2, 8)), r"q must be \(b, hq, dh\)"),
])
def test_decode_attention_refuses_bad_inputs(bad, match):
    args = dict(q=torch.zeros(1, 2, 8), k=torch.zeros(1, 5, 1, 8),
                v=torch.zeros(1, 5, 1, 8), lengths=3, window=None)
    args.update(bad)
    with pytest.raises(ValueError, match=match):
        DA.decode_attention(args["q"], args["k"], args["v"], args["lengths"],
                            window=args["window"])


def test_decode_attention_device_rule():
    """A CPU tensor goes to the plain version, bit for bit, and launches
    nothing; an int length is every row's."""
    q, k, v, _ = _decode_inputs(2, 4, 2, 30, 16, seed=5)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    before = DA.KERNEL.launches
    out = DA.decode_attention(*t, 17, window=8)
    assert DA.KERNEL.launches == before
    plain = TR.decode_attention_ref(*t, torch.tensor([17, 17]), window=8)
    assert torch.equal(out, plain)


# ---------------------------------------------------------------------------
# The decode attention layer and the cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,length", [(None, 0), (None, 11), (16, 9),
                                           (16, 37)])
def test_attention_decode_matches_reference(window, length):
    """One decode step of the attention module (projections, RoPE at the
    true position, the write at the ring slot, B8, the output projection)
    against the reference's with ``use_pallas=True``, from the same float32
    cache; the cache is updated in place."""
    rng = np.random.default_rng(length)
    decls = TL.attention_decls(64, 4, 2, 32)
    p = {k: rng.normal(size=d.shape).astype(np.float32) / 8.0
         for k, d in decls.items()}
    x = rng.normal(size=(3, 64)).astype(np.float32)
    s_alloc = 16 if window else 24
    k, v = (rng.normal(size=(3, s_alloc, 2, 32)).astype(np.float32)
            for _ in "kv")
    kw = dict(n_heads=4, n_kv_heads=2, head_dim=32, rope_theta=10_000.0,
              window=window)
    cache = TL.attention_cache(3, 64 if window else 24, 2, 32,
                               dtype=torch.float32, window=window,
                               device="cpu")
    assert cache["k"].shape == k.shape and cache["length"] == 0
    cache["k"].copy_(torch.from_numpy(k))
    cache["v"].copy_(torch.from_numpy(v))
    cache["length"] = length
    k_before = cache["k"]
    y, out_cache = TL.attention_decode(
        {n: torch.from_numpy(a) for n, a in p.items()}, torch.from_numpy(x),
        cache, **kw)
    jy, jc = JL.attention_decode(
        {n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x),
        {"k": jnp.asarray(k), "v": jnp.asarray(v),
         "length": jnp.int32(length)}, use_pallas=True, **kw)
    assert out_cache is cache and cache["k"] is k_before
    assert cache["length"] == int(jc["length"]) == length + 1
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jc["k"]), **F32)
    np.testing.assert_allclose(cache["v"].numpy(), np.asarray(jc["v"]), **F32)


MODELS = {
    "h2o-danube-3-4b": dict(n_kv_heads=2),   # GQA 2, window 16: a ring
    "musicgen-medium": {},                   # embed_inputs, no window
    "grok-1-314b": {},                       # MoE, a group of b tokens
    "phi3.5-moe-42b-a6.6b": {},              # MoE, GQA 4
    "mamba2-370m": {},                       # SSM state only
    "zamba2-1.2b": {},                       # SSM + 3 shared-attention sites
    "llama-3.2-vision-11b": {},              # cross sites, image cache
}


def _pair(arch, dtype, **over):
    """(reference config, port config, reference params, port params); a
    VLM's gates drawn nonzero in both trees."""
    kw = dict(MODELS[arch], dtype=dtype, use_pallas=True, **over)
    jcfg = dataclasses.replace(JC.smoke_config(arch), **kw)
    tcfg = dataclasses.replace(TC.smoke_config(arch), **kw)
    jp = JLM.init(jcfg, jax.random.key(0))
    if "cross" in jp:
        jp["cross"]["gate"] = jnp.asarray(np.random.default_rng(11).normal(
            size=jp["cross"]["gate"].shape).astype(np.float32))
    return jcfg, tcfg, jp, convert.lm_params_from_arrays(tcfg, _np(jp),
                                                         device="cpu")


def _tokens(cfg, b=2, s=40, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.embed_inputs:
        return rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _caches(jcfg, tcfg, b, s_max, dtype, seed=12):
    """Both packages' empty caches; a VLM's image cache filled with the
    same random values (rounded to the cache dtype) in both."""
    jc = JLM.init_cache(jcfg, b, s_max, dtype=getattr(jnp, dtype))
    tc = TLM.init_cache(tcfg, b, s_max, dtype=getattr(torch, dtype),
                        device="cpu")
    if "image_kv" in jc:
        rng = np.random.default_rng(seed)
        for name in ("k", "v"):
            a = jnp.asarray(rng.normal(size=jc["image_kv"][name].shape)
                            .astype(np.float32)).astype(getattr(jnp, dtype))
            jc["image_kv"][name] = a
            tc["image_kv"][name].copy_(torch.from_numpy(
                np.array(a.astype(jnp.float32))))
    return jc, tc


def _cache_leaves(tc, jc):
    """(name, port array, reference array) for every tensor of the two
    caches, in the reference's layout (`lm_cache_to_arrays`)."""
    port, ref = convert.lm_cache_to_arrays(tc), _np(jc)
    flat_p = jax.tree_util.tree_flatten_with_path(port)[0]
    flat_r = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    assert [k for k, _ in flat_p] == list(flat_r)
    return [(jax.tree_util.keystr(k), a, flat_r[k]) for k, a in flat_p]


def _as_f32(a: np.ndarray) -> np.ndarray:
    """A reference-layout array (bf16 as uint16 bits) as float32."""
    if a.dtype == np.uint16:
        return (a.astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def _ref_step(jcfg):
    return jax.jit(lambda p, c, t: JLM.decode_step(p, jcfg, c, t))


# (arch, model dtype, cache dtype): the dense models in each dtype pair,
# the other families in float32 and bf16.
DENSE = ("h2o-danube-3-4b", "musicgen-medium")
DECODE_RUNS = [(a, d, c) for a in DENSE
               for d, c in (("float32", "float32"), ("float32", "bfloat16"),
                            ("bfloat16", "bfloat16"))] + \
    [(a, d, d) for a in MODELS if a not in DENSE
     for d in ("float32", "bfloat16")]


@contextlib.contextmanager
def _reference_routing():
    """Within the block, the reference's ``moe._route`` records each
    call's expert choices, and the port's ``moe._route`` takes them, call
    by call, in place of its own top-k: the port's gate values are its own
    probabilities at the reference's experts, renormalised.  Yields the
    list of the port's own choices that differ from the reference's, each
    as (call, row, gap between the port's k-th and (k+1)-th
    probabilities)."""
    real_j, real_t, calls, flips = JM._route, TM._route, [], []
    n_calls = [0]

    def record(tokens, router, top_k):
        vals, idx = real_j(tokens, router, top_k)
        calls.append(np.array(idx))
        return vals, idx

    def take(tokens, router, top_k):
        want = torch.from_numpy(calls.pop(0)).long()
        probs = torch.softmax(tokens.float() @ router.float(), dim=-1)
        _, own = real_t(tokens, router, top_k)
        top = probs.sort(-1, descending=True).values
        gap = top[:, top_k - 1] - top[:, top_k]
        for r in torch.nonzero((own != want).any(-1)).flatten().tolist():
            flips.append((n_calls[0], r, float(gap[r])))
        n_calls[0] += 1
        vals = probs.gather(1, want)
        return vals / vals.sum(-1, keepdim=True).clamp_min(1e-9), want

    JM._route, TM._route = record, take
    try:
        yield flips
    finally:
        JM._route, TM._route = real_j, real_t


@pytest.mark.parametrize("arch,dtype,cache_dtype", DECODE_RUNS)
def test_decode_step_matches_reference(arch, dtype, cache_dtype):
    """Tokens one at a time from an empty cache of 64 positions (40 for the
    dense models, whose 16-slot ring for h2o-danube wraps twice; 16 for the
    others): logits at every step against the reference's ``decode_step``, and the
    final caches (attention k and v, SSM states and convolution buffers,
    hybrid sites, the VLM's image cache).

    The MoE models' bf16 runs route the port's tokens to the reference's
    experts (`_reference_routing`, the reference's step run eagerly with
    its layers unrolled so that its choices can be recorded): init's 0.02 router leaves the
    probabilities so close that a top-2 boundary can fall within the bf16
    rounding of the layer input, where the packages pick different
    experts, a discrete change and not a rounding one.  Each choice the
    port's own top-k makes otherwise must be such a near-tie: its k-th and
    (k+1)-th probabilities within 5e-3 (flips seen at gaps of 8e-5 to
    1.2e-3).  Float32 runs route on their own."""
    jcfg, tcfg, jp, tp = _pair(arch, dtype)
    steps = 40 if arch in DENSE else 16
    x = _tokens(tcfg, s=steps)
    jc, tc = _caches(jcfg, tcfg, 2, 64, cache_dtype)
    step = _ref_step(jcfg)
    forced = bool(tcfg.n_experts) and dtype == "bfloat16"
    if forced:                       # eager and unrolled: choices recorded
        eager = dataclasses.replace(jcfg, scan_layers=False)
        step = lambda p, c, t: JLM.decode_step(p, eager, c, t)  # noqa: E731
    routing = _reference_routing() if forced else contextlib.nullcontext([])
    tol = (F32 if cache_dtype == "float32" else BF16_CACHE) \
        if dtype == "float32" else BF16_ENVELOPE
    with routing as flips:
        for i in range(steps):
            jl, jc = step(jp, jc, jnp.asarray(x[:, i]))
            tl, tc2 = TLM.decode_step(tp, tcfg, tc, x[:, i])
            assert tc2 is tc and tc["length"] == i + 1
            assert tl.dtype == torch.float32
            assert tl.shape == (2, tcfg.padded_vocab)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl, np.float32),
                                       **tol)
    assert all(gap < 5e-3 for _, _, gap in flips), flips
    assert np.asarray(jc["layers"]["length"]).tolist() == \
        [steps] * tcfg.n_layers
    cache_tol = F32 if cache_dtype == "float32" else BF16_ENVELOPE
    for name, a, b in _cache_leaves(tc, jc):
        assert a.dtype == b.dtype, name
        np.testing.assert_allclose(_as_f32(a), _as_f32(b), **cache_tol,
                                   err_msg=name)


def test_moe_decode_drops_tokens_as_the_reference():
    """In decode the MoE layer routes the batch as one group of b tokens,
    so a small capacity drops tokens there too (capacity 1 a group of 8
    tokens x 2 choices over 4 experts), as in the reference."""
    jcfg, tcfg, jp, tp = _pair("phi3.5-moe-42b-a6.6b", "float32",
                               capacity_factor=0.25)
    x = _tokens(tcfg, b=8, s=6, seed=5)
    jc, tc = _caches(jcfg, tcfg, 8, 16, "float32")
    step = _ref_step(jcfg)
    for i in range(6):
        jl, jc = step(jp, jc, jnp.asarray(x[:, i]))
        tl, tc = TLM.decode_step(tp, tcfg, tc, x[:, i])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    h = torch.randn(8, 1, tcfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    plan = TM.moe_plan(h, tp["blocks"][0]["moe"]["router"],
                        n_experts=tcfg.n_experts, top_k=tcfg.top_k,
                        capacity_factor=tcfg.capacity_factor,
                        router_group=tcfg.router_group)
    assert plan["g"] == 8 and plan["cap"] == 1
    assert not plan["in_cap"].all()


def _ulps_apart(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Element-wise distance in bf16 ulps between two bf16 tensors (the
    bits mapped to an order in which neighbouring values differ by 1)."""
    def ordered(t):
        i = t.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "musicgen-medium"])
def test_decode_step_from_reference_bf16_cache(arch):
    """The witness for the bf16-cache tolerance above.  At each of 40 steps
    (the ring wraps twice for h2o-danube) the port starts from the
    reference's own bf16 cache bits, carried over with
    `lm_cache_from_arrays`.  From the same bits its logits agree within
    1e-4.  The first layer, whose input is the same on both sides, writes
    each k and v within one bf16 ulp of the reference's, and some one ulp
    apart; a deeper layer's writes drift further, since its input went
    through attention over the new token's own flipped k and v.  So the
    free-running gap is the rounding of the cached k and v falling the
    other way, not a fault of the float32-q, bf16-cache path."""
    jcfg, tcfg, jp, tp = _pair(arch, "float32")
    x = _tokens(tcfg)
    jc = JLM.init_cache(jcfg, 2, 64, dtype=jnp.bfloat16)
    step = _ref_step(jcfg)
    flips = 0
    for i in range(x.shape[1]):
        tc = convert.lm_cache_from_arrays(tcfg, _np(jc), device="cpu")
        jl, jc = step(jp, jc, jnp.asarray(x[:, i]))
        tl, tc = TLM.decode_step(tp, tcfg, tc, x[:, i])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
        ref = convert.lm_cache_from_arrays(tcfg, _np(jc), device="cpu")
        for name in ("k", "v"):
            ulps = _ulps_apart(tc["layers"][name], ref["layers"][name])
            assert int(ulps[0].max()) <= 1, (i, name)
            flips += int((ulps > 0).sum())
    assert flips > 0


def test_decode_step_from_wrapped_reference_cache():
    """The reference decodes 21 tokens into a 16-slot ring (so it has
    wrapped); its cache is carried over with `lm_cache_from_arrays` and
    both packages take one more step from it."""
    jcfg, tcfg, jp, tp = _pair("h2o-danube-3-4b", "float32")
    x = _tokens(tcfg, s=22, seed=1)
    jc = JLM.init_cache(jcfg, 2, 64, dtype=jnp.float32)
    step = _ref_step(jcfg)
    for i in range(21):
        _, jc = step(jp, jc, jnp.asarray(x[:, i]))
    tc = convert.lm_cache_from_arrays(tcfg, _np(jc), device="cpu")
    assert tc["length"] == 21 and tc["layers"]["k"].shape[2] == 16
    jl, jc = step(jp, jc, jnp.asarray(x[:, 21]))
    tl, tc = TLM.decode_step(tp, tcfg, tc, x[:, 21])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    np.testing.assert_allclose(tc["layers"]["v"].numpy(),
                               np.asarray(jc["layers"]["v"]), **F32)


def _image_cache(tp, tcfg, cache, image):
    """Fill a VLM cache's image k and v with each cross site's projections
    of the image embeddings (the caller's job: neither package has a
    prefill-to-cache path)."""
    b, n = image.shape[:2]
    for i, cp in enumerate(tp["cross"]):
        for name, w in (("k", cp["attn"]["wk"]), ("v", cp["attn"]["wv"])):
            cache["image_kv"][name][i] = (image @ w).reshape(
                b, n, tcfg.n_kv_heads, tcfg.head_dim_)


@pytest.mark.parametrize("arch", list(MODELS))
def test_decode_matches_own_forward(arch):
    """The port's decode (float32, float32 cache; the ring wraps for
    h2o-danube; the VLM's image cache holds the projections of the
    forward's image embeddings) against its own full-sequence forward at
    every position, within 1e-5 of the largest logit."""
    _, tcfg, _, tp = _pair(arch, "float32")
    x = _tokens(tcfg, seed=2)
    batch = {"inputs": x}
    cache = TLM.init_cache(tcfg, 2, 64, dtype=torch.float32, device="cpu")
    if tcfg.family == "vlm":
        batch["image_embeds"] = torch.randn(
            2, tcfg.n_image_tokens, tcfg.d_model,
            generator=torch.Generator().manual_seed(3))
        _image_cache(tp, tcfg, cache, batch["image_embeds"])
    full = TLM.forward(tp, tcfg, batch)
    err = 0.0
    for i in range(x.shape[1]):
        logits, _ = TLM.decode_step(tp, tcfg, cache, x[:, i])
        err = max(err, float((logits - full[:, i]).abs().max()))
    assert err <= 1e-5 * float(full.abs().max())


@pytest.mark.parametrize("arch,s_max,n_layers", [
    ("gemma-7b", 8, 1),            # no window: the write clamps at s_max - 1
    ("h2o-danube-3-4b", 8, 2),     # window 16 over an 8-slot ring
])
def test_reference_decode_past_max_seq_len_is_not_carried_over(arch, s_max,
                                                               n_layers):
    """Past ``s_max`` the reference overwrites keys its query must still
    see (without a window ``dynamic_update_slice`` clamps the write to the
    last slot; with a ring shorter than the window it wraps too early) and
    its logits leave the forward's.  The port raises, naming
    ``max_seq_len``, before writing anything."""
    kw = dict(dtype="float32", use_pallas=True, n_layers=n_layers)
    jcfg = dataclasses.replace(JC.smoke_config(arch), **kw)
    tcfg = dataclasses.replace(TC.smoke_config(arch), **kw)
    jp = JLM.init(jcfg, jax.random.key(0))
    tp = convert.lm_params_from_arrays(tcfg, _np(jp), device="cpu")
    x = _tokens(tcfg, s=12, seed=3)
    full = np.asarray(JLM.forward(jp, jcfg, {"inputs": jnp.asarray(x)}))
    jc = JLM.init_cache(jcfg, 2, s_max, dtype=jnp.float32)
    tc = TLM.init_cache(tcfg, 2, s_max, dtype=torch.float32, device="cpu")
    step = _ref_step(jcfg)
    for i in range(12):
        jl, jc = step(jp, jc, jnp.asarray(x[:, i]))
        err = float(np.abs(np.asarray(jl) - full[:, i]).max())
        if i < s_max:
            assert err < 1e-5
            tl, _ = TLM.decode_step(tp, tcfg, tc, x[:, i])
            np.testing.assert_allclose(tl.numpy(), full[:, i], **F32)
        else:
            assert err > 0.1                 # the reference's fault
            k_before = tc["layers"]["k"].clone()
            with pytest.raises(ValueError, match="max_seq_len"):
                TLM.decode_step(tp, tcfg, tc, x[:, i])
            assert tc["length"] == s_max
            assert torch.equal(tc["layers"]["k"], k_before)


@pytest.mark.parametrize("arch,s_max", [("h2o-danube-3-4b", 64),
                                        ("h2o-danube-3-4b", 9),
                                        ("gemma-7b", 33),
                                        ("phi3.5-moe-42b-a6.6b", 33),
                                        ("mamba2-370m", 64),
                                        ("zamba2-1.2b", 40),
                                        ("llama-3.2-vision-11b", 33)])
@pytest.mark.parametrize("dtype", [None, "float32"])
def test_init_cache_matches_reference(arch, s_max, dtype):
    """Every tensor's shape and dtype is the reference's (bf16 by default
    whatever the model dtype; SSM states float32), all zeros; one host int
    where the reference keeps a length a layer and a site."""
    cfg = dataclasses.replace(TC.get_config(arch), n_layers=7,
                              dtype="float32")
    jkw = {} if dtype is None else dict(dtype=getattr(jnp, dtype))
    tkw = {} if dtype is None else dict(dtype=getattr(torch, dtype))
    j = JLM.init_cache(cfg, 2, s_max, **jkw)
    t = TLM.init_cache(cfg, 2, s_max, device="cpu", **tkw)
    assert set(t) == set(j) | {"length"} and t["length"] == 0
    for name, a, b in _cache_leaves(t, j):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert not a.any() and not b.any(), name
    assert np.asarray(j["layers"]["length"]).tolist() == [0] * 7


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_cache_converters_round_trip_bitwise(cache_dtype):
    """Reference cache after 5 steps -> port -> reference arrays is
    bitwise, bf16 included, for attention (h2o-danube's ring), SSM,
    hybrid and VLM caches; unequal lengths (a layer's, or a hybrid
    site's) are refused."""
    for arch in ("h2o-danube-3-4b", "mamba2-370m", "zamba2-1.2b",
                 "llama-3.2-vision-11b"):
        jcfg, tcfg, jp, _ = _pair(arch, "float32")
        jc, _ = _caches(jcfg, tcfg, 2, 64, cache_dtype)
        step = _ref_step(jcfg)
        x = _tokens(tcfg, s=5, seed=4)
        for i in range(5):
            _, jc = step(jp, jc, jnp.asarray(x[:, i]))
        arrays = _np(jc)
        tc = convert.lm_cache_from_arrays(tcfg, arrays, device="cpu")
        assert tc["length"] == 5
        for name, a, b in _cache_leaves(tc, jc):
            assert a.dtype == b.dtype, (arch, name)
            np.testing.assert_array_equal(a, b, err_msg=f"{arch} {name}")
        lengths = np.full(tcfg.n_layers, 5, np.int32)
        lengths[2] = 4
        bad = dict(arrays, layers=dict(arrays["layers"], length=lengths))
        with pytest.raises(ValueError, match="all equal"):
            convert.lm_cache_from_arrays(tcfg, bad, device="cpu")
        if "shared_attn" in arrays:
            sites = [dict(site) for site in arrays["shared_attn"]]
            sites[-1]["length"] = np.asarray(6, np.int32)
            with pytest.raises(ValueError, match="all equal"):
                convert.lm_cache_from_arrays(
                    tcfg, dict(arrays, shared_attn=sites), device="cpu")


def test_cache_follows_the_device_rule():
    cfg = dataclasses.replace(TC.smoke_config("h2o-danube-3-4b"), n_layers=1)
    arrays = convert.lm_cache_to_arrays(TLM.init_cache(cfg, 1, 8,
                                                       device="cpu"))
    if torch.cuda.is_available():
        assert TLM.init_cache(cfg, 1, 8)["layers"]["k"].device.type == "cuda"
        assert convert.lm_cache_from_arrays(
            cfg, arrays)["layers"]["k"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TLM.init_cache(cfg, 1, 8)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            convert.lm_cache_from_arrays(cfg, arrays)


def test_transformer_lm_decode_methods():
    """`TransformerLM.init_cache` / `decode_step` run the functions on the
    module's device."""
    _, tcfg, _, tp = _pair("h2o-danube-3-4b", "float32")
    model = TLM.TransformerLM(tcfg, tp)
    a = model.init_cache(2, 32)
    b = TLM.init_cache(tcfg, 2, 32, device="cpu")
    x = _tokens(tcfg, s=3, seed=6)
    for i in range(3):
        la, a = model.decode_step(a, x[:, i])
        lb, b = TLM.decode_step(tp, tcfg, b, x[:, i])
        assert torch.equal(la, lb)
    assert a["length"] == 3 and torch.equal(a["layers"]["k"], b["layers"]["k"])


# ---------------------------------------------------------------------------
# The serving step
# ---------------------------------------------------------------------------

def _serve_pair(temperature, n_layers=2):
    jcfg, tcfg, jp, tp = _pair("h2o-danube-3-4b", "float32",
                               n_layers=n_layers)
    scfg = JS.ServeConfig(max_seq_len=64, temperature=temperature)
    tscfg = lm_serve.ServeConfig(max_seq_len=64, temperature=temperature)
    assert (tscfg.max_seq_len, tscfg.temperature) == (scfg.max_seq_len,
                                                      scfg.temperature)
    jstep = jax.jit(JS.make_serve_step(jcfg, scfg))
    tstep = lm_serve.make_serve_step(tcfg, tscfg)
    jc = JLM.init_cache(jcfg, 3, scfg.max_seq_len)
    tc = TLM.init_cache(tcfg, 3, tscfg.max_seq_len, device="cpu")
    return jcfg, jp, tp, jstep, tstep, jc, tc


def test_serve_step_greedy_matches_reference():
    """Greedy decoding (a 4-token prompt fed token by token, then 24
    generated tokens past the ring's wrap) gives the reference's tokens."""
    jcfg, jp, tp, jstep, tstep, jc, tc = _serve_pair(0.0)
    prompt = _tokens(jcfg, b=3, s=4, seed=7)
    key = jax.random.key(0)
    jtok = ttok = None
    seen = []
    for i in range(28):
        jin = jnp.asarray(prompt[:, i]) if i < 4 else jtok
        tin = prompt[:, i] if i < 4 else ttok
        jtok, jc = jstep(jp, jc, jin, key)
        ttok, tc = tstep(tp, tc, tin)
        assert ttok.dtype == torch.int32
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        seen.append(ttok.numpy())
    assert len({int(t) for t in np.concatenate(seen)}) > 3


def test_serve_step_gumbel_noise_matches_reference():
    """At T = 0.7 the reference draws ``jax.random.categorical(key, logits
    / T)``; the port given ``jax.random.gumbel(key, logits.shape)`` as its
    noise picks the same tokens."""
    jcfg, jp, tp, jstep, tstep, jc, tc = _serve_pair(0.7)
    prompt = _tokens(jcfg, b=3, s=2, seed=8)
    jtok = ttok = None
    for i in range(20):
        key = jax.random.fold_in(jax.random.key(9), i)
        gumbel = np.array(jax.random.gumbel(key, (3, jcfg.padded_vocab)))
        jin = jnp.asarray(prompt[:, i]) if i < 2 else jtok
        tin = prompt[:, i] if i < 2 else ttok
        jtok, jc = jstep(jp, jc, jin, key)
        ttok, tc = tstep(tp, tc, tin, gumbel=gumbel)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


def test_serve_step_generator_draws_are_reproducible():
    """One generator seed gives one token sequence; another seed another;
    sampling without a generator or noise is refused."""
    _, tcfg, _, tp = _pair("h2o-danube-3-4b", "float32", n_layers=1)
    step = lm_serve.make_serve_step(
        tcfg, lm_serve.ServeConfig(max_seq_len=32, temperature=1.0))

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        cache = TLM.init_cache(tcfg, 4, 32, device="cpu")
        tok, out = torch.zeros(4, dtype=torch.int32), []
        for _ in range(12):
            tok, cache = step(tp, cache, tok, generator=g)
            out.append(tok)
        return torch.stack(out)

    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))
    cache = TLM.init_cache(tcfg, 1, 32, device="cpu")
    with pytest.raises(ValueError, match="needs a generator"):
        step(tp, cache, np.zeros(1, np.int32))


@pytest.mark.parametrize("arch,s_max", [("h2o-danube-3-4b", 8),
                                        ("musicgen-medium", 32),
                                        ("zamba2-1.2b", 32),
                                        ("llama-3.2-vision-11b", 32)])
def test_serve_step_refuses_a_cache_of_another_size(arch, s_max):
    """The step holds the cache to ``max_seq_len``: a cache made for
    another size (here 48: 16 ring slots for h2o-danube, 48 for musicgen
    and the VLM's layers, 48 in each of zamba2's shared-attention sites)
    raises naming ``max_seq_len`` and is left as it was."""
    _, tcfg, _, tp = _pair(arch, "float32", n_layers=3)
    step = lm_serve.make_serve_step(tcfg, lm_serve.ServeConfig(
        max_seq_len=s_max))
    x = _tokens(tcfg, b=1, s=1)[:, 0]
    cache = TLM.init_cache(tcfg, 1, 48, device="cpu")
    tensors = [t for t in jax.tree.leaves(cache)
               if isinstance(t, torch.Tensor)]
    with pytest.raises(ValueError, match="max_seq_len"):
        step(tp, cache, x)
    assert cache["length"] == 0 and not any(t.any() for t in tensors)
    ok = TLM.init_cache(tcfg, 1, s_max, device="cpu")
    tok, ok = step(tp, ok, x)
    assert ok["length"] == 1 and tok.shape == (1,)


def test_serve_step_takes_an_ssm_cache_of_any_size():
    """An SSM cache has no slots to hold to ``max_seq_len``: caches made
    for any size serve the same tokens."""
    _, tcfg, _, tp = _pair("mamba2-370m", "float32", n_layers=2)
    step = lm_serve.make_serve_step(tcfg, lm_serve.ServeConfig(
        max_seq_len=8))
    x = _tokens(tcfg, b=2, s=12, seed=9)
    toks = []
    for s_max in (8, 1000):
        cache = TLM.init_cache(tcfg, 2, s_max, device="cpu")
        out = [step(tp, cache, x[:, i])[0] for i in range(12)]
        assert cache["length"] == 12
        toks.append(torch.stack(out))
    assert torch.equal(toks[0], toks[1])


def test_serve_step_refuses_an_image_cache_of_another_size():
    """A VLM cache whose image k and v hold another number of image tokens
    than the config's raises, naming the image cache."""
    _, tcfg, _, tp = _pair("llama-3.2-vision-11b", "float32", n_layers=2)
    step = lm_serve.make_serve_step(tcfg, lm_serve.ServeConfig(
        max_seq_len=16))
    other = dataclasses.replace(tcfg, n_image_tokens=tcfg.n_image_tokens + 1)
    cache = TLM.init_cache(other, 1, 16, device="cpu")
    with pytest.raises(ValueError, match="the image cache holds 17 slots"):
        step(tp, cache, _tokens(tcfg, b=1, s=1)[:, 0])
