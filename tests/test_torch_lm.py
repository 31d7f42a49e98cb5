"""Port vs reference: the LM prefill path of every family (config
registry, layers, B7's plain version, whole forward and prefill, the token
stream).

Inputs are made with a seeded numpy generator; the reference's random
parameters (``repro.models.lm.init``) are carried over with
`repro_torch.io.convert.lm_params_from_arrays`, so both packages run the
same model.  The reference's attention is its Pallas kernel B7 in interpret
mode (``use_pallas=True``), whose semantics the port implements (its
``use_pallas=False`` path rounds the probabilities to the model dtype).  A
VLM's cross gates are zero at init, which would hide its cross blocks, so
`_pair` draws them nonzero in the reference's tree before carrying it over,
and the VLM's image embeddings are given to both packages in float32, as
the data pipeline makes them (`lm_batches`): in a bf16 model both project
them to the cross k and v in float32, and the port then rounds k and v to
bf16 for B7 where the reference's kernel reads them in float32, a
difference held by the bf16 envelope below.

Tolerances.  B7's plain version against ``ref.mha_ref`` and the interpret
kernel: atol 2e-6 + rtol 1e-5 in float32 (both compute in float32; the
sums run in another order).  Layers and the whole model in float32: atol
1e-4 + rtol 1e-4 (matmul and transcendental rounding of two libraries over
a few layers).  The whole model in bfloat16: the reference's own bf16
envelope, atol 5e-2 + rtol 5e-2 (tests/test_models.py), since the two
libraries round bf16 products and activations at different places.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import configs as JC
from repro.data import pipeline as JP
from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro.models import config as JMC
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.models import params as JPA
from repro_torch import configs as TC
from repro_torch.data import pipeline as TP
from repro_torch.io import convert
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref as TR
from repro_torch.models import config as TMC
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.models import params as TPA
from repro_torch.training import lm_serve

F32 = dict(atol=1e-4, rtol=1e-4)
BF16_ENVELOPE = dict(atol=5e-2, rtol=5e-2)
ATTN = dict(atol=2e-6, rtol=1e-5)


def _np(tree):
    """A JAX tree as numpy arrays, bfloat16 as its uint16 bits."""
    return jax.tree.map(lambda a: np.asarray(a).view(np.uint16)
                        if a.dtype == jnp.bfloat16 else np.asarray(a), tree)


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32), np.float32)


# ---------------------------------------------------------------------------
# Registry and declarations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", JC.ARCH_NAMES)
def test_registry_matches_reference(arch):
    """Full and smoke configs are field by field the reference's, with the
    same parameter counts."""
    assert TC.ARCH_NAMES == JC.ARCH_NAMES
    for get in ("get_config", "smoke_config"):
        t, j = getattr(TC, get)(arch), getattr(JC, get)(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.n_params(), t.active_params(), t.padded_vocab,
                t.head_dim_) == (j.n_params(), j.active_params(),
                                 j.padded_vocab, j.head_dim_)


def test_shapes_and_gbdt_config_match_reference():
    assert [dataclasses.asdict(s) for s in TMC.LM_SHAPES] == \
        [dataclasses.asdict(s) for s in JMC.LM_SHAPES]
    assert TMC.shape_by_name("prefill_32k") == TMC.LM_SHAPES[1]
    with pytest.raises(KeyError):
        TMC.shape_by_name("nope")
    with pytest.raises(KeyError, match="unknown arch"):
        TC.get_config("nope")
    cfg, n, m = TC.get_gbdt_config()
    jcfg, jn, jm = JC.get_gbdt_config()
    assert (n, m) == (jn, jm)
    assert (cfg.n_outputs, cfg.sketch_k, cfg.n_trees, cfg.depth) == \
        (jcfg.n_outputs, jcfg.sketch_k, jcfg.n_trees, jcfg.depth)


@pytest.mark.parametrize("arch", JC.ARCH_NAMES)
def test_param_decls_match_reference(arch):
    """The port declares the reference's tree (shapes, axes, init), sites
    included.  Its count is the reference tree's, and the config's analytic
    one where that counts every declared tensor (dense, audio and MoE: the
    analytic count leaves out the SSM's A_log, D, dt_bias and norm, the
    shared block's norms, and counts an MLP a cross site has not)."""
    cfg = TC.get_config(arch)
    t = TPA.map_decls(dataclasses.astuple, TLM.param_decls(cfg))
    jdecls = JLM.param_decls(JC.get_config(arch))
    j = jax.tree.map(dataclasses.astuple, jdecls,
                     is_leaf=lambda x: hasattr(x, "axes"))
    assert t == j
    n = TPA.n_params(TLM.param_decls(cfg))
    assert n == JPA.n_params(jdecls)
    if cfg.family in ("dense", "audio", "moe"):
        assert n == cfg.n_params()


def test_init_params_dtypes_and_scales():
    """Matrices in the model dtype with fan-in-scaled (or 0.02) normals,
    norm weights float32 ones; one seed gives one model."""
    cfg = dataclasses.replace(TC.smoke_config("granite-34b"), n_layers=2)
    make = lambda: TLM.init(cfg, torch.Generator().manual_seed(5),  # noqa: E731
                            device="cpu")
    p, again = make(), make()
    assert len(p["blocks"]) == 2
    assert p["blocks"][1]["ln1"].dtype == torch.float32
    assert torch.equal(p["final_norm"], torch.ones(cfg.d_model))
    wi = p["blocks"][0]["mlp"]["wi"]
    assert wi.dtype == torch.bfloat16 and wi.shape == (128, 256)
    assert abs(float(wi.float().std()) * np.sqrt(128) - 1.0) < 0.05
    assert abs(float(p["lm_head"].float().std()) - 0.02) < 0.002
    assert all(torch.equal(a, b) for a, b in zip(
        TLM._flatten(p).values(), TLM._flatten(again).values()))


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rope_match_reference(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 24, 4, 120)).astype(np.float32)
    w = rng.normal(size=(120,)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tol = F32 if dtype == "float32" else dict(atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(_f32(TL.rms_norm(tx, torch.from_numpy(w))),
                               _f32(JL.rms_norm(jx, jnp.asarray(w))), **tol)
    pos = np.arange(100, 124)
    out = TL.rope(tx, torch.from_numpy(pos), 10_000.0)
    assert out.dtype == tx.dtype
    np.testing.assert_allclose(
        _f32(out), _f32(JL.rope(jx, jnp.asarray(pos), 10_000.0)), **tol)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_reference(act):
    rng = np.random.default_rng(2)
    p = {k: (rng.normal(size=d.shape) / np.sqrt(d.shape[0])).astype(
        np.float32) for k, d in TL.mlp_decls(64, 96, act).items()}
    x = rng.normal(size=(2, 8, 64)).astype(np.float32)
    out = TL.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), act=act)
    ref = JL.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x), act=act)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


def test_gelu_is_the_tanh_form():
    x = torch.tensor([1.0])
    p = {"wi": torch.eye(1), "wo": torch.eye(1)}
    assert float(TL.mlp_apply(p, x[None], act="gelu")) == pytest.approx(
        float(jax.nn.gelu(1.0)), abs=1e-7)
    assert abs(float(jax.nn.gelu(1.0)) - 0.841345) > 1e-4   # not erf


@pytest.mark.parametrize("n_kv,window", [(2, 16), (1, None), (4, 5)])
def test_attention_apply_matches_reference(n_kv, window):
    """The attention module (projections, RoPE, B7, output projection)
    against the reference's with ``use_pallas=True``."""
    rng = np.random.default_rng(n_kv)
    decls = TL.attention_decls(64, 4, n_kv, 32)
    p = {k: rng.normal(size=d.shape).astype(np.float32) / 8.0
         for k, d in decls.items()}
    x = rng.normal(size=(2, 40, 64)).astype(np.float32)
    kw = dict(n_heads=4, n_kv_heads=n_kv, head_dim=32, rope_theta=10_000.0,
              window=window)
    out = TL.attention_apply({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x), **kw)
    ref = JL.attention_apply({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), use_pallas=True, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_apply_matches_reference(dtype):
    """Cross-attention (``kv_inputs``: no RoPE, no mask, sk != sq) with
    float32 image embeddings, in a float32 and a bf16 module, against the
    reference's with ``use_pallas=True`` (32 keys: its wrapper pads none).
    In bf16 both project k and v in float32; the port then rounds them to
    bf16 for B7 (exactly that, checked bitwise), the reference's kernel
    reads them in float32, and the two agree within the bf16 envelope."""
    rng = np.random.default_rng(5)
    decls = TL.attention_decls(64, 4, 2, 32)
    p = {k: rng.normal(size=d.shape).astype(np.float32) / 8.0
         for k, d in decls.items()}
    x = rng.normal(size=(2, 20, 64)).astype(np.float32)
    kv = rng.normal(size=(2, 32, 64)).astype(np.float32)
    kw = dict(n_heads=4, n_kv_heads=2, head_dim=32, rope_theta=10_000.0)
    tp = {k: torch.from_numpy(v).to(getattr(torch, dtype))
          for k, v in p.items()}
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    out = TL.attention_apply(tp, xt, kv_inputs=torch.from_numpy(kv), **kw)
    ref = JL.attention_apply(
        {k: jnp.asarray(v).astype(getattr(jnp, dtype)) for k, v in p.items()},
        jnp.asarray(x).astype(getattr(jnp, dtype)),
        kv_inputs=jnp.asarray(kv), use_pallas=True, **kw)
    assert out.dtype == getattr(torch, dtype) and str(ref.dtype) == dtype
    tol = F32 if dtype == "float32" else BF16_ENVELOPE
    np.testing.assert_allclose(_f32(out), _f32(ref), **tol)

    def heads(t, h):
        return t.reshape(2, -1, h, 32).transpose(1, 2).contiguous()
    k, v = (heads((torch.from_numpy(kv) @ tp[w].float()).to(xt.dtype), 2)
            for w in ("wk", "wv"))
    o = FA.flash_attention(heads(xt @ tp["wq"], 4), k, v, causal=False)
    assert torch.equal(out, o.transpose(1, 2).reshape(2, 20, 128) @ tp["wo"])


# ---------------------------------------------------------------------------
# B7's plain version
# ---------------------------------------------------------------------------

def _qkv(b, hq, hkv, s, dh, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, s, dh)).astype(dtype)
            for h in (hq, hkv, hkv)]


# (group, causal, window, s, dh): every group 1/2/4/8, causal on and off,
# window None/16/50, s in {64, 200, 257} and dh in {32, 120, 256}.
ATTN_CASES = [
    (1, True, None, 64, 32), (1, False, 50, 200, 120),
    (1, True, 16, 257, 256), (2, False, None, 64, 120),
    (2, True, 50, 200, 32), (2, True, None, 257, 120),
    (4, True, 16, 64, 120), (4, False, 16, 200, 256),
    (4, False, None, 257, 32), (8, True, 50, 64, 256),
    (8, False, None, 200, 32), (8, True, 16, 257, 120),
    (2, False, 50, 257, 32), (4, True, 50, 257, 120),
]


@pytest.mark.parametrize("group,causal,window,s,dh", ATTN_CASES)
def test_flash_attention_ref_matches_reference(group, causal, window, s, dh):
    """The plain version against ``ref.mha_ref`` always, and against the
    reference's kernel (``ops.flash_attention``, interpret mode) where that
    one is right: causal, or no padding to its tile (see the next test)."""
    hkv = 8 // group if group < 8 else 1
    q, k, v = _qkv(1, hkv * group, hkv, s, dh, seed=s + dh + group)
    out = FA.flash_attention(*map(torch.from_numpy, (q, k, v)),
                             causal=causal, window=window).numpy()
    j = [jnp.asarray(a) for a in (q, k, v)]
    np.testing.assert_allclose(
        out, np.asarray(JR.mha_ref(*j, causal=causal, window=window)), **ATTN)
    block = min(128, max(8, 1 << (s - 1).bit_length()))
    if causal or s % block == 0:
        np.testing.assert_allclose(out, np.asarray(JO.flash_attention(
            *j, causal=causal, window=window, interpret=True)), **ATTN)


def test_reference_padding_fault_is_not_carried_over():
    """``ops.flash_attention`` pads k/v to its tile with zeros and passes the
    padded length as ``kv_len``, so without the causal mask the zero keys
    are attended to.  The port masks keys past the true ``sk``."""
    q, k, v = _qkv(1, 2, 2, 200, 32, seed=7)
    j = [jnp.asarray(a) for a in (q, k, v)]
    want = np.asarray(JR.mha_ref(*j, causal=False))
    out = FA.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=False)
    np.testing.assert_allclose(out.numpy(), want, **ATTN)
    faulty = np.asarray(JO.flash_attention(*j, causal=False, interpret=True))
    assert np.abs(faulty - want).max() > 0.05


@settings(deadline=None, max_examples=12)
@given(group=st.sampled_from([1, 2, 4]), s=st.integers(1, 90),
       dh=st.integers(1, 40), causal=st.booleans(),
       window=st.one_of(st.none(), st.integers(1, 40)),
       seed=st.integers(0, 2 ** 16))
def test_flash_attention_ref_property(group, s, dh, causal, window, seed):
    """Any length and head width: the plain version is ``mha_ref``."""
    q, k, v = _qkv(2, 2 * group, 2, s, dh, seed)
    out = FA.flash_attention(*map(torch.from_numpy, (q, k, v)),
                             causal=causal, window=window)
    want = JR.mha_ref(*map(jnp.asarray, (q, k, v)), causal=causal,
                      window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **ATTN)


def test_flash_attention_ref_chunks_and_cross_lengths():
    """Query chunks smaller than the sequence, and sq != sk, change
    nothing: the chunked plain version equals ``mha_ref``."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(1, 4, 37, 16)).astype(np.float32)
    kv = [rng.normal(size=(1, 2, 50, 16)).astype(np.float32) for _ in "kv"]
    t = [torch.from_numpy(a) for a in (q, *kv)]
    for causal, window in ((True, None), (False, 20), (True, 7)):
        want = np.asarray(JR.mha_ref(*map(jnp.asarray, (q, *kv)),
                                     causal=causal, window=window))
        for chunk in (5, 64):
            out = TR.flash_attention_ref(*t, causal=causal, window=window,
                                         chunk=chunk)
            np.testing.assert_allclose(out.numpy(), want, **ATTN)


@pytest.mark.parametrize("bad,match", [
    (dict(q=torch.zeros(1, 3, 4, 8), k=torch.zeros(1, 2, 4, 8),
          v=torch.zeros(1, 2, 4, 8)), "multiple of kv heads"),
    (dict(q=torch.zeros(1, 2, 4, 8, dtype=torch.float16)), "float32 or bf"),
    (dict(k=torch.zeros(1, 1, 4, 8, dtype=torch.bfloat16)), "k must be"),
    (dict(window=0), "window 0"),
    (dict(q=torch.zeros(1, 2, 9, 8), window=5), "every query row a key"),
    (dict(q=torch.zeros(1, 2, 4, 300), k=torch.zeros(1, 1, 4, 300),
          v=torch.zeros(1, 1, 4, 300)), "dh <= 256"),
])
def test_flash_attention_refuses_bad_inputs(bad, match):
    args = dict(q=torch.zeros(1, 2, 4, 8), k=torch.zeros(1, 1, 4, 8),
                v=torch.zeros(1, 1, 4, 8), window=None)
    args.update(bad)
    with pytest.raises(ValueError, match=match):
        FA.flash_attention(args["q"], args["k"], args["v"],
                           window=args["window"])


# ---------------------------------------------------------------------------
# Whole model
# ---------------------------------------------------------------------------

MODELS = {
    "h2o-danube-3-4b": dict(n_kv_heads=2),   # GQA 2, window 16
    "gemma-7b": {},                          # geglu, embed_scale
    "granite-34b": {},                       # kv=1, gelu, untied head
    "musicgen-medium": {},                   # embed_inputs
    "grok-1-314b": {},                       # MoE 4 experts, moe_shard tp
    "phi3.5-moe-42b-a6.6b": {},              # MoE 4 experts, ep, GQA 4
    "mamba2-370m": {},                       # SSD, attention-free
    "zamba2-1.2b": {},                       # SSD + shared attention, MHA
    "llama-3.2-vision-11b": {},              # cross sites over 16 images
}


def _open_gates(jp, seed=11):
    """The reference's VLM tree with its cross gates drawn nonzero."""
    if "cross" in jp:
        gate = jp["cross"]["gate"]
        jp["cross"]["gate"] = jnp.asarray(np.random.default_rng(seed).normal(
            size=gate.shape).astype(np.float32))
    return jp


def _pair(arch, dtype, **over):
    """(reference config, port config, reference params, port params); a
    VLM's gates drawn nonzero in both trees."""
    kw = dict(MODELS[arch], dtype=dtype, use_pallas=True, **over)
    jcfg = dataclasses.replace(JC.smoke_config(arch), **kw)
    tcfg = dataclasses.replace(TC.smoke_config(arch), **kw)
    jp = _open_gates(JLM.init(jcfg, jax.random.key(0)))
    return jcfg, tcfg, jp, convert.lm_params_from_arrays(tcfg, _np(jp),
                                                         device="cpu")


def _inputs(cfg, b=2, s=64, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.embed_inputs:
        return rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _batches(cfg, b=2, s=64, seed=0):
    """(reference batch, port batch): the same tokens, and for a VLM the
    same float32 image embeddings, whatever the model dtype."""
    x = _inputs(cfg, b, s, seed)
    jb, tb = {"inputs": jnp.asarray(x)}, {"inputs": x}
    if cfg.family == "vlm":
        im = np.random.default_rng(seed + 1).normal(
            size=(b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
        jb["image_embeds"], tb["image_embeds"] = jnp.asarray(im), im
    return jb, tb


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", list(MODELS))
def test_forward_and_prefill_match_reference(arch, dtype):
    jcfg, tcfg, jp, tp = _pair(arch, dtype)
    jb, tb = _batches(tcfg)
    want = np.asarray(JLM.forward(jp, jcfg, jb), np.float32)
    out = TLM.forward(tp, tcfg, tb)
    assert out.dtype == torch.float32
    assert out.shape == (2, 64, tcfg.padded_vocab)
    tol = F32 if dtype == "float32" else BF16_ENVELOPE
    np.testing.assert_allclose(out.numpy(), want, **tol)
    want_last = np.asarray(JLM.prefill(jp, jcfg, jb), np.float32)
    step = lm_serve.make_prefill_step(tcfg)
    last = step(tp, {k: torch.from_numpy(v) for k, v in tb.items()})
    np.testing.assert_allclose(last.numpy(), want_last, **tol)
    np.testing.assert_allclose(last.numpy(), out[:, -1].numpy(), **F32)


def test_vlm_gates_open_the_cross_blocks():
    """Zero gates (the init) close the cross blocks: the port's forward
    ignores the image.  Open gates (`_pair`) let it through, in both
    packages alike."""
    _, tcfg, _, tp = _pair("llama-3.2-vision-11b", "float32")
    closed = TLM.init(tcfg, torch.Generator().manual_seed(1), device="cpu")
    assert all(not c["gate"].any() for c in closed["cross"])
    assert all(c["gate"].abs().min() > 0 for c in tp["cross"])
    _, tb = _batches(tcfg, s=12)
    other = dict(tb, image_embeds=tb["image_embeds"] * 3.0 + 1.0)
    assert torch.equal(TLM.forward(closed, tcfg, tb),
                       TLM.forward(closed, tcfg, other))
    assert not torch.allclose(TLM.forward(tp, tcfg, tb),
                              TLM.forward(tp, tcfg, other), atol=1e-3)
    with pytest.raises(ValueError, match="image_embeds"):
        TLM.forward(tp, tcfg, {"inputs": tb["inputs"]})


def test_use_pallas_does_not_change_the_port():
    """The port keeps the field but always runs B7."""
    _, tcfg, _, tp = _pair("h2o-danube-3-4b", "float32")
    x = _inputs(tcfg, s=40)
    a = TLM.forward(tp, tcfg, {"inputs": x})
    b = TLM.forward(tp, dataclasses.replace(tcfg, use_pallas=False),
                    {"inputs": x})
    assert torch.equal(a, b)


def test_transformer_lm_module_runs_the_functions():
    _, tcfg, _, tp = _pair("gemma-7b", "float32")
    model = TLM.TransformerLM(tcfg, tp)
    assert isinstance(model, torch.nn.Module)
    assert "weights.blocks/3/attn/wq" in model.state_dict()
    assert not any(p.requires_grad for p in model.parameters())
    x = _inputs(tcfg, s=20)
    assert torch.equal(model(dict(inputs=x)),
                       TLM.forward(tp, tcfg, {"inputs": x}))
    assert torch.equal(model.prefill(dict(inputs=x)),
                       TLM.prefill(tp, tcfg, {"inputs": x}))
    rand = TLM.TransformerLM.random(tcfg, torch.Generator().manual_seed(0),
                                    device="cpu")
    assert sum(p.numel() for p in rand.parameters()) == tcfg.n_params()


def test_init_follows_the_device_rule():
    """``lm.init`` and `TransformerLM.random` build on CUDA unless the
    caller names another device, and refuse a generator on another
    device."""
    cfg = dataclasses.replace(TC.smoke_config("h2o-danube-3-4b"), n_layers=1)
    if torch.cuda.is_available():
        p = TLM.init(cfg, torch.Generator(device="cuda"))
        assert p["embed"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TLM.init(cfg, torch.Generator())
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TLM.TransformerLM.random(cfg, torch.Generator())
    with pytest.raises(ValueError, match="generator lies on cpu"):
        TLM.init(cfg, torch.Generator(), device="cuda")
    with pytest.raises(ValueError, match="generator lies on cpu"):
        TLM.TransformerLM.random(cfg, torch.Generator(), device="meta")
    p = TLM.init(cfg, torch.Generator().manual_seed(3), device="cpu")
    assert p["embed"].device.type == "cpu"


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "llama-3.2-vision-11b"])
def test_transformer_lm_module_keeps_sites(arch):
    """The hybrid's shared block and the VLM's cross sites go through the
    module's flat names and back unchanged."""
    _, tcfg, _, tp = _pair(arch, "float32")
    model = TLM.TransformerLM(tcfg, tp)
    names = model.state_dict()
    key = ("weights.shared_attn/attn/wq" if tcfg.family == "hybrid"
           else "weights.cross/1/gate")
    assert key in names
    back = model.params
    assert all(torch.equal(a, b) for a, b in zip(
        TLM._flatten(back).values(), TLM._flatten(tp).values()))
    _, tb = _batches(tcfg, s=10)
    assert torch.equal(model(tb), TLM.forward(tp, tcfg, tb))


def test_vocab_mask_matches_reference():
    cfg = TC.get_config("phi3.5-moe-42b-a6.6b")       # 32064 -> 32256
    mask = TLM.vocab_mask(cfg)
    np.testing.assert_array_equal(mask.numpy(),
                                  np.asarray(JLM.vocab_mask(cfg)))
    assert TLM.vocab_mask(TC.get_config("h2o-danube-3-4b")) is None


def test_lm_params_from_arrays_follows_the_device_rule():
    cfg = TC.smoke_config("h2o-danube-3-4b")
    tree = _np(JLM.init(JC.smoke_config("h2o-danube-3-4b"), jax.random.key(1)))
    if torch.cuda.is_available():
        p = convert.lm_params_from_arrays(cfg, tree)
        assert p["embed"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            convert.lm_params_from_arrays(cfg, tree)
    p = convert.lm_params_from_arrays(cfg, tree, device="cpu")
    assert p["embed"].dtype == torch.bfloat16
    assert torch.equal(p["blocks"][2]["attn"]["wk"].view(torch.int16),
                       torch.from_numpy(tree["blocks"]["attn"]["wk"][2]
                                        .view(np.int16).copy()))


# ---------------------------------------------------------------------------
# Token stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(embed_dim=8),
                                dict(image_tokens=3, d_model=4)])
def test_lm_batches_bitwise(kw):
    t = TP.lm_batches(300, 2, 17, seed=4, **kw)
    j = JP.lm_batches(300, 2, 17, seed=4, **kw)
    for _ in range(3):
        a, b = next(t), next(j)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
