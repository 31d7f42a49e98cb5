"""Port vs reference: the Mamba2 (SSD) block (`repro_torch.models.ssm`).

Inputs are made with a seeded numpy generator and handed to both packages.

Tolerances.  The chunked scan in float32 against the reference's: atol 1e-4
+ rtol 1e-4.  The port passes the chunk states on by one product with the
matrix of decays between chunks where the reference runs a log-depth
associative scan, and the two libraries order their matmul sums
differently, so the float32 results differ by rounding only.  Against the plain recurrence over time (both packages'
``ssd_reference``): 1e-4 in float32 at these sizes (the chunked form sums
exp(cum_i - cum_j) products where the recurrence multiplies decays step by
step).  The whole block: float32 1e-4, bfloat16 within the
reference's own bf16 envelope, atol 5e-2 + rtol 5e-2 (tests/test_models.py).
Decode step by step against the port's own full-sequence block: 1e-4 in
float32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.models import ssm as JS
from repro_torch.models import params as TPA
from repro_torch.models import ssm as TS

F32 = dict(atol=1e-4, rtol=1e-4)
BF16_ENVELOPE = dict(atol=5e-2, rtol=5e-2)

# d_model, d_inner, n_state, heads, head_dim, d_conv: smoke_config's widths.
DIMS = (128, 256, 16, 8, 32, 4)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _ssd_inputs(b, s, h, p, n, seed):
    rng = np.random.default_rng(seed)
    return dict(x=rng.normal(size=(b, s, h, p)).astype(np.float32),
                dt=np.abs(rng.normal(size=(b, s, h))).astype(np.float32) / 2,
                A=-np.abs(rng.normal(size=(h,))).astype(np.float32),
                Bm=rng.normal(size=(b, s, n)).astype(np.float32),
                Cm=rng.normal(size=(b, s, n)).astype(np.float32))


def _block_params(seed, dtype="float32"):
    d, di, n, h, _, k = DIMS
    rng = np.random.default_rng(seed)
    p = {}
    for name, decl in TS.ssm_decls(d, di, n, h, k).items():
        if decl.init == "ones":
            a = np.ones(decl.shape, np.float32)
        elif name in ("A_log", "dt_bias"):
            a = rng.normal(size=decl.shape).astype(np.float32) / 2
        else:
            scale = 0.3 if decl.init == "small_normal" else \
                1 / np.sqrt(decl.shape[0])
            a = (rng.normal(size=decl.shape) * scale).astype(np.float32)
        p[name] = a
    low = ("A_log", "D", "dt_bias", "norm")         # float32 in both trees
    tp = {k: torch.from_numpy(v).to(torch.float32 if k in low
                                    else getattr(torch, dtype))
          for k, v in p.items()}
    jp = {k: jnp.asarray(v).astype(jnp.float32 if k in low
                                   else getattr(jnp, dtype))
          for k, v in p.items()}
    return tp, jp


def test_ssm_decls_match_reference():
    t = TPA.map_decls(dataclasses.astuple, TS.ssm_decls(64, 128, 16, 4, 4))
    j = jax.tree.map(dataclasses.astuple, JS.ssm_decls(64, 128, 16, 4, 4),
                     is_leaf=lambda x: hasattr(x, "axes"))
    assert t == j


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_reference(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 19, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    out = TS._causal_conv(torch.from_numpy(x).to(getattr(torch, dtype)),
                          torch.from_numpy(w).to(getattr(torch, dtype)))
    want = JS._causal_conv(jnp.asarray(x).astype(getattr(jnp, dtype)),
                           jnp.asarray(w).astype(getattr(jnp, dtype)))
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_f32(out), _f32(want))


# (b, s, heads, head_dim, state, chunk): chunks of 8 and 16, a chunk longer
# than s, an s that the chunk does not divide (halved to 4), a single
# chunk, and 128 chunks (a long prefill's matrix of decays between chunks).
SSD_CASES = [(2, 32, 4, 8, 16, 8), (1, 48, 2, 16, 8, 16),
             (2, 12, 3, 4, 4, 64), (1, 20, 2, 8, 8, 8),
             (1, 512, 2, 4, 4, 4)]


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_CASES)
def test_ssd_chunked_matches_reference(b, s, h, p, n, chunk):
    """The chunked scan (and its final state) against the reference's in
    float32, and both against the plain recurrence."""
    a = _ssd_inputs(b, s, h, p, n, seed=s + chunk)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    j = {k: jnp.asarray(v) for k, v in a.items()}
    y, hs = TS._ssd_chunked(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"], chunk)
    jy, jh = JS._ssd_chunked(j["x"], j["dt"], j["A"], j["Bm"], j["Cm"],
                             chunk)
    assert y.dtype == torch.float32 and hs.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32)
    np.testing.assert_allclose(hs.numpy(), np.asarray(jh), **F32)
    ry, rh = TS.ssd_reference(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"])
    jry, jrh = JS.ssd_reference(j["x"], j["dt"], j["A"], j["Bm"], j["Cm"])
    np.testing.assert_allclose(ry.numpy(), np.asarray(jry), **F32)
    np.testing.assert_allclose(rh.numpy(), np.asarray(jrh), **F32)
    np.testing.assert_allclose(y.numpy(), ry.numpy(), **F32)
    np.testing.assert_allclose(hs.numpy(), rh.numpy(), **F32)


@settings(deadline=None, max_examples=10)
@given(s=st.integers(1, 40), chunk=st.sampled_from([1, 4, 8, 16]),
       seed=st.integers(0, 2 ** 16))
def test_ssd_chunked_is_the_recurrence(s, chunk, seed):
    """Any length and chunk: the chunked scan is the plain recurrence."""
    a = _ssd_inputs(1, s, 2, 4, 4, seed)
    t = [torch.from_numpy(a[k]) for k in ("x", "dt", "A", "Bm", "Cm")]
    y, hs = TS._ssd_chunked(*t, chunk)
    ry, rh = TS.ssd_reference(*t)
    np.testing.assert_allclose(y.numpy(), ry.numpy(), **F32)
    np.testing.assert_allclose(hs.numpy(), rh.numpy(), **F32)


def test_ssd_chunked_bf16_keeps_the_precision_policy():
    """bf16 x, B, C: the output is bf16, within the bf16 envelope of the
    reference's; the state stays float32."""
    a = _ssd_inputs(2, 32, 4, 8, 16, seed=7)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    j = {k: jnp.asarray(v) for k, v in a.items()}
    bf = [t["x"].bfloat16(), t["dt"], t["A"], t["Bm"].bfloat16(),
          t["Cm"].bfloat16()]
    y, hs = TS._ssd_chunked(*bf, 8)
    jy, jh = JS._ssd_chunked(j["x"].astype(jnp.bfloat16), j["dt"], j["A"],
                             j["Bm"].astype(jnp.bfloat16),
                             j["Cm"].astype(jnp.bfloat16), 8)
    assert y.dtype == torch.bfloat16 and hs.dtype == torch.float32
    np.testing.assert_allclose(_f32(y), _f32(jy), **BF16_ENVELOPE)
    np.testing.assert_allclose(hs.numpy(), np.asarray(jh), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,chunk", [(24, 16), (7, 4)])
def test_ssm_apply_matches_reference(s, chunk, dtype):
    d, _, n, h, hd, k = DIMS
    tp, jp = _block_params(seed=s, dtype=dtype)
    x = np.random.default_rng(s).normal(size=(2, s, d)).astype(np.float32)
    kw = dict(n_state=n, n_heads=h, head_dim=hd, d_conv=k, chunk=chunk)
    out = TS.ssm_apply(tp, torch.from_numpy(x).to(getattr(torch, dtype)),
                       **kw)
    want = JS.ssm_apply(jp, jnp.asarray(x).astype(getattr(jnp, dtype)), **kw)
    assert out.dtype == getattr(torch, dtype)
    tol = F32 if dtype == "float32" else BF16_ENVELOPE
    np.testing.assert_allclose(_f32(out), _f32(want), **tol)


def _cache_arrays(b, seed):
    d, di, n, h, hd, k = DIMS
    rng = np.random.default_rng(seed)
    return dict(state=rng.normal(size=(b, h, hd, n)).astype(np.float32),
                conv_x=rng.normal(size=(b, k - 1, di)).astype(np.float32),
                conv_B=rng.normal(size=(b, k - 1, n)).astype(np.float32),
                conv_C=rng.normal(size=(b, k - 1, n)).astype(np.float32))


@pytest.mark.parametrize("dtype,cache_dtype", [("float32", "float32"),
                                               ("float32", "bfloat16"),
                                               ("bfloat16", "bfloat16")])
def test_ssm_decode_matches_reference(dtype, cache_dtype):
    """Three decode steps from the same random cache: outputs, the float32
    state and the convolution buffers (in the cache dtype) against the
    reference's; the port's cache is updated in place."""
    d, di, n, h, hd, k = DIMS
    tp, jp = _block_params(seed=3, dtype=dtype)
    c = _cache_arrays(2, seed=4)
    tc = TS.ssm_cache(2, h, hd, n, k, di, dtype=getattr(torch, cache_dtype))
    jc = JS.ssm_cache(2, h, hd, n, k, di, dtype=getattr(jnp, cache_dtype))
    for name in ("state", "conv_x", "conv_B", "conv_C"):
        tc[name].copy_(torch.from_numpy(c[name]))
        jc[name] = jnp.asarray(c[name]).astype(jc[name].dtype)
    state = tc["state"]
    rng = np.random.default_rng(5)
    kw = dict(n_state=n, n_heads=h, head_dim=hd)
    tol = F32 if dtype == "float32" else BF16_ENVELOPE
    for _ in range(3):
        x = rng.normal(size=(2, d)).astype(np.float32)
        y, out = TS.ssm_decode(tp, torch.from_numpy(x).to(getattr(torch,
                                                                  dtype)),
                               tc, **kw)
        jy, jc = JS.ssm_decode(jp, jnp.asarray(x).astype(getattr(jnp, dtype)),
                               jc, **kw)
        assert out is tc and tc["state"] is state
        np.testing.assert_allclose(_f32(y), _f32(jy), **tol)
        for name in ("state", "conv_x", "conv_B", "conv_C"):
            assert str(tc[name].dtype).split(".")[1] == str(jc[name].dtype)
            np.testing.assert_allclose(_f32(tc[name]), _f32(jc[name]), **tol)
    assert int(jc["length"]) == 3


def test_ssm_decode_matches_ssm_apply():
    """Decoding a sequence token by token from a zeroed float32 cache gives
    the full-sequence block's output at every position."""
    d, di, n, h, hd, k = DIMS
    tp, _ = _block_params(seed=6)
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, 21, d)).astype(np.float32))
    full = TS.ssm_apply(tp, x, n_state=n, n_heads=h, head_dim=hd, d_conv=k,
                        chunk=8)
    cache = TS.ssm_cache(2, h, hd, n, k, di, dtype=torch.float32)
    steps = [TS.ssm_decode(tp, x[:, t], cache, n_state=n, n_heads=h,
                           head_dim=hd)[0] for t in range(21)]
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(),
                               **F32)


def test_ssm_cache_matches_reference():
    t = TS.ssm_cache(3, 8, 32, 16, 4, 256, n_layers=2)
    j = JS.ssm_cache(3, 8, 32, 16, 4, 256)
    for name in ("state", "conv_x", "conv_B", "conv_C"):
        assert tuple(t[name].shape) == (2,) + j[name].shape
        assert str(t[name].dtype).split(".")[1] == str(j[name].dtype)
        assert not t[name].any()
