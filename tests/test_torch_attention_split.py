"""B7's split of float32 probabilities into three bf16 parts
(`ref.split_bf16x3`): the plain statement of what the kernel's bf16 body
feeds its P V products on the tensor cores.  Each part is a bf16 value,
the three add up to p bit for bit, and attention through the parts stays
within the plain version's tolerance of the float32 attention, the JAX
package's ``mha_ref`` included.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import ref as JR
from repro_torch.kernels import ref

# The plain version's tolerance against the reference (tests/test_torch_lm.py).
ATTN = dict(atol=2e-6, rtol=1e-5)


def probabilities(rng: np.random.Generator, n: int) -> np.ndarray:
    """n float32 values in [2^-100, 1]: exponents uniform in [-100, -1]
    with random 23-bit mantissas, and 1.0 itself at every eighth place."""
    e = rng.integers(-100, 0, n)
    mant = rng.integers(0, 1 << 23, n)
    p = np.ldexp(1.0 + mant / float(1 << 23), e).astype(np.float32)
    p[::8] = 1.0
    return p


def assert_exact_split(p: torch.Tensor) -> None:
    parts = ref.split_bf16x3(p)
    for part in parts:
        assert part.dtype == torch.bfloat16
        # A bf16 value is a float32 whose low 16 bits are zero.
        low = part.float().view(torch.int32) & 0xFFFF
        assert not bool(low.any())
    hi, mid, lo = (t.float() for t in parts)
    total = (hi + mid) + lo
    assert torch.equal(total.view(torch.int32), p.view(torch.int32))
    # Each part is at most half an ulp of bf16 of the one before it.
    assert bool((mid.abs() <= hi.abs() * 2.0 ** -8).all())
    assert bool((lo.abs() <= mid.abs() * 2.0 ** -8).all())


@settings(deadline=None, max_examples=40)
@given(seed=st.integers(0, 2 ** 32 - 1), n=st.integers(1, 5000))
def test_split_is_exact_on_drawn_probabilities(seed, n):
    p = torch.from_numpy(probabilities(np.random.default_rng(seed), n))
    assert_exact_split(p)


def test_split_is_exact_at_the_edges():
    """The range's ends, bf16 rounding ties and the largest float32 below
    1 (whose hi rounds up to 1)."""
    edges = [2.0 ** -100, 2.0 ** -100 * (1 + 2.0 ** -23), 1.0,
             1 - 2.0 ** -24, 0.5 + 2.0 ** -9, 0.5 + 3 * 2.0 ** -9,
             1 - 2.0 ** -9, 1 - 2.0 ** -17, 2.0 ** -50 * (1 + 2.0 ** -8),
             math.exp(-1.0), math.exp(-20.0), 1 / 3]
    p = torch.tensor(edges, dtype=torch.float32)
    assert_exact_split(p)
    hi, _, _ = ref.split_bf16x3(p)
    assert float(hi[3]) == 1.0


@pytest.mark.parametrize("seed", range(6))
def test_split_is_exact_on_softmax_rows(seed):
    """The kernel's p: exp(s - m) of scores in float32, 1.0 at each row's
    max, the rest in (0, 1)."""
    rng = np.random.default_rng(seed)
    s = torch.from_numpy((rng.normal(size=(64, 256)) * 8).astype(np.float32))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p[p >= 2.0 ** -100]
    assert_exact_split(p)


@pytest.mark.parametrize("m,k,n", [(64, 64, 120), (17, 300, 64),
                                   (128, 16, 256)])
def test_three_part_product_is_the_float32_product(m, k, n):
    """P V through the three parts with float32 sums, against P V in
    float64 and in float32, for bf16 V."""
    rng = np.random.default_rng(m * k + n)
    s = rng.normal(size=(m, k)).astype(np.float32) * 4
    p = torch.from_numpy(np.exp(s - s.max(-1, keepdims=True)))
    v = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)).to(
        torch.bfloat16).float()
    parts = sum(t.float() @ v for t in reversed(ref.split_bf16x3(p)))
    exact = (p.double() @ v.double()).float()
    torch.testing.assert_close(parts, exact, **ATTN)
    torch.testing.assert_close(parts, p @ v, **ATTN)


def attention_via_parts(q, k, v, *, causal, window):
    """B7's bf16 body in plain float32 tensor operations: scores, masks,
    p = exp(s - m), P V as the three parts' products, / max(l, 1e-30)."""
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    kk = k.repeat_interleave(hq // hkv, 1).float()
    vv = v.repeat_interleave(hq // hkv, 1).float()
    s = q.float() @ kk.transpose(-1, -2) * (1.0 / math.sqrt(dh))
    qpos = torch.arange(sq)[:, None]
    kpos = torch.arange(sk)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= qpos - kpos < window
    s = torch.where(mask, s, ref.NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = sum(t.float() @ vv for t in reversed(ref.split_bf16x3(p)))
    return o / p.sum(-1, keepdim=True).clamp_min(1e-30)


@pytest.mark.parametrize("group,causal,window,s,dh", [
    (1, True, None, 64, 32), (4, True, 50, 200, 120), (2, False, None, 130, 64),
    (8, True, 16, 100, 36), (1, False, 40, 90, 256)])
def test_attention_through_the_parts(group, causal, window, s, dh):
    """On bf16-exact inputs, attention through the three parts against the
    port's float32 plain version and the JAX package's ``mha_ref``."""
    hkv = 8 // group if group < 8 else 1
    rng = np.random.default_rng(s + dh + group)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, h, s, dh)).astype(
        np.float32)).to(torch.bfloat16).float() for h in (hkv * group, hkv,
                                                          hkv))
    out = attention_via_parts(q, k, v, causal=causal, window=window)
    plain = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out, plain, **ATTN)
    want = np.asarray(JR.mha_ref(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                 causal=causal, window=window))
    np.testing.assert_allclose(out.numpy(), want, **ATTN)
