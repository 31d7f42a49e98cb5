"""Mamba2 (SSD, state-space duality) blocks: the chunked full-sequence path
and the one-token decode over a constant-size state.

The port of the JAX package's ``models/ssm.py`` (Dao & Gu,
arXiv:2405.21060).  The sequence is cut into chunks of ``q = min(chunk,
s)`` tokens (halved until q divides s); within a chunk the output is a
masked, attention-like product, and each chunk's final state passes to the
next.  The reference's precision policy is kept: x, B, C and the (q, q)
decay mask in the model dtype; dt, the cumulative decays and every
accumulation in float32 (its ``preferred_element_type=float32`` products
are float32 products of the model-dtype values here).

The reference passes the chunk states on by a log-depth
``jax.lax.associative_scan`` over (decay, state) pairs; the port computes
every chunk's entering state at once, as one batched product of the chunk
states with the lower-triangular matrix of decays between chunks,
``exp(segsum(total))`` (the minimal SSD of the paper), so its float32
states differ from the reference's by rounding only (held to 1e-4 in
``tests/test_torch_ssm.py``).  Decode is the recurrence itself, ``h <-
exp(dt A) h + dt x B^T``, with the state and the convolution buffers of the
cache updated in place.  No Pallas kernel is involved in the reference, and
none here: plain PyTorch, projections by ``torch.matmul``.

On a mesh (``ctx`` with a model axis of more than one rank) ``d_inner`` is
split over ``model``: ``wz``, ``wx``, ``conv_x``, ``norm`` and ``wo`` are
this rank's blocks, which hold whole SSD heads, and the replicated
``wB``, ``wC``, ``wdt``, ``conv_B``, ``conv_C``, ``A_log``, ``D`` and
``dt_bias`` enter through `collectives.copy_to` (each rank's gradient of
them is its heads' part); each rank runs the scan on its heads, the gated
RMSNorm sums its squares over the axis, and ``wo``'s products are summed.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as C
from repro_torch.models.layers import AxisCtx, rms_norm
from repro_torch.models.params import ParamDecl


def ssm_decls(d_model: int, d_inner: int, n_state: int, n_heads: int,
              d_conv: int) -> Dict[str, ParamDecl]:
    return {
        "wz": ParamDecl((d_model, d_inner), ("fsdp", "tp")),
        "wx": ParamDecl((d_model, d_inner), ("fsdp", "tp")),
        "wB": ParamDecl((d_model, n_state), ("fsdp", None)),
        "wC": ParamDecl((d_model, n_state), ("fsdp", None)),
        "wdt": ParamDecl((d_model, n_heads), ("fsdp", None)),
        "conv_x": ParamDecl((d_conv, d_inner), (None, "tp"),
                            init="small_normal"),
        "conv_B": ParamDecl((d_conv, n_state), (None, None),
                            init="small_normal"),
        "conv_C": ParamDecl((d_conv, n_state), (None, None),
                            init="small_normal"),
        "A_log": ParamDecl((n_heads,), (None,), init="zeros"),
        "D": ParamDecl((n_heads,), (None,), init="ones"),
        "dt_bias": ParamDecl((n_heads,), (None,), init="zeros"),
        "norm": ParamDecl((d_inner,), ("tp",), init="ones"),
        "wo": ParamDecl((d_inner, d_model), ("tp", "fsdp")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution of x (B, S, C) with taps w (K, C):
    the K taps added in order in float32, cast back to x's dtype."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + xp[:, i:i + s].float() * w[i].float()
    return out.to(x.dtype)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): ``out[i, j] = a[j+1] + ... + a[i]`` for j <=
    i (0 on the diagonal), -inf above it.  Each entry is its own sum, not a
    difference of two running sums, so it keeps its precision far along
    the sequence."""
    t = a.shape[-1]
    ones = torch.ones(t, t, dtype=torch.bool, device=a.device)
    x = a[..., :, None].expand(*a.shape, t).masked_fill(~ones.tril(-1), 0.0)
    return torch.cumsum(x, dim=-2).masked_fill(~ones.tril(), float("-inf"))


def _ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, chunk: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan.  x: (B, S, H, P); dt: (B, S, H); A: (H,) (negative); Bm,
    Cm: (B, S, N) (one group).  Returns (y (B, S, H, P) in x's dtype, the
    final state (B, H, P, N) float32)."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    q = min(chunk, s)
    while s % q:
        q //= 2
    nc = s // q
    lowp = x.dtype
    xr = x.reshape(b, nc, q, h, p)
    dtr = dt.reshape(b, nc, q, h).float()
    Br = Bm.reshape(b, nc, q, n).to(lowp)
    Cr = Cm.reshape(b, nc, q, n).to(lowp)

    cum = torch.cumsum(dtr * A, dim=2)                    # (b, c, q, h)
    total = cum[:, :, -1]                                 # (b, c, h)

    # Within a chunk: y_i = sum_{j <= i} exp(cum_i - cum_j) (C_i . B_j)
    # dt_j x_j, the mask in the model dtype, the products in float32.
    CB = Cr.float() @ Br.float().transpose(-1, -2)        # (b, c, i, j)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (b, c, i, j, h)
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    # exp of the masked (upper) entries is taken at -inf, not at their
    # positive seg, so that neither it nor its gradient overflows.
    seg = seg.masked_fill(~causal[:, :, None], float("-inf"))
    L = torch.where(causal[:, :, None], torch.exp(seg) * CB[..., None],
                    0.0).to(lowp)
    del seg
    dtx = (xr.float() * dtr[..., None]).to(lowp)          # (b, c, j, h, p)
    y = (L.permute(0, 1, 4, 2, 3).float()
         @ dtx.permute(0, 1, 3, 2, 4).float())            # (b, c, h, i, p)
    y = y.permute(0, 1, 3, 2, 4)                          # (b, c, i, h, p)
    del L, dtx

    # Each chunk's final state from its own tokens.
    decay_to_end = torch.exp(total[:, :, None, :] - cum)  # (b, c, q, h)
    w = (dtr * decay_to_end).to(lowp).float()
    xw = (xr.float() * w[..., None]).reshape(b, nc, q, h * p)
    states = (xw.transpose(-1, -2) @ Br.float()).reshape(b, nc, h, p, n)

    # The state entering chunk z (z = 0 .. nc; z = nc is the final state):
    # sum over c < z of exp(total_{c+1} + ... + total_{z-1}) states_c, one
    # product over every chunk.
    decay = torch.exp(_segsum(F.pad(total.transpose(1, 2), (1, 0))))
    entering = decay[..., 1:] @ states.permute(0, 2, 1, 3, 4).reshape(
        b, h, nc, p * n)                                  # (b, h, z, p*n)
    entering = entering.reshape(b, h, nc + 1, p, n).transpose(1, 2)
    prev, h_final = entering[:, :-1], entering[:, -1]

    # Across chunks: y_i += exp(cum_i) C_i . state entering the chunk.
    cprev = (prev.to(lowp).float().reshape(b, nc, h * p, n)
             @ Cr.float().transpose(-1, -2))              # (b, c, h*p, i)
    ecum = torch.exp(cum).to(lowp).float()                # (b, c, i, h)
    y = y + (cprev.reshape(b, nc, h, p, q).permute(0, 1, 4, 2, 3)
             * ecum[..., None])
    return y.reshape(b, s, h, p).to(x.dtype), h_final


REPLICATED = ("wB", "wC", "wdt", "conv_B", "conv_C", "A_log", "D",
              "dt_bias")


def ssm_apply(p, x: torch.Tensor, *, n_state: int, n_heads: int,
              head_dim: int, d_conv: int, chunk: int,
              ctx=None) -> torch.Tensor:
    """Full-sequence Mamba2 block.  x: (B, S, D) -> (B, S, D).  With
    ``ctx`` and ``p`` holding a block of ``d_inner``, this rank's heads
    (see the module docstring)."""
    b, s, _ = x.shape
    split = (ctx is not None and ctx.tp > 1
             and p["wz"].shape[1] < n_heads * head_dim)
    tp = ctx.tp if split else 1
    if n_heads % tp:
        raise ValueError(f"{n_heads} SSD heads do not split over {tp} "
                         f"model ranks")
    # Without a split the copies, the norm's sum and wo's sum are
    # identities, and this rank's heads are all of them.
    sctx = ctx if split else AxisCtx()
    hl = n_heads // tp
    h0 = sctx.tp_rank * hl
    x = sctx.copy(x)
    p = dict(p, **{k: sctx.copy(p[k]) for k in REPLICATED})
    z = x @ p["wz"]
    xi = x @ p["wx"]
    Bm = x @ p["wB"]
    Cm = x @ p["wC"]
    dt = F.softplus(x.float() @ p["wdt"][:, h0:h0 + hl].float()
                    + p["dt_bias"][h0:h0 + hl])
    xi = F.silu(_causal_conv(xi, p["conv_x"]).float()).to(x.dtype)
    Bm = F.silu(_causal_conv(Bm, p["conv_B"]).float()).to(x.dtype)
    Cm = F.silu(_causal_conv(Cm, p["conv_C"]).float()).to(x.dtype)
    A = -torch.exp(p["A_log"][h0:h0 + hl].float())
    xh = xi.reshape(b, s, hl, head_dim)
    y, _ = _ssd_chunked(xh, dt, A, Bm, Cm, chunk)
    # The skip term is float32, and so is y from here on (the reference's
    # promotion of a model-dtype y plus a float32 term).
    y = y.float() + p["D"][h0:h0 + hl].float()[None, None, :, None] \
        * xh.float()
    y = y.reshape(b, s, hl * head_dim) * F.silu(z.float())
    # The gated RMSNorm over the whole d_inner: each rank's mean square of
    # its equal block, averaged over the ranks (`layers.rms_norm` at tp 1).
    var = C.psum_both(y.square().mean(-1, keepdim=True), sctx.mesh,
                      sctx.model_axis) / tp
    y = (y * torch.rsqrt(var + 1e-5) * p["norm"]).to(x.dtype)
    return sctx.reduce(y @ p["wo"])


def ssm_cache(b: int, n_heads: int, head_dim: int, n_state: int,
              d_conv: int, d_inner: int, dtype=torch.bfloat16, device=None,
              n_layers: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """A zeroed decode cache: ``state`` (b, H, P, N) float32 and the last
    ``d_conv - 1`` inputs of each convolution in ``dtype``, with a leading
    ``n_layers`` axis when given.  Its ``length`` is the LM cache's one
    host int (`lm.init_cache`)."""
    lead = () if n_layers is None else (n_layers,)

    def zeros(*shape, dt=dtype):
        return torch.zeros(lead + shape, dtype=dt, device=device)
    return {"state": zeros(b, n_heads, head_dim, n_state, dt=torch.float32),
            "conv_x": zeros(b, d_conv - 1, d_inner),
            "conv_B": zeros(b, d_conv - 1, n_state),
            "conv_C": zeros(b, d_conv - 1, n_state)}


def _conv_step(buf: torch.Tensor, new: torch.Tensor, w: torch.Tensor):
    """One causal-convolution step: buf (B, K-1, C) past inputs, new (B, C)
    -> (float32 output (B, C), the window's last K-1 inputs in float32)."""
    window = torch.cat([buf.float(), new.float()[:, None]], dim=1)
    return (window * w.float()).sum(1), window[:, 1:]


def ssm_decode(p, x: torch.Tensor, cache, *, n_state: int, n_heads: int,
               head_dim: int):
    """One-token decode.  x: (B, D); ``cache`` one layer's `ssm_cache`,
    updated in place: returns ``(y (B, D), cache)`` with the same dict."""
    b = x.shape[0]
    z = x @ p["wz"]
    xi, conv_x = _conv_step(cache["conv_x"], x @ p["wx"], p["conv_x"])
    Bm, conv_B = _conv_step(cache["conv_B"], x @ p["wB"], p["conv_B"])
    Cm, conv_C = _conv_step(cache["conv_C"], x @ p["wC"], p["conv_C"])
    xi, Bm, Cm = F.silu(xi), F.silu(Bm), F.silu(Cm)
    dt = F.softplus(x.float() @ p["wdt"].float() + p["dt_bias"])  # (B, H)
    A = -torch.exp(p["A_log"].float())
    xh = xi.reshape(b, n_heads, head_dim)
    dA = torch.exp(dt * A[None, :])
    h_new = (cache["state"] * dA[..., None, None]
             + (dt[..., None] * xh)[..., None] * Bm[:, None, None, :])
    y = (h_new * Cm[:, None, None, :]).sum(-1) \
        + p["D"].float()[None, :, None] * xh
    y = rms_norm(y.reshape(b, n_heads * head_dim) * F.silu(z.float()),
                 p["norm"])
    cache["state"].copy_(h_new)
    cache["conv_x"].copy_(conv_x)
    cache["conv_B"].copy_(conv_B)
    cache["conv_C"].copy_(conv_C)
    return y.to(x.dtype) @ p["wo"], cache


def ssd_reference(x, dt, A, Bm, Cm):
    """The plain recurrence over time, for tests: (y (B, S, H, P), final
    state (B, H, P, N)), in float32."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    x, dt, Bm, Cm = x.float(), dt.float(), Bm.float(), Cm.float()
    state = torch.zeros(b, h, p, n, dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        dA = torch.exp(dt[:, t] * A[None, :])
        state = (state * dA[..., None, None]
                 + (dt[:, t, :, None] * x[:, t])[..., None]
                 * Bm[:, t, None, None, :])
        ys.append((state * Cm[:, t, None, None, :]).sum(-1))
    return torch.stack(ys, dim=1), state
