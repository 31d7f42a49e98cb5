"""Model configuration for the architecture pool.

A copy of the JAX package's ``models/config.py`` (it imports nothing of JAX),
so that the port's configs compare field by field with the reference's.  One
frozen dataclass drives every family: dense / MoE / SSM (Mamba2-SSD) /
hybrid (Mamba2 + shared attention) / audio (token-decoder with embedding
frontend stub) / VLM (periodic cross-attention).  `repro_torch.configs.<arch>`
files instantiate these with the exact published hyperparameters.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

VOCAB_PAD_MULTIPLE = 256  # TP divisibility (DESIGN.md §4)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"           # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0               # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    act: str = "swiglu"             # swiglu | geglu | gelu
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = True
    logit_softcap: float = 0.0      # gemma-style tanh soft cap (0 = off)
    embed_scale: bool = False       # multiply embeddings by sqrt(d_model) (gemma)

    # Attention variants ----------------------------------------------------
    window: Optional[int] = None    # sliding-window attention (h2o-danube-3)
    swa_every: int = 1              # 1 = every layer uses `window` (if set)

    # MoE (grok-1, phi-3.5-moe) ---------------------------------------------
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 2.0
    router_group: int = 1024        # group-wise dispatch to bound einsum cost
    moe_shard: str = "ep"           # ep: experts over model axis | tp: inside
    dispatch_mode: str = "einsum"   # einsum (GShard baseline) | gather (§Perf)

    # SSM / hybrid (mamba2, zamba2) ------------------------------------------
    ssm_state: int = 0              # N (d_state); 0 = no SSM layers
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 128
    ssm_conv: int = 4
    attn_every: int = 0             # hybrid: shared attn block every k layers

    # VLM (llama-3.2-vision) --------------------------------------------------
    cross_attn_every: int = 0       # cross-attention block every k layers
    n_image_tokens: int = 1024      # stub frontend: precomputed patch embeds

    # Audio (musicgen) ---------------------------------------------------------
    embed_inputs: bool = False      # frontend stub: inputs are embeddings

    # Numerics / execution -----------------------------------------------------
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "nothing"   # nothing | dots — what survives remat
    tp_strategy: str = "tp"         # tp | dp_only (small archs: batch over
                                    # "model", params replicated — §Perf)
    scan_layers: bool = True
    microbatches: int = 1           # python-unrolled gradient accumulation
    seq_shard_residuals: bool = True
    attn_chunk: int = 2048          # online-softmax chunk (q and kv)
    causal_skip: bool = True        # skip fully-masked kv chunks (beyond-paper)
    use_pallas: bool = False        # Pallas attention kernels (TPU target path)

    # -- derived -------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = VOCAB_PAD_MULTIPLE
        return (self.vocab_size + m - 1) // m * m

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def is_subquadratic(self) -> bool:
        """Eligible for the long_500k decode shape (DESIGN.md §4)."""
        return self.family in ("ssm", "hybrid") or self.window is not None

    @property
    def has_attention_scan(self) -> bool:
        return self.family in ("dense", "moe", "audio", "vlm")

    def n_params(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D)."""
        d, f, v = self.d_model, self.d_ff, self.padded_vocab
        hd = self.head_dim_
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        glu = self.act in ("swiglu", "geglu")
        mlp = d * f * (3 if glu else 2)
        per_layer = 0
        if self.family in ("dense", "moe", "audio", "vlm"):
            per_layer = attn + (mlp * self.n_experts if self.n_experts
                                else mlp) + (d * self.n_experts if self.n_experts else 0)
        elif self.family in ("ssm", "hybrid"):
            di, n, g = self.d_inner, self.ssm_state, 1
            in_proj = d * (2 * di + 2 * g * n + self.ssm_nheads)
            per_layer = in_proj + di * d + self.ssm_conv * (di + 2 * g * n)
        total = self.n_layers * per_layer
        if self.family == "hybrid" and self.attn_every:
            total += attn + mlp                      # one shared block
        if self.family == "vlm" and self.cross_attn_every:
            n_cross = self.n_layers // self.cross_attn_every
            total += n_cross * (attn + mlp)
        total += v * d * (1 if self.tie_embeddings else 2)
        total += self.n_layers * 2 * d + d          # norms
        return total

    def active_params(self) -> int:
        """MoE: params touched per token (top-k experts)."""
        if not self.n_experts:
            return self.n_params()
        d, f = self.d_model, self.d_ff
        glu = self.act in ("swiglu", "geglu")
        mlp = d * f * (3 if glu else 2)
        dense_like = self.n_params() - self.n_layers * mlp * self.n_experts
        return dense_like + self.n_layers * mlp * self.top_k


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned (arch x input-shape) dry-run cell."""
    name: str                       # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


LM_SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeCell:
    for s in LM_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)
