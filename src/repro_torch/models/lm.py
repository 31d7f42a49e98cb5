"""Decoder-only LM: parameters, forward and prefill.

The port of the JAX package's ``models/lm.py`` for the families whose
blocks are all ``_dense_block``: ``dense`` and ``audio`` (musicgen's
embedding-frontend stub).  The other families raise, naming the slice that
brings them.  Parameters are a tree of nested dicts of tensors, as the
reference's, except that ``blocks`` is a list of one dict per layer where
the reference stacks them along a leading layer axis (`init` draws them
stacked and unstacks; `io.convert.lm_params_from_arrays` unstacks the
reference's).  `TransformerLM` holds such a tree as an ``nn.Module``.

``cfg.use_pallas`` is kept with the reference's default, so that configs
compare equal, but nothing branches on it: every attention layer runs B7
(`kernels.flash_attention`), whose device picks the kernel or its plain
version.  ``attn_chunk``, ``causal_skip``, ``remat`` and ``scan_layers``
shape the reference's compiled graph and have no counterpart here.
Forward and prefill run under ``torch.inference_mode()``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from repro_torch.models import layers as Ly
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamDecl, init_params, stack

FAMILIES = ("dense", "audio")
_LATER = {"moe": "the MoE slice", "ssm": "the SSM slice",
          "hybrid": "the SSM slice (Mamba2 blocks + shared attention)",
          "vlm": "the VLM slice (cross-attention)"}


def check_family(cfg: ModelConfig) -> None:
    """Raise for a family (or an MoE block) this slice does not run."""
    family = "moe" if cfg.n_experts else cfg.family
    if family not in FAMILIES:
        raise ValueError(f"family {family!r} is not ported yet: it comes "
                         f"with {_LATER.get(family, 'a later slice')} of "
                         f"repro_torch")


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# Parameter declarations
# ---------------------------------------------------------------------------

def _block_decls(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    return {
        "ln1": ParamDecl((d,), (None,), init="ones"),
        "attn": Ly.attention_decls(d, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.head_dim_),
        "ln2": ParamDecl((d,), (None,), init="ones"),
        "mlp": Ly.mlp_decls(d, cfg.d_ff, cfg.act),
    }


def param_decls(cfg: ModelConfig) -> Dict[str, Any]:
    check_family(cfg)
    d, v = cfg.d_model, cfg.padded_vocab
    decls: Dict[str, Any] = {
        "embed": ParamDecl((v, d), ("tp", "fsdp"), init="small_normal"),
        "blocks": stack(_block_decls(cfg), cfg.n_layers),
        "final_norm": ParamDecl((d,), (None,), init="ones"),
    }
    if not cfg.tie_embeddings:
        decls["lm_head"] = ParamDecl((v, d), ("tp", "fsdp"),
                                     init="small_normal")
    return decls


def unstack(tree, n: int) -> List[Any]:
    """A tree of (n, ...) tensors -> a list of n trees of (...) views."""
    if isinstance(tree, torch.Tensor):
        if tree.dim() == 0 or tree.shape[0] != n:
            raise ValueError(f"expected {n} stacked layers, got shape "
                             f"{tuple(tree.shape)}")
        return list(tree.unbind(0))
    per_key = {k: unstack(v, n) for k, v in tree.items()}
    return [{k: v[i] for k, v in per_key.items()} for i in range(n)]


def init(cfg: ModelConfig, generator: torch.Generator, device=None):
    """Random parameters (`params.init_params`) in the model dtype, norm
    weights in float32, blocks unstacked per layer; on CUDA unless
    ``device`` names another device, drawn from ``generator`` on it."""
    params = init_params(param_decls(cfg), generator, model_dtype(cfg),
                         device)
    params["blocks"] = unstack(params["blocks"], cfg.n_layers)
    return params


# ---------------------------------------------------------------------------
# Blocks and forward
# ---------------------------------------------------------------------------

def _dense_block(bp, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = Ly.rms_norm(x, bp["ln1"], cfg.norm_eps)
    h = Ly.attention_apply(bp["attn"], h, n_heads=cfg.n_heads,
                           n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim_,
                           rope_theta=cfg.rope_theta, window=cfg.window)
    x = x + h
    h = Ly.rms_norm(x, bp["ln2"], cfg.norm_eps)
    return x + Ly.mlp_apply(bp["mlp"], h, act=cfg.act)


def embed_tokens(params, cfg: ModelConfig, inputs) -> torch.Tensor:
    """Token ids (B, S) -> embeddings, or, with ``embed_inputs``, the given
    (B, S, d_model) embeddings cast to the model dtype; then times
    ``sqrt(d_model)`` rounded to that dtype when ``embed_scale``."""
    embed = params["embed"]
    inputs = torch.as_tensor(inputs, device=embed.device)
    if cfg.embed_inputs:
        x = inputs.to(model_dtype(cfg))
    else:
        x = embed[inputs.long()]
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def logits_from_hidden(params, cfg: ModelConfig,
                       x: torch.Tensor) -> torch.Tensor:
    """Final norm, then the head product in the model dtype, then float32,
    then the tanh soft cap when set: float32 logits over ``padded_vocab``."""
    x = Ly.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    logits = (x @ head.t()).float()
    if cfg.logit_softcap:
        cap = cfg.logit_softcap
        logits = cap * torch.tanh(logits / cap)
    return logits


def _hidden(params, cfg: ModelConfig, batch: Dict[str, Any]) -> torch.Tensor:
    check_family(cfg)
    x = embed_tokens(params, cfg, batch["inputs"])
    for bp in params["blocks"]:
        x = _dense_block(bp, x, cfg)
    return x


@torch.inference_mode()
def forward(params, cfg: ModelConfig, batch: Dict[str, Any]) -> torch.Tensor:
    """Full-sequence forward -> float32 logits (B, S, padded_vocab)."""
    return logits_from_hidden(params, cfg, _hidden(params, cfg, batch))


@torch.inference_mode()
def prefill(params, cfg: ModelConfig, batch: Dict[str, Any]) -> torch.Tensor:
    """Prefill = the forward's last-position logits (B, padded_vocab).  The
    head is applied to that position alone (the reference computes every
    position's logits, then keeps the last)."""
    return logits_from_hidden(params, cfg,
                              _hidden(params, cfg, batch)[:, -1])


def vocab_mask(cfg: ModelConfig, device=None) -> Optional[torch.Tensor]:
    """0 on real tokens and -1e30 on the padding of ``padded_vocab``, or
    None when there is no padding."""
    if cfg.padded_vocab == cfg.vocab_size:
        return None
    ids = torch.arange(cfg.padded_vocab, device=device)
    return torch.where(ids < cfg.vocab_size, 0.0, -1e30)


# ---------------------------------------------------------------------------
# nn.Module
# ---------------------------------------------------------------------------

def _flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    out: Dict[str, torch.Tensor] = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _unflatten(flat: Dict[str, torch.Tensor]):
    tree: Dict[str, Any] = {}
    for name, t in flat.items():
        node = tree
        *path, leaf = name.split("/")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t
    blocks = tree["blocks"]
    tree["blocks"] = [blocks[str(i)] for i in range(len(blocks))]
    return tree


class TransformerLM(nn.Module):
    """``cfg`` and its parameter tree as an ``nn.Module``: the leaves are
    parameters without gradients under ``/``-joined names
    (``blocks/3/attn/wq``), so ``.to(device)`` and ``state_dict`` work as
    usual.  `random` builds one from a ``torch.Generator``."""

    def __init__(self, cfg: ModelConfig, params):
        super().__init__()
        check_family(cfg)
        self.cfg = cfg
        self.weights = nn.ParameterDict({
            k: nn.Parameter(v, requires_grad=False)
            for k, v in _flatten(params).items()})

    @classmethod
    def random(cls, cfg: ModelConfig, generator: torch.Generator,
               device=None) -> "TransformerLM":
        return cls(cfg, init(cfg, generator, device))

    @property
    def params(self):
        return _unflatten(dict(self.weights.items()))

    def forward(self, batch: Dict[str, Any]) -> torch.Tensor:
        return forward(self.params, self.cfg, batch)

    def prefill(self, batch: Dict[str, Any]) -> torch.Tensor:
        return prefill(self.params, self.cfg, batch)
