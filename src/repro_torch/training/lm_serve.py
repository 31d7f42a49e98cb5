"""LM serving: the decode step over a KV cache, and the prefill step.

The port of the JAX package's ``training/lm_serve.py``.  A caller makes a
cache with ``lm.init_cache(cfg, batch, scfg.max_seq_len)`` and feeds one
token per sequence through ``make_serve_step``: a prompt token by token
(the reference's prefill fills no cache either), then each sampled token.
Nothing of the forest serving path (`serve_lib`) imports this module.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_seq_len: int = 2048            # the cache's size: lm.init_cache's s_max
    temperature: float = 0.0           # 0 = greedy


def _slot_errors(cfg: ModelConfig, scfg: ServeConfig,
                 cache: Dict[str, Any]) -> List[str]:
    """Where a cache's attention slots are not what ``lm.init_cache(cfg,
    batch, scfg.max_seq_len)`` makes: the layers' (``min(max_seq_len,
    window)`` with a window), each hybrid shared-attention site's
    (``max_seq_len``: no window) and a VLM's image cache
    (``n_image_tokens``).  An SSM layer's cache has no slots."""
    n = scfg.max_seq_len
    want = min(n, cfg.window) if cfg.window is not None else n
    why = f"max_seq_len {n} makes"
    found = []
    if "k" in cache["layers"]:
        found.append(("the layers' cache", cache["layers"]["k"].shape[2],
                      why, want))
    found += [(f"shared-attention site {i}'s cache", site["k"].shape[1],
               why, n) for i, site in enumerate(cache.get("shared_attn", []))]
    if "image_kv" in cache:
        found.append(("the image cache", cache["image_kv"]["k"].shape[2],
                      "n_image_tokens is", cfg.n_image_tokens))
    return [f"{what} holds {got} slots where {rule} {exp}"
            for what, got, rule, exp in found if got != exp]


def make_serve_step(cfg: ModelConfig, scfg: ServeConfig) -> Callable:
    """``serve_step(params, cache, token, generator=None, gumbel=None) ->
    (next_token, cache)``: one `lm.decode_step` (the cache updated in
    place), the vocab mask added, then the greedy argmax at temperature 0,
    else ``argmax(logits / T + g)`` with Gumbel noise g (B, padded_vocab):
    ``gumbel`` when given, else drawn from ``generator``, which must then
    be given and lie on the logits' device.  That is the reference's
    ``jax.random.categorical``, with its noise injected.  ``next_token`` is
    int32 (B,) on the parameters' device.  The cache must be one that
    ``lm.init_cache(cfg, batch, scfg.max_seq_len)`` makes: a cache whose
    attention caches (a layer's, a hybrid site's, the image cache) hold
    another number of slots raises; an SSM cache has none to check."""

    def serve_step(params, cache: Dict[str, Any], token,
                   generator: Optional[torch.Generator] = None,
                   gumbel=None):
        errors = _slot_errors(cfg, scfg, cache)
        if errors:
            raise ValueError("; ".join(errors) + ": make it with "
                             "lm.init_cache(cfg, batch, scfg.max_seq_len)")
        logits, cache = lm.decode_step(params, cfg, cache, token)
        mask = lm.vocab_mask(cfg, logits.device)
        if mask is not None:
            logits = logits + mask
        if scfg.temperature > 0:
            if gumbel is None:
                if generator is None:
                    raise ValueError("sampling at temperature > 0 needs a "
                                     "generator or injected gumbel noise")
                u = torch.empty_like(logits).exponential_(generator=generator)
                gumbel = -torch.log(u)
            gumbel = torch.as_tensor(gumbel, dtype=torch.float32,
                                     device=logits.device)
            logits = logits / scfg.temperature + gumbel
        return logits.argmax(-1).to(torch.int32), cache

    return serve_step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """``prefill_step(params, batch) -> (B, padded_vocab)`` float32 logits
    of each sequence's last position, on the parameters' device.
    ``batch["inputs"]`` is (B, S) token ids, or (B, S, d_model) embeddings
    with ``cfg.embed_inputs``, as numpy arrays or tensors; a VLM's
    ``batch["image_embeds"]`` (B, n_image_tokens, d_model) goes with it."""

    def prefill_step(params, batch: Dict[str, Any]) -> torch.Tensor:
        return lm.prefill(params, cfg, batch)

    return prefill_step
