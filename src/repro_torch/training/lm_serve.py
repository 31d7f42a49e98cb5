"""LM serving: the decode step over a KV cache, and the prefill step.

The port of the JAX package's ``training/lm_serve.py``.  A caller makes a
cache with ``lm.init_cache(cfg, batch, scfg.max_seq_len)`` and feeds one
token per sequence through ``make_serve_step``: a prompt token by token
(the reference's prefill fills no cache either), then each sampled token.
Nothing of the forest serving path (`serve_lib`) imports this module.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_seq_len: int = 2048            # the cache's size: lm.init_cache's s_max
    temperature: float = 0.0           # 0 = greedy


def make_serve_step(cfg: ModelConfig, scfg: ServeConfig) -> Callable:
    """``serve_step(params, cache, token, generator=None, gumbel=None) ->
    (next_token, cache)``: one `lm.decode_step` (the cache updated in
    place), the vocab mask added, then the greedy argmax at temperature 0,
    else ``argmax(logits / T + g)`` with Gumbel noise g (B, padded_vocab):
    ``gumbel`` when given, else drawn from ``generator``, which must then
    be given and lie on the logits' device.  That is the reference's
    ``jax.random.categorical``, with its noise injected.  ``next_token`` is
    int32 (B,) on the parameters' device.  The cache must be one that
    ``lm.init_cache(cfg, batch, scfg.max_seq_len)`` makes: a cache of
    another size raises."""
    lm.check_family(cfg)
    s_alloc = (min(scfg.max_seq_len, cfg.window) if cfg.window is not None
               else scfg.max_seq_len)

    def serve_step(params, cache: Dict[str, Any], token,
                   generator: Optional[torch.Generator] = None,
                   gumbel=None):
        slots = cache["layers"]["k"].shape[2]
        if slots != s_alloc:
            raise ValueError(
                f"the cache holds {slots} slots, but max_seq_len "
                f"{scfg.max_seq_len} makes {s_alloc}: make it with "
                f"lm.init_cache(cfg, batch, scfg.max_seq_len)")
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
    with ``cfg.embed_inputs``, as numpy arrays or tensors."""
    lm.check_family(cfg)

    def prefill_step(params, batch: Dict[str, Any]) -> torch.Tensor:
        return lm.prefill(params, cfg, batch)

    return prefill_step
