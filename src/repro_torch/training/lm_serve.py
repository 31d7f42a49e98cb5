"""LM serving: the prefill step.

The port of the JAX package's ``training/lm_serve.py`` without the decode
half: ``make_serve_step`` (one-token decode over a KV cache) and its
``ServeConfig`` come with the decode slice.  Nothing of the forest serving
path (`serve_lib`) imports this module.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """``prefill_step(params, batch) -> (B, padded_vocab)`` float32 logits
    of each sequence's last position, on the parameters' device.
    ``batch["inputs"]`` is (B, S) token ids, or (B, S, d_model) embeddings
    with ``cfg.embed_inputs``, as numpy arrays or tensors."""
    lm.check_family(cfg)

    def prefill_step(params, batch: Dict[str, Any]) -> torch.Tensor:
        return lm.prefill(params, cfg, batch)

    return prefill_step
