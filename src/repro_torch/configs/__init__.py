"""Architecture registry: the 10 pool configs + the paper's workload.

The port of the JAX package's ``configs/__init__.py``.  ``get_config(name)``
returns the full published configuration; ``smoke_config(name)`` a reduced
same-family config for CPU tests (small depth, width, experts and tables);
``get_gbdt_config()`` the paper's SketchBoost workload.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

_MODULES: Dict[str, str] = {
    "zamba2-1.2b": "zamba2_1_2b",
    "musicgen-medium": "musicgen_medium",
    "mamba2-370m": "mamba2_370m",
    "gemma-7b": "gemma_7b",
    "llama3-405b": "llama3_405b",
    "granite-34b": "granite_34b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "grok-1-314b": "grok_1_314b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
}

ARCH_NAMES: List[str] = list(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_NAMES}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def get_gbdt_config():
    mod = importlib.import_module("repro_torch.configs.sketchboost_tabular")
    return mod.CONFIG, mod.N_ROWS, mod.N_FEATURES


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config: 2-6 layers, narrow widths, tiny vocab.

    Keeps the structural features of the full config (GLU kind, MoE top-k,
    SSD chunking, periodic shared/cross blocks, SWA).  Heads are capped at 4
    and kv heads at the heads, so a GQA ratio above 4 becomes plain
    attention (h2o-danube's 32/8 becomes 4/4).
    """
    cfg = get_config(name)
    heads = min(cfg.n_heads, 4)
    kv = max(1, min(cfg.n_kv_heads, heads))
    over = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=128, n_heads=heads, n_kv_heads=kv, head_dim=32,
        d_ff=0 if cfg.d_ff == 0 else 256,
        vocab_size=min(cfg.vocab_size, 512),
        microbatches=1, attn_chunk=32,
    )
    if cfg.family in ("ssm", "hybrid"):
        over.update(ssm_state=16, ssm_headdim=32, ssm_chunk=16)
    if cfg.family == "hybrid":
        over.update(attn_every=2, n_layers=5)
    if cfg.n_experts:
        over.update(n_experts=max(4, cfg.n_experts // 4), router_group=32,
                    capacity_factor=4.0)
    if cfg.family == "vlm":
        over.update(cross_attn_every=2, n_image_tokens=16)
    if cfg.window is not None:
        over.update(window=16)
    return dataclasses.replace(cfg, **over)
