"""grok-1-314b [moe]: 8 experts top-2 [hf:xai-org/grok-1].
64L d_model=6144 48H(kv=8) d_ff=32768 vocab=131072.
8 experts < TP=16 => moe_shard='tp' (d_ff of each expert sharded over the
model axis; EP requires E % tp == 0 — DESIGN.md §4)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=32768, vocab_size=131072, act="swiglu",
    n_experts=8, top_k=2, moe_shard="tp",
    tie_embeddings=False, microbatches=4,
)
