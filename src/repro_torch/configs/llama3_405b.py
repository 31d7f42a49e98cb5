"""llama3-405b [dense]: GQA, 128k vocab [arXiv:2407.21783].
126L d_model=16384 128H(kv=8) d_ff=53248 vocab=128256.
kv=8 < TP=16 -> KV projections replicated across TP (Megatron-style
duplication).  >=100B => Adafactor + gradient accumulation (DESIGN.md §5)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8, head_dim=128,
    d_ff=53248, vocab_size=128256, act="swiglu", rope_theta=500_000.0,
    tie_embeddings=False, microbatches=16,
)
