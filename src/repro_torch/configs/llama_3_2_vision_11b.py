"""llama-3.2-vision-11b [vlm]: cross-attention image layers every 5 decoder
layers [hf:meta-llama/Llama-3.2-11B-Vision].  40L d_model=4096 32H(kv=8)
d_ff=14336 vocab=128256.  Vision frontend is a STUB: input_specs() supplies
precomputed patch embeddings (B, n_image_tokens, d_model)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=128256, act="swiglu",
    cross_attn_every=5, n_image_tokens=1600,
    tie_embeddings=False,
)
