"""h2o-danube-3-4b [dense]: llama+mistral mix with sliding-window attention
[arXiv:2401.16818].  24L d_model=3840 32H(kv=8) d_ff=10240 vocab=32000.
SWA window=4096 makes it sub-quadratic => runs long_500k (ring KV cache)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8, head_dim=120,
    d_ff=10240, vocab_size=32000, act="swiglu",
    window=4096, tie_embeddings=True,
)
