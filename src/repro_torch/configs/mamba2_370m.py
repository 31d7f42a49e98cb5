"""mamba2-370m [ssm]: SSD (state-space duality), attention-free
[arXiv:2405.21060].  48L d_model=1024 d_ff=0 vocab=50280 ssm_state=128.
Vocab padded 50280 -> 50432 for TP divisibility (DESIGN.md §4)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_chunk=256,
    tie_embeddings=True,
)
