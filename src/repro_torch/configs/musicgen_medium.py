"""musicgen-medium [audio]: decoder-only over EnCodec tokens
[arXiv:2306.05284; hf].  48L d_model=1536 24H(kv=24) d_ff=6144 vocab=2048.
Modality frontend (EnCodec) is a STUB: input_specs() supplies precomputed
frame embeddings (B, S, d_model), per the assignment."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
    d_ff=6144, vocab_size=2048, act="gelu",
    embed_inputs=True, tie_embeddings=False,
)
