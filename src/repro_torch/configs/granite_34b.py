"""granite-34b [dense]: GPT-BigCode-lineage code model, MQA (kv=1),
plain (non-GLU) MLP — 2*d*ff*88L reproduces the published 34B; swiglu would
give 47B
[arXiv:2405.04324; hf].  88L d_model=6144 48H(kv=1) d_ff=24576 vocab=49152."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, head_dim=128,
    d_ff=24576, vocab_size=49152, act="gelu",
    tie_embeddings=False, microbatches=2,
)
