"""The paper's own workload (Appendix B.7 scale): SketchBoost on a synthetic
multiclass table of 2,097,152 rows x 100 features, d = 512 classes."""
from repro_torch.core.boosting import GBDTConfig

CONFIG = GBDTConfig(
    loss="multiclass", n_outputs=512, strategy="single_tree",
    sketch_method="random_projection", sketch_k=5,
    n_trees=100, depth=6, learning_rate=0.05, lambda_l2=1.0, n_bins=256,
)
N_ROWS = 2_097_152
N_FEATURES = 100
