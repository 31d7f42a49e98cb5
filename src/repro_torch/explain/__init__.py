"""Model inspection over `core.forest.PackedForest`.

Port of the JAX package's ``explain/``: exact multioutput TreeSHAP
(path-dependent through the B6 kernel, and interventional), feature
importances and leaf embeddings, all from the packed serving buffers.
"""
from repro_torch.explain.importance import (IMPORTANCE_KINDS, apply_forest,
                                            feature_importances,
                                            real_split_mask)
from repro_torch.explain.paths import BIG_BIN, PathPack, build_path_pack
from repro_torch.explain.shap import (ALGORITHMS, expected_values,
                                      shap_values)

__all__ = [
    "ALGORITHMS", "BIG_BIN", "IMPORTANCE_KINDS", "PathPack", "apply_forest",
    "build_path_pack", "expected_values", "feature_importances",
    "real_split_mask", "shap_values",
]
