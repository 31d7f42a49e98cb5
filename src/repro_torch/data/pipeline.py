"""Synthetic tabular data (paper App. B.7 protocol, Guyon 2003 scheme).

A copy of the numpy generators of the JAX package's ``data/pipeline.py``,
so that the two packages see identical inputs from one seed.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def make_tabular(task: str, n: int, m: int, d: int, *, seed: int = 0,
                 n_informative: Optional[int] = None, noise: float = 0.5
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Guyon-style synthetic dataset.

    Features: ``n_informative`` i.i.d. normals, 2x linear combinations of
    them, remainder pure noise.  Targets from a random linear map + noise:
      multiclass  -> argmax over d logits (labels (n,))
      multilabel  -> sign over d logits   (labels (n, d) in {0,1})
      multitask   -> the d logits         (targets (n, d))
    """
    rng = np.random.default_rng(seed)
    ni = n_informative or max(m // 10, 2)
    nc = min(2 * ni, max(m - ni, 0))
    base = rng.normal(size=(n, ni)).astype(np.float32)
    combo = base @ rng.normal(size=(ni, nc)).astype(np.float32)
    rest = rng.normal(size=(n, max(m - ni - nc, 0))).astype(np.float32)
    X = np.concatenate([base, combo, rest], axis=1)[:, :m]
    W = rng.normal(size=(ni, d)).astype(np.float32)
    logits = base @ W + noise * rng.normal(size=(n, d)).astype(np.float32)
    if task == "multiclass":
        y = logits.argmax(1).astype(np.int32)
    elif task == "multilabel":
        y = (logits > 0).astype(np.float32)
    elif task == "multitask_mse":
        y = logits.astype(np.float32)
    else:
        raise ValueError(task)
    return X, y


def train_test_split(X, y, test_frac: float = 0.2, seed: int = 0):
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(X))
    cut = int(len(X) * (1 - test_frac))
    tr, te = idx[:cut], idx[cut:]
    return X[tr], X[te], y[tr], y[te]
