"""SketchBoost on PyTorch and CUDA (Hopper, sm_90a).

The port of `src/repro/` (JAX / Pallas on TPU) to PyTorch, module for
module: ``core/`` (quantize, losses, sketch, histogram, split, tree, forest,
boosting), ``kernels/`` (hand-written CUDA kernels, their ctypes wrappers
and their plain PyTorch versions), ``io/`` (checkpoints in the JAX
package's format, carry-over of its fitted state), ``training/`` and
``launch/`` (forest serving), ``runtime/``, ``data/`` and ``configs/``.

It imports ``torch`` and ``numpy`` only, never ``jax`` and nothing of
``repro``; the JAX package is the reference the port's tests hold it to.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
