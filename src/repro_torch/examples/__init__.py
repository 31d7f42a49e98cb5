"""The port's runnable examples, one module each, ports of the JAX
package's ``examples/*.py`` with the same configurations, sizes and
checks:

  python -m repro_torch.examples.quickstart        # sketch methods vs Full
  python -m repro_torch.examples.serve_gbdt        # registry, int8 twin
  python -m repro_torch.examples.explain_gbdt      # checkpoint -> TreeSHAP
  python -m repro_torch.examples.distributed_gbdt  # (4, 2) mesh of ranks

Each runs on the CUDA card unless ``--device cpu`` is given, and takes
size arguments whose defaults are the reference example's.  Each module's
``main(argv)`` returns what it printed as a dict, for tests and
``chip_smoke.py``.
"""
