"""The benchmark harness of the PyTorch and CUDA port.

Everything that belongs to one configuration, traffic mix, kernel or
per-layer metric lives in a file of its own under ``mgbench/`` and is found
by the name that ``BENCHMARK.json`` gives it (``spec.py``). The harness
imports no JAX and nothing of the JAX package; the port is imported only
by ``runner.py``.
"""
