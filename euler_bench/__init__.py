"""The benchmark of ``tpu_euler_torch``, the PyTorch and CUDA assembler.

``run.py`` runs one cell of ``BENCHMARK.json`` once; ``README.md`` says how.
Nothing here imports JAX or the JAX package ``tpu_euler``.
"""
