"""The benchmark of the PyTorch and CUDA port (``cfd_tpu_torch``): see
``harness.py`` and ``BENCHMARK.json``."""
