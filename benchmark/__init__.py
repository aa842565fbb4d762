"""The benchmark of ``gssd_torch`` (the PyTorch and CUDA port) on one
NVIDIA H100: ``python3 -m benchmark.run``. See ``benchmark/README.md``."""
