"""Hand-written CUDA kernels (sources in ``csrc/``) with their plain
PyTorch versions."""
