"""nerf_simple_tpu_torch: the PyTorch / CUDA port of nerf_simple_tpu.

The JAX package ``nerf_simple_tpu`` is the reference this package is held
against. This package imports torch and numpy, never JAX. It runs the
novel-view server's path: rays -> stratified samples -> the fused NeRF
MLP forward (a hand-written CUDA kernel on the card, its plain PyTorch
version on CPU tensors) -> volume compositing.
"""
