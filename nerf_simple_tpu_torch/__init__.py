"""nerf_simple_tpu_torch: the PyTorch / CUDA port of nerf_simple_tpu.

The JAX package ``nerf_simple_tpu`` is the reference this package is held
against. This package imports torch and numpy, never JAX. It runs training
(``python -m nerf_simple_tpu_torch.train``: the fused train-step kernel)
and the novel-view server (``python -m nerf_simple_tpu_torch.serve``: the
fused MLP forward). Each kernel is hand-written CUDA on the card, with
its plain PyTorch version for CPU tensors (``kernels/mlp.py``).
"""
