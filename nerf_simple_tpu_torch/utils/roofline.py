"""The least time an NVIDIA H100 SXM could take for a piece of work.

Published dense peaks of one H100 SXM at its full 700 W (NVIDIA's data
sheet): 989 TFLOP/s in bf16 on the tensor cores, 67 TFLOP/s in f32
outside them (no TF32), 3.35 TB/s of HBM3. A card set below 700 W runs
slower; the bound is stated against these peaks all the same.
"""

from __future__ import annotations

import torch

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12


def bound_ms(flops: float, nbytes: float, dtype) -> float:
    """max(operations over the peak rate of ``dtype``, bytes over the
    memory rate), in ms: count each input byte read once and each output
    byte written once."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S) * 1e3


def input_grad_work(model, rows: int, dtype, mip: bool = False) -> tuple[float, float]:
    """FLOPs and bytes of the input-gradient kernel (csrc/input_grad.cuh)
    for ``rows`` sample rows of ``model`` (a NerfMLP): it reads the 2 H +
    H/2 cotangent plane rows a row in ``dtype`` and x's six used rows (24
    B; nine under ``mip``, the variances too, 36 B), and writes dx (32 B;
    64 B, 16 rows, for an appearance model or under ``mip``); its
    products need the 3 + 6 Lp posx columns of W1 and Wsx and the 3 + 6 Ld
    posd columns of Wcd (and the app_dim code columns of an appearance
    model), 2 (2 H (3 + 6 Lp) + H/2 (3 + 6 Ld + app_dim)) flop a row (the
    transpose's sincosf, and under mip its expf and damp chain, left out,
    as is a contracted model's contraction and its transpose: tens of flop a
    row against ~84,000).
    At the flagship, 524,288 rows: bf16 bound by its bytes (0.21 ms; 0.22
    under mip: the kernel runs its bf16 products on the tensor cores), f32
    by its operations (0.56 ms: the SIMT kernel's FMA pipes)."""
    H, H2 = model.H, model.H // 2
    nx, nd = 3 + 6 * model.Lp, 3 + 6 * model.Ld + model.app_dim
    es = torch.finfo(dtype).bits // 8
    x_bytes = 36 if mip else 24
    dx_bytes = 64 if model.app_dim > 0 or mip else 32
    return 2.0 * (2 * H * nx + H2 * nd) * rows, (es * (2 * H + H2) + x_bytes + dx_bytes) * rows


def bound_by(flops: float, nbytes: float, dtype) -> str:
    """"operations" or "bytes": which of the two sets ``bound_ms``."""
    return "operations" if flops / PEAK_FLOPS[dtype] >= nbytes / PEAK_BYTES_PER_S else "bytes"
