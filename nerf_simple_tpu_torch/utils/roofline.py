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


def bound_by(flops: float, nbytes: float, dtype) -> str:
    """"operations" or "bytes": which of the two sets ``bound_ms``."""
    return "operations" if flops / PEAK_FLOPS[dtype] >= nbytes / PEAK_BYTES_PER_S else "bytes"
