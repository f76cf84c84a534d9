"""The device an entry point runs on.

The entry points (train, evaluate) default to the card. Without one they
raise: the CPU runs only when it is asked for (``--device cpu``,
``device="cpu"``), never as a quiet fallback.
"""

from __future__ import annotations

import torch


def require_device(device) -> torch.device:
    """``device`` as a torch.device; raises for a CUDA device on a machine
    without one."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} asked for, but no CUDA device is available; "
            "pass --device cpu (device='cpu') to run on the CPU"
        )
    return device
