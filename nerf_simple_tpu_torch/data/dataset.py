"""Device-resident ray and pixel sets (port of nerf_simple_tpu/data/dataset.py).

Each split's packed ``[origin | direction]`` rays and flat gt pixels are
built on the device once and stay there; a training batch is drawn on
the device with ``torch.randint`` from a generator on that device, so a
step moves no data between host and card.
"""

from __future__ import annotations

import dataclasses

import torch

from nerf_simple_tpu_torch.data.blender import BlenderData
from nerf_simple_tpu_torch.ops.rays import rays_for_poses


@dataclasses.dataclass
class RayDataset:
    """``rays[split]`` (N_split*H*W, 6), camera-major then row-major;
    ``pixels[split]`` the matching (N_split*H*W, 3) gt colours."""

    rays: dict[str, torch.Tensor]
    pixels: dict[str, torch.Tensor]
    H: int
    W: int
    f: float

    @classmethod
    def from_blender(cls, data: BlenderData, device="cpu") -> "RayDataset":
        rays, pixels = {}, {}
        for name, split in data.splits.items():
            poses = torch.as_tensor(split.poses, device=device)
            rays[name] = rays_for_poses(poses, data.H, data.W, data.f)
            pixels[name] = torch.as_tensor(split.images.reshape(-1, 3), device=device)
        return cls(rays, pixels, data.H, data.W, data.f)

    def split_size(self, split: str) -> int:
        return self.rays[split].shape[0]


def sample_ray_batch(generator: torch.Generator, rays: torch.Tensor, pixels: torch.Tensor,
                     batch_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A uniform batch with replacement, drawn on the tensors' device."""
    idx = torch.randint(0, rays.shape[0], (batch_size,), generator=generator, device=rays.device)
    return rays[idx], pixels[idx]
