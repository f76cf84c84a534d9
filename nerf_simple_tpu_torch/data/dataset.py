"""Device-resident ray and pixel sets (port of nerf_simple_tpu/data/dataset.py).

Each split's packed ``[origin | direction]`` rays and flat gt pixels are
built on the device once and stay there; a training batch is drawn on
the device with ``torch.randint`` from a generator on that device, so a
step moves no data between host and card.

``multiscale_train_arrays`` builds mip-NeRF's multiscale training pool:
the train split's image pyramid as 8-column rays, each with its cone
radius and its loss weight.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nerf_simple_tpu_torch.data.blender import BlenderData, block_mean
from nerf_simple_tpu_torch.ops.rays import rays_for_poses, rays_for_poses_scaled


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


MULTISCALE_SCALES = (1, 2, 4, 8)


def multiscale_train_arrays(data: BlenderData, base_radius: float,
                            device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """Mip-NeRF's multiscale training set (paper sec. 4; JAX
    ``multiscale_train_arrays``): the union of the train split's pyramid at
    scales 1, 1/2, 1/4 and 1/8, in that order. Scale s gives the rays of
    ``rays_for_poses_scaled`` (pixel centres on the block centres), the
    s x s block means of the images (``block_mean``), a cone radius ``s *
    base_radius`` (the 1/s frame's focal is f/s) and a loss weight s^2 (the
    pixel's footprint area), divided by the weights' mean over the union.

    Returns ((N, 8) ``[origin | direction | cone radius | loss weight]``,
    (N, 3) gt colours) on ``device``. H and W must be multiples of 8."""
    s_max = MULTISCALE_SCALES[-1]
    if data.H % s_max or data.W % s_max:
        # coarser sides would shear the coarse scales' rays off the block centres
        raise ValueError(f"mip_multiscale needs H and W divisible by {s_max} (got {data.H}x{data.W}); crop or "
                         "resize the dataset, or use half_res")
    split = data.splits["train"]
    poses = torch.as_tensor(split.poses, device=device)
    counts = [len(split) * (data.H // s) * (data.W // s) for s in MULTISCALE_SCALES]
    mean_w = sum(n * s * s for n, s in zip(counts, MULTISCALE_SCALES)) / sum(counts)
    rays, pixels = [], []
    for s, n in zip(MULTISCALE_SCALES, counts):
        gt = split.images if s == 1 else np.stack([block_mean(im, s) for im in split.images])
        cols = torch.tensor([s * base_radius, s * s / mean_w], dtype=torch.float32, device=device)
        rays.append(torch.cat([rays_for_poses_scaled(poses, data.H, data.W, data.f, s), cols.expand(n, 2)], 1))
        pixels.append(torch.as_tensor(gt.reshape(-1, 3).astype(np.float32), device=device))
    return torch.cat(rays), torch.cat(pixels)


def sample_ray_batch(generator: torch.Generator, rays: torch.Tensor, pixels: torch.Tensor,
                     batch_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A uniform batch with replacement, drawn on the tensors' device."""
    idx = torch.randint(0, rays.shape[0], (batch_size,), generator=generator, device=rays.device)
    return rays[idx], pixels[idx]
