"""Camera rays and spherical poses (port of nerf_simple_tpu/ops/rays.py).

Reference conventions (utils/xyz.py:38-52): pixel (row r, col c) maps to
the camera-frame direction ``((c - W//2)/f, -(r - H//2)/f, -1)`` on an
integer-centred grid; rays are row-major over the image; directions are
not normalised.
"""

from __future__ import annotations

import numpy as np
import torch


def camera_ray_dirs(
    H: int, W: int, f: float, device, dtype=torch.float32
) -> torch.Tensor:
    """(H*W, 3) camera-frame directions, row-major over pixels."""
    rows = torch.arange(H, dtype=dtype, device=device) - H // 2
    cols = torch.arange(W, dtype=dtype, device=device) - W // 2
    x = (cols[None, :] / f).expand(H, W)
    y = (-rows[:, None] / f).expand(H, W)
    z = -torch.ones((H, W), dtype=dtype, device=device)
    return torch.stack([x, y, z], dim=-1).reshape(H * W, 3)


def rays_for_poses(poses: torch.Tensor, H: int, W: int, f: float) -> torch.Tensor:
    """(P, 4, 4) camera-to-world poses -> (P*H*W, 6) ``[origin | dir]``
    rays, camera-major then row-major (utils/dataload.py:127)."""
    cam_dirs = camera_ray_dirs(H, W, f, poses.device, poses.dtype)  # (HW, 3)
    # R_p @ d as an elementwise product and sum: exact f32 on every
    # device (a CUDA matmul could run in TF32 if a caller enabled it)
    world_dirs = (poses[:, None, :3, :3] * cam_dirs[None, :, None, :]).sum(-1)
    origins = poses[:, None, :3, 3].expand_as(world_dirs)
    return torch.cat([origins, world_dirs], dim=-1).reshape(-1, 6)


# Spherical ("dome orbit") poses, reference utils/xyz.py:55-81: host numpy.


def _theta_mat(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array(
        [[1.0, 0, 0, 0], [0, c, s, 0], [0, -s, c, 0], [0, 0, 0, 1.0]]
    )


def _phi_mat(phi: float) -> np.ndarray:
    c, s = np.cos(phi), np.sin(phi)
    return np.array(
        [[c, s, 0, 0], [-s, c, 0, 0], [0, 0, 1.0, 0], [0, 0, 0, 1.0]]
    )


def spherical_to_pose(r: float, theta_deg: float, phi_deg: float) -> np.ndarray:
    """4x4 camera-to-world pose: ``phi_mat @ theta_mat @ translate(z=r)``
    with the reference's rotation signs."""
    trans = np.eye(4)
    trans[2, 3] = r
    return _phi_mat(np.radians(phi_deg)) @ _theta_mat(np.radians(theta_deg)) @ trans
