"""Camera rays and spherical poses (port of nerf_simple_tpu/ops/rays.py).

Reference conventions (utils/xyz.py:38-52): pixel (row r, col c) maps to
the camera-frame direction ``((c - W//2)/f, -(r - H//2)/f, -1)`` on an
integer-centred grid; rays are row-major over the image; directions are
not normalised.

``rodrigues_rotate``, ``apply_cam_deltas`` and ``bake_cam_deltas`` are the
differentiable per-image pose deltas of BARF-style camera refinement
(``pose_opt``): the train step refines its sampled rays with them, and a
pose freeze bakes them into the whole ray set.
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


def _world_rays(poses: torch.Tensor, cam_dirs: torch.Tensor) -> torch.Tensor:
    """(P, 4, 4) poses and (n, 3) camera-frame directions -> (P*n, 6)
    ``[origin | dir]`` rays, camera-major."""
    # R_p @ d as an elementwise product and sum: exact f32 on every
    # device (a CUDA matmul could run in TF32 if a caller enabled it)
    world_dirs = (poses[:, None, :3, :3] * cam_dirs[None, :, None, :]).sum(-1)
    origins = poses[:, None, :3, 3].expand_as(world_dirs)
    return torch.cat([origins, world_dirs], dim=-1).reshape(-1, 6)


def rays_for_poses(poses: torch.Tensor, H: int, W: int, f: float) -> torch.Tensor:
    """(P, 4, 4) camera-to-world poses -> (P*H*W, 6) ``[origin | dir]``
    rays, camera-major then row-major (utils/dataload.py:127)."""
    return _world_rays(poses, camera_ray_dirs(H, W, f, poses.device, poses.dtype))


def rays_for_poses_scaled(poses: torch.Tensor, H: int, W: int, f: float, s: int) -> torch.Tensor:
    """Rays of a 1/s-scale frame whose pixel centres are the centres of the
    s x s blocks an area downsample averages (JAX ``rays_for_poses_scaled``):
    pixel i samples the full-resolution coordinate ``s*i + (s-1)/2``. The
    integer-centred grid of ``rays_for_poses(poses, H//s, W//s, f/s)``
    would sit (s-1)/2 full-resolution pixels off those centres. At s = 1 it
    is ``rays_for_poses``. Returns (P * (H//s) * (W//s), 6)."""
    if s == 1:
        return rays_for_poses(poses, H, W, f)
    Hs, Ws = H // s, W // s
    dev, dt = poses.device, poses.dtype
    rows = torch.arange(Hs, dtype=dt, device=dev) * s + (s - 1) / 2.0 - H // 2
    cols = torch.arange(Ws, dtype=dt, device=dev) * s + (s - 1) / 2.0 - W // 2
    x = (cols[None, :] / f).expand(Hs, Ws)
    y = (-rows[:, None] / f).expand(Hs, Ws)
    cam_dirs = torch.stack([x, y, -torch.ones((Hs, Ws), dtype=dt, device=dev)], dim=-1).reshape(Hs * Ws, 3)
    return _world_rays(poses, cam_dirs)


# Camera-pose refinement: per-image se(3) deltas, an axis-angle rotation
# about the camera centre and a world translation (JAX ops/rays.py:181-257).


def rodrigues_rotate(rvec: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors ``v`` (..., 3) by the axis-angle ``rvec`` (..., 3).

    Rodrigues' formula with the even coefficients ``sin(t)/t`` and ``(1 -
    cos t)/t^2 == 2 sin^2(t/2)/t^2``: near zero both take their series, and
    the exact branches use the half-angle form and a clamp that keeps every
    intermediate of the gradient in f32's normal range, so the gradient at
    the zero rotation (the initial delta) is finite. A naive ``(1 - cos
    t)/max(t^2, 1e-24)`` has a finite value there but a 0/0 gradient."""
    sq = torch.sum(rvec * rvec, dim=-1, keepdim=True)
    th = torch.sqrt(torch.clamp(sq, min=1e-24))
    small = sq < 1e-8
    sinc = torch.where(small, 1.0 - sq / 6.0, torch.sin(th) / th)
    half = torch.sin(0.5 * th) / th  # -> 1/2 as th -> 0, no cancellation
    cosc = torch.where(small, 0.5 - sq / 24.0, 2.0 * half * half)
    cr = torch.linalg.cross(rvec, v, dim=-1)
    crr = torch.linalg.cross(rvec, cr, dim=-1)
    return v + sinc * cr + cosc * crr


def apply_cam_deltas(rays: torch.Tensor, dr: torch.Tensor, dt: torch.Tensor) -> torch.Tensor:
    """Refine packed ``[origin | direction | ...]`` rays by per-ray (B, 3)
    deltas: directions rotate by ``rodrigues_rotate(dr, .)`` (about the
    camera centre), origins move by ``dt`` (world frame); columns past 6
    pass through. The identity at the zero delta."""
    return torch.cat([rays[:, :3] + dt, rodrigues_rotate(dr, rays[:, 3:6]), rays[:, 6:]], dim=-1)


def bake_cam_deltas(rays: torch.Tensor, dr_tbl: torch.Tensor, dt_tbl: torch.Tensor,
                    rays_per_image: int) -> torch.Tensor:
    """Per-image (n_images, 3) delta tables applied to a whole ray set in
    one pass: row i belongs to image ``i // rays_per_image`` (the row-major
    [image, pixel] layout of ``rays_for_poses``). Equal to the per-ray
    ``apply_cam_deltas`` by construction."""
    im = torch.arange(rays.shape[0], device=rays.device) // rays_per_image
    return apply_cam_deltas(rays, dr_tbl[im], dt_tbl[im])


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


def orbit_poses(r: float, theta_deg: float, n_phi: int = 40) -> np.ndarray:
    """(n_phi, 4, 4) poses sweeping phi over [0, 360] with the endpoint
    included, so the first and last frames coincide (reference
    ``poses_to_render``, utils/xyz.py:83-91)."""
    phis = np.linspace(0.0, 360.0, n_phi)
    return np.stack([spherical_to_pose(r, theta_deg, p) for p in phis])
