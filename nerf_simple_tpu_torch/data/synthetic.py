"""Procedural synthetic scene (port of nerf_simple_tpu/data/synthetic.py,
the ``blobs`` style).

No dataset ships with the repo, so the port writes its own scene: a
cluster of coloured Gaussian density blobs near the origin, seen from the
reference's orbit (r=4, theta=-30), with ground truth rendered by the
same compositing the model trains against (dense midpoint samples).
``write_blender_scene`` lays it out like nerf_synthetic (train/ val/
test/ PNGs plus transforms_*.json with ``camera_angle_x``), so the
Blender loader reads it like lego; ``write_depth`` adds the metric-depth
sidecars; ``train_jitter`` jitters the train cameras' elevation (the JAX
writer's seed). The JAX package's ``hard`` and ``unbounded`` styles and
varied camera radii are not ported.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from nerf_simple_tpu_torch.ops.rays import rays_for_poses, spherical_to_pose
from nerf_simple_tpu_torch.ops.volume import composite
from nerf_simple_tpu_torch.utils.png import encode_png

_FOV_X = 0.6911112070083618  # lego's camera_angle_x
_CHUNK = 65536  # rays a pass of render_gt

# (center xyz, pre-softplus peak sigma, rgb color, radius)
_BLOBS = (
    ((0.0, 0.0, 0.0), 8.0, (0.9, 0.2, 0.1), 0.45),
    ((0.6, 0.3, -0.2), 6.0, (0.1, 0.8, 0.2), 0.35),
    ((-0.5, -0.4, 0.3), 6.0, (0.2, 0.3, 0.9), 0.40),
    ((0.1, -0.6, -0.4), 5.0, (0.9, 0.8, 0.1), 0.30),
)


def field(locs: torch.Tensor) -> torch.Tensor:
    """Analytic radiance field (the ``blobs`` style): (..., 3) positions
    -> (..., 4) rgb and pre-softplus sigma."""
    sigma = torch.full(locs.shape[:-1], -10.0, dtype=locs.dtype, device=locs.device)
    rgb_acc = torch.zeros((*locs.shape[:-1], 3), dtype=locs.dtype, device=locs.device)
    w_acc = torch.zeros_like(sigma)
    for center, peak, color, radius in _BLOBS:
        c = torch.tensor(center, dtype=locs.dtype, device=locs.device)
        g = torch.exp(-torch.sum((locs - c) ** 2, -1) / (2.0 * radius**2))
        sigma = sigma + peak * g
        rgb_acc = rgb_acc + g[..., None] * torch.tensor(color, dtype=locs.dtype, device=locs.device)
        w_acc = w_acc + g
    rgb = rgb_acc / torch.clamp(w_acc[..., None], min=1e-6)
    return torch.cat([rgb, sigma[..., None]], dim=-1)


def orbit_cameras(n: int, r: float = 4.0, theta_deg: float = -30.0, seed_jitter: int = 0) -> np.ndarray:
    """(n, 4, 4) poses spread over azimuth [0, 360), with the JAX
    package's deterministic elevation jitter when ``seed_jitter`` != 0."""
    rng = np.random.default_rng(seed_jitter)
    phis = np.linspace(0.0, 360.0, n, endpoint=False)
    thetas = theta_deg + (rng.uniform(-8, 8, n) if seed_jitter else np.zeros(n))
    return np.stack([spherical_to_pose(r, t, p) for t, p in zip(thetas, phis)]).astype(np.float32)


@torch.no_grad()
def render_gt(
    poses: np.ndarray,
    H: int,
    W: int,
    f: float,
    N: int = 192,
    tn: float = 2.0,
    tf: float = 6.0,
    device="cpu",
    return_depth: bool = False,
) -> np.ndarray | tuple[np.ndarray, np.ndarray]:
    """(P, H, W, 3) float32 ground truth in [0, 1]: the analytic field at
    N midpoint samples a ray, composited and clipped like an eval render;
    with ``return_depth`` also the (P, H, W) expected termination depth
    sum(w t), the quantity a trained model's composite predicts."""
    imgs, depths = [], []
    mids = tn + (torch.arange(N, dtype=torch.float32, device=device) + 0.5) * (tf - tn) / N
    for pose in poses:
        rays = rays_for_poses(torch.as_tensor(pose[None], device=device), H, W, f)
        rgb, depth = [], []
        for i in range(0, rays.shape[0], _CHUNK):
            r = rays[i : i + _CHUNK]
            ts = mids.expand(r.shape[0], N)
            dirs = r[:, 3:6]
            locs = r[:, None, :3] + dirs[:, None, :] * ts[..., None]
            unit = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
            comp = composite(field(locs), ts, unit)
            rgb.append(torch.clamp(comp.rgb, 0.0, 1.0))
            depth.append(comp.depth)
        imgs.append(torch.cat(rgb).reshape(H, W, 3).cpu().numpy())
        depths.append(torch.cat(depth).reshape(H, W).cpu().numpy())
    imgs = np.stack(imgs).astype(np.float32)
    return (imgs, np.stack(depths).astype(np.float32)) if return_depth else imgs


def write_blender_scene(
    path: str,
    n_train: int = 8,
    n_val: int = 2,
    n_test: int = 2,
    H: int = 64,
    W: int = 64,
    device="cpu",
    write_depth: bool = False,
    train_jitter: int = 0,
) -> None:
    """Write the synthetic scene to ``path`` in nerf_synthetic layout, the
    images as 8-bit RGB PNGs, with lego's field of view. ``write_depth``
    also saves each image's metric depth as ``<path>/depth/<split>/
    r_<i>.npy``, a sidecar directory outside the split directories the
    Blender loader lists. ``train_jitter``: the seed of the train cameras'
    elevation jitter (``orbit_cameras``' ``seed_jitter``); 0 keeps every
    train view at theta = -30, a circle of views, as the JAX writer's
    default does."""
    f = W / (2.0 * np.tan(_FOV_X / 2.0))
    specs = {
        "train": orbit_cameras(n_train, seed_jitter=train_jitter),
        "val": orbit_cameras(n_val, seed_jitter=1),
        "test": orbit_cameras(n_test, seed_jitter=2),
    }
    for split, poses in specs.items():
        split_dir = os.path.join(path, split)
        os.makedirs(split_dir, exist_ok=True)
        imgs, depths = render_gt(poses, H, W, f, N=192, device=device, return_depth=True)
        if write_depth:
            ddir = os.path.join(path, "depth", split)
            os.makedirs(ddir, exist_ok=True)
            for i, d in enumerate(depths):
                np.save(os.path.join(ddir, f"r_{i}.npy"), d)
        frames = []
        for i, (img, pose) in enumerate(zip(imgs, poses)):
            with open(os.path.join(split_dir, f"r_{i}.png"), "wb") as fh:
                fh.write(encode_png((img * 255).astype(np.uint8)))
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": pose.tolist()})
        with open(os.path.join(path, f"transforms_{split}.json"), "w") as fh:
            json.dump({"camera_angle_x": _FOV_X, "frames": frames}, fh)
