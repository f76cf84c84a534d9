"""Procedural synthetic scenes (port of nerf_simple_tpu/data/synthetic.py,
the ``blobs`` and ``unbounded`` styles).

No dataset ships with the repo, so the port writes its own scene: a
cluster of coloured Gaussian density blobs near the origin, seen from the
reference's orbit (r=4, theta=-30), with ground truth rendered by the
same compositing the model trains against (dense midpoint samples).
``write_blender_scene`` lays it out like nerf_synthetic (train/ val/
test/ PNGs plus transforms_*.json with ``camera_angle_x``), so the
Blender loader reads it like lego; ``write_depth`` adds the metric-depth
sidecars; ``train_jitter`` jitters the train cameras' elevation (the JAX
writer's seed). ``add_exposure_twins`` gives every train view a darker
twin at the same pose (the appearance codes' check). The ``unbounded``
style adds a distant shell at radius 20 behind the cluster, the scene
that scene contraction and disparity spacing are for; ``camera_r_range``
draws each camera's radius (the background parallax that tells a
world-space far field from a camera-centred one). The JAX package's
``hard`` style is not ported (ROADMAP Queue A item 4).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from nerf_simple_tpu_torch.ops.rays import rays_for_poses, spherical_to_pose
from nerf_simple_tpu_torch.ops.volume import composite
from nerf_simple_tpu_torch.utils.png import decode_png, encode_png

_FOV_X = 0.6911112070083618  # lego's camera_angle_x
_CHUNK = 65536  # rays a pass of render_gt

# (center xyz, pre-softplus peak sigma, rgb color, radius)
_BLOBS = (
    ((0.0, 0.0, 0.0), 8.0, (0.9, 0.2, 0.1), 0.45),
    ((0.6, 0.3, -0.2), 6.0, (0.1, 0.8, 0.2), 0.35),
    ((-0.5, -0.4, 0.3), 6.0, (0.2, 0.3, 0.9), 0.40),
    ((0.1, -0.6, -0.4), 5.0, (0.9, 0.8, 0.1), 0.30),
)


def _field_blobs(locs: torch.Tensor) -> torch.Tensor:
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


def _field_unbounded(locs: torch.Tensor) -> torch.Tensor:
    """The blob cluster and a distant shell at radius 20 painted with six
    azimuthal colour bands and an elevation ramp (the JAX
    ``_field_unbounded``): cameras at r = 3..6 see the shell through every
    pixel that misses the cluster. The supports are disjoint, so the blend
    takes the denser of the two."""
    near = _field_blobs(locs)
    r = torch.linalg.vector_norm(locs, dim=-1)
    shell_sigma = -10.0 + 30.0 * torch.sigmoid(8.0 * (0.75 - torch.abs(r - 20.0)))
    bands = 0.5 + 0.5 * torch.sin(6.0 * torch.atan2(locs[..., 1], locs[..., 0]))
    el = locs[..., 2] / torch.clamp(r, min=1e-6)
    shell_rgb = torch.stack([bands, 1.0 - bands, 0.5 + 0.5 * el], dim=-1)
    take_shell = (shell_sigma > near[..., 3])[..., None]
    sigma = torch.maximum(near[..., 3], shell_sigma)
    rgb = torch.where(take_shell, shell_rgb, near[..., :3])
    return torch.cat([rgb, sigma[..., None]], dim=-1)


_STYLES = {"blobs": _field_blobs, "unbounded": _field_unbounded}


def field(locs: torch.Tensor, style: str = "blobs") -> torch.Tensor:
    """Analytic radiance field of a style: (..., 3) positions -> (..., 4)
    rgb and pre-softplus sigma."""
    if style == "hard":
        raise NotImplementedError("the 'hard' synthetic style is not ported yet: ROADMAP Queue A item 4")
    return _STYLES[style](locs)


def orbit_cameras(n: int, r: float = 4.0, theta_deg: float = -30.0, seed_jitter: int = 0,
                  r_range: tuple[float, float] | None = None) -> np.ndarray:
    """(n, 4, 4) poses spread over azimuth [0, 360), with the JAX
    package's deterministic elevation jitter when ``seed_jitter`` != 0;
    with ``r_range``, each camera's radius drawn uniformly from it (after
    the jitter, from the same generator, as JAX draws them)."""
    rng = np.random.default_rng(seed_jitter)
    phis = np.linspace(0.0, 360.0, n, endpoint=False)
    thetas = theta_deg + (rng.uniform(-8, 8, n) if seed_jitter else np.zeros(n))
    rs = rng.uniform(*r_range, n) if r_range else np.full(n, r)
    return np.stack([spherical_to_pose(rr, t, p) for rr, t, p in zip(rs, thetas, phis)]).astype(np.float32)


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
    style: str = "blobs",
) -> np.ndarray | tuple[np.ndarray, np.ndarray]:
    """(P, H, W, 3) float32 ground truth in [0, 1]: the analytic field of
    ``style`` at N midpoint samples a ray, composited and clipped like an eval render;
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
            comp = composite(field(locs, style), ts, unit)
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
    style: str = "blobs",
    camera_r_range: tuple[float, float] | None = None,
) -> None:
    """Write the synthetic scene to ``path`` in nerf_synthetic layout, the
    images as 8-bit RGB PNGs, with lego's field of view. ``write_depth``
    also saves each image's metric depth as ``<path>/depth/<split>/
    r_<i>.npy``, a sidecar directory outside the split directories the
    Blender loader lists. ``train_jitter``: the seed of the train cameras'
    elevation jitter (``orbit_cameras``' ``seed_jitter``); 0 keeps every
    train view at theta = -30, a circle of views, as the JAX writer's
    default does. ``style``: "blobs" or "unbounded" (whose ground truth
    integrates 576 samples on [0.5, 30], past the shell, as JAX's does);
    ``camera_r_range``: each camera's radius drawn from it."""
    f = W / (2.0 * np.tan(_FOV_X / 2.0))
    field(torch.zeros(1, 3), style)  # an unknown or unported style raises before anything is written
    gt_N, gt_tn, gt_tf = (576, 0.5, 30.0) if style == "unbounded" else (192, 2.0, 6.0)
    specs = {
        "train": orbit_cameras(n_train, seed_jitter=train_jitter, r_range=camera_r_range),
        "val": orbit_cameras(n_val, seed_jitter=1, r_range=camera_r_range),
        "test": orbit_cameras(n_test, seed_jitter=2, r_range=camera_r_range),
    }
    for split, poses in specs.items():
        split_dir = os.path.join(path, split)
        os.makedirs(split_dir, exist_ok=True)
        imgs, depths = render_gt(poses, H, W, f, N=gt_N, tn=gt_tn, tf=gt_tf, device=device, return_depth=True,
                                 style=style)
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


def add_exposure_twins(path: str, factor: float = 0.55) -> int:
    """Give each of the n train views of the scene at ``path`` an exposure
    twin: train image n + i is image i times ``factor``, cut to 8 bits, at
    image i's pose (the JAX package's exposure-twin fixture,
    tests/test_pose_app.py:476-507, which writes the same bytes with cv2).
    Equal poses mean equal rays, so only a per-image appearance code can
    tell the twins apart. Returns the train views now in the scene."""
    tj_path = os.path.join(path, "transforms_train.json")
    with open(tj_path) as fh:
        tj = json.load(fh)
    frames = tj["frames"]
    n = len(frames)
    for i in range(n):
        with open(os.path.join(path, "train", f"r_{i}.png"), "rb") as fh:
            img = decode_png(fh.read(), color=True).astype(np.float64)
        with open(os.path.join(path, "train", f"r_{n + i}.png"), "wb") as fh:
            fh.write(encode_png((img * factor).astype(np.uint8)))
        frames.append({"file_path": f"./train/r_{n + i}", "transform_matrix": frames[i]["transform_matrix"]})
    with open(tj_path, "w") as fh:
        json.dump(tj, fh)
    return 2 * n
