"""Blender-synthetic (nerf_synthetic) scene loader without cv2 (port of
nerf_simple_tpu/data/blender.py).

Behaviour of the JAX loader, which follows the reference
(utils/dataload.py:12-112):

- images listed per split and natural-sorted (train/val: every file in
  the split dir; test: only ``r_<n>.png``);
- 8-bit RGB(A) PNGs read by ``utils/png.py``, then /255; the alpha
  channel is dropped, as ``cv2.imread`` drops it (``white_bkgd``
  composites RGBA onto white instead);
- ``half_res`` halves both sides with an exact 2x2 mean, which is what
  cv2's INTER_AREA computes at a scale of exactly 2; odd sides raise;
- ``num_imgs >= 0`` truncates every split to that count;
- ``f = W / (2 tan(camera_angle_x / 2))`` from the (halved) width.

Host-side numpy; the arrays go to the device once, in bulk
(data/dataset.py). Test-split depth/normal maps and metric-depth
sidecars are not ported.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re

import numpy as np

from nerf_simple_tpu_torch.utils.png import decode_png


def _natural_key(s: str):
    return [int(tok) if tok.isdigit() else tok.lower()
            for tok in re.split(r"(\d+)", os.path.basename(s))]


def imread_rgb(path: str, white_bkgd: bool = False) -> np.ndarray:
    """(H, W, 3) float64 in [0, 1]."""
    with open(path, "rb") as fh:
        img = decode_png(fh.read()) / 255.0
    if img.shape[-1] == 4 and white_bkgd:
        a = img[..., 3:4]
        return img[..., :3] * a + (1.0 - a)
    return img[..., :3]


def half(img: np.ndarray) -> np.ndarray:
    """Halve both sides by the 2x2 mean of each block."""
    H, W = img.shape[:2]
    if H % 2 or W % 2:
        raise ValueError(f"half_res needs even image sides, got {H}x{W}")
    return img.reshape(H // 2, 2, W // 2, 2, -1).mean(axis=(1, 3))


@dataclasses.dataclass
class BlenderSplit:
    images: np.ndarray  # (N, H, W, 3) float32 in [0, 1]
    poses: np.ndarray  # (N, 4, 4) float32

    def __len__(self) -> int:
        return len(self.images)


@dataclasses.dataclass
class BlenderData:
    splits: dict[str, BlenderSplit]
    H: int
    W: int
    f: float


def load_blender(path: str, half_res: bool = True, num_imgs: int = -1,
                 white_bkgd: bool = False) -> BlenderData:
    """Load a nerf_synthetic-format scene directory."""
    splits: dict[str, BlenderSplit] = {}
    fov = None
    for split in ("train", "val", "test"):
        with open(os.path.join(path, f"transforms_{split}.json")) as fh:
            meta = json.load(fh)
        if split == "train":
            fov = meta["camera_angle_x"]
        split_dir = os.path.join(path, split)
        names = os.listdir(split_dir)
        if split == "test":
            names = [fn for fn in names if re.match(r"r_[0-9]+.png", fn)]
        paths = sorted((os.path.join(split_dir, fn) for fn in names), key=_natural_key)
        n = len(paths) if num_imgs < 0 else min(num_imgs, len(paths))
        imgs, poses = [], []
        for i in range(n):
            img = imread_rgb(paths[i], white_bkgd)
            imgs.append((half(img) if half_res else img).astype(np.float32))
            poses.append(np.asarray(meta["frames"][i]["transform_matrix"], np.float32))
        splits[split] = BlenderSplit(np.stack(imgs), np.stack(poses))
    H, W = splits["test"].images.shape[1:3]
    return BlenderData(splits, H, W, float(W / (2.0 * np.tan(fov / 2.0))))
