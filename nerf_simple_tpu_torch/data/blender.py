"""Blender-synthetic (nerf_synthetic) scene loader without cv2 (port of
nerf_simple_tpu/data/blender.py).

Behaviour of the JAX loader, which follows the reference
(utils/dataload.py:12-112):

- images listed per split and natural-sorted (train/val: every file in
  the split dir; test: only ``r_<n>.png``);
- PNGs read by ``utils/png.py`` as ``cv2.imread`` reads them (any colour
  type, bit depth and interlace), then /255; the alpha channel is
  dropped, as ``cv2.imread`` drops it (``white_bkgd`` composites RGBA
  onto white instead);
- ``half_res`` halves both sides with an exact 2x2 mean, which is what
  cv2's INTER_AREA computes at a scale of exactly 2; odd sides raise;
- ``num_imgs >= 0`` truncates every split to that count;
- ``f = W / (2 tan(camera_angle_x / 2))`` from the (halved) width.

- metric-depth sidecars ``<path>/depth/<split>/r_<i>.npy`` (written by
  ``data/synthetic.py``): read when there is one for every kept image of
  the split (a partial set warns and is ignored), halved like the images
  under ``half_res``.

Host-side numpy; the arrays go to the device once, in bulk
(data/dataset.py). ``load_test_maps`` adds the test split's depth and
normal PNG maps (the reference's visualisations, which nothing trains on).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import warnings

import numpy as np

from nerf_simple_tpu_torch.utils.png import decode_png


def _natural_key(s: str):
    return [int(tok) if tok.isdigit() else tok.lower()
            for tok in re.split(r"(\d+)", os.path.basename(s))]


def imread_rgb(path: str, white_bkgd: bool = False) -> np.ndarray:
    """(H, W, 3) float64, the JAX ``_imread_rgb`` through cv2: without
    ``white_bkgd`` the image as ``cv2.imread`` reads it (``IMREAD_COLOR``:
    grey repeated, palette expanded, alpha dropped, 16-bit cut to 8),
    over 255; with it, the image as stored (``IMREAD_UNCHANGED``) over 255,
    RGBA composited onto white and grey repeated to three channels (cv2's
    BGR-to-RGB conversion does that to one channel). At 16 bits both JAX
    branches divide by 255 too, so values run past 1; the port keeps that."""
    with open(path, "rb") as fh:
        data = fh.read()
    if not white_bkgd:
        return decode_png(data, color=True) / 255.0
    img = decode_png(data) / 255.0
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    if img.shape[-1] == 4:
        a = img[..., 3:4]
        return img[..., :3] * a + (1.0 - a)
    return img


def block_mean(img: np.ndarray, s: int) -> np.ndarray:
    """Shrink both sides of an (H, W) or (H, W, C) image s times by the mean
    of each s x s block: cv2's INTER_AREA at an integer scale. Sides that s
    does not divide raise."""
    H, W = img.shape[:2]
    if H % s or W % s:
        raise ValueError(f"a 1/{s} block mean needs image sides divisible by {s}, got {H}x{W}")
    return img.reshape(H // s, s, W // s, s, *img.shape[2:]).mean(axis=(1, 3))


def half(img: np.ndarray) -> np.ndarray:
    """Halve both sides of an (H, W) or (H, W, C) image by the 2x2 mean of
    each block (``block_mean`` at s = 2)."""
    H, W = img.shape[:2]
    if H % 2 or W % 2:
        raise ValueError(f"half_res needs even image sides, got {H}x{W}")
    return block_mean(img, 2)


@dataclasses.dataclass
class BlenderSplit:
    images: np.ndarray  # (N, H, W, 3) float32 in [0, 1]
    poses: np.ndarray  # (N, 4, 4) float32
    # the test split's depth and normal PNG maps (load_test_maps), (N, H, W, 3) float32 at full resolution
    depth_images: np.ndarray | None = None
    normal_images: np.ndarray | None = None
    metric_depth: np.ndarray | None = None  # (N, H, W) float32, from the sidecars

    def __len__(self) -> int:
        return len(self.images)


@dataclasses.dataclass
class BlenderData:
    splits: dict[str, BlenderSplit]
    H: int
    W: int
    f: float


def load_scene(dataset: str, path: str, half_res: bool = True, num_imgs: int = -1,
               white_bkgd: bool = False) -> BlenderData:
    """The scene of a config's ``dataset``: "tiny_nerf" reads the npz at
    ``path`` (which knows no half_res, num_imgs or white_bkgd, as in JAX),
    "blender" the scene directory."""
    if dataset == "tiny_nerf":
        from nerf_simple_tpu_torch.data.tiny_nerf import load_tiny_nerf

        return load_tiny_nerf(path)
    return load_blender(path, half_res, num_imgs, white_bkgd=white_bkgd)


def load_blender(path: str, half_res: bool = True, num_imgs: int = -1, load_test_maps: bool = False,
                 white_bkgd: bool = False) -> BlenderData:
    """Load a nerf_synthetic-format scene directory. ``load_test_maps``
    also reads the test split's ``r_<i>_depth*`` and ``r_<i>_normal*``
    PNGs, natural-sorted, cut to the split's image count, at full
    resolution (JAX data/blender.py:162-186)."""
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
        maps = {}
        if split == "test" and load_test_maps:
            for kind in ("depth", "normal"):
                found = sorted((os.path.join(split_dir, fn) for fn in os.listdir(split_dir)
                                if re.match(rf"r_[0-9]+_{kind}", fn)), key=_natural_key)
                if found:
                    maps[f"{kind}_images"] = np.stack([imread_rgb(p).astype(np.float32) for p in found[:n]])
        splits[split] = BlenderSplit(np.stack(imgs), np.stack(poses),
                                     metric_depth=_metric_depth(path, split, n, half_res), **maps)
    H, W = splits["test"].images.shape[1:3]
    return BlenderData(splits, H, W, float(W / (2.0 * np.tan(fov / 2.0))))


def _metric_depth(path: str, split: str, n: int, half_res: bool) -> np.ndarray | None:
    """The split's (n, H, W) metric depth from ``<path>/depth/<split>/
    r_<i>.npy``, all or nothing."""
    ddir = os.path.join(path, "depth", split)
    if not os.path.isdir(ddir):
        return None
    paths = [os.path.join(ddir, f"r_{i}.npy") for i in range(n)]
    if not all(os.path.exists(p) for p in paths):
        warnings.warn(f"{ddir} exists but is missing some of r_0..r_{n - 1}.npy; ignoring "
                      "metric depth for this split", stacklevel=3)
        return None
    maps = [np.load(p).astype(np.float32) for p in paths]
    return np.stack([half(m).astype(np.float32) if half_res else m for m in maps])
