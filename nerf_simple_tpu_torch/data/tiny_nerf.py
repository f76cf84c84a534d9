"""The tiny_nerf_data.npz loader (port of nerf_simple_tpu/data/tiny_nerf.py).

The npz holds ``images`` (N, H, W, 3) float32, ``poses`` (N, 4, 4) and a
scalar ``focal``. Split as the original tiny-NeRF colab: the first
``n_train`` images (100, at most N - 2) train, the rest held out, half
val and half test. Host-side numpy, as the Blender loader.
"""

from __future__ import annotations

import numpy as np

from nerf_simple_tpu_torch.data.blender import BlenderData, BlenderSplit


def load_tiny_nerf(path: str, n_train: int = 100) -> BlenderData:
    with np.load(path) as data:
        images = np.asarray(data["images"], np.float32)
        poses = np.asarray(data["poses"], np.float32)
        focal = float(data["focal"])
    n = len(images)
    n_train = min(n_train, n - 2)
    n_val = (n - n_train) // 2

    def split(lo: int, hi: int) -> BlenderSplit:
        return BlenderSplit(images[lo:hi], poses[lo:hi])

    return BlenderData({"train": split(0, n_train), "val": split(n_train, n_train + n_val),
                        "test": split(n_train + n_val, n)}, images.shape[1], images.shape[2], focal)
