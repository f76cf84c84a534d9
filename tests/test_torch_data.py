"""The port's data path on CPU against the JAX package: the PNG reader
against cv2, the synthetic scene against JAX ``render_gt``, the Blender
loader against the JAX loader on a JAX-written scene, the device ray set
(mirrors tests/test_data.py)."""

import json
import os
import struct
import zlib

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerf_simple_tpu.data.blender as jblender
import nerf_simple_tpu.data.dataset as jdataset
import nerf_simple_tpu.data.synthetic as jsynth
from nerf_simple_tpu_torch.data import blender, synthetic
from nerf_simple_tpu_torch.data.dataset import RayDataset, sample_ray_batch
from nerf_simple_tpu_torch.utils.png import decode_png, encode_png


@pytest.fixture(scope="module")
def jax_scene(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("jscene"))
    jsynth.write_blender_scene(d, n_train=4, n_val=2, n_test=2, H=32, W=32)
    return d


def _filtered_png(img: np.ndarray, ftype: int) -> bytes:
    """A PNG whose every row uses row filter ``ftype`` (the PNG spec's
    filters, written out here independently of the decoder)."""
    H, W, C = img.shape
    rows = img.reshape(H, W * C).astype(np.int64)
    out = []
    for y in range(H):
        x, prior = rows[y], rows[y - 1] if y else np.zeros(W * C, np.int64)
        a = np.concatenate([np.zeros(C, np.int64), x[:-C]])
        c = np.concatenate([np.zeros(C, np.int64), prior[:-C]])
        if ftype == 0:
            pred = 0
        elif ftype == 1:
            pred = a
        elif ftype == 2:
            pred = prior
        elif ftype == 3:
            pred = (a + prior) // 2
        else:
            p = a + prior - c
            pa, pb, pc = np.abs(p - a), np.abs(p - prior), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prior, c))
        out.append(bytes([ftype]) + ((x - pred) % 256).astype(np.uint8).tobytes())

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    ihdr = struct.pack(">IIBBBBB", W, H, 8, 2 if C == 3 else 6, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


def _image(C, seed=0):
    rng = np.random.default_rng(seed)
    img = (rng.uniform(0, 1, (13, 17, C)) ** 2 * 255).astype(np.uint8)
    img[3:9, 4:12] = 200  # flat patches: the sequential filters' carries
    return img


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("C", [3, 4], ids=["rgb", "rgba"])
def test_png_row_filters(ftype, C):
    img = _image(C, seed=ftype)
    np.testing.assert_array_equal(decode_png(_filtered_png(img, ftype)), img)


@pytest.mark.parametrize("C", [3, 4], ids=["rgb", "rgba"])
def test_png_reader_matches_cv2(tmp_path, C):
    """cv2 (libpng) picks its row filters adaptively, so its files mix
    filters 0-4."""
    img = _image(C, seed=7)
    p = str(tmp_path / "a.png")
    cv2.imwrite(p, cv2.cvtColor(img, cv2.COLOR_RGB2BGR if C == 3 else cv2.COLOR_RGBA2BGRA))
    with open(p, "rb") as fh:
        got = decode_png(fh.read())
    want = cv2.cvtColor(cv2.imread(p, cv2.IMREAD_UNCHANGED),
                        cv2.COLOR_BGR2RGB if C == 3 else cv2.COLOR_BGRA2RGBA)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(decode_png(encode_png(img)), img)


def test_png_reader_rejects_what_it_does_not_take(tmp_path):
    p = str(tmp_path / "g.png")
    cv2.imwrite(p, np.zeros((4, 4), np.uint16))  # 16-bit greyscale
    with open(p, "rb") as fh:
        with pytest.raises(ValueError, match="8-bit"):
            decode_png(fh.read())
    data = encode_png(_image(3))
    with pytest.raises(ValueError, match="CRC"):
        decode_png(data[:40] + bytes([data[40] ^ 1]) + data[41:])


def test_synthetic_scene_matches_jax_render_gt():
    poses = jsynth.orbit_cameras(2, seed_jitter=1)
    np.testing.assert_array_equal(synthetic.orbit_cameras(2, seed_jitter=1), poses)
    want = jsynth.render_gt(poses, 16, 20, 18.0, N=64)
    got = synthetic.render_gt(poses, 16, 20, 18.0, N=64)
    assert got.shape == want.shape == (2, 16, 20, 3)
    np.testing.assert_allclose(got, want, atol=2e-5)
    assert got.max() > 0.2  # the blobs are in view


def test_synthetic_field_matches_jax():
    locs = np.random.default_rng(0).uniform(-1.5, 1.5, (500, 3)).astype(np.float32)
    np.testing.assert_allclose(synthetic.field(torch.from_numpy(locs)).numpy(),
                               np.asarray(jsynth.field(jnp.asarray(locs))), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("half_res, num_imgs", [(False, -1), (True, 2)])
def test_load_blender_matches_jax_loader(jax_scene, half_res, num_imgs):
    want = jblender.load_blender(jax_scene, half_res, num_imgs)
    got = blender.load_blender(jax_scene, half_res, num_imgs)
    assert (got.H, got.W) == (want.H, want.W)
    assert got.f == pytest.approx(want.f, rel=1e-12)
    for s in ("train", "val", "test"):
        assert len(got.splits[s]) == len(want.splits[s])
        np.testing.assert_array_equal(got.splits[s].poses, want.splits[s].poses)
        # cv2's INTER_AREA at a scale of exactly 2 is the 2x2 mean
        np.testing.assert_allclose(got.splits[s].images, want.splits[s].images, atol=1e-6)
        assert got.splits[s].images.dtype == np.float32


def test_port_written_scene_loads_in_the_jax_loader(tmp_path):
    d = str(tmp_path / "scene")
    synthetic.write_blender_scene(d, n_train=3, n_val=1, n_test=1, H=24, W=24)
    want = jblender.load_blender(d, half_res=False)
    got = blender.load_blender(d, half_res=False)
    for s in ("train", "val", "test"):
        np.testing.assert_array_equal(got.splits[s].images, want.splits[s].images)
    assert got.splits["train"].images.max() > 0.2


def test_white_bkgd_and_dropped_alpha_match_jax(tmp_path):
    d = str(tmp_path / "rgba")
    for split in ("train", "val", "test"):
        os.makedirs(os.path.join(d, split))
        img = np.zeros((8, 8, 4), np.uint8)
        img[:, :4] = [0, 0, 255, 255]  # BGRA: opaque red
        img[:, 4:] = [0, 255, 0, 0]  # green, transparent
        img[2, 2] = [10, 20, 30, 128]
        cv2.imwrite(os.path.join(d, split, "r_0.png"), img)
        with open(os.path.join(d, f"transforms_{split}.json"), "w") as fh:
            json.dump({"camera_angle_x": 0.69, "frames": [
                {"file_path": f"./{split}/r_0", "transform_matrix": np.eye(4).tolist()}]}, fh)
    for white in (False, True):
        want = jblender.load_blender(d, half_res=False, white_bkgd=white)
        got = blender.load_blender(d, half_res=False, white_bkgd=white)
        np.testing.assert_allclose(got.splits["train"].images, want.splits["train"].images, atol=1e-6)


def test_half_res_rejects_odd_sides():
    with pytest.raises(ValueError, match="even"):
        blender.half(np.zeros((5, 4, 3)))


def test_natural_sort_key():
    names = ["r_10.png", "r_2.png", "r_1.png", "R_3.png"]
    assert sorted(names, key=blender._natural_key) == sorted(names, key=jblender._natural_key)


def test_ray_dataset_matches_jax(jax_scene):
    jd = jdataset.RayDataset.from_blender(jblender.load_blender(jax_scene, half_res=False))
    rd = RayDataset.from_blender(blender.load_blender(jax_scene, half_res=False), "cpu")
    for s in ("train", "val", "test"):
        np.testing.assert_allclose(rd.rays[s].numpy(), np.asarray(jd.rays[s]), atol=1e-6)
        np.testing.assert_allclose(rd.pixels[s].numpy(), np.asarray(jd.pixels[s]), atol=1e-7)
    assert rd.split_size("train") == 4 * 32 * 32


def test_sample_ray_batch_pairs_rays_with_pixels(jax_scene):
    rd = RayDataset.from_blender(blender.load_blender(jax_scene, half_res=True), "cpu")
    g = torch.Generator().manual_seed(0)
    rays_b, pix_b = sample_ray_batch(g, rd.rays["train"], rd.pixels["train"], 64)
    assert rays_b.shape == (64, 6) and pix_b.shape == (64, 3)
    again = sample_ray_batch(torch.Generator().manual_seed(0), rd.rays["train"], rd.pixels["train"], 64)
    assert torch.equal(rays_b, again[0]) and torch.equal(pix_b, again[1])
    for r, p in zip(rays_b[:5], pix_b[:5]):
        rows = torch.nonzero((rd.rays["train"] == r).all(dim=1))[:, 0]
        assert any(torch.allclose(rd.pixels["train"][i], p) for i in rows)
