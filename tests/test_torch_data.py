"""The port's data path on CPU against the JAX package: the PNG reader
against cv2, the synthetic scene against JAX ``render_gt``, the Blender
loader against the JAX loader on a JAX-written scene, the device ray set
(mirrors tests/test_data.py); the loaders and options of ROADMAP Queue A
item 4: the ``hard`` style, the tiny_nerf npz (and train() + eval on it),
the test split's depth and normal maps, ``train_im_idxs``."""

import json
import os
import re
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


# PNG kinds: colour type, bit depth, tRNS. The ids "rgb" and "rgba" are the
# 8-bit truecolour cases the reader took first.
KINDS = {
    "rgb": (2, 8, False), "rgba": (6, 8, False), "grey": (0, 8, False), "grey1": (0, 1, False),
    "grey2": (0, 2, False), "grey4": (0, 4, False), "grey16": (0, 16, False),
    "grey-trns": (0, 8, True), "greyalpha": (4, 8, False), "greyalpha16": (4, 16, False),
    "rgb16": (2, 16, False), "rgba16": (6, 16, False), "rgb-trns": (2, 8, True),
    "rgb16-trns": (2, 16, True), "pal1": (3, 1, False), "pal2": (3, 2, False),
    "pal4": (3, 4, True), "pal8": (3, 8, True),
}
_SPP = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _samples(kind, H=13, W=17, seed=0):
    """(H, W, samples a pixel) of a kind: random values of its bit depth,
    with flat patches (the sequential filters' carries), and a pixel that
    hits the tRNS key."""
    ctype, depth, _ = KINDS[kind]
    rng = np.random.default_rng(seed)
    top = (1 << depth) - 1 if ctype != 3 else min(255, (1 << depth) - 1)
    img = (rng.uniform(0, 1, (H, W, _SPP[ctype])) ** 2 * top).round().astype(np.uint16)
    img[min(3, H - 1) : 9, min(4, W - 1) : 12] = top * 3 // 4
    return img


def _filter_rows(rows: np.ndarray, ftypes, bpp: int) -> bytes:
    """Rows of bytes (h, n), each filtered with its type (the PNG spec's
    filters, written out here independently of the decoder)."""
    h, n = rows.shape
    rows = rows.astype(np.int64)
    out = []
    for y in range(h):
        x, prior = rows[y], rows[y - 1] if y else np.zeros(n, np.int64)
        a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        f = ftypes[y]
        if f == 0:
            pred = 0
        elif f == 1:
            pred = a
        elif f == 2:
            pred = prior
        elif f == 3:
            pred = (a + prior) // 2
        else:
            p = a + prior - c
            pa, pb, pc = np.abs(p - a), np.abs(p - prior), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prior, c))
        out.append(bytes([f]) + ((x - pred) % 256).astype(np.uint8).tobytes())
    return b"".join(out)


def _pack(img: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, spp) samples -> (h, rowbytes) bytes: big-endian at 16 bits,
    MSB first below 8."""
    h, w, spp = img.shape
    flat = img.reshape(h, w * spp)
    if depth == 16:
        return np.stack([flat >> 8, flat & 0xFF], -1).reshape(h, -1).astype(np.uint8)
    if depth == 8:
        return flat.astype(np.uint8)
    per = 8 // depth
    n = -(-w * spp // per)
    padded = np.zeros((h, n * per), np.int64)
    padded[:, : w * spp] = flat
    shifts = np.arange(8 - depth, -1, -depth)
    return (padded.reshape(h, n, per) << shifts).sum(-1).astype(np.uint8)


def _png(img, kind, ftype, interlace=False, seed=0) -> bytes:
    """A PNG of samples `img` written here: every row with filter `ftype`,
    or a seeded mix of all five where ftype is None; palette and tRNS
    chunks for the kinds that have them; Adam7 when `interlace`."""
    ctype, depth, trns = KINDS[kind]
    H, W, spp = img.shape
    bpp = max(1, depth * spp // 8)
    rng = np.random.default_rng(seed)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    data = b""
    for x0, y0, dx, dy in passes:
        sub = img[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = _pack(sub, depth)
        ft = rng.integers(0, 5, rows.shape[0]) if ftype is None else [ftype] * rows.shape[0]
        data += _filter_rows(rows, ft, bpp)

    def chunk(tag, body):
        return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0,
                                                              int(interlace)))
    if ctype == 3:
        n = 1 << depth
        out += chunk(b"PLTE", np.random.default_rng(99).integers(0, 256, (n, 3)).astype(np.uint8).tobytes())
    if trns:
        if ctype == 3:
            out += chunk(b"tRNS", bytes(range(0, 256, 37))[: (1 << depth) - 1])
        else:  # the key: the first pixel's colour
            out += chunk(b"tRNS", b"".join(struct.pack(">H", int(v)) for v in img[0, 0, :spp]))
    return out + chunk(b"IDAT", zlib.compress(data)) + chunk(b"IEND", b"")


def _cv2(data: bytes, flags) -> np.ndarray:
    """What cv2 decodes, in RGB(A) order."""
    img = cv2.imdecode(np.frombuffer(data, np.uint8), flags)
    if img.ndim == 3:
        img = img[..., [2, 1, 0, 3][: img.shape[-1]]]
    return img


def _check_as_cv2(data: bytes) -> None:
    for color, flags in ((False, cv2.IMREAD_UNCHANGED), (True, cv2.IMREAD_COLOR)):
        got, want = decode_png(data, color=color), _cv2(data, flags)
        assert got.dtype == want.dtype and got.shape == want.shape, (color, got.shape, want.shape)
        np.testing.assert_array_equal(got, want)


def _image(C, seed=0):
    rng = np.random.default_rng(seed)
    img = (rng.uniform(0, 1, (13, 17, C)) ** 2 * 255).astype(np.uint8)
    img[3:9, 4:12] = 200  # flat patches: the sequential filters' carries
    return img


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("C", list(KINDS))
def test_png_row_filters(ftype, C):
    """Every colour type and bit depth with every row filter, against
    cv2 in both of its read modes; 8-bit truecolour also against the
    samples written."""
    img = _samples(C, seed=ftype)
    data = _png(img, C, ftype)
    _check_as_cv2(data)
    if C in ("rgb", "rgba"):
        np.testing.assert_array_equal(decode_png(data), img.astype(np.uint8))


@pytest.mark.parametrize("size", [(13, 17), (3, 2), (1, 1)], ids=["13x17", "3x2", "1x1"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_png_adam7_interlaced_matches_cv2(kind, size):
    """Adam7 files written here (rows of mixed filters in each pass);
    small sides leave some passes empty."""
    img = _samples(kind, *size, seed=3)
    _check_as_cv2(_png(img, kind, None, interlace=True, seed=4))


@pytest.mark.parametrize("C", ["rgb", "rgba", "grey", "grey16", "rgb16", "rgba16"])
def test_png_reader_matches_cv2(tmp_path, C):
    """Files cv2 (libpng) writes, with its adaptive row filters (a mix of
    0-4)."""
    img = _image({"rgb": 3, "rgba": 4, "rgb16": 3, "rgba16": 4}.get(C, 1), seed=7)
    if C.endswith("16"):
        img = img.astype(np.uint16) * 257 + np.arange(img.size, dtype=np.uint16).reshape(img.shape) % 251
    if img.shape[-1] == 1:
        img = img[..., 0]
    p = str(tmp_path / "a.png")
    cv2.imwrite(p, img if img.ndim == 2 else img[..., [2, 1, 0, 3][: img.shape[-1]]])
    with open(p, "rb") as fh:
        data = fh.read()
    _check_as_cv2(data)
    np.testing.assert_array_equal(decode_png(data), img)
    if img.dtype == np.uint8 and img.ndim == 3:
        np.testing.assert_array_equal(decode_png(encode_png(img)), img)


def test_png_reader_rejects_what_it_does_not_take(tmp_path):
    """16-bit greyscale now decodes as cv2 gives it; a bad CRC and a bad
    signature still raise."""
    p = str(tmp_path / "g.png")
    grey16 = (np.arange(16, dtype=np.uint16) * 4099).reshape(4, 4)
    cv2.imwrite(p, grey16)
    with open(p, "rb") as fh:
        data = fh.read()
    np.testing.assert_array_equal(decode_png(data), cv2.imread(p, cv2.IMREAD_UNCHANGED))
    np.testing.assert_array_equal(decode_png(data), grey16)
    data = encode_png(_image(3))
    with pytest.raises(ValueError, match="CRC"):
        decode_png(data[:40] + bytes([data[40] ^ 1]) + data[41:])
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"\x89PNG\r\n\x1a\x00" + data[8:])


@pytest.mark.parametrize("kind, white", [
    ("grey", False), ("pal8", False), ("rgb16", False), ("rgba16", False),
    ("rgb", True), ("rgba", True), ("rgb16", True), ("rgba16", True), ("grey", True),
])
def test_imread_rgb_matches_jax_loader(tmp_path, kind, white):
    """The port's ``imread_rgb`` and the JAX ``_imread_rgb`` (cv2) on one
    file give the same arrays. Greyscale under white_bkgd too: cv2's
    BGR-to-RGB conversion repeats one channel to three."""
    img = _samples(kind, seed=11)
    p = str(tmp_path / "im.png")
    with open(p, "wb") as fh:
        fh.write(_png(img, kind, None, seed=12))
    want = jblender._imread_rgb(p, white)
    got = blender.imread_rgb(p, white)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


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


@pytest.mark.parametrize("ftype", [3, 4])
def test_png_reader_probe_writes_what_it_times(ftype, capsys, monkeypatch):
    """probes/png_reader.py: its all-one-filter file decodes (here and in
    cv2) to the image it was made from; one JSON line at a small size."""
    import json
    import sys

    from nerf_simple_tpu_torch.probes import png_reader

    img = _image(4, seed=ftype)
    data = png_reader.filtered_png(img, ftype)
    np.testing.assert_array_equal(decode_png(data), img)
    np.testing.assert_array_equal(_cv2(data, cv2.IMREAD_UNCHANGED), img)
    monkeypatch.setattr(sys, "argv", ["png_reader", "--size", "24", "--reps", "1", "--filter", str(ftype)])
    png_reader.main()
    assert json.loads(capsys.readouterr().out)["decode_s"] > 0


# --- the loaders and options of ROADMAP Queue A item 4 -------------------------------------------------------


def test_hard_style_matches_jax_and_its_scene_is_sharp_and_sparse(tmp_path):
    """The ``hard`` style (sharp-edged boxes, near-binary density) against
    JAX's field and ``render_gt``, then JAX's statistics of it
    (tests/test_data.py:180-210): ~2% of [-2, 2]^3 occupied, saturated
    interiors, a thin transition shell; a written scene loads in both
    loaders alike, the machine in view and the background empty."""
    g = np.stack(np.meshgrid(*([np.linspace(-2, 2, 32, dtype=np.float32)] * 3), indexing="ij"), -1).reshape(-1, 3)
    got = synthetic.field(torch.from_numpy(g), style="hard").numpy()
    np.testing.assert_allclose(got, np.asarray(jsynth.field(jnp.asarray(g), style="hard")), rtol=1e-5, atol=1e-4)
    sigma = got[:, 3]
    assert 0.005 < float((sigma > 0).mean()) < 0.06
    assert float((sigma > 30.0).mean()) > 0.001
    assert float(((sigma > 0) & (sigma < 30.0)).mean()) < 0.02
    poses = jsynth.orbit_cameras(2, seed_jitter=3)
    want = jsynth.render_gt(poses, 12, 12, 14.0, N=576, style="hard")
    np.testing.assert_allclose(synthetic.render_gt(poses, 12, 12, 14.0, N=576, style="hard"), want, atol=1e-4)
    d = str(tmp_path / "hard")
    synthetic.write_blender_scene(d, n_train=2, n_val=1, n_test=1, H=24, W=24, style="hard")
    data = blender.load_blender(d, half_res=False)
    np.testing.assert_array_equal(data.splits["train"].images, jblender.load_blender(d, half_res=False).splits[
        "train"].images)
    cover = float((data.splits["train"].images[0].sum(-1) > 0.05).mean())
    assert 0.05 < cover < 0.7


def _tiny_npz(path, n=106, H=20, seed=0, scene=False):
    """A tiny_nerf npz: seeded noise as JAX's test writes it
    (tests/test_data.py:106), or the blob scene's renders from an orbit."""
    rng = np.random.default_rng(seed)
    if scene:
        poses = synthetic.orbit_cameras(n, seed_jitter=3)
        focal = H / (2.0 * np.tan(synthetic._FOV_X / 2.0))
        images = synthetic.render_gt(poses, H, H, focal, N=64)
    else:
        poses, focal = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1)), 25.0
        poses[:, :3, 3] = rng.normal(size=(n, 3))
        images = rng.uniform(0, 1, (n, H, H, 3)).astype(np.float32)
    np.savez(path, images=images, poses=poses, focal=np.float64(focal))
    return path


def test_load_tiny_nerf_matches_jax(tmp_path):
    """``load_tiny_nerf`` against JAX's on an npz the test writes: 100
    train images, the rest split between val and test, H, W and focal;
    fewer images keep two held out."""
    from nerf_simple_tpu.data.tiny_nerf import load_tiny_nerf as jload
    from nerf_simple_tpu_torch.data.tiny_nerf import load_tiny_nerf

    for n in (106, 7):
        p = _tiny_npz(str(tmp_path / f"tiny{n}.npz"), n=n)
        got, want = load_tiny_nerf(p), jload(p)
        assert (got.H, got.W, got.f) == (want.H, want.W, want.f) == (20, 20, 25.0)
        for s in ("train", "val", "test"):
            assert len(got.splits[s]) == len(want.splits[s])
            np.testing.assert_array_equal(got.splits[s].images, want.splits[s].images)
            np.testing.assert_array_equal(got.splits[s].poses, want.splits[s].poses)
    assert [len(got.splits[s]) for s in ("train", "val", "test")] == [5, 1, 1]
    assert [len(load_tiny_nerf(str(tmp_path / "tiny106.npz")).splits[s]) for s in ("train", "val", "test")] == [100, 3, 3]
    rd = RayDataset.from_blender(load_tiny_nerf(str(tmp_path / "tiny106.npz")), "cpu")
    assert rd.rays["train"].shape == (100 * 400, 6)


def test_train_and_evaluate_a_tiny_nerf_scene_on_cpu(tmp_path, capsys, monkeypatch):
    """``dataset: tiny_nerf`` through train() (20 steps, sampling only
    train image 0 and 2 under ``train_im_idxs``: the loss falls) and
    evaluate.test on the same npz (a still of the test split, its PNGs);
    ``dataset: llff`` still raises in both configs."""
    import sys

    from nerf_simple_tpu_torch.config import TestConfig, TrainConfig
    from nerf_simple_tpu_torch.evaluate import test
    from nerf_simple_tpu_torch.train.loop import train

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    npz = _tiny_npz(str(tmp_path / "tiny.npz"), n=8, H=16, scene=True)
    cfg = TrainConfig(datapath=npz, dataset="tiny_nerf", savepath=str(tmp_path / "models"), exp_name="tiny", Nf=16,
                      num_iters=30, batch_size=128, net_H=32, net_Lp=4, net_Ld=2, steps_per_call=10, ckpt_loss=1,
                      ckpt_images=10**6, ckpt_model=10**6, train_im_idxs=(0, 2), backend="pallas",
                      log_dir=str(tmp_path / "logs"))
    state = train(cfg, device="cpu")
    losses = [float(v) for v in re.findall(r"loss: ([0-9.]+)", capsys.readouterr().out)]
    assert state.step == 30 and len(losses) == 30 and np.mean(losses[-5:]) < np.mean(losses[:5])
    test(TestConfig(loadpath=str(tmp_path / "models" / "tiny"), datapath=npz, dataset="tiny_nerf",
                    savepath=str(tmp_path / "results"), exp_name="tiny", im_idxs=(0,), N_samples=16, batch_size=256,
                    backend="pallas"), device="cpu")
    out = capsys.readouterr().out
    assert re.search(r"im 0: mse=[0-9.]+ psnr=[0-9.]+ ssim=", out)
    assert os.path.exists(str(tmp_path / "results" / "tiny" / "rgb_0.png"))
    for cls, kw in ((TrainConfig, dict(datapath="d")), (TestConfig, dict(loadpath="m", datapath="d"))):
        with pytest.raises(NotImplementedError, match="item 6, LLFF"):
            cls(**kw, dataset="llff")


@pytest.mark.parametrize("num_imgs", [-1, 1])
def test_load_test_maps_matches_jax(tmp_path, num_imgs):
    """``load_blender(load_test_maps=True)`` against JAX's on depth and
    normal PNGs the test writes beside the test images (greyscale and
    RGBA, named as lego's ``r_<i>_depth_0000.png``): natural-sorted, read
    as cv2.imread reads them, cut to the split's count; without the
    argument, or on other splits, there are none."""
    d = str(tmp_path / "scene")
    synthetic.write_blender_scene(d, n_train=1, n_val=1, n_test=2, H=12, W=12)
    rng = np.random.default_rng(5)
    for i in range(2):
        for kind, C in (("depth", 1), ("normal", 4)):
            img = rng.integers(0, 256, (12, 12, C) if C > 1 else (12, 12), dtype=np.uint8)
            with open(os.path.join(d, "test", f"r_{i}_{kind}_0000.png"), "wb") as fh:
                fh.write(encode_png(img))
    got = blender.load_blender(d, half_res=True, num_imgs=num_imgs, load_test_maps=True)
    want = jblender.load_blender(d, half_res=True, num_imgs=num_imgs, load_test_maps=True)
    n = 2 if num_imgs < 0 else 1
    for kind in ("depth_images", "normal_images"):
        g, w = getattr(got.splits["test"], kind), getattr(want.splits["test"], kind)
        assert g.shape == w.shape == (n, 12, 12, 3) and g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
        assert getattr(got.splits["train"], kind) is None
    assert got.splits["test"].images.shape == (n, 6, 6, 3)
    assert blender.load_blender(d, half_res=True).splits["test"].depth_images is None


@pytest.mark.parametrize("idxs", [(0,), (1, 3)], ids=["image-0", "images-1-3"])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_train_im_idxs_restricts_sampling(jax_scene, idxs, backend):
    """``train_im_idxs``: every sampled ray comes from a listed image
    (JAX tests/test_train.py:350-375): the rows of every other image hold
    NaN, so one stray row makes the loss NaN; 10 steps stay finite on the
    autograd and the fused step. Without ``rays_per_image`` the step does
    not build."""
    from nerf_simple_tpu_torch.config import TrainConfig
    from nerf_simple_tpu_torch.models.nerf import NerfMLP
    from nerf_simple_tpu_torch.train.step import build_train_step, make_train_state

    rd = RayDataset.from_blender(blender.load_blender(jax_scene, half_res=True), "cpu")
    per_img = rd.H * rd.W
    rays, pixels = rd.rays["train"].clone(), rd.pixels["train"].clone()
    for im in range(4):
        if im not in idxs:
            rays[im * per_img : (im + 1) * per_img] = float("nan")
            pixels[im * per_img : (im + 1) * per_img] = float("nan")
    cfg = TrainConfig(datapath="d", Nf=8, batch_size=64, net_H=32, net_Lp=4, net_Ld=2, num_iters=10,
                      train_im_idxs=idxs, backend=backend)
    model = NerfMLP(Lp=4, Ld=2, H=32)
    state = make_train_state(cfg, model, "cpu")
    step = build_train_step(cfg, model, rays_per_image=per_img)
    losses = [float(step(state, rays, pixels)) for _ in range(10)]
    assert np.isfinite(losses).all()
    with pytest.raises(ValueError, match="rays_per_image"):
        build_train_step(cfg, model)
