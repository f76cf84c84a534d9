"""The port's eval slice on CPU against the JAX package: the fused render
(B3) against the JAX Pallas kernel in interpret mode, the fused chunked
render against the unfused and plain paths, orbit poses, TestConfig, the
metric-depth loader, normals, and evaluate.test end to end (stills and
the orbit video); the device default of train() and evaluate.test.

Inputs are made with numpy from a seed and handed to both packages. On
CPU tensors the port's wrappers run their plain versions; the CUDA
kernels are held to those on the card (tests/test_torch_cuda.py). The
end-to-end comparisons replace both renderers' stratified sampler by bin
midpoints, so both packages render the same samples.

Tolerances: f32 kernel outputs, the JAX kernel test's bounds (rgb and acc
2e-4; depth, a sum of w*t with t up to 6, 1e-3). bf16: both round the
same operands, but an occasional activation rounds to the neighbouring
bf16 in another summation order (tests/test_torch_kernels.py): 2e-3 on
rgb. Written 8-bit images: within 1 level (a value on a rounding edge).
"""

import dataclasses
import glob
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.experimental.pallas import tpu as pltpu

import nerf_simple_tpu.config as jconfig
import nerf_simple_tpu.data.blender as jblender
import nerf_simple_tpu.data.synthetic as jsynth
import nerf_simple_tpu.kernels.mlp as jmlp
import nerf_simple_tpu.models.nerf as jnerf
import nerf_simple_tpu.ops.rays as jrays
import nerf_simple_tpu.render.renderer as jrenderer
from nerf_simple_tpu_torch import config
from nerf_simple_tpu_torch.data import blender
from nerf_simple_tpu_torch.kernels import mlp
from nerf_simple_tpu_torch.models.nerf import NerfField, NerfMLP, init_nerf_params
from nerf_simple_tpu_torch.ops.rays import orbit_poses, rays_for_poses
from nerf_simple_tpu_torch.render import renderer
from nerf_simple_tpu_torch.render.renderer import RenderSettings, render_rays_chunked

SMALL = NerfMLP(Lp=4, Ld=2, H=32)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_params(params):
    return {k: {n: jnp.asarray(a) for n, a in d.items()} for k, d in params.items()}


def _jm(model):
    return jnerf.NerfMLP(model.Lp, model.Ld, model.H)


def _x16(B, N, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.normal(0, 0.1, (B, 3))
    d = rng.normal(size=(B, 3))
    ts = np.sort(rng.uniform(2, 6, (B, N)), -1)
    x = np.zeros((16, B, N), np.float32)
    x[0:3] = o.T[:, :, None] + d.T[:, :, None] * ts[None]
    x[3:6] = (d / np.linalg.norm(d, axis=-1, keepdims=True)).T[:, :, None]
    x[6] = ts
    x[7:] = rng.uniform(-9, 9, (9, B, N))  # rows 7..15 are not read
    return x.reshape(16, B * N)


# --- B3: the fused render -------------------------------------------------------------

@pytest.mark.parametrize("dtype, jdtype", [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)],
                         ids=["f32", "bf16"])
def test_fused_render_matches_jax_kernel(dtype, jdtype):
    B, N = 8, 16
    params = init_nerf_params(3, SMALL)
    x = _x16(B, N, seed=3)
    before = mlp.fused_render.launches
    got = mlp.fused_render(mlp.pack_weights(NerfField.from_jax_params(params, "cpu")),
                           torch.from_numpy(x), N, dtype, SMALL).numpy()
    assert mlp.fused_render.launches == before  # CPU tensor: the plain version, no launch
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jmlp.fused_render(
            jmlp.pack_weights(_jax_params(params), model=_jm(SMALL)), jnp.asarray(x), N,
            tile_rows=B * N, compute_dtype=jdtype, model=_jm(SMALL)))
    assert got.shape == (8, B * N)
    heads = np.zeros(B * N, bool)
    heads[::N] = True
    np.testing.assert_array_equal(got[:, ~heads], 0.0)
    np.testing.assert_array_equal(got[5:], 0.0)
    if dtype == torch.float32:
        np.testing.assert_allclose(got[[0, 1, 2, 4]][:, heads], want[[0, 1, 2, 4]][:, heads], atol=2e-4)
        np.testing.assert_allclose(got[3, heads], want[3, heads], atol=1e-3)
    else:
        np.testing.assert_allclose(got[:3, heads], want[:3, heads], atol=2e-3)
    assert np.all(got[4, heads] > 0.99)  # the 1e10 tail delta: acc == 1


def test_fused_render_plain_matches_composite():
    """The plain render equals the plain forward plus the renderer's
    compositing (ops/volume.py) at the same samples."""
    B, N = 5, 12
    field = NerfField.from_jax_params(init_nerf_params(4, SMALL), "cpu")
    x = torch.from_numpy(_x16(B, N, seed=4))
    wts = mlp.pack_weights(field)
    got = mlp.fused_render_plain(wts, x, N, torch.float32, SMALL)
    out8 = mlp.fused_mlp_forward_plain(wts, x[:8].contiguous(), torch.float32, SMALL)
    from nerf_simple_tpu_torch.ops.volume import composite_T

    ref = composite_T(out8[:4].reshape(4, B, N), x[6].reshape(B, N), x[3:6, ::N].T)
    torch.testing.assert_close(got[:3, ::N].T, ref.rgb, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(got[3, ::N], ref.depth, atol=1e-5, rtol=1e-6)
    torch.testing.assert_close(got[4, ::N], ref.acc, atol=1e-6, rtol=1e-6)


def test_fused_render_rejects_bad_inputs():
    wts = mlp.pack_weights(NerfField(SMALL))
    x = torch.from_numpy(_x16(4, 8))
    with pytest.raises(ValueError, match="whole rays"):
        mlp.fused_render(wts, x, 7, torch.float32, SMALL)
    with pytest.raises(ValueError, match="appearance"):
        mlp.fused_render(wts, x, 8, torch.float32, NerfMLP(Lp=4, Ld=2, H=32, app_dim=4))
    with pytest.raises(ValueError, match="device"):
        mlp.fused_render(wts, x.to("meta"), 8, torch.float32, SMALL)


@pytest.mark.parametrize("model", [SMALL, NerfMLP()], ids=["small", "flagship"])
def test_fused_eval_chunked_matches_unfused_and_xla(model):
    """render_rays_chunked with fused_eval against the unfused pallas path
    and the xla path, same seed (mirrors tests/test_kernels.py:397-435)."""
    field = NerfField.from_jax_params(init_nerf_params(0, model), "cpu")
    rng = np.random.default_rng(9)
    rays = torch.from_numpy(np.concatenate([rng.normal(0, 0.1, (32, 3)), rng.normal(size=(32, 3))],
                                           -1).astype(np.float32))
    s = RenderSettings(N=16, backend="pallas", compute_dtype=torch.float32)
    fused = render_rays_chunked(field, rays, 1, dataclasses.replace(s, fused_eval=True), chunk=16)
    for other in (s, dataclasses.replace(s, backend="xla"),
                  dataclasses.replace(s, backend="xla", fused_eval=True)):  # xla ignores fused_eval
        rgb, disp = render_rays_chunked(field, rays, 1, other, chunk=16)
        np.testing.assert_allclose(fused[0].numpy(), rgb.numpy(), atol=2e-4)
        np.testing.assert_allclose(fused[1].numpy(), disp.numpy(), rtol=2e-3)


# --- poses, config, data -------------------------------------------------------------------

@pytest.mark.parametrize("r, theta, n", [(4.0, -30.0, 30), (3.5, 10.0, 7), (4.0, -30.0, 1)])
def test_orbit_poses_match_jax(r, theta, n):
    got = orbit_poses(r, theta, n)
    assert got.shape == (n, 4, 4)
    np.testing.assert_allclose(got, np.asarray(jrays.orbit_poses(r, theta, n)), atol=1e-6)
    if n > 1:
        np.testing.assert_allclose(got[0], got[-1], atol=1e-9)  # the endpoint is included


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml"))),
                         ids=os.path.basename)
def test_test_config_matches_jax(path):
    d = config.load_yaml(path)
    jd = yaml.load(open(path), Loader=yaml.FullLoader)
    tp = d["test_params"]
    unported = {k for k, v in tp.items() if k in config._TEST_UNPORTED
                and v != config._TEST_UNPORTED[k][0] and not (k == "num_data_shards" and v == 0)}
    unported |= {"dataset"} if tp.get("dataset") == "llff" else set()  # a ported key whose llff value is not
    if unported:
        with pytest.raises(NotImplementedError, match="not ported yet"):
            config.test_config_from_dict(d)
        return
    got = config.test_config_from_dict(d)
    want = jconfig.test_config_from_dict(jd)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_test_config_defaults_and_checks():
    jfields = {f.name: f.default for f in dataclasses.fields(jconfig.TestConfig)}
    for f in dataclasses.fields(config.TestConfig):
        assert f.default == jfields[f.name], f.name  # the JAX defaults
    base = {"loadpath": "m", "datapath": "d"}
    with pytest.raises(ValueError, match="needs mip=True"):  # the JAX TrainConfig's words
        config.test_config_from_dict({**base, "opaque_background": True})
    assert config.test_config_from_dict({**base, "mip": True, "opaque_background": True}).opaque_background
    assert config.test_config_from_dict({**base, "mip": True, "Np": 32}).Np == 32  # mip x proposal: ported
    with pytest.raises(ValueError, match="tn > 0"):
        config.test_config_from_dict({**base, "sampling_space": "disparity", "tn": 0.0})
    assert config.test_config_from_dict({**base, "num_data_shards": 0}).loadpath == "m"
    for key, value in (("num_data_shards", -1), ("llff_factor", 4), ("ndc", False)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            config.test_config_from_dict({**base, key: value})
    assert config.test_config_from_dict({**base, "occ_R": 32}).occ_R == 32  # ported: occupancy eval
    with pytest.raises(ValueError, match="Nc/occupancy"):  # JAX's rule (config.py:736-745)
        config.test_config_from_dict({**base, "occupancy": True, "mip": True})
    assert config.test_config_from_dict({**base, "Np": 32}).Np == 32  # ported: proposal eval
    with pytest.warns(UserWarning, match="unknown config key"):
        config.test_config_from_dict({**base, "heirarchical": 1})


@pytest.mark.parametrize("half_res", [False, True], ids=["full", "half"])
def test_metric_depth_loader_matches_jax(tmp_path, half_res):
    scene = str(tmp_path / "scene")
    jsynth.write_blender_scene(scene, n_train=2, n_val=1, n_test=2, H=16, W=16, write_depth=True)
    got, want = blender.load_blender(scene, half_res), jblender.load_blender(scene, half_res)
    for split in ("train", "val", "test"):
        g, w = got.splits[split].metric_depth, want.splits[split].metric_depth
        assert g.shape == w.shape == (len(w), 8 if half_res else 16, 8 if half_res else 16)
        np.testing.assert_allclose(g, w, rtol=1e-6)
    os.remove(os.path.join(scene, "depth", "test", "r_1.npy"))  # all or nothing
    with pytest.warns(UserWarning, match="missing"):
        assert blender.load_blender(scene, False).splits["test"].metric_depth is None


def test_synthetic_depth_matches_jax():
    from nerf_simple_tpu_torch.data import synthetic

    poses = synthetic.orbit_cameras(2)
    f = 16 / (2.0 * np.tan(synthetic._FOV_X / 2.0))
    _, got = synthetic.render_gt(poses, 16, 16, f, N=64, return_depth=True)
    _, want = jsynth.render_gt(poses, 16, 16, f, N=64, return_depth=True)
    np.testing.assert_allclose(got, want, atol=1e-4)


# --- the whole slice -------------------------------------------------------------------

@pytest.fixture
def midpoints(monkeypatch):
    """Both renderers sample bin midpoints; the JAX render caches are
    cleared before and after, so no program traced with the patch
    survives the test."""
    jorig, orig = jrenderer.stratified_ts_spaced, renderer.stratified_ts_spaced
    monkeypatch.setattr(jrenderer, "stratified_ts_spaced",
                        lambda *a, **k: jorig(*a, **{**k, "det": True}))
    monkeypatch.setattr(renderer, "stratified_ts_spaced",
                        lambda *a, **k: orig(*a, **{**k, "det": True}))
    jrenderer._chunked_render_fn.cache_clear()
    jrenderer._normals_chunk_fn.cache_clear()
    yield
    jrenderer._chunked_render_fn.cache_clear()
    jrenderer._normals_chunk_fn.cache_clear()


@pytest.fixture(scope="module")
def exp(tmp_path_factory):
    """A JAX-written params npz with its model.json beside a 20x20 scene
    with metric depth."""
    from nerf_simple_tpu.train.checkpoint import export_params_npz, save_model_meta

    root = tmp_path_factory.mktemp("eval")
    scene = str(root / "scene")
    jsynth.write_blender_scene(scene, n_train=2, n_val=1, n_test=2, H=20, W=20, write_depth=True)
    exp_dir = str(root / "exp")
    os.makedirs(exp_dir)
    export_params_npz(os.path.join(exp_dir, "params_7.npz"), _jax_params(init_nerf_params(5, SMALL)))
    save_model_meta(exp_dir, _jm(SMALL))
    return root, scene, os.path.join(exp_dir, "params_7.npz")


def _metrics(out: str) -> dict:
    return {int(m[0]): (float(m[1]), float(m[2])) for m in re.findall(
        r"im (\d+): mse=\S+ psnr=(\S+) ssim=(\S+)", out)}


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_evaluate_stills_match_jax(exp, midpoints, capsys, backend):
    import cv2

    from nerf_simple_tpu.evaluate import test as jtest

    from nerf_simple_tpu_torch.evaluate import test

    root, scene, params = exp
    cfg = dict(loadpath=params, datapath=scene, batch_size=256, half_res=False, im_idxs=[0, 1],
               N_samples=8, normals=True)
    jtest({**cfg, "savepath": str(root / "jax"), "exp_name": "e"})
    jout = capsys.readouterr().out
    test({**cfg, "savepath": str(root / backend), "exp_name": "e", "backend": backend}, device="cpu")
    out = capsys.readouterr().out
    got, want = _metrics(out), _metrics(jout)
    assert sorted(got) == sorted(want) == [0, 1]
    for i in (0, 1):
        assert abs(got[i][0] - want[i][0]) <= 0.01 and abs(got[i][1] - want[i][1]) <= 1e-3
        assert f"im {i}: depth_rmse=" in out
    assert re.findall(r"depth_rmse=(\S+)", out) == re.findall(r"depth_rmse=(\S+)", jout)
    for name in ("rgb_0", "rgb_1", "depth_0", "depth_1", "normal_0", "normal_1"):
        a = cv2.imread(str(root / backend / "e" / f"{name}.png"), cv2.IMREAD_UNCHANGED)
        b = cv2.imread(str(root / "jax" / "e" / f"{name}.png"), cv2.IMREAD_UNCHANGED)
        assert a.shape == b.shape == ((20, 40, 3) if name.startswith("rgb") else
                                      (20, 20) if name.startswith("depth") else (20, 20, 3))
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, name


def test_evaluate_orbit_video_holds_the_rendered_frames(exp, midpoints, capsys):
    from nerf_simple_tpu_torch.evaluate import test
    from nerf_simple_tpu_torch.utils.video import read_avi

    root, scene, params = exp
    test(dict(loadpath=params, datapath=scene, savepath=str(root / "anim"), exp_name="e",
              batch_size=256, half_res=False, animation=True, num_poses=4, theta=30,
              N_samples=8), device="cpu")
    out = capsys.readouterr().out
    assert "uncompressed RGB AVI" in out and "wrote " in out
    (path,) = glob.glob(str(root / "anim" / "e" / "nerf_rgb*.avi"))
    frames, fps = read_avi(path)
    assert frames.shape == (4, 20, 20, 3) and fps == 15
    from nerf_simple_tpu_torch.evaluate import load_params

    field = NerfField.from_jax_params(load_params(params), "cpu", SMALL)
    f = 20 / (2.0 * np.tan(0.6911112070083618 / 2.0))
    rays = rays_for_poses(torch.as_tensor(orbit_poses(4.0, -30.0, 4), dtype=torch.float32), 20, 20, f)
    for i, frame in enumerate(frames):
        rgb, _ = render_rays_chunked(field, rays[i * 400 : (i + 1) * 400], 0, RenderSettings(N=8),
                                     chunk=256)
        np.testing.assert_array_equal(frame, (rgb.reshape(20, 20, 3).numpy() * 255).astype(np.uint8))


def test_normals_match_jax(midpoints):
    params = init_nerf_params(6, SMALL)
    rng = np.random.default_rng(6)
    d = rng.normal(size=(64, 3))
    rays = np.concatenate([-4 * d / np.linalg.norm(d, axis=1, keepdims=True) + rng.normal(0, .2, (64, 3)),
                           d], 1).astype(np.float32)
    s = RenderSettings(N=16, backend="pallas")  # normals force the plain path, as in JAX
    got = renderer.render_normals_chunked(NerfField.from_jax_params(params, "cpu"),
                                          torch.from_numpy(rays), 0, s, chunk=40).numpy()
    import jax

    want = np.asarray(jrenderer.render_normals_chunked(
        _jax_params(params), jnp.asarray(rays), jax.random.PRNGKey(0),
        jrenderer.RenderSettings(N=16, backend="pallas"), _jm(SMALL), chunk=40))
    assert got.shape == (64, 3)
    assert np.linalg.norm(got, axis=1).max() <= 1 + 1e-6
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_load_params_resolves_experiment_dirs(tmp_path):
    from nerf_simple_tpu_torch.config import TrainConfig
    from nerf_simple_tpu_torch.evaluate import load_params
    from nerf_simple_tpu_torch.train import checkpoint as ckpt
    from nerf_simple_tpu_torch.train.step import make_train_state

    state = make_train_state(TrainConfig(datapath="d", net_H=32, net_Lp=4, net_Ld=2), SMALL, "cpu")
    for step in (3, 12):
        state.step = step
        ckpt.save_checkpoint(str(tmp_path), state)
    got = load_params(str(tmp_path))  # the latest ckpt_<step>.pth
    np.testing.assert_array_equal(got["trunk0"]["w"], state.field.to_jax_params()["trunk0"]["w"])
    np.testing.assert_array_equal(load_params(str(tmp_path / "ckpt_3.pth"))["color1"]["b"],
                                  got["color1"]["b"])
    ckpt.export_params_npz(str(tmp_path / "w.npz"), {"field": got, "cams": {"dr": np.zeros((2, 3))}})
    params, aux = load_params(str(tmp_path / "w.npz"), return_aux=True)
    assert "trunk0" in params and set(aux) == {"cams"}


def test_evaluate_rejects_pose_refined_checkpoints(exp, midpoints, tmp_path, capsys):
    """A pose-refined npz (the JAX ``{"field", "cams"}`` params): its train
    stills render from the refined poses, as the JAX ``evaluate.test``
    renders them (the PNGs to 1 level, the metrics); a delta table that
    does not cover the train split is rejected with JAX's message and the
    stills render unrefined, as with the field alone; test stills are
    never refined."""
    import cv2

    from nerf_simple_tpu.evaluate import test as jtest
    from nerf_simple_tpu.train.checkpoint import export_params_npz, save_model_meta

    from nerf_simple_tpu_torch.evaluate import load_params, test

    root, scene, params = exp
    field = load_params(params)
    rng = np.random.default_rng(3)
    paths = {}
    for name, n_img in (("fit", 2), ("short", 1)):
        d = tmp_path / name
        os.makedirs(d)
        export_params_npz(str(d / "params_1.npz"), {"field": field, "cams": {
            "dr": rng.normal(0, 0.05, (n_img, 3)).astype(np.float32),
            "dt": rng.normal(0, 0.1, (n_img, 3)).astype(np.float32)}})
        save_model_meta(str(d), _jm(SMALL))
        paths[name] = str(d / "params_1.npz")
    cfg = dict(datapath=scene, batch_size=256, half_res=False, im_set="train", im_idxs=[0, 1], N_samples=8,
               exp_name="e")

    def stills(where):
        return [cv2.imread(str(tmp_path / where / "e" / f"rgb_{i}.png"), cv2.IMREAD_UNCHANGED) for i in (0, 1)]

    jtest({**cfg, "loadpath": paths["fit"], "savepath": str(tmp_path / "jfit")})
    jout = capsys.readouterr().out
    test({**cfg, "loadpath": paths["fit"], "savepath": str(tmp_path / "fit_out")}, device="cpu")
    out = capsys.readouterr().out
    got, want = _metrics(out), _metrics(jout)
    for i in (0, 1):
        assert abs(got[i][0] - want[i][0]) <= 0.01 and abs(got[i][1] - want[i][1]) <= 1e-3
    for a, b in zip(stills("fit_out"), stills("jfit")):
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    test({**cfg, "loadpath": params, "savepath": str(tmp_path / "plain")}, device="cpu")
    test({**cfg, "loadpath": paths["short"], "savepath": str(tmp_path / "short_out")}, device="cpu")
    out = capsys.readouterr().out
    assert "pose deltas cover 1 train images but the split has 2; skipping eval-time refinement" in out
    for a, b, c in zip(stills("short_out"), stills("plain"), stills("fit_out")):
        assert (a == b).all() and (a != c).any()
    test({**cfg, "im_set": "test", "loadpath": paths["fit"], "savepath": str(tmp_path / "test_fit")}, device="cpu")
    test({**cfg, "im_set": "test", "loadpath": params, "savepath": str(tmp_path / "test_plain")}, device="cpu")
    for a, b in zip(stills("test_fit"), stills("test_plain")):
        assert (a == b).all()


# --- the device default ------------------------------------------------------------------

def test_entry_points_need_the_card_unless_asked_for_cpu(tmp_path):
    """train() and evaluate.test() default to the card; without one they
    raise and name --device cpu, where the JAX-free port would otherwise
    have run on the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    from nerf_simple_tpu_torch.evaluate import test
    from nerf_simple_tpu_torch.probes import pad_passes
    from nerf_simple_tpu_torch.train.loop import train

    with pytest.raises(RuntimeError, match="--device cpu"):
        train({"datapath": str(tmp_path), "savepath": str(tmp_path)})
    with pytest.raises(RuntimeError, match="--device cpu"):
        test({"loadpath": str(tmp_path), "datapath": str(tmp_path)})
    with pytest.raises(RuntimeError, match="--device cpu"):
        pad_passes.main([])
    assert not os.listdir(tmp_path)  # nothing ran
