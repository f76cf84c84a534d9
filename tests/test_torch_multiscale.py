"""The port's multiscale slice (mip-NeRF's multiscale training) on CPU
against the JAX package: the block-centred rays of a 1/s frame, the block
mean against cv2's INTER_AREA, the pyramid's ray pool, the mip train
step's input with per-ray radii and loss weights, B1's plain mip core
(one level, two levels, mip x proposal) against JAX's weighted loss
assembled from its XLA functions, the mip render with 8-column rays,
train() on the pyramid, and the config rules.

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs its XLA paths (no interpret-mode kernels), and the fine
edges are JAX's ``resample_edges(det=True)``, handed to both. The CUDA
kernels are held to the plain versions on the card
(tests/test_torch_cuda.py).

Tolerances:

- ``rays_for_poses_scaled``, the block mean against cv2, the pyramid
  arrays: f32 atol 1e-6 (the weights' mean rtol 1e-5, as JAX's own test,
  tests/test_mip.py:547).
- ``build_x16_mip`` against JAX's rows: f32 rtol 1e-5, atol 1e-6.
- The plain mip cores against JAX's weighted loss: f32 loss rtol 1e-4,
  gradients atol 1e-5 / rtol 2e-3 (tests/test_mip.py:592, :738 and
  tests/test_torch_mip.py).
- The mip render at the same edges: rgb and weights atol 1e-5.
"""

from __future__ import annotations

import dataclasses
import os
import re
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerf_simple_tpu.config as jconfig
import nerf_simple_tpu.data.blender as jblender
import nerf_simple_tpu.data.dataset as jdataset
import nerf_simple_tpu.models.nerf as jnerf
import nerf_simple_tpu.models.proposal as jproposal
import nerf_simple_tpu.ops.rays as jrays
import nerf_simple_tpu.ops.sampling as jsampling
import nerf_simple_tpu.ops.volume as jvolume
import nerf_simple_tpu.render.renderer as jrenderer
from nerf_simple_tpu_torch import config
from nerf_simple_tpu_torch.data import blender, dataset, synthetic
from nerf_simple_tpu_torch.models.nerf import NerfField, NerfMLP, init_nerf_params
from nerf_simple_tpu_torch.models.proposal import ProposalMLP, ProposalPair
from nerf_simple_tpu_torch.ops.rays import rays_for_poses_scaled
from nerf_simple_tpu_torch.render import renderer
from nerf_simple_tpu_torch.render.renderer import RenderSettings
from nerf_simple_tpu_torch.train import step as tstep
from nerf_simple_tpu_torch.train.loop import train

SMALL = NerfMLP(Lp=4, Ld=2, H=32)
B, N, NP = 8, 16, 8
RADIUS = 0.02


def _t(a):
    return torch.from_numpy(np.array(a))


def _jtree(params):
    if isinstance(params, dict):
        return {k: _jtree(v) for k, v in params.items()}
    return jnp.asarray(params)


def _grads(field):
    return {name: {"w": getattr(field, name).weight.grad.numpy().T,
                   "b": getattr(field, name).bias.grad.numpy()} for name in field.model.layer_dims()}


def _assert_grads(got, want):
    for layer in want:
        for k in ("w", "b"):
            np.testing.assert_allclose(got[layer][k], np.asarray(want[layer][k]), atol=1e-5, rtol=2e-3,
                                       err_msg=f"{layer}/{k}")


def _rays8(n, seed):
    """(n, 8) rays from a radius-4 shell towards the origin, each with a
    cone radius in [0.005, 0.06] and a loss weight in [0.25, 4]; their gt
    colours."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    o = -4.0 * d / np.linalg.norm(d, axis=1, keepdims=True) + rng.normal(0, 0.2, (n, 3))
    rays = np.concatenate([o, d, rng.uniform(0.005, 0.06, (n, 1)), rng.uniform(0.25, 4.0, (n, 1))], 1)
    return rays.astype(np.float32), rng.uniform(0, 1, (n, 3)).astype(np.float32)


def _edges(n, N_, seed):
    return np.sort(np.random.default_rng(seed).uniform(2.0, 6.0, (n, N_ + 1)), -1).astype(np.float32)


# --- the pyramid -----------------------------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 2, 4, 8])
def test_rays_for_poses_scaled_matches_jax(s):
    """Block-centred rays of a 1/s frame (pixel i at full-resolution
    coordinate s*i + (s-1)/2) against JAX's; at s = 1 the plain rays."""
    poses = synthetic.orbit_cameras(3, seed_jitter=2)
    got = rays_for_poses_scaled(_t(poses), 24, 32, 30.0, s).numpy()
    want = np.asarray(jrays.rays_for_poses_scaled(jnp.asarray(poses), 24, 32, 30.0, s))
    assert got.shape == (3 * (24 // s) * (32 // s), 6)
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("s", [2, 4, 8])
def test_block_mean_matches_cv2_inter_area(s):
    """The s x s block mean against cv2.resize(INTER_AREA) on seeded f32
    images (3 channels and 1), and at s = 2 bit-equal to ``half``; sides
    that s does not divide raise."""
    rng = np.random.default_rng(s)
    for shape in ((40, 24, 3), (16, 32)):
        img = rng.uniform(0, 1, shape).astype(np.float32)
        want = cv2.resize(img, (shape[1] // s, shape[0] // s), interpolation=cv2.INTER_AREA)
        got = blender.block_mean(img, s)
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-6)
        if s == 2:
            assert np.array_equal(got, blender.half(img))
    with pytest.raises(ValueError, match="divisible"):
        blender.block_mean(np.zeros((12, 10, 3), np.float32), 8)


@pytest.fixture(scope="module")
def scene16(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ms16"))
    synthetic.write_blender_scene(d, n_train=2, n_val=1, n_test=1, H=16, W=16)
    return d


def test_multiscale_train_arrays_match_jax(scene16):
    """The pyramid pool against JAX's ``multiscale_train_arrays`` (cv2
    INTER_AREA there) on a 16x16 scene, then its layout (JAX
    tests/test_mip.py:547): rows a scale in order 1, 2, 4, 8, radii s *
    base, loss weights of mean 1 with the scale-8 rays 64 times the
    scale-1 rays, the first scale-2 direction the mean of the first 2x2
    block of full-resolution directions."""
    base = 0.01
    got_r, got_p = dataset.multiscale_train_arrays(blender.load_blender(scene16, half_res=False), base)
    want_r, want_p = jdataset.multiscale_train_arrays(jblender.load_blender(scene16, half_res=False), base)
    r = got_r.numpy()
    np.testing.assert_allclose(r, np.asarray(want_r), atol=1e-6)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=1e-6)
    P, HW = 2, 16 * 16
    n = P * (HW + HW // 4 + HW // 16 + HW // 64)
    assert r.shape == (n, 8) and got_p.shape == (n, 3) and got_r.dtype == got_p.dtype == torch.float32
    ofs = 0
    for s in dataset.MULTISCALE_SCALES:
        n_s = P * HW // (s * s)
        np.testing.assert_allclose(r[ofs : ofs + n_s, 6], s * base, rtol=1e-6)
        assert np.all(r[ofs : ofs + n_s, 7] == r[ofs, 7])
        ofs += n_s
    np.testing.assert_allclose(r[:, 7].mean(), 1.0, rtol=1e-5)
    np.testing.assert_allclose(r[-1, 7] / r[0, 7], 64.0, rtol=1e-5)
    full = r[: P * HW, 3:6].reshape(P, 16, 16, 3)
    half = r[P * HW : P * HW + P * HW // 4, 3:6].reshape(P, 8, 8, 3)
    np.testing.assert_allclose(half[0, 0, 0], full[0, :2, :2].mean((0, 1)), atol=1e-6)


def test_multiscale_rejects_nondivisible_resolution():
    """Sides that 8 does not divide would shear the coarse scales' rays off
    the block centres (JAX tests/test_mip.py:218)."""
    split = blender.BlenderSplit(np.zeros((1, 100, 100, 3), np.float32), np.eye(4)[None].astype(np.float32))
    with pytest.raises(ValueError, match="divisible"):
        dataset.multiscale_train_arrays(blender.BlenderData({"train": split}, 100, 100, 50.0), 0.01)


# --- the step's input and B1's plain mip cores -------------------------------------------------------------------

def test_build_x16_mip_with_8_column_rays_matches_jax():
    """``build_x16_mip`` of 8-column rays against JAX's ``_build_x16_mip``
    rows (train/step.py:648-665), assembled from its public
    ``frustum_gaussians_T`` with the (B, 1) radii of column 6: means,
    unit dirs, widths, near edges, gt, variances, and column 7 broadcast
    on row 14; 6-column rays equal 8-column rays of radius ``base_radius``
    and weight 1."""
    rays, pix = _rays8(B, 1)
    edges = _edges(B, N, 2)
    got = tstep.build_x16_mip(_t(rays), _t(edges), _t(pix), RADIUS).numpy().reshape(16, B, N)
    jr, je = jnp.asarray(rays), jnp.asarray(edges)
    meanT, unitT, varT, _ = jsampling.frustum_gaussians_T(jr, je, jr[:, 6][:, None], "cone")
    want = np.zeros((16, B, N), np.float32)
    want[0:3], want[3:6], want[11:14] = np.asarray(meanT), np.asarray(unitT)[:, :, None], np.asarray(varT)
    want[6], want[7] = edges[:, 1:] - edges[:, :-1], edges[:, :-1]
    want[8:11] = pix.T[:, :, None]
    want[14] = rays[:, 7:8]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    six = tstep.build_x16_mip(_t(rays[:, :6]), _t(edges), _t(pix), RADIUS)
    eight = rays.copy()
    eight[:, 6], eight[:, 7] = RADIUS, 1.0
    assert torch.equal(six, tstep.build_x16_mip(_t(eight), _t(edges), _t(pix), 0.5))


def _jwmse(rgb, rays, pix):
    return jnp.mean(rays[:, 7:8] * (rgb - pix) ** 2)


def _jsettings(**kw):
    return jrenderer.RenderSettings(N=N, tn=2.0, tf=6.0, mip=True, base_radius=0.5, **kw)


@pytest.mark.parametrize("levels", [1, 2], ids=["one-level", "two-level"])
def test_plain_b1_mip_core_with_per_ray_weights_matches_jax(levels):
    """``mip_fused_loss`` on 8-column rays (B1's plain version on CPU, row
    14 the rays' loss weights, rows 11..13 their own cones) against JAX's
    XLA loss of the same batch (train/step.py:548-560, :587-589): one
    level's weighted MSE, or ``0.1 coarse + fine`` at JAX's fine edges;
    f32 loss and gradients. ``base_radius`` is a decoy: column 6 rules."""
    cw = 0.1
    params = init_nerf_params(3, SMALL)
    rays, pix = _rays8(B, 4)
    edges = _edges(B, N, 5)
    jr, jpix, je, jm = jnp.asarray(rays), jnp.asarray(pix), jnp.asarray(edges), jnerf.NerfMLP(4, 2, 32)
    js = _jsettings()
    edges_f = None
    if levels == 2:
        out_c = jrenderer._mip_level(_jtree(params), jr, je, js, jm)
        edges_f = jsampling.resample_edges(jax.random.PRNGKey(0), je, out_c.weights, N, det=True)

    def jax_loss(p):
        loss = _jwmse(jrenderer._mip_level(p, jr, je, js, jm).rgb, jr, jpix)
        if levels == 2:
            loss = cw * loss + _jwmse(jrenderer._mip_level(p, jr, edges_f, js, jm).rgb, jr, jpix)
        return loss

    jloss, want = jax.jit(jax.value_and_grad(jax_loss))(_jtree(params))
    field = NerfField.from_jax_params(params, "cpu")
    loss = tstep.mip_fused_loss(field, _t(rays), _t(pix), _t(edges), None, torch.float32, SMALL, 0.5,
                                mip_levels=levels, coarse_weight=cw,
                                edges_fine=None if edges_f is None else _t(np.asarray(edges_f)))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    _assert_grads(_grads(field), want)


def test_plain_b1_mip_proposal_core_with_per_ray_weights_matches_jax():
    """``mip_proposal_fused_loss`` on 8-column rays (one plain B1 launch
    with row 14's weights, the opaque tail) against JAX's fused mip x
    proposal core's loss assembled from its XLA functions: the weighted
    MSE of ``_mip_level`` at the fine edges JAX resamples from the
    proposal's interval weights, plus the interval interlevel loss; f32,
    the main field's and the proposal net's gradients."""
    jm, jpm = jnerf.NerfMLP(4, 2, 32), jproposal.ProposalMLP(Lp=4, D=2, H=16)
    params = {"fine": jax.tree.map(np.asarray, jnerf.init_nerf_params(jax.random.PRNGKey(6), jm)),
              "prop": jax.tree.map(np.asarray, jproposal.init_proposal_params(jax.random.PRNGKey(7), jpm))}
    rays, pix = _rays8(B, 8)
    edges_p = _edges(B, NP, 9)
    jr, jpix, jep = jnp.asarray(rays), jnp.asarray(pix), jnp.asarray(edges_p)
    js = _jsettings(opaque_background=True)
    w_prop = jproposal.proposal_weights_intervals(_jtree(params["prop"]), jr, jep, jpm, jnp.float32, opaque_tail=True)
    edges_f = jsampling.resample_edges(jax.random.PRNGKey(0), jep, w_prop, N, det=True)
    mids_f = 0.5 * (edges_f[:, 1:] + edges_f[:, :-1])

    def jax_loss(p):
        out = jrenderer._mip_level(p["fine"], jr, edges_f, js, jm)
        wp = jproposal.proposal_weights_intervals(p["prop"], jr, jep, jpm, jnp.float32, opaque_tail=True)
        return _jwmse(out.rgb, jr, jpix) + jvolume.interlevel_loss_intervals(
            jax.lax.stop_gradient(out.weights), mids_f, wp, jep, opaque_tail=True)

    jloss, want = jax.jit(jax.value_and_grad(jax_loss))(_jtree(params))
    pair = ProposalPair.from_jax_params(params, "cpu", SMALL, ProposalMLP(Lp=4, D=2, H=16))
    loss, w_f = tstep.mip_proposal_fused_loss(pair, _t(rays), _t(pix), _t(edges_p), None, N, torch.float32, SMALL,
                                              0.5, opaque_tail=True, edges_f=_t(np.asarray(edges_f)))
    assert w_f.shape == (B, N)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    _assert_grads(_grads(pair.fine), want["fine"])
    for name in pair.prop.to_jax_params():
        np.testing.assert_allclose(getattr(pair.prop, name).weight.grad.T.numpy(), np.asarray(want["prop"][name]["w"]),
                                   atol=1e-5, rtol=2e-3, err_msg=name)


@pytest.mark.parametrize("levels", [1, 2], ids=["one-level", "two-level"])
def test_autograd_mip_loss_weights_each_ray(levels):
    """``autograd_loss``'s mip branch on 8-column rays (the path of sigma
    noise or depth under multiscale) equals the plain fused core: the
    same weighted MSE at one level and at both (JAX :557-560, :587-589)."""
    cfg = config.TrainConfig(datapath="d", Nf=N, mip=True, mip_levels=levels, mip_multiscale=True, batch_size=B,
                             net_H=32, net_Lp=4, net_Ld=2)
    params = init_nerf_params(10, SMALL)
    rays, pix = _rays8(B, 11)
    edges = _t(_edges(B, N, 12))
    edges_f = _t(_edges(B, N, 13)) if levels == 2 else None
    f1, f2 = (NerfField.from_jax_params(params, "cpu") for _ in range(2))
    loss = tstep.autograd_loss(cfg, f1, _t(rays), _t(pix), edges, None, tstep.render_settings(cfg, 0.5),
                               edges_fine=edges_f)
    loss.backward()
    want = tstep.mip_fused_loss(f2, _t(rays), _t(pix), edges, None, torch.float32, SMALL, 0.5, mip_levels=levels,
                                edges_fine=edges_f)
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    _assert_grads(_grads(f1), _grads(f2))


# --- the render ----------------------------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_mip_render_and_chunked_render_take_the_rays_radii(backend):
    """One mip level of 8-column rays against JAX's ``_mip_level`` (which
    reads column 6, render/renderer.py:263) at the same edges; a chunked
    frame of 8-column rays equals, chunk by chunk, the 6-column frame at
    the settings' radius set to the chunk's (JAX :919); normals drop the
    extra columns (JAX :1032)."""
    params = init_nerf_params(14, SMALL)
    field = NerfField.from_jax_params(params, "cpu")
    rays, _ = _rays8(100, 15)
    edges = _edges(100, N, 16)
    s = RenderSettings(N=N, mip=True, mip_levels=2, base_radius=RADIUS, backend=backend)
    with torch.no_grad():
        got = renderer._mip_level(field, _t(rays), _t(edges), s)
    want = jrenderer._mip_level(_jtree(params), jnp.asarray(rays), jnp.asarray(edges), _jsettings(),
                                jnerf.NerfMLP(4, 2, 32))
    np.testing.assert_allclose(got.rgb.numpy(), np.asarray(want.rgb), atol=1e-5)
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights), atol=1e-5)
    r8 = rays.copy()
    r8[:50, 6], r8[50:, 6] = 0.01, 0.04
    rgb, disp = renderer.render_rays_chunked(field, _t(r8), 3, s, chunk=50)
    assert rgb.shape == (100, 3) and torch.isfinite(disp).all()
    for sl, radius in ((slice(0, 50), 0.01), (slice(50, 100), 0.04)):
        want_rgb, want_disp = renderer.render_rays_chunked(field, _t(rays[:, :6]), 3,
                                                           dataclasses.replace(s, base_radius=radius), chunk=50)
        assert torch.equal(rgb[sl], want_rgb[sl]) and torch.equal(disp[sl], want_disp[sl])
    assert torch.equal(renderer.render_normals_chunked(field, _t(r8), 3, s, chunk=50),
                       renderer.render_normals_chunked(field, _t(rays[:, :6]), 3, s, chunk=50))


# --- train() and the config -----------------------------------------------------------------------------------

def test_train_multiscale_on_cpu(tmp_path, capsys, monkeypatch):
    """train() with ``mip_multiscale`` on a 24x24 scene (JAX
    tests/test_mip.py:650): the step draws 8-column rays from the 4-scale
    pool (its fused core, B1's plain version, sees them), the loss falls,
    the val render and the exports are a mip run's; then 10 steps of mip x
    proposal on the pyramid."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # CSV logging, as on the card's machine
    scene = str(tmp_path / "scene")
    synthetic.write_blender_scene(scene, n_train=4, n_val=1, n_test=1, H=24, W=24)
    seen = []
    for name in ("mip_fused_loss", "mip_proposal_fused_loss"):
        real = getattr(tstep, name)
        monkeypatch.setattr(tstep, name, lambda *a, _real=real, **k: seen.append(tuple(a[1].shape)) or _real(*a, **k))
    base = dict(datapath=scene, savepath=str(tmp_path / "models"), Nf=16, mip=True, mip_multiscale=True,
                net_Lp=4, net_Ld=2, net_H=32, batch_size=128, half_res=False, backend="pallas", compute_dtype="f32",
                ckpt_loss=1, ckpt_model=10**6, log_dir=str(tmp_path / "logs"))
    state = train({**base, "exp_name": "ms", "mip_levels": 2, "num_iters": 60, "steps_per_call": 20,
                   "ckpt_images": 59, "val_idxs": [0]}, device="cpu")
    out = capsys.readouterr().out
    losses = [float(v) for v in re.findall(r"loss: ([0-9.]+)", out)]
    assert state.step == 60 and len(losses) == 60 and seen == [(128, 8)] * 60
    assert np.mean(losses[-10:]) < 0.7 * np.mean(losses[:10])
    assert "Val image 0 | iter: 60" in out
    assert os.path.exists(str(tmp_path / "models" / "ms" / "params_60.pth"))
    seen.clear()
    state = train({**base, "exp_name": "ms_prop", "proposal": True, "Np": 8, "prop_Lp": 4, "prop_D": 2,
                   "prop_H": 16, "opaque_background": True, "num_iters": 10, "steps_per_call": 5,
                   "ckpt_images": 10**6}, device="cpu")
    assert state.step == 10 and seen == [(128, 8)] * 10


RULES = {  # JAX config.py:392-413, :557-560
    "no-mip": (dict(), "requires mip=True"),
    "depth": (dict(mip=True, depth_loss_weight=0.1), "depth supervision"),
    "train_im_idxs": (dict(mip=True, train_im_idxs=(0,)), "incompatible with train_im_idxs"),
    "tiny_nerf": (dict(mip=True, dataset="tiny_nerf"), "needs dataset=blender"),
    "pose": (dict(mip=True, pose_opt=True), "pose_opt cannot combine with mip_multiscale"),
    "appearance": (dict(mip=True, appearance_dim=4), "appearance_dim > 0 cannot combine with mip_multiscale"),
}


@pytest.mark.parametrize("rule", list(RULES))
def test_multiscale_config_rules_raise_as_jax(rule):
    """Each combination JAX refuses with mip_multiscale raises JAX's
    ValueError in both packages; lego_mip.yaml + mip_multiscale loads, at
    one level and with proposal."""
    kw, match = RULES[rule]
    for mod in (config, jconfig):
        with pytest.raises(ValueError, match=match):
            mod.TrainConfig(datapath="d", mip_multiscale=True, **kw)
    d = config.load_yaml("configs/lego_mip.yaml")
    assert config.train_config_from_dict({**d, "mip_multiscale": True}).mip_multiscale
    assert config.train_config_from_dict({**d, "mip_multiscale": True, "mip_levels": 1, "proposal": True}).proposal
    assert dataset.MULTISCALE_SCALES == jdataset.MULTISCALE_SCALES
