"""The port's training regularisers on CPU against the JAX package: sigma
noise on raw sigma, the masked depth L2 and the point-form distortion
loss in s-space; B1's distortion rail (its plain version, as the wrapper
runs it on CPU tensors) against the JAX Pallas kernel in interpret mode;
the autograd loss against JAX's assembled from its public functions; the
config keys; train() with each regulariser.

Inputs are made with numpy from a seed and handed to both packages; the
sigma noise is drawn as JAX draws it (``jax.random.normal(fold_in(key,
1), (B, N))``) and handed to the port. The CUDA rail is held to the plain
version on the card (tests/test_torch_cuda.py).

Tolerances (those of tests/test_torch_hierarchical.py):

- ``distortion_loss``: f32 against JAX, rtol 1e-5 (the same cumsums);
  against the O(N^2) float64 oracle, atol 1e-5 (JAX's own bound,
  tests/test_volume.py).
- B1 with the rail: f32, loss rtol 1e-4, field gradients atol 1e-5 /
  rtol 2e-3 (JAX's kernel test bounds); bf16, loss rtol 1e-3, each
  gradient tensor within 2e-2 of its largest entry.
- The autograd losses and renders, f32: loss rtol 1e-5 (rgb, weights atol
  1e-5); gradients atol 1e-5 / rtol 2e-3.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import nerf_simple_tpu.config as jconfig
import nerf_simple_tpu.kernels.mlp as jmlp
import nerf_simple_tpu.models.nerf as jnerf
import nerf_simple_tpu.ops.volume as jvolume
import nerf_simple_tpu.render.renderer as jrenderer
from nerf_simple_tpu_torch import config
from nerf_simple_tpu_torch.kernels import mlp
from nerf_simple_tpu_torch.models.nerf import NerfField, NerfMLP, NerfPair, init_nerf_params
from nerf_simple_tpu_torch.ops import volume
from nerf_simple_tpu_torch.render import renderer
from nerf_simple_tpu_torch.render.renderer import RenderSettings
from nerf_simple_tpu_torch.train.loop import train
from nerf_simple_tpu_torch.train.step import (
    autograd_loss,
    build_train_step,
    build_x16,
    make_train_state,
    render_settings,
)

SMALL = NerfMLP(Lp=4, Ld=2, H=32)
B, N, NC, NF = 8, 16, 8, 16
TN, TF, LAM = 2.0, 6.0, 0.05
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]
DTYPE_IDS = ["f32", "bf16"]
BF16_GRAD_TOL, BF16_LOSS_RTOL = 2e-2, 1e-3


def _jax(params):
    if "coarse" in params:
        return {k: _jax(v) for k, v in params.items()}
    return {k: {n: jnp.asarray(a) for n, a in d.items()} for k, d in params.items()}


def _jm(model):
    return jnerf.NerfMLP(model.Lp, model.Ld, model.H)


def _field_grads(field):
    if isinstance(field, NerfPair):
        return {k: _field_grads(getattr(field, k)) for k in ("coarse", "fine")}
    return {name: {"w": getattr(field, name).weight.grad.numpy().T,
                   "b": getattr(field, name).bias.grad.numpy()} for name in field.model.layer_dims()}


def _assert_grads(got, want, dt=torch.float32):
    if "coarse" in want:
        for k in ("coarse", "fine"):
            _assert_grads(got[k], want[k], dt)
        return
    for layer in want:
        for k in ("w", "b"):
            g, w = got[layer][k], np.asarray(want[layer][k])
            if dt == torch.float32:
                np.testing.assert_allclose(g, w, atol=1e-5, rtol=2e-3, err_msg=f"{layer}/{k}")
            else:
                err = np.abs(g - w).max() / np.abs(w).max()
                assert err <= BF16_GRAD_TOL, (layer, k, err)


def _rays(n, seed):
    """Rays from a radius-4 shell towards the origin, their gt colours."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    o = -4.0 * d / np.linalg.norm(d, axis=1, keepdims=True) + rng.normal(0, 0.2, (n, 3))
    return (np.concatenate([o, d], 1).astype(np.float32),
            rng.uniform(0, 1, (n, 3)).astype(np.float32))


def _ts(n, N, seed):
    return np.sort(np.random.default_rng(seed).uniform(TN, TF, (n, N)), -1).astype(np.float32)


def _jax_s_norm(ts, disparity):
    """JAX ``train/step.py::_s_norm`` (a closure of ``build_train_step``)."""
    if disparity:
        return (1.0 / TN - 1.0 / jnp.maximum(ts, 1e-10)) / (1.0 / TN - 1.0 / TF)
    return (ts - TN) / (TF - TN)


def _jax_depth_term(out, gt_d):
    """JAX ``train/step.py::_depth_term`` (a closure of ``build_train_step``)."""
    valid = jnp.isfinite(gt_d) & (gt_d > 0)
    sq = jnp.where(valid, (out.depth - gt_d) ** 2, 0.0)
    return jnp.sum(sq) / jnp.maximum(jnp.sum(valid), 1)


# --- the distortion loss -------------------------------------------------------------

def test_distortion_loss_matches_jax_and_the_quadratic_oracle():
    """The O(N) cumsum form against JAX's and against the literal O(N^2)
    mip-NeRF 360 eqn. 15 in float64 (JAX tests/test_volume.py:55), the
    tail sample left out of both."""
    rng = np.random.default_rng(0)
    b, n = 7, 33
    ts = np.sort(rng.uniform(2, 6, (b, n)), axis=-1)
    w = rng.uniform(0, 0.2, (b, n))
    wo, mo = w[:, :-1], ts[:, :-1]
    d = ts[:, 1:] - ts[:, :-1]
    cross = np.einsum("bi,bj,bij->b", wo, wo, np.abs(mo[:, :, None] - mo[:, None, :]))
    want = float(np.mean(cross + np.sum(wo * wo * d, -1) / 3.0))
    w32, ts32 = w.astype(np.float32), ts.astype(np.float32)
    got = float(volume.distortion_loss(torch.from_numpy(w32), torch.from_numpy(ts32)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, float(jvolume.distortion_loss(jnp.asarray(w32), jnp.asarray(ts32))), rtol=1e-5)


def test_distortion_loss_ignores_the_tail_sample_and_penalises_fog():
    """Mass on the tail sample (the 1e10 absorber) adds nothing (JAX
    tests/test_volume.py:95); one surface scores far below the same mass
    spread along the ray."""
    ts = torch.linspace(2, 6, 64).expand(1, 64)
    w = torch.zeros(1, 64)
    w[0, 10] = 0.3
    tail = w.clone()
    tail[0, -1] = 0.7
    assert float(volume.distortion_loss(tail, ts)) == float(volume.distortion_loss(w, ts))
    surface = torch.zeros(1, 64)
    surface[0, 30] = 0.9
    fog = torch.full((1, 64), 0.9 / 63)
    fog[0, -1] = 0.0
    assert float(volume.distortion_loss(fog, ts)) > 20 * float(volume.distortion_loss(surface, ts))


@pytest.mark.parametrize("disparity", [False, True], ids=["linear", "disparity"])
def test_s_norm_matches_jax(disparity):
    ts = _ts(B, N, 1)
    got = volume.s_norm(torch.from_numpy(ts), TN, TF, disparity).numpy()
    want = np.asarray(_jax_s_norm(jnp.asarray(ts), disparity))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert got.min() >= -1e-6 and got.max() <= 1 + 1e-6


# --- B1's distortion rail ---------------------------------------------------------------

def _x16(rays, pix, ts):
    return build_x16(*(torch.from_numpy(np.array(a)) for a in (rays, ts, pix)))


@pytest.mark.parametrize("dt, jdt", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("disparity", [False, True], ids=["linear", "disparity"])
def test_fused_train_step_distortion_matches_jax(disparity, dt, jdt):
    """B1 with ``dist`` (its plain version, as the wrapper runs it on CPU)
    against the JAX kernel in interpret mode: loss and gradients; the
    rail's weight gradient is exactly 0 at the tail."""
    params = init_nerf_params(0, SMALL)
    rays, pix = _rays(B, 1)
    ts = _ts(B, N, 2)
    x = _x16(rays, pix, ts)
    dist = (LAM, TN, TF, disparity)
    with pltpu.force_tpu_interpret_mode():
        wts, vjp = jax.vjp(lambda p: jmlp.pack_weights(p, model=_jm(SMALL)), _jax(params))
        jloss, jdw = jmlp.fused_train_step(wts, jnp.asarray(x.numpy()), N, B * N, jdt, model=_jm(SMALL),
                                           dist=dist)
        want = vjp(jdw)[0]
    field = NerfField.from_jax_params(params, "cpu")
    packed = mlp.pack_weights(field, differentiable=True)
    mlp.fused_train_step.dist_launches = 0
    loss, dw = mlp.fused_train_step(packed, x, N, dt, SMALL, dist=dist)
    assert mlp.fused_train_step.dist_launches == 0  # CPU tensor: the plain version
    torch.autograd.backward(list(packed), list(dw))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4 if dt == torch.float32 else BF16_LOSS_RTOL)
    _assert_grads(_field_grads(field), want, dt)
    loss0 = mlp.fused_train_step(mlp.pack_weights(field), x, N, dt, SMALL)[0]
    assert float(loss) > float(loss0)  # the rail adds a non-negative term
    w = torch.from_numpy(np.random.default_rng(3).uniform(0, 0.3, (B, N)).astype(np.float32))
    _, d_w = mlp._distortion_rail(w, volume.s_norm(torch.from_numpy(ts), TN, TF, disparity))
    assert bool((d_w[:, -1] == 0).all()) and bool((d_w[:, :-1] != 0).any())


@pytest.mark.parametrize("disparity", [False, True], ids=["linear", "disparity"])
def test_fused_train_step_distortion_matches_autograd(disparity):
    """B1's plain version with ``dist`` against autograd of MSE + lambda *
    distortion_loss(weights, s_norm(ts)) through the render path (JAX
    tests/test_kernels.py:221 holds its kernel so), at the flagship
    width, f32."""
    model = NerfMLP()
    params = init_nerf_params(0, model)
    rays, pix = _rays(B, 5)
    ts = _ts(B, N, 6)
    field = NerfField.from_jax_params(params, "cpu")
    packed = mlp.pack_weights(field, differentiable=True)
    loss, dw = mlp.fused_train_step(packed, _x16(rays, pix, ts), N, torch.float32, model,
                                    dist=(LAM, TN, TF, disparity))
    torch.autograd.backward(list(packed), list(dw))
    got = _field_grads(field)
    ref = NerfField.from_jax_params(params, "cpu")
    tts = torch.from_numpy(ts)
    out = renderer.render_rays(ref, torch.from_numpy(rays), None, RenderSettings(N=N), ts=tts)
    want_loss = (torch.mean((out.rgb - torch.from_numpy(pix)) ** 2)
                 + LAM * volume.distortion_loss(out.weights, volume.s_norm(tts, TN, TF, disparity)))
    want_loss.backward()
    np.testing.assert_allclose(float(loss), want_loss.item(), rtol=1e-4)
    _assert_grads(got, _field_grads(ref))


# --- sigma noise in the render ----------------------------------------------------------

@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_render_rays_sigma_noise_matches_jax(backend):
    """The noise JAX draws, handed to the port: rgb and weights as JAX's
    render (its xla path; the port's pallas path runs the forward kernel's
    plain version). With sigma_noise = 0 nothing is drawn: the result and
    the generator's stream are those of the default settings."""
    params = init_nerf_params(2, SMALL)
    rays, _ = _rays(B, 3)
    ts = _ts(B, N, 4)
    key = jax.random.PRNGKey(5)
    jout = jrenderer.render_rays(_jax(params), jnp.asarray(rays), key,
                                 jrenderer.RenderSettings(N=N, sigma_noise=0.5), _jm(SMALL), ts=jnp.asarray(ts))
    noise = torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(key, 1), (B, N))))
    field = NerfField.from_jax_params(params, "cpu")
    with torch.no_grad():
        got = renderer.render_rays(field, torch.from_numpy(rays), None,
                                   RenderSettings(N=N, sigma_noise=0.5, backend=backend), ts=torch.from_numpy(ts),
                                   noise=noise)
        np.testing.assert_allclose(got.rgb.numpy(), np.asarray(jout.rgb), atol=1e-5)
        np.testing.assert_allclose(got.weights.numpy(), np.asarray(jout.weights), atol=1e-5)
        g0, g1 = torch.Generator(), torch.Generator()
        g0.manual_seed(7)
        g1.manual_seed(7)
        base = renderer.render_rays(field, torch.from_numpy(rays), g0, RenderSettings(N=N, backend=backend))
        off = renderer.render_rays(field, torch.from_numpy(rays), g1,
                                   RenderSettings(N=N, backend=backend, sigma_noise=0.0))
        assert torch.equal(base.rgb, off.rgb) and torch.equal(base.weights, off.weights)
        assert torch.equal(g0.get_state(), g1.get_state())
        on = renderer.render_rays(field, torch.from_numpy(rays), g1,
                                  RenderSettings(N=N, backend=backend, sigma_noise=1.0))
        assert not torch.allclose(on.weights, base.weights) and bool(torch.isfinite(on.rgb).all())
    with pytest.raises(ValueError, match="generator"):
        renderer.render_rays(field, torch.from_numpy(rays), None, RenderSettings(N=N, sigma_noise=1.0))


def test_hierarchical_render_applies_no_noise_and_returns_its_ts():
    """As in JAX, the hierarchical render ignores sigma_noise; with
    ``return_ts`` it hands back the coarse ts and the union."""
    pair = NerfPair.from_jax_params({"coarse": init_nerf_params(0, SMALL), "fine": init_nerf_params(1, SMALL)},
                                    "cpu")
    rays = torch.from_numpy(_rays(B, 2)[0])
    ts_c = torch.from_numpy(_ts(B, NC, 3))
    with torch.no_grad():
        outs = [renderer.render_rays_hierarchical(pair.coarse, pair.fine, rays, None,
                                                  RenderSettings(N=NF, N_coarse=NC, sigma_noise=s), det_fine=True,
                                                  ts_coarse=ts_c, return_ts=True) for s in (0.0, 1.0)]
    (c0, f0, (t0, u0)), (c1, f1, (t1, u1)) = outs
    assert torch.equal(c0.rgb, c1.rgb) and torch.equal(f0.weights, f1.weights)
    assert torch.equal(t0, ts_c) and u0.shape == (B, NC + NF) and torch.equal(u0, u1)
    assert bool((u0[:, 1:] >= u0[:, :-1]).all())


# --- the autograd loss against JAX's loss_fn --------------------------------------------

REGULARISERS = {"sigma_noise": dict(sigma_noise=0.5), "depth": dict(depth_loss_weight=0.3),
                "distortion": dict(distortion_loss_weight=LAM, sampling_space="disparity")}


@pytest.mark.parametrize("hier", [False, True], ids=["single", "hierarchical"])
@pytest.mark.parametrize("reg", list(REGULARISERS))
def test_autograd_loss_matches_jax_loss_fn(reg, hier):
    """``autograd_loss`` (the step's autograd core) against JAX's
    ``loss_fn`` assembled from its public functions, f32, same weights,
    ts, gt depth (a hole among them) and noise: loss and gradients. The
    hierarchical render applies no noise on either side; importance
    samples are the quantiles."""
    kw = REGULARISERS[reg]
    cfg = config.TrainConfig(datapath="d", Nf=NF if hier else N, Nc=NC, hierarchical=hier, batch_size=B,
                             net_H=32, net_Lp=4, net_Ld=2, **kw)
    params = ({"coarse": init_nerf_params(1, SMALL), "fine": init_nerf_params(2, SMALL)} if hier
              else init_nerf_params(1, SMALL))
    rays, pix = _rays(B, 7)
    ts = _ts(B, NC if hier else N, 8)
    gt_d = np.random.default_rng(9).uniform(3, 5, B).astype(np.float32)
    gt_d[2] = 0.0  # a hole in the depth data
    key = jax.random.PRNGKey(3)
    js = jrenderer.RenderSettings(N=cfg.Nf, N_coarse=NC if hier else 0, tn=TN, tf=TF,
                                  sampling_space=cfg.sampling_space, sigma_noise=cfg.sigma_noise)
    jr, jt, jpix, jgt = jnp.asarray(rays), jnp.asarray(ts), jnp.asarray(pix), jnp.asarray(gt_d)

    def jax_loss(p):
        if hier:
            c, f, (_, ts_all) = jrenderer.render_rays_hierarchical(p["coarse"], p["fine"], jr, key, js, _jm(SMALL),
                                                                   det_fine=True, ts_coarse=jt, return_ts=True)
            heads, dist_w, dist_t = (c, f), f.weights, ts_all
        else:
            out = jrenderer.render_rays(p, jr, key, js, _jm(SMALL), ts=jt)
            heads, dist_w, dist_t = (out,), out.weights, jt
        loss = sum(jnp.mean((h.rgb - jpix) ** 2) for h in heads)
        if cfg.depth_loss_weight > 0:
            loss = loss + cfg.depth_loss_weight * sum(_jax_depth_term(h, jgt) for h in heads)
        if cfg.distortion_loss_weight > 0:
            loss = loss + cfg.distortion_loss_weight * jvolume.distortion_loss(
                dist_w, _jax_s_norm(dist_t, cfg.sampling_space == "disparity"))
        return loss

    jloss, want = jax.value_and_grad(jax_loss)(_jax(params))
    field = (NerfPair if hier else NerfField).from_jax_params(params, "cpu")
    pix_b = torch.from_numpy(pix)
    if cfg.depth_loss_weight > 0:
        pix_b = torch.cat([pix_b, torch.from_numpy(gt_d)[:, None]], 1)
    noise = torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(key, 1), (B, N))))
    loss = autograd_loss(cfg, field, torch.from_numpy(rays), pix_b, torch.from_numpy(ts), None,
                         render_settings(cfg), det_fine=True, noise=None if hier else noise)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _assert_grads(_field_grads(field), want)


# --- the step, the config, train() -------------------------------------------------------

def test_regulariser_steps_pick_their_core():
    """JAX's rule: sigma noise and depth leave the fused kernel for the
    autograd path (fused_mlp) with JAX's warning, and an explicit
    fused=True raises; distortion stays on the fused kernel, whose step
    equals the autograd step's from one state (single net and
    hierarchical)."""
    rays, pix = (torch.from_numpy(a) for a in _rays(300, 11))
    pix4 = torch.cat([pix, torch.full((300, 1), 4.0)], 1)
    for kw, reason in ((dict(sigma_noise=0.5), "sigma_noise > 0"), (dict(depth_loss_weight=0.1), "depth_loss_weight")):
        cfg = config.TrainConfig(datapath="d", Nf=N, batch_size=16, backend="pallas", net_H=32, net_Lp=4,
                                 net_Ld=2, **kw)
        with pytest.warns(UserWarning, match=rf"fused train kernel is ineligible \({re.escape(reason)}"):
            fn = build_train_step(cfg, SMALL)
        assert np.isfinite(float(fn(make_train_state(cfg, SMALL, "cpu"), rays, pix4 if "depth" in reason else pix)))
        with pytest.raises(ValueError, match=re.escape(reason)):
            build_train_step(cfg, SMALL, fused=True)
    for hier in (False, True):
        losses = {}
        for fused in (True, False):
            cfg = config.TrainConfig(datapath="d", Nf=NF if hier else N, Nc=NC, hierarchical=hier, batch_size=16,
                                     backend="xla" if not fused else "pallas", net_H=32, net_Lp=4, net_Ld=2,
                                     distortion_loss_weight=LAM, sampling_space="disparity")
            fn = build_train_step(cfg, SMALL, fused=fused or None)
            losses[fused] = float(fn(make_train_state(cfg, SMALL, "cpu"), rays, pix))
        np.testing.assert_allclose(losses[True], losses[False], rtol=1e-4)


def test_regulariser_keys_load_and_are_checked():
    """lego.yaml with each regulariser loads; negative weights raise as in
    JAX; the keys and defaults are the JAX TrainConfig's."""
    d = config.load_yaml("configs/lego.yaml")
    for key, value in (("sigma_noise", 0.1), ("depth_loss_weight", 0.1), ("distortion_loss_weight", 0.01)):
        assert getattr(config.train_config_from_dict({**d, key: value}), key) == value
        assert getattr(config.train_config_from_dict({**config.load_yaml("configs/lego_hierarchical.yaml"),
                                                      key: value}), key) == value
    jfields = {f.name: f.default for f in dataclasses.fields(jconfig.TrainConfig)}
    for key in ("depth_loss_weight", "distortion_loss_weight"):
        for mod in (config, jconfig):
            with pytest.raises(ValueError, match=key):
                mod.TrainConfig(datapath="d", **{key: -0.1})
        assert getattr(config.TrainConfig(datapath="d"), key) == jfields[key] == 0.0
    with pytest.raises(ValueError, match="sigma_noise"):
        RenderSettings(sigma_noise=-1.0)


def _scene(tmp_path_factory, depth):
    from nerf_simple_tpu_torch.data.synthetic import write_blender_scene

    path = str(tmp_path_factory.mktemp("scene") / "s")
    write_blender_scene(path, n_train=3, n_val=1, n_test=1, H=16, W=16, write_depth=depth)
    return path


@pytest.fixture(scope="module")
def depth_scene(tmp_path_factory):
    return _scene(tmp_path_factory, True)


def _train_cfg(scene, tmp_path, **kw):
    return dict(datapath=scene, savepath=str(tmp_path / "models"), exp_name="r", Nf=8, num_iters=20,
                ckpt_model=10, ckpt_loss=1, ckpt_images=10**6, batch_size=64, half_res=False, val_idxs=[0],
                backend="pallas", compute_dtype="f32", steps_per_call=10, net_H=32, net_Lp=4, net_Ld=2,
                log_dir=str(tmp_path / "logs"), honor_lr_init=True, lr_init=5e-3, lr_final=5e-3, **kw)


@pytest.mark.filterwarnings("ignore:backend='pallas' requested")
@pytest.mark.parametrize("kw", [dict(sigma_noise=0.5), dict(depth_loss_weight=0.5),
                                dict(distortion_loss_weight=0.05, hierarchical=True, Nc=8)],
                         ids=["sigma_noise", "depth", "distortion-hierarchical"])
def test_train_with_each_regulariser_on_cpu(depth_scene, tmp_path, capsys, kw):
    """train() a few steps with each regulariser: finite, falling losses;
    the sigma noise run resumes from its checkpoint bit for bit (10 steps,
    then 10 resumed, equal the 20 straight)."""

    def losses():
        return [float(line.split()[1]) for line in capsys.readouterr().out.splitlines() if line.startswith("loss:")]

    state = train(_train_cfg(depth_scene, tmp_path, **kw), device="cpu")
    straight = losses()
    assert len(straight) == 20 and np.all(np.isfinite(straight)) and np.mean(straight[-5:]) < np.mean(straight[:5])
    if "sigma_noise" not in kw:
        return
    again = tmp_path / "again"
    train({**_train_cfg(depth_scene, again, **kw), "num_iters": 10}, device="cpu")
    first = losses()
    resumed = train({**_train_cfg(depth_scene, again, **kw), "resume": True}, device="cpu")
    assert first + losses() == straight
    assert resumed.step == 20 and torch.equal(resumed.generator.get_state(), state.generator.get_state())
    for name, p in resumed.field.named_parameters():
        assert torch.equal(p, dict(state.field.named_parameters())[name]), name


def test_depth_loss_needs_the_sidecars(tmp_path_factory, tmp_path):
    """JAX's actionable error when the train split has no metric depth."""
    scene = _scene(tmp_path_factory, False)
    with pytest.raises(ValueError, match="depth/train"):
        train(_train_cfg(scene, tmp_path, depth_loss_weight=0.1), device="cpu")
