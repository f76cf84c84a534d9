"""The port's training slice on CPU against the JAX package: the config
reader, the gradient of the pack, the fused MLP backward (B2) and the
fused train step (B1) against the JAX Pallas kernels in interpret mode,
Adam against optax, the metrics, and train() end to end.

Inputs are made with numpy from a seed and handed to both packages. On
CPU tensors the port's wrappers run their plain versions; the CUDA
kernels are held to those on the card (tests/test_torch_cuda.py).

Tolerances: at f32, the JAX test's bounds (tests/test_kernels.py:156-165:
loss rtol 1e-4, field gradients atol 1e-5 / rtol 2e-3). At bf16 both
packages round the same operands, but in different summation orders an
occasional activation or cotangent rounds to the neighbouring bf16
(2^-8 relative), and the JAX kernel takes three bias gradients (b1, bs,
the colour half of bcs) from rounded cotangents and the others from f32
ones, where the port sums rounded cotangents for all: per tensor, max
abs error within 2e-2 of the JAX tensor's largest entry (measured up to
1.0e-2), loss rtol 1e-3.
"""

import dataclasses
import glob
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from jax.experimental.pallas import tpu as pltpu

import nerf_simple_tpu.config as jconfig
import nerf_simple_tpu.kernels.mlp as jmlp
import nerf_simple_tpu.models.nerf as jnerf
import nerf_simple_tpu.train.metrics as jmetrics
import nerf_simple_tpu.train.step as jstep
import nerf_simple_tpu.utils.profiling as jprof
from nerf_simple_tpu_torch import config
from nerf_simple_tpu_torch.kernels import mlp
from nerf_simple_tpu_torch.models.nerf import NerfField, NerfMLP, init_nerf_params
from nerf_simple_tpu_torch.train import metrics
from nerf_simple_tpu_torch.train.loop import chunk_schedule, train
from nerf_simple_tpu_torch.train.step import (
    build_train_step,
    build_x16,
    lr_schedule,
    make_optimizer,
    make_train_state,
)

SMALL = NerfMLP(Lp=4, Ld=2, H=32)
MODELS = [SMALL, NerfMLP()]
MODEL_IDS = ["small", "flagship"]
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]
DTYPE_IDS = ["f32", "bf16"]
BF16_GRAD_TOL, BF16_LOSS_RTOL = 2e-2, 1e-3


def _jax(params):
    return {k: {n: jnp.asarray(a) for n, a in d.items()} for k, d in params.items()}


def _jm(model):
    return jnerf.NerfMLP(model.Lp, model.Ld, model.H)


def _field_grads(field):
    return {name: {"w": getattr(field, name).weight.grad.numpy().T,
                   "b": getattr(field, name).bias.grad.numpy()} for name in field.model.layer_dims()}


def _assert_grads(got, want, dt):
    for layer in want:
        for k in ("w", "b"):
            g, w = got[layer][k], np.asarray(want[layer][k])
            if dt == torch.float32:
                np.testing.assert_allclose(g, w, atol=1e-5, rtol=2e-3, err_msg=f"{layer}/{k}")
            else:
                err = np.abs(g - w).max() / np.abs(w).max()
                assert err <= BF16_GRAD_TOL, (layer, k, err)


def _x16(B, N, seed):
    rng = np.random.default_rng(seed)
    o, d = rng.normal(0, 0.1, (B, 3)), rng.normal(size=(B, 3))
    ts = np.sort(rng.uniform(2, 6, (B, N)), -1)
    x = np.zeros((16, B, N), np.float32)
    x[0:3] = o.T[:, :, None] + d.T[:, :, None] * ts[None]
    x[3:6] = (d / np.linalg.norm(d, axis=-1, keepdims=True)).T[:, :, None]
    x[6] = ts
    x[8:11] = rng.uniform(0, 1, (3, B, 1))
    return x.reshape(16, B * N)


# --- config ----------------------------------------------------------------

@pytest.mark.parametrize("path", sorted(glob.glob("configs/*.yaml")))
def test_yaml_subset_reader_matches_pyyaml(path):
    with open(path) as fh:
        want = yaml.load(fh, Loader=yaml.FullLoader)
    assert config.load_yaml(path) == want


def test_yaml_scalars_resolve_like_pyyaml():
    text = ("a: 5e-4\nb: 5.0e-4\nc: yes\nd: Off\ne: ~\nf: 'x # y'  # c\ng: [1, 2.5, true]\n"
            "i: -3\nj: .5\nk:\n  l: 1\n  m: [a, b]\nn: 2\n")
    assert config.parse_yaml(text) == yaml.load(text, Loader=yaml.FullLoader)


def test_train_config_keys_and_defaults_are_the_jax_ones():
    jfields = {f.name: f.default for f in dataclasses.fields(jconfig.TrainConfig)}
    ported = {f.name: f.default for f in dataclasses.fields(config.TrainConfig)}
    assert set(ported) | set(config._UNPORTED) == set(jfields)
    assert not set(ported) & set(config._UNPORTED)
    for k, v in ported.items():
        assert v == jfields[k], k
    for k, (v, _) in config._UNPORTED.items():
        assert v == jfields[k], k


def test_lego_yaml_loads_and_unported_keys_raise():
    cfg = config.train_config_from_dict(config.load_yaml("configs/lego.yaml"))
    assert (cfg.batch_size, cfg.Nf, cfg.compute_dtype, cfg.steps_per_call) == (4096, 128, "bf16", 100)
    assert cfg.val_idxs == (0, 1) and cfg.render_dtype == torch.bfloat16
    for key, value in (("mip_multiscale", True), ("num_data_shards", 4),
                       ("model_family", "hashgrid"), ("train_im_idxs", [0]), ("occupancy", True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            config.train_config_from_dict({"datapath": "d", key: value})
    assert config.train_config_from_dict({"datapath": "d", "contract": True}).contract  # ported
    with pytest.raises(NotImplementedError, match="ROADMAP Queue B item 3"):  # not with pose refinement yet
        config.train_config_from_dict({"datapath": "d", "contract": True, "pose_opt": True})
    for key, value in (("sigma_noise", 0.1), ("distortion_loss_weight", 0.01), ("proposal", True),
                       ("Np", 32), ("prop_H", 32), ("proposal_loss_weight", 0.5)):  # ported: they load
        assert getattr(config.train_config_from_dict({"datapath": "d", "proposal": True, key: value}), key) == value
    assert config.train_config_from_dict({"datapath": "d", "appearance_dim": 4}).appearance_dim == 4  # ported
    for key, value in (("mip", True), ("mip_levels", 2), ("opaque_background", True), ("resample_blur", 0.1)):
        assert getattr(config.train_config_from_dict({"datapath": "d", "mip": True, key: value}), key) == value
    with pytest.warns(UserWarning, match="heirarchical"):
        config.train_config_from_dict({"datapath": "d", "heirarchical": True})
    with pytest.raises(ValueError, match="backend"):
        config.TrainConfig(datapath="d", backend="tpu")


# --- the kernels' math --------------------------------------------------------

@pytest.mark.parametrize("model", MODELS, ids=MODEL_IDS)
def test_pack_gradient_matches_jax_vjp(model):
    """The transpose of the pack (column permute-and-pad, the Wcs = Wcf.Wf
    fold) by autograd, against jax.vjp(pack_weights)."""
    params = init_nerf_params(0, model)
    rng = np.random.default_rng(1)
    shapes = mlp._weight_shapes(model)
    cot = {n: rng.normal(size=shapes[n]).astype(np.float32) for n in mlp.FusedWeights._fields}
    _, vjp = jax.vjp(lambda p: jmlp.pack_weights(p, model=_jm(model)), _jax(params))
    want = vjp(jmlp.FusedWeights(**{n: jnp.asarray(a) for n, a in cot.items()}))[0]
    field = NerfField.from_jax_params(params, "cpu")
    packed = mlp.pack_weights(field, differentiable=True)
    torch.autograd.backward(list(packed), [torch.from_numpy(cot[n]) for n in packed._fields])
    got = _field_grads(field)
    for layer in want:
        for k in ("w", "b"):
            np.testing.assert_allclose(got[layer][k], np.asarray(want[layer][k]), rtol=1e-5,
                                       atol=1e-5, err_msg=f"{layer}/{k}")
    assert not mlp.pack_weights(field).W1.requires_grad  # the default stays detached


@pytest.mark.parametrize("dt, jdt", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("model", MODELS, ids=MODEL_IDS)
def test_fused_mlp_backward_matches_jax(model, dt, jdt):
    """fused_mlp's backward (B2's plain version on CPU) through the pack,
    against JAX _fused_mlp_bwd through jax.vjp(pack_weights)."""
    params = init_nerf_params(3, model)
    rng = np.random.default_rng(4)
    rows = 128
    x = np.zeros((8, rows), np.float32)
    x[:3] = rng.uniform(-2, 2, (3, rows))
    d = rng.normal(size=(3, rows))
    x[3:6] = d / np.linalg.norm(d, axis=0)
    g = np.zeros((8, rows), np.float32)
    g[:4] = rng.normal(size=(4, rows)) * 0.1
    with pltpu.force_tpu_interpret_mode():
        wts, vjp = jax.vjp(lambda p: jmlp.pack_weights(p, model=_jm(model)), _jax(params))
        want = vjp(jmlp._fused_mlp_bwd(wts, jnp.asarray(x), jnp.asarray(g), 128, jdt, _jm(model)))[0]
    field = NerfField.from_jax_params(params, "cpu")
    xt = torch.from_numpy(x)  # needs no gradient: weights only, like want_dx=False
    out = mlp.fused_mlp(mlp.pack_weights(field, differentiable=True), xt, dt, model)
    out.backward(torch.from_numpy(g))
    assert xt.grad is None
    _assert_grads(_field_grads(field), want, dt)


@pytest.mark.parametrize("dt, jdt", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("model", MODELS, ids=MODEL_IDS)
def test_fused_train_step_matches_jax(model, dt, jdt):
    """B1's plain version (what the wrapper runs on CPU) against the JAX
    fused_train_step kernel, B=8 rays of N=16 samples."""
    params = init_nerf_params(0, model)
    B, N = 8, 16
    x = _x16(B, N, 5)
    with pltpu.force_tpu_interpret_mode():
        wts, vjp = jax.vjp(lambda p: jmlp.pack_weights(p, model=_jm(model)), _jax(params))
        jloss, jdw = jmlp.fused_train_step(wts, jnp.asarray(x), N, 128, jdt, model=_jm(model))
        want = vjp(jdw)[0]
    field = NerfField.from_jax_params(params, "cpu")
    packed = mlp.pack_weights(field, differentiable=True)
    mlp.fused_train_step.launches = 0
    loss, dw = mlp.fused_train_step(packed, torch.from_numpy(x), N, dt, model)
    assert mlp.fused_train_step.launches == 0  # CPU tensor: the plain version
    torch.autograd.backward(list(packed), list(dw))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4 if dt == torch.float32 else BF16_LOSS_RTOL)
    _assert_grads(_field_grads(field), want, dt)


def test_fused_train_step_plain_equals_autograd_of_the_render_path():
    """At f32 the explicit math equals autograd through render_rays' plain
    (xla) path: the compositing gradient, the backprop and the fold."""
    from nerf_simple_tpu_torch.render.renderer import RenderSettings, render_rays

    params = init_nerf_params(2, SMALL)
    rng = np.random.default_rng(6)
    B, N = 6, 12
    rays = torch.from_numpy(np.concatenate([rng.normal(0, .1, (B, 3)), rng.normal(size=(B, 3))], 1).astype(np.float32))
    ts = torch.sort(torch.from_numpy(rng.uniform(2, 6, (B, N)).astype(np.float32)), 1)[0]
    pix = torch.from_numpy(rng.uniform(0, 1, (B, 3)).astype(np.float32))
    f1 = NerfField.from_jax_params(params, "cpu")
    packed = mlp.pack_weights(f1, differentiable=True)
    loss, dw = mlp.fused_train_step(packed, build_x16(rays, ts, pix), N, torch.float32, SMALL)
    torch.autograd.backward(list(packed), list(dw))
    f2 = NerfField.from_jax_params(params, "cpu")
    ref = torch.mean((render_rays(f2, rays, None, RenderSettings(N=N), ts=ts).rgb - pix) ** 2)
    ref.backward()
    np.testing.assert_allclose(float(loss), ref.item(), rtol=1e-5)
    _assert_grads(_field_grads(f1), _field_grads(f2), torch.float32)


def test_fused_train_step_rejects_partial_rays():
    wts = mlp.pack_weights(NerfField(SMALL))
    with pytest.raises(ValueError, match="whole rays"):
        mlp.fused_train_step(wts, torch.zeros(16, 30), 8, torch.float32, SMALL)


# --- optimizer, schedule, metrics ---------------------------------------------------

@pytest.mark.parametrize("honor", [False, True])
def test_adam_and_schedule_match_optax(honor):
    """Three updates from the same gradients: torch.optim.Adam with the
    port's per-step lr against the JAX package's optax optimizer."""
    kw = dict(datapath="d", lr_init=1e-3, lr_final=1e-5, num_iters=10, honor_lr_init=honor)
    cfg = config.TrainConfig(**kw)
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(5, 4)).astype(np.float32)
    grads = [rng.normal(size=(5, 4)).astype(np.float32) for _ in range(3)]
    tx = jstep.make_optimizer(jconfig.TrainConfig(**kw))
    jp, st = jnp.asarray(p0), None
    st = tx.init(jp)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_optimizer(cfg, [p])
    lr0, decay = lr_schedule(cfg)
    assert lr0 == (1e-3 if honor else 5e-4)
    for i, g in enumerate(grads):
        upd, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        p.grad = torch.from_numpy(g)
        for group in opt.param_groups:
            group["lr"] = lr0 * decay**i
        opt.step()
        if i == 0:  # step 0 runs at lr0: Adam's first update is lr0 * g / (|g| + eps)
            np.testing.assert_allclose(p.detach().numpy(), p0 - lr0 * g / (np.abs(g) + 1e-8), rtol=1e-6)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    gt = rng.uniform(0, 0.9, (20, 24, 3)).astype(np.float32)
    pred = np.clip(gt + rng.normal(0, 0.05, gt.shape), 0, 1).astype(np.float32)
    assert metrics.img_mse(gt, pred) == pytest.approx(float(jmetrics.img_mse(gt, pred)), rel=1e-5)
    assert metrics.img_psnr(gt, pred) == pytest.approx(float(jmetrics.img_psnr(gt, pred)), rel=1e-5)
    assert metrics.img_psnr(gt, pred, peak=1.0) > metrics.img_psnr(gt, pred)  # peak = max(gt) quirk
    assert metrics.img_ssim(gt, pred) == pytest.approx(float(jmetrics.img_ssim(gt, pred)), abs=2e-5)
    batch = np.stack([gt, pred])
    assert metrics.img_ssim(batch, batch[::-1]) == pytest.approx(
        float(jmetrics.img_ssim(batch, batch[::-1])), abs=2e-5)
    assert metrics.img_ssim(gt, gt) == pytest.approx(1.0, abs=1e-9)


@pytest.mark.parametrize("start, n, spc, every", [(0, 300, 50, (100, 150, 150)), (37, 250, 20, (10, 500, 100)),
                                                  (0, 7, 10, (3,))])
def test_chunk_schedule_matches_jax(start, n, spc, every):
    assert list(chunk_schedule(start, n, spc, every)) == list(jprof.chunk_schedule(start, n, spc, every))


# --- the train step and the loop ------------------------------------------------------

def _rays(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return torch.from_numpy(np.concatenate([-4.0 * d / np.linalg.norm(d, axis=1, keepdims=True), d], 1)), \
        torch.from_numpy(rng.uniform(0, 1, (n, 3)).astype(np.float32))


def test_train_step_backends_agree_from_one_state():
    """Fused (B1), two-kernel (fused_mlp: forward + B2, with the JAX
    warning) and plain paths: same state, same batches, same losses."""
    rays, pixels = _rays(500, 0)
    losses = {}
    for name, backend, fused in (("fused", "pallas", True), ("two-kernel", "pallas", False),
                                 ("plain", "xla", None)):
        cfg = config.TrainConfig(datapath="d", Nf=8, batch_size=32, backend=backend,
                                 net_H=32, net_Lp=4, net_Ld=2)
        state = make_train_state(cfg, SMALL, "cpu")
        if fused is False:
            with pytest.warns(UserWarning, match="fused train kernel"):
                fn = build_train_step(cfg, SMALL, fused=False)
        else:
            with warnings.catch_warnings():
                warnings.simplefilter("error")
                fn = build_train_step(cfg, SMALL, fused=fused)
        losses[name] = np.array([float(fn(state, rays, pixels)) for _ in range(3)])
        assert state.step == 3
    np.testing.assert_allclose(losses["fused"], losses["plain"], rtol=1e-5)
    np.testing.assert_allclose(losses["two-kernel"], losses["plain"], rtol=1e-5)


def test_train_end_to_end_on_cpu(tmp_path, capsys):
    """train() on a tiny scene: the loss falls, checkpoints and exports are
    written, and the JAX package and this one load the export; a resume
    continues from the saved step."""
    from nerf_simple_tpu.evaluate import load_params as jload

    from nerf_simple_tpu_torch.data.synthetic import write_blender_scene
    from nerf_simple_tpu_torch.evaluate import load_params

    scene = str(tmp_path / "scene")
    write_blender_scene(scene, n_train=4, n_val=2, n_test=2, H=24, W=24)
    cfg = dict(datapath=scene, savepath=str(tmp_path / "models"), exp_name="tiny", Nf=16,
               num_iters=60, ckpt_model=50, ckpt_loss=1, ckpt_images=30, batch_size=64,
               half_res=False, val_idxs=[0], num_train_imgs=4, backend="pallas",
               compute_dtype="f32", steps_per_call=10, net_H=32, net_Lp=4, net_Ld=2,
               log_dir=str(tmp_path / "logs"), honor_lr_init=True, lr_init=5e-3, lr_final=5e-4)
    state = train(cfg, device="cpu")
    out = capsys.readouterr().out
    losses = [float(line.split()[1]) for line in out.splitlines() if line.startswith("loss:")]
    assert len(losses) == 60 and np.all(np.isfinite(losses))
    assert np.mean(losses[-10:]) < 0.7 * np.mean(losses[:10])
    assert "Val image 0 | iter: 10 | PSNR" in out and "SSIM" in out
    exp = tmp_path / "models" / "tiny"
    assert {"ckpt_10.pth", "ckpt_60.pth", "params_60.npz", "params_60.pth", "model.json"} <= {
        p.name for p in exp.iterdir()}
    want = state.field.to_jax_params()
    for loaded in (load_params(str(exp / "params_60.npz")), jload(str(exp / "params_60.npz")),
                   load_params(str(exp / "params_60.pth"))):
        np.testing.assert_array_equal(np.asarray(loaded["trunk0"]["w"]), want["trunk0"]["w"])

    cfg.update(resume=True, num_iters=80)
    state2 = train(cfg, device="cpu")
    out = capsys.readouterr().out
    assert f"resumed from {exp / 'ckpt_60.pth'} at step 60" in out
    assert state2.step == 80 and (exp / "ckpt_80.pth").exists()


def test_resume_reproduces_the_uninterrupted_run(tmp_path):
    """Params, Adam state and the generator round-trip: 2 + 2 steps with a
    checkpoint between equal 4 steps straight."""
    from nerf_simple_tpu_torch.train import checkpoint as ckpt

    rays, pixels = _rays(300, 1)
    cfg = config.TrainConfig(datapath="d", Nf=8, batch_size=16, backend="pallas",
                             net_H=32, net_Lp=4, net_Ld=2)
    a = make_train_state(cfg, SMALL, "cpu")
    fn = build_train_step(cfg, SMALL)
    straight = [float(fn(a, rays, pixels)) for _ in range(4)]
    b = make_train_state(cfg, SMALL, "cpu")
    first = [float(fn(b, rays, pixels)) for _ in range(2)]
    path = ckpt.save_checkpoint(str(tmp_path), b)
    assert ckpt.latest_checkpoint(str(tmp_path)) == path
    c = make_train_state(cfg, SMALL, "cpu")
    ckpt.restore_checkpoint(path, c)
    assert c.step == 2
    rest = [float(fn(c, rays, pixels)) for _ in range(2)]
    assert first + rest == straight

