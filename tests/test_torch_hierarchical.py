"""The port's hierarchical (coarse + fine) slice on CPU against the JAX
package: the importance sampler and the merge, the fused train step's
weights output (B1 ``out_weights``) against the JAX Pallas kernel in
interpret mode, the two-pass fused core, the hierarchical render, the
config keys, the ``{coarse, fine}`` checkpoints and train()/evaluate.test
end to end.

Inputs are made with numpy from a seed and handed to both packages; the
random draws of the two packages differ, so the comparisons take the
deterministic quantiles (``det=True``) or bin midpoints. On CPU tensors
the port's wrappers run their plain versions; the CUDA kernel is held to
them on the card (tests/test_torch_cuda.py).

Tolerances:

- ``_inv_cdf_interp``, ``importance_ts(det=True)``: f32 rounding, rtol
  1e-6 (atol 1e-6 at values of order 1-6): the same f32 operations, the
  CDF's cumsum and the quantiles summed or spaced in another order. On
  the same CDF and u the two inverse CDFs agree bit for bit. Under spiky
  weights (w^8, as a trained coarse net gives) a near-empty bin's CDF
  step is ~1e-7, and the cumsum's one-ulp difference (1.2e-7) moves a
  sample inside that bin by a share of its width: there atol 1e-4, the
  JAX package's own bound for this function (tests/test_sampling.py,
  test_importance_det_quantiles_match_numpy_invcdf; 9.2e-5 measured).
  ``merge_sorted``: exact (a permutation of the same values).
- B1's weights output (at most 1): f32, atol 1e-5; bf16, atol 2e-3, the
  bf16 bound of the forward's outputs (tests/test_torch_eval.py): an
  activation that rounds to the neighbouring bf16 in another summation
  order moves sigma, and the weights carry it (measured: 3.7e-7 f32,
  4.5e-7 bf16). Loss and gradients: the
  bounds of tests/test_torch_train.py (f32: loss rtol 1e-4, gradients atol
  1e-5 / rtol 2e-3; bf16: loss rtol 1e-3, each tensor within 2e-2 of its
  largest entry).
- The two-pass core against JAX assembled from its public functions, at
  f32: the same loss and gradient bounds.
- The port's fused two-pass step against its autograd path, from one
  state, after steps: loss rtol 1e-4 and JAX's bin-flip rule
  (tests/test_kernels.py, test_fused_hierarchical_train_matches_generic):
  fewer than 0.1% of the parameters farther apart than 5e-5 + 1e-3 |p|. The
  two paths' coarse weights differ in the last bits, and a u on a CDF edge
  then picks another fine sample.
- Renders: f32, rgb and weights atol 1e-5, disparity rtol 1e-5 (the
  same products summed in another order).
"""

import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.experimental.pallas import tpu as pltpu

import nerf_simple_tpu.config as jconfig
import nerf_simple_tpu.kernels.mlp as jmlp
import nerf_simple_tpu.models.nerf as jnerf
import nerf_simple_tpu.ops.sampling as jsampling
import nerf_simple_tpu.render.renderer as jrenderer
from nerf_simple_tpu_torch import config
from nerf_simple_tpu_torch.kernels import mlp
from nerf_simple_tpu_torch.models.nerf import NerfField, NerfMLP, NerfPair, init_nerf_params
from nerf_simple_tpu_torch.ops import sampling
from nerf_simple_tpu_torch.render import renderer
from nerf_simple_tpu_torch.render.renderer import RenderSettings
from nerf_simple_tpu_torch.train.loop import train
from nerf_simple_tpu_torch.train.step import (
    build_train_step,
    build_x16,
    hierarchical_fused_loss,
    make_train_state,
)

SMALL = NerfMLP(Lp=4, Ld=2, H=32)
B, NC, NF = 16, 8, 16
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]
DTYPE_IDS = ["f32", "bf16"]
BF16_GRAD_TOL, BF16_LOSS_RTOL = 2e-2, 1e-3


def _jax(params):
    if "coarse" in params:
        return {k: _jax(v) for k, v in params.items()}
    return {k: {n: jnp.asarray(a) for n, a in d.items()} for k, d in params.items()}


def _jm(model):
    return jnerf.NerfMLP(model.Lp, model.Ld, model.H)


def _pair_params(seed):
    return {"coarse": init_nerf_params(seed, SMALL), "fine": init_nerf_params(seed + 1, SMALL)}


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


def _rays(n, seed):
    """Rays from a radius-4 shell towards the origin, their gt colours."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    o = -4.0 * d / np.linalg.norm(d, axis=1, keepdims=True) + rng.normal(0, 0.2, (n, 3))
    return (np.concatenate([o, d], 1).astype(np.float32),
            rng.uniform(0, 1, (n, 3)).astype(np.float32))


def _ts(n, N, seed):
    return np.sort(np.random.default_rng(seed).uniform(2, 6, (n, N)), -1).astype(np.float32)


# --- the sampler -----------------------------------------------------------------

def test_inv_cdf_interp_matches_jax_on_shared_u():
    rng = np.random.default_rng(0)
    pdf = rng.uniform(0, 1, (6, 11)) ** 3
    pdf[0, 3:6] = 0.0  # empty bins: the < 1e-8 branch
    pdf /= pdf.sum(-1, keepdims=True)
    cdf = np.concatenate([np.zeros((6, 1)), np.cumsum(pdf, -1)], -1).astype(np.float32)
    values = np.sort(rng.uniform(2, 6, (6, 12)), -1).astype(np.float32)
    u = np.concatenate([np.zeros((6, 1)), np.sort(rng.uniform(0, 1, (6, 14)), -1), cdf[:, 4:5],
                        np.ones((6, 1))], -1).astype(np.float32)  # u = 0, a CDF edge and u = 1
    got = sampling._inv_cdf_interp(torch.from_numpy(cdf), torch.from_numpy(values), torch.from_numpy(u))
    want = np.asarray(jsampling._inv_cdf_interp(jnp.asarray(cdf), jnp.asarray(values), jnp.asarray(u)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("Nc, Nf, spiky, tol", [(8, 16, False, dict(rtol=1e-6, atol=1e-6)),
                                                (64, 192, True, dict(atol=1e-4))], ids=["small", "lego-spiky"])
def test_importance_ts_det_matches_jax(Nc, Nf, spiky, tol):
    rng = np.random.default_rng(Nc)
    ts_c = _ts(12, Nc, Nc)
    w = rng.uniform(0, 1, (12, Nc)).astype(np.float32)
    if spiky:
        w = (w ** 8).astype(np.float32)
    got = sampling.importance_ts(None, torch.from_numpy(ts_c), torch.from_numpy(w), Nf, det=True)
    want = np.asarray(jsampling.importance_ts(jax.random.PRNGKey(0), jnp.asarray(ts_c), jnp.asarray(w), Nf,
                                              det=True))
    assert got.shape == (12, Nf)
    np.testing.assert_allclose(got.numpy(), want, **tol)


def test_merge_sorted_matches_jax_with_ties():
    rng = np.random.default_rng(3)
    a = np.sort(rng.integers(0, 10, (9, 17)), -1).astype(np.float32)  # many equal values
    b = np.sort(np.concatenate([a[:, ::3], rng.integers(0, 10, (9, 7))], -1), -1).astype(np.float32)
    got = sampling.merge_sorted(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jsampling.merge_sorted(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.sort(np.concatenate([a, b], -1), -1))


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def test_importance_concentrates_on_high_weight_bins():
    ts_c = torch.linspace(2.0, 6.0, 64).expand(4, 64)
    w = torch.exp(-((ts_c - 4.0) ** 2) / 0.01)  # all weight near t = 4
    ts_f = sampling.importance_ts(_gen(1), ts_c, w, 128)
    assert ts_f.shape == (4, 128)
    assert bool((torch.diff(ts_f, dim=-1) >= 0).all())
    assert ((ts_f - 4.0).abs() < 0.5).float().mean().item() > 0.95


def test_importance_ts_is_sorted_without_sort():
    """u are exact uniform order statistics and the inverse CDF is
    monotone: ascending samples, inside [ts_c min, max], with no sort."""
    for seed in range(5):
        g = _gen(seed)
        ts_c = sampling.stratified_ts(g, 64, 32, 2.0, 6.0, "cpu")
        w = torch.rand((64, 32), generator=g) ** 4  # spiky weights
        ts_f = sampling.importance_ts(g, ts_c, w, 48)
        assert bool((torch.diff(ts_f, dim=-1) >= 0).all()), f"unsorted at seed {seed}"
        assert ts_f.min().item() >= ts_c.min().item() and ts_f.max().item() <= ts_c.max().item()


def test_importance_u_matches_uniform_order_statistics():
    """A flat PDF over one grid on every ray: the pooled samples are
    uniform over the midpoints' range (each decile within 10%)."""
    ts_c = torch.linspace(0.0, 1.0, 16).expand(512, 16)
    s = sampling.importance_ts(_gen(0), ts_c, torch.ones(512, 16), 64).numpy().ravel()
    lo, hi = float(ts_c[0, 1] + ts_c[0, 0]) / 2, float(ts_c[0, -1] + ts_c[0, -2]) / 2
    hist, _ = np.histogram((s - lo) / (hi - lo), bins=10, range=(0, 1))
    assert np.abs(hist - len(s) / 10).max() < 0.1 * len(s) / 10


# --- B1's weights output and the two-pass core ---------------------------------------

def _x16(rays, pix, ts):
    return build_x16(*(torch.from_numpy(np.array(a)) for a in (rays, ts, pix)))


@pytest.mark.parametrize("dt, jdt", DTYPES, ids=DTYPE_IDS)
def test_fused_train_step_weights_output_matches_jax(dt, jdt):
    """B1 with ``out_weights`` (its plain version, as the wrapper runs it
    on CPU) against the JAX kernel in interpret mode: weights, loss and
    gradients; the weights are the step's own compositing weights."""
    params = init_nerf_params(0, SMALL)
    rays, pix = _rays(B, 1)
    x = _x16(rays, pix, _ts(B, NC, 2))
    with pltpu.force_tpu_interpret_mode():
        wts, vjp = jax.vjp(lambda p: jmlp.pack_weights(p, model=_jm(SMALL)), _jax(params))
        jloss, jdw, jw = jmlp.fused_train_step(wts, jnp.asarray(x.numpy()), NC, B * NC, jdt,
                                               out_weights=True, model=_jm(SMALL))
        want = vjp(jdw)[0]
    field = NerfField.from_jax_params(params, "cpu")
    packed = mlp.pack_weights(field, differentiable=True)
    mlp.fused_train_step.launches = 0
    loss, dw, w = mlp.fused_train_step(packed, x, NC, dt, SMALL, out_weights=True)
    assert mlp.fused_train_step.launches == 0  # CPU tensor: the plain version
    assert w.shape == (B, NC) and w.dtype == torch.float32
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-5 if dt == torch.float32 else 2e-3)
    torch.autograd.backward(list(packed), list(dw))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4 if dt == torch.float32 else BF16_LOSS_RTOL)
    _assert_grads(_field_grads(field), want, dt)
    loss2, dw2 = mlp.fused_train_step(mlp.pack_weights(field), x, NC, dt, SMALL)  # without: the same step
    assert float(loss2) == float(loss) and all(torch.equal(a, b) for a, b in zip(dw2, dw))


def test_two_pass_core_matches_jax_assembled():
    """``hierarchical_fused_loss`` (quantile importance samples) against
    the JAX two-pass core built from its public functions: fused_train_step
    with out_weights on the coarse net, importance_ts(det=True),
    merge_sorted, fused_train_step on the fine net; same weights, same
    coarse ts, f32."""
    params = _pair_params(3)
    rays, pix = _rays(B, 4)
    ts_c = _ts(B, NC, 5)
    jts = jnp.asarray(ts_c)
    with pltpu.force_tpu_interpret_mode():
        wts_c, vjp_c = jax.vjp(lambda p: jmlp.pack_weights(p, model=_jm(SMALL)), _jax(params["coarse"]))
        loss_c, dw_c, w_c = jmlp.fused_train_step(wts_c, jnp.asarray(_x16(rays, pix, ts_c).numpy()), NC,
                                                  B * NC, jnp.float32, out_weights=True, model=_jm(SMALL))
        ts_all = jsampling.merge_sorted(jts, jsampling.importance_ts(jax.random.PRNGKey(0), jts, w_c, NF,
                                                                     det=True))
        N = NC + NF
        wts_f, vjp_f = jax.vjp(lambda p: jmlp.pack_weights(p, model=_jm(SMALL)), _jax(params["fine"]))
        loss_f, dw_f = jmlp.fused_train_step(wts_f, jnp.asarray(_x16(rays, pix, np.asarray(ts_all)).numpy()), N,
                                             B * N, jnp.float32, model=_jm(SMALL))
        want = {"coarse": vjp_c(dw_c)[0], "fine": vjp_f(dw_f)[0]}
    pair = NerfPair.from_jax_params(params, "cpu")
    loss = hierarchical_fused_loss(pair, torch.from_numpy(rays), torch.from_numpy(pix), torch.from_numpy(ts_c),
                                   None, NF, torch.float32, SMALL, det_fine=True)
    np.testing.assert_allclose(float(loss), float(loss_c + loss_f), rtol=1e-4)
    for k in ("coarse", "fine"):
        _assert_grads(_field_grads(getattr(pair, k)), want[k], torch.float32)


def _hier_cfg(backend, **kw):
    return config.TrainConfig(datapath="d", Nf=NF, Nc=NC, hierarchical=True, batch_size=B, backend=backend,
                              net_H=32, net_Lp=4, net_Ld=2, **kw)


def test_fused_two_pass_step_matches_the_autograd_path():
    """Fused (two B1 launches a step), two-kernel autograd (fused_mlp) and
    plain autograd steps from one state: the same losses, and after the
    steps the same parameters under JAX's bin-flip rule."""
    rays, pix = (torch.from_numpy(a) for a in _rays(400, 6))
    runs = {}
    for name, backend, fused in (("fused", "pallas", True), ("two-kernel", "pallas", False),
                                 ("plain", "xla", None)):
        cfg = _hier_cfg(backend)
        state = make_train_state(cfg, SMALL, "cpu")
        if fused is False:
            with pytest.warns(UserWarning, match="fused train kernel"):
                fn = build_train_step(cfg, SMALL, fused=False)
        else:
            fn = build_train_step(cfg, SMALL, fused=fused)
        mlp.fused_train_step.launches = 0
        losses = np.array([float(fn(state, rays, pix)) for _ in range(3)])
        assert mlp.fused_train_step.launches == 0  # CPU: the plain version, counted only on the card
        runs[name] = losses, state.field.to_jax_params()
    want_loss, want = runs["plain"]
    for name in ("fused", "two-kernel"):
        losses, got = runs[name]
        np.testing.assert_allclose(losses, want_loss, rtol=1e-4)
        bad = total = 0
        for k in ("coarse", "fine"):
            for layer in want[k]:
                for p in ("w", "b"):
                    a, b = got[k][layer][p], want[k][layer][p]
                    bad += int((np.abs(a - b) > 5e-5 + 1e-3 * np.abs(b)).sum())
                    total += a.size
        assert bad / total < 0.001, f"{name}: {bad}/{total} params diverge (> bin-flip noise)"


def test_hierarchical_state_inits_both_nets_from_derived_seeds():
    state = make_train_state(_hier_cfg("pallas"), SMALL, "cpu")
    assert isinstance(state.field, NerfPair)
    got = state.field.to_jax_params()
    for k, i in (("coarse", 0), ("fine", 1)):
        want = init_nerf_params(renderer.derive_seed(0, i), SMALL)
        np.testing.assert_array_equal(got[k]["trunk0"]["w"], want["trunk0"]["w"])
    n = sum(p.numel() for p in state.field.parameters())
    assert n == sum(p.numel() for g in state.optimizer.param_groups for p in g["params"])  # one Adam over both


# --- rendering ----------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_render_rays_hierarchical_matches_jax(backend):
    """Given coarse ts and quantile importance samples, the port's coarse
    and fine outputs against JAX's xla path (the port's pallas path: the
    forward kernel's plain version)."""
    params = _pair_params(7)
    rays, _ = _rays(B, 8)
    ts_c = _ts(B, NC, 9)
    s = RenderSettings(N=NF, N_coarse=NC, backend=backend)
    pair = NerfPair.from_jax_params(params, "cpu")
    with torch.no_grad():
        got = renderer.render_rays_hierarchical(pair.coarse, pair.fine, torch.from_numpy(rays), None, s,
                                                det_fine=True, ts_coarse=torch.from_numpy(ts_c))
    jp = _jax(params)
    want = jrenderer.render_rays_hierarchical(
        jp["coarse"], jp["fine"], jnp.asarray(rays), jax.random.PRNGKey(0),
        jrenderer.RenderSettings(N=NF, N_coarse=NC), _jm(SMALL), det_fine=True, ts_coarse=jnp.asarray(ts_c))
    for g, w in zip(got, want):
        assert g.weights.shape == w.weights.shape
        np.testing.assert_allclose(g.rgb.numpy(), np.asarray(w.rgb), atol=1e-5)
        np.testing.assert_allclose(g.weights.numpy(), np.asarray(w.weights), atol=1e-5)
        np.testing.assert_allclose(g.disp.numpy(), np.asarray(w.disp), rtol=1e-5)
    assert got[1].weights.shape == (B, NC + NF)


@pytest.fixture
def midpoints(monkeypatch):
    """Both renderers' stratified samplers give bin midpoints; the JAX
    render caches are cleared before and after."""
    jorig, orig = jrenderer.stratified_ts_spaced, renderer.stratified_ts_spaced
    monkeypatch.setattr(jrenderer, "stratified_ts_spaced", lambda *a, **k: jorig(*a, **{**k, "det": True}))
    monkeypatch.setattr(renderer, "stratified_ts_spaced", lambda *a, **k: orig(*a, **{**k, "det": True}))
    jrenderer._chunked_render_fn.cache_clear()
    yield
    jrenderer._chunked_render_fn.cache_clear()


def test_render_rays_chunked_hierarchical_matches_jax(midpoints):
    params = _pair_params(11)
    rays, _ = _rays(100, 12)
    s = RenderSettings(N=NF, N_coarse=NC, backend="pallas", fused_eval=True)  # fused_eval: not under N_coarse
    mlp.fused_render.launches = 0
    rgb, disp = renderer.render_rays_chunked(NerfPair.from_jax_params(params, "cpu"), torch.from_numpy(rays), 0, s,
                                             chunk=32)
    jrgb, jdisp = jrenderer.render_rays_chunked(_jax(params), jnp.asarray(rays), jax.random.PRNGKey(0),
                                                jrenderer.RenderSettings(N=NF, N_coarse=NC), _jm(SMALL), chunk=32)
    assert rgb.shape == (100, 3)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), atol=1e-5)
    np.testing.assert_allclose(disp.numpy(), np.asarray(jdisp), rtol=1e-5)
    with pytest.raises(ValueError, match="NerfPair"):
        renderer.render_rays_chunked(NerfField.from_jax_params(params["fine"], "cpu"), torch.from_numpy(rays), 0, s)
    with pytest.raises(ValueError, match="NerfPair"):
        renderer.render_rays_chunked(NerfPair.from_jax_params(params, "cpu"), torch.from_numpy(rays), 0,
                                     RenderSettings(N=NF))


# --- config, checkpoints, the slice end to end -------------------------------------------

def test_lego_hierarchical_yaml_loads_and_nc_is_checked():
    with open("configs/lego_hierarchical.yaml") as fh:
        assert config.load_yaml("configs/lego_hierarchical.yaml") == yaml.load(fh, Loader=yaml.FullLoader)
    d = config.load_yaml("configs/lego_hierarchical.yaml")
    cfg = config.train_config_from_dict(d)
    assert (cfg.hierarchical, cfg.Nc, cfg.Nf, cfg.batch_size, cfg.compute_dtype) == (True, 64, 192, 4096, "bf16")
    tc = config.test_config_from_dict(d)
    assert (tc.Nc, tc.N_samples) == (64, 192)
    for mod in (config, jconfig):
        with pytest.raises(ValueError, match="hierarchical=True needs Nc > 0"):
            mod.TrainConfig(datapath="d", hierarchical=True, Nc=0)
    with pytest.raises(ValueError, match="proposal and hierarchical"):
        config.train_config_from_dict({**d, "proposal": True})


def test_hierarchical_checkpoint_resumes_bit_for_bit(tmp_path):
    """Both nets, Adam over both and the generator round-trip: 2 + 2 steps
    with a checkpoint between equal 4 steps straight; a one-field state
    refuses the checkpoint."""
    from nerf_simple_tpu_torch.train import checkpoint as ckpt

    rays, pix = (torch.from_numpy(a) for a in _rays(300, 13))
    cfg = _hier_cfg("pallas")
    fn = build_train_step(cfg, SMALL)
    a = make_train_state(cfg, SMALL, "cpu")
    straight = [float(fn(a, rays, pix)) for _ in range(4)]
    b = make_train_state(cfg, SMALL, "cpu")
    first = [float(fn(b, rays, pix)) for _ in range(2)]
    path = ckpt.save_checkpoint(str(tmp_path), b)
    c = make_train_state(cfg, SMALL, "cpu")
    ckpt.restore_checkpoint(path, c)
    assert c.step == 2
    rest = [float(fn(c, rays, pix)) for _ in range(2)]
    assert first + rest == straight
    for k in ("coarse", "fine"):
        np.testing.assert_array_equal(c.field.to_jax_params()[k]["post0"]["w"],
                                      a.field.to_jax_params()[k]["post0"]["w"])
    with pytest.raises(ValueError, match="hierarchical"):
        ckpt.restore_checkpoint(path, make_train_state(config.TrainConfig(datapath="d", net_H=32, net_Lp=4,
                                                                          net_Ld=2), SMALL, "cpu"))


def test_train_and_evaluate_hierarchical_on_cpu(tmp_path, capsys, monkeypatch):
    """train() a tiny hierarchical run, logging to CSV alone as on a
    machine without tensorboard: falling loss, {coarse, fine} checkpoint,
    an npz the JAX package loads with both nets, the fine net in the .pth
    export and behind the server; then evaluate.test with Nc > 0 against
    the JAX evaluate.test (both samplers at bin midpoints), and an Nc > 0
    eval of a one-net checkpoint raises."""
    from nerf_simple_tpu.evaluate import test as jtest
    from nerf_simple_tpu.train.checkpoint import import_params_npz as jimport

    from nerf_simple_tpu_torch.data.synthetic import write_blender_scene
    from nerf_simple_tpu_torch.evaluate import load_params, test
    from nerf_simple_tpu_torch.serve import RenderServer

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # the import raises
    scene = str(tmp_path / "scene")
    write_blender_scene(scene, n_train=4, n_val=1, n_test=2, H=20, W=20)
    cfg = dict(datapath=scene, savepath=str(tmp_path / "models"), exp_name="h", Nf=NF, Nc=NC,
               hierarchical=True, num_iters=40, ckpt_model=40, ckpt_loss=1, ckpt_images=20, batch_size=64,
               half_res=False, val_idxs=[0], num_train_imgs=4, backend="pallas", compute_dtype="f32",
               steps_per_call=10, net_H=32, net_Lp=4, net_Ld=2, log_dir=str(tmp_path / "logs"),
               honor_lr_init=True, lr_init=5e-3, lr_final=5e-4)
    state = train(cfg, device="cpu")
    out = capsys.readouterr().out
    losses = [float(line.split()[1]) for line in out.splitlines() if line.startswith("loss:")]
    assert len(losses) == 40 and np.mean(losses[-10:]) < 0.8 * np.mean(losses[:10])
    assert "Val image 0 | iter: 30 | PSNR" in out
    (csv_path,) = (tmp_path / "logs").glob("run_*/scalars.csv")
    assert len([r for r in csv_path.read_text().splitlines() if ",Loss/train," in r]) == 40
    exp = tmp_path / "models" / "h"
    params = state.field.to_jax_params()
    jnpz = jimport(str(exp / "params_40.npz"))
    for k in ("coarse", "fine"):
        np.testing.assert_array_equal(np.asarray(jnpz[k]["skip"]["w"]), params[k]["skip"]["w"])
    fine = load_params(str(exp / "params_40.pth"))
    np.testing.assert_array_equal(fine["skip"]["w"], params["fine"]["skip"]["w"])
    np.testing.assert_array_equal(load_params(str(exp))["skip"]["w"], params["fine"]["skip"]["w"])
    srv = RenderServer(load_params(str(exp / "params_40.npz")), 8, 8, 20.0, RenderSettings(N=NF), model=SMALL,
                       device="cpu")
    np.testing.assert_array_equal(srv.field.to_jax_params()["skip"]["w"], params["fine"]["skip"]["w"])

    jorig, orig = jrenderer.stratified_ts_spaced, renderer.stratified_ts_spaced
    monkeypatch.setattr(jrenderer, "stratified_ts_spaced", lambda *a, **k: jorig(*a, **{**k, "det": True}))
    monkeypatch.setattr(renderer, "stratified_ts_spaced", lambda *a, **k: orig(*a, **{**k, "det": True}))
    jrenderer._chunked_render_fn.cache_clear()
    tp = dict(loadpath=str(exp / "params_40.npz"), datapath=scene, exp_name="e", batch_size=256, half_res=False,
              im_idxs=[0, 1], N_samples=NF, Nc=NC)
    jtest({**tp, "savepath": str(tmp_path / "jax")})
    jout = capsys.readouterr().out
    test({**tp, "savepath": str(tmp_path / "port"), "backend": "pallas", "normals": True}, device="cpu")
    got = capsys.readouterr().out
    jrenderer._chunked_render_fn.cache_clear()
    metrics = [re.findall(r"im (\d+): mse=\S+ psnr=(\S+) ssim=(\S+)", o) for o in (got, jout)]
    assert len(metrics[0]) == len(metrics[1]) == 2
    for (i, p, s), (j, q, r) in zip(*metrics):
        assert i == j and abs(float(p) - float(q)) <= 0.01 and abs(float(s) - float(r)) <= 1e-3
    assert {"rgb_0.png", "depth_1.png", "normal_0.png"} <= set(os.listdir(tmp_path / "port" / "e"))
    with pytest.raises(ValueError, match="no coarse/fine nets"):
        test({**tp, "loadpath": str(exp / "params_40.pth"), "savepath": str(tmp_path / "x")}, device="cpu")
