"""The port's pose-refinement slice (BARF) on CPU against the JAX package:
the camera deltas (``rodrigues_rotate``, ``apply_cam_deltas``,
``bake_cam_deltas``) and their gradients, the anneal windows
(``anneal_weights``, ``gamma``'s alpha, ``anneal_row_weights``), the
forward with the windows and B2's input gradient (the plain versions, as
the wrappers run them on CPU tensors, against JAX's Pallas kernels in
interpret mode), the pose loss of one batch (single net and hierarchical
pair) against JAX's assembled from its public functions, the pose Adam
group against optax, the freeze, the config rules, train() through a
freeze and a resume past it, and eval of refined train stills.

Inputs are made with numpy from a seed and handed to both packages; the
random draws of the two packages differ, so the comparisons hand both the
same batch, ts and image indices (the hierarchical fine samples are the
deterministic quantiles). The CUDA kernels are held to the plain versions
on the card (tests/test_torch_cuda.py).

Tolerances:

- The ray ops, the windows and the annealed encoders: f32, atol 1e-6
  (rtol 1e-6 where values are ~1); a rotation against float64 rotation
  matrices, atol 2e-5 (JAX's bound, tests/test_pose_app.py:53).
- The forward with the windows against JAX's interpret-mode kernel: f32
  atol 1e-5; bf16 atol 2e-3 (the forward's bounds, tests/test_torch_mip.py).
- B2 with ``want_dx`` against JAX's ``_fused_mlp_bwd(want_dx=True)``: the
  weight gradients through the pack at f32 atol 1e-5 / rtol 2e-3, at bf16
  each tensor within 2e-2 of its largest entry (tests/test_torch_mip.py);
  ``dx``, max abs error over max |dx|: 1e-4 in f32 (the two sum f32
  products in other orders, and the transpose scales octave i by 2^i)
  and 5e-3 in bf16. Against torch autograd of the plain forward in float64: 1e-12.
- The pose loss against JAX's: loss rtol 1e-5, field and delta gradients
  atol 1e-5 / rtol 2e-3 (f32: other summation orders).
- Adam against optax: rtol 1e-6, atol 1e-7 (tests/test_torch_train.py).
"""

import dataclasses
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import nerf_simple_tpu.config as jconfig
import nerf_simple_tpu.data.synthetic as jsynth
import nerf_simple_tpu.kernels.mlp as jmlp
import nerf_simple_tpu.models.nerf as jnerf
import nerf_simple_tpu.ops.encoding as jencoding
import nerf_simple_tpu.ops.rays as jrays
import nerf_simple_tpu.render.renderer as jrenderer
import nerf_simple_tpu.train.step as jstep
from nerf_simple_tpu_torch import config
from nerf_simple_tpu_torch.data import synthetic
from nerf_simple_tpu_torch.kernels import mlp
from nerf_simple_tpu_torch.models.nerf import NerfField, NerfMLP, NerfPair, init_nerf_params, nerf_apply
from nerf_simple_tpu_torch.ops import encoding, rays
from nerf_simple_tpu_torch.render import renderer
from nerf_simple_tpu_torch.render.renderer import RenderSettings
from nerf_simple_tpu_torch.train import checkpoint as ckpt
from nerf_simple_tpu_torch.train.step import (
    CamDeltas,
    anneal_alpha,
    autograd_loss,
    build_train_step,
    freeze_pose_state,
    kernel_refusal,
    make_optimizer,
    make_train_state,
    pose_lr,
    render_settings,
)

SMALL = NerfMLP(Lp=4, Ld=2, H=32)
B, N, HW = 8, 16, 16  # rays, samples a ray, pixels an image of the ray set
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]
DTYPE_IDS = ["f32", "bf16"]
BF16_GRAD_TOL = 2e-2
DX_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-3}


def _jtree(params):
    if isinstance(params, dict):
        return {k: _jtree(v) for k, v in params.items()}
    return jnp.asarray(params)


def _jm(model):
    return jnerf.NerfMLP(model.Lp, model.Ld, model.H)


def _t(a):
    return torch.from_numpy(np.array(a))


def _grads(field):
    return {name: {"w": getattr(field, name).weight.grad.numpy().T,
                   "b": getattr(field, name).bias.grad.numpy()} for name in field.model.layer_dims()}


def _assert_grads(got, want, dt=torch.float32):
    for layer in want:
        for k in ("w", "b"):
            g, w = got[layer][k], np.asarray(want[layer][k])
            if dt == torch.float32:
                np.testing.assert_allclose(g, w, atol=1e-5, rtol=2e-3, err_msg=f"{layer}/{k}")
            else:
                err = np.abs(g - w).max() / np.abs(w).max()
                assert err <= BF16_GRAD_TOL, (layer, k, err)


def _rotmat(r):
    th = np.linalg.norm(r)
    if th < 1e-12:
        return np.eye(3)
    k = r / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _xT(rows, seed):
    rng = np.random.default_rng(seed)
    x = np.zeros((8, rows), np.float32)
    x[:3] = rng.uniform(-2, 2, (3, rows))
    d = rng.normal(size=(3, rows))
    x[3:6] = d / np.linalg.norm(d, axis=0, keepdims=True)
    return x


def _batch(seed, n_img=3):
    """Rays from a radius-4 shell towards the origin, gt colours, sorted
    ts and each ray's image."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(B, 3))
    o = -4.0 * d / np.linalg.norm(d, axis=1, keepdims=True) + rng.normal(0, 0.2, (B, 3))
    ts = np.sort(rng.uniform(2, 6, (B, N)), -1)
    return (np.concatenate([o, d], 1).astype(np.float32), rng.uniform(0, 1, (B, 3)).astype(np.float32),
            ts.astype(np.float32), rng.integers(0, n_img, B))


def _deltas(seed, n_img=3, scale=0.05):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, scale, (n_img, 3)).astype(np.float32),
            rng.normal(0, 2 * scale, (n_img, 3)).astype(np.float32))


# --- the camera deltas --------------------------------------------------------------------------------

def test_rodrigues_matches_jax_and_f64_rotations():
    rng = np.random.default_rng(0)
    rv = (rng.normal(size=(16, 3)) * rng.uniform(0, 2.5, (16, 1))).astype(np.float32)
    rv[3] = 0.0
    rv[4] = 3e-5  # the series branch
    v = rng.normal(size=(16, 3)).astype(np.float32)
    got = rays.rodrigues_rotate(_t(rv), _t(v)).numpy()
    np.testing.assert_allclose(got, np.asarray(jrays.rodrigues_rotate(jnp.asarray(rv), jnp.asarray(v))), atol=1e-6)
    np.testing.assert_allclose(got, np.stack([_rotmat(r.astype(np.float64)) @ x for r, x in zip(rv, v)]), atol=2e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), np.linalg.norm(v, axis=-1), rtol=1e-5)


@pytest.mark.parametrize("where", ["zero", "random"])
def test_rodrigues_vjp_matches_jax_and_is_finite_at_zero(where):
    """The gradient in the rotation (the training init is the zero delta:
    finite there, ``v x u``) and in the vectors, against ``jax.vjp``."""
    rng = np.random.default_rng(1)
    rv = np.zeros((8, 3), np.float32) if where == "zero" else rng.normal(0, 0.3, (8, 3)).astype(np.float32)
    v, u = rng.normal(size=(8, 3)).astype(np.float32), rng.normal(size=(8, 3)).astype(np.float32)
    r_t, v_t = _t(rv).requires_grad_(True), _t(v).requires_grad_(True)
    (rays.rodrigues_rotate(r_t, v_t) * _t(u)).sum().backward()
    _, vjp = jax.vjp(jrays.rodrigues_rotate, jnp.asarray(rv), jnp.asarray(v))
    jr, jv = vjp(jnp.asarray(u))
    assert bool(torch.isfinite(r_t.grad).all())
    np.testing.assert_allclose(r_t.grad.numpy(), np.asarray(jr), atol=1e-5)
    np.testing.assert_allclose(v_t.grad.numpy(), np.asarray(jv), atol=1e-5)
    if where == "zero":
        np.testing.assert_allclose(r_t.grad.numpy(), np.cross(v, u), atol=1e-5)


def test_apply_and_bake_cam_deltas_match_jax():
    """Values and VJPs of ``apply_cam_deltas`` against JAX's (columns past
    6 pass through; the zero delta is the identity), and ``bake_cam_deltas``
    equal bit for bit to the per-ray form with gathered deltas."""
    rng = np.random.default_rng(2)
    n_img, hw = 3, 8
    r8 = rng.normal(size=(n_img * hw, 8)).astype(np.float32)
    dr, dt = _deltas(3, n_img)
    im = np.arange(n_img * hw) // hw
    got = rays.apply_cam_deltas(_t(r8), _t(dr[im]), _t(dt[im])).numpy()
    np.testing.assert_allclose(got, np.asarray(jrays.apply_cam_deltas(*map(jnp.asarray, (r8, dr[im], dt[im])))),
                               atol=1e-6)
    assert (got[:, 6:] == r8[:, 6:]).all()
    z = np.zeros((n_img * hw, 3), np.float32)
    assert (rays.apply_cam_deltas(_t(r8), _t(z), _t(z)).numpy() == r8).all()
    baked = rays.bake_cam_deltas(_t(r8), _t(dr), _t(dt), hw)
    assert torch.equal(baked, rays.apply_cam_deltas(_t(r8), _t(dr[im]), _t(dt[im])))
    np.testing.assert_allclose(baked.numpy(), np.asarray(jrays.bake_cam_deltas(*map(jnp.asarray, (r8, dr, dt)), hw)),
                               atol=1e-6)
    u = rng.normal(size=r8.shape).astype(np.float32)
    tdr, tdt = _t(dr).requires_grad_(True), _t(dt).requires_grad_(True)
    (rays.bake_cam_deltas(_t(r8), tdr, tdt, hw) * _t(u)).sum().backward()
    _, vjp = jax.vjp(lambda a, b: jrays.bake_cam_deltas(jnp.asarray(r8), a, b, hw), jnp.asarray(dr), jnp.asarray(dt))
    jdr, jdt = vjp(jnp.asarray(u))
    np.testing.assert_allclose(tdr.grad.numpy(), np.asarray(jdr), atol=1e-5)
    np.testing.assert_allclose(tdt.grad.numpy(), np.asarray(jdt), atol=1e-5)


# --- the anneal windows ---------------------------------------------------------------------------------

@pytest.mark.parametrize("alpha", [0.0, 0.3, 0.77, 1.0])
def test_anneal_weights_gamma_and_row_weights_match_jax(alpha):
    for L in (4, 10):
        np.testing.assert_allclose(encoding.anneal_weights(L, alpha).numpy(),
                                   np.asarray(jencoding.anneal_weights(L, jnp.float32(alpha))), atol=1e-6)
    x = np.random.default_rng(4).uniform(-3, 3, (5, 3)).astype(np.float32)
    np.testing.assert_allclose(encoding.gamma(_t(x), 4, alpha).numpy(),
                               np.asarray(jencoding.gamma(jnp.asarray(x), 4, jnp.float32(alpha))), atol=1e-6)
    for model in (SMALL, NerfMLP()):
        got = mlp.anneal_row_weights(model, alpha)
        want = jmlp.anneal_row_weights(_jm(model), jnp.float32(alpha))
        for g, w in zip(got, want):
            assert g.shape == (w.shape[0],) and g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w)[:, 0], atol=1e-6)
    if alpha == 1.0:  # done: every window exactly 1
        assert all(bool((w == 1).all()) for w in mlp.anneal_row_weights(NerfMLP(), alpha))


def test_nerf_apply_with_enc_alpha_matches_jax():
    params = init_nerf_params(5, SMALL)
    x = _xT(64, 6)[:6].T.copy()
    field = NerfField.from_jax_params(params, "cpu")
    for alpha in (None, 0.4):
        with torch.no_grad():
            got = nerf_apply(field, _t(x), enc_alpha=alpha).numpy()
        want = jnerf.nerf_apply(_jtree(params), jnp.asarray(x), _jm(SMALL),
                                enc_alpha=None if alpha is None else jnp.float32(alpha))
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("dt, jdt", DTYPES, ids=DTYPE_IDS)
def test_fused_mlp_forward_with_windows_matches_jax(dt, jdt):
    """The forward with the anneal windows (its plain version, which the
    wrapper runs on a CPU tensor) against JAX's interpret-mode kernel with
    ``enc_w``, and in f32 against ``nerf_apply`` at the same alpha."""
    params = init_nerf_params(7, SMALL)
    x = _xT(128, 8)
    jw = jmlp.anneal_row_weights(_jm(SMALL), jnp.float32(0.3))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jmlp.fused_mlp_forward(jmlp.pack_weights(_jtree(params), model=_jm(SMALL)),
                                                 jnp.asarray(x), 128, jdt, _jm(SMALL), False, jw))
    field = NerfField.from_jax_params(params, "cpu")
    enc_w = mlp.anneal_row_weights(SMALL, 0.3)
    mlp.fused_mlp_forward.launches = mlp.fused_mlp_forward.anneal_launches = 0
    got = mlp.fused_mlp_forward(mlp.pack_weights(field), _t(x), dt, SMALL, enc_w=enc_w).numpy()
    assert mlp.fused_mlp_forward.launches == mlp.fused_mlp_forward.anneal_launches == 0  # CPU: plain
    np.testing.assert_allclose(got[:4], want[:4], atol=1e-5 if dt == torch.float32 else 2e-3)
    if dt == torch.float32:
        with torch.no_grad():
            np.testing.assert_allclose(got[:4].T, nerf_apply(field, _t(x[:6].T), enc_alpha=0.3).numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="enc_w"):
        mlp.fused_mlp_forward(mlp.pack_weights(field), _t(x), dt, SMALL, enc_w=(enc_w[1], enc_w[0]))


@pytest.mark.parametrize("dt, jdt", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("alpha", [None, 0.3, 1.0], ids=["none", "a0.3", "a1"])
def test_backward_want_dx_matches_jax(alpha, dt, jdt):
    """B2 with ``want_dx`` (its plain version) against JAX's interpret-mode
    ``_fused_mlp_bwd(want_dx=True, enc_w)``: the weight gradients through
    the pack and ``dx``; the windows' own gradient is none."""
    params = init_nerf_params(9, SMALL)
    x = _xT(128, 10)
    g = np.zeros((8, 128), np.float32)
    g[:4] = np.random.default_rng(11).normal(size=(4, 128)) * 0.1
    jw = None if alpha is None else jmlp.anneal_row_weights(_jm(SMALL), jnp.float32(alpha))
    with pltpu.force_tpu_interpret_mode():
        wts, vjp = jax.vjp(lambda p: jmlp.pack_weights(p, model=_jm(SMALL)), _jtree(params))
        jgrads, jdx = jmlp._fused_mlp_bwd(wts, jnp.asarray(x), jnp.asarray(g), 128, jdt, _jm(SMALL), False,
                                          want_dx=True, enc_w=jw)
        want = vjp(jgrads)[0]
    field = NerfField.from_jax_params(params, "cpu")
    enc_w = None if alpha is None else mlp.anneal_row_weights(SMALL, alpha)
    xT = _t(x).requires_grad_(True)
    out = mlp.fused_mlp(mlp.pack_weights(field, differentiable=True), xT, dt, SMALL, enc_w=enc_w)
    out.backward(_t(g))
    _assert_grads(_grads(field), want, dt)
    jdx = np.asarray(jdx)
    assert (xT.grad.numpy()[6:] == 0).all()
    assert np.abs(xT.grad.numpy() - jdx).max() / np.abs(jdx).max() <= DX_TOL[dt]


def test_input_grad_bound_reckoning():
    """The input-gradient kernel's work at the flagship's training batch:
    71,424 flop and 1,336 (bf16) / 2,616 (f32) bytes a row, so 0.209 ms bf16
    (bytes) and 0.559 ms f32 (operations) at 524,288 rows on the H100."""
    from nerf_simple_tpu_torch.utils.roofline import bound_by, bound_ms, input_grad_work

    rows = 524_288
    (f16, b16), (f32, b32) = (input_grad_work(NerfMLP(), rows, dt) for dt in (torch.bfloat16, torch.float32))
    assert f16 == f32 == 71_424 * rows and (b16, b32) == (1_336 * rows, 2_616 * rows)
    assert bound_by(f16, b16, torch.bfloat16) == "bytes" and bound_by(f32, b32, torch.float32) == "operations"
    assert bound_ms(f16, b16, torch.bfloat16) == pytest.approx(0.2091, abs=1e-4)
    assert bound_ms(f32, b32, torch.float32) == pytest.approx(0.5589, abs=1e-4)


@pytest.mark.parametrize("alpha", [None, 0.3], ids=["none", "a0.3"])
def test_input_grad_equals_autograd_of_the_plain_forward_in_f64(alpha):
    """``dx`` of B2's plain version (and of ``input_grad_plain`` on the
    backward tile's planes) against torch autograd of the plain forward,
    all in float64."""
    wts = mlp.FusedWeights(*(w.double() for w in mlp.pack_weights(NerfField.from_jax_params(
        init_nerf_params(12, SMALL), "cpu"))))
    x = torch.from_numpy(_xT(200, 13).astype(np.float64))
    g = torch.from_numpy(np.random.default_rng(14).normal(size=(8, 200)))
    enc_w = None if alpha is None else mlp.anneal_row_weights(SMALL, alpha)
    xr = x.clone().requires_grad_(True)
    (mlp.fused_mlp_forward_plain(wts, xr, torch.float64, SMALL, enc_w=enc_w) * g).sum().backward()
    _, dx = mlp.fused_mlp_backward_plain(wts, x, g, torch.float64, SMALL, want_dx=True, enc_w=enc_w)
    np.testing.assert_allclose(dx.numpy(), xr.grad.numpy(), atol=1e-12)
    _, res = mlp.forward_residuals_plain(wts, x, torch.float64, SMALL, enc_w=enc_w)
    gws = mlp.backward_tile_plain(wts, res, g, torch.float64, SMALL)
    np.testing.assert_allclose(mlp.input_grad_plain(wts, x, gws, torch.float64, SMALL, enc_w).numpy(),
                               xr.grad.numpy(), atol=1e-12)
    # under mip B2 gives the integrated encoder's input gradient, 16 rows (tests/test_torch_pose_mip.py)
    w32 = mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(12, SMALL), "cpu"))
    _, dx16 = mlp.fused_mlp_backward(w32, torch.zeros((16, 64)), torch.zeros((8, 64)), torch.float32, SMALL, mip=True,
                                     want_dx=True)
    assert dx16.shape == (16, 64)


# --- the pose loss of one batch -------------------------------------------------------------------------

def _pose_cfg(backend="pallas", **kw):
    return config.TrainConfig(datapath="d", Nf=N, batch_size=B, backend=backend, net_H=SMALL.H, net_Lp=SMALL.Lp,
                              net_Ld=SMALL.Ld, pose_opt=True, num_iters=40, pose_warmup=2, **kw)


@pytest.mark.parametrize("hier", [False, True], ids=["single", "hierarchical"])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_pose_loss_matches_jax_loss_fn(backend, hier):
    """``autograd_loss`` with the camera deltas of each ray's image and the
    anneal at alpha 0.35 (under "pallas" through ``fused_mlp`` with the
    input gradient, its plain version) against JAX's ``loss_fn`` pose
    branch (train/step.py:434-462) assembled from its public functions at
    the same batch, ts and ``im_b``: the loss and the gradients of the
    field(s) and of the ``dr``/``dt`` tables."""
    alpha = 0.35
    cfg = _pose_cfg(backend, pe_anneal_until=20, **(dict(hierarchical=True, Nc=N) if hier else {}))
    p = {"coarse": init_nerf_params(15, SMALL), "fine": init_nerf_params(16, SMALL)} if hier else \
        init_nerf_params(15, SMALL)
    rays_np, pix, ts, im_b = _batch(17)
    dr, dt = _deltas(18)
    js = jrenderer.RenderSettings(N=N, N_coarse=N if hier else 0, tn=2.0, tf=6.0)
    jr, jpix, jts = map(jnp.asarray, (rays_np, pix, ts))

    def jax_loss(params, cams):
        r = jrays.apply_cam_deltas(jr, cams["dr"][im_b], cams["dt"][im_b])
        a = jnp.float32(alpha)
        if hier:
            c, f = jrenderer.render_rays_hierarchical(params["coarse"], params["fine"], r, jax.random.PRNGKey(0), js,
                                                      _jm(SMALL), det_fine=True, ts_coarse=jts, enc_alpha=a)
            return jnp.mean((c.rgb - jpix) ** 2) + jnp.mean((f.rgb - jpix) ** 2)
        out = jrenderer.render_rays(params, r, jax.random.PRNGKey(0), js, _jm(SMALL), ts=jts, enc_alpha=a)
        return jnp.mean((out.rgb - jpix) ** 2)

    jloss, (jg, jcams) = jax.value_and_grad(jax_loss, argnums=(0, 1))(_jtree(p), {"dr": jnp.asarray(dr),
                                                                                 "dt": jnp.asarray(dt)})
    field = (NerfPair.from_jax_params if hier else NerfField.from_jax_params)(p, "cpu")
    cams = CamDeltas(3).copy_tables_({"dr": dr, "dt": dt})
    mlp.fused_mlp_backward.dx_launches = 0
    loss = autograd_loss(cfg, field, _t(rays_np), _t(pix), _t(ts), None, render_settings(cfg), det_fine=True,
                         cams=cams, im_b=torch.from_numpy(im_b), enc_alpha=alpha)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k in ("dr", "dt"):
        np.testing.assert_allclose(getattr(cams, k).grad.numpy(), np.asarray(jcams[k]), atol=1e-5, rtol=2e-3,
                                   err_msg=k)
    assert float(np.abs(np.asarray(jcams["dr"])).max()) > 0
    if hier:
        _assert_grads(_grads(field.coarse), jg["coarse"])
        _assert_grads(_grads(field.fine), jg["fine"])
    else:
        _assert_grads(_grads(field), jg)
    assert mlp.fused_mlp_backward.dx_launches == 0  # CPU: the plain versions, no launch


def test_pose_step_anneal_done_equals_no_anneal_and_moves_the_deltas():
    """One pose step (pallas, the plain kernels on CPU): past
    ``pe_anneal_until`` the loss equals the anneal-free config's bit for
    bit (every window is 1: no windows are passed at all); mid-anneal it
    differs; the deltas move once the warmup is over, not before; the
    kernel refusal names pose_opt, and the step warns of nothing."""
    rays_np, pix, _, _ = _batch(19)
    all_rays = _t(np.tile(rays_np, (6, 1)))  # 3 images of HW = 16 rays
    all_pix = _t(np.tile(pix, (6, 1)))
    assert kernel_refusal(_pose_cfg()).startswith("pose_opt")
    assert anneal_alpha(_pose_cfg(pe_anneal_until=4), 3) == 0.75
    assert anneal_alpha(_pose_cfg(pe_anneal_until=4), 4) is None

    def run(until, step0):
        cfg = _pose_cfg(pe_anneal_until=until)
        state = make_train_state(cfg, SMALL, "cpu", n_images=3)
        state.step = step0
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            loss = build_train_step(cfg, SMALL, rays_per_image=HW)(state, all_rays, all_pix)
        return loss.item(), state.cams.tables()["dr"]

    (done, _), (off, _), (mid, _), (mid_off, _) = run(4, 6), run(0, 6), run(4, 1), run(0, 1)
    assert done == off and mid != mid_off
    assert (run(0, 0)[1] == 0).all() and np.abs(run(0, 2)[1]).max() > 0  # warmup 2: lr 0 at steps 0, 1
    with pytest.raises(ValueError, match="rays_per_image"):
        build_train_step(_pose_cfg(), SMALL)
    with pytest.raises(ValueError, match="n_images"):
        make_train_state(_pose_cfg(), SMALL, "cpu")


def test_chunked_render_honors_enc_alpha():
    """``render_rays_chunked(enc_alpha=...)`` (mid-anneal previews) equals a
    direct ``render_rays`` at the same alpha on a chunk, differs from the
    full encoder, and does not take the fused render kernel."""
    field = NerfField.from_jax_params(init_nerf_params(20, SMALL), "cpu")
    r = _t(_batch(21)[0])
    s = RenderSettings(N=4, backend="pallas", fused_eval=True)
    mlp.fused_render.launches = 0
    rgb, _ = renderer.render_rays_chunked(field, r, 3, s, chunk=8, enc_alpha=0.4)
    with torch.no_grad():
        direct = renderer.render_rays(field, r, renderer.chunk_generator(3, 0, "cpu"), s, enc_alpha=0.4)
    np.testing.assert_allclose(rgb.numpy(), torch.clamp(direct.rgb, 0, 1).numpy(), atol=1e-6)
    assert not np.allclose(rgb.numpy(), renderer.render_rays_chunked(field, r, 3, s, chunk=8)[0].numpy(), atol=1e-4)
    with pytest.raises(ValueError, match="anneal"):
        renderer.render_rays_chunked(field, r, 3, dataclasses.replace(s, mip=True, base_radius=0.01), enc_alpha=0.4)


# --- the optimizer and the freeze -------------------------------------------------------------------------

def test_pose_lr_and_adam_match_optax_across_the_warmup():
    """The field and the deltas under the port's two Adam groups against
    the JAX ``multi_transform`` of optax's Adams: six updates, warmup 3
    (the deltas stand still, their moments and count run on), then the
    pose schedule."""
    kw = dict(datapath="d", lr_init=1e-3, lr_final=1e-5, num_iters=10, pose_opt=True, pose_warmup=3,
              pose_lr_init=2e-3, pose_lr_final=1e-4)
    cfg = config.TrainConfig(**kw)
    rng = np.random.default_rng(22)
    p0 = rng.normal(size=(5, 4)).astype(np.float32)
    dr0, dt0 = _deltas(23, 2)
    tx = jstep.make_optimizer(jconfig.TrainConfig(**kw))
    jp = {"field": jnp.asarray(p0), "cams": {"dr": jnp.asarray(dr0), "dt": jnp.asarray(dt0)}}
    st = tx.init(jp)
    p = torch.nn.Parameter(_t(p0))
    cams = CamDeltas(2).copy_tables_({"dr": dr0, "dt": dt0})
    opt = make_optimizer(cfg, [p], cams)
    assert [g["name"] for g in opt.param_groups] == ["field", "cams"] and opt.param_groups[1]["lr"] == 0.0
    lr0 = 5e-4
    decay = np.exp(np.log(1e-5 / 1e-3) / 10)
    for i in range(6):
        gp, gr, gt = (rng.normal(size=a.shape).astype(np.float32) for a in (p0, dr0, dt0))
        upd, st = tx.update({"field": jnp.asarray(gp), "cams": {"dr": jnp.asarray(gr), "dt": jnp.asarray(gt)}}, st, jp)
        jp = optax.apply_updates(jp, upd)
        p.grad, cams.dr.grad, cams.dt.grad = _t(gp), _t(gr), _t(gt)
        for group in opt.param_groups:
            group["lr"] = pose_lr(cfg, i) if group["name"] == "cams" else lr0 * decay**i
        opt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp["field"]), rtol=1e-6, atol=1e-7)
        for k in ("dr", "dt"):
            np.testing.assert_allclose(getattr(cams, k).detach().numpy(), np.asarray(jp["cams"][k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{k} {i}")
        if i < 3:
            assert (cams.dr.detach().numpy() == dr0).all()
    assert pose_lr(cfg, 2) == 0.0 and pose_lr(cfg, 3) == pytest.approx(2e-3 * (1e-4 / 2e-3) ** 0.3)


def test_freeze_pose_state_carries_the_field_moments():
    """``freeze_pose_state`` drops the deltas and their Adam group and
    carries the field's moments and step counts (the same tensors), so
    the plain optimizer runs on; the state is the plain config's."""
    cfg = _pose_cfg(pose_freeze_at=4)
    state = make_train_state(cfg, SMALL, "cpu", n_images=3)
    for i in range(2):
        for prm in (*state.field.parameters(), *state.cams.parameters()):
            prm.grad = torch.full_like(prm, 0.1 * (i + 1))
        state.optimizer.step()
    state.step = 2
    field_state = {prm: state.optimizer.state[prm] for prm in state.field.parameters()}
    new = freeze_pose_state(state)
    assert new.cams is None and new.step == 2 and new.field is state.field
    assert len(new.optimizer.param_groups) == 1
    assert len(new.optimizer.state) == len(field_state)
    for prm, st in field_state.items():
        got = new.optimizer.state[prm]
        assert int(got["step"]) == 2 and torch.equal(got["exp_avg"], st["exp_avg"])
        assert torch.equal(got["exp_avg_sq"], st["exp_avg_sq"]) and float(got["exp_avg"].abs().max()) > 0
    for prm in new.field.parameters():
        prm.grad = torch.ones_like(prm)
    new.optimizer.step()
    plain = make_train_state(dataclasses.replace(cfg, pose_opt=False, pose_freeze_at=0), SMALL, "cpu")
    assert new.optimizer.state_dict()["param_groups"][0]["params"] == \
        plain.optimizer.state_dict()["param_groups"][0]["params"]


# --- the config --------------------------------------------------------------------------------------------

POSE_RULES = [
    (dict(pose_opt=True, pose_lr_init=0.0), "must be positive"),
    (dict(pose_freeze_at=-1), "pose_freeze_at must be >= 0"),
    (dict(pose_freeze_at=400), "without pose_opt"),
    (dict(pose_opt=True, pose_freeze_at=200), "pose_warmup"),
    (dict(pose_opt=True, pose_freeze_at=4000), "num_iters"),
    (dict(pe_anneal_until=-1), "pe_anneal_until must be >= 0"),
    (dict(pe_anneal_until=100), "without pose_opt"),
    (dict(pose_opt=True, pe_anneal_until=100, mip=True), "mip"),
    (dict(pose_opt=True, pose_freeze_at=400, pe_anneal_until=500), "finish by pose_freeze_at"),
]


def test_pose_config_keys_load_and_each_rule_raises():
    """lego.yaml with the pose keys loads; each of JAX's pose rules raises
    in both packages; pose with mip or with proposal loads in both (the
    port composes them since Queue A item 1 landed), and pose with both
    (mip x proposal, Queue A item 2) loads in both too, the fused core
    refusing it (pose's path is autograd);
    pose with ``appearance_dim`` loads (the real-capture recipe), but not
    with ``pose_freeze_at`` (JAX's rule)."""
    d = config.load_yaml("configs/lego.yaml")
    keys = dict(pose_opt=True, pose_lr_init=2e-3, pose_lr_final=2e-5, pose_warmup=100, pose_freeze_at=1500,
                pe_anneal_until=1500)
    cfg = config.train_config_from_dict({**d, **keys})
    assert all(getattr(cfg, k) == v for k, v in keys.items())
    for kw, match in POSE_RULES:
        with pytest.raises(ValueError, match=match):
            config.TrainConfig(datapath="d", **kw)
        with pytest.raises(ValueError):
            jconfig.TrainConfig(datapath="d", **kw)
    for kw in (dict(pose_opt=True, mip=True), dict(pose_opt=True, proposal=True)):
        jconfig.TrainConfig(datapath="d", **kw)  # both packages compose them
        assert config.TrainConfig(datapath="d", **kw).pose_opt
    jconfig.TrainConfig(datapath="d", pose_opt=True, mip=True, proposal=True)
    cfg = config.TrainConfig(datapath="d", pose_opt=True, mip=True, proposal=True)
    assert cfg.pose_opt and cfg.mip and cfg.proposal and kernel_refusal(cfg).startswith("pose_opt")
    assert config.train_config_from_dict({**d, "pose_opt": True, "appearance_dim": 4}).appearance_dim == 4
    with pytest.raises(ValueError, match="pose_freeze_at cannot combine with appearance_dim"):
        config.train_config_from_dict({**d, **keys, "appearance_dim": 4})
    field = NerfField.from_jax_params(init_nerf_params(9, SMALL), "cpu")
    x16 = torch.zeros((16, 8), requires_grad=True)  # the input gradient under mip: 16 rows
    mlp.fused_mlp(mlp.pack_weights(field, differentiable=True), x16, torch.float32, SMALL, mip=True).sum().backward()
    assert x16.grad.shape == (16, 8) and (x16.grad[6:11] == 0).all()


def test_write_blender_scene_train_jitter_matches_jax(tmp_path):
    """``train_jitter`` jitters the train cameras' elevation as the JAX
    writer does: the same train poses for the same seed."""
    synthetic.write_blender_scene(str(tmp_path / "t"), 3, 1, 1, H=8, W=8, train_jitter=3)
    jsynth.write_blender_scene(str(tmp_path / "j"), 3, 1, 1, H=8, W=8, train_jitter=3)
    for split in ("train", "test"):
        got, want = (json.load(open(tmp_path / s / f"transforms_{split}.json")) for s in ("t", "j"))
        np.testing.assert_allclose([f["transform_matrix"] for f in got["frames"]],
                                   [f["transform_matrix"] for f in want["frames"]], atol=1e-6)
    flat = json.load(open(tmp_path / "t" / "transforms_train.json"))["frames"]
    assert len({round(f["transform_matrix"][2][3], 4) for f in flat}) == 3  # three elevations


# --- train() and eval ----------------------------------------------------------------------------------------

def test_train_through_a_freeze_resume_and_refined_stills(tmp_path, capsys, monkeypatch):
    """train() on CPU (pallas, the plain kernels) with pose_opt, the anneal
    and a freeze at 7 (aligned up to 10 by steps_per_call 5): the sidecar
    holds the deltas and the freeze step, the checkpoint before it holds
    ``{field, cams}`` and the ones after are plain, the npz export is
    plain; a resume past the freeze re-bakes the sidecar into the rays;
    ``evaluate.test`` renders the train stills from the refined poses (the
    rays baked with the sidecar's deltas) and the test stills unrefined."""
    from nerf_simple_tpu_torch.evaluate import test
    from nerf_simple_tpu_torch.train import loop
    from nerf_simple_tpu_torch.utils.png import decode_png

    scene = str(tmp_path / "scene")
    synthetic.write_blender_scene(scene, 3, 1, 1, H=12, W=12, train_jitter=3)
    cfg = dict(datapath=scene, savepath=str(tmp_path / "m"), exp_name="p", Nf=8, batch_size=32, net_H=32,
               net_Lp=4, net_Ld=2, half_res=False, backend="pallas", num_iters=20, steps_per_call=5,
               ckpt_loss=5, ckpt_images=10, ckpt_model=5, log_dir=str(tmp_path / "logs"), val_idxs=[0],
               pose_opt=True, pose_warmup=2, pose_freeze_at=7, pe_anneal_until=6, pose_lr_init=1e-2)
    bakes = []
    monkeypatch.setattr(loop, "bake_cam_deltas", lambda *a: bakes.append(a[1].cpu().numpy()) or
                        rays.bake_cam_deltas(*a))
    state = loop.train(cfg, device="cpu")
    out = capsys.readouterr().out
    exp = tmp_path / "m" / "p"
    assert "pose freeze at step 10" in out and state.cams is None and state.step == 20
    with np.load(exp / "cam_deltas.npz") as side:
        dr, dt, step = side["dr"], side["dt"], int(side["freeze_step"])
    assert step == 10 and dr.shape == (3, 3) and np.abs(dr).max() > 0 and len(bakes) == 1
    assert "field" in ckpt.checkpoint_params(str(exp / "ckpt_10.pth"))
    assert "trunk0" in ckpt.checkpoint_params(str(exp / "ckpt_15.pth"))
    assert "trunk0" in ckpt.import_params_npz(str(exp / "params_20.npz"))
    loop.train({**cfg, "num_iters": 25, "resume": True}, device="cpu")
    assert "resumed from" in capsys.readouterr().out and len(bakes) == 2
    np.testing.assert_array_equal(bakes[1], dr)

    ev = dict(loadpath=str(exp), datapath=scene, half_res=False, N_samples=8, batch_size=256, im_idxs=[0, 1])
    test({**ev, "im_set": "train", "savepath": str(tmp_path / "r")}, device="cpu")
    test({**ev, "im_set": "test", "im_idxs": [0], "savepath": str(tmp_path / "u")}, device="cpu")
    from nerf_simple_tpu_torch.data.blender import load_blender
    from nerf_simple_tpu_torch.data.dataset import RayDataset
    from nerf_simple_tpu_torch.evaluate import load_params

    field = NerfField.from_jax_params(load_params(str(exp)), "cpu", SMALL)
    rd = RayDataset.from_blender(load_blender(scene, False), "cpu")
    baked = rays.bake_cam_deltas(rd.rays["train"], _t(dr), _t(dt), 144)
    s = RenderSettings(N=8)
    for i in (0, 1):
        from nerf_simple_tpu_torch.render.renderer import derive_seed, render_image

        refined = render_image(field, baked, 12, 12, i, derive_seed(0, i), s, 256)[0][0]
        got = decode_png(open(tmp_path / "r" / "exp" / f"rgb_{i}.png", "rb").read())[:, 12:]
        assert np.abs(got.astype(int) - (refined * 255).astype(np.uint8).astype(int)).max() <= 1
        unrefined = render_image(field, rd.rays["train"], 12, 12, i, derive_seed(0, i), s, 256)[0][0]
        assert np.abs(refined - unrefined).max() > 1e-4  # the deltas moved the render
    got = decode_png(open(tmp_path / "u" / "exp" / "rgb_0.png", "rb").read())[:, 12:]
    want = (render_image(field, rd.rays["test"], 12, 12, 0, derive_seed(0, 0), s, 256)[0][0] * 255).astype(np.uint8)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert re.search(r"im 1: mse=", capsys.readouterr().out)
