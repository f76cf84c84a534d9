"""The port's mip slice (mip-NeRF cone casting) on CPU against the JAX
package: the integrated positional encoding, the frustum Gaussians,
interval compositing and the interval distortion, the fine level's
resampled edges, the forward with the integrated encoder (the plain
version as the wrapper runs it on CPU tensors, against the JAX Pallas
kernel in interpret mode and ``nerf_apply_mip``), B2's mip recompute, B1's
cone-cast variant (interval compositing, the per-ray loss weight, the
opaque tail, the interval rail, the weights output), the two-level fused
core and the autograd loss, the mip render, the config rules, train(),
evaluate.test and the server.

Inputs are made with numpy from a seed and handed to both packages; the
random draws of the two packages differ, so the comparisons hand both the
same edges (and the fine level's, from JAX's ``resample_edges(det=True)``).
The CUDA kernels are held to the plain versions on the card
(tests/test_torch_cuda.py).

Tolerances:

- ``gamma_ipe``, ``ipe_encoder``, ``frustum_gaussians_T``,
  ``conical_gaussian``, ``composite_intervals`` (with and without the
  opaque tail), ``distortion_loss_intervals`` and ``resample_edges(det=
  True)``: f32, rtol 1e-5 (atol 1e-6 where a value can be ~0: the damped
  high octaves, weights and edges near 0).
- The forward with ``mip=True`` against JAX's interpret-mode kernel and
  ``nerf_apply_mip``: f32 atol 1e-5 (JAX's own bound, tests/test_mip.py:
  312); bf16, atol 2e-3, the forward's bf16 bound (tests/test_torch_eval.
  py).
- B1 with ``mip=True`` and B2's mip recompute against JAX's kernels, and
  the fused and autograd cores against JAX's assembled from its public
  functions: f32 loss rtol 1e-4, gradients atol 1e-5 / rtol 2e-3
  (tests/test_mip.py:314, :492, tests/test_mip_proposal.py:495, :645-738);
  bf16 loss rtol 1e-3, each gradient tensor within 2e-2 of its largest
  entry (tests/test_torch_train.py's BF16 bound); the weights output atol
  1e-5 (f32) / 2e-3 (bf16).
- The renders at the same edges, f32: rgb and weights atol 1e-5,
  disparity rtol 1e-5 (tests/test_torch_hierarchical.py).
- The port's fused step against its autograd path from one state, after
  steps: JAX's rule (tests/test_mip.py:492): loss rtol 1e-4, parameters
  atol 5e-5 / rtol 2e-3.
"""

import dataclasses
import json
import math
import os
import re
import sys
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import nerf_simple_tpu.config as jconfig
import nerf_simple_tpu.kernels.mlp as jmlp
import nerf_simple_tpu.models.nerf as jnerf
import nerf_simple_tpu.ops.encoding as jencoding
import nerf_simple_tpu.ops.sampling as jsampling
import nerf_simple_tpu.ops.volume as jvolume
import nerf_simple_tpu.render.renderer as jrenderer
from nerf_simple_tpu_torch import config
from nerf_simple_tpu_torch.kernels import mlp
from nerf_simple_tpu_torch.models.nerf import NerfField, NerfMLP, init_nerf_params, nerf_apply_mip
from nerf_simple_tpu_torch.ops import encoding, sampling, volume
from nerf_simple_tpu_torch.render import renderer
from nerf_simple_tpu_torch.render.renderer import RenderSettings
from nerf_simple_tpu_torch.train.loop import train
from nerf_simple_tpu_torch.train.step import (
    autograd_loss,
    build_train_step,
    build_x16_mip,
    make_train_state,
    mip_fused_loss,
    render_settings,
)

SMALL = NerfMLP(Lp=4, Ld=2, H=32)
B, N = 8, 16
TN, TF, LAM, RADIUS = 2.0, 6.0, 0.05, 0.02
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]
DTYPE_IDS = ["f32", "bf16"]
BF16_GRAD_TOL, BF16_LOSS_RTOL = 2e-2, 1e-3


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


def _rays(n, seed):
    """Rays from a radius-4 shell towards the origin, their gt colours."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    o = -4.0 * d / np.linalg.norm(d, axis=1, keepdims=True) + rng.normal(0, 0.2, (n, 3))
    return (np.concatenate([o, d], 1).astype(np.float32),
            rng.uniform(0, 1, (n, 3)).astype(np.float32))


def _edges(n, N_, seed):
    return np.sort(np.random.default_rng(seed).uniform(TN, TF, (n, N_ + 1)), -1).astype(np.float32)


def _jx16(rays, edges, pix, lw=None):
    """The fused step's mip input, built by the port (compared with JAX's
    moments in test_build_x16_mip_layout), as numpy, with the loss
    weights ``lw`` (B,) on row 14."""
    x = build_x16_mip(_t(rays), _t(edges), _t(pix), RADIUS).numpy().copy()
    if lw is not None:
        x[14] = np.repeat(lw, edges.shape[1] - 1)
    return x


# --- the encoder, the Gaussians, interval compositing ----------------------------------------

def test_gamma_ipe_and_ipe_encoder_match_jax():
    rng = np.random.default_rng(0)
    mean = rng.normal(0, 2, (64, 3)).astype(np.float32)
    var = rng.uniform(0, 0.05, (64, 3)).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    got = encoding.gamma_ipe(_t(mean), _t(var), 6).numpy()
    np.testing.assert_allclose(got, np.asarray(jencoding.gamma_ipe(jnp.asarray(mean), jnp.asarray(var), 6)),
                               rtol=1e-5, atol=1e-6)
    assert torch.equal(encoding.gamma_ipe(_t(mean), torch.zeros(64, 3), 6), encoding.gamma(_t(mean), 6))
    px, pd = encoding.ipe_encoder(_t(mean), _t(var), _t(d), 4, 2)
    jpx, jpd = jencoding.ipe_encoder(jnp.asarray(mean), jnp.asarray(var), jnp.asarray(d), 4, 2)
    assert px.shape == (64, 3 + 24) and pd.shape == (64, 3 + 12)
    np.testing.assert_allclose(px.numpy(), np.asarray(jpx), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pd.numpy(), np.asarray(jpd), rtol=1e-5, atol=1e-6)


def test_frustum_gaussians_and_conical_gaussian_match_jax():
    rays, _ = _rays(B, 1)
    edges = _edges(B, N, 2)
    radius = np.random.default_rng(3).uniform(0.01, 0.05, (B, 1)).astype(np.float32)
    for r in (RADIUS, radius):
        rr = r if isinstance(r, float) else _t(r)
        got = sampling.frustum_gaussians_T(_t(rays), _t(edges), rr)
        jr = r if isinstance(r, float) else jnp.asarray(r)
        want = jsampling.frustum_gaussians_T(jnp.asarray(rays), jnp.asarray(edges), jr)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
        got = sampling.conical_gaussian(_t(rays), _t(edges), rr)
        want = jsampling.conical_gaussian(jnp.asarray(rays), jnp.asarray(edges), jr)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    with pytest.raises(NotImplementedError, match="LLFF/NDC"):
        sampling.conical_gaussian(_t(rays), _t(edges), RADIUS, "cylinder")


def test_build_x16_mip_layout():
    """Rows of the fused step's mip input against JAX's moments (JAX's
    _build_x16_mip is a closure of its train step; its layout:
    train/step.py:642-681)."""
    rays, pix = _rays(B, 4)
    edges = _edges(B, N, 5)
    x = build_x16_mip(_t(rays), _t(edges), _t(pix), RADIUS).numpy().reshape(16, B, N)
    meanT, unitT, varT, _ = (np.asarray(a) for a in jsampling.frustum_gaussians_T(
        jnp.asarray(rays), jnp.asarray(edges), RADIUS))
    np.testing.assert_allclose(x[0:3], meanT, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(x[3:6], np.broadcast_to(unitT[:, :, None], (3, B, N)), rtol=1e-6)
    np.testing.assert_allclose(x[6], np.diff(edges, axis=1), rtol=1e-6)
    np.testing.assert_array_equal(x[7], edges[:, :-1])
    np.testing.assert_array_equal(x[8:11], np.broadcast_to(pix.T[:, :, None], (3, B, N)))
    np.testing.assert_allclose(x[11:14], varT, rtol=1e-5, atol=1e-9)
    assert (x[14] == 1).all() and (x[15] == 0).all()


@pytest.mark.parametrize("opaque", [False, True], ids=["finite", "opaque"])
def test_composite_intervals_and_distortion_intervals_match_jax(opaque):
    rng = np.random.default_rng(6)
    rgb_sigma = rng.normal(0, 2, (B, N, 4)).astype(np.float32)
    edges = _edges(B, N, 7)
    mids = 0.5 * (edges[:, 1:] + edges[:, :-1])
    d = rng.normal(size=(B, 3)).astype(np.float32)
    u = d / np.linalg.norm(d, axis=1, keepdims=True)
    got = volume.composite_intervals(_t(rgb_sigma), _t(edges), _t(mids), _t(u), opaque_tail=opaque)
    want = jvolume.composite_intervals(*(jnp.asarray(a) for a in (rgb_sigma, edges, mids, u)), opaque_tail=opaque)
    for f in ("rgb", "alpha", "acc", "weights", "depth", "disp"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)), rtol=1e-5, atol=1e-6,
                                   err_msg=f)
    if opaque:
        np.testing.assert_allclose(got.acc.numpy(), 1.0, rtol=1e-6)  # the absorber takes what is left
    w = rng.uniform(0, 0.2, (B, N)).astype(np.float32)
    s = (edges - TN) / (TF - TN)
    got = volume.distortion_loss_intervals(_t(w), _t(s), opaque_tail=opaque)
    np.testing.assert_allclose(float(got), float(jvolume.distortion_loss_intervals(
        jnp.asarray(w), jnp.asarray(s), opaque_tail=opaque)), rtol=1e-5)


def test_resample_edges_matches_jax_and_draws_sorted_edges():
    rng = np.random.default_rng(8)
    edges = _edges(B, N, 9)
    w = rng.uniform(0, 1, (B, N)).astype(np.float32) ** 4
    for blur in (0.01, 0.0):
        got = sampling.resample_edges(None, _t(edges), _t(w), N + 4, blur=blur, det=True)
        want = jsampling.resample_edges(jax.random.PRNGKey(0), jnp.asarray(edges), jnp.asarray(w), N + 4, blur=blur,
                                        det=True)
        assert got.shape == (B, N + 5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    g = torch.Generator()
    g.manual_seed(0)
    drawn = sampling.resample_edges(g, _t(edges), _t(w), 64)
    assert (torch.diff(drawn, dim=1) >= 0).all()
    assert (drawn >= _t(edges[:, :1]) - 1e-5).all() and (drawn <= _t(edges[:, -1:]) + 1e-5).all()


# --- the kernels' plain versions against the JAX kernels -----------------------------------------

def _mip_x(rows, seed):
    rng = np.random.default_rng(seed)
    x = np.zeros((16, rows), np.float32)
    x[0:3] = rng.normal(0, 1.5, (3, rows))
    d = rng.normal(size=(3, rows))
    x[3:6] = d / np.linalg.norm(d, axis=0)
    x[11:14] = rng.uniform(0, 0.05, (3, rows))
    return x


@pytest.mark.parametrize("dt, jdt", DTYPES, ids=DTYPE_IDS)
def test_fused_mlp_forward_mip_matches_jax(dt, jdt):
    """The forward with the integrated encoder (its plain version, which
    the wrapper runs on a CPU tensor) against JAX's interpret-mode kernel
    with mip=True and, in f32, ``nerf_apply_mip`` of both packages."""
    params = init_nerf_params(10, SMALL)
    x = _mip_x(128, 11)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jmlp.fused_mlp_forward(jmlp.pack_weights(_jtree(params), model=_jm(SMALL)),
                                                 jnp.asarray(x), 128, jdt, _jm(SMALL), True))
    field = NerfField.from_jax_params(params, "cpu")
    mlp.fused_mlp_forward.launches = mlp.fused_mlp_forward.mip_launches = 0
    got = mlp.fused_mlp_forward(mlp.pack_weights(field), _t(x), dt, SMALL, mip=True).numpy()
    assert mlp.fused_mlp_forward.launches == mlp.fused_mlp_forward.mip_launches == 0  # CPU: plain
    np.testing.assert_allclose(got[:4], want[:4], atol=1e-5 if dt == torch.float32 else 2e-3)
    assert (got[4:] == 0).all()
    if dt == torch.float32:
        japply = np.asarray(jnerf.nerf_apply_mip(_jtree(params), *(jnp.asarray(x[r].T) for r in
                                                                   (slice(0, 3), slice(11, 14), slice(3, 6))),
                                                 _jm(SMALL)))
        np.testing.assert_allclose(got[:4].T, japply, atol=1e-5)
        with torch.no_grad():
            mine = nerf_apply_mip(field, *(_t(x[r].T) for r in (slice(0, 3), slice(11, 14), slice(3, 6))))
        np.testing.assert_allclose(mine.numpy(), japply, atol=1e-5)
    with pytest.raises(ValueError, match="16"):  # the wrapper wants 16 rows under mip on the card
        mlp._check_launch("fused_mlp_fwd", mlp.pack_weights(field), _t(x[:8]), "xT", mlp._x_rows(True),
                          torch.float32, SMALL)


@pytest.mark.parametrize("dt, jdt", DTYPES, ids=DTYPE_IDS)
def test_fused_mlp_backward_mip_matches_jax(dt, jdt):
    """B2's mip recompute: ``fused_mlp(mip=True)``'s backward (its plain
    version) through the pack against JAX's ``_fused_mlp_bwd`` with
    mip=True through ``jax.vjp(pack_weights)``."""
    params = init_nerf_params(12, SMALL)
    x = _mip_x(128, 13)
    g = np.zeros((8, 128), np.float32)
    g[:4] = np.random.default_rng(14).normal(size=(4, 128)) * 0.1
    with pltpu.force_tpu_interpret_mode():
        wts, vjp = jax.vjp(lambda p: jmlp.pack_weights(p, model=_jm(SMALL)), _jtree(params))
        want = vjp(jmlp._fused_mlp_bwd(wts, jnp.asarray(x), jnp.asarray(g), 128, jdt, _jm(SMALL), True))[0]
    field = NerfField.from_jax_params(params, "cpu")
    out = mlp.fused_mlp(mlp.pack_weights(field, differentiable=True), _t(x), dt, SMALL, mip=True)
    out.backward(_t(g))
    _assert_grads(_grads(field), want, dt)


MIP_CASES = {  # B1's cone-cast cases of chip_smoke's mip phase, and the two-level combination's coarse pass
    "plain": dict(),
    "weights": dict(out_weights=True),
    "opaque": dict(opaque_tail=True),
    "rail": dict(dist=(LAM, TN, TF, False), lw=True),
    "rail-opaque-disparity": dict(dist=(LAM, TN, TF, True), opaque_tail=True, lw=True),
}


@pytest.mark.parametrize("dt, jdt", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("case", list(MIP_CASES))
def test_fused_train_step_mip_matches_jax(case, dt, jdt):
    """B1 with mip=True (its plain version, as the wrapper runs it on CPU)
    against JAX's interpret-mode kernel at the same x16: interval
    compositing, the weights output, the opaque tail, the interval rail
    with non-unit loss weights on row 14 (linear and disparity s)."""
    kw = dict(MIP_CASES[case])
    lw = np.random.default_rng(15).uniform(0.25, 2.0, B).astype(np.float32) if kw.pop("lw", False) else None
    params = init_nerf_params(16, SMALL)
    rays, pix = _rays(B, 17)
    x = _jx16(rays, _edges(B, N, 18), pix, lw)
    with pltpu.force_tpu_interpret_mode():
        wts, vjp = jax.vjp(lambda p: jmlp.pack_weights(p, model=_jm(SMALL)), _jtree(params))
        jout = jmlp.fused_train_step(wts, jnp.asarray(x), N, B * N, jdt, model=_jm(SMALL), mip=True, **kw)
        want = vjp(jout[1])[0]
    field = NerfField.from_jax_params(params, "cpu")
    packed = mlp.pack_weights(field, differentiable=True)
    mlp.fused_train_step.launches = mlp.fused_train_step.mip_launches = 0
    out = mlp.fused_train_step(packed, _t(x), N, dt, SMALL, mip=True, **kw)
    assert mlp.fused_train_step.launches == mlp.fused_train_step.mip_launches == 0  # CPU: plain
    torch.autograd.backward(list(packed), list(out[1]))
    np.testing.assert_allclose(float(out[0]), float(jout[0]), rtol=1e-4 if dt == torch.float32 else BF16_LOSS_RTOL)
    _assert_grads(_grads(field), want, dt)
    if kw.get("out_weights"):
        np.testing.assert_allclose(out[2].numpy(), np.asarray(jout[2]), atol=1e-5 if dt == torch.float32 else 2e-3)
    with pytest.raises(ValueError, match="needs mip"):
        mlp.fused_train_step(packed, _t(x), N, dt, SMALL, opaque_tail=True)


def test_fused_train_step_mip_plain_equals_autograd_of_the_render_path():
    """At f32 B1's cone-cast math equals autograd through the mip render's
    plain path with the interval distortion (opaque tail, loss weights
    1): the compositing gradient, the rail, the damped-posx backprop."""
    params = init_nerf_params(19, SMALL)
    rays, pix = _rays(B, 20)
    edges = _edges(B, N, 21)
    f1 = NerfField.from_jax_params(params, "cpu")
    packed = mlp.pack_weights(f1, differentiable=True)
    loss, dw = mlp.fused_train_step(packed, _t(_jx16(rays, edges, pix)), N, torch.float32, SMALL,
                                    dist=(LAM, TN, TF, False), mip=True, opaque_tail=True)
    torch.autograd.backward(list(packed), list(dw))
    f2 = NerfField.from_jax_params(params, "cpu")
    s = RenderSettings(N=N, mip=True, base_radius=RADIUS, opaque_background=True)
    out = renderer.render_rays_mip(f2, _t(rays), None, s, edges=_t(edges))
    ref = torch.mean((out.rgb - _t(pix)) ** 2) + LAM * volume.distortion_loss_intervals(
        out.weights, (_t(edges) - TN) / (TF - TN), opaque_tail=True)
    ref.backward()
    np.testing.assert_allclose(float(loss), ref.item(), rtol=1e-5)
    _assert_grads(_grads(f1), _grads(f2))


# --- the cores, the render and the step ---------------------------------------------------------

def _jax_two_level_fused(params, rays, pix, edges, jdt, cw, opaque):
    """JAX's fused two-level mip core (train/step.py:950-973) from its
    public functions, in interpret mode: the coarse launch with the
    weights output, ``resample_edges(det=True)`` of them, the fine launch
    on the same packed weights, ``cw * dw_c + dw_f`` through one vjp."""
    with pltpu.force_tpu_interpret_mode():
        wts, vjp = jax.vjp(lambda p: jmlp.pack_weights(p, model=_jm(SMALL)), _jtree(params))
        loss_c, dw_c, w_c = jmlp.fused_train_step(wts, jnp.asarray(_jx16(rays, edges, pix)), N, B * N, jdt,
                                                  out_weights=True, model=_jm(SMALL), mip=True, opaque_tail=opaque)
        edges_f = np.asarray(jsampling.resample_edges(jax.random.PRNGKey(0), jnp.asarray(edges), w_c, N, det=True))
        loss_f, dw_f = jmlp.fused_train_step(wts, jnp.asarray(_jx16(rays, edges_f, pix)), N, B * N, jdt,
                                             model=_jm(SMALL), mip=True, opaque_tail=opaque)
        want = vjp(jax.tree.map(lambda a, b: cw * a + b, dw_c, dw_f))[0]
    return float(cw * loss_c + loss_f), want, edges_f


@pytest.mark.parametrize("dt, jdt", DTYPES, ids=DTYPE_IDS)
def test_mip_fused_two_level_core_matches_jax(dt, jdt):
    """``mip_fused_loss`` at mip_levels 2 (two B1 launches on one pack:
    their plain versions on CPU) against JAX's fused two-level core, the
    fine edges JAX's."""
    params = init_nerf_params(22, SMALL)
    rays, pix = _rays(B, 23)
    edges = _edges(B, N, 24)
    cw = 0.1
    jloss, want, jedges_f = _jax_two_level_fused(params, rays, pix, edges, jdt, cw, False)
    field = NerfField.from_jax_params(params, "cpu")
    mlp.fused_train_step.launches = 0
    loss = mip_fused_loss(field, _t(rays), _t(pix), _t(edges), None, dt, SMALL, RADIUS, mip_levels=2,
                          coarse_weight=cw, edges_fine=_t(jedges_f))
    assert mlp.fused_train_step.launches == 0  # CPU: plain
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-4 if dt == torch.float32 else BF16_LOSS_RTOL)
    _assert_grads(_grads(field), want, dt)


def _mip_cfg(backend, **kw):
    return config.TrainConfig(**{**dict(datapath="d", Nf=N, mip=True, batch_size=B, backend=backend, net_H=32,
                                        net_Lp=4, net_Ld=2), **kw})


def _jax_depth_term(out, gt_d):
    valid = jnp.isfinite(gt_d) & (gt_d > 0)
    return jnp.sum(jnp.where(valid, (out.depth - gt_d) ** 2, 0.0)) / jnp.maximum(jnp.sum(valid), 1)


@pytest.mark.parametrize("kw", [dict(mip_levels=2, mip_coarse_weight=0.3, depth_loss_weight=0.2),
                                dict(distortion_loss_weight=LAM, opaque_background=True,
                                     sampling_space="disparity")],
                         ids=["two-level-depth", "one-level-rail-opaque"])
def test_autograd_mip_loss_matches_jax_loss_fn(kw):
    """``autograd_loss``'s mip branch against JAX's ``loss_fn`` (its mip
    branches, train/step.py:548-611) from its public functions at the same
    edges: ``_mip_level`` at the coarse and at JAX's fine edges, the
    weighted two-level MSE and the depth term, or one level's MSE and the
    interval distortion in s-space; f32, loss and gradients."""
    cfg = _mip_cfg("xla", **kw)
    params = init_nerf_params(25, SMALL)
    rays, pix = _rays(B, 26)
    edges = _edges(B, N, 27)
    gt_d = np.random.default_rng(28).uniform(3, 5, B).astype(np.float32)
    gt_d[2] = 0.0  # a hole
    js = jrenderer.RenderSettings(N=N, tn=TN, tf=TF, mip=True, base_radius=RADIUS, mip_levels=cfg.mip_levels,
                                  opaque_background=cfg.opaque_background, sampling_space=cfg.sampling_space)
    jr, jpix, jgt, jedges = (jnp.asarray(a) for a in (rays, pix, gt_d, edges))
    edges_f = None

    if cfg.mip_levels == 2:
        out_c = jrenderer._mip_level(_jtree(params), jr, jedges, js, _jm(SMALL))
        edges_f = jsampling.resample_edges(jax.random.PRNGKey(0), jedges, out_c.weights, N, det=True)

    def jax_loss(p):
        out = jrenderer._mip_level(p, jr, jedges, js, _jm(SMALL))
        if cfg.mip_levels == 2:
            out_f = jrenderer._mip_level(p, jr, edges_f, js, _jm(SMALL))
            loss = cfg.mip_coarse_weight * jnp.mean((out.rgb - jpix) ** 2) + jnp.mean((out_f.rgb - jpix) ** 2)
            out = out_f
        else:
            loss = jnp.mean((out.rgb - jpix) ** 2)
        if cfg.depth_loss_weight > 0:
            loss = loss + cfg.depth_loss_weight * _jax_depth_term(out, jgt)
        if cfg.distortion_loss_weight > 0:
            s = (1.0 / TN - 1.0 / jnp.maximum(jedges, 1e-10)) / (1.0 / TN - 1.0 / TF)
            loss = loss + cfg.distortion_loss_weight * jvolume.distortion_loss_intervals(
                out.weights, s, opaque_tail=cfg.opaque_background)
        return loss

    jloss, want = jax.value_and_grad(jax_loss)(_jtree(params))
    field = NerfField.from_jax_params(params, "cpu")
    pix_b = _t(pix)
    if cfg.depth_loss_weight > 0:
        pix_b = torch.cat([pix_b, _t(gt_d)[:, None]], 1)
    loss = autograd_loss(cfg, field, _t(rays), pix_b, _t(edges), None, render_settings(cfg, RADIUS),
                         edges_fine=None if edges_f is None else _t(edges_f))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    _assert_grads(_grads(field), want)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_render_rays_mip_matches_jax(backend):
    """Both levels of the mip render at the same coarse edges (the fine
    ones JAX's quantile resampling of its coarse weights) against JAX's
    ``_mip_level`` (xla), with and without the opaque tail; the port's
    pallas path runs the forward kernel's plain version with the
    integrated encoder."""
    params = init_nerf_params(29, SMALL)
    rays, _ = _rays(B, 30)
    edges = _edges(B, N, 31)
    field = NerfField.from_jax_params(params, "cpu")
    for opaque in (False, True):
        s = RenderSettings(N=N, backend=backend, mip=True, mip_levels=2, base_radius=RADIUS,
                           opaque_background=opaque)
        js = jrenderer.RenderSettings(N=N, mip=True, mip_levels=2, base_radius=RADIUS, opaque_background=opaque)
        jc = jrenderer._mip_level(_jtree(params), jnp.asarray(rays), jnp.asarray(edges), js, _jm(SMALL))
        jedges_f = jsampling.resample_edges(jax.random.PRNGKey(0), jnp.asarray(edges), jc.weights, N, det=True)
        jf = jrenderer._mip_level(_jtree(params), jnp.asarray(rays), jedges_f, js, _jm(SMALL))
        with torch.no_grad():
            oc, of = renderer.render_rays_mip(field, _t(rays), None, s, edges=_t(edges),
                                              edges_fine=_t(jedges_f), return_coarse=True)
        for got, want in ((oc, jc), (of, jf)):
            np.testing.assert_allclose(got.rgb.numpy(), np.asarray(want.rgb), atol=1e-5)
            np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights), atol=1e-5)
            np.testing.assert_allclose(got.disp.numpy(), np.asarray(want.disp), rtol=1e-5)


def test_render_rays_chunked_mip_and_normals():
    """A chunked mip frame: every chunk through the mip render (the
    forward kernel's plain version with mip, never the fused render),
    reproducible from its seed, a wider cone changes it; normals render
    point samples; mip takes no ts."""
    field = NerfField.from_jax_params(init_nerf_params(32, SMALL), "cpu")
    rays, _ = _rays(100, 33)
    s = RenderSettings(N=N, backend="pallas", mip=True, mip_levels=2, base_radius=RADIUS, fused_eval=True)
    mlp.fused_render.launches = 0
    rgb, disp = renderer.render_rays_chunked(field, _t(rays), 3, s, chunk=32)
    assert rgb.shape == (100, 3) and torch.isfinite(disp).all() and float(rgb.max()) <= 1.0
    assert torch.equal(rgb, renderer.render_rays_chunked(field, _t(rays), 3, s, chunk=32)[0])
    wide = renderer.render_rays_chunked(field, _t(rays), 3, dataclasses.replace(s, base_radius=0.3), chunk=32)[0]
    assert not torch.allclose(rgb, wide, atol=1e-4)
    nrm = renderer.render_normals_chunked(field, _t(rays), 3, s, chunk=32)
    point = renderer.render_normals_chunked(field, _t(rays), 3, RenderSettings(N=N), chunk=32)
    assert torch.equal(nrm, point)
    with pytest.raises(ValueError, match="interval edges"):
        renderer.render_rays(field, _t(rays), None, s, ts=torch.zeros(100, N))


def test_fused_mip_step_matches_the_autograd_path():
    """Fused (two B1 launches a step), two-kernel autograd (fused_mlp with
    mip, i.e. the forward and B2) and plain autograd steps from one state
    at mip_levels 2 with an opaque tail, then at one level with the
    interval rail: the same losses, and after the steps the same
    parameters under JAX's rule. Each path draws the same edges (one
    generator stream)."""
    rays, pix = (_t(a) for a in _rays(300, 34))
    for kw in (dict(mip_levels=2, opaque_background=True), dict(distortion_loss_weight=LAM)):
        runs = {}
        for name, backend, fused in (("fused", "pallas", True), ("two-kernel", "pallas", False),
                                     ("plain", "xla", None)):
            cfg = _mip_cfg(backend, num_iters=8, batch_size=32, **kw)
            state = make_train_state(cfg, SMALL, "cpu")
            if fused is False:
                with pytest.warns(UserWarning, match="fused train kernel"):
                    fn = build_train_step(cfg, SMALL, fused=False, base_radius=RADIUS)
            else:
                fn = build_train_step(cfg, SMALL, fused=fused, base_radius=RADIUS)
            runs[name] = np.array([float(fn(state, rays, pix)) for _ in range(3)]), state.field.to_jax_params()
        want_loss, want = runs["plain"]
        for name in ("fused", "two-kernel"):
            losses, got = runs[name]
            np.testing.assert_allclose(losses, want_loss, rtol=1e-4)
            for layer in want:
                for p in ("w", "b"):
                    np.testing.assert_allclose(got[layer][p], want[layer][p], atol=5e-5, rtol=2e-3,
                                               err_msg=f"{kw} {name} {layer}/{p}")


def test_mip_sigma_noise_takes_the_autograd_path_through_b2():
    """sigma noise under mip: JAX's warning and the autograd path through
    ``fused_mlp`` with mip (B2's recompute on the card; its plain version
    here), the noise drawn from the step's generator; the loss is finite
    and the step is reproducible from the seed."""
    rays, pix = (_t(a) for a in _rays(64, 35))
    cfg = _mip_cfg("pallas", mip_levels=2, sigma_noise=1.0, batch_size=16)
    losses = []
    for _ in range(2):
        state = make_train_state(cfg, SMALL, "cpu")
        with pytest.warns(UserWarning, match="sigma_noise"):
            fn = build_train_step(cfg, SMALL, base_radius=RADIUS)
        losses.append([float(fn(state, rays, pix)) for _ in range(2)])
    assert np.isfinite(losses).all() and losses[0] == losses[1]
    with pytest.raises(ValueError, match="base_radius"):
        build_train_step(cfg, SMALL)


# --- the config, train(), evaluate.test and the server ---------------------------------------------

def test_lego_mip_yaml_loads_and_each_rule_raises():
    d = config.load_yaml("configs/lego_mip.yaml")
    cfg = config.train_config_from_dict(d)
    assert (cfg.mip, cfg.mip_levels, cfg.mip_coarse_weight, cfg.backend) == (True, 2, 0.1, "pallas")
    tcfg = config.test_config_from_dict(d)
    assert (tcfg.mip, tcfg.mip_levels, tcfg.N_samples) == (True, 2, 128)
    base = dict(datapath="d")
    for kw, match in ((dict(mip=True, hierarchical=True), "incompatible"), (dict(mip_levels=3), "mip_levels"),
                      (dict(mip=True, resample_blur=-1.0), "resample_blur"),
                      (dict(opaque_background=True), "needs mip=True"), (dict(mip_levels=2), "requires mip"),
                      (dict(mip=True, mip_levels=2, proposal=True), "both define the coarse level"),
                      (dict(mip=True, mip_levels=2, distortion_loss_weight=0.1), "not supported"),
                      (dict(mip=True, mip_coarse_weight=-1.0), "mip_coarse_weight")):
        for mod in (config, jconfig):
            with pytest.raises(ValueError, match=match):
                mod.TrainConfig(**base, **kw)
    tbase = dict(loadpath="m", datapath="d")
    for kw, match in ((dict(mip=True, Nc=8), "cone-cast eval"), (dict(mip=True, mip_levels=2, Np=8), "coarse level"),
                      (dict(mip_levels=2), "requires mip"), (dict(mip_levels=0), "mip_levels")):
        for mod in (config, jconfig):
            with pytest.raises(ValueError, match=match):
                mod.TestConfig(**tbase, **kw)
    with pytest.raises(NotImplementedError, match="mip x proposal"):
        config.TrainConfig(**base, mip=True, proposal=True)
    with pytest.raises(NotImplementedError, match="mip x proposal"):
        config.TestConfig(**tbase, mip=True, Np=8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        config.train_config_from_dict({**base, "mip": True, "mip_multiscale": True})
    assert config.train_config_from_dict({**base, "mip": True, "contract": True}).contract  # ported
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 2"):  # with proposal: mip x proposal
        config.train_config_from_dict({**base, "mip": True, "proposal": True, "contract": True})
    with pytest.raises(ValueError, match="excludes hierarchical"):  # JAX serve.py:59-65
        RenderSettings(mip=True, N_coarse=8)


def test_train_evaluate_and_serve_mip_on_cpu(tmp_path, capsys, monkeypatch):
    """train() a tiny two-level mip run (the fused core's plain version):
    falling loss, val renders, exports; the cone radius is the frames'
    2 / sqrt(12) / f. Then evaluate.test with the mip test_params (stills
    with PSNR, PNGs); the server with --mip --mip-levels 2 (a frame equal
    to render_rays_chunked's, /health says mip)."""
    from nerf_simple_tpu_torch import serve
    from nerf_simple_tpu_torch.data.synthetic import write_blender_scene
    from nerf_simple_tpu_torch.evaluate import load_params, test
    from nerf_simple_tpu_torch.serve import RenderServer

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # CSV logging, as on the card's machine
    scene = str(tmp_path / "scene")
    write_blender_scene(scene, n_train=4, n_val=1, n_test=2, H=20, W=20)
    cfg = dict(datapath=scene, savepath=str(tmp_path / "models"), exp_name="m", Nf=N, mip=True, mip_levels=2,
               num_iters=40, ckpt_model=40, ckpt_loss=1, ckpt_images=20, batch_size=64, half_res=False,
               val_idxs=[0], num_train_imgs=4, backend="pallas", compute_dtype="f32", steps_per_call=10,
               net_H=32, net_Lp=4, net_Ld=2, log_dir=str(tmp_path / "logs"), honor_lr_init=True, lr_init=5e-3,
               lr_final=5e-4)
    seen = []
    real_build = build_train_step

    def spy(c, m, fused=None, base_radius=0.0):
        seen.append(base_radius)
        return real_build(c, m, fused, base_radius)

    monkeypatch.setattr("nerf_simple_tpu_torch.train.loop.build_train_step", spy)
    state = train(cfg, device="cpu")
    out = capsys.readouterr().out
    from nerf_simple_tpu_torch.data.blender import load_blender

    f = load_blender(scene, False, 4).f
    assert seen == [pytest.approx(2.0 / math.sqrt(12.0) / f)]
    losses = [float(line.split()[1]) for line in out.splitlines() if line.startswith("loss:")]
    assert len(losses) == 40 and np.mean(losses[-10:]) < 0.8 * np.mean(losses[:10])
    assert "Val image 0 | iter: 30 | PSNR" in out
    exp = tmp_path / "models" / "m"
    np.testing.assert_array_equal(load_params(str(exp / "params_40.pth"))["skip"]["w"],
                                  state.field.to_jax_params()["skip"]["w"])  # a plain NerfMLP checkpoint

    tp = dict(loadpath=str(exp), datapath=scene, savepath=str(tmp_path / "res"), exp_name="e", batch_size=256,
              half_res=False, im_idxs=[0, 1], N_samples=N, mip=True, mip_levels=2, backend="pallas", normals=True)
    test(tp, device="cpu")
    got = capsys.readouterr().out
    psnr = [float(p) for p in re.findall(r"im \d+: mse=\S+ psnr=(\S+)", got)]
    assert len(psnr) == 2 and min(psnr) > 10.0
    assert {"rgb_0.png", "depth_1.png", "normal_0.png"} <= set(os.listdir(tmp_path / "res" / "e"))

    params = load_params(str(exp / "params_40.npz"))
    settings = RenderSettings(N=N, backend="pallas", mip=True, mip_levels=2, base_radius=0.05)
    srv = RenderServer(params, 8, 8, 20.0, settings, model=SMALL, device="cpu")
    frame = srv.render(4.0, -30.0, 60.0)
    from nerf_simple_tpu_torch.ops.rays import rays_for_poses, spherical_to_pose

    rays = rays_for_poses(torch.as_tensor(spherical_to_pose(4.0, -30.0, 60.0)[None], dtype=torch.float32), 8, 8,
                          20.0)
    rgb, _ = renderer.render_rays_chunked(srv.field, rays, srv.seed, settings)
    np.testing.assert_array_equal(frame, (np.clip(rgb.reshape(8, 8, 3).numpy(), 0, 1) * 255).astype(np.uint8))
    httpd = serve.serve(srv, 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{httpd.server_address[1]}/health", timeout=60) as r:
            assert json.loads(r.read())["mip"] is True
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    kwargs = {}
    monkeypatch.setattr(serve, "RenderServer", lambda params, *a, **k: kwargs.update(args=a, **k) or srv)
    monkeypatch.setattr(serve, "serve", lambda *a: type("H", (), {"serve_forever": lambda self: None})())
    serve.main(["--loadpath", str(exp / "params_40.npz"), "--height", "8", "--width", "8", "--focal", "20",
                "--mip", "--mip-levels", "2", "--resample-blur", "0.02", "--opaque-background", "--samples", str(N),
                "--device", "cpu"])
    s = kwargs["args"][3]
    assert (s.mip, s.mip_levels, s.resample_blur, s.opaque_background) == (True, 2, 0.02, True)
    assert s.base_radius == pytest.approx(2.0 / math.sqrt(12.0) / 20.0)
    assert "mip levels 2" in capsys.readouterr().out
