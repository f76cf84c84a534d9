"""The port's appearance-code slice (NeRF-W's per-image codes,
``appearance_dim``) on CPU against the JAX package: the config rules,
``nerf_apply(app=)``, the packed ``Wcd`` with ``Wca``'s columns, the
forward with the code rows and B2 with the codes' gradients (the plain
versions, as the wrappers run them on CPU tensors, against JAX's Pallas
kernels in interpret mode), the loss of one batch with codes (single net,
hierarchical pair, proposal scheme, and with pose refinement) against
JAX's assembled from its public functions, the chunked render with a
code, the JAX package's exposure-twin fixture, and train() with a
checkpoint, a resume and eval under ``appearance_idx``.

Inputs are made with numpy from a seed and handed to both packages; the
random draws of the two packages differ, so the comparisons hand both the
same batch, ts and image indices (the hierarchical and proposal samples
are the deterministic quantiles). The CUDA kernels are held to the plain
versions on the card (tests/test_torch_cuda.py).

Tolerances:

- ``nerf_apply`` with codes: f32 atol 1e-6; bf16 atol 2e-3 (one bf16
  rounding of a sum's terms apart).
- The forward with codes against JAX's interpret-mode kernel: f32 atol
  1e-5; bf16 atol 2e-3 (the forward's bounds, tests/test_torch_pose.py).
  The port sums ``[Wcd | Wca] [posd ; app8]`` in one product, JAX as two.
- B2 with ``want_dx`` against JAX's ``_fused_mlp_bwd(want_dx=True)``: the
  weight gradients through the pack (``color0``'s code columns from
  ``dWca``) at f32 atol 1e-5 / rtol 2e-3, at bf16 each tensor within 2e-2
  of its largest entry; ``dx`` rows 0..5 and 8..15, max abs error over
  max |dx|: 1e-4 in f32 and 5e-3 in bf16 (tests/test_torch_pose.py).
  Against torch autograd of the plain forward in float64: 1e-12.
- The loss of one batch against JAX's: loss rtol 1e-5; field, code-table
  and delta gradients atol 1e-5 / rtol 2e-3 (f32: other summation orders).
- The chunked render: rgb atol 1e-5, disparity rtol 1e-5.
- The exposure twins: JAX's thresholds (tests/test_pose_app.py:513-573),
  the loss with codes below 0.35 of the loss without, the twins'
  brightness ratio in (1.4, 2.3).
"""

import dataclasses
import json
import os
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
import nerf_simple_tpu.models.proposal as jprop
import nerf_simple_tpu.ops.rays as jrays
import nerf_simple_tpu.ops.volume as jvolume
import nerf_simple_tpu.render.renderer as jrenderer
from nerf_simple_tpu_torch import config
from nerf_simple_tpu_torch.data import synthetic
from nerf_simple_tpu_torch.kernels import mlp
from nerf_simple_tpu_torch.models import zeros_app_for
from nerf_simple_tpu_torch.models.nerf import NerfField, NerfMLP, NerfPair, init_nerf_params, nerf_apply
from nerf_simple_tpu_torch.models.proposal import ProposalMLP, ProposalPair, init_proposal_params
from nerf_simple_tpu_torch.render import renderer
from nerf_simple_tpu_torch.render.renderer import RenderSettings
from nerf_simple_tpu_torch.train import checkpoint as ckpt
from nerf_simple_tpu_torch.train.step import (
    AppCodes,
    CamDeltas,
    autograd_loss,
    build_train_step,
    kernel_refusal,
    make_train_state,
    render_settings,
)

APP = NerfMLP(Lp=4, Ld=2, H=32, app_dim=3)
PSMALL = ProposalMLP(Lp=4, D=2, H=32)
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
    return jnerf.NerfMLP(model.Lp, model.Ld, model.H, app_dim=model.app_dim)


def _t(a):
    return torch.from_numpy(np.array(a))


def _grads(field):
    if isinstance(field, (NerfPair, ProposalPair)):
        return {k: _grads(getattr(field, k)) for k in ("coarse", "prop", "fine") if hasattr(field, k)}
    return {name: {"w": getattr(field, name).weight.grad.numpy().T,
                   "b": getattr(field, name).bias.grad.numpy()} for name in field.model.layer_dims()}


def _assert_grads(got, want, dt=torch.float32):
    for layer in want:
        if "w" not in want[layer]:
            _assert_grads(got[layer], want[layer], dt)
            continue
        for k in ("w", "b"):
            g, w = got[layer][k], np.asarray(want[layer][k])
            if dt == torch.float32:
                np.testing.assert_allclose(g, w, atol=1e-5, rtol=2e-3, err_msg=f"{layer}/{k}")
            else:
                err = np.abs(g - w).max() / np.abs(w).max()
                assert err <= BF16_GRAD_TOL, (layer, k, err)


def _x16(rows, seed, A=APP.app_dim):
    """Kernel input of an appearance model: xyz, unit dirs, codes in rows
    8..8+A (a few codes, each on a run of samples, as rays carry them)."""
    rng = np.random.default_rng(seed)
    x = np.zeros((16, rows), np.float32)
    x[:3] = rng.uniform(-2, 2, (3, rows))
    d = rng.normal(size=(3, rows))
    x[3:6] = d / np.linalg.norm(d, axis=0, keepdims=True)
    codes = rng.normal(0, 0.5, (A, 8))
    x[8 : 8 + A] = np.repeat(codes, -(-rows // 8), axis=1)[:, :rows]
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


# --- config, model, pack -------------------------------------------------------------------------------

def test_appearance_config_rules_match_jax():
    """``appearance_dim`` loads with lego.yaml (and with pose refinement);
    each of JAX's appearance rules raises ValueError in both packages;
    more than 8 code rows under "pallas" raise in the port (JAX falls back
    to XLA) and load under "xla"; ``appearance_idx`` is a TestConfig key."""
    d = config.load_yaml("configs/lego.yaml")
    cfg = config.train_config_from_dict({**d, "appearance_dim": 8, "backend": "pallas"})
    assert cfg.appearance_dim == 8 and cfg.backend == "pallas"
    assert config.train_config_from_dict({**d, "appearance_dim": 4, "pose_opt": True}).pose_opt
    assert config.train_config_from_dict({**d, "appearance_dim": 4, "hierarchical": True}).hierarchical
    assert config.train_config_from_dict({**d, "appearance_dim": 4, "proposal": True}).proposal
    rules = [(dict(appearance_dim=-1), "appearance_dim must be >= 0"),
             (dict(appearance_dim=4, mip=True), "not plumbed through the mip"),
             (dict(appearance_dim=4, pose_opt=True, pose_warmup=10, pose_freeze_at=20),
              "pose_freeze_at cannot combine with appearance_dim")]
    for kw, match in rules:
        with pytest.raises(ValueError, match=match):
            config.TrainConfig(datapath="d", **kw)
        with pytest.raises(ValueError):
            jconfig.TrainConfig(datapath="d", **kw)
    jconfig.TrainConfig(datapath="d", appearance_dim=12, backend="pallas")  # JAX falls back to XLA
    with pytest.raises(ValueError, match="> 8 under backend 'pallas'"):
        config.TrainConfig(datapath="d", appearance_dim=12, backend="pallas")
    assert config.TrainConfig(datapath="d", appearance_dim=12, backend="xla").appearance_dim == 12
    assert config.test_config_from_dict({"loadpath": "l", "datapath": "d", "appearance_idx": 2}).appearance_idx == 2
    assert kernel_refusal(config.TrainConfig(datapath="d", appearance_dim=2)).startswith("appearance_dim")


@pytest.mark.parametrize("dt, jdt", DTYPES, ids=DTYPE_IDS)
def test_nerf_apply_with_codes_matches_jax(dt, jdt):
    """``nerf_apply(app=)`` against JAX's (the code appended to the
    direction encoding), and JAX's shape rule: an appearance model needs
    codes of its width, a plain one takes none."""
    params = init_nerf_params(3, APP)
    x = _x16(64, 4)
    want = jnerf.nerf_apply(_jtree(params), jnp.asarray(x[:6].T), _jm(APP), jdt, app=jnp.asarray(x[8:11].T))
    field = NerfField.from_jax_params(params, "cpu", APP)
    with torch.no_grad():
        got = nerf_apply(field, _t(x[:6].T), dt, app=_t(x[8:11].T))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6 if dt == torch.float32 else 2e-3)
    for bad in (None, _t(x[8:10].T)):
        with pytest.raises(ValueError, match="app_dim"):
            nerf_apply(field, _t(x[:6].T), dt, app=bad)
    with pytest.raises(ValueError, match="app_dim"):
        nerf_apply(NerfField(NerfMLP(Lp=4, Ld=2, H=32)), _t(x[:6].T), dt, app=_t(x[8:11].T))
    assert zeros_app_for(APP, 5).shape == (5, 3) and zeros_app_for(NerfMLP(), 5) is None
    back = field.to_jax_params()
    np.testing.assert_array_equal(back["color0"]["w"], params["color0"]["w"])  # (H + Cd + A, H / 2)


@pytest.mark.parametrize("app_dim", [3, 8])
def test_pack_weights_matches_jax_wcd_and_wca(app_dim):
    """The packed ``Wcd`` of an appearance model is JAX's ``Wcd`` with
    JAX's ``Wca`` (H/2, 8) as its last eight columns, zero past
    ``app_dim``; the other matrices are JAX's."""
    model = dataclasses.replace(APP, app_dim=app_dim)
    params = init_nerf_params(5, model)
    jw = jmlp.pack_weights(_jtree(params), model=_jm(model))
    got = mlp.pack_weights(NerfField.from_jax_params(params, "cpu", model))
    FD0 = mlp._enc_rows(model.Ld)
    assert got.Wcd.shape == (model.H // 2, FD0 + 8) == mlp._weight_shapes(model)["Wcd"]
    np.testing.assert_allclose(got.Wcd[:, :FD0].numpy(), np.asarray(jw.Wcd), atol=1e-7)
    np.testing.assert_allclose(got.Wcd[:, FD0:].numpy(), np.asarray(jw.Wca), atol=1e-7)
    assert (got.Wcd[:, FD0 + app_dim :] == 0).all()
    for name in ("W1", "Wsx", "Wcs", "bcs", "Wc1"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(jw, name)), atol=1e-6)
    L = mlp.Layout.of(model)
    assert (L.FD, L.h(0)) == (FD0 + 8, L.FX + FD0 + 8)  # every plane after posd moves by eight


@pytest.mark.parametrize("dt, jdt", DTYPES, ids=DTYPE_IDS)
def test_fused_mlp_forward_with_codes_matches_jax(dt, jdt):
    """The forward with the code rows (its plain version, which the wrapper
    runs on a CPU tensor) against JAX's interpret-mode kernel on the same
    16-row input, and in f32 against ``nerf_apply(app=)``; the codes move
    the colour, never sigma; the wrapper refuses mip with codes and an
    8-row input."""
    params = init_nerf_params(7, APP)
    x = _x16(128, 8)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jmlp.fused_mlp_forward(jmlp.pack_weights(_jtree(params), model=_jm(APP)),
                                                 jnp.asarray(x), 128, jdt, _jm(APP)))
    field = NerfField.from_jax_params(params, "cpu", APP)
    wts = mlp.pack_weights(field)
    mlp.fused_mlp_forward.launches = mlp.fused_mlp_forward.app_launches = 0
    got = mlp.fused_mlp_forward(wts, _t(x), dt, APP).numpy()
    assert mlp.fused_mlp_forward.launches == mlp.fused_mlp_forward.app_launches == 0  # CPU: plain
    np.testing.assert_allclose(got[:4], want[:4], atol=1e-5 if dt == torch.float32 else 2e-3)
    if dt == torch.float32:
        with torch.no_grad():
            np.testing.assert_allclose(got[:4].T, nerf_apply(field, _t(x[:6].T), app=_t(x[8:11].T)).numpy(),
                                       atol=1e-5)
    x2 = x.copy()
    x2[8:11] += 1.0
    other = mlp.fused_mlp_forward(wts, _t(x2), dt, APP).numpy()
    assert np.array_equal(other[3], got[3]) and np.abs(other[:3] - got[:3]).max() > 1e-3
    with pytest.raises(ValueError, match="rows 8..15"):
        mlp.fused_mlp_forward(wts, _t(x), dt, APP, mip=True)


@pytest.mark.parametrize("dt, jdt", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("alpha", [None, 0.3], ids=["none", "a0.3"])
def test_backward_with_codes_matches_jax(alpha, dt, jdt):
    """B2 with ``want_dx`` on an appearance model (its plain version)
    against JAX's interpret-mode ``_fused_mlp_bwd(want_dx=True, enc_w)``:
    the weight gradients through the pack (``color0``'s code columns from
    ``dWca``, the last eight columns of the packed ``dWcd``), and ``dx``
    rows 0..5 and 8..15 (the codes'); rows 6..7 and the pad code rows are
    zero."""
    params = init_nerf_params(9, APP)
    x = _x16(128, 10)
    g = np.zeros((8, 128), np.float32)
    g[:4] = np.random.default_rng(11).normal(size=(4, 128)) * 0.1
    jw = None if alpha is None else jmlp.anneal_row_weights(_jm(APP), jnp.float32(alpha))
    with pltpu.force_tpu_interpret_mode():
        wts, vjp = jax.vjp(lambda p: jmlp.pack_weights(p, model=_jm(APP)), _jtree(params))
        jgrads, jdx = jmlp._fused_mlp_bwd(wts, jnp.asarray(x), jnp.asarray(g), 128, jdt, _jm(APP), False,
                                          want_dx=True, enc_w=jw)
        want = vjp(jgrads)[0]
    field = NerfField.from_jax_params(params, "cpu", APP)
    enc_w = None if alpha is None else mlp.anneal_row_weights(APP, alpha)
    packed = mlp.pack_weights(field)
    grads, dx = mlp.fused_mlp_backward(packed, _t(x), _t(g), dt, APP, want_dx=True, enc_w=enc_w)
    FD0 = mlp._enc_rows(APP.Ld)
    jca = np.asarray(jgrads.Wca)
    err = np.abs(grads.Wcd[:, FD0:].numpy() - jca).max() / np.abs(jca).max()
    assert err <= (1e-5 if dt == torch.float32 else BF16_GRAD_TOL), err  # dWca
    xT = _t(x).requires_grad_(True)
    out = mlp.fused_mlp(mlp.pack_weights(field, differentiable=True), xT, dt, APP, enc_w=enc_w)
    out.backward(_t(g))
    _assert_grads(_grads(field), want, dt)
    jdx = np.asarray(jdx)
    assert jdx.shape == (16, 128) and torch.equal(xT.grad, dx)
    dx = dx.numpy()
    assert (dx[6:8] == 0).all() and (dx[8 + APP.app_dim :] == 0).all()
    for rows in (slice(0, 6), slice(8, 16)):
        assert np.abs(dx[rows] - jdx[rows]).max() / np.abs(jdx[rows]).max() <= DX_TOL[dt], rows


def test_code_gradients_equal_autograd_of_the_plain_forward_in_f64():
    """``dx`` of B2's plain version on an appearance model (and of
    ``input_grad_plain`` on the backward tile's planes) against torch
    autograd of the plain forward, all in float64, with the anneal windows
    on (the code rows take none)."""
    wts = mlp.FusedWeights(*(w.double() for w in mlp.pack_weights(NerfField.from_jax_params(
        init_nerf_params(12, APP), "cpu", APP))))
    x = torch.from_numpy(_x16(200, 13).astype(np.float64))
    g = torch.from_numpy(np.random.default_rng(14).normal(size=(8, 200)))
    enc_w = mlp.anneal_row_weights(APP, 0.4)
    xr = x.clone().requires_grad_(True)
    (mlp.fused_mlp_forward_plain(wts, xr, torch.float64, APP, enc_w=enc_w) * g).sum().backward()
    _, dx = mlp.fused_mlp_backward_plain(wts, x, g, torch.float64, APP, want_dx=True, enc_w=enc_w)
    np.testing.assert_allclose(dx.numpy(), xr.grad.numpy(), atol=1e-12)
    assert np.abs(dx[8:11].numpy()).max() > 0
    _, res = mlp.forward_residuals_plain(wts, x, torch.float64, APP, enc_w=enc_w)
    assert res.shape[0] == mlp.Layout.of(APP).FA
    gws = mlp.backward_tile_plain(wts, res, g, torch.float64, APP)
    np.testing.assert_allclose(mlp.input_grad_plain(wts, x, gws, torch.float64, APP, enc_w).numpy(),
                               xr.grad.numpy(), atol=1e-12)


def test_explain_dx_holds_the_code_rows():
    """``probes/input_grad.py::explain_dx`` on an appearance model (what
    the card tests and chip_smoke.py hold B2's dx to): against itself no row
    is past the tolerance, the code rows are held against their own largest
    entry, and each of the three planted faults (an octave window of posx
    and of posd halved, the code rows halved) puts rows past it."""
    from nerf_simple_tpu_torch.probes.input_grad import explain_dx, row_err

    wts = mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(30, APP), "cpu", APP))
    x = _t(_x16(300, 31))
    g = _t(np.random.default_rng(32).normal(size=(8, 300)).astype(np.float32))
    _, dx = mlp.fused_mlp_backward(wts, x, g, torch.float32, APP, want_dx=True)
    ex = explain_dx(wts, x, g, dx, dx.clone(), torch.float32, APP, None, DX_TOL[torch.float32])
    assert ex["n_past"] == 0 and ex["own_masks_err"] <= DX_TOL[torch.float32], ex
    assert set(ex["faults"]) == {"posx_top_octave_half", "posd_low_octave_half", "code_rows_half"}
    assert all(f["n_unexplained"] > 0 for f in ex["faults"].values()), ex
    bad = dx.clone()
    bad[8:16] *= 1.01  # 1% of the code rows: below one scale for all rows, past their own
    assert float(row_err(bad, dx).max()) > DX_TOL[torch.float32]


# --- the loss of one batch with codes ----------------------------------------------------------------

def _cfg(backend="pallas", **kw):
    return config.TrainConfig(datapath="d", Nf=N, batch_size=B, backend=backend, net_H=APP.H, net_Lp=APP.Lp,
                              net_Ld=APP.Ld, appearance_dim=APP.app_dim, num_iters=40, pose_warmup=2, **kw)


@pytest.mark.parametrize("case, backend", [("single", "xla"), ("single", "pallas"), ("hierarchical", "pallas"),
                                           ("proposal", "pallas"), ("pose", "pallas")])
def test_appearance_loss_matches_jax_loss_fn(case, backend):
    """``autograd_loss`` with each ray's image's code (under "pallas"
    through ``fused_mlp`` with B2's input gradient, its plain version)
    against JAX's ``loss_fn`` appearance branch (train/step.py:433-449:
    the deltas applied first, then ``app_b = table[im_b]``) assembled from
    its public functions at the same batch, ts and ``im_b``: the loss and
    the gradients of the field(s), of the code table and (pose) of the
    delta tables. Hierarchical: both nets take the code; proposal: the main
    field only."""
    kw = {"hierarchical": dict(hierarchical=True, Nc=N), "pose": dict(pose_opt=True),
          "proposal": dict(proposal=True, Np=N, prop_Lp=4, prop_D=2, prop_H=32)}.get(case, {})
    cfg = _cfg(backend, **kw)
    p = {"coarse": init_nerf_params(15, APP), "fine": init_nerf_params(16, APP)} if case == "hierarchical" else \
        {"prop": init_proposal_params(15, PSMALL), "fine": init_nerf_params(16, APP)} if case == "proposal" else \
        init_nerf_params(15, APP)
    rays_np, pix, ts, im_b = _batch(17)
    rng = np.random.default_rng(18)
    table = rng.normal(0, 0.3, (3, APP.app_dim)).astype(np.float32)
    dr, dt = rng.normal(0, 0.05, (3, 3)).astype(np.float32), rng.normal(0, 0.1, (3, 3)).astype(np.float32)
    js = jrenderer.RenderSettings(N=N, N_coarse=N if case == "hierarchical" else 0,
                                  N_prop=N if case == "proposal" else 0, tn=2.0, tf=6.0)
    jr, jpix, jts = map(jnp.asarray, (rays_np, pix, ts))
    key = jax.random.PRNGKey(0)

    def jax_loss(params, app, cams):
        r = jrays.apply_cam_deltas(jr, cams["dr"][im_b], cams["dt"][im_b]) if case == "pose" else jr
        a = app[im_b]
        if case == "hierarchical":
            c, f = jrenderer.render_rays_hierarchical(params["coarse"], params["fine"], r, key, js, _jm(APP),
                                                      det_fine=True, ts_coarse=jts, app=a)
            return jnp.mean((c.rgb - jpix) ** 2) + jnp.mean((f.rgb - jpix) ** 2)
        if case == "proposal":
            out, (ts_p, w_p, ts_f) = jrenderer.render_rays_proposal(
                params, r, key, js, _jm(APP), jprop.ProposalMLP(PSMALL.Lp, PSMALL.D, PSMALL.H), det_fine=True,
                ts_prop=jts, return_aux=True, app=a)
            return jnp.mean((out.rgb - jpix) ** 2) + cfg.proposal_loss_weight * jvolume.interlevel_loss(
                jax.lax.stop_gradient(out.weights), ts_f, w_p, ts_p)
        out = jrenderer.render_rays(params, r, key, js, _jm(APP), ts=jts, app=a)
        return jnp.mean((out.rgb - jpix) ** 2)

    jloss, (jg, japp, jcams) = jax.value_and_grad(jax_loss, argnums=(0, 1, 2))(
        _jtree(p), jnp.asarray(table), {"dr": jnp.asarray(dr), "dt": jnp.asarray(dt)})
    if case == "hierarchical":
        field = NerfPair.from_jax_params(p, "cpu", APP)
    elif case == "proposal":
        field = ProposalPair.from_jax_params(p, "cpu", APP, PSMALL)
    else:
        field = NerfField.from_jax_params(p, "cpu", APP)
    app = AppCodes(3, APP.app_dim).copy_tables_(table)
    cams = CamDeltas(3).copy_tables_({"dr": dr, "dt": dt}) if case == "pose" else None
    mlp.fused_mlp_backward.dx_launches = 0
    loss = autograd_loss(cfg, field, _t(rays_np), _t(pix), _t(ts), None, render_settings(cfg), det_fine=True,
                         cams=cams, im_b=torch.from_numpy(im_b), app=app)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert float(np.abs(np.asarray(japp)).max()) > 0
    np.testing.assert_allclose(app.table.grad.numpy(), np.asarray(japp), atol=1e-5, rtol=2e-3)
    if cams is not None:
        for k in ("dr", "dt"):
            np.testing.assert_allclose(getattr(cams, k).grad.numpy(), np.asarray(jcams[k]), atol=1e-5, rtol=2e-3,
                                       err_msg=k)
    _assert_grads(_grads(field), jg)
    assert mlp.fused_mlp_backward.dx_launches == 0  # CPU: the plain versions, no launch


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


def test_chunked_render_with_a_code_matches_jax(midpoints):
    """``render_rays_chunked(app=code)`` (the plain forward under "pallas",
    ``fused_eval`` asked for but ineligible with a code) against JAX's at
    the same bin-midpoint samples; the code moves the colour, not the
    disparity; a render without a code raises for an appearance model; the
    fused render and train-step kernels refuse it."""
    params = init_nerf_params(21, APP)
    rays_np, _, _, _ = _batch(22)
    rays_np = np.tile(rays_np, (5, 1))[:37]
    code = np.array([0.4, -0.2, 0.7], np.float32)
    field = NerfField.from_jax_params(params, "cpu", APP)
    s = RenderSettings(N=N, backend="pallas", fused_eval=True)
    mlp.fused_render.launches = 0
    rgb, disp = renderer.render_rays_chunked(field, _t(rays_np), 0, s, chunk=16, app=_t(code))
    jrgb, jdisp = jrenderer.render_rays_chunked(_jtree(params), jnp.asarray(rays_np), jax.random.PRNGKey(0),
                                                jrenderer.RenderSettings(N=N), _jm(APP), chunk=16,
                                                app=jnp.asarray(code))
    assert rgb.shape == (37, 3) and mlp.fused_render.launches == 0
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), atol=1e-5)
    np.testing.assert_allclose(disp.numpy(), np.asarray(jdisp), rtol=1e-5)
    other = renderer.render_rays_chunked(field, _t(rays_np), 0, s, chunk=16, app=_t(code + 1.0))
    assert torch.equal(other[1], disp) and not torch.allclose(other[0], rgb, atol=1e-4)  # colour only
    with pytest.raises(ValueError, match="app_dim"):
        renderer.render_rays_chunked(field, _t(rays_np), 0, dataclasses.replace(s, fused_eval=False), chunk=16)
    with pytest.raises(ValueError, match="appearance slot"):  # eligible without a code: the kernel refuses
        renderer.render_rays_chunked(field, _t(rays_np), 0, s, chunk=16)
    x16 = torch.zeros((16, 4 * N))
    with pytest.raises(ValueError, match="appearance"):
        mlp.fused_render(mlp.pack_weights(field), x16, N, torch.float32, APP)
    with pytest.raises(ValueError, match="appearance slot"):
        mlp.fused_train_step(mlp.pack_weights(field), x16, N, torch.float32, APP)


# --- training and eval ---------------------------------------------------------------------------------

def _write_exposure_twin_scene(root):
    """The JAX package's exposure-twin scene (tests/test_pose_app.py:
    476-507), written by the port's scene writer and PNG codec: 3 train
    views, and r_{3+i} is r_i's image scaled by 0.55 at the same pose, so
    only a per-image code can tell the twins apart."""
    scene = os.path.join(root, "scene")
    synthetic.write_blender_scene(scene, 3, 1, 1, H=32, W=32, train_jitter=3)
    assert synthetic.add_exposure_twins(scene) == 6
    return scene


def test_exposure_twins_match_the_jax_writer(tmp_path):
    """The port's ``add_exposure_twins`` writes the twins the JAX fixture
    writes with cv2 (tests/test_pose_app.py:476-507) from the same base
    images: equal pixels as cv2 reads them, equal poses."""
    import shutil

    import cv2

    scene = str(tmp_path / "port")
    synthetic.write_blender_scene(scene, 2, 1, 1, H=16, W=16, train_jitter=3)
    ref = str(tmp_path / "ref")
    shutil.copytree(scene, ref)
    assert synthetic.add_exposure_twins(scene) == 4
    for i in range(2):
        img = cv2.imread(os.path.join(ref, "train", f"r_{i}.png")).astype(np.float64)
        cv2.imwrite(os.path.join(ref, "train", f"r_{i + 2}.png"), (img * 0.55).astype(np.uint8))
        np.testing.assert_array_equal(cv2.imread(os.path.join(scene, "train", f"r_{i + 2}.png")),
                                      cv2.imread(os.path.join(ref, "train", f"r_{i + 2}.png")))
    with open(os.path.join(scene, "transforms_train.json")) as fh:
        frames = json.load(fh)["frames"]
    assert [f["file_path"] for f in frames] == [f"./train/r_{i}" for i in range(4)]
    assert frames[2]["transform_matrix"] == frames[0]["transform_matrix"]


@pytest.fixture
def one_thread():
    """One intra-op thread for a long CPU run of small products: the suite's
    parallel workers already take every core, and on a thread a core each
    the twins' 2,400 steps ran several times slower than on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_appearance_separates_exposure_twins(tmp_path, one_thread):
    """The JAX package's exposure-twin check at its size and thresholds
    (tests/test_pose_app.py:513-573: 1200 steps of 512 rays x 32 samples,
    Lp 6, Ld 2, H 32, codes of 4): with codes the train loss falls below
    0.35 of the loss without them (nothing else can express the twins'
    brightness gap), and the same rays rendered under the bright twin's
    code and the dim twin's differ by the injected 1 / 0.55 (JAX measured
    0.17 and 1.83)."""
    from nerf_simple_tpu_torch.data.blender import load_blender
    from nerf_simple_tpu_torch.data.dataset import RayDataset

    scene = _write_exposure_twin_scene(str(tmp_path))
    data = load_blender(scene, half_res=False)
    rd = RayDataset.from_blender(data, "cpu")
    H, W = data.H, data.W
    assert rd.split_size("train") // (H * W) == 6

    def run(app_dim):
        cfg = config.TrainConfig(datapath=scene, Nf=32, num_iters=1200, batch_size=512, steps_per_call=100,
                                 half_res=False, appearance_dim=app_dim, net_Lp=6, net_Ld=2, net_H=32)
        model = NerfMLP(6, 2, 32, app_dim=app_dim)
        state = make_train_state(cfg, model, "cpu", n_images=6 if app_dim else None)
        step = build_train_step(cfg, model, rays_per_image=H * W)
        for _ in range(cfg.num_iters):
            loss = step(state, rd.rays["train"], rd.pixels["train"])
        return state, float(loss)

    state, loss_app = run(4)
    _, loss_plain = run(0)
    assert loss_app < 0.35 * loss_plain, (loss_app, loss_plain)
    table = state.app.table.detach()
    assert table.std() > 0
    rays0 = rd.rays["train"][: H * W]

    def brightness(code):
        rgb, _ = renderer.render_rays_chunked(state.field, rays0, 5, RenderSettings(N=32), chunk=1024, app=code)
        return float(rgb.mean())

    ratio = brightness(table[0]) / max(brightness(table[3]), 1e-9)
    assert 1.4 < ratio < 2.3, ratio


def test_train_resume_and_evaluate_with_appearance_idx(tmp_path, capsys):
    """train() on CPU (pallas, the plain kernels) with ``appearance_dim:
    2``: the code table has a row a train image and moves; the checkpoint
    and ``params_<N>.npz`` carry ``{field, app}`` with JAX's key names (no
    reference .pth); the "app" Adam group follows the main schedule; a
    resume restores the table and its moments; ``evaluate.test`` renders
    with the mean code (``appearance_idx`` -1) and with image 0's, which
    differ, and an index past the table raises."""
    from nerf_simple_tpu_torch.data.blender import load_blender
    from nerf_simple_tpu_torch.data.dataset import RayDataset
    from nerf_simple_tpu_torch.evaluate import load_params, test
    from nerf_simple_tpu_torch.render.renderer import derive_seed, render_image
    from nerf_simple_tpu_torch.train import loop
    from nerf_simple_tpu_torch.utils.png import decode_png

    scene = str(tmp_path / "scene")
    synthetic.write_blender_scene(scene, 3, 1, 1, H=12, W=12)
    cfg = dict(datapath=scene, savepath=str(tmp_path / "m"), exp_name="a", Nf=8, batch_size=32, net_H=32,
               net_Lp=4, net_Ld=2, half_res=False, backend="pallas", num_iters=10, steps_per_call=5, ckpt_loss=5,
               ckpt_images=5, ckpt_model=5, log_dir=str(tmp_path / "logs"), val_idxs=[0], appearance_dim=2)
    mlp.fused_train_step.launches = 0
    state = loop.train(cfg, device="cpu")
    exp = tmp_path / "m" / "a"
    assert state.app.table.shape == (3, 2) and state.app.table.abs().max() > 0
    groups = {g["name"]: g["lr"] for g in state.optimizer.param_groups}
    assert groups["app"] == groups["field"] and set(groups) == {"field", "app"}
    held = ckpt.checkpoint_params(str(exp / "ckpt_10.pth"))
    assert set(held) == {"field", "app"} and held["app"].shape == (3, 2)
    npz = ckpt.import_params_npz(str(exp / "params_10.npz"))
    assert set(npz) == {"field", "app"} and np.array_equal(npz["app"], state.app.tables())
    assert not (exp / "params_10.pth").exists()
    with open(exp / "model.json") as fh:
        assert json.load(fh)["app_dim"] == 2
    resumed = loop.train({**cfg, "num_iters": 15, "resume": True}, device="cpu")
    assert "resumed from" in capsys.readouterr().out and resumed.step == 15
    assert not np.array_equal(resumed.app.tables(), state.app.tables())

    ev = dict(loadpath=str(exp), datapath=scene, half_res=False, N_samples=8, batch_size=256, im_idxs=[0],
              backend="pallas")
    test({**ev, "savepath": str(tmp_path / "mean")}, device="cpu")
    test({**ev, "savepath": str(tmp_path / "img0"), "appearance_idx": 0}, device="cpu")
    params, aux = load_params(str(exp), return_aux=True)
    assert aux["app"].shape == (3, 2)
    model = NerfMLP(4, 2, 32, app_dim=2)
    field = NerfField.from_jax_params(params, "cpu", model)
    rd = RayDataset.from_blender(load_blender(scene, False), "cpu")
    for sub, code in (("mean", aux["app"].mean(0)), ("img0", aux["app"][0])):
        want = render_image(field, rd.rays["test"], 12, 12, 0, derive_seed(0, 0), RenderSettings(N=8), 256,
                            app=_t(code))[0][0]
        with open(tmp_path / sub / "exp" / "rgb_0.png", "rb") as fh:
            got = decode_png(fh.read())[:, 12:]
        assert np.abs(got.astype(int) - (want * 255).astype(np.uint8).astype(int)).max() <= 1
    with open(tmp_path / "mean" / "exp" / "rgb_0.png", "rb") as a, open(tmp_path / "img0" / "exp" / "rgb_0.png",
                                                                        "rb") as b:
        assert a.read() != b.read()
    with pytest.raises(IndexError, match="appearance_idx 3"):
        test({**ev, "savepath": str(tmp_path / "x"), "appearance_idx": 3}, device="cpu")
    assert mlp.fused_train_step.launches == 0
    assert re.search(r"im 0: mse=", capsys.readouterr().out)
