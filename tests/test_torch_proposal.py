"""The port's proposal-network slice (mip-NeRF 360 sampling, point form)
on CPU against the JAX package: the proposal MLP and its weights, the
interlevel loss, the placement anneal, the proposal render and a chunked
proposal frame, the fused proposal core (B1 with its weights output and
its distortion rail in one launch, the plain version as the wrapper runs
it on CPU tensors, against the JAX Pallas kernel in interpret mode), the
autograd loss, the config keys, the ``{prop, fine}`` checkpoints,
train(), evaluate.test and the server.

Inputs are made with numpy from a seed and handed to both packages; the
random draws of the two packages differ, so the comparisons hand both
the same ``ts`` or take the deterministic probes and quantiles
(``det_fine``), which make an eval frame deterministic end to end. The
CUDA kernel is held to the plain version on the card
(tests/test_torch_cuda.py).

Tolerances:

- ``proposal_sigma``/``proposal_weights``: f32, atol 1e-5 (the same
  products summed in another order); bf16, atol 2e-3, the forward's bf16
  bound (tests/test_torch_eval.py): a sum in another order can round an
  activation to the neighbouring bf16. ``weights_from_sigma`` equals
  ``composite``'s weights bit for bit (one code path), and JAX's to atol
  1e-6.
- ``anneal_weights``: rtol 1e-6 (one ``pow`` in f32).
- ``interlevel_loss``: against JAX, rtol 1e-5 and its gradient in
  ``w_prop`` atol 1e-6 / rtol 1e-5 (the same f32 sums in another order);
  against the float64 loop oracle, rtol 1e-5 (JAX's own bound,
  tests/test_proposal.py); exactly 0 when the proposal covers.
- Renders at the same ts, f32: rgb and weights atol 1e-5, disparity rtol
  1e-5 (tests/test_torch_hierarchical.py); the deterministic importance
  samples rtol 1e-6 / atol 1e-6.
- The fused core against JAX's assembled from its public functions: f32,
  loss rtol 1e-4, both nets' gradients atol 1e-5 / rtol 2e-3, ``w_f``
  atol 1e-5; bf16, loss rtol 1e-3, each gradient tensor within 2e-2 of
  its largest entry, ``w_f`` atol 2e-3 (the bounds of
  tests/test_torch_train.py and tests/test_torch_hierarchical.py).
- The autograd loss against JAX's ``loss_fn`` assembled, f32: loss rtol
  1e-5, gradients atol 1e-5 / rtol 2e-3 (tests/test_torch_regularisers.py).
- The port's fused step against its autograd path from one state, after
  steps: JAX's rule (tests/test_proposal.py, test_proposal_fused_matches_
  xla): loss rtol 1e-4, parameters atol 5e-5 / rtol 2e-3.
- ``evaluate.test`` of both packages on one scene: PSNR within 0.01 dB,
  SSIM within 1e-3 (tests/test_torch_hierarchical.py).
"""

import dataclasses
import json
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
import yaml
from jax.experimental.pallas import tpu as pltpu

import nerf_simple_tpu.config as jconfig
import nerf_simple_tpu.kernels.mlp as jmlp
import nerf_simple_tpu.models.nerf as jnerf
import nerf_simple_tpu.models.proposal as jprop
import nerf_simple_tpu.ops.sampling as jsampling
import nerf_simple_tpu.ops.volume as jvolume
import nerf_simple_tpu.render.renderer as jrenderer
from nerf_simple_tpu_torch import config
from nerf_simple_tpu_torch.kernels import mlp
from nerf_simple_tpu_torch.models.nerf import NerfField, NerfMLP, NerfPair, init_nerf_params
from nerf_simple_tpu_torch.models.proposal import (
    ProposalField,
    ProposalMLP,
    ProposalPair,
    infer_proposal_arch,
    init_proposal_params,
    proposal_from_train_config,
    proposal_sigma,
    proposal_weights,
)
from nerf_simple_tpu_torch.ops import sampling, volume
from nerf_simple_tpu_torch.render import renderer
from nerf_simple_tpu_torch.render.renderer import RenderSettings
from nerf_simple_tpu_torch.train.loop import train
from nerf_simple_tpu_torch.train.step import (
    _prop_anneal,
    autograd_loss,
    build_train_step,
    build_x16,
    make_train_state,
    proposal_fused_loss,
    render_settings,
)

SMALL = NerfMLP(Lp=4, Ld=2, H=32)
PSMALL = ProposalMLP(Lp=4, D=2, H=32)
B, NP, NF = 8, 8, 16
TN, TF, LAM = 2.0, 6.0, 0.05
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]
DTYPE_IDS = ["f32", "bf16"]
BF16_GRAD_TOL, BF16_LOSS_RTOL = 2e-2, 1e-3


def _jtree(params):
    if isinstance(params, dict):
        return {k: _jtree(v) for k, v in params.items()}
    return jnp.asarray(params)


def _jm(model):
    return jnerf.NerfMLP(model.Lp, model.Ld, model.H)


def _jpm(model):
    return jprop.ProposalMLP(model.Lp, model.D, model.H)


def _params(seed):
    return {"prop": init_proposal_params(seed, PSMALL), "fine": init_nerf_params(seed + 1, SMALL)}


def _grads(field):
    if isinstance(field, ProposalPair):
        return {k: _grads(getattr(field, k)) for k in ("prop", "fine")}
    return {name: {"w": getattr(field, name).weight.grad.numpy().T,
                   "b": getattr(field, name).bias.grad.numpy()} for name in field.model.layer_dims()}


def _assert_grads(got, want, dt=torch.float32):
    for layer in want:
        if isinstance(want[layer], dict) and "w" not in want[layer]:
            _assert_grads(got[layer], want[layer], dt)
            continue
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


def _t(a):
    return torch.from_numpy(np.array(a))


# --- the proposal MLP -------------------------------------------------------------------

def test_proposal_arch_round_trip_and_init_shapes():
    m = ProposalMLP(Lp=5, D=3, H=48)
    params = init_proposal_params(0, m)
    assert infer_proposal_arch(params) == m
    assert jprop.infer_proposal_arch(_jtree(params)) == jprop.ProposalMLP(Lp=5, D=3, H=48)
    jparams = jprop.init_proposal_params(jax.random.PRNGKey(0), jprop.ProposalMLP(Lp=5, D=3, H=48))
    assert {k: {n: a.shape for n, a in d.items()} for k, d in params.items()} == \
           {k: {n: a.shape for n, a in d.items()} for k, d in jparams.items()}
    assert all(a.dtype == np.float32 for d in params.values() for a in d.values())
    for name, (fan_in, _) in m.layer_dims().items():
        assert np.abs(params[name]["w"]).max() <= 1 / np.sqrt(fan_in)
    field = ProposalField.from_jax_params(params, "cpu")
    assert field.model == m
    back = field.to_jax_params()
    for name in params:
        np.testing.assert_array_equal(back[name]["w"], params[name]["w"])
        np.testing.assert_array_equal(back[name]["b"], params[name]["b"])
    cfg = config.TrainConfig(datapath="d", proposal=True, prop_Lp=5, prop_D=3, prop_H=48)
    assert proposal_from_train_config(cfg) == m
    pair = ProposalPair.from_jax_params(_params(0), "cpu")
    assert set(pair.to_jax_params()) == {"prop", "fine"} and pair.model == SMALL
    assert ProposalField(ProposalMLP(contract=True)).model.contract  # ported: the net contracts its positions
    assert proposal_from_train_config(config.TrainConfig(datapath="d", proposal=True, contract=True)).contract


@pytest.mark.parametrize("dt, jdt", DTYPES, ids=DTYPE_IDS)
def test_proposal_sigma_and_weights_match_jax(dt, jdt):
    params = init_proposal_params(3, PSMALL)
    rays, _ = _rays(B, 4)
    ts = _ts(B, NP, 5)
    locs = np.random.default_rng(6).uniform(-2, 2, (B, NP, 3)).astype(np.float32)
    field = ProposalField.from_jax_params(params, "cpu")
    tol = 1e-5 if dt == torch.float32 else 2e-3
    with torch.no_grad():
        sig = proposal_sigma(field, _t(locs), dt)
        w = proposal_weights(field, _t(rays), _t(ts), dt)
    jsig = jprop.proposal_sigma(_jtree(params), jnp.asarray(locs), _jpm(PSMALL), jdt)
    jw = jprop.proposal_weights(_jtree(params), jnp.asarray(rays), jnp.asarray(ts), _jpm(PSMALL), jdt)
    assert sig.shape == (B, NP) and sig.dtype == torch.float32 and w.shape == (B, NP)
    np.testing.assert_allclose(sig.numpy(), np.asarray(jsig), atol=tol)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=tol)
    assert bool((w >= 0).all()) and bool((w.sum(-1) <= 1 + 1e-5).all())


def test_weights_from_sigma_is_composites_weights():
    rng = np.random.default_rng(7)
    rgb_sigma = rng.normal(0, 2, (16, 24, 4)).astype(np.float32)
    ts = _ts(16, 24, 8)
    d = rng.normal(size=(16, 3))
    dirs = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    w = volume.weights_from_sigma(_t(rgb_sigma)[..., 3], _t(ts), _t(dirs))
    assert torch.equal(w, volume.composite(_t(rgb_sigma), _t(ts), _t(dirs)).weights)
    want = jvolume.composite(jnp.asarray(rgb_sigma), jnp.asarray(ts), jnp.asarray(dirs)).weights
    np.testing.assert_allclose(w.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(jvolume.weights_from_sigma(
        jnp.asarray(rgb_sigma[..., 3]), jnp.asarray(ts), jnp.asarray(dirs))), atol=1e-6)


@pytest.mark.parametrize("a", [None, 0.0, 0.5, 1.0], ids=["none", "0", "0.5", "1"])
def test_anneal_weights_matches_jax(a):
    w = np.random.default_rng(9).uniform(0, 0.3, (6, 10)).astype(np.float32)
    w[0, :3] = 0.0  # the 1e-8 floor
    got = sampling.anneal_weights(_t(w), a)
    want = np.asarray(jsampling.anneal_weights(jnp.asarray(w), None if a is None else jnp.float32(a)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    if a is None:
        assert torch.equal(got, _t(w))
    if a == 0.0:
        assert bool((got == 1.0).all())  # uniform placement


# --- the interlevel loss -------------------------------------------------------------------

def _interlevel_np(w, ts, wp, tsp, eps=1e-4):
    """The per-ray float64 loop oracle of JAX's tests/test_proposal.py."""
    total = 0.0
    for b in range(w.shape[0]):
        mids = 0.5 * (tsp[b, 1:] + tsp[b, :-1])
        bound = np.zeros(tsp.shape[1])
        for i in range(w.shape[1] - 1):  # the tail sample left out
            bound[int(np.sum(mids <= ts[b, i]))] += w[b, i]
        excess = np.maximum(bound - wp[b], 0.0)
        total += float(np.sum(excess**2 / (wp[b] + eps)))
    return total / w.shape[0]


def _il_inputs(seed, B_=8, N=24, Np=10):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 0.2, (B_, N)).astype(np.float32), _ts(B_, N, seed + 1),
            rng.uniform(0, 0.05, (B_, Np)).astype(np.float32), _ts(B_, Np, seed + 2))


def test_interlevel_loss_and_its_gradient_match_jax():
    w, ts, wp, tsp = _il_inputs(10)
    wp_t = _t(wp).requires_grad_(True)
    loss = volume.interlevel_loss(_t(w), _t(ts), wp_t, _t(tsp))
    loss.backward()
    jloss, jg = jax.value_and_grad(lambda x: jvolume.interlevel_loss(
        jnp.asarray(w), jnp.asarray(ts), x, jnp.asarray(tsp)))(jnp.asarray(wp))
    assert loss.item() > 0
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(wp_t.grad.numpy(), np.asarray(jg), atol=1e-6, rtol=1e-5)
    assert wp_t.grad.max().item() <= 0 and wp_t.grad.min().item() < 0  # it only pushes the proposal up


def test_interlevel_loss_matches_the_float64_loop_oracle():
    w, ts, wp, tsp = _il_inputs(11)
    got = float(volume.interlevel_loss(_t(w), _t(ts), _t(wp), _t(tsp)))
    np.testing.assert_allclose(got, _interlevel_np(w.astype(np.float64), ts, wp.astype(np.float64), tsp),
                               rtol=1e-5)


def test_interlevel_loss_is_zero_when_the_proposal_covers():
    w, ts, _, tsp = _il_inputs(12, B_=4, N=16, Np=6)
    wp = np.zeros((4, 6), np.float32)
    for b in range(4):
        mids = 0.5 * (tsp[b, 1:] + tsp[b, :-1])
        for i in range(15):
            wp[b, int(np.sum(mids <= ts[b, i]))] += w[b, i]
    wp += 0.01
    assert float(volume.interlevel_loss(_t(w), _t(ts), _t(wp), _t(tsp))) == 0.0
    assert float(volume.interlevel_loss(_t(w), _t(ts), _t(wp / 4), _t(tsp))) > 0.0


def test_interlevel_loss_tie_on_a_bin_edge():
    """A sample exactly on a midpoint of the probes falls in the cell
    above it (``#(edges <= t)``), as in JAX; the tail sample is left out
    even when it carries all the weight."""
    tsp = np.array([[2.0, 3.0, 4.0, 5.0]], np.float32)  # interior edges 2.5, 3.5, 4.5
    ts = np.array([[2.5, 3.5, 3.75, 6.0]], np.float32)
    w = np.array([[0.3, 0.2, 0.1, 0.4]], np.float32)
    wp = np.zeros((1, 4), np.float32)
    idx = torch.searchsorted(_t(0.5 * (tsp[:, 1:] + tsp[:, :-1])), _t(ts[:, :-1]), right=True)
    assert idx.tolist() == [[1, 2, 2]]
    got = float(volume.interlevel_loss(_t(w), _t(ts), _t(wp), _t(tsp)))
    want = (0.3**2 + 0.3**2) / 1e-4  # cells 1 and 2 hold 0.3 each; the tail's 0.4 is not counted
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got, float(jvolume.interlevel_loss(*(jnp.asarray(a) for a in (w, ts, wp, tsp)))),
                               rtol=1e-6)
    np.testing.assert_allclose(got, _interlevel_np(w.astype(np.float64), ts, wp.astype(np.float64), tsp), rtol=1e-5)


# --- rendering ------------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_render_rays_proposal_matches_jax(backend):
    """Given the probes, with ``det_fine``: the proposal weights, the
    annealed placement, the samples and the main field's render against
    JAX's xla path (the port's pallas path runs the forward kernel's
    plain version); without ``ts_prop`` the probes are bin midpoints. No
    sigma noise is applied."""
    params = _params(13)
    rays, _ = _rays(B, 14)
    tsp = _ts(B, NP, 15)
    pair = ProposalPair.from_jax_params(params, "cpu")
    for a in (None, 0.5):
        s = RenderSettings(N=NF, N_prop=NP, backend=backend, sigma_noise=1.0)
        with torch.no_grad():
            out, (ts_p, w_p, ts_f) = renderer.render_rays_proposal(pair, _t(rays), None, s, det_fine=True,
                                                                   ts_prop=_t(tsp), return_aux=True, prop_anneal=a)
        jout, (jts_p, jw_p, jts_f) = jrenderer.render_rays_proposal(
            _jtree(params), jnp.asarray(rays), jax.random.PRNGKey(0), jrenderer.RenderSettings(N=NF, N_prop=NP),
            _jm(SMALL), _jpm(PSMALL), det_fine=True, ts_prop=jnp.asarray(tsp), return_aux=True,
            prop_anneal=None if a is None else jnp.float32(a))
        assert torch.equal(ts_p, _t(tsp)) and ts_f.shape == (B, NF) and out.weights.shape == (B, NF)
        np.testing.assert_allclose(w_p.numpy(), np.asarray(jw_p), atol=1e-5)
        np.testing.assert_allclose(ts_f.numpy(), np.asarray(jts_f), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(out.rgb.numpy(), np.asarray(jout.rgb), atol=1e-5)
        np.testing.assert_allclose(out.weights.numpy(), np.asarray(jout.weights), atol=1e-5)
        np.testing.assert_allclose(out.disp.numpy(), np.asarray(jout.disp), rtol=1e-5)
    with torch.no_grad():
        _, (ts_mid, _, _) = renderer.render_rays_proposal(pair, _t(rays), None, RenderSettings(N=NF, N_prop=NP),
                                                          det_fine=True, return_aux=True)
    np.testing.assert_allclose(ts_mid[0].numpy(), TN + (np.arange(NP) + 0.5) * (TF - TN) / NP, rtol=1e-6)
    with pytest.raises(ValueError, match="N_prop > 0"):
        renderer.render_rays_proposal(pair, _t(rays), None, RenderSettings(N=NF))


def test_render_rays_chunked_proposal_matches_jax():
    """A chunked proposal frame (probes at bin midpoints, samples at the
    quantiles: deterministic end to end) against JAX's
    ``render_rays_chunked``; ``fused_eval`` is not taken under N_prop > 0,
    as in JAX, and a field of another scheme raises."""
    params = _params(16)
    rays, _ = _rays(100, 17)
    s = RenderSettings(N=NF, N_prop=NP, backend="pallas", fused_eval=True)
    mlp.fused_render.launches = 0
    rgb, disp = renderer.render_rays_chunked(ProposalPair.from_jax_params(params, "cpu"), _t(rays), 0, s, chunk=32)
    jrgb, jdisp = jrenderer.render_rays_chunked(_jtree(params), jnp.asarray(rays), jax.random.PRNGKey(0),
                                                jrenderer.RenderSettings(N=NF, N_prop=NP), _jm(SMALL), chunk=32,
                                                prop_model=_jpm(PSMALL))
    assert rgb.shape == (100, 3) and disp.shape == (100,)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), atol=1e-5)
    np.testing.assert_allclose(disp.numpy(), np.asarray(jdisp), rtol=1e-5)
    again = renderer.render_rays_chunked(ProposalPair.from_jax_params(params, "cpu"), _t(rays), 5, s, chunk=32)[0]
    assert torch.equal(rgb, again)  # no draw depends on the seed
    for field in (NerfField.from_jax_params(params["fine"], "cpu"),
                  NerfPair.from_jax_params({"coarse": params["fine"], "fine": params["fine"]}, "cpu")):
        with pytest.raises(ValueError, match="ProposalPair"):
            renderer.render_rays_chunked(field, _t(rays), 0, s)
    assert RenderSettings(N_prop=NP, mip=True, base_radius=0.01).mip  # mip x proposal: ported


# --- the fused core and the step ----------------------------------------------------------------

def _jax_fused_core(params, rays, pix, tsp, dt, jdt, dist, plw):
    """JAX's fused proposal core (train/step.py) from its public functions:
    proposal_weights under jax.vjp, the quantile samples of its weights,
    fused_train_step with the weights output and ``dist`` in interpret
    mode, the interlevel loss's value and gradient in w_prop."""
    jp = _jtree(params)
    jrays, jtsp = jnp.asarray(rays), jnp.asarray(tsp)
    with pltpu.force_tpu_interpret_mode():
        w_prop, vjp_p = jax.vjp(lambda pp: jprop.proposal_weights(pp, jrays, jtsp, _jpm(PSMALL), jdt), jp["prop"])
        ts_f = jsampling.importance_ts(jax.random.PRNGKey(0), jtsp, jax.lax.stop_gradient(w_prop), NF, det=True)
        x16 = build_x16(_t(rays), _t(ts_f), _t(pix))
        wts, vjp_f = jax.vjp(lambda p: jmlp.pack_weights(p, model=_jm(SMALL)), jp["fine"])
        loss_mse, dw, w_f = jmlp.fused_train_step(wts, jnp.asarray(x16.numpy()), NF, B * NF, jdt, out_weights=True,
                                                  model=_jm(SMALL), dist=dist)
        il, d_wp = jax.value_and_grad(lambda wp: jvolume.interlevel_loss(w_f, ts_f, wp, jtsp))(w_prop)
        grads = {"prop": vjp_p(plw * d_wp)[0], "fine": vjp_f(dw)[0]}
    return float(loss_mse + plw * il), grads, np.asarray(w_f), np.asarray(ts_f)


@pytest.mark.parametrize("dt, jdt", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("dist", [None, (LAM, TN, TF, False)], ids=["no-dist", "dist"])
def test_fused_proposal_core_matches_jax_assembled(dist, dt, jdt):
    """``proposal_fused_loss`` (B1 with the weights output and the rail in
    one launch: its plain version on CPU) against JAX's fused core, same
    weights, probes and samples: loss, both nets' gradients, ``w_f``; its
    own quantile samples are JAX's."""
    params = _params(18)
    rays, pix = _rays(B, 19)
    tsp = _ts(B, NP, 20)
    plw = 0.7
    jloss, want, jw_f, jts_f = _jax_fused_core(params, rays, pix, tsp, dt, jdt, dist, plw)
    pair = ProposalPair.from_jax_params(params, "cpu")
    mlp.fused_train_step.launches = mlp.fused_train_step.weights_dist_launches = 0
    loss, w_f = proposal_fused_loss(pair, _t(rays), _t(pix), _t(tsp), None, NF, dt, SMALL, plw, dist=dist,
                                    ts_f=_t(jts_f))
    assert mlp.fused_train_step.launches == mlp.fused_train_step.weights_dist_launches == 0  # CPU: plain
    assert w_f.shape == (B, NF) and not w_f.requires_grad
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-4 if dt == torch.float32 else BF16_LOSS_RTOL)
    np.testing.assert_allclose(w_f.numpy(), jw_f, atol=1e-5 if dt == torch.float32 else 2e-3)
    _assert_grads(_grads(pair), want, dt)
    with torch.no_grad():
        ts_f = sampling.importance_ts(None, _t(tsp), proposal_weights(pair.prop, _t(rays), _t(tsp), dt), NF,
                                      det=True)
    np.testing.assert_allclose(ts_f.numpy(), jts_f, rtol=1e-6, atol=1e-6 if dt == torch.float32 else 1e-4)


def _prop_cfg(backend, **kw):
    return config.TrainConfig(**{**dict(datapath="d", Nf=NF, proposal=True, Np=NP, prop_Lp=4, prop_D=2,
                                        prop_H=32, batch_size=B, backend=backend, net_H=32, net_Lp=4,
                                        net_Ld=2), **kw})


def _jax_depth_term(out, gt_d):
    valid = jnp.isfinite(gt_d) & (gt_d > 0)
    return jnp.sum(jnp.where(valid, (out.depth - gt_d) ** 2, 0.0)) / jnp.maximum(jnp.sum(valid), 1)


@pytest.mark.parametrize("kw", [{}, dict(depth_loss_weight=0.3, distortion_loss_weight=LAM,
                                         sampling_space="disparity", proposal_loss_weight=0.5)],
                         ids=["plain", "regularisers"])
def test_autograd_proposal_loss_matches_jax_loss_fn(kw):
    """``autograd_loss``'s proposal branch against JAX's ``loss_fn`` (its
    proposal branch) from public functions: render_rays_proposal with the
    probes given and quantile samples, the MSE, the interlevel loss on the
    detached weights, the depth term and the distortion at the samples;
    f32, loss and both nets' gradients."""
    cfg = _prop_cfg("xla", **kw)
    params = _params(21)
    rays, pix = _rays(B, 22)
    tsp = _ts(B, NP, 23)
    gt_d = np.random.default_rng(24).uniform(3, 5, B).astype(np.float32)
    gt_d[2] = 0.0  # a hole
    js = jrenderer.RenderSettings(N=NF, N_prop=NP, tn=TN, tf=TF, sampling_space=cfg.sampling_space)
    jr, jtsp, jpix, jgt = (jnp.asarray(a) for a in (rays, tsp, pix, gt_d))

    def jax_loss(p):
        out, (ts_p, w_p, ts_f) = jrenderer.render_rays_proposal(p, jr, jax.random.PRNGKey(0), js, _jm(SMALL),
                                                                _jpm(PSMALL), det_fine=True, ts_prop=jtsp,
                                                                return_aux=True)
        loss = jnp.mean((out.rgb - jpix) ** 2) + cfg.proposal_loss_weight * jvolume.interlevel_loss(
            jax.lax.stop_gradient(out.weights), ts_f, w_p, ts_p)
        if cfg.depth_loss_weight > 0:
            loss = loss + cfg.depth_loss_weight * _jax_depth_term(out, jgt)
        if cfg.distortion_loss_weight > 0:
            s = (1.0 / TN - 1.0 / jnp.maximum(ts_f, 1e-10)) / (1.0 / TN - 1.0 / TF)
            loss = loss + cfg.distortion_loss_weight * jvolume.distortion_loss(out.weights, s)
        return loss

    jloss, want = jax.value_and_grad(jax_loss)(_jtree(params))
    pair = ProposalPair.from_jax_params(params, "cpu")
    pix_b = _t(pix)
    if cfg.depth_loss_weight > 0:
        pix_b = torch.cat([pix_b, _t(gt_d)[:, None]], 1)
    loss = autograd_loss(cfg, pair, _t(rays), pix_b, _t(tsp), None, render_settings(cfg), det_fine=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    _assert_grads(_grads(pair), want)


def test_fused_proposal_step_matches_the_autograd_path():
    """Fused (one B1 launch a step, the weights output and the rail),
    two-kernel autograd (fused_mlp) and plain autograd steps from one
    state, with the distortion rail and the placement anneal: the same
    losses, and after the steps the same parameters of both nets under
    JAX's rule."""
    rays, pix = (_t(a) for a in _rays(300, 25))
    runs = {}
    for name, backend, fused in (("fused", "pallas", True), ("two-kernel", "pallas", False),
                                 ("plain", "xla", None)):
        cfg = _prop_cfg(backend, distortion_loss_weight=LAM, prop_anneal_frac=0.5, num_iters=8, batch_size=32)
        state = make_train_state(cfg, SMALL, "cpu")
        if fused is False:
            with pytest.warns(UserWarning, match="fused train kernel"):
                fn = build_train_step(cfg, SMALL, fused=False)
        else:
            fn = build_train_step(cfg, SMALL, fused=fused)
        runs[name] = np.array([float(fn(state, rays, pix)) for _ in range(3)]), state.field.to_jax_params()
    want_loss, want = runs["plain"]
    for name in ("fused", "two-kernel"):
        losses, got = runs[name]
        np.testing.assert_allclose(losses, want_loss, rtol=1e-4)
        for k in ("prop", "fine"):
            for layer in want[k]:
                for p in ("w", "b"):
                    np.testing.assert_allclose(got[k][layer][p], want[k][layer][p], atol=5e-5, rtol=2e-3,
                                               err_msg=f"{name} {k}/{layer}/{p}")


def test_prop_anneal_and_the_state():
    """``_prop_anneal`` is JAX's f32 ramp, None when off; the proposal
    state seeds its nets from derived seeds, one Adam over both; sigma
    noise and depth leave the fused kernel, as in JAX."""
    cfg = _prop_cfg("pallas", prop_anneal_frac=0.3, num_iters=70)
    for step in (0, 1, 7, 20, 21, 100):
        want = float(jnp.clip(jnp.asarray(step).astype(jnp.float32) / (0.3 * 70), 0.0, 1.0))
        assert _prop_anneal(cfg, step) == want
    assert _prop_anneal(_prop_cfg("pallas"), 5) is None
    state = make_train_state(cfg, SMALL, "cpu")
    assert isinstance(state.field, ProposalPair)
    got = state.field.to_jax_params()
    np.testing.assert_array_equal(got["prop"]["trunk0"]["w"],
                                  init_proposal_params(renderer.derive_seed(0, 0), PSMALL)["trunk0"]["w"])
    np.testing.assert_array_equal(got["fine"]["trunk0"]["w"],
                                  init_nerf_params(renderer.derive_seed(0, 1), SMALL)["trunk0"]["w"])
    n = sum(p.numel() for p in state.field.parameters())
    assert n == sum(p.numel() for g in state.optimizer.param_groups for p in g["params"])
    for kw in (dict(sigma_noise=0.5), dict(depth_loss_weight=0.1)):
        with pytest.warns(UserWarning, match="fused train kernel is ineligible"):
            build_train_step(_prop_cfg("pallas", **kw), SMALL)


# --- config, checkpoints, the slice end to end ----------------------------------------------------

def test_lego_proposal_yaml_loads_and_each_check_raises():
    with open("configs/lego_proposal.yaml") as fh:
        assert config.load_yaml("configs/lego_proposal.yaml") == yaml.load(fh, Loader=yaml.FullLoader)
    d = config.load_yaml("configs/lego_proposal.yaml")
    cfg = config.train_config_from_dict(d)
    assert (cfg.proposal, cfg.Np, cfg.Nf, cfg.prop_Lp, cfg.prop_D, cfg.prop_H, cfg.proposal_loss_weight,
            cfg.batch_size, cfg.compute_dtype, cfg.backend) == (True, 64, 128, 6, 4, 64, 1.0, 4096, "bf16", "pallas")
    tc = config.test_config_from_dict(d)
    assert (tc.Np, tc.N_samples, tc.Nc) == (64, 128, 0)
    base = {"datapath": "d", "proposal": True}
    for kw, match in ((dict(hierarchical=True), "alternative sampling"), (dict(Np=0), "Np > 0"),
                      (dict(prop_D=0), "dims must be positive"), (dict(prop_H=-1), "dims must be positive"),
                      (dict(proposal_loss_weight=-0.1), "proposal_loss_weight"),
                      (dict(prop_anneal_frac=1.5), "prop_anneal_frac"),
                      (dict(proposal=False, prop_anneal_frac=0.2), "needs proposal=True")):
        for mod in (config, jconfig):
            with pytest.raises(ValueError, match=match):
                mod.TrainConfig(**{**base, **kw})
    for mod in (config, jconfig):
        with pytest.raises(ValueError, match="alternative samplers"):
            mod.TestConfig(loadpath="m", datapath="d", Np=8, Nc=8)
    assert config.train_config_from_dict({**d, "mip": True}).mip  # mip x proposal: ported
    for key, value, match in (("mip_levels", 2, "requires mip=True"), ("opaque_background", True, "needs mip=True")):
        for mod in (config, jconfig):  # JAX's rules, in JAX's words
            with pytest.raises(ValueError, match=match):
                mod.train_config_from_dict({**d, key: value})
    assert config.test_config_from_dict({**d["test_params"], "mip": True}).mip


def test_proposal_checkpoint_resumes_bit_for_bit_and_schemes_are_checked(tmp_path):
    """Both nets, Adam over both and the generator round-trip (with the
    anneal on): 2 + 2 steps with a checkpoint between equal 4 straight; a
    checkpoint of one scheme refuses a state of another, all three ways."""
    from nerf_simple_tpu_torch.train import checkpoint as ckpt

    rays, pix = (_t(a) for a in _rays(300, 26))
    cfg = _prop_cfg("pallas", prop_anneal_frac=0.5, num_iters=8, distortion_loss_weight=LAM)
    fn = build_train_step(cfg, SMALL)
    a = make_train_state(cfg, SMALL, "cpu")
    straight = [float(fn(a, rays, pix)) for _ in range(4)]
    b = make_train_state(cfg, SMALL, "cpu")
    first = [float(fn(b, rays, pix)) for _ in range(2)]
    path = ckpt.save_checkpoint(str(tmp_path / "p"), b)
    c = make_train_state(cfg, SMALL, "cpu")
    ckpt.restore_checkpoint(path, c)
    assert c.step == 2
    rest = [float(fn(c, rays, pix)) for _ in range(2)]
    assert first + rest == straight
    for k in ("prop", "fine"):
        for layer, d in a.field.to_jax_params()[k].items():
            np.testing.assert_array_equal(c.field.to_jax_params()[k][layer]["w"], d["w"])
    one = config.TrainConfig(datapath="d", net_H=32, net_Lp=4, net_Ld=2, Nf=NF)
    hier = dataclasses.replace(one, hierarchical=True, Nc=NP)
    with pytest.raises(ValueError, match="proposal"):
        ckpt.restore_checkpoint(path, make_train_state(one, SMALL, "cpu"))
    with pytest.raises(ValueError, match="proposal"):
        ckpt.restore_checkpoint(path, make_train_state(hier, SMALL, "cpu"))
    one_path = ckpt.save_checkpoint(str(tmp_path / "one"), make_train_state(one, SMALL, "cpu"))
    with pytest.raises(ValueError, match="one field"):
        ckpt.restore_checkpoint(one_path, make_train_state(cfg, SMALL, "cpu"))
    with pytest.raises(ValueError, match="per-network"):
        ckpt.export_params_pth(str(tmp_path / "x.pth"), a.field.to_jax_params())


def test_train_proposal_resumes_bit_for_bit(tmp_path, capsys):
    """train() with the placement anneal and the rail, 20 steps; the run
    resumed from its step-10 checkpoint in another directory repeats
    steps 10-19 bit for bit (losses, both nets' parameters, the
    generator). The anneal and the learning rate follow num_iters, so
    both runs keep the same num_iters."""
    import shutil

    from nerf_simple_tpu_torch.data.synthetic import write_blender_scene

    scene = str(tmp_path / "scene")
    write_blender_scene(scene, n_train=3, n_val=1, n_test=1, H=16, W=16)

    def cfg(root, **kw):
        return dict(datapath=scene, savepath=str(root / "models"), exp_name="p", Nf=NF, proposal=True, Np=NP,
                    prop_Lp=4, prop_D=2, prop_H=32, prop_anneal_frac=0.5, distortion_loss_weight=LAM,
                    num_iters=20, ckpt_model=10, ckpt_loss=1, ckpt_images=10**6, batch_size=64, half_res=False,
                    val_idxs=[0], backend="pallas", compute_dtype="f32", steps_per_call=10, net_H=32, net_Lp=4,
                    net_Ld=2, log_dir=str(root / "logs"), **kw)

    def losses():
        return [float(line.split()[1]) for line in capsys.readouterr().out.splitlines() if line.startswith("loss:")]

    state = train(cfg(tmp_path / "a"), device="cpu")
    straight = losses()
    assert len(straight) == 20 and np.all(np.isfinite(straight))
    (tmp_path / "b" / "models" / "p").mkdir(parents=True)
    shutil.copy(tmp_path / "a" / "models" / "p" / "ckpt_10.pth", tmp_path / "b" / "models" / "p")
    resumed = train(cfg(tmp_path / "b") | {"resume": True}, device="cpu")
    assert losses() == straight[10:]
    assert resumed.step == 20 and torch.equal(resumed.generator.get_state(), state.generator.get_state())
    for name, p in resumed.field.named_parameters():
        assert torch.equal(p, dict(state.field.named_parameters())[name]), name


def test_train_evaluate_and_serve_proposal_on_cpu(tmp_path, capsys, monkeypatch):
    """train() a tiny proposal run (CSV logging alone, as on a machine
    without tensorboard): falling loss, val renders, an npz the JAX
    package loads with both nets, the main field in the .pth export; then
    evaluate.test with Np > 0 against the JAX evaluate.test (both
    deterministic end to end), its error for a checkpoint without the
    proposal net; the server with proposal samples, and the CLI flag."""
    from nerf_simple_tpu.evaluate import test as jtest
    from nerf_simple_tpu.train.checkpoint import import_params_npz as jimport

    from nerf_simple_tpu_torch import serve
    from nerf_simple_tpu_torch.data.synthetic import write_blender_scene
    from nerf_simple_tpu_torch.evaluate import load_params, test
    from nerf_simple_tpu_torch.serve import RenderServer

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # the import raises
    scene = str(tmp_path / "scene")
    write_blender_scene(scene, n_train=4, n_val=1, n_test=2, H=20, W=20)
    cfg = dict(datapath=scene, savepath=str(tmp_path / "models"), exp_name="p", Nf=NF, proposal=True, Np=NP,
               prop_Lp=4, prop_D=2, prop_H=32, num_iters=40, ckpt_model=40, ckpt_loss=1, ckpt_images=20,
               batch_size=64, half_res=False, val_idxs=[0], num_train_imgs=4, backend="pallas",
               compute_dtype="f32", steps_per_call=10, net_H=32, net_Lp=4, net_Ld=2,
               log_dir=str(tmp_path / "logs"), honor_lr_init=True, lr_init=5e-3, lr_final=5e-4)
    state = train(cfg, device="cpu")
    out = capsys.readouterr().out
    losses = [float(line.split()[1]) for line in out.splitlines() if line.startswith("loss:")]
    assert len(losses) == 40 and np.mean(losses[-10:]) < 0.8 * np.mean(losses[:10])
    assert "Val image 0 | iter: 30 | PSNR" in out
    exp = tmp_path / "models" / "p"
    params = state.field.to_jax_params()
    jnpz = jimport(str(exp / "params_40.npz"))
    for k, layer in (("prop", "trunk1"), ("fine", "skip")):
        np.testing.assert_array_equal(np.asarray(jnpz[k][layer]["w"]), params[k][layer]["w"])
    np.testing.assert_array_equal(load_params(str(exp / "params_40.pth"))["skip"]["w"], params["fine"]["skip"]["w"])
    assert set(load_params(str(exp), keep_hierarchy=True)) == {"prop", "fine"}

    jrenderer._chunked_render_fn.cache_clear()
    tp = dict(loadpath=str(exp / "params_40.npz"), datapath=scene, exp_name="e", batch_size=256, half_res=False,
              im_idxs=[0, 1], N_samples=NF, Np=NP)
    jtest({**tp, "savepath": str(tmp_path / "jax")})
    jout = capsys.readouterr().out
    test({**tp, "savepath": str(tmp_path / "port"), "backend": "pallas"}, device="cpu")
    got = capsys.readouterr().out
    jrenderer._chunked_render_fn.cache_clear()
    metrics = [re.findall(r"im (\d+): mse=\S+ psnr=(\S+) ssim=(\S+)", o) for o in (got, jout)]
    assert len(metrics[0]) == len(metrics[1]) == 2
    for (i, p, s), (j, q, r) in zip(*metrics):
        assert i == j and abs(float(p) - float(q)) <= 0.01 and abs(float(s) - float(r)) <= 1e-3
    assert {"rgb_0.png", "depth_1.png"} <= set(os.listdir(tmp_path / "port" / "e"))
    with pytest.raises(ValueError, match="no proposal net"):
        test({**tp, "loadpath": str(exp / "params_40.pth"), "savepath": str(tmp_path / "x")}, device="cpu")

    settings = RenderSettings(N=NF, N_prop=NP, backend="pallas")
    srv = RenderServer(load_params(str(exp / "params_40.npz"), keep_hierarchy=True), 8, 8, 20.0, settings,
                       model=SMALL, device="cpu")
    assert srv.prop_model == PSMALL and isinstance(srv.field, ProposalPair)
    frame = srv.render(4.0, -30.0, 60.0)
    from nerf_simple_tpu_torch.ops.rays import rays_for_poses, spherical_to_pose

    rays = rays_for_poses(torch.as_tensor(spherical_to_pose(4.0, -30.0, 60.0)[None], dtype=torch.float32), 8, 8,
                          20.0)
    rgb, _ = renderer.render_rays_chunked(srv.field, rays, srv.seed, settings)
    np.testing.assert_array_equal(frame, (np.clip(rgb.reshape(8, 8, 3).numpy(), 0, 1) * 255).astype(np.uint8))
    httpd = serve.serve(srv, 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/health", timeout=60) as r:
            assert json.loads(r.read())["proposal"] is True
        with urllib.request.urlopen(url + "/render?r=4&theta=-30&phi=60", timeout=60) as r:
            np.testing.assert_array_equal(serve.decode_png(r.read()), frame)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    with pytest.raises(ValueError, match="proposal-trained"):
        RenderServer(load_params(str(exp / "params_40.pth")), 8, 8, 20.0, settings, model=SMALL, device="cpu")
    seen = {}
    monkeypatch.setattr(serve, "RenderServer", lambda params, *a, **k: seen.update(params=params, args=a, **k) or srv)
    monkeypatch.setattr(serve, "serve", lambda *a: type("H", (), {"serve_forever": lambda self: None})())
    serve.main(["--loadpath", str(exp / "params_40.npz"), "--height", "8", "--width", "8", "--focal", "20",
                "--proposal-samples", str(NP), "--samples", str(NF), "--device", "cpu"])
    assert set(seen["params"]) == {"prop", "fine"} and seen["device"] == "cpu"
    assert (seen["args"][3].N_prop, seen["args"][3].N) == (NP, NF)
    assert f"Np={NP}" in capsys.readouterr().out
