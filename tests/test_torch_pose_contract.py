"""The port's pose refinement and appearance codes on a contracted model
(mip-NeRF 360's ``contract``) on CPU against the JAX package: the input
gradient's contraction (the plain version of B2's ``want_dx`` and of the
input-gradient kernel, what the wrappers run on CPU tensors) against the
vjp of JAX's interpret-mode ``_fused_mlp_bwd(want_dx=True)`` with and
without BARF's anneal windows and appearance codes, and against float64
autograd of the plain forward; ``probes/input_grad.py::explain_dx``'s two
contract faults; one f32 train step each of pose + contract (single net,
with and without the anneal; the hierarchical pair; the 360 recipe's keys)
and of appearance + contract (single, hierarchical, proposal; with and
without pose) against the JAX ``build_train_step`` (``backend: xla``) from
the same weights and draws; the config rules, and pose + mip + contract
running where it used to raise; ``train()`` of the 360 recipe with pose through a
freeze and refined train stills, and of contract + appearance evaluated
under a code.

Sample positions straddle the unit ball (a third inside, a third in (1,
3], the rest at 25..35), so both branches of the contraction run.

A port step is handed the JAX step's draws (the batch indices, the
stratified samples or probes, the importance samples), which the test
computes with the JAX package from the keys the JAX step splits.

Tolerances:

- ``dx`` against JAX's: per row group (positions 0..2, directions 3..5,
  codes 8..15), max abs error over the group's largest entry: 1e-5 in f32
  (other summation orders; the radial terms of the contraction's
  transpose cancel, ~2/n each for a result of 1/n^2, so a far row keeps
  fewer digits than a near one), 5e-3 in bf16 (tests/test_torch_pose.py's
  bf16 bound). The weight gradients through the pack: f32 atol 1e-5 +
  rtol 2e-3, bf16 each tensor within 2e-2 of its largest entry
  (tests/test_torch_appearance.py's).
- Against float64 autograd of the plain forward: atol 1e-12.
- A train step against JAX's: the loss rtol 2e-5, the ``dr``/``dt``
  tables and the code table atol 1e-5 (JAX's bounds,
  tests/test_pose_app.py:871).
"""

from __future__ import annotations

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import nerf_simple_tpu.config as jconfig
import nerf_simple_tpu.kernels.mlp as jmlp
import nerf_simple_tpu.models.nerf as jnerf
import nerf_simple_tpu.models.proposal as jproposal
import nerf_simple_tpu.ops.rays as jrays
import nerf_simple_tpu.ops.sampling as jsampling
import nerf_simple_tpu.render.renderer as jrenderer
import nerf_simple_tpu.train.step as jstep
from nerf_simple_tpu.models import model_from_train_config as jmodel_from_train_config
from nerf_simple_tpu_torch import config
from nerf_simple_tpu_torch.data import synthetic
from nerf_simple_tpu_torch.kernels import mlp
from nerf_simple_tpu_torch.models import model_from_train_config
from nerf_simple_tpu_torch.models.nerf import NerfField, NerfMLP, NerfPair, init_nerf_params
from nerf_simple_tpu_torch.models.proposal import ProposalMLP, ProposalPair
from nerf_simple_tpu_torch.probes import input_grad as ig_probe
from nerf_simple_tpu_torch.render import renderer
from nerf_simple_tpu_torch.train import checkpoint as ckpt
from nerf_simple_tpu_torch.train import step as tstep

CSMALL = NerfMLP(Lp=4, Ld=2, H=32, contract=True)
CAPP = NerfMLP(Lp=4, Ld=2, H=32, contract=True, app_dim=3)
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]
DX_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-3}
BF16_GRAD_TOL = 2e-2
TN, TF = 0.5, 30.0  # the unbounded scene's bounds (JAX scripts/unbounded_bench.py:70-116)
N_RAYS, RAYS_PER_IMAGE, N_IMAGES, BATCH = 64, 16, 4, 32  # JAX's _tiny_cfg step (tests/test_pose_app.py:871)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jtree(params):
    if isinstance(params, dict):
        return {k: _jtree(v) for k, v in params.items()}
    return jnp.asarray(params)


def _jm(model):
    return jnerf.NerfMLP(model.Lp, model.Ld, model.H, contract=model.contract, app_dim=model.app_dim)


def _x(rows, seed, app_dim=0):
    """(8, rows) f32 kernel input, (16, rows) with ``app_dim`` code rows in
    8..: positions a third inside the unit ball, a third in (1, 3], the
    rest at 25..35; unit dirs; codes N(0, 0.5), each on a run of rows."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(3, rows))
    u /= np.linalg.norm(u, axis=0, keepdims=True)
    r = rng.permutation(np.concatenate([rng.uniform(0.0, 0.999, rows - 2 * (rows // 3)),
                                        rng.uniform(1.001, 3.0, rows // 3), rng.uniform(25.0, 35.0, rows // 3)]))
    x = np.zeros((16 if app_dim else 8, rows), np.float32)
    x[:3] = u * r
    d = rng.normal(size=(3, rows))
    x[3:6] = d / np.linalg.norm(d, axis=0, keepdims=True)
    if app_dim:
        codes = rng.normal(0, 0.5, (app_dim, 8))
        x[8 : 8 + app_dim] = np.repeat(codes, -(-rows // 8), axis=1)[:, :rows]
    return x


def _groups(model):
    return [(0, 3), (3, 6)] + ([(8, 16)] if model.app_dim else [])


def _grads(field):
    return {name: {"w": getattr(field, name).weight.grad.numpy().T, "b": getattr(field, name).bias.grad.numpy()}
            for name in field.model.layer_dims()}


def _assert_grads(got, want, dt):
    for layer in want:
        for k in ("w", "b"):
            g, w = got[layer][k], np.asarray(want[layer][k])
            if dt == torch.float32:
                np.testing.assert_allclose(g, w, atol=1e-5, rtol=2e-3, err_msg=f"{layer}/{k}")
            else:
                assert np.abs(g - w).max() / np.abs(w).max() <= BF16_GRAD_TOL, (layer, k)


# --- the input gradient's contraction -----------------------------------------------------------------------

@pytest.mark.parametrize("dt, jdt", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("alpha", [None, 0.3], ids=["none", "a0.3"])
@pytest.mark.parametrize("model", [CSMALL, CAPP], ids=["point", "codes"])
def test_backward_want_dx_of_a_contracted_model_matches_jax(model, alpha, dt, jdt):
    """B2 with ``want_dx`` on a contracted model (``fused_mlp_backward``'s
    plain version) against the vjp of JAX's interpret-mode
    ``_fused_mlp_bwd(want_dx=True, enc_w)`` through ``pack_weights``: the
    weight gradients (through ``fused_mlp``'s autograd, whose input gradient
    is the same dx) and dx by row group; rows 6..7 zero. The rows inside
    the unit ball have the dx of the model without contract, to the bit;
    outside they differ."""
    rows = 192
    params = init_nerf_params(9, model)
    x = _x(rows, 10, model.app_dim)
    g = np.zeros((8, rows), np.float32)
    g[:4] = np.random.default_rng(11).normal(size=(4, rows)) * 0.1
    jw = None if alpha is None else jmlp.anneal_row_weights(_jm(model), jnp.float32(alpha))
    with pltpu.force_tpu_interpret_mode():
        wts, vjp = jax.vjp(lambda p: jmlp.pack_weights(p, model=_jm(model)), _jtree(params))
        jgrads, jdx = jmlp._fused_mlp_bwd(wts, jnp.asarray(x), jnp.asarray(g), rows, jdt, _jm(model), False,
                                          want_dx=True, enc_w=jw)
        want = vjp(jgrads)[0]
    field = NerfField.from_jax_params(params, "cpu", model)
    enc_w = None if alpha is None else mlp.anneal_row_weights(model, alpha)
    _, dx = mlp.fused_mlp_backward(mlp.pack_weights(field), _t(x), _t(g), dt, model, want_dx=True, enc_w=enc_w)
    xT = _t(x).requires_grad_(True)
    mlp.fused_mlp(mlp.pack_weights(field, differentiable=True), xT, dt, model, enc_w=enc_w).backward(_t(g))
    _assert_grads(_grads(field), want, dt)
    assert torch.equal(xT.grad, dx)
    jdx, dx = np.asarray(jdx), dx.numpy()
    assert dx.shape == jdx.shape == (x.shape[0], rows) and (dx[6:8] == 0).all()
    for a, b in _groups(model):
        err = np.abs(dx[a:b] - jdx[a:b]).max() / np.abs(jdx[a:b]).max()
        assert err <= DX_TOL[dt], (a, b, err)
    inside = np.linalg.norm(x[:3], axis=0) <= 1.0
    plain_model = NerfMLP(model.Lp, model.Ld, model.H, app_dim=model.app_dim)
    _, unc = mlp.fused_mlp_backward(mlp.pack_weights(field), _t(x), _t(g), dt, plain_model, want_dx=True,
                                    enc_w=enc_w)
    unc = unc.numpy()
    np.testing.assert_array_equal(dx[:, inside], unc[:, inside])
    assert np.abs(dx[:3, ~inside] - unc[:3, ~inside]).max() > 1e-3 * np.abs(dx[:3]).max()


@pytest.mark.parametrize("alpha", [None, 0.4], ids=["none", "a0.4"])
@pytest.mark.parametrize("model", [CSMALL, CAPP], ids=["point", "codes"])
def test_contract_input_grad_equals_autograd_of_the_plain_forward_in_f64(model, alpha):
    """dx of B2's plain version on a contracted model (and of
    ``input_grad_plain`` on the backward tile's planes) against torch
    autograd of the plain contracted forward, all in float64, with and
    without the windows and the codes (independent of JAX)."""
    wts = mlp.FusedWeights(*(w.double() for w in mlp.pack_weights(NerfField.from_jax_params(
        init_nerf_params(12, model), "cpu", model))))
    x = torch.from_numpy(_x(300, 13, model.app_dim).astype(np.float64))
    g = torch.from_numpy(np.random.default_rng(14).normal(size=(8, 300)))
    enc_w = None if alpha is None else mlp.anneal_row_weights(model, alpha)
    xr = x.clone().requires_grad_(True)
    (mlp.fused_mlp_forward_plain(wts, xr, torch.float64, model, enc_w=enc_w) * g).sum().backward()
    _, dx = mlp.fused_mlp_backward_plain(wts, x, g, torch.float64, model, want_dx=True, enc_w=enc_w)
    np.testing.assert_allclose(dx.numpy(), xr.grad.numpy(), atol=1e-12)
    _, res = mlp.forward_residuals_plain(wts, x, torch.float64, model, enc_w=enc_w)
    gws = mlp.backward_tile_plain(wts, res, g, torch.float64, model)
    np.testing.assert_allclose(mlp.input_grad_plain(wts, x, gws, torch.float64, model, enc_w).numpy(),
                               xr.grad.numpy(), atol=1e-12)


def test_explain_dx_catches_the_contract_faults():
    """``probes/input_grad.py::explain_dx`` on a contracted model with codes
    (what the card tests and chip_smoke.py hold B2's dx to): against itself
    no row is past the tolerance; each of its planted faults puts rows past
    it: the two of the contraction (the transpose's ``c (x . dy) x`` term
    dropped; the encoder's transpose taken at the uncontracted rows), the
    window faults and the code rows halved."""
    wts = mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(30, CAPP), "cpu", CAPP))
    x = _t(_x(300, 31, CAPP.app_dim))
    g = _t(np.random.default_rng(32).normal(size=(8, 300)).astype(np.float32))
    enc_w = mlp.anneal_row_weights(CAPP, 0.6)
    _, dx = mlp.fused_mlp_backward(wts, x, g, torch.float32, CAPP, want_dx=True, enc_w=enc_w)
    ex = ig_probe.explain_dx(wts, x, g, dx, dx.clone(), torch.float32, CAPP, enc_w, 1e-4)
    assert ex["n_past"] == 0 and ex["own_masks_err"] <= 1e-4, ex
    assert set(ex["faults"]) == {"posx_top_octave_half", "posd_low_octave_half", "code_rows_half",
                                 *ig_probe.CONTRACT_FAULTS}
    assert all(f["n_unexplained"] > 0 for f in ex["faults"].values()), ex
    with ig_probe.planted("jacobian_c_dropped"):
        bad = mlp.input_grad_plain(wts, x, mlp.backward_tile_plain(wts, mlp.forward_residuals_plain(
            wts, x, torch.float32, CAPP, enc_w=enc_w)[1], g, torch.float32, CAPP), torch.float32, CAPP, enc_w)
    inside = x[:3].norm(dim=0) <= 1.0
    assert torch.equal(bad[:, inside], dx[:, inside]) and torch.equal(bad[3:], dx[3:])  # outside, rows 0..2 only


# --- one train step against JAX's ---------------------------------------------------------------------------

PROP = dict(proposal=True, Np=8, prop_Lp=4, prop_D=2, prop_H=16)
KINDS = {
    "single-pose": dict(pose_opt=True),
    "single-pose-anneal": dict(pose_opt=True, pe_anneal_until=4),
    "hierarchical-pose": dict(Nc=8, hierarchical=True, pose_opt=True),
    "360-pose": dict(**PROP, distortion_loss_weight=0.01, pose_opt=True),
    "single-app": dict(appearance_dim=3),
    "single-app-pose": dict(appearance_dim=3, pose_opt=True),
    "hierarchical-app": dict(Nc=8, hierarchical=True, appearance_dim=3),
    "hierarchical-app-pose": dict(Nc=8, hierarchical=True, appearance_dim=3, pose_opt=True),
    "proposal-app": dict(**PROP, appearance_dim=3),
    "proposal-app-pose": dict(**PROP, appearance_dim=3, pose_opt=True),
}


def _cfg_kw(kind: str) -> dict:
    """JAX's _tiny_cfg (tests/test_pose_app.py:150) with the contraction and
    disparity spacing on the unbounded scene's bounds, f32, one step a
    call, no pose warmup (the deltas move in the first step)."""
    return dict(datapath="x", contract=True, sampling_space="disparity", tn=TN, tf=TF, Nf=8, batch_size=BATCH,
                steps_per_call=1, num_iters=4, net_Lp=4, net_Ld=2, net_H=32, pose_warmup=0, compute_dtype="f32",
                **KINDS[kind])


def _scene_rays(seed=1):
    """Rays from cameras at r = 3..6 towards the origin (the unbounded
    scene's rig), so that their samples lie inside the ball and far out;
    gt colours."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(N_RAYS, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = -rng.uniform(3.0, 6.0, (N_RAYS, 1)) * d + rng.normal(0, 0.3, (N_RAYS, 3))
    return np.concatenate([o, d], 1).astype(np.float32), rng.uniform(0, 1, (N_RAYS, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_step(kind: str):
    """One JAX step (``backend: xla``) from its own state, and its draws as
    the JAX step makes them: (params of the first state, the loss, the
    params after the step, the draws)."""
    cfg = jconfig.TrainConfig(backend="xla", **_cfg_kw(kind))
    model = jmodel_from_train_config(cfg)
    assert model.contract
    state = jstep.make_train_state(jax.random.PRNGKey(0), cfg, model, n_images=N_IMAGES)
    step = jstep.build_train_step(cfg, model, donate=False, rays_per_image=RAYS_PER_IMAGE)
    rays_np, pix_np = _scene_rays()
    rays, pix = jnp.asarray(rays_np), jnp.asarray(pix_np)
    key = jax.random.PRNGKey(3)
    p0 = jax.tree.map(np.asarray, state.params)
    js = jrenderer.RenderSettings(N=cfg.Nf, N_coarse=cfg.Nc if cfg.hierarchical else 0, sampling_space="disparity",
                                  tn=TN, tf=TF, compute_dtype=jnp.float32)
    k_sel, k_render = jax.random.split(jax.random.fold_in(key, 0))
    idx = jax.random.randint(k_sel, (BATCH,), 0, N_RAYS)
    im_b = idx // RAYS_PER_IMAGE
    params, r = state.params["field"], rays[idx]
    if cfg.pose_opt:
        r = jrays.apply_cam_deltas(r, state.params["cams"]["dr"][im_b], state.params["cams"]["dt"][im_b])
    app_b = state.params["app"][im_b] if cfg.appearance_dim else None
    d = {"idx": idx}
    k_strat, k_imp = jax.random.split(k_render)
    if cfg.hierarchical:
        d["ts"] = ts_c = jsampling.stratified_ts_spaced(k_strat, BATCH, cfg.Nc, TN, TF, space="disparity")
        w_c = jrenderer._render_at_ts(params["coarse"], r, ts_c, js, model, app=app_b).weights
        d["fine"] = jsampling.importance_ts(k_imp, ts_c, w_c, cfg.Nf)
    elif cfg.proposal:
        d["ts"] = ts_p = jsampling.stratified_ts_spaced(k_strat, BATCH, cfg.Np, TN, TF, space="disparity")
        w = jproposal.proposal_weights(params["prop"], r, ts_p, jproposal.proposal_from_train_config(cfg), jnp.float32)
        d["fine"] = jsampling.importance_ts(k_imp, ts_p, w, cfg.Nf)
    else:
        d["ts"] = jsampling.stratified_ts_spaced(k_render, BATCH, cfg.Nf, TN, TF, space="disparity")
    state, loss = step(state, rays, pix, key)
    return (p0, float(np.asarray(loss).reshape(-1)[0]), jax.tree.map(np.asarray, state.params),
            {k: np.asarray(v) for k, v in d.items()})


@pytest.mark.parametrize("kind", list(KINDS))
def test_pose_and_appearance_steps_of_a_contracted_model_match_jax_step(monkeypatch, kind):
    """One f32 step of the port's pallas step with a contracted main field
    and pose refinement and/or appearance codes (the autograd path through
    ``fused_mlp``: the forward with the windows or the code rows, B2 with
    the input gradient's contraction, their plain versions on CPU; a
    proposal net's pose gradient through plain-torch autograd of its
    contraction) against one of the JAX ``build_train_step`` with
    ``backend: xla`` from the same initial params on the same rays and
    draws: the loss, the refined camera tables and the code table. No
    fused core runs."""
    p0, jloss, jafter, draws = _jax_step(kind)
    cfg = config.TrainConfig(backend="pallas", **_cfg_kw(kind))
    model = model_from_train_config(cfg)
    assert model.contract and model.app_dim == cfg.appearance_dim
    assert tstep.kernel_refusal(cfg).startswith("pose_opt" if cfg.pose_opt else "appearance_dim")
    if cfg.proposal:
        field = ProposalPair.from_jax_params(p0["field"], "cpu", model, ProposalMLP(Lp=4, D=2, H=16, contract=True))
    elif cfg.hierarchical:
        field = NerfPair.from_jax_params(p0["field"], "cpu", model)
    else:
        field = NerfField.from_jax_params(p0["field"], "cpu", model)
    cams = tstep.CamDeltas(N_IMAGES).copy_tables_(p0["cams"]) if cfg.pose_opt else None
    app = tstep.AppCodes(N_IMAGES, 3).copy_tables_(p0["app"]) if cfg.appearance_dim else None
    state = tstep.TrainState(field, tstep.make_optimizer(cfg, field.parameters(), cams, app), torch.Generator(),
                             cams=cams, app=app)
    monkeypatch.setattr(torch, "randint", lambda *a, **k: _t(draws["idx"]).long())
    monkeypatch.setattr(tstep, "stratified_ts_spaced", lambda *a, **k: _t(draws["ts"]))
    monkeypatch.setattr(renderer, "importance_ts", lambda *a, **k: _t(draws["fine"]))
    fused = []
    for name in ("hierarchical_fused_loss", "proposal_fused_loss", "fused_loss"):
        monkeypatch.setattr(tstep, name, lambda *a, _n=name, **k: fused.append(_n))
    step_fn = tstep.build_train_step(cfg, model, rays_per_image=RAYS_PER_IMAGE)
    rays_np, pix_np = _scene_rays()
    launches = mlp.fused_mlp_backward.dx_launches
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # pose's and appearance's path is autograd through fused_mlp: no warning
        loss = step_fn(state, _t(rays_np), _t(pix_np)).item()
    assert fused == [] and mlp.fused_mlp_backward.dx_launches == launches  # CPU: the plain versions
    np.testing.assert_allclose(loss, jloss, rtol=2e-5)
    if cfg.pose_opt:
        assert np.abs(jafter["cams"]["dr"]).max() > 0 and np.abs(cams.tables()["dt"]).max() > 0
        for k in ("dr", "dt"):
            np.testing.assert_allclose(cams.tables()[k], jafter["cams"][k], atol=1e-5, err_msg=k)
    if cfg.appearance_dim:
        assert np.abs(jafter["app"]).max() > 0
        np.testing.assert_allclose(app.tables(), jafter["app"], atol=1e-5)


# --- the config rules and the raise message ------------------------------------------------------------------

def test_contract_with_pose_and_codes_loads_and_pose_mip_contract_raises_item_4():
    """``contract`` with ``pose_opt``, with ``appearance_dim`` and with both
    loads in both packages (and colmap360.yaml with its pose block switched
    on); pose + mip + contract, which JAX composes, loads too (Queue B item
    4 is ported: no message names it, the refusal's constant is gone), and
    every place that needs its input gradient runs and agrees with the
    plain path: the plain transpose, ``fused_mlp`` through autograd,
    ``fused_mlp_backward(want_dx=True)`` and ``input_grad`` on the backward's
    planes."""
    assert not hasattr(config, "CONTRACT_MIP_INPUT_GRAD") and not hasattr(config, "CONTRACT_INPUT_GRAD")
    for kw in (dict(pose_opt=True), dict(appearance_dim=4), dict(pose_opt=True, appearance_dim=4),
               dict(pose_opt=True, hierarchical=True), dict(appearance_dim=4, proposal=True)):
        jconfig.TrainConfig(datapath="x", contract=True, **kw)
        cfg = config.TrainConfig(datapath="x", contract=True, **kw)
        assert model_from_train_config(cfg).contract and model_from_train_config(cfg).app_dim == cfg.appearance_dim
    d = {k: v for k, v in config.load_yaml("configs/colmap360.yaml").items()
         if k not in ("dataset", "llff_factor", "ndc", "test_params")}
    cfg = config.train_config_from_dict({**d, "datapath": "x", "pose_opt": True, "pose_warmup": 600,
                                         "pose_freeze_at": 5000})
    assert (cfg.contract, cfg.proposal, cfg.pose_opt, cfg.pose_freeze_at) == (True, True, True, 5000)
    jconfig.TrainConfig(datapath="x", contract=True, pose_opt=True, mip=True)
    cfg = config.TrainConfig(datapath="x", contract=True, pose_opt=True, mip=True)
    assert model_from_train_config(cfg).contract and tstep.kernel_refusal(cfg).startswith("pose_opt")
    cmip = NerfMLP(Lp=4, Ld=2, H=32, contract=True)
    wts = mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(33, cmip), "cpu", cmip))
    x16 = torch.zeros((16, 8))
    x16[:6] = _t(_x(8, 34))[:6]
    x16[0:3] *= 3.0  # both sides of the unit sphere
    x16[11:14] = 0.01
    g = _t(np.random.default_rng(35).normal(size=(8, 8)).astype(np.float32))
    xr = x16.clone().requires_grad_(True)
    mlp.fused_mlp(wts, xr, torch.float32, cmip, mip=True).backward(g)
    _, dx = mlp.fused_mlp_backward(wts, x16, g, torch.float32, cmip, mip=True, want_dx=True)
    _, res = mlp.forward_residuals_plain(wts, x16, torch.float32, cmip, mip=True)
    gws = mlp.backward_tile_plain(wts, res, g, torch.float32, cmip)
    alone = mlp.input_grad(wts, x16, gws, torch.float32, cmip, mip=True)
    assert torch.equal(xr.grad, dx) and dx.shape == (16, 8) and bool(torch.isfinite(dx).all())
    assert (dx[11:14] != 0).any() and (x16[0:3].norm(dim=0) > 1).any()
    np.testing.assert_allclose(alone.numpy(), dx.numpy(), rtol=1e-5, atol=1e-6 * dx.abs().max().item())
    assert mlp._encode_transpose(x16, torch.zeros(mlp._enc_rows(4), 8), torch.zeros(mlp._enc_rows(2), 8), cmip,
                                 mip=True).abs().max() == 0


# --- train() and eval through the normal entry points --------------------------------------------------------

def test_train_the_360_pose_recipe_through_a_freeze_and_refined_stills(tmp_path, capsys, monkeypatch):
    """train() on CPU (pallas, the plain kernels) of the 360 recipe's shape
    (contract, disparity, proposal, distortion) with its pose block
    switched on (``pose_opt``, a warmup, ``pose_freeze_at``) on a small
    unbounded scene with jittered train poses: before the freeze the
    autograd path through ``fused_mlp`` with the input gradient's
    contraction, after it the fused proposal core (B1 of a contracted
    model); the deltas move and are baked; ``evaluate.test`` renders the
    refined train stills with Np probes."""
    import sys

    from nerf_simple_tpu_torch.evaluate import test
    from nerf_simple_tpu_torch.train import loop

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    scene = str(tmp_path / "scene")
    synthetic.write_blender_scene(scene, n_train=3, n_val=1, n_test=1, H=10, W=10, train_jitter=3,
                                  style="unbounded", camera_r_range=(3.0, 6.0))
    cfg = dict(datapath=scene, savepath=str(tmp_path / "m"), exp_name="p", Nf=8, contract=True,
               sampling_space="disparity", tn=TN, tf=TF, **PROP, distortion_loss_weight=0.01, net_Lp=4,
               net_Ld=2, net_H=32, num_iters=15, steps_per_call=5, ckpt_loss=5, ckpt_images=10**6, ckpt_model=5,
               batch_size=32, half_res=False, val_idxs=[0], num_train_imgs=3, backend="pallas",
               log_dir=str(tmp_path / "logs"), pose_opt=True, pose_warmup=2, pose_freeze_at=7, pose_lr_init=1e-2)
    calls = []
    for name in ("autograd_loss", "proposal_fused_loss"):
        real = getattr(tstep, name)
        monkeypatch.setattr(tstep, name, lambda *a, _r=real, _n=name, **k: calls.append(_n) or _r(*a, **k))
    state = loop.train(cfg, device="cpu")
    out = capsys.readouterr().out
    assert calls == ["autograd_loss"] * 10 + ["proposal_fused_loss"] * 5
    assert "pose freeze at step 10" in out and state.cams is None
    assert state.field.fine.model.contract and state.field.prop.model.contract
    exp = tmp_path / "m" / "p"
    with np.load(exp / "cam_deltas.npz") as side:
        assert np.abs(side["dr"]).max() > 0 and np.abs(side["dt"]).max() > 0
    assert ckpt.load_model_meta(str(exp)).contract
    test(dict(loadpath=str(exp), datapath=scene, half_res=False, N_samples=8, Np=8, batch_size=256, im_idxs=[0],
              im_set="train", sampling_space="disparity", tn=TN, tf=TF, savepath=str(tmp_path / "r")), device="cpu")
    assert "im 0: mse=" in capsys.readouterr().out and (tmp_path / "r" / "exp" / "rgb_0.png").exists()


def test_train_and_evaluate_contract_with_appearance_codes(tmp_path, capsys, monkeypatch):
    """train() on CPU of a contracted single net with ``appearance_dim: 2``
    and ``pose_opt``: the code table and the deltas move; the checkpoint
    carries ``{field, cams, app}``, the sidecar a contracted appearance
    model, and eval rebuilds it (the weights and the code table carried
    over) and renders under the mean code and image 0's, which differ."""
    import sys

    from nerf_simple_tpu_torch.evaluate import load_params, test
    from nerf_simple_tpu_torch.train import loop

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    scene = str(tmp_path / "scene")
    synthetic.write_blender_scene(scene, n_train=3, n_val=1, n_test=1, H=10, W=10, style="unbounded",
                                  camera_r_range=(3.0, 6.0))
    cfg = dict(datapath=scene, savepath=str(tmp_path / "m"), exp_name="a", Nf=8, contract=True,
               sampling_space="disparity", tn=TN, tf=TF, net_Lp=4, net_Ld=2, net_H=32, num_iters=10,
               steps_per_call=5, ckpt_loss=5, ckpt_images=10**6, ckpt_model=5, batch_size=32, half_res=False,
               val_idxs=[0], num_train_imgs=3, backend="pallas", log_dir=str(tmp_path / "logs"), appearance_dim=2,
               pose_opt=True, pose_warmup=0)
    state = loop.train(cfg, device="cpu")
    assert state.app.table.abs().max() > 0 and state.cams.dr.abs().max() > 0
    exp = tmp_path / "m" / "a"
    meta = ckpt.load_model_meta(str(exp))
    assert meta.contract and meta.app_dim == 2
    assert set(ckpt.checkpoint_params(str(exp / "ckpt_10.pth"))) == {"field", "cams", "app"}
    params, aux = load_params(str(exp), return_aux=True)
    np.testing.assert_array_equal(aux["app"], state.app.tables())
    field = NerfField.from_jax_params(params, "cpu", meta)
    for name, p in state.field.named_parameters():
        assert torch.equal(dict(field.named_parameters())[name], p.detach()), name
    ev = dict(loadpath=str(exp), datapath=scene, half_res=False, N_samples=8, batch_size=256, im_idxs=[0],
              sampling_space="disparity", tn=TN, tf=TF, backend="pallas")
    test({**ev, "savepath": str(tmp_path / "mean")}, device="cpu")
    test({**ev, "savepath": str(tmp_path / "img0"), "appearance_idx": 0}, device="cpu")
    with open(tmp_path / "mean" / "exp" / "rgb_0.png", "rb") as a, open(tmp_path / "img0" / "exp" / "rgb_0.png",
                                                                        "rb") as b:
        assert a.read() != b.read()
