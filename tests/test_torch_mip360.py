"""The port's mip-NeRF 360 composition on CPU against the JAX package: the
input gradient of a contracted model under mip (the plain
``_encode_transpose`` with mip and contract, what B2's ``want_dx`` and the
input-gradient kernel's ``MIP && CONTRACT`` instantiation run on CPU
tensors) against the JAX ``_input_grad_tile_mip`` with ``contract=True``
called as plain jnp, and against float64 autograd of the plain contracted
integrated encoder; the interval forms of the proposal scheme
(``weights_from_sigma_intervals``, ``interlevel_loss_intervals``,
``proposal_weights_intervals``) with and without the opaque tail; the mip
branch of ``render_rays_proposal``; one and two f32 train steps of mip x
proposal (the fused core's plain version and the autograd path) and of
pose refinement with mip x proposal, mip + contract and all three against
the JAX ``build_train_step`` (``backend: xla``) from the same weights and
draws; the config and ``RenderSettings`` rules; and ``train()``,
``evaluate.test`` and the server for the whole composition with pose and
contract.

Sample positions straddle the unit ball (a third inside, a third just
either side of the unit sphere, the rest out to |x| ~ 30), so both
branches of the contraction run. A port step is handed the JAX step's draws
(the batch indices, the probe edges or interval edges, the fine edges),
which the test computes with the JAX package from the keys the JAX step
splits.

Tolerances:

- The transpose against JAX's: per row group (means 0..2, directions
  3..5, variances 11..13), max abs error over the group's largest entry,
  1e-5 (f32 sums in another order); the rows JAX leaves zero exactly zero.
- Against float64 autograd: atol 1e-9 of the largest entry (exact algebra,
  float64 rounding only).
- The interval weights, losses and renders against JAX's: atol 1e-6 on
  weights in [0, 1] (rgb, losses rtol 1e-5).
- A train step against JAX's: the losses rtol 2e-5, the ``dr``/``dt``
  tables atol 1e-5 (JAX's bounds, tests/test_pose_app.py:871).
"""

from __future__ import annotations

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerf_simple_tpu.config as jconfig
import nerf_simple_tpu.kernels.mlp as jmlp
import nerf_simple_tpu.models.nerf as jnerf
import nerf_simple_tpu.models.proposal as jproposal
import nerf_simple_tpu.ops.rays as jrays
import nerf_simple_tpu.ops.sampling as jsampling
import nerf_simple_tpu.ops.volume as jvolume
import nerf_simple_tpu.render.renderer as jrenderer
import nerf_simple_tpu.train.step as jstep
from nerf_simple_tpu.models import model_from_train_config as jmodel_from_train_config
from nerf_simple_tpu_torch import config
from nerf_simple_tpu_torch.data import synthetic
from nerf_simple_tpu_torch.kernels import mlp
from nerf_simple_tpu_torch.models import model_from_train_config
from nerf_simple_tpu_torch.models.nerf import NerfField, NerfMLP
from nerf_simple_tpu_torch.models.proposal import ProposalField, ProposalMLP, ProposalPair, proposal_weights_intervals
from nerf_simple_tpu_torch.ops import volume
from nerf_simple_tpu_torch.probes import input_grad as ig_probe
from nerf_simple_tpu_torch.render import renderer
from nerf_simple_tpu_torch.render.renderer import RenderSettings
from nerf_simple_tpu_torch.train import step as tstep

GROUPS = [(0, 3), (3, 6), (11, 14)]  # the mean, direction and variance rows
ZERO_ROWS = list(ig_probe.MIP_ZERO_ROWS)
TN, TF = 0.5, 30.0  # the unbounded scene's bounds (JAX scripts/unbounded_bench.py:70-116)
N_RAYS, RAYS_PER_IMAGE, N_IMAGES, BATCH = 64, 16, 4, 32  # JAX's _tiny_cfg step (tests/test_pose_app.py:871)
BASE_RADIUS = 0.02
PROP = dict(proposal=True, Np=8, prop_Lp=4, prop_D=2, prop_H=16)
CONTRACT = dict(contract=True, sampling_space="disparity", tn=TN, tf=TF)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jtree(params):
    if isinstance(params, dict):
        return {k: _jtree(v) for k, v in params.items()}
    return jnp.asarray(params)


def _x16(rows, seed):
    """(16, rows) f32 mip input: means on both sides of the unit sphere (a
    third at |x| in [0.05, 0.99], a third within 1e-2 of it, the rest in
    [1.5, 30]), unit dirs, variances log-uniform in [1e-5, 1e-1]."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(3, rows))
    u /= np.linalg.norm(u, axis=0, keepdims=True)
    k = rows // 3
    r = np.concatenate([rng.uniform(0.05, 0.99, rows - 2 * k), 1.0 + rng.choice([-1, 1], k) * rng.uniform(1e-4, 1e-2, k),
                        rng.uniform(1.5, 30.0, k)])
    d = rng.normal(size=(3, rows))
    x = np.zeros((16, rows), np.float32)
    x[:3] = u * rng.permutation(r)
    x[3:6] = d / np.linalg.norm(d, axis=0, keepdims=True)
    x[11:14] = 10.0 ** rng.uniform(-5, -1, (3, rows))
    return x


# --- the input gradient of a contracted model under mip ------------------------------------------------------

@pytest.mark.parametrize("Lp, Ld", [(4, 2), (10, 4)], ids=["small", "flagship"])
def test_mip_contract_input_grad_plain_matches_jax_input_grad_tile_mip(Lp, Ld):
    """The port's plain input gradient of a contracted model under mip
    (``_encode_transpose(mip=True)``: both chains at the contracted means
    and variances, then ``_contract_transpose_mip``) against the JAX
    ``_input_grad_tile_mip`` with ``contract=True`` (:972-983, :1034-1064),
    called as plain jnp on the same encoded-row cotangents, means, dirs and
    variances; inside the unit ball it equals the transpose without
    contract."""
    rows = 600
    x = _x16(rows, 1)
    rng = np.random.default_rng(2)
    gx = rng.normal(size=(mlp._enc_rows(Lp), rows)).astype(np.float32)
    gd = rng.normal(size=(mlp._enc_rows(Ld), rows)).astype(np.float32)
    jm = jnerf.NerfMLP(Lp, Ld, 32, contract=True)
    want = np.asarray(jmlp._input_grad_tile_mip(
        jnp.asarray(x[:8]), jnp.asarray(x[8:16]), jnp.asarray(gx), jnp.asarray(gd), jnp.asarray(jmlp._spread_x(jm)),
        jnp.asarray(jmlp._spread_d(jm)), jnp.asarray(jmlp._spread_v(jm)), jm))
    model = NerfMLP(Lp=Lp, Ld=Ld, H=32, contract=True)
    got = mlp._encode_transpose(_t(x), _t(gx), _t(gd), model, mip=True).numpy()
    assert got.shape == want.shape == (16, rows) and got.dtype == np.float32
    assert (got[ZERO_ROWS] == 0).all() and (want[ZERO_ROWS] == 0).all()
    for a, b in GROUPS:
        err = np.abs(got[a:b] - want[a:b]).max() / np.abs(want[a:b]).max()
        assert err <= 1e-5, (a, b, err)
    inside = np.linalg.norm(x[:3], axis=0) <= 1.0
    plain = mlp._encode_transpose(_t(x), _t(gx), _t(gd), NerfMLP(Lp=Lp, Ld=Ld, H=32), mip=True).numpy()
    np.testing.assert_array_equal(got[:, inside], plain[:, inside])
    assert np.abs(got[:, ~inside] - plain[:, ~inside]).max() > 1e-2


def test_mip_contract_input_grad_equals_autograd_in_f64():
    """The plain transpose in float64 against ``torch.autograd.grad``
    through the port's plain contracted integrated encoder (``_encode``
    with the variances: the contraction, the linearised Gaussian warp, the
    damped sin/cos rows), an independent check of the closed form; and
    B2's plain version with dx against autograd of the plain forward. The
    probe's copy of the coupled transpose (``transpose_mip_with``) equals
    the plain one, and each of its planted terms moves it."""
    model = NerfMLP(Lp=4, Ld=2, H=32, contract=True)
    rows = 300
    x = torch.from_numpy(_x16(rows, 3).astype(np.float64))
    rng = np.random.default_rng(4)
    gx = torch.from_numpy(rng.normal(size=(mlp._enc_rows(4), rows)))
    gd = torch.from_numpy(rng.normal(size=(mlp._enc_rows(2), rows)))
    xr = x.clone().requires_grad_(True)
    posx, posd = mlp._encode(xr, model, xr[11:14])
    (dx_auto,) = torch.autograd.grad((posx * gx).sum() + (posd * gd).sum(), xr)
    got = mlp._encode_transpose(x, gx, gd, model, mip=True)
    assert (got[ZERO_ROWS] == 0).all()
    np.testing.assert_allclose(got.numpy(), dx_auto.numpy(), atol=1e-9 * dx_auto.abs().max().item())

    from nerf_simple_tpu_torch.models.nerf import init_nerf_params

    wts = mlp.FusedWeights(*(w.double() for w in mlp.pack_weights(NerfField.from_jax_params(
        init_nerf_params(12, model), "cpu", model))))
    g = torch.from_numpy(rng.normal(size=(8, rows)))
    xr = x.clone().requires_grad_(True)
    (mlp.fused_mlp_forward_plain(wts, xr, torch.float64, model, mip=True) * g).sum().backward()
    _, dx = mlp.fused_mlp_backward_plain(wts, x, g, torch.float64, model, mip=True, want_dx=True)
    np.testing.assert_allclose(dx.numpy(), xr.grad.numpy(), atol=1e-9 * xr.grad.abs().max().item())

    xyz, var = x[0:3], x[11:14]
    dy, dvo = torch.from_numpy(rng.normal(size=(3, rows))), torch.from_numpy(rng.normal(size=(3, rows)))
    want = mlp._contract_transpose_mip(xyz, var, dy, dvo)
    same = ig_probe.transpose_mip_with(xyz, var, dy, dvo)
    assert all(torch.allclose(a, b, rtol=1e-12, atol=0) for a, b in zip(same, want))
    for fault, row in (("term_n_dropped", 0), ("coupling_dropped", 1)):
        bad = ig_probe.transpose_mip_with(xyz, var, dy, dvo, fault)
        assert (bad[row] - want[row]).abs().max() > 1e-3 * want[row].abs().max(), fault


# --- the interval forms of the proposal scheme ---------------------------------------------------------------

def _rays(n, seed, contract=False):
    """(n, 6) rays: from cameras at r = 3..6 towards the origin (the
    unbounded rig) under ``contract``, else from r = 4 across the [2, 6]
    shell; unnormalised directions."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = rng.uniform(3.0, 6.0, (n, 1)) if contract else 4.0
    o = -r * d + rng.normal(0, 0.3, (n, 3))
    return np.concatenate([o, d * rng.uniform(0.8, 1.2, (n, 1))], 1).astype(np.float32)


@pytest.mark.parametrize("opaque", [False, True], ids=["open", "opaque"])
def test_interval_weights_losses_and_proposal_weights_match_jax(opaque):
    """``weights_from_sigma_intervals``, ``interlevel_loss_intervals`` (and
    its gradient in the proposal weights) and ``proposal_weights_intervals``
    (point and contracted proposal net, and its gradient) against JAX's,
    with and without the opaque tail; the opaque tail's weights sum to 1,
    and its interlevel loss ignores the fine level's last interval."""
    rng = np.random.default_rng(5)
    B, N, Np = 24, 12, 8
    sigma = rng.normal(0, 2, (B, N)).astype(np.float32)
    edges = np.sort(rng.uniform(2, 6, (B, N + 1)), -1).astype(np.float32)
    dirs = rng.normal(size=(B, 3)).astype(np.float32)
    unit = dirs / np.linalg.norm(dirs, axis=1, keepdims=True)
    want = np.asarray(jax.jit(functools.partial(jvolume.weights_from_sigma_intervals, opaque_tail=opaque))(
        jnp.asarray(sigma), jnp.asarray(edges), jnp.asarray(unit)))
    got = volume.weights_from_sigma_intervals(_t(sigma), _t(edges), _t(unit), opaque)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    if opaque:
        np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)

    w = rng.uniform(0, 0.2, (B, N)).astype(np.float32)
    mids = 0.5 * (edges[:, 1:] + edges[:, :-1])
    edges_p = np.sort(rng.uniform(2, 6, (B, Np + 1)), -1).astype(np.float32)
    w_prop = rng.uniform(0, 0.2, (B, Np)).astype(np.float32)
    jl, jg = jax.jit(jax.value_and_grad(lambda wp: jvolume.interlevel_loss_intervals(
        jnp.asarray(w), jnp.asarray(mids), wp, jnp.asarray(edges_p), opaque_tail=opaque)))(jnp.asarray(w_prop))
    wp = _t(w_prop).requires_grad_(True)
    loss = volume.interlevel_loss_intervals(_t(w), _t(mids), wp, _t(edges_p), opaque)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(wp.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-7)
    w2 = w.copy()
    w2[:, -1] += 0.7
    moved = volume.interlevel_loss_intervals(_t(w2), _t(mids), _t(w_prop), _t(edges_p), opaque).item()
    assert (moved == loss.item()) == opaque

    for contract in (False, True):
        pm = ProposalMLP(Lp=4, D=2, H=16, contract=contract)
        jpm = jproposal.ProposalMLP(Lp=4, D=2, H=16, contract=contract)
        params = jax.tree.map(np.asarray, jproposal.init_proposal_params(jax.random.PRNGKey(6), jpm))
        rays = _rays(B, 7, contract)
        pe = np.sort(rng.uniform(TN if contract else 2.0, TF if contract else 6.0, (B, Np + 1)), -1).astype(np.float32)
        cot = rng.normal(size=(B, Np)).astype(np.float32)

        def weights_and_vjp(p, c, jpm=jpm, rays=rays, pe=pe):
            w, vjp = jax.vjp(lambda q: jproposal.proposal_weights_intervals(
                q, jnp.asarray(rays), jnp.asarray(pe), jpm, jnp.float32, opaque_tail=opaque), p)
            return w, vjp(c)[0]

        jw, jgrad = jax.jit(weights_and_vjp)(_jtree(params), jnp.asarray(cot))
        field = ProposalField.from_jax_params(params, "cpu", pm)
        tw = proposal_weights_intervals(field, _t(rays), _t(pe), torch.float32, opaque)
        np.testing.assert_allclose(tw.detach().numpy(), np.asarray(jw), atol=1e-6)
        (tw * _t(cot)).sum().backward()
        for name, p in field.to_jax_params().items():
            tl = getattr(field, name)
            np.testing.assert_allclose(tl.weight.grad.T.numpy(), np.asarray(jgrad[name]["w"]), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("case", ["linear", "contract-opaque"])
def test_render_rays_proposal_mip_matches_jax(case):
    """The mip branch of ``render_rays_proposal`` with ``det_fine`` (the
    probe edges at bin midpoints, the fine edges at the quantiles) against
    JAX's (render/renderer.py:614-645) on the xla paths of both: the probe
    edges, the proposal weights, the fine edges, rgb and weights; the
    contracted case in disparity space with the opaque background. The
    chunked render's first chunk equals the direct render."""
    contract = case.startswith("contract")
    kw = dict(sampling_space="disparity", tn=TN, tf=TF, opaque_background=True) if contract else {}
    model = NerfMLP(Lp=4, Ld=2, H=32, contract=contract)
    pm = ProposalMLP(Lp=4, D=2, H=16, contract=contract)
    jm = jnerf.NerfMLP(4, 2, 32, contract=contract)
    jpm = jproposal.ProposalMLP(Lp=4, D=2, H=16, contract=contract)
    params = {"fine": jax.tree.map(np.asarray, jnerf.init_nerf_params(jax.random.PRNGKey(8), jm)),
              "prop": jax.tree.map(np.asarray, jproposal.init_proposal_params(jax.random.PRNGKey(9), jpm))}
    rays = _rays(N_RAYS, 10, contract)
    js = jrenderer.RenderSettings(N=16, N_prop=8, mip=True, base_radius=BASE_RADIUS, **kw)
    render = jax.jit(lambda p, r: jrenderer.render_rays_proposal(p, r, jax.random.PRNGKey(0), js, jm, jpm,
                                                                 det_fine=True, return_aux=True))
    want, (jep, jwp, jef) = render(_jtree(params), jnp.asarray(rays))
    pair = ProposalPair.from_jax_params(params, "cpu", model, pm)
    s = RenderSettings(N=16, N_prop=8, mip=True, base_radius=BASE_RADIUS, backend="pallas", **kw)
    with torch.no_grad():
        got, (ep, wp, ef) = renderer.render_rays_proposal(pair, _t(rays), None, s, det_fine=True, return_aux=True)
    assert ep.shape == (N_RAYS, 9) and ef.shape == (N_RAYS, 17) and got.weights.shape == (N_RAYS, 16)
    np.testing.assert_allclose(ep.numpy(), np.asarray(jep), rtol=1e-6)
    np.testing.assert_allclose(wp.numpy(), np.asarray(jwp), atol=1e-6)
    np.testing.assert_allclose(ef.numpy(), np.asarray(jef), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.rgb.numpy(), np.asarray(want.rgb), atol=1e-5)
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights), atol=1e-5)
    rgb, _ = renderer.render_rays_chunked(pair, _t(rays), 3, s, chunk=16)
    with torch.no_grad():
        direct = renderer.render_rays_proposal(pair, _t(rays[:16]), renderer.chunk_generator(3, 0, "cpu"), s,
                                               det_fine=True)
    np.testing.assert_allclose(rgb[:16].numpy(), torch.clamp(direct.rgb, 0, 1).numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="integrated"):
        renderer.render_rays_proposal(pair, _t(rays), None, s, det_fine=True, enc_alpha=0.5)


# --- train steps against JAX's -------------------------------------------------------------------------------

KINDS = {
    "mip-proposal": dict(mip=True, **PROP, distortion_loss_weight=0.01, opaque_background=True),
    "mip-proposal-contract": dict(mip=True, **PROP, **CONTRACT, distortion_loss_weight=0.01),
    "pose-mip-proposal": dict(mip=True, **PROP, pose_opt=True),
    "pose-mip-contract": dict(mip=True, **CONTRACT, pose_opt=True),
    "pose-mip-proposal-contract": dict(mip=True, **PROP, **CONTRACT, pose_opt=True, opaque_background=True,
                                       distortion_loss_weight=0.01),
}


def _tiny(kind, **kw) -> dict:
    """JAX's _tiny_cfg (tests/test_pose_app.py:150), one step a call, f32,
    no pose warmup (the deltas move in the first step)."""
    return dict(datapath="x", Nf=8, num_iters=4, batch_size=BATCH, steps_per_call=1, net_H=32, net_Lp=4, net_Ld=2,
                pose_warmup=0, compute_dtype="f32", **KINDS[kind], **kw)


@functools.lru_cache(maxsize=None)
def _jax_steps(kind: str, n_steps: int = 2):
    """The JAX step (``backend: xla``) ``n_steps`` times from its own state,
    and each step's draws as the JAX step makes them: (params of the first
    state, losses, the final cams, draws)."""
    cfg = jconfig.TrainConfig(**_tiny(kind, backend="xla"))
    model = jmodel_from_train_config(cfg)
    pose = dict(rays_per_image=RAYS_PER_IMAGE) if cfg.pose_opt else {}
    state = jstep.make_train_state(jax.random.PRNGKey(0), cfg, model, n_images=N_IMAGES)
    step = jstep.build_train_step(cfg, model, donate=False, base_radius=BASE_RADIUS, **pose)
    rays_np, pix_np = _rays(N_RAYS, 1, cfg.contract), np.random.default_rng(1).uniform(0, 1, (N_RAYS, 3))
    rays, pix = jnp.asarray(rays_np), jnp.asarray(pix_np.astype(np.float32))
    key = jax.random.PRNGKey(3)
    p0 = jax.tree.map(np.asarray, state.params)
    losses, draws = [], []
    for i in range(n_steps):
        k_sel, k_render = jax.random.split(jax.random.fold_in(key, i))
        idx = jax.random.randint(k_sel, (BATCH,), 0, N_RAYS)
        field = state.params["field"] if cfg.pose_opt else state.params
        r = rays[idx]
        if cfg.pose_opt:
            im_b = idx // RAYS_PER_IMAGE
            r = jrays.apply_cam_deltas(r, state.params["cams"]["dr"][im_b], state.params["cams"]["dt"][im_b])
        d = {"idx": np.asarray(idx)}
        if cfg.proposal:
            k_strat, k_imp = jax.random.split(k_render)
            ep = jsampling.stratified_ts_spaced(k_strat, BATCH, cfg.Np + 1, cfg.tn, cfg.tf, space=cfg.sampling_space)
            w = jproposal.proposal_weights_intervals(field["prop"], r, ep, jproposal.proposal_from_train_config(cfg),
                                                     jnp.float32, opaque_tail=cfg.opaque_background)
            d["edges"] = np.asarray(ep)
            d["edges_fine"] = np.asarray(jsampling.resample_edges(k_imp, ep, w, cfg.Nf, blur=cfg.resample_blur))
        else:
            d["edges"] = np.asarray(jsampling.stratified_ts_spaced(k_render, BATCH, cfg.Nf + 1, cfg.tn, cfg.tf,
                                                                   space=cfg.sampling_space))
        draws.append(d)
        state, loss = step(state, rays, pix, key)
        losses.append(float(np.asarray(loss).reshape(-1)[0]))
    cams = jax.tree.map(np.asarray, state.params["cams"]) if cfg.pose_opt else None
    return p0, losses, cams, draws, rays_np, pix_np.astype(np.float32)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_mip_proposal_and_pose_steps_match_jax_xla_step(monkeypatch, kind, backend):
    """Two f32 steps of the port's ``build_train_step`` (under "pallas"
    without pose the fused mip x proposal core, B1's plain version on CPU,
    one launch a step; with pose, or under "xla", the autograd path: the
    main field through ``fused_mlp(mip=True)`` with B2's mip input gradient,
    a contracted model's included, or ``nerf_apply_mip``, the proposal net
    in plain autograd) against two of the JAX step with ``backend: xla`` on
    the same rays, draws and initial params: the losses (MSE + the interval
    interlevel loss + the interval distortion) and, with pose, the refined
    camera tables."""
    p0, jlosses, jcams, draws, rays_np, pix_np = _jax_steps(kind)
    cfg = config.TrainConfig(**_tiny(kind, backend=backend))
    model = model_from_train_config(cfg)
    fp0 = p0["field"] if cfg.pose_opt else p0
    if cfg.proposal:
        field = ProposalPair.from_jax_params(fp0, "cpu", model, ProposalMLP(Lp=4, D=2, H=16, contract=cfg.contract))
    else:
        field = NerfField.from_jax_params(fp0, "cpu", model)
    cams = tstep.CamDeltas(N_IMAGES).copy_tables_(p0["cams"]) if cfg.pose_opt else None
    state = tstep.TrainState(field, tstep.make_optimizer(cfg, field.parameters(), cams), torch.Generator(), cams=cams)
    queue, cur = list(draws), {}

    def randint(*a, **k):  # step_fn's first draw, the batch: the step's other draws follow it
        cur.clear()
        cur.update(queue.pop(0))
        return _t(cur["idx"]).long()

    monkeypatch.setattr(torch, "randint", randint)
    monkeypatch.setattr(tstep, "stratified_ts_spaced", lambda *a, **k: _t(cur["edges"]))
    for mod in (renderer, tstep):
        monkeypatch.setattr(mod, "resample_edges", lambda *a, **k: _t(cur["edges_fine"]))
    calls = []
    real = tstep.mip_proposal_fused_loss
    monkeypatch.setattr(tstep, "mip_proposal_fused_loss", lambda *a, **k: calls.append(1) or real(*a, **k))
    step_fn = tstep.build_train_step(cfg, model, base_radius=BASE_RADIUS,
                                     rays_per_image=RAYS_PER_IMAGE if cfg.pose_opt else None)
    losses = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore" if backend == "xla" else "error")  # no fallback warning on the pallas paths
        for _ in range(2):
            losses.append(step_fn(state, _t(rays_np), _t(pix_np)).item())
    fused = backend == "pallas" and not cfg.pose_opt and cfg.proposal
    assert len(calls) == 2 * fused
    np.testing.assert_allclose(losses, jlosses, rtol=2e-5)
    if cfg.pose_opt:
        assert np.abs(jcams["dr"]).max() > 0 and np.abs(cams.tables()["dt"]).max() > 0
        for k in ("dr", "dt"):
            np.testing.assert_allclose(cams.tables()[k], jcams[k], atol=1e-5, err_msg=k)


# --- the config and RenderSettings rules ---------------------------------------------------------------------

def test_mip_proposal_config_and_render_settings_rules():
    """mip x proposal loads in both packages (JAX tests/test_mip_proposal.py:
    355-392, :720): with distortion, the opaque background, contract and
    pose (colmap360.yaml + ``mip: true`` and its pose block among them);
    ``TestConfig`` and ``RenderSettings`` take mip with Np; JAX's rules
    raise in both: ``mip_levels: 2`` with proposal, mip with
    ``pe_anneal_until`` or ``appearance_dim`` (ValueError); the two-level
    eval with Np; ``mip_multiscale`` still raises, naming its item; the
    fused core takes the composition, pose's path is autograd."""
    base = dict(datapath="x")
    for kw in (dict(mip=True, proposal=True, Np=8, distortion_loss_weight=0.01),
               dict(mip=True, proposal=True, Np=8, opaque_background=True),
               dict(mip=True, proposal=True, Np=8, contract=True, pose_opt=True, pose_warmup=10, pose_freeze_at=100),
               dict(mip=True, contract=True, pose_opt=True)):
        jconfig.TrainConfig(**base, **kw)
        cfg = config.TrainConfig(**base, **kw)
        assert cfg.mip and (tstep.kernel_refusal(cfg) is None) == (not cfg.pose_opt)
    d = {k: v for k, v in config.load_yaml("configs/colmap360.yaml").items()
         if k not in ("dataset", "llff_factor", "ndc", "test_params")}
    for extra in ({"mip": True}, {"mip": True, "opaque_background": True, "pose_opt": True, "pose_warmup": 600,
                                  "pose_freeze_at": 5000}):
        cfg = config.train_config_from_dict({**d, **extra, "datapath": "x"})
        assert (cfg.mip, cfg.proposal, cfg.contract, cfg.mip_levels) == (True, True, True, 1)
        jconfig.TrainConfig(**{**d, **extra, "datapath": "x"})
    for kw, match in ((dict(mip=True, mip_levels=2, proposal=True), "mip_levels=2 and proposal"),
                      (dict(mip=True, proposal=True, pe_anneal_until=10, pose_opt=True), "pe_anneal_until"),
                      (dict(mip=True, proposal=True, appearance_dim=4), "appearance_dim")):
        for mod in (config, jconfig):
            with pytest.raises(ValueError, match=match):
                mod.TrainConfig(**base, **kw)
    tbase = dict(loadpath="m", datapath="x")
    for mod in (config, jconfig):
        tc = mod.TestConfig(**tbase, mip=True, Np=8, opaque_background=True)
        assert tc.mip and tc.Np == 8
        with pytest.raises(ValueError, match="mip_levels=2 and Np"):
            mod.TestConfig(**tbase, mip=True, mip_levels=2, Np=8)
    assert config.train_config_from_dict({**base, "mip": True, "proposal": True, "mip_multiscale": True}).proposal
    for mod in (config, jconfig):  # occupancy is ported: with mip JAX's ValueError (config.py:342-350)
        with pytest.raises(ValueError, match="incompatible with occupancy"):
            mod.TrainConfig(**base, mip=True, proposal=True, occupancy=True)
    s = RenderSettings(mip=True, N_prop=8, base_radius=0.01, opaque_background=True)
    assert s.mip and s.N_prop == 8
    with pytest.raises(ValueError, match="excludes hierarchical"):
        RenderSettings(mip=True, N_coarse=8)


# --- train(), evaluate.test and the server -------------------------------------------------------------------

def test_train_evaluate_and_serve_the_360_composition_with_pose(tmp_path, capsys, monkeypatch):
    """train() on CPU (pallas, the plain kernels) of colmap360.yaml's shape
    with ``mip: true``, the opaque background and its pose block on a small
    unbounded scene with jittered train poses: before the freeze the
    autograd path (the contracted forward and B2 with the ``MIP &&
    CONTRACT`` input gradient's plain version), after it the fused mip x
    proposal core; the loss stays finite, the deltas move and are baked;
    the checkpoint holds ``{prop, fine}`` of a contracted model;
    ``evaluate.test`` renders the refined train still with Np probes under
    mip; the server's frame equals ``render_rays_chunked``'s."""
    import sys

    from nerf_simple_tpu_torch.evaluate import load_params, test
    from nerf_simple_tpu_torch.serve import RenderServer
    from nerf_simple_tpu_torch.train import checkpoint as ckpt
    from nerf_simple_tpu_torch.train import loop

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    scene = str(tmp_path / "scene")
    synthetic.write_blender_scene(scene, n_train=3, n_val=1, n_test=1, H=10, W=10, train_jitter=3,
                                  style="unbounded", camera_r_range=(3.0, 6.0))
    cfg = dict(datapath=scene, savepath=str(tmp_path / "m"), exp_name="p", Nf=8, mip=True, opaque_background=True,
               **CONTRACT, **PROP, distortion_loss_weight=0.01, net_Lp=4, net_Ld=2, net_H=32, num_iters=15,
               steps_per_call=5, ckpt_loss=5, ckpt_images=10**6, ckpt_model=5, batch_size=32, half_res=False,
               val_idxs=[0], num_train_imgs=3, backend="pallas", log_dir=str(tmp_path / "logs"), pose_opt=True,
               pose_warmup=2, pose_freeze_at=7, pose_lr_init=1e-2)
    calls = []
    for name in ("autograd_loss", "mip_proposal_fused_loss"):
        real = getattr(tstep, name)
        monkeypatch.setattr(tstep, name, lambda *a, _r=real, _n=name, **k: calls.append(_n) or _r(*a, **k))
    state = loop.train(cfg, device="cpu")
    out = capsys.readouterr().out
    assert calls == ["autograd_loss"] * 10 + ["mip_proposal_fused_loss"] * 5
    assert "pose freeze at step 10" in out and state.cams is None and "nan" not in out.lower()
    exp = tmp_path / "m" / "p"
    with np.load(exp / "cam_deltas.npz") as side:
        assert np.abs(side["dr"]).max() > 0 and np.abs(side["dt"]).max() > 0
    assert ckpt.load_model_meta(str(exp)).contract
    ev = dict(loadpath=str(exp), datapath=scene, half_res=False, N_samples=8, Np=8, mip=True, opaque_background=True,
              batch_size=256, im_idxs=[0], im_set="train", sampling_space="disparity", tn=TN, tf=TF,
              savepath=str(tmp_path / "r"))
    test(ev, device="cpu")
    assert "im 0: mse=" in capsys.readouterr().out and (tmp_path / "r" / "exp" / "rgb_0.png").exists()

    params = load_params(str(exp), keep_hierarchy=True)
    assert set(params) == {"prop", "fine"}
    s = RenderSettings(N=8, N_prop=8, mip=True, opaque_background=True, base_radius=0.05, sampling_space="disparity",
                       tn=TN, tf=TF, backend="pallas")
    srv = RenderServer(params, 6, 6, 5.0, s, model=ckpt.load_model_meta(str(exp)), warmup=False, device="cpu")
    assert srv.field.prop.model.contract and srv.field.fine.model.contract
    frame = srv.render(4.0, -30.0, 60.0)
    from nerf_simple_tpu_torch.ops.rays import rays_for_poses
    from nerf_simple_tpu_torch.serve import spherical_to_pose

    rays = rays_for_poses(torch.as_tensor(spherical_to_pose(4.0, -30.0, 60.0)[None], dtype=torch.float32), 6, 6, 5.0)
    rgb, _ = renderer.render_rays_chunked(srv.field, rays, srv.seed, s)
    assert np.abs(frame.astype(int) - (rgb.reshape(6, 6, 3).numpy() * 255).astype(np.uint8).astype(int)).max() <= 1
