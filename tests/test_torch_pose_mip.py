"""The port's pose refinement with cone casting (mip) and with proposal
sampling on CPU against the JAX package: the integrated encoder's transpose
(the plain mip input gradient, the mip branch of B2's ``want_dx``) against
the JAX ``_input_grad_tile_mip`` called as plain jnp and against float64
autograd; the differentiable ``fused_mlp(mip=True)`` (its plain versions,
as the wrappers run them on CPU tensors) against ``jax.grad`` of the JAX
``nerf_apply_mip``; one and two f32 train steps of the port with pose + mip
(``mip_levels`` 1 and 2) and with pose + proposal (point form, mid-anneal)
against the JAX ``build_train_step`` with ``backend: xla``; the proposal
render and the chunked render with ``enc_alpha``; the config rules; and
``train()`` through a freeze, a resume past it and eval of refined train
stills for a pose-trained mip run and a pose-trained proposal run.

The JAX side runs its XLA paths only (its interpret-mode kernels are
costly; its own pallas-vs-xla tests of these compositions are marked
slow). The two packages draw different random numbers, so a port step is
handed the JAX step's draws (the batch indices, the interval edges or
probes, the fine edges or importance samples), which the test computes
with the JAX package from the same keys the JAX step splits.

Tolerances:

- The mip transpose against JAX's: rtol 1e-5, with an atol of 1e-6 of the
  row group's largest entry (the mean, direction and variance rows each:
  an entry whose terms cancel keeps no relative precision in f32); the
  rows JAX leaves zero exactly zero.
- Against float64 autograd of the plain forward: atol 1e-12.
- ``fused_mlp(mip=True)``'s input gradients against ``jax.grad`` of
  ``nerf_apply_mip``: atol 2e-4, rtol 2e-3 (JAX's bounds,
  tests/test_mip.py:776).
- A train step against JAX's: losses rtol 2e-5, the ``dr``/``dt`` tables
  atol 1e-5 (JAX's bounds, tests/test_pose_app.py:871).
- The proposal render with ``enc_alpha`` against JAX's: rgb and weights
  atol 1e-5 (tests/test_torch_proposal.py's render bound).
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
import nerf_simple_tpu.render.renderer as jrenderer
import nerf_simple_tpu.train.step as jstep
from nerf_simple_tpu.models import model_from_train_config
from nerf_simple_tpu_torch import config
from nerf_simple_tpu_torch.data import synthetic
from nerf_simple_tpu_torch.kernels import mlp
from nerf_simple_tpu_torch.models.nerf import NerfField, NerfMLP, init_nerf_params
from nerf_simple_tpu_torch.models.proposal import ProposalMLP, ProposalPair
from nerf_simple_tpu_torch.ops import rays as trays
from nerf_simple_tpu_torch.probes.input_grad import MIP_ZERO_ROWS
from nerf_simple_tpu_torch.render import renderer
from nerf_simple_tpu_torch.render.renderer import RenderSettings
from nerf_simple_tpu_torch.train import checkpoint as ckpt
from nerf_simple_tpu_torch.train import step as tstep

SMALL = NerfMLP(Lp=4, Ld=2, H=32)
FLAGSHIP = NerfMLP()
ZERO_ROWS = list(MIP_ZERO_ROWS)  # what _input_grad_tile_mip leaves zero
GROUPS = [(0, 3), (3, 6), (11, 14)]  # the mean, direction and variance rows
N_RAYS, RAYS_PER_IMAGE, N_IMAGES, BATCH = 64, 16, 4, 32  # JAX's _tiny_cfg step (tests/test_pose_app.py:871)
BASE_RADIUS = 0.02


def _t(a):
    return torch.from_numpy(np.array(a))


def _jm(model):
    return jnerf.NerfMLP(model.Lp, model.Ld, model.H)


def _jtree(params):
    if isinstance(params, dict):
        return {k: _jtree(v) for k, v in params.items()}
    return jnp.asarray(params)


def _x16(rows, seed):
    """(16, rows) f32: means N(0, 1.2), unit dirs, variances U(0.001, 0.05)
    in rows 11..13 (JAX tests/test_mip.py:776's inputs)."""
    rng = np.random.default_rng(seed)
    x = np.zeros((16, rows), np.float32)
    x[:3] = rng.normal(0, 1.2, (3, rows))
    d = rng.normal(size=(3, rows))
    x[3:6] = d / np.linalg.norm(d, axis=0, keepdims=True)
    x[11:14] = rng.uniform(0.001, 0.05, (3, rows))
    return x


# --- the integrated encoder's transpose ------------------------------------------------------------------

@pytest.mark.parametrize("model", [SMALL, FLAGSHIP], ids=["small", "flagship"])
def test_mip_input_grad_plain_matches_jax_input_grad_tile_mip(model):
    """The port's plain mip input gradient (``_encode_transpose(mip=True)``,
    what ``input_grad_plain`` and B2's plain version run under mip) against
    the JAX ``_input_grad_tile_mip`` without contraction, called as plain
    jnp on the same encoded-row cotangents, means, dirs and variances."""
    rows = 256
    x = _x16(rows, 1)
    rng = np.random.default_rng(2)
    gx = rng.normal(size=(mlp._enc_rows(model.Lp), rows)).astype(np.float32)
    gd = rng.normal(size=(mlp._enc_rows(model.Ld), rows)).astype(np.float32)
    jm = _jm(model)
    want = np.asarray(jmlp._input_grad_tile_mip(
        jnp.asarray(x[:8]), jnp.asarray(x[8:16]), jnp.asarray(gx), jnp.asarray(gd), jnp.asarray(jmlp._spread_x(jm)),
        jnp.asarray(jmlp._spread_d(jm)), jnp.asarray(jmlp._spread_v(jm)), jm))
    got = mlp._encode_transpose(_t(x), _t(gx), _t(gd), model, mip=True).numpy()
    assert got.shape == want.shape == (16, rows) and got.dtype == np.float32
    assert (got[ZERO_ROWS] == 0).all() and (want[ZERO_ROWS] == 0).all()
    for a, b in GROUPS:
        np.testing.assert_allclose(got[a:b], want[a:b], rtol=1e-5, atol=1e-6 * np.abs(want[a:b]).max(),
                                   err_msg=f"rows {a}..{b - 1}")
    # the damp chain is live: at zero variance the mean rows are the point transpose's, the variance rows not 0
    x0 = x.copy()
    x0[11:14] = 0.0
    point = mlp._encode_transpose(_t(x0[:8]), _t(gx), _t(gd), model).numpy()
    at0 = mlp._encode_transpose(_t(x0), _t(gx), _t(gd), model, mip=True).numpy()
    np.testing.assert_array_equal(at0[:6], point[:6])
    assert np.abs(at0[11:14]).min() > 0 and np.abs(got[:3] - at0[:3]).max() > 1e-2


def test_mip_input_grad_equals_autograd_of_the_plain_forward_in_f64():
    """dx of B2's plain version under mip (and of ``input_grad_plain`` on
    the backward tile's planes) against torch autograd of the plain mip
    forward, all in float64: rows 0..5 and 11..13, the rest zero."""
    wts = mlp.FusedWeights(*(w.double() for w in mlp.pack_weights(NerfField.from_jax_params(
        init_nerf_params(12, SMALL), "cpu"))))
    x = torch.from_numpy(_x16(200, 13).astype(np.float64))
    g = torch.from_numpy(np.random.default_rng(14).normal(size=(8, 200)))
    xr = x.clone().requires_grad_(True)
    (mlp.fused_mlp_forward_plain(wts, xr, torch.float64, SMALL, mip=True) * g).sum().backward()
    _, dx = mlp.fused_mlp_backward_plain(wts, x, g, torch.float64, SMALL, mip=True, want_dx=True)
    assert dx.shape == (16, 200) and (dx[ZERO_ROWS] == 0).all()
    np.testing.assert_allclose(dx.numpy(), xr.grad.numpy(), atol=1e-12)
    _, res = mlp.forward_residuals_plain(wts, x, torch.float64, SMALL, mip=True)
    gws = mlp.backward_tile_plain(wts, res, g, torch.float64, SMALL)
    np.testing.assert_allclose(mlp.input_grad_plain(wts, x, gws, torch.float64, SMALL, mip=True).numpy(),
                               xr.grad.numpy(), atol=1e-12)


@pytest.mark.parametrize("model", [SMALL, FLAGSHIP], ids=["small", "flagship"])
def test_fused_mlp_mip_input_grads_match_jax_autodiff(model):
    """``fused_mlp(mip=True)`` on CPU tensors (the plain forward and B2's
    plain version with the mip input gradient) through ``torch.autograd``:
    dL/d(mean), dL/d(variance) and dL/d(dir) against ``jax.grad`` of JAX's
    ``nerf_apply_mip`` (JAX tests/test_mip.py:776, ``contract=False``); the
    launch counters do not move (no kernel on the CPU)."""
    R = 128
    rng = np.random.default_rng(3)
    jm = _jm(model)
    params = jnerf.init_nerf_params(jax.random.PRNGKey(0), jm)
    mean = rng.normal(0, 1.2, (R, 3)).astype(np.float32)
    var = rng.uniform(0.001, 0.05, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3))
    dirs = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    cot = rng.normal(size=(R, 4)).astype(np.float32)

    def xla_loss(m, v, q):
        return jnp.sum(jnerf.nerf_apply_mip(params, m, v, q, jm) * cot)

    ref = jax.grad(xla_loss, argnums=(0, 1, 2))(jnp.asarray(mean), jnp.asarray(var), jnp.asarray(dirs))
    field = NerfField.from_jax_params(jax.tree.map(np.asarray, params), "cpu", model)
    m, v, q = (_t(a).requires_grad_(True) for a in (mean, var, dirs))
    x = torch.cat([m.T, q.T, torch.zeros((5, R)), v.T, torch.zeros((2, R))])
    before = (mlp.fused_mlp_backward.launches, mlp.fused_mlp_backward.mip_dx_launches)
    out = mlp.fused_mlp(mlp.pack_weights(field, differentiable=True), x, torch.float32, model, mip=True)
    (out[:4].T * _t(cot)).sum().backward()
    for name, r, t in zip(("mean", "var", "dir"), ref, (m, v, q)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), atol=2e-4, rtol=2e-3, err_msg=f"d/d({name})")
    assert (mlp.fused_mlp_backward.launches, mlp.fused_mlp_backward.mip_dx_launches) == before


# --- one and two train steps against JAX's -----------------------------------------------------------------

def _scene_rays(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N_RAYS, 6)).astype(np.float32),
            rng.uniform(0, 1, (N_RAYS, 3)).astype(np.float32))


def _tiny(**kw) -> dict:
    """JAX's _tiny_cfg (tests/test_pose_app.py:150), one step a call, f32."""
    return dict(datapath="x", Nf=4, num_iters=4, batch_size=BATCH, steps_per_call=1, net_H=32, net_Lp=4,
                net_Ld=2, pose_warmup=0, compute_dtype="f32", pose_opt=True, **kw)


@functools.lru_cache(maxsize=None)
def _jax_steps(kind: str, n_steps: int = 2):
    """The JAX step (``backend: xla``) ``n_steps`` times from its own state,
    and each step's draws as the JAX step makes them: (params of the first
    state, losses, the final cams, draws); ``kind`` is "mip1", "mip2" or
    "proposal"."""
    kw = (dict(mip=True, mip_levels=int(kind[-1])) if kind.startswith("mip") else
          dict(proposal=True, Np=4, prop_Lp=4, prop_D=2, prop_H=16, pe_anneal_until=4))
    cfg = jconfig.TrainConfig(**_tiny(backend="xla", **kw))
    model = model_from_train_config(cfg)
    state = jstep.make_train_state(jax.random.PRNGKey(0), cfg, model, n_images=N_IMAGES)
    step = jstep.build_train_step(cfg, model, donate=False, rays_per_image=RAYS_PER_IMAGE,
                                  base_radius=BASE_RADIUS if cfg.mip else 0.0)
    rays_np, pix_np = _scene_rays()
    rays, pix = jnp.asarray(rays_np), jnp.asarray(pix_np)
    key = jax.random.PRNGKey(3)
    p0 = jax.tree.map(np.asarray, state.params)
    losses, draws = [], []
    js = jrenderer.RenderSettings(N=cfg.Nf, N_prop=cfg.Np if cfg.proposal else 0, mip=cfg.mip,
                                  mip_levels=cfg.mip_levels, base_radius=BASE_RADIUS if cfg.mip else 0.0,
                                  resample_blur=cfg.resample_blur, tn=cfg.tn, tf=cfg.tf, compute_dtype=jnp.float32)
    for i in range(n_steps):
        k_sel, k_render = jax.random.split(jax.random.fold_in(key, i))
        idx = jax.random.randint(k_sel, (BATCH,), 0, N_RAYS)
        im_b = idx // RAYS_PER_IMAGE
        cams, field = state.params["cams"], state.params["field"]
        r = jrays.apply_cam_deltas(rays[idx], cams["dr"][im_b], cams["dt"][im_b])
        d = {"idx": np.asarray(idx)}
        if cfg.mip:
            d["edges"] = np.asarray(jsampling.stratified_ts_spaced(k_render, BATCH, cfg.Nf + 1, cfg.tn, cfg.tf))
            if cfg.mip_levels == 2:
                out_c, _ = jrenderer._render_mip(field, r, k_render, js, model, return_coarse=True)
                d["edges_fine"] = np.asarray(jsampling.resample_edges(
                    jax.random.fold_in(k_render, 2), jnp.asarray(d["edges"]), out_c.weights, cfg.Nf,
                    blur=cfg.resample_blur))
        else:
            k_strat, k_imp = jax.random.split(k_render)
            ts_p = jsampling.stratified_ts_spaced(k_strat, BATCH, cfg.Np, cfg.tn, cfg.tf)
            w = jproposal.proposal_weights(field["prop"], r, ts_p, jproposal.proposal_from_train_config(cfg),
                                           jnp.float32)
            d["ts"], d["ts_fine"] = np.asarray(ts_p), np.asarray(jsampling.importance_ts(k_imp, ts_p, w, cfg.Nf))
        draws.append(d)
        state, loss = step(state, rays, pix, key)
        losses.append(float(np.asarray(loss).reshape(-1)[0]))
    return p0, losses, jax.tree.map(np.asarray, state.params["cams"]), draws


def _port_steps(monkeypatch, kind: str, backend: str, n_steps: int = 2):
    """The port's step (build_train_step, the autograd path) ``n_steps``
    times from the JAX state's params, handed the JAX step's draws:
    (losses, cams tables, the mip and proposal launches of the fused core)."""
    p0, _, _, draws = _jax_steps(kind, n_steps)
    kw = (dict(mip=True, mip_levels=int(kind[-1])) if kind.startswith("mip") else
          dict(proposal=True, Np=4, prop_Lp=4, prop_D=2, prop_H=16, pe_anneal_until=4))
    cfg = config.TrainConfig(**_tiny(backend=backend, **kw))
    if cfg.proposal:
        field = ProposalPair.from_jax_params(p0["field"], "cpu", SMALL, ProposalMLP(Lp=4, D=2, H=16))
    else:
        field = NerfField.from_jax_params(p0["field"], "cpu", SMALL)
    cams = tstep.CamDeltas(N_IMAGES).copy_tables_(p0["cams"])
    gen = torch.Generator()
    state = tstep.TrainState(field, tstep.make_optimizer(cfg, field.parameters(), cams), gen, cams=cams)
    queue, cur = list(draws), {}

    def randint(*a, **k):  # step_fn's first draw, the batch: the step's other draws follow it
        cur.clear()
        cur.update(queue.pop(0))
        return _t(cur["idx"]).long()

    monkeypatch.setattr(torch, "randint", randint)
    monkeypatch.setattr(tstep, "stratified_ts_spaced", lambda *a, **k: _t(cur["edges"] if cfg.mip else cur["ts"]))
    monkeypatch.setattr(renderer, "resample_edges", lambda *a, **k: _t(cur["edges_fine"]))
    monkeypatch.setattr(renderer, "importance_ts", lambda *a, **k: _t(cur["ts_fine"]))
    fused = []
    for name in ("mip_fused_loss", "proposal_fused_loss", "fused_loss"):
        monkeypatch.setattr(tstep, name, lambda *a, _n=name, **k: fused.append(_n))
    step_fn = tstep.build_train_step(cfg, SMALL, rays_per_image=RAYS_PER_IMAGE,
                                     base_radius=BASE_RADIUS if cfg.mip else 0.0)
    rays_np, pix_np = _scene_rays()
    losses = []
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # pose's path is autograd through fused_mlp: no fallback warning
        for _ in range(n_steps):
            losses.append(step_fn(state, _t(rays_np), _t(pix_np)).item())
    return losses, cams.tables(), fused, cfg


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("levels", [1, 2], ids=["mip1", "mip2"])
def test_pose_mip_steps_match_jax_xla_step(monkeypatch, levels, backend):
    """Two f32 steps of the port with pose_opt + mip at ``mip_levels``
    1 and 2 (under "pallas" through ``fused_mlp`` with B2's mip input
    gradient, its plain version on CPU; under "xla" through
    ``nerf_apply_mip``) against two of the JAX ``build_train_step`` with
    ``backend: xla`` on the same rays, draws and initial params: the losses
    and the refined camera tables; no fused core runs (pose's path is
    autograd) and the deltas moved."""
    _, jlosses, jcams, _ = _jax_steps(f"mip{levels}")
    mlp.fused_mlp_backward.mip_dx_launches = 0
    losses, cams, fused, cfg = _port_steps(monkeypatch, f"mip{levels}", backend)
    assert tstep.kernel_refusal(cfg).startswith("pose_opt") and fused == []
    np.testing.assert_allclose(losses, jlosses, rtol=2e-5)
    assert np.abs(jcams["dr"]).max() > 0 and np.abs(cams["dt"]).max() > 0
    for k in ("dr", "dt"):
        np.testing.assert_allclose(cams[k], jcams[k], atol=1e-5, err_msg=k)
    assert mlp.fused_mlp_backward.mip_dx_launches == 0  # CPU: the plain versions, no launch


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_pose_proposal_steps_match_jax_xla_step(monkeypatch, backend):
    """Two f32 steps of the port with pose_opt + proposal (point form) and
    ``pe_anneal_until: 4`` (the anneal at 0 and 0.25: the main field's
    encoder only) against two of the JAX step with ``backend: xla`` on the
    same rays, probes, importance samples and initial params: the losses
    (MSE + the interlevel loss) and the refined camera tables."""
    _, jlosses, jcams, _ = _jax_steps("proposal")
    losses, cams, fused, cfg = _port_steps(monkeypatch, "proposal", backend)
    assert tstep.kernel_refusal(cfg).startswith("pose_opt") and fused == []
    assert tstep.anneal_alpha(cfg, 1) == 0.25
    np.testing.assert_allclose(losses, jlosses, rtol=2e-5)
    assert np.abs(jcams["dr"]).max() > 0
    for k in ("dr", "dt"):
        np.testing.assert_allclose(cams[k], jcams[k], atol=1e-5, err_msg=k)


# --- the proposal render with enc_alpha ---------------------------------------------------------------------

@pytest.mark.parametrize("alpha", [0.0, 0.4], ids=["a0", "a0.4"])
def test_proposal_render_with_enc_alpha_matches_jax(alpha):
    """``render_rays_proposal(enc_alpha=...)`` at the same probes with the
    deterministic quantiles against JAX's (the anneal on the main field
    only, JAX render/renderer.py:665-670), and the chunked render: chunk 0
    equals the direct render at that alpha, differs from the full encoder,
    and a mip render refuses the windows."""
    prop_model = ProposalMLP(Lp=4, D=2, H=16)
    params = jax.tree.map(np.asarray, jstep.make_train_state(
        jax.random.PRNGKey(5), jconfig.TrainConfig(**_tiny(proposal=True, Np=8, prop_Lp=4, prop_D=2, prop_H=16)),
        jnerf.NerfMLP(4, 2, 32), n_images=1).params["field"])
    rays_np, _ = _scene_rays(6)
    ts = np.sort(np.random.default_rng(7).uniform(2, 6, (N_RAYS, 8)), -1).astype(np.float32)
    js = jrenderer.RenderSettings(N=8, N_prop=8, tn=2.0, tf=6.0)
    want = jrenderer.render_rays_proposal(_jtree(params), jnp.asarray(rays_np), jax.random.PRNGKey(0), js,
                                          jnerf.NerfMLP(4, 2, 32), jproposal.ProposalMLP(Lp=4, D=2, H=16),
                                          det_fine=True, ts_prop=jnp.asarray(ts), enc_alpha=jnp.float32(alpha))
    pair = ProposalPair.from_jax_params(params, "cpu", SMALL, prop_model)
    s = RenderSettings(N=8, N_prop=8, backend="pallas")
    with torch.no_grad():
        got = renderer.render_rays_proposal(pair, _t(rays_np), None, s, det_fine=True, ts_prop=_t(ts),
                                            enc_alpha=alpha)
    np.testing.assert_allclose(got.rgb.numpy(), np.asarray(want.rgb), atol=1e-5)
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights), atol=1e-5)
    rgb, _ = renderer.render_rays_chunked(pair, _t(rays_np), 3, s, chunk=16, enc_alpha=alpha)
    with torch.no_grad():
        direct = renderer.render_rays_proposal(pair, _t(rays_np[:16]), renderer.chunk_generator(3, 0, "cpu"), s,
                                               det_fine=True, enc_alpha=alpha)
    np.testing.assert_allclose(rgb[:16].numpy(), torch.clamp(direct.rgb, 0, 1).numpy(), atol=1e-6)
    assert not np.allclose(rgb.numpy(), renderer.render_rays_chunked(pair, _t(rays_np), 3, s, chunk=16)[0].numpy(),
                           atol=1e-4)
    field = NerfField.from_jax_params(params["fine"], "cpu", SMALL)
    with pytest.raises(ValueError, match="not with mip"):
        renderer.render_rays_chunked(field, _t(rays_np), 3, RenderSettings(N=4, mip=True, base_radius=0.01),
                                     enc_alpha=0.4)


# --- the config rules --------------------------------------------------------------------------------------

def test_pose_with_mip_and_proposal_configs_load_and_the_rules_raise():
    """lego_mip.yaml (``mip_levels`` 2 and 1) and lego_proposal.yaml with
    pose_opt load in both packages; JAX's rules raise in both: pose + mip +
    ``pe_anneal_until`` and mip + ``appearance_dim`` (ValueError); the port
    still refuses pose + mip + proposal (mip x proposal, Queue A item 2)
    and pose + ``contract`` (the input gradient's contraction, Queue B item
    3), which JAX composes."""
    pose = dict(pose_opt=True, pose_warmup=10, pose_freeze_at=100)
    for path, extra in (("configs/lego_mip.yaml", {}), ("configs/lego_mip.yaml", {"mip_levels": 1}),
                        ("configs/lego_proposal.yaml", {"pe_anneal_until": 40})):
        d = {**config.load_yaml(path), **pose, **extra}
        cfg = config.train_config_from_dict(d)
        assert cfg.pose_opt and cfg.pose_freeze_at == 100 and (cfg.mip or cfg.proposal)
        jconfig.TrainConfig(**{k: v for k, v in d.items() if k != "test_params"})
    for kw, match in ((dict(pose_opt=True, mip=True, pe_anneal_until=50), "mip"),
                      (dict(pose_opt=True, mip=True, appearance_dim=4), "mip")):
        with pytest.raises(ValueError, match=match):
            config.TrainConfig(datapath="d", **kw)
        with pytest.raises(ValueError):
            jconfig.TrainConfig(datapath="d", **kw)
    jconfig.TrainConfig(datapath="d", pose_opt=True, mip=True, proposal=True, Np=8)  # JAX composes it
    with pytest.raises(NotImplementedError, match="Queue A item 2"):
        config.TrainConfig(datapath="d", pose_opt=True, mip=True, proposal=True, Np=8)
    with pytest.raises(NotImplementedError, match="Queue B item 3"):
        config.train_config_from_dict({"datapath": "d", "pose_opt": True, "contract": True})
    for levels in (1, 2):
        cfg = config.TrainConfig(datapath="d", pose_opt=True, mip=True, mip_levels=levels)
        assert tstep.kernel_refusal(cfg).startswith("pose_opt")
        assert tstep.kernel_refusal(config.TrainConfig(datapath="d", mip=True, mip_levels=levels)) is None
    with pytest.raises(ValueError, match="windows"):  # the kernels take no windows under mip either
        mlp.fused_mlp_forward(mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(0, SMALL), "cpu")),
                              torch.zeros((16, 8)), torch.float32, SMALL, mip=True,
                              enc_w=mlp.anneal_row_weights(SMALL, 0.5))


# --- train() through a freeze and eval ---------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["mip", "proposal"])
def test_train_pose_through_a_freeze_resume_and_refined_stills(tmp_path, capsys, monkeypatch, kind):
    """train() on CPU (pallas, the plain kernels) with pose_opt and a freeze
    at 7 (aligned up to 10 by steps_per_call 5), for a two-level mip run and
    a proposal run (the anneal to 6, a mid-anneal preview at 5): the steps
    before the freeze take the autograd path, those after it the fused mip
    (proposal) core; the sidecar holds the deltas, the checkpoint before it
    ``{field, cams}``, the later ones are plain; a resume past the freeze
    re-bakes the sidecar; ``evaluate.test`` renders the train stills from
    the refined rig (mip: cones at mip_levels 2; proposal: Np probes)."""
    from nerf_simple_tpu_torch.evaluate import test
    from nerf_simple_tpu_torch.train import loop
    from nerf_simple_tpu_torch.utils.png import decode_png

    scene = str(tmp_path / "scene")
    synthetic.write_blender_scene(scene, 3, 1, 1, H=8, W=8, train_jitter=3)
    extra = (dict(mip=True, mip_levels=2) if kind == "mip" else
             dict(proposal=True, Np=8, prop_Lp=4, prop_D=2, prop_H=16, pe_anneal_until=6))
    cfg = dict(datapath=scene, savepath=str(tmp_path / "m"), exp_name="p", Nf=8, batch_size=32, net_H=32,
               net_Lp=4, net_Ld=2, half_res=False, backend="pallas", num_iters=15, steps_per_call=5,
               ckpt_loss=5, ckpt_images=5, ckpt_model=5, log_dir=str(tmp_path / "logs"), val_idxs=[0],
               pose_opt=True, pose_warmup=2, pose_freeze_at=7, pose_lr_init=1e-2, **extra)
    calls = []
    for name in ("autograd_loss", "mip_fused_loss", "proposal_fused_loss"):
        real = getattr(tstep, name)
        monkeypatch.setattr(tstep, name, lambda *a, _r=real, _n=name, **k: calls.append(_n) or _r(*a, **k))
    alphas = []
    real_chunked = loop.render_rays_chunked
    monkeypatch.setattr(loop, "render_rays_chunked",
                        lambda *a, **k: alphas.append(k.get("enc_alpha")) or real_chunked(*a, **k))
    state = loop.train(cfg, device="cpu")
    out = capsys.readouterr().out
    exp = tmp_path / "m" / "p"
    fused = "mip_fused_loss" if kind == "mip" else "proposal_fused_loss"
    assert calls == ["autograd_loss"] * 10 + [fused] * 5
    assert "pose freeze at step 10" in out and state.cams is None and state.step == 15
    if kind == "proposal":
        assert 5 / 6 in alphas  # the preview at step 5 renders mid-anneal, through the proposal scheme
    with np.load(exp / "cam_deltas.npz") as side:
        dr, dt = side["dr"], side["dt"]
    assert dr.shape == (3, 3) and np.abs(dr).max() > 0 and np.abs(dt).max() > 0
    assert "field" in ckpt.checkpoint_params(str(exp / "ckpt_10.pth"))
    assert "cams" not in ckpt.checkpoint_params(str(exp / "ckpt_15.pth"))
    bakes = []
    monkeypatch.setattr(loop, "bake_cam_deltas", lambda *a: bakes.append(a[1].cpu().numpy()) or
                        trays.bake_cam_deltas(*a))
    loop.train({**cfg, "num_iters": 20, "resume": True}, device="cpu")
    assert "resumed from" in capsys.readouterr().out and len(bakes) == 1
    np.testing.assert_array_equal(bakes[0], dr)

    ev = dict(loadpath=str(exp), datapath=scene, half_res=False, N_samples=8, batch_size=256, im_idxs=[0],
              im_set="train", savepath=str(tmp_path / "r"),
              **(dict(mip=True, mip_levels=2) if kind == "mip" else dict(Np=8)))
    test(ev, device="cpu")
    from nerf_simple_tpu_torch.data.blender import load_blender
    from nerf_simple_tpu_torch.data.dataset import RayDataset
    from nerf_simple_tpu_torch.evaluate import load_params

    params = load_params(str(exp), keep_hierarchy=kind == "proposal")
    field = (ProposalPair.from_jax_params(params, "cpu", SMALL, ProposalMLP(Lp=4, D=2, H=16)) if kind == "proposal"
             else NerfField.from_jax_params(params, "cpu", SMALL))
    rd = RayDataset.from_blender(load_blender(scene, False), "cpu")
    baked = trays.bake_cam_deltas(rd.rays["train"], _t(dr), _t(dt), 64)
    s = (RenderSettings(N=8, mip=True, mip_levels=2, base_radius=2.0 / 12.0**0.5 / rd.f) if kind == "mip"
         else RenderSettings(N=8, N_prop=8))
    from nerf_simple_tpu_torch.render.renderer import derive_seed, render_image

    refined = render_image(field, baked, 8, 8, 0, derive_seed(0, 0), s, 256)[0][0]
    got = decode_png(open(tmp_path / "r" / "exp" / "rgb_0.png", "rb").read())[:, 8:]
    assert np.abs(got.astype(int) - (refined * 255).astype(np.uint8).astype(int)).max() <= 1
    unrefined = render_image(field, rd.rays["train"], 8, 8, 0, derive_seed(0, 0), s, 256)[0][0]
    assert np.abs(refined - unrefined).max() > 1e-4  # the deltas moved the render
