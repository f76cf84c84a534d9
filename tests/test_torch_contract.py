"""The port's scene contraction (mip-NeRF 360's ``contract``) on CPU against
the JAX package, mirroring tests/test_contract.py: ``scene_contraction``
and ``contract_gaussian`` (its properties, JAX's values, JAX's Monte Carlo
check); ``nerf_apply`` and ``nerf_apply_mip`` of a contracted model inside
and outside the unit ball; the plain versions of the forward, B2 and B1
with a contracted model (what the wrappers run on CPU tensors) against
JAX's kernels in interpret mode; two train steps each of the single net,
the hierarchical pair, the 360 recipe (proposal sampling, disparity
spacing, the distortion rail) and mip + contract at one and two levels
against the JAX ``build_train_step`` (``backend: xla``) from the same
weights and draws; the ``model.json`` sidecar, and eval and the server
rebuilding a contracted main model and proposal net; the ``unbounded``
synthetic style and ``orbit_cameras(r_range=)``; ``train()`` of the 360
recipe on a 20x20 unbounded scene, evaluated by both packages; the config
rules; the weights crossing between the packages unchanged; the normals'
density gradient through the contraction.

A port step is handed the JAX step's draws (the batch indices, the
stratified samples or edges, the importance samples or fine edges), which
the test computes with the JAX package from the keys the JAX step splits,
so no sample moves between the two and no bin-flip rule is needed.

Tolerances:

- ``scene_contraction`` and ``contract_gaussian`` against JAX: 1e-6 (the
  same f32 operations; JAX's own property bounds otherwise); the Monte
  Carlo check: JAX's (mean atol 5e-3, variance rtol 0.15 + atol 2e-5).
- ``nerf_apply`` against JAX: atol 1e-5 (tests/test_torch_model.py's).
- The plain kernels against JAX's interpret-mode kernels: the forward
  atol 1e-5 in f32, 2e-3 in bf16 (tests/test_torch_mip.py's); the
  gradients atol 1e-5 + rtol 2e-3 in f32; B1's loss rtol 2e-4 (JAX's,
  tests/test_contract.py:69, :303).
- A train step against JAX's: the losses rtol 2e-4 (the fused core
  against JAX's autodiff path: JAX's pallas-vs-xla bound, as above).
- The unbounded field against JAX's: rtol 2e-5 + atol 1e-5 (the two
  norms differ by an ulp at the shell's radius 20, where sigma's sigmoid
  has slope 60 a unit).
- The normals' density gradient against ``jax.grad``: atol 1e-5 + rtol
  1e-4 (f32 autograd of the same layers in another order).
- Eval of one trained checkpoint by both packages: PSNR to 0.01 dB,
  SSIM to 1e-3 (tests/test_torch_proposal.py's).
"""

from __future__ import annotations

import dataclasses
import functools
import os
import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import nerf_simple_tpu.config as jconfig
import nerf_simple_tpu.data.synthetic as jsynthetic
import nerf_simple_tpu.kernels.mlp as jmlp
import nerf_simple_tpu.models.nerf as jnerf
import nerf_simple_tpu.models.proposal as jproposal
import nerf_simple_tpu.ops.encoding as jencoding
import nerf_simple_tpu.ops.sampling as jsampling
import nerf_simple_tpu.render.renderer as jrenderer
import nerf_simple_tpu.train.step as jstep
from nerf_simple_tpu.models import model_from_train_config as jmodel_from_train_config
from nerf_simple_tpu_torch import config
from nerf_simple_tpu_torch.data import synthetic
from nerf_simple_tpu_torch.kernels import mlp
from nerf_simple_tpu_torch.models import model_from_meta, model_from_train_config
from nerf_simple_tpu_torch.models.nerf import NerfField, NerfMLP, NerfPair, init_nerf_params, nerf_apply, nerf_apply_mip
from nerf_simple_tpu_torch.models.proposal import ProposalMLP, ProposalPair
from nerf_simple_tpu_torch.ops import encoding
from nerf_simple_tpu_torch.train import checkpoint as ckpt
from nerf_simple_tpu_torch.train import step as tstep

WIDE = NerfMLP(Lp=6, Ld=2, H=32)  # JAX's test width (tests/test_contract.py:59)
CWIDE = NerfMLP(Lp=6, Ld=2, H=32, contract=True)
TN, TF = 0.5, 30.0  # the unbounded scene's bounds (JAX scripts/unbounded_bench.py:70-116)
RADIUS = 0.02
N_RAYS, BATCH = 64, 32


def _t(a):
    return torch.from_numpy(np.array(a))


def _jtree(params):
    if isinstance(params, dict):
        return {k: _jtree(v) for k, v in params.items()}
    return jnp.asarray(params)


def _jm(model):
    return jnerf.NerfMLP(model.Lp, model.Ld, model.H, contract=model.contract)


def _rays(n, seed):
    """Rays from cameras at r = 3..6 towards the origin (the unbounded
    scene's rig): samples on [TN, TF] lie inside the unit ball and far
    out; their gt colours."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = -rng.uniform(3.0, 6.0, (n, 1)) * d + rng.normal(0, 0.3, (n, 3))
    return (np.concatenate([o, d], 1).astype(np.float32), rng.uniform(0, 1, (n, 3)).astype(np.float32))


def _points(n, seed):
    """(3, n) positions, a third inside the unit ball, a third in (1, 3],
    the rest at 25..35, and unit dirs; f32 numpy."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(3, n))
    u /= np.linalg.norm(u, axis=0, keepdims=True)
    r = rng.permutation(np.concatenate([rng.uniform(0.0, 0.999, n - 2 * (n // 3)), rng.uniform(1.001, 3.0, n // 3),
                                        rng.uniform(25.0, 35.0, n // 3)]))
    d = rng.normal(size=(3, n))
    return (u * r).astype(np.float32), (d / np.linalg.norm(d, axis=0, keepdims=True)).astype(np.float32), r <= 1.0


def _x(n, seed, mip=False):
    """The kernels' input: (8, n), or (16, n) with variances log-uniform in
    [1e-6, 1e-1] in rows 11..13 under mip."""
    xyz, dirs, inside = _points(n, seed)
    x = np.zeros((16 if mip else 8, n), np.float32)
    x[:3], x[3:6] = xyz, dirs
    if mip:
        x[11:14] = 10.0 ** np.random.default_rng(seed + 1).uniform(-6, -1, (3, n))
    return x, inside


# --- the contraction -------------------------------------------------------------------------------

def test_scene_contraction_properties_and_matches_jax():
    """JAX's properties (tests/test_contract.py:19): the identity inside
    the unit ball, strictly inside radius 2, radially monotone, directions
    kept, the unit sphere fixed, a far point near radius 2; and JAX's
    values."""
    x = np.random.default_rng(0).normal(0, 5, (512, 3)).astype(np.float32)
    y = encoding.scene_contraction(_t(x)).numpy()
    np.testing.assert_allclose(y, np.asarray(jencoding.scene_contraction(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    n_in, n_out = np.linalg.norm(x, axis=-1), np.linalg.norm(y, axis=-1)
    inside = n_in <= 1.0
    assert inside.any() and (~inside).any()
    np.testing.assert_array_equal(y[inside], x[inside])
    assert (n_out < 2.0).all()
    order = np.argsort(n_in)
    assert (np.diff(n_out[order]) > -1e-6).all()
    np.testing.assert_allclose(y / np.maximum(n_out, 1e-10)[:, None], x / n_in[:, None], atol=1e-5)
    unit = (x[:8] / n_in[:8, None]).astype(np.float32)
    np.testing.assert_allclose(encoding.scene_contraction(_t(unit)).numpy(), unit, atol=1e-6)
    far = encoding.scene_contraction(torch.tensor([[1e6, 0.0, 0.0]]))
    assert abs(far[0, 0].item() - 2.0) <= 1e-4
    # the kernels' form (mlp._contract: the squares summed in order, floored at 1e-20) agrees
    np.testing.assert_allclose(mlp._contract(_t(x.T.copy()), None)[0].numpy().T, y, rtol=1e-6, atol=1e-6)


def test_contract_gaussian_matches_jax_and_monte_carlo():
    """``contract_gaussian`` against JAX's, and JAX's Monte Carlo check
    (tests/test_contract.py:273): the linearised warp against the
    contracted mean and variance of 300,000 samples; inside the ball the
    identity; the kernels' form (``mlp._contract`` with variances) the
    same warp."""
    means = np.array([[3.0, -1.0, 2.0], [0.2, 0.1, -0.3], [0.0, 5.0, 0.0]], np.float32)
    varis = np.array([[0.02, 0.01, 0.015], [0.001, 0.002, 0.001], [0.01, 0.03, 0.02]], np.float32)
    m_out, v_out = (a.numpy() for a in encoding.contract_gaussian(_t(means), _t(varis)))
    jm, jv = jencoding.contract_gaussian(jnp.asarray(means), jnp.asarray(varis))
    np.testing.assert_allclose(m_out, np.asarray(jm), rtol=1e-6)
    np.testing.assert_allclose(v_out, np.asarray(jv), rtol=1e-6)
    km, kv = mlp._contract(_t(means.T.copy()), _t(varis.T.copy()))
    np.testing.assert_allclose(km.numpy().T, m_out, rtol=1e-6)
    np.testing.assert_allclose(kv.numpy().T, v_out, rtol=1e-5)
    rng = np.random.default_rng(1)
    for i in range(3):
        pts = means[i] + rng.normal(size=(300_000, 3)) * np.sqrt(varis[i])
        con = encoding.scene_contraction(_t(pts.astype(np.float32))).numpy().astype(np.float64)
        np.testing.assert_allclose(m_out[i], con.mean(0), atol=5e-3)
        np.testing.assert_allclose(v_out[i], con.var(0), rtol=0.15, atol=2e-5)
    np.testing.assert_array_equal(m_out[1], means[1])
    np.testing.assert_array_equal(v_out[1], varis[1])


@pytest.mark.parametrize("mip", [False, True], ids=["point", "mip"])
def test_nerf_apply_contract_matches_jax_inside_and_outside(mip):
    """``nerf_apply`` (and under mip ``nerf_apply_mip``) of a contracted
    model against JAX's; the same as the model without contract to the bit
    inside the unit ball, and not outside it (tests/test_contract.py:136)."""
    params = init_nerf_params(0, WIDE)
    x, inside = _x(240, 2, mip)
    field, cfield = NerfField.from_jax_params(params, "cpu"), NerfField.from_jax_params(params, "cpu", CWIDE)
    assert cfield.model.contract
    with torch.no_grad():
        if mip:
            args = [_t(x[r].T) for r in (slice(0, 3), slice(11, 14), slice(3, 6))]
            got, plain = nerf_apply_mip(cfield, *args).numpy(), nerf_apply_mip(field, *args).numpy()
            want = np.asarray(jnerf.nerf_apply_mip(_jtree(params), *(jnp.asarray(a.numpy()) for a in args),
                                                   _jm(CWIDE)))
        else:
            got, plain = nerf_apply(cfield, _t(x[:6].T)).numpy(), nerf_apply(field, _t(x[:6].T)).numpy()
            want = np.asarray(jnerf.nerf_apply(_jtree(params), jnp.asarray(x[:6].T), _jm(CWIDE)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(got[inside], plain[inside])
    assert np.abs(got[~inside] - plain[~inside]).max() > 1e-4


# --- the plain versions of the kernels against JAX's kernels in interpret mode ------------------------

@pytest.mark.parametrize("dt, jdt", [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)], ids=["f32", "bf16"])
@pytest.mark.parametrize("mip", [False, True], ids=["point", "mip"])
def test_plain_forward_contract_matches_jax_kernel(mip, dt, jdt):
    """The forward of a contracted model (its plain version, which the
    wrapper runs on a CPU tensor) against JAX's interpret-mode kernel
    (``_encode``'s contraction, kernels/mlp.py:437-456); no launch counted;
    in f32 also against ``nerf_apply``."""
    params = init_nerf_params(3, WIDE)
    x, _ = _x(128, 4, mip)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jmlp.fused_mlp_forward(jmlp.pack_weights(_jtree(params), model=_jm(CWIDE)),
                                                 jnp.asarray(x), 128, jdt, _jm(CWIDE), mip))
    field = NerfField.from_jax_params(params, "cpu", CWIDE)
    before = (mlp.fused_mlp_forward.launches, mlp.fused_mlp_forward.contract_launches)
    got = mlp.fused_mlp_forward(mlp.pack_weights(field), _t(x), dt, CWIDE, mip=mip).numpy()
    assert (mlp.fused_mlp_forward.launches, mlp.fused_mlp_forward.contract_launches) == before  # CPU: plain
    np.testing.assert_allclose(got[:4], want[:4], atol=1e-5 if dt == torch.float32 else 2e-3)
    assert (got[4:] == 0).all()
    if dt == torch.float32 and not mip:
        with torch.no_grad():
            np.testing.assert_allclose(got[:4].T, nerf_apply(field, _t(x[:6].T)).numpy(), atol=1e-5)


def _grads(field):
    return {name: {"w": getattr(field, name).weight.grad.numpy().T, "b": getattr(field, name).bias.grad.numpy()}
            for name in field.model.layer_dims()}


def _assert_grads(got, want):
    for layer in want:
        for k in ("w", "b"):
            np.testing.assert_allclose(got[layer][k], np.asarray(want[layer][k]), atol=1e-5, rtol=2e-3,
                                       err_msg=f"{layer}/{k}")


@pytest.mark.parametrize("mip", [False, True], ids=["point", "mip"])
def test_plain_backward_contract_matches_jax_kernel(mip):
    """B2 recomputing a contracted model's forward: ``fused_mlp``'s backward
    (its plain version) through the pack against JAX's ``_fused_mlp_bwd``
    in interpret mode through ``jax.vjp(pack_weights)``, f32; the input's
    gradient is B2's ``want_dx`` (point; tests/test_torch_pose_contract.py
    holds it to JAX; under mip tests/test_torch_mip360.py), the same as
    ``fused_mlp_backward(want_dx=True)``'s."""
    params = init_nerf_params(5, WIDE)
    x, _ = _x(128, 6, mip)
    g = np.zeros((8, 128), np.float32)
    g[:4] = np.random.default_rng(7).normal(size=(4, 128)) * 0.1
    with pltpu.force_tpu_interpret_mode():
        wts, vjp = jax.vjp(lambda p: jmlp.pack_weights(p, model=_jm(CWIDE)), _jtree(params))
        want = vjp(jmlp._fused_mlp_bwd(wts, jnp.asarray(x), jnp.asarray(g), 128, jnp.float32, _jm(CWIDE), mip))[0]
    field = NerfField.from_jax_params(params, "cpu", CWIDE)
    mlp.fused_mlp(mlp.pack_weights(field, differentiable=True), _t(x), torch.float32, CWIDE, mip=mip).backward(_t(g))
    _assert_grads(_grads(field), want)
    xT = _t(x).requires_grad_(True)
    mlp.fused_mlp(mlp.pack_weights(field), xT, torch.float32, CWIDE, mip=mip).backward(_t(g))
    _, dx = mlp.fused_mlp_backward(mlp.pack_weights(field), _t(x), _t(g), torch.float32, CWIDE, mip=mip,
                                   want_dx=True)
    assert torch.equal(xT.grad, dx) and bool(torch.isfinite(dx).all())


B1_CASES = {"point-weights-rail-disparity": dict(out_weights=True, dist=(0.01, TN, TF, True)),
            "mip-weights-opaque": dict(mip=True, out_weights=True, opaque_tail=True)}


@pytest.mark.parametrize("case", list(B1_CASES))
def test_plain_train_step_contract_matches_jax_kernel(case):
    """B1 of a contracted model (its plain version) against JAX's
    interpret-mode ``fused_train_step``: the 360 recipe's point launch
    (the weights output, the disparity-space rail) and a cone-cast one
    (the weights output, the opaque tail), f32: the loss to JAX's rtol
    2e-4, every gradient, the weights."""
    from nerf_simple_tpu_torch.train.step import build_x16, build_x16_mip

    kw = B1_CASES[case]
    mip = kw.get("mip", False)
    B, N = 8, 16
    params = init_nerf_params(8, WIDE)
    rays, pix = _rays(B, 9)
    ts = np.sort(1.0 / np.random.default_rng(10).uniform(1 / TF, 1 / TN, (B, N + mip)), -1).astype(np.float32)
    x = (build_x16_mip(_t(rays), _t(ts), _t(pix), RADIUS) if mip else build_x16(_t(rays), _t(ts), _t(pix))).numpy()
    with pltpu.force_tpu_interpret_mode():
        wts, vjp = jax.vjp(lambda p: jmlp.pack_weights(p, model=_jm(CWIDE)), _jtree(params))
        jout = jmlp.fused_train_step(wts, jnp.asarray(x), N, B * N, jnp.float32, model=_jm(CWIDE), **kw)
        want = vjp(jout[1])[0]
    field = NerfField.from_jax_params(params, "cpu", CWIDE)
    packed = mlp.pack_weights(field, differentiable=True)
    before = mlp.fused_train_step.contract_launches
    out = mlp.fused_train_step(packed, _t(x), N, torch.float32, CWIDE, **kw)
    assert mlp.fused_train_step.contract_launches == before  # CPU: plain
    torch.autograd.backward(list(packed), list(out[1]))
    np.testing.assert_allclose(float(out[0]), float(jout[0]), rtol=2e-4)
    _assert_grads(_grads(field), want)
    np.testing.assert_allclose(out[2].numpy(), np.asarray(jout[2]), atol=1e-5)


# --- two train steps against JAX's -----------------------------------------------------------------------

KINDS = {
    "single": dict(Nf=16),
    "hierarchical": dict(Nf=8, Nc=8, hierarchical=True),
    "360": dict(Nf=8, proposal=True, Np=8, prop_Lp=4, prop_D=2, prop_H=16, distortion_loss_weight=0.01),
    "mip1": dict(Nf=8, mip=True),
    "mip2": dict(Nf=8, mip=True, mip_levels=2),
}


def _cfg_kw(kind: str) -> dict:
    """JAX's contract step config (tests/test_contract.py:59), f32, one
    step a call, disparity spacing on the unbounded scene's bounds."""
    return dict(datapath="x", contract=True, sampling_space="disparity", tn=TN, tf=TF, batch_size=BATCH,
                steps_per_call=1, num_iters=4, net_Lp=6, net_Ld=2, net_H=32, compute_dtype="f32", **KINDS[kind])


@functools.lru_cache(maxsize=None)
def _jax_steps(kind: str, n_steps: int = 2):
    """The JAX step (``backend: xla``) ``n_steps`` times from its own
    state, and each step's draws as the JAX step makes them: (params of
    the first state, losses, draws)."""
    cfg = jconfig.TrainConfig(backend="xla", **_cfg_kw(kind))
    model = jmodel_from_train_config(cfg)
    assert model.contract
    state = jstep.make_train_state(jax.random.PRNGKey(0), cfg, model)
    step = jstep.build_train_step(cfg, model, donate=False, base_radius=RADIUS if cfg.mip else 0.0)
    rays_np, pix_np = _rays(N_RAYS, 11)
    rays, pix = jnp.asarray(rays_np), jnp.asarray(pix_np)
    key = jax.random.PRNGKey(12)
    p0 = jax.tree.map(np.asarray, state.params)
    js = jrenderer.RenderSettings(N=cfg.Nf, N_coarse=cfg.Nc if cfg.hierarchical else 0, mip=cfg.mip,
                                  mip_levels=cfg.mip_levels, base_radius=RADIUS if cfg.mip else 0.0,
                                  resample_blur=cfg.resample_blur, sampling_space="disparity", tn=TN, tf=TF,
                                  compute_dtype=jnp.float32)
    losses, draws = [], []
    for i in range(n_steps):
        k_sel, k_render = jax.random.split(jax.random.fold_in(key, i))
        idx = jax.random.randint(k_sel, (BATCH,), 0, N_RAYS)
        r, params = rays[idx], state.params
        d = {"idx": np.asarray(idx)}
        k_strat, k_imp = jax.random.split(k_render)
        if cfg.mip:
            d["ts"] = edges = jsampling.stratified_ts_spaced(k_render, BATCH, cfg.Nf + 1, TN, TF, space="disparity")
            if cfg.mip_levels == 2:
                out_c, _ = jrenderer._render_mip(params, r, k_render, js, model, return_coarse=True)
                d["fine"] = jsampling.resample_edges(jax.random.fold_in(k_render, 2), edges, out_c.weights, cfg.Nf,
                                                     blur=cfg.resample_blur)
        elif cfg.hierarchical:
            d["ts"] = ts_c = jsampling.stratified_ts_spaced(k_strat, BATCH, cfg.Nc, TN, TF, space="disparity")
            w_c = jrenderer._render_at_ts(params["coarse"], r, ts_c, js, model).weights
            d["fine"] = jsampling.importance_ts(k_imp, ts_c, w_c, cfg.Nf)
        elif cfg.proposal:
            d["ts"] = ts_p = jsampling.stratified_ts_spaced(k_strat, BATCH, cfg.Np, TN, TF, space="disparity")
            w = jproposal.proposal_weights(params["prop"], r, ts_p, jproposal.proposal_from_train_config(cfg),
                                           jnp.float32)
            d["fine"] = jsampling.importance_ts(k_imp, ts_p, w, cfg.Nf)
        else:
            d["ts"] = jsampling.stratified_ts_spaced(k_render, BATCH, cfg.Nf, TN, TF, space="disparity")
        draws.append({k: np.asarray(v) for k, v in d.items()})
        state, loss = step(state, rays, pix, key)
        losses.append(float(np.asarray(loss).reshape(-1)[0]))
    return p0, losses, draws


@pytest.mark.parametrize("kind", list(KINDS))
def test_contract_train_steps_match_jax_step(monkeypatch, kind):
    """Two f32 steps of the port's pallas step (the fused cores: B1 of a
    contracted model, its plain version on CPU; the proposal net contracts
    in plain torch) against two of the JAX ``build_train_step`` with
    ``backend: xla`` from the same initial params on the same rays and
    draws: the single net, the hierarchical pair (JAX's :229), the 360
    recipe (proposal sampling + the disparity-space distortion rail) and
    mip + contract at one and two levels (JAX's :303). Each loss to rtol
    2e-4; the fused core ran (no autograd fallback)."""
    p0, jlosses, draws = _jax_steps(kind)
    cfg = config.TrainConfig(backend="pallas", **_cfg_kw(kind))
    model = model_from_train_config(cfg)
    assert model == CWIDE and tstep.kernel_refusal(cfg) is None
    if cfg.proposal:
        field = ProposalPair.from_jax_params(p0, "cpu", model, ProposalMLP(Lp=4, D=2, H=16, contract=True))
        assert tstep.make_train_state(cfg, model, "cpu").field.prop.model == field.prop.model
    elif cfg.hierarchical:
        field = NerfPair.from_jax_params(p0, "cpu", model)
    else:
        field = NerfField.from_jax_params(p0, "cpu", model)
    state = tstep.TrainState(field, tstep.make_optimizer(cfg, field.parameters()), torch.Generator())
    queue, cur = list(draws), {}

    def randint(*a, **k):  # step_fn's first draw, the batch: the step's other draws follow it
        cur.clear()
        cur.update(queue.pop(0))
        return _t(cur["idx"]).long()

    monkeypatch.setattr(torch, "randint", randint)
    monkeypatch.setattr(tstep, "stratified_ts_spaced", lambda *a, **k: _t(cur["ts"]))
    monkeypatch.setattr(tstep, "importance_ts", lambda *a, **k: _t(cur["fine"]))
    monkeypatch.setattr(tstep, "resample_edges", lambda *a, **k: _t(cur["fine"]))
    cores = []
    for name in ("mip_fused_loss", "hierarchical_fused_loss", "proposal_fused_loss", "fused_loss"):
        core = getattr(tstep, name)
        monkeypatch.setattr(tstep, name, lambda *a, _n=name, _c=core, **k: cores.append(_n) or _c(*a, **k))
    step_fn = tstep.build_train_step(cfg, model, base_radius=RADIUS if cfg.mip else 0.0)
    rays_np, pix_np = _rays(N_RAYS, 11)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the fused core takes it: no fallback warning
        losses = [step_fn(state, _t(rays_np), _t(pix_np)).item() for _ in range(2)]
    assert cores and cores[0] == ("mip_fused_loss" if cfg.mip else "hierarchical_fused_loss" if cfg.hierarchical
                                  else "proposal_fused_loss" if cfg.proposal else "fused_loss")
    np.testing.assert_allclose(losses, jlosses, rtol=2e-4)


# --- the sidecar, eval and the server; the weights -----------------------------------------------------

def test_contract_rides_the_sidecar_and_eval_and_serve_rebuild_both_nets(tmp_path):
    """``contract`` rides the ``model.json`` sidecar (JAX's :116): eval's
    model comes back contracted without a knob, with no sidecar warning
    for a contracted model; on a proposal eval and in the server the
    proposal net, whose weight shapes cannot tell, copies ``contract``
    from the main model (JAX evaluate.py:143-147, serve.py:96-99). A
    contracted model's params are the plain pytree: npz and pth round
    trips give the same weights and the same field values, and JAX reads
    the npz."""
    from nerf_simple_tpu.train.checkpoint import import_params_npz as jimport

    from nerf_simple_tpu_torch.evaluate import _model_for, load_params
    from nerf_simple_tpu_torch.render.renderer import RenderSettings
    from nerf_simple_tpu_torch.serve import RenderServer

    assert model_from_meta({"family": "nerf", **dataclasses.asdict(CWIDE)}) == CWIDE
    exp = tmp_path / "exp"
    ckpt.save_model_meta(str(exp), CWIDE)
    assert ckpt.load_model_meta(str(exp)) == CWIDE
    pm = ProposalMLP(Lp=4, D=2, H=16, contract=True)
    params = {"prop": jax.tree.map(np.asarray, jproposal.init_proposal_params(jax.random.PRNGKey(1),
                                                                             jproposal.ProposalMLP(4, 2, 16))),
              "fine": init_nerf_params(2, WIDE)}
    ckpt.export_params_npz(str(exp / "params_1.npz"), params)
    ckpt.export_params_pth(str(exp / "params_1.pth"), params["fine"])
    jnpz = jimport(str(exp / "params_1.npz"))
    np.testing.assert_array_equal(np.asarray(jnpz["fine"]["skip"]["w"]), params["fine"]["skip"]["w"])
    loaded = load_params(str(exp / "params_1.npz"), keep_hierarchy=True)
    np.testing.assert_array_equal(load_params(str(exp / "params_1.pth"))["skip"]["w"], params["fine"]["skip"]["w"])
    tcfg = config.TestConfig(loadpath=str(exp / "params_1.npz"), datapath="d", Np=8, N_samples=8)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert _model_for(tcfg, loaded) == CWIDE
    with pytest.warns(UserWarning, match="no model.json sidecar"):  # without it: the warning, contract=False
        assert not _model_for(dataclasses.replace(tcfg, loadpath=str(tmp_path)), loaded).contract
    settings = RenderSettings(N=8, N_prop=8, tn=TN, tf=TF, sampling_space="disparity", backend="pallas")
    srv = RenderServer(loaded, 8, 8, 20.0, settings, model=CWIDE, device="cpu", warmup=False)
    assert srv.prop_model == pm and srv.field.prop.model.contract and srv.field.fine.model.contract
    x, _ = _x(64, 13)
    with torch.no_grad():
        want = np.asarray(jnerf.nerf_apply(_jtree(params["fine"]), jnp.asarray(x[:6].T), _jm(CWIDE)))
        np.testing.assert_allclose(nerf_apply(srv.field.fine, _t(x[:6].T)).numpy(), want, atol=1e-5)
        want = np.asarray(jproposal.proposal_sigma(_jtree(params["prop"]), jnp.asarray(x[:3].T),
                                                   jproposal.ProposalMLP(4, 2, 16, contract=True)))
        from nerf_simple_tpu_torch.models.proposal import proposal_sigma

        np.testing.assert_allclose(proposal_sigma(srv.field.prop, _t(x[:3].T)).numpy(), want, atol=1e-5)


# --- the unbounded scene, and the 360 recipe trained and evaluated ------------------------------------------

def test_unbounded_field_and_orbit_cameras_match_jax():
    """The ``unbounded`` style's field (the blob cluster and the shell at
    radius 20) and ``orbit_cameras`` with varied radii against JAX's;
    an unknown style raises before anything is written."""
    rng = np.random.default_rng(14)
    u = rng.normal(size=(600, 3))
    locs = (u / np.linalg.norm(u, axis=1, keepdims=True) * rng.uniform(0, 24, (600, 1))).astype(np.float32)
    got = synthetic.field(_t(locs), "unbounded").numpy()
    want = np.asarray(jsynthetic.field(jnp.asarray(locs), "unbounded"))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5)
    assert (got[:, 3] > 10).any()  # the shell is in the sample
    for kw in (dict(seed_jitter=3, r_range=(3.0, 6.0)), dict(seed_jitter=0, r_range=(3.0, 6.0)), dict(seed_jitter=2)):
        np.testing.assert_allclose(synthetic.orbit_cameras(7, **kw), jsynthetic.orbit_cameras(7, **kw), atol=1e-6)
    radii = np.linalg.norm(synthetic.orbit_cameras(7, seed_jitter=3, r_range=(3.0, 6.0))[:, :3, 3], axis=1)
    assert (radii >= 3.0).all() and (radii <= 6.0).all() and radii.std() > 0.1
    with pytest.raises(ValueError, match="unknown synthetic style"):
        synthetic.write_blender_scene("unused", style="glass")
    assert not os.path.exists("unused")


def test_train_and_evaluate_the_360_recipe_on_an_unbounded_scene(tmp_path, capsys, monkeypatch):
    """train() the 360 recipe's shape (contract, disparity spacing, the
    proposal scheme, the distortion rail; JAX's :374) on a 20x20 scene of
    the ``unbounded`` style with varied camera radii: the loss falls and
    the sidecar says contract; then ``evaluate.test`` with Np > 0 of the
    port and of the JAX package on the same checkpoint (both
    deterministic end to end, the contraction rebuilt from the sidecar):
    the same PSNR and SSIM."""
    import sys

    from nerf_simple_tpu.evaluate import test as jtest

    from nerf_simple_tpu_torch.evaluate import test
    from nerf_simple_tpu_torch.train.loop import train

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    scene = str(tmp_path / "scene")
    synthetic.write_blender_scene(scene, n_train=4, n_val=1, n_test=1, H=20, W=20, train_jitter=3,
                                  style="unbounded", camera_r_range=(3.0, 6.0))
    cfg = dict(datapath=scene, savepath=str(tmp_path / "models"), exp_name="u", Nf=8, contract=True,
               sampling_space="disparity", tn=TN, tf=TF, proposal=True, Np=8, prop_Lp=4, prop_D=2, prop_H=32,
               distortion_loss_weight=0.01, net_Lp=4, net_Ld=2, net_H=32, num_iters=40, ckpt_model=40, ckpt_loss=1,
               ckpt_images=10**6, batch_size=64, half_res=False, val_idxs=[0], num_train_imgs=4, backend="pallas",
               compute_dtype="f32", steps_per_call=10, honor_lr_init=True, lr_init=5e-3, lr_final=5e-4,
               log_dir=str(tmp_path / "logs"))
    before = mlp.fused_train_step.contract_launches
    state = train(cfg, device="cpu")
    assert mlp.fused_train_step.contract_launches == before  # CPU: B1's plain version
    losses = [float(line.split()[1]) for line in capsys.readouterr().out.splitlines() if line.startswith("loss:")]
    assert len(losses) == 40 and np.mean(losses[-10:]) < 0.8 * np.mean(losses[:10])
    assert state.field.fine.model.contract and state.field.prop.model.contract
    exp = tmp_path / "models" / "u"
    assert ckpt.load_model_meta(str(exp)).contract
    jrenderer._chunked_render_fn.cache_clear()
    tp = dict(loadpath=str(exp / "params_40.npz"), datapath=scene, exp_name="e", batch_size=256, half_res=False,
              im_idxs=[0], N_samples=8, Np=8, sampling_space="disparity", tn=TN, tf=TF)
    jtest({**tp, "savepath": str(tmp_path / "jax")})
    jout = capsys.readouterr().out
    test({**tp, "savepath": str(tmp_path / "port"), "backend": "pallas"}, device="cpu")
    got = capsys.readouterr().out
    jrenderer._chunked_render_fn.cache_clear()
    metrics = [re.findall(r"im (\d+): mse=\S+ psnr=(\S+) ssim=(\S+)", o) for o in (got, jout)]
    assert len(metrics[0]) == len(metrics[1]) == 1
    for (i, p, s), (j, q, r) in zip(*metrics):
        assert i == j and abs(float(p) - float(q)) <= 0.01 and abs(float(s) - float(r)) <= 1e-3
    assert "rgb_0.png" in os.listdir(tmp_path / "port" / "e")


# --- the config rules ----------------------------------------------------------------------------------------

def test_contract_config_rules():
    """contract loads (with mip too, which composes, and with the 360
    recipe of configs/colmap360.yaml given the unbounded scene's dataset
    and bounds); JAX's rule: contract with LLFF + NDC is a ValueError in
    both packages; pose refinement with mip and contract (the mip input
    gradient's contraction, Queue B item 4) and mip + proposal + contract
    (Queue A item 2) load, as they do in JAX; pose refinement or appearance
    codes with contract load."""
    assert config.TrainConfig(datapath="x", contract=True, mip=True).contract
    d = {k: v for k, v in config.load_yaml("configs/colmap360.yaml").items()
         if k not in ("dataset", "llff_factor", "ndc", "test_params")}
    cfg = config.train_config_from_dict({**d, "datapath": "x", "tn": TN, "tf": TF})
    assert (cfg.contract, cfg.sampling_space, cfg.proposal, cfg.Np, cfg.distortion_loss_weight) == (
        True, "disparity", True, 64, 0.01)
    assert model_from_train_config(cfg).contract and tstep.kernel_refusal(cfg) is None
    with pytest.raises(ValueError, match="NDC"):
        config.train_config_from_dict({"datapath": "x", "contract": True, "dataset": "llff", "ndc": True})
    with pytest.raises(ValueError, match="NDC"):
        jconfig.TrainConfig(datapath="x", contract=True, dataset="llff", ndc=True)
    with pytest.raises(NotImplementedError, match="LLFF"):  # non-NDC LLFF is JAX's, not ported (Queue A item 6)
        config.train_config_from_dict({"datapath": "x", "contract": True, "dataset": "llff", "ndc": False})
    for kw in (dict(pose_opt=True), dict(appearance_dim=4), dict(pose_opt=True, mip=True)):
        jconfig.TrainConfig(datapath="x", contract=True, **kw)  # JAX composes them
        assert config.TrainConfig(datapath="x", contract=True, **kw).contract
    jconfig.TrainConfig(datapath="x", contract=True, mip=True, proposal=True)
    assert config.TrainConfig(datapath="x", contract=True, mip=True, proposal=True).proposal
    assert NerfField(NerfMLP(Lp=2, Ld=2, H=16, contract=True, app_dim=2)).model.app_dim == 2


def test_normals_chain_through_the_contraction():
    """The normals' density gradient (``render/renderer.py::_density_grad``,
    plain autograd) of a contracted field against ``jax.grad`` of
    softplus(sigma) of JAX's contracted ``nerf_apply``: the chain rule runs
    through ``scene_contraction``, so outside the unit ball the gradient
    differs from the field without contract."""
    from nerf_simple_tpu_torch.render.renderer import _density_grad

    params = init_nerf_params(15, WIDE)
    x, inside = _x(96, 16)
    pts = x[:3].T.copy()
    dirs = np.zeros_like(pts)
    dirs[:, 2] = -1.0

    def soft_sigma(p):
        out = jnerf.nerf_apply(_jtree(params), jnp.concatenate([p, jnp.asarray(dirs)], -1), _jm(CWIDE))
        return jnp.sum(jax.nn.softplus(out[:, 3]))

    want = np.asarray(jax.grad(soft_sigma)(jnp.asarray(pts)))
    got = _density_grad(NerfField.from_jax_params(params, "cpu", CWIDE), _t(pts), torch.float32).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    plain = _density_grad(NerfField.from_jax_params(params, "cpu"), _t(pts), torch.float32).numpy()
    np.testing.assert_array_equal(got[inside], plain[inside])
    assert np.abs(got[~inside] - plain[~inside]).max() > 1e-4
