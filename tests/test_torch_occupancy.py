"""The port's occupancy-grid sampling (ops/occupancy.py), its train-step,
checkpoint, render, eval and serving integration, and the ``debug_nan``
and ``profile_dir`` options, on CPU against the JAX package.

Inputs are made with numpy from a seed and handed to both packages. JAX's
draws (the sampler's exponentials, the refresh jitter) are made with its
own key calls and passed into the port, so no RNG stream needs to match.
Occupancy's JAX functions are plain XLA; no interpret-mode kernel runs.

Tolerances:

- ``occ_lookup``, ``ray_bin_occupancy``: exact (the same f32 operations
  pick the same cell).
- ``binned_pdf_ts``: atol 1e-5 on t in [2, 6]; ``occupancy_ts``: atol
  2e-4. The CDF's cumsum rounds in another order (a few ulp of 1), and t
  moves by the bin width times that over the bin's mass: at floor 0.01
  over 16 bins a bin may hold 6e-4 of the mass, so up to ~1.2e-4 at width
  0.25. The map from u to t is continuous across bin edges, so a flipped
  bin moves t by that rounding only.
- ``update_occ_grid`` and ``build_occ_from_params`` on an analytic field:
  atol 1e-6; through the MLP's density probe: atol 1e-5 (f32).
- ``density_fn``: f32 atol 1e-4 of sigma (JAX's XLA ``nerf_apply`` and the
  port's layer-by-layer MLP or the forward kernel's plain version sum in
  other orders); bf16 atol 2e-2 (an activation may round to the
  neighbouring bf16 and the layers below carry it; tests/test_torch_model.py
  holds the rgb heads to 2e-3, sigma's raw values are ~10x larger).
- The chunked render at occupancy samples: rgb atol 1e-5 (f32).
"""

from __future__ import annotations

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerf_simple_tpu.models.nerf as jnerf
import nerf_simple_tpu.ops.occupancy as jocc
import nerf_simple_tpu.render.renderer as jrenderer
from nerf_simple_tpu_torch import config
from nerf_simple_tpu_torch.config import TrainConfig
from nerf_simple_tpu_torch.data.synthetic import write_blender_scene
from nerf_simple_tpu_torch.models.nerf import NerfField, NerfMLP, NerfPair, init_nerf_params
from nerf_simple_tpu_torch.ops import occupancy as occ
from nerf_simple_tpu_torch.ops.rays import apply_cam_deltas
from nerf_simple_tpu_torch.render import renderer
from nerf_simple_tpu_torch.render.renderer import RenderSettings
from nerf_simple_tpu_torch.train import checkpoint as ckpt
from nerf_simple_tpu_torch.train import step as tstep
from nerf_simple_tpu_torch.train.loop import train

SMALL = NerfMLP(Lp=4, Ld=2, H=32)
TS_ATOL = 1e-5
OCC_TS_ATOL = 2e-4


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _jtree(params):
    if isinstance(params, dict):
        return {k: _jtree(v) for k, v in params.items()}
    return jnp.asarray(params)


def _jmodel(model):
    return jnerf.NerfMLP(model.Lp, model.Ld, model.H, contract=model.contract, app_dim=model.app_dim)


def _rays(B, seed=0):
    """(B, 6) rays from a radius-4 shell aimed near the origin (unnormalised
    directions of length ~1)."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(B, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o / 4.0 + rng.normal(0, 0.1, (B, 3))
    return np.concatenate([o, d], 1).astype(np.float32)


def _ball(xp):
    def fn(pts):
        return xp.where((pts**2).sum(-1) ** 0.5 < 0.5, 50.0, -50.0)
    return fn


def _j_u(key, B, N):
    """JAX's sorted uniforms of ``binned_pdf_ts`` (its :124-126)."""
    e = jax.random.exponential(key, (B, N + 1), dtype=jnp.float32)
    s = jnp.cumsum(e, axis=-1)
    return np.asarray(s[:, :N] / s[:, N:])


# --- the sampler ---------------------------------------------------------------------------------------------

def test_occ_lookup_and_ray_bins_match_jax():
    rng = np.random.default_rng(0)
    R, aabb = 8, 2.0
    grid = rng.uniform(size=(R, R, R)).astype(np.float32)
    pts = rng.uniform(-3, 3, (500, 3)).astype(np.float32)  # some outside the box: clamped
    np.testing.assert_array_equal(occ.occ_lookup(_t(grid), _t(pts), aabb).numpy(),
                                  np.asarray(jocc.occ_lookup(jnp.asarray(grid), jnp.asarray(pts), aabb)))
    rays = _rays(64)
    np.testing.assert_array_equal(
        occ.ray_bin_occupancy(_t(grid), _t(rays), 2.0, 6.0, 16, aabb).numpy(),
        np.asarray(jocc.ray_bin_occupancy(jnp.asarray(grid), jnp.asarray(rays), 2.0, 6.0, 16, aabb)))
    # JAX's own cases (tests/test_occupancy.py:20-31)
    g = torch.arange(64, dtype=torch.float32).reshape(4, 4, 4)
    got = occ.occ_lookup(g, torch.tensor([[-1.9, -1.9, -1.9], [1.9, 0.1, -0.9], [9.0, -9.0, 0.1]]), 2.0)
    assert got.tolist() == [g[0, 0, 0].item(), g[3, 2, 1].item(), g[3, 0, 2].item()]


@pytest.mark.parametrize("case", ["random", "det", "zero-mass", "zero-mass-det", "one-bin"])
def test_binned_pdf_ts_matches_jax(case):
    B, Nb, N = 6, 16, 32
    rng = np.random.default_rng(1)
    w = rng.uniform(size=(B, Nb)).astype(np.float32)
    if case.startswith("zero-mass"):
        w[0] = 0.0  # a ray of zero mass: the uniform PDF (JAX :105-112)
    if case == "one-bin":
        w[:] = 0.0
        w[:, 5] = 1.0
    key = jax.random.PRNGKey(3)
    det = case.endswith("det")
    want = np.asarray(jocc.binned_pdf_ts(key, jnp.asarray(w), N, 2.0, 6.0, det=det))
    got = occ.binned_pdf_ts(None, _t(w), N, 2.0, 6.0, det=det, u=None if det else _t(_j_u(key, B, N))).numpy()
    np.testing.assert_allclose(got, want, atol=TS_ATOL)
    assert (np.diff(got, axis=-1) >= 0).all() and got.min() >= 2.0 and got.max() <= 6.0
    if case.startswith("zero-mass"):
        assert got[0].max() - got[0].min() > 2.0  # spread over the range
    if case == "one-bin":
        assert ((got >= 3.25) & (got <= 3.5)).all()  # bin 5 of 16 over [2, 6]
    # the generator draws sorted uniforms of its own (a different stream), as finite sorted ts
    g = torch.Generator().manual_seed(0)
    drawn = occ.binned_pdf_ts(g, _t(w), N, 2.0, 6.0)
    assert bool(torch.isfinite(drawn).all()) and bool((drawn.diff(dim=-1) >= 0).all())


@pytest.mark.parametrize("group", [1, 4, 3], ids=["per-ray", "group-4", "group-3-not-dividing"])
@pytest.mark.parametrize("det", [True, False], ids=["det", "random"])
def test_occupancy_ts_matches_jax(group, det):
    rng = np.random.default_rng(2)
    grid = (rng.uniform(size=(16, 16, 16)) > 0.7).astype(np.float32)
    rays = _rays(24, seed=3)
    key = jax.random.PRNGKey(5)
    kw = dict(N=32, tn=2.0, tf=6.0, aabb=2.0, Nb=16, floor=0.01, det=det, group=group)
    want = np.asarray(jocc.occupancy_ts(key, jnp.asarray(rays), jnp.asarray(grid), **kw))
    u = None if det else _t(_j_u(key, 24, 32))
    got = occ.occupancy_ts(None, _t(rays), _t(grid), **kw, u=u).numpy()
    np.testing.assert_allclose(got, want, atol=OCC_TS_ATOL)


def test_occupancy_ts_zero_floor_empty_grid_and_empty_space():
    """Floor 0 on an all-zero grid: finite sorted ts (JAX :105-112); a grid
    occupied at x > 0 draws ~all samples of +x rays there (JAX
    tests/test_occupancy.py:59-87)."""
    key = jax.random.PRNGKey(4)
    rays = np.concatenate([np.zeros((4, 3)), np.tile([[0.0, 0.0, -1.0]], (4, 1))], 1).astype(np.float32)
    want = np.asarray(jocc.occupancy_ts(key, jnp.asarray(rays), jnp.zeros((8, 8, 8)), 32, 2.0, 6.0, aabb=2.0,
                                        Nb=8, floor=0.0))
    got = occ.occupancy_ts(None, _t(rays), torch.zeros(8, 8, 8), 32, 2.0, 6.0, 2.0, Nb=8, floor=0.0,
                           u=_t(_j_u(key, 4, 32))).numpy()
    np.testing.assert_allclose(got, want, atol=OCC_TS_ATOL)
    assert np.isfinite(got).all() and (np.diff(got, axis=-1) >= 0).all()
    grid = torch.zeros(8, 8, 8)
    grid[4:] = 1.0
    rays = torch.tensor([[-1.0, 0.0, 0.0, 1.0, 0.0, 0.0]]).expand(16, 6)
    ts = occ.occupancy_ts(torch.Generator().manual_seed(0), rays, grid, 64, 0.0, 2.0, 1.0, Nb=32, floor=1e-3)
    assert (ts > 1.0).float().mean().item() > 0.95


def test_update_and_build_occ_grid_match_jax():
    R, aabb = 8, 1.0
    key = jax.random.PRNGKey(0)
    jitter = np.asarray(jax.random.uniform(key, (R**3, 3), jnp.float32))
    start = np.random.default_rng(0).uniform(size=(R, R, R)).astype(np.float32)
    want = np.asarray(jocc.update_occ_grid(jnp.asarray(start), _ball(jnp), key, aabb, decay=0.9))
    got = occ.update_occ_grid(_t(start), _ball(torch), None, aabb, decay=0.9, jitter=_t(jitter)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert got[3:5, 3:5, 3:5].min() > 0.5 and abs(got[0, 0, 0] - 0.9 * start[0, 0, 0]) < 1e-6
    jitters = [_t(np.asarray(jax.random.uniform(jax.random.fold_in(key, i), (R**3, 3), jnp.float32)))
               for i in range(4)]
    want = np.asarray(jocc.build_occ_from_params(_ball(jnp), R, aabb, key))
    got = occ.build_occ_from_params(_ball(torch), R, aabb, None, jitters=jitters).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert got[3:5, 3:5, 3:5].min() > 0.5 and got[0, 0, 0] < 1e-3


@pytest.mark.parametrize("model, dtype", [(SMALL, torch.float32), (SMALL, torch.bfloat16),
                                          (NerfMLP(Lp=4, Ld=2, H=32, contract=True), torch.float32),
                                          (NerfMLP(Lp=4, Ld=2, H=32, app_dim=4), torch.float32)],
                         ids=["f32", "bf16", "contract-f32", "app-f32"])
def test_density_fn_matches_jax(model, dtype):
    """The probe on both backends (the forward kernel's plain version under
    "pallas") against JAX's XLA probe, and a refresh through it."""
    params = init_nerf_params(0, model)
    pts = np.random.default_rng(4).uniform(-3, 3, (700, 3)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(jax.jit(jocc.density_fn(_jtree(params), _jmodel(model), jdt))(jnp.asarray(pts)))
    field = NerfField.from_jax_params(params, "cpu", model)
    atol = 1e-4 if dtype == torch.float32 else 2e-2
    for backend in ("xla", "pallas"):
        got = occ.density_fn(field, backend, dtype)(_t(pts))
        assert got.shape == (700,) and not got.requires_grad
        np.testing.assert_allclose(got.numpy(), want, atol=atol * max(1.0, float(np.abs(want).max())))
    if dtype == torch.float32 and model is SMALL:
        R, key = 8, jax.random.PRNGKey(2)
        jitter = np.asarray(jax.random.uniform(key, (R**3, 3), jnp.float32))
        want = np.asarray(jocc.update_occ_grid(jnp.ones((R, R, R)), jocc.density_fn(_jtree(params), _jmodel(model)),
                                               key, 2.0))
        got = occ.update_occ_grid(torch.ones(R, R, R), occ.density_fn(field, "pallas"), None, 2.0,
                                  jitter=_t(jitter)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_rebuild_occ_probes_the_fine_field():
    """A pair's grid is the fine field's (JAX :216-220)."""
    pair = NerfPair.from_jax_params({"coarse": init_nerf_params(0, SMALL), "fine": init_nerf_params(1, SMALL)}, "cpu")
    got = occ.rebuild_occ(pair, "xla", torch.float32, 8, 2.0, seed=7)
    want = occ.rebuild_occ(pair.fine, "xla", torch.float32, 8, 2.0, seed=7)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not torch.equal(got, occ.rebuild_occ(pair.coarse, "xla", torch.float32, 8, 2.0, seed=7))


# --- the chunked render ---------------------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", ["single", "hierarchical"])
def test_chunked_render_at_occupancy_ts_matches_jax(scheme):
    """Deterministic quantiles of the grid's PDF in both packages (JAX
    renderer.py:764-830): the single net at N, the hierarchical coarse pass
    at N_coarse; then fused_eval under "pallas" (the render kernel's plain
    version) draws the same samples as the unfused path."""
    grid = (np.random.default_rng(5).uniform(size=(16, 16, 16)) > 0.6).astype(np.float32)
    rays = _rays(40, seed=6)
    kw = dict(N=16, occ_Nb=16, occ_floor=0.01, occ_aabb=2.0, occ_group=4)
    if scheme == "single":
        params = init_nerf_params(0, SMALL)
        field = NerfField.from_jax_params(params, "cpu")
    else:
        kw["N_coarse"] = 8
        params = {"coarse": init_nerf_params(0, SMALL), "fine": init_nerf_params(1, SMALL)}
        field = NerfPair.from_jax_params(params, "cpu")
    want, _ = jrenderer.render_rays_chunked(_jtree(params), jnp.asarray(rays), jax.random.PRNGKey(0),
                                            jrenderer.RenderSettings(**kw), jnerf.NerfMLP(4, 2, 32), chunk=20,
                                            occ=jnp.asarray(grid))
    got, disp = renderer.render_rays_chunked(field, _t(rays), 0, RenderSettings(**kw), chunk=20, occ=_t(grid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert got.shape == (40, 3) and bool(torch.isfinite(disp).all())
    if scheme == "single":
        fused = renderer.render_rays_chunked(field, _t(rays), 0, RenderSettings(**kw, backend="pallas",
                                                                                fused_eval=True), chunk=20,
                                             occ=_t(grid))[0]
        np.testing.assert_allclose(fused.numpy(), got.numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="interval edges"):
        renderer.render_rays_chunked(NerfField.from_jax_params(init_nerf_params(0, SMALL), "cpu"), _t(rays), 0,
                                     RenderSettings(N=8, mip=True, base_radius=0.01), occ=_t(grid))


# --- the train step ---------------------------------------------------------------------------------------------

def _cfg(**kw):
    base = dict(datapath="d", Nf=16, Nc=8, Np=8, batch_size=64, net_H=32, net_Lp=4, net_Ld=2, occupancy=True,
                occ_R=8, occ_Nb=8, occ_update_every=4, occ_aabb=2.0, prop_H=16, prop_D=2)
    return TrainConfig(**{**base, **kw})


def _pool(n=512, seed=9):
    rays = _t(_rays(n, seed))
    pix = torch.from_numpy(np.random.default_rng(seed + 1).uniform(size=(n, 3)).astype(np.float32))
    return rays, pix


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_step_refreshes_the_grid_on_its_cadence(backend):
    """All ones at the start; a refresh from the pre-step weights, its jitter
    first from the state's generator, at steps 0, 4, 8 and no other; the
    step's samples come from the refreshed grid (JAX step.py:1058-1086)."""
    cfg = _cfg(backend=backend, compute_dtype="f32")
    state = tstep.make_train_state(cfg, SMALL, "cpu")
    assert state.occ.shape == (8, 8, 8) and bool((state.occ == 1).all())
    step_fn = tstep.build_train_step(cfg, SMALL)
    rays, pix = _pool()
    grids = []
    for k in range(9):
        if k % 4 == 0:
            g = torch.Generator().manual_seed(0)
            g.set_state(state.generator.get_state())
            dp = NerfField.from_jax_params(state.field.to_jax_params(), "cpu")
            want = occ.update_occ_grid(state.occ, occ.density_fn(dp, backend), g, 2.0, decay=0.95)
        step_fn(state, rays, pix)
        if k % 4 == 0:
            torch.testing.assert_close(state.occ, want, rtol=0, atol=0)
        grids.append(state.occ.clone())
    assert not bool((grids[0] == 1).all())
    changed = [k for k in range(1, 9) if not torch.equal(grids[k], grids[k - 1])]
    assert changed == [4, 8] and state.step == 9


@pytest.mark.parametrize("kind", ["single-xla", "single-pallas", "hierarchical", "proposal", "pose", "appearance"])
def test_step_draws_occupancy_ts_on_every_core(kind, monkeypatch):
    """The occupancy sampler replaces the stratified draw on each core (JAX
    ``_maybe_occ_ts``): Nf for one net, Nc for the hierarchical coarse pass,
    Np for the proposal probes; its rays are the batch's (after the
    refresh's jitter and the batch draw), under pose the refined ones."""
    kw = {"single-xla": dict(backend="xla"), "single-pallas": dict(backend="pallas"),
          "hierarchical": dict(backend="pallas", hierarchical=True), "proposal": dict(backend="pallas", proposal=True),
          "pose": dict(backend="xla", pose_opt=True, pose_warmup=0),
          "appearance": dict(backend="pallas", appearance_dim=4)}[kind]
    cfg = _cfg(**kw)
    model = dataclasses.replace(SMALL, app_dim=cfg.appearance_dim)
    aux = cfg.pose_opt or cfg.appearance_dim > 0
    state = tstep.make_train_state(cfg, model, "cpu", n_images=4 if aux else None)
    if state.cams is not None:
        with torch.no_grad():
            state.cams.dr.copy_(torch.randn(4, 3, generator=torch.Generator().manual_seed(1)) * 0.05)
            state.cams.dt.copy_(torch.randn(4, 3, generator=torch.Generator().manual_seed(2)) * 0.05)
    seen = []

    def spy(g, rays, grid, N, *a, **k):
        out = occ.occupancy_ts(g, rays, grid, N, *a, **k)
        seen.append((rays.detach().clone(), N, out))
        return out

    monkeypatch.setattr(tstep, "occupancy_ts", spy)
    rays, pix = _pool()
    g = torch.Generator().manual_seed(0)
    g.set_state(state.generator.get_state())
    torch.rand((8**3, 3), generator=g)  # the refresh's jitter comes first
    idx = torch.randint(0, rays.shape[0], (cfg.batch_size,), generator=g)
    deltas = None if state.cams is None else (state.cams.dr.detach().clone(), state.cams.dt.detach().clone())
    loss = tstep.build_train_step(cfg, model, **({"rays_per_image": 128} if aux else {}))(state, rays, pix)
    assert bool(torch.isfinite(loss)) and len(seen) == 1
    got_rays, N, ts = seen[0]
    assert N == {"hierarchical": cfg.Nc, "proposal": cfg.Np}.get(kind, cfg.Nf) and ts.shape == (cfg.batch_size, N)
    want = rays[idx]
    if kind == "pose":
        im = idx // 128
        want = apply_cam_deltas(want, deltas[0][im], deltas[1][im])
        assert not torch.allclose(want, rays[idx])
    torch.testing.assert_close(got_rays, want, rtol=0, atol=1e-6)


def test_occupancy_config_rules_match_jax():
    import nerf_simple_tpu.config as jconfig

    for kw, match in ((dict(mip=True, occupancy=True), "incompatible with occupancy"),
                      (dict(mip=True, hierarchical=True, occupancy=True), "hierarchical, occupancy"),
                      (dict(sampling_space="disparity", occupancy=True), "dead under occupancy")):
        for mod in (config, jconfig):
            with pytest.raises(ValueError, match=match):
                mod.TrainConfig(datapath="d", **kw)
    for kw, match in ((dict(mip=True, occupancy=True), "Nc/occupancy"),
                      (dict(sampling_space="disparity", occupancy=True), "dead under occupancy")):
        for mod in (config, jconfig):
            with pytest.raises(ValueError, match=match):
                mod.TestConfig(loadpath="m", datapath="d", **kw)
    d = config.load_yaml("configs/lego_occ.yaml")
    cfg, tc = config.train_config_from_dict(d), config.test_config_from_dict(d)
    assert (cfg.occupancy, cfg.Nf, cfg.occ_R, cfg.occ_Nb, cfg.occ_aabb) == (True, 64, 64, 32, 2.0)
    assert (tc.occupancy, tc.N_samples, tc.occ_group, tc.occ_Nb) == (True, 64, 4, 32)
    for key in ("occupancy", "occ_R", "occ_update_every", "profile_dir", "debug_nan"):
        assert key not in config._UNPORTED
    assert "occ_group" not in config._TEST_UNPORTED


# --- checkpoints ---------------------------------------------------------------------------------------------

def test_checkpoint_carries_the_grid_and_the_three_toggles(tmp_path):
    """Round trip; then JAX's rule for derived state (checkpoint.py:59-90):
    off -> on keeps the run's fresh grid, on -> off drops the grid, and at
    another occ_R the run's resolution wins."""
    on, off, on16 = _cfg(), _cfg(occupancy=False), _cfg(occ_R=16)
    state = tstep.make_train_state(on, SMALL, "cpu")
    state.occ = state.occ * 0.5
    state.step = 7
    path = ckpt.save_checkpoint(str(tmp_path / "a"), state)
    back = tstep.make_train_state(on, SMALL, "cpu")
    ckpt.restore_checkpoint(path, back)
    assert back.step == 7 and bool((back.occ == 0.5).all())
    for name, p in state.field.named_parameters():
        torch.testing.assert_close(dict(back.field.named_parameters())[name], p, rtol=0, atol=0)
    s_off = tstep.make_train_state(off, SMALL, "cpu")
    s_off.step = 5
    p_off = ckpt.save_checkpoint(str(tmp_path / "b"), s_off)
    assert "occ" not in torch.load(p_off, weights_only=False)
    back = tstep.make_train_state(on, SMALL, "cpu")
    ckpt.restore_checkpoint(p_off, back)
    assert back.step == 5 and back.occ.shape == (8, 8, 8) and bool((back.occ == 1).all())
    back = tstep.make_train_state(off, SMALL, "cpu")
    ckpt.restore_checkpoint(path, back)
    assert back.step == 7 and back.occ is None
    back = tstep.make_train_state(on16, SMALL, "cpu")
    ckpt.restore_checkpoint(path, back)
    assert back.occ.shape == (16, 16, 16) and bool((back.occ == 1).all())


# --- debug_nan and profile_dir ------------------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_debug_nan_raises_on_nan_rays_and_passes_clean_ones(backend):
    """JAX tests/test_train.py:279-296: NaN rays raise naming NaN (and the
    step); clean rays pass, the step advances; NaN points read cell 0 of the
    grid, so the sampler does not index out of it."""
    cfg = _cfg(backend=backend, debug_nan=True)
    state = tstep.make_train_state(cfg, SMALL, "cpu")
    step_fn = tstep.build_train_step(cfg, SMALL)
    rays, pix = _pool()
    with pytest.raises(Exception, match="(?i)nan") as err:
        step_fn(state, torch.full_like(rays, float("nan")), pix)
    assert "step 0" in str(err.value) and state.step == 0
    loss = step_fn(state, rays, pix)
    assert bool(torch.isfinite(loss)) and state.step == 1
    off = tstep.build_train_step(_cfg(backend=backend), SMALL)
    assert bool(torch.isnan(off(tstep.make_train_state(_cfg(backend=backend), SMALL, "cpu"),
                                torch.full_like(rays, float("nan")), pix)))  # off: no check


def test_assert_finite_names_the_leaf():
    from nerf_simple_tpu_torch.utils.guards import assert_finite

    assert_finite({"x": np.ones(3), "y": [torch.zeros(2)]}, "params")
    with pytest.raises(ValueError, match=r"non-finite values in params\[y/0\]: 1 NaN"):
        assert_finite({"x": np.ones(3), "y": [torch.tensor([1.0, float("nan")])]}, "params")


@pytest.fixture(scope="module")
def tiny_scene(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("occ_scene") / "scene")
    write_blender_scene(d, 4, 1, 1, H=16, W=16)
    return d


@pytest.fixture
def no_tensorboard(monkeypatch):
    """The logger as on the card's machine, which has no tensorboard: the CSV
    alone (importing tensorboard here loads TensorFlow, ~15 s)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _train_dict(scene, work, **kw):
    return {"datapath": scene, "savepath": str(work), "exp_name": "e", "Nf": 8, "num_iters": 20, "ckpt_model": 100,
            "ckpt_loss": 100, "ckpt_images": 100, "batch_size": 64, "half_res": False, "val_idxs": [0],
            "num_train_imgs": 4, "net_H": 16, "net_Lp": 2, "net_Ld": 2, "steps_per_call": 5,
            "log_dir": str(work / "logs"), **kw}


def test_profile_dir_writes_a_trace_and_skips_as_jax(tiny_scene, tmp_path, capsys, no_tensorboard):
    prof = tmp_path / "prof"
    state = train(_train_dict(tiny_scene, tmp_path, profile_dir=str(prof), occupancy=True, occ_R=8, occ_Nb=8,
                              occ_update_every=4, occ_aabb=2.0), device="cpu")
    traces = list(prof.glob("trace_*.json"))
    assert state.step == 20 and len(traces) == 1 and traces[0].stat().st_size > 0
    assert "wrote trace" in capsys.readouterr().out
    train(_train_dict(tiny_scene, tmp_path, exp_name="short", num_iters=8, profile_dir=str(prof)), device="cpu")
    assert "only 8 iters remain (< 2*steps_per_call=10); skipping trace" in capsys.readouterr().out
    train(_train_dict(tiny_scene, tmp_path, exp_name="pose", pose_opt=True, pose_warmup=2, pose_freeze_at=5,
                      profile_dir=str(prof)), device="cpu")
    assert "would cross pose_freeze_at (5); skipping trace" in capsys.readouterr().out
    assert len(list(prof.glob("trace_*.json"))) == 1


# --- eval and serving -------------------------------------------------------------------------------------------

def test_evaluate_and_serve_with_the_grid(tiny_scene, tmp_path, capsys, monkeypatch, no_tensorboard):
    """train() an occupancy run; evaluate.test rebuilds the grid from it
    (stills with PSNR); the server rebuilds one and reports it."""
    from nerf_simple_tpu_torch import evaluate
    from nerf_simple_tpu_torch.serve import RenderServer

    train(_train_dict(tiny_scene, tmp_path, occupancy=True, occ_R=8, occ_Nb=8, occ_update_every=4, occ_aabb=2.0),
          device="cpu")
    calls = []
    orig = occ.rebuild_occ

    def spy(*a, **k):
        calls.append(a[3])
        return orig(*a, **k)

    monkeypatch.setattr(occ, "rebuild_occ", spy)  # evaluate.test imports it when it runs
    evaluate.test({"loadpath": str(tmp_path / "e"), "datapath": tiny_scene, "savepath": str(tmp_path),
                   "exp_name": "ev", "half_res": False, "im_idxs": [0], "N_samples": 8, "occupancy": True,
                   "occ_R": 8, "occ_Nb": 8, "occ_aabb": 2.0, "occ_group": 4, "batch_size": 256}, device="cpu")
    assert calls == [8] and "psnr=" in capsys.readouterr().out
    assert os.path.exists(tmp_path / "ev" / "rgb_0.png")
    params = ckpt.import_params_npz(str(tmp_path / "e" / "params_20.npz"))
    srv = RenderServer(params, 8, 8, 10.0, RenderSettings(N=8, occ_aabb=2.0), warmup=False, device="cpu",
                       occupancy=True, occ_R=8)
    assert srv.occ.shape == (8, 8, 8) and srv.render(4.0, -30.0, 0.0).shape == (8, 8, 3)
    with pytest.raises(ValueError, match="excludes hierarchical/occupancy"):
        RenderServer(params, 8, 8, 10.0, RenderSettings(N=8, mip=True, base_radius=0.01), warmup=False,
                     device="cpu", occupancy=True)
