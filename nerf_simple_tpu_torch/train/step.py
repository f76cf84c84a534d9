"""The training step: sample -> render -> loss -> gradients -> Adam (port of
nerf_simple_tpu/train/step.py: one network, the hierarchical coarse + fine
pair, the proposal scheme's proposal net and main field, or one network
casting cones, mip-NeRF's path, at one or two levels).

Learning rate as the reference: Adam starts at the hard-coded 5e-4
(train.py:43 ignores lr_init; ``honor_lr_init`` fixes that) and
``lr(i) = lr0 * decay^i`` with ``decay = exp(ln(lr_final/lr_init) /
num_iters)`` for update ``i`` (0-based), as optax's
``exponential_decay`` counts. Adam has optax's defaults (betas 0.9 and
0.999, eps 1e-8); torch's update is the same formula.

The batch and the sample ``ts`` are drawn on the device from the state's
generator, so a step moves nothing between host and card.

Cores:

- ``backend="pallas"``: the fused train-step kernel
  (kernels/mlp.py::fused_train_step), one launch a step; its packed
  gradients go back to the field through the differentiable pack.
  Hierarchical: two launches, as JAX ``train/step.py`` runs them: the
  coarse net at Nc stratified samples with the weights output, which
  ``importance_ts`` turns into Nf samples; then the fine net at the
  sorted union of Nc + Nf. The loss is the sum of the two passes', and
  each pass's gradients go back to its own net. Proposal: one launch, as
  JAX's fused proposal core runs it: the proposal net's weights at Np
  stratified probes (plain torch, under autograd) place Nf importance
  samples; the main field at them with the weights output; the
  interlevel loss of the proposal weights against those (detached by
  construction) trains the proposal net. ``distortion_loss_weight > 0``
  runs in the kernel (its distortion rail): on the single net, on the
  hierarchical fine pass, and on the proposal scheme's main field, in the
  launch that also gives the weights. Mip (``mip_fused_loss``): the
  stratified draw is Nf + 1 interval edges, and B1 runs its cone-cast
  variant (the integrated encoder, interval compositing, the per-ray loss
  weight): once a step at ``mip_levels: 1`` (with the interval form of the
  rail under ``distortion_loss_weight``), twice at ``mip_levels: 2``, both
  launches on the same packed weights: the coarse level with the weights
  output, from which ``resample_edges`` draws the fine level's edges; the
  loss and the gradients are ``mip_coarse_weight`` times the coarse
  level's plus the fine level's. Mip x proposal (``mip_proposal_fused_loss``,
  mip-NeRF 360's composition): Np + 1 stratified probe edges, the proposal
  net's interval weights over them (under autograd), ``resample_edges`` of
  them, detached and annealed, to Nf + 1 fine edges, and one cone-cast B1
  launch there with the weights output, the interval rail and the opaque
  tail; the interval interlevel loss trains the proposal net;
- ``backend="xla"``, or ``fused=False``: autograd over ``render_rays``
  (``render_rays_hierarchical``) and the loss JAX's ``loss_fn`` builds:
  the MSE (of both nets' colours), ``depth_loss_weight`` times the masked
  depth L2 (of both nets), ``distortion_loss_weight`` times the
  distortion in s-space (of the fine net's weights at the union);
  proposal: ``render_rays_proposal``, the MSE, ``proposal_loss_weight``
  times the interlevel loss on the main field's detached weights, the
  depth term and the distortion at the main field's samples (under mip
  their interval forms at the fine edges); mip:
  ``render_rays_mip`` at both levels, the loss weighted as the fused
  core's, the interval distortion. Under ``backend="pallas"`` that
  renders through ``fused_mlp`` (its mip variant under mip), whose
  backward is the fused backward kernel. This is the JAX package's path for what
  its single kernel does not take: ``sigma_noise > 0`` or
  ``depth_loss_weight > 0`` choose it by default, with JAX's warning, and
  ``fused=True`` with either raises. ``sigma_noise`` noises raw sigma in
  the single-net render; the hierarchical and proposal renders apply
  none, as in JAX (which still leaves its fused kernel for them).

Pose refinement (``pose_opt``, BARF): the state also holds per-image
camera deltas (``CamDeltas``, the JAX ``params["cams"]``) on a second
Adam group with its own schedule (lr 0 through ``pose_warmup``). A step
refines its sampled rays by their images' deltas (``apply_cam_deltas``)
and takes the autograd path through ``fused_mlp``, whose input rows then
carry a gradient: B2 also gives the gradient of the kernel's input rows, which autograd
carries through ray generation into the delta tables; under
``pe_anneal_until`` the encoder's anneal windows ride the forward and B2.
Under mip (one or two levels) B2's input gradient is the integrated
encoder's transpose, d/d(mean, direction, variance), which autograd carries
through ``frustum_gaussians_T`` into the deltas (no anneal: JAX's rule).
With proposal sampling the main field's ray gradient comes from B2 the same
way (the anneal on the main field only; under mip x proposal B2's mip input
gradient, a contracted model's included) and the proposal MLP's from plain
autograd through its probe positions.
The fused train step (B1) does not take it (JAX's rule); it takes over
after ``freeze_pose_state``, once the deltas are baked into the ray set
(the mip and proposal forms of B1 too).

Appearance codes (``appearance_dim``, NeRF-W): the state also holds a
per-image code table (``AppCodes``, the JAX ``params["app"]``), zero at
the start, on a third Adam group ("app") on the main schedule. A step
gathers its rays' codes (after the pose deltas, when both train) and
takes the same autograd path through ``fused_mlp``: the codes ride the
kernels' input rows 8..15, B2's input gradient gives their rows of dx,
and autograd carries those through the gather into the table (JAX's
``pallas_aux`` path). B1 has no slot for codes.

Occupancy (``occupancy``, ops/occupancy.py): the state also holds the
(occ_R)^3 grid, all ones at the start. A step whose count is a multiple of
``occ_update_every`` first refreshes it from the field's pre-step weights
(the fine field of a pair; ``density_fn``: the forward kernel under
``"pallas"``), then draws its samples from it (``occupancy_ts``) in place
of the stratified draw: the single net's Nf, the hierarchical coarse
pass's Nc, the proposal probes' Np, on every core. Under pose refinement
they are drawn from the refined rays, as JAX's ``loss_fn`` draws them.

``debug_nan`` (utils/guards.py, the part of JAX's ``checkify``): each step
checks its loss and every gradient before Adam and every parameter after
it, and runs under ``torch.autograd.detect_anomaly``; the first NaN or Inf
raises, naming the tensor and the step. Off, the step has no check.
"""

from __future__ import annotations

import dataclasses
import math
import warnings

import torch
from torch import nn

from nerf_simple_tpu_torch.config import TrainConfig
from nerf_simple_tpu_torch.kernels.mlp import fused_train_step, pack_weights
import numpy as np

from nerf_simple_tpu_torch.models.nerf import NerfField, NerfMLP, NerfPair, init_nerf_params
from nerf_simple_tpu_torch.models.proposal import (
    ProposalField,
    ProposalPair,
    init_proposal_params,
    proposal_from_train_config,
    proposal_weights,
    proposal_weights_intervals,
)
from nerf_simple_tpu_torch.ops.occupancy import density_fn, init_occ_grid, occupancy_ts, update_occ_grid
from nerf_simple_tpu_torch.ops.rays import apply_cam_deltas
from nerf_simple_tpu_torch.ops.sampling import (
    anneal_weights,
    frustum_gaussians_T,
    importance_ts,
    merge_sorted,
    resample_edges,
    stratified_ts_spaced,
)
from nerf_simple_tpu_torch.ops.volume import (
    CompositeOut,
    distortion_loss,
    distortion_loss_intervals,
    interlevel_loss,
    interlevel_loss_intervals,
    s_norm,
)
from nerf_simple_tpu_torch.render.renderer import (
    RenderSettings,
    derive_seed,
    render_rays,
    render_rays_hierarchical,
    render_rays_mip,
    render_rays_proposal,
)
from nerf_simple_tpu_torch.utils.guards import finite_guard


def lr_schedule(cfg: TrainConfig):
    """(lr0, decay): the learning rate of update i is lr0 * decay**i."""
    lr0 = cfg.lr_init if cfg.honor_lr_init else 5e-4  # train.py:43 quirk
    return lr0, math.exp(math.log(cfg.lr_final / cfg.lr_init) / cfg.num_iters)


def pose_lr(cfg: TrainConfig, step: int) -> float:
    """The pose deltas' learning rate at update ``step`` (JAX
    ``pose_schedule``): 0 through ``pose_warmup``, then ``pose_lr_init *
    pose_decay**step`` counted from the start, ``pose_decay = exp(ln(
    pose_lr_final / pose_lr_init) / num_iters)``."""
    if step < cfg.pose_warmup:
        return 0.0
    return cfg.pose_lr_init * math.exp(math.log(cfg.pose_lr_final / cfg.pose_lr_init) / cfg.num_iters) ** step


class CamDeltas(nn.Module):
    """Per-train-image camera deltas (the JAX ``params["cams"]``): ``dr``,
    axis-angle rotations about the camera centres, and ``dt``, world
    translations, each (n_images, 3), zero (the identity) at the start."""

    def __init__(self, n_images: int, device=None):
        super().__init__()
        self.dr = nn.Parameter(torch.zeros((n_images, 3), dtype=torch.float32, device=device))
        self.dt = nn.Parameter(torch.zeros((n_images, 3), dtype=torch.float32, device=device))

    def tables(self) -> dict:
        """The JAX ``{"dr", "dt"}`` pytree, numpy."""
        return {"dr": self.dr.detach().cpu().numpy().copy(), "dt": self.dt.detach().cpu().numpy().copy()}

    def copy_tables_(self, tables: dict) -> "CamDeltas":
        with torch.no_grad():
            for k in ("dr", "dt"):
                getattr(self, k).copy_(torch.as_tensor(np.asarray(tables[k], np.float32)))
        return self


class AppCodes(nn.Module):
    """Per-train-image appearance codes (the JAX ``params["app"]``): a
    (n_images, appearance_dim) table, zero at the start (a no-op code: the
    photometric gradient breaks the symmetry)."""

    def __init__(self, n_images: int, dim: int, device=None):
        super().__init__()
        self.table = nn.Parameter(torch.zeros((n_images, dim), dtype=torch.float32, device=device))

    def tables(self) -> np.ndarray:
        """The JAX ``params["app"]`` array, numpy."""
        return self.table.detach().cpu().numpy().copy()

    def copy_tables_(self, table) -> "AppCodes":
        with torch.no_grad():
            self.table.copy_(torch.as_tensor(np.asarray(table, np.float32)))
        return self


def make_optimizer(cfg: TrainConfig, params, cams: CamDeltas | None = None,
                   app: AppCodes | None = None) -> torch.optim.Adam:
    """Adam over ``params``; with ``cams``, the deltas in a second param
    group ("cams") on the pose schedule (the JAX ``multi_transform``: its
    moments and step count update through the warmup, at lr 0); with
    ``app``, the appearance codes in a group ("app") on the main schedule
    (JAX train/step.py:127-131)."""
    lr0, _ = lr_schedule(cfg)
    groups = [{"params": list(params), "name": "field"}]
    if cams is not None:
        groups.append({"params": list(cams.parameters()), "name": "cams", "lr": pose_lr(cfg, 0)})
    if app is not None:
        groups.append({"params": list(app.parameters()), "name": "app"})
    return torch.optim.Adam(groups, lr=lr0, betas=(0.9, 0.999), eps=1e-8)


@dataclasses.dataclass
class TrainState:
    """The field (a ``NerfPair`` when hierarchical, a ``ProposalPair`` with
    proposal sampling), its optimizer, the
    step count and the generator that draws batches and samples, on the
    training device; with ``pose_opt`` (until a freeze) the camera deltas
    ``cams``; with ``appearance_dim`` the appearance codes ``app``; with
    ``occupancy`` the (occ_R)^3 occupancy grid ``occ``."""

    field: NerfField | NerfPair | ProposalPair
    optimizer: torch.optim.Adam
    generator: torch.Generator
    step: int = 0
    cams: CamDeltas | None = None
    app: AppCodes | None = None
    occ: torch.Tensor | None = None


def make_train_state(cfg: TrainConfig, model: NerfMLP, device, n_images: int | None = None) -> TrainState:
    """Weights from the numpy seed ``cfg.seed`` (the JAX package draws
    them from a JAX key: the two inits differ), generator seeded alike.
    Hierarchical: the coarse and fine nets from ``derive_seed(cfg.seed,
    0)`` and ``derive_seed(cfg.seed, 1)``; proposal: the proposal net and
    the main field alike; one Adam over both. ``pose_opt`` and
    ``appearance_dim`` need ``n_images`` (train images: the delta and code
    tables' rows)."""
    if cfg.hierarchical:
        field = NerfPair(*(NerfField.from_jax_params(init_nerf_params(derive_seed(cfg.seed, k), model),
                                                     device, model) for k in (0, 1)))
    elif cfg.proposal:
        prop_model = proposal_from_train_config(cfg)
        field = ProposalPair(
            ProposalField.from_jax_params(init_proposal_params(derive_seed(cfg.seed, 0), prop_model), device,
                                          prop_model),
            NerfField.from_jax_params(init_nerf_params(derive_seed(cfg.seed, 1), model), device, model))
    else:
        field = NerfField.from_jax_params(init_nerf_params(cfg.seed, model), device, model)
    if (cfg.pose_opt or cfg.appearance_dim > 0) and n_images is None:
        raise ValueError("pose_opt / appearance_dim need n_images (rows of the per-image delta/code tables); "
                         "train() passes the train-split image count")
    cams = CamDeltas(n_images, device) if cfg.pose_opt else None
    app = AppCodes(n_images, cfg.appearance_dim, device) if cfg.appearance_dim > 0 else None
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed)
    occ = init_occ_grid(cfg.occ_R, device) if cfg.occupancy else None
    return TrainState(field, make_optimizer(cfg, field.parameters(), cams, app), gen, cams=cams, app=app, occ=occ)


def freeze_pose_state(state: TrainState) -> TrainState:
    """Drop the camera deltas (JAX ``freeze_pose_state``, at
    ``pose_freeze_at``): a state of the bare field whose Adam is the plain
    field optimizer, with the field's moments and step counts carried
    over, so its trajectory runs on across the freeze. Bake the deltas
    into the ray set first (``bake_cam_deltas``): dropping them unbaked
    un-refines the rig."""
    old = state.optimizer
    params = list(state.field.parameters())
    opt = torch.optim.Adam(params, lr=old.param_groups[0]["lr"], betas=(0.9, 0.999), eps=1e-8)
    for p in params:
        if p in old.state:
            opt.state[p] = old.state[p]
    return TrainState(state.field, opt, state.generator, state.step, occ=state.occ)


def build_x16(rays_b: torch.Tensor, ts: torch.Tensor, pix_b: torch.Tensor) -> torch.Tensor:
    """The fused step's (16, B*N) input: sample xyz along the unnormalised
    direction, unit dirs, ts, and the gt colour on every sample."""
    B, N = ts.shape
    oT, dT = rays_b[:, :3].T, rays_b[:, 3:6].T
    x = torch.zeros((16, B, N), dtype=torch.float32, device=rays_b.device)
    x[0:3] = oT[:, :, None] + dT[:, :, None] * ts[None]
    x[3:6] = (dT / torch.linalg.vector_norm(dT, dim=0, keepdim=True))[:, :, None]
    x[6] = ts
    x[8:11] = pix_b.T[:, :, None]
    return x.reshape(16, B * N)


def build_x16_mip(rays_b: torch.Tensor, edges: torch.Tensor, pix_b: torch.Tensor, base_radius,
                  shape: str = "cone") -> torch.Tensor:
    """The fused step's (16, B*N) input under mip (JAX ``_build_x16_mip``)
    at (B, N + 1) interval ``edges``: the frustum Gaussians' means in rows
    0..2, unit dirs 3..5, the interval widths 6, their near edges t0 7,
    the gt colour 8..10, the diagonal variances 11..13, the ray's loss
    weight 14. 8-column rays (multiscale training) carry their own cone
    radius in column 6 and their loss weight in column 7; 6-column rays
    take the scalar ``base_radius`` and weight 1."""
    B, N = edges.shape[0], edges.shape[1] - 1
    per_ray = rays_b.shape[1] >= 8
    meanT, unitT, varT, _ = frustum_gaussians_T(rays_b, edges, rays_b[:, 6:7] if per_ray else base_radius, shape)
    t0, t1 = edges[:, :-1], edges[:, 1:]
    x = torch.zeros((16, B, N), dtype=torch.float32, device=rays_b.device)
    x[0:3] = meanT
    x[3:6] = unitT[:, :, None]
    x[6] = t1 - t0
    x[7] = t0
    x[8:11] = pix_b[:, :3].T[:, :, None]
    x[11:14] = varT
    x[14] = rays_b[:, 7:8] if per_ray else 1.0
    return x.reshape(16, B * N)


def mip_fused_loss(field: NerfField, rays_b, pix_b, edges, generator, compute_dtype, model: NerfMLP,
                   base_radius, mip_levels: int = 1, coarse_weight: float = 0.1, blur: float = 0.01,
                   opaque_tail: bool = False, dist: tuple | None = None,
                   edges_fine: torch.Tensor | None = None) -> torch.Tensor:
    """The fused mip core (JAX train/step.py, its mip core): B1's cone-cast
    variant at the (B, N + 1) stratified ``edges``, with ``dist`` (its
    interval form) and ``opaque_tail``. At ``mip_levels: 2`` the same
    packed weights serve both levels: the coarse launch with the weights
    output (which carries no gradient: the stop-gradient on the
    resampling), the fine edges that ``resample_edges`` draws from it
    (from ``generator``; or the ``edges_fine`` given), the fine launch
    there; the loss is
    ``coarse_weight * loss_c + loss_f``, and the gradients the same sum of
    the two launches', taken to the field through one differentiable
    pack. Returns the loss."""
    N = edges.shape[1] - 1
    wts = pack_weights(field, differentiable=True)

    def launch(e, **kw):
        return fused_train_step(wts, build_x16_mip(rays_b, e, pix_b, base_radius), N, compute_dtype, model,
                                mip=True, opaque_tail=opaque_tail, **kw)

    if mip_levels == 2:
        loss_c, dw_c, w_c = launch(edges, out_weights=True)
        if edges_fine is None:
            edges_fine = resample_edges(generator, edges, w_c, N, blur=blur)
        loss_f, dw_f = launch(edges_fine)
        torch.autograd.backward(list(wts), [coarse_weight * a + b for a, b in zip(dw_c, dw_f)])
        return coarse_weight * loss_c + loss_f
    loss, dwts = launch(edges, dist=dist)
    torch.autograd.backward(list(wts), list(dwts))
    return loss


def fused_loss(field: NerfField, rays_b, pix_b, ts, compute_dtype, model: NerfMLP, out_weights=False,
               dist: tuple | None = None):
    """One launch of the fused train step at the (B, N) ``ts`` (with the
    distortion rail ``dist``, as ``fused_train_step`` takes it): (loss[,
    the compositing weights (B, N) with ``out_weights``]); the gradients go
    back to ``field`` through the differentiable pack."""
    wts = pack_weights(field, differentiable=True)
    loss, dwts, *w = fused_train_step(wts, build_x16(rays_b, ts, pix_b), ts.shape[1], compute_dtype,
                                      model, out_weights, dist)
    torch.autograd.backward(list(wts), list(dwts))
    return (loss, *w)


def hierarchical_fused_loss(pair: NerfPair, rays_b, pix_b, ts_c, generator, N_fine: int, compute_dtype,
                            model: NerfMLP, det_fine: bool = False, dist: tuple | None = None) -> torch.Tensor:
    """The two fused passes of a hierarchical step (JAX train/step.py, the
    hierarchical fused core): the coarse net at the stratified ``ts_c``
    with the weights output; ``N_fine`` importance samples from them
    (drawn from ``generator``, or the quantiles with ``det_fine``); the
    fine net at the sorted union, with the distortion rail ``dist``.
    Returns loss_c + loss_f; each pass's gradients go to its own net."""
    loss_c, w_c = fused_loss(pair.coarse, rays_b, pix_b, ts_c, compute_dtype, model, out_weights=True)
    ts_all = merge_sorted(ts_c, importance_ts(generator, ts_c, w_c, N_fine, det=det_fine))
    return loss_c + fused_loss(pair.fine, rays_b, pix_b, ts_all, compute_dtype, model, dist=dist)[0]


def proposal_fused_loss(pair: ProposalPair, rays_b, pix_b, ts_p, generator, N_fine: int, compute_dtype,
                        model: NerfMLP, loss_weight: float = 1.0, anneal: float | None = None,
                        dist: tuple | None = None, ts_f: torch.Tensor | None = None):
    """The fused proposal core (JAX train/step.py, its point form): the
    proposal weights at the (B, Np) probes ``ts_p``, under autograd;
    ``N_fine`` importance samples of them, detached and annealed by
    ``anneal`` (drawn from ``generator``, or the ``ts_f`` given); one launch of the fused train step on the main
    field there, with the weights output and the distortion rail
    ``dist``; the interlevel loss of the proposal weights against the
    kernel's (which carry no gradient). The main field's gradients come
    from the kernel, the proposal net's from ``loss_weight`` times the
    interlevel loss. Returns (loss_mse + loss_weight * interlevel, the
    main field's (B, N_fine) weights)."""
    w_prop = proposal_weights(pair.prop, rays_b, ts_p, compute_dtype)
    if ts_f is None:
        ts_f = importance_ts(generator, ts_p, anneal_weights(w_prop.detach(), anneal), N_fine)
    loss_mse, w_f = fused_loss(pair.fine, rays_b, pix_b, ts_f, compute_dtype, model, out_weights=True, dist=dist)
    il = interlevel_loss(w_f, ts_f, w_prop, ts_p)
    (loss_weight * il).backward()
    return loss_mse + loss_weight * il.detach(), w_f


def mip_proposal_fused_loss(pair: ProposalPair, rays_b, pix_b, edges_p, generator, N_fine: int, compute_dtype,
                            model: NerfMLP, base_radius, loss_weight: float = 1.0, anneal: float | None = None,
                            blur: float = 0.01, opaque_tail: bool = False, dist: tuple | None = None,
                            edges_f: torch.Tensor | None = None):
    """The fused mip x proposal core (JAX train/step.py:813-885, mip-NeRF
    360's composition): the proposal net's interval weights over the (B,
    Np + 1) probe edges ``edges_p``, under autograd; ``N_fine + 1`` fine
    edges resampled from them, detached and annealed by ``anneal`` (drawn
    from ``generator``, or the ``edges_f`` given); one cone-cast launch of
    the fused train step on the main field there, with the weights output,
    the interval rail ``dist`` and ``opaque_tail``; the interval interlevel
    loss of the proposal weights against the kernel's (which carry no
    gradient) at the fine midpoints. The main field's gradients come from
    the kernel, the proposal net's from ``loss_weight`` times the interlevel
    loss. Returns (loss_mse + loss_weight * interlevel, the main field's
    (B, N_fine) interval weights)."""
    w_prop = proposal_weights_intervals(pair.prop, rays_b, edges_p, compute_dtype, opaque_tail)
    if edges_f is None:
        edges_f = resample_edges(generator, edges_p, anneal_weights(w_prop.detach(), anneal), N_fine, blur=blur)
    wts = pack_weights(pair.fine, differentiable=True)
    loss_mse, dwts, w_f = fused_train_step(wts, build_x16_mip(rays_b, edges_f, pix_b, base_radius), N_fine,
                                           compute_dtype, model, out_weights=True, dist=dist, mip=True,
                                           opaque_tail=opaque_tail)
    torch.autograd.backward(list(wts), list(dwts))
    il = interlevel_loss_intervals(w_f, 0.5 * (edges_f[:, 1:] + edges_f[:, :-1]), w_prop, edges_p, opaque_tail)
    (loss_weight * il).backward()
    return loss_mse + loss_weight * il.detach(), w_f


def _prop_anneal(cfg: TrainConfig, step: int) -> float | None:
    """The placement anneal's exponent at ``step`` (JAX ``_prop_anneal``):
    a ramp 0 -> 1 over the first ``prop_anneal_frac * num_iters`` steps,
    in f32 as JAX computes it; None when the anneal is off."""
    if cfg.prop_anneal_frac <= 0:
        return None
    return float(np.clip(np.float32(step) / np.float32(cfg.prop_anneal_frac * cfg.num_iters), 0.0, 1.0))


def _s_norm(cfg: TrainConfig, ts: torch.Tensor) -> torch.Tensor:
    """Sample distances in the config's sampling parametrisation, s in
    [0, 1] (JAX ``_s_norm``): where the distortion loss is measured."""
    return s_norm(ts, cfg.tn, cfg.tf, cfg.sampling_space == "disparity")


def _depth_term(out: CompositeOut, gt_d: torch.Tensor) -> torch.Tensor:
    """Masked L2 on the expected depth (JAX ``_depth_term``): rays whose
    gt depth is not finite or <= 0 (holes) add nothing; the mean is over
    the valid rays. A hole's gt is replaced before the difference, so it
    adds no NaN to the gradient either."""
    valid = torch.isfinite(gt_d) & (gt_d > 0)
    sq = torch.where(valid, (out.depth - torch.where(valid, gt_d, 0.0)) ** 2, 0.0)
    return torch.sum(sq) / torch.clamp(torch.sum(valid), min=1)


def kernel_refusal(cfg: TrainConfig) -> str | None:
    """Why the fused train kernel does not take ``cfg`` (JAX's reasons), or
    None: its backward is the MSE's (and the distortion rail's) alone, and
    it gives no gradient to the rays or to appearance codes (pose
    refinement's and appearance's path is autograd through ``fused_mlp``
    with the input gradient)."""
    if cfg.pose_opt:
        return "pose_opt (the camera deltas train through B2's input gradient)"
    if cfg.appearance_dim > 0:
        return "appearance_dim > 0 (the codes train through B2's input gradient)"
    if cfg.sigma_noise != 0.0:
        return "sigma_noise > 0"
    if cfg.depth_loss_weight > 0:
        return "depth_loss_weight > 0 (the fused kernel's backward is MSE-only)"
    return None


def anneal_alpha(cfg: TrainConfig, step: int) -> float | None:
    """BARF's anneal progress at ``step`` (JAX ``loss_fn``: clip(step /
    pe_anneal_until, 0, 1) in f32), or None when the anneal is off or done
    (at 1 every window is exactly 1: the standard encoder, which the
    kernels then run without windows)."""
    if cfg.pe_anneal_until <= 0:
        return None
    alpha = float(np.clip(np.float32(step) / np.float32(cfg.pe_anneal_until), 0.0, 1.0))
    return alpha if alpha < 1.0 else None


def autograd_loss(cfg: TrainConfig, field: NerfField | NerfPair | ProposalPair, rays_b, pix_b, ts, generator,
                  settings: RenderSettings, det_fine: bool = False, noise=None,
                  prop_anneal: float | None = None, edges_fine: torch.Tensor | None = None,
                  cams: CamDeltas | None = None, im_b: torch.Tensor | None = None,
                  enc_alpha: float | None = None, app: AppCodes | None = None, occ_sampler=None) -> torch.Tensor:
    """The differentiable loss of one batch at the stratified ``ts``, as
    JAX's ``loss_fn`` builds it: the raw-colour MSE (train.py:52), plus
    ``depth_loss_weight`` times ``_depth_term`` (the metric depth is
    ``pix_b``'s 4th channel), plus ``distortion_loss_weight`` times the
    distortion of the weights at ``_s_norm`` of the ts. Hierarchical: the
    standard NeRF loss (paper eqn. 6), both heads to gt, the depth term on
    both, the distortion on the fine net's weights at the union (what
    eval renders). Proposal (``ts`` are the probes): the MSE of the main
    field, ``proposal_loss_weight`` times the interlevel loss of the
    proposal weights against the main field's detached ones, the depth
    term, the distortion of the main field's weights at its samples; the
    placement annealed by ``prop_anneal`` (and the main field's encoder by
    ``enc_alpha``); under mip (``ts`` are the Np + 1 probe edges) the
    interval interlevel loss at the fine midpoints and the interval
    distortion at the fine edges (JAX :505-539). Mip (``ts`` are the Nf + 1
    interval edges): ``render_rays_mip``, the MSE, ``mip_coarse_weight``
    times the coarse level's plus the fine level's at ``mip_levels: 2``
    (the fine edges resampled, or ``edges_fine``), the depth term of the
    last level, the interval distortion at ``mip_levels: 1``; with
    8-column rays (multiscale training) each ray's squared error weighed by
    its column 7 and its cone by its column 6. ``generator`` draws the importance samples (the quantiles with
    ``det_fine``) and the sigma noise (or ``noise``, a (B, N) standard
    normal, is taken; under mip it is always drawn). Pose refinement: the
    rays refined by the deltas ``cams`` of their images ``im_b`` first (the
    loss then reaches the tables through ray generation; under mip through
    the frustum Gaussians of both levels, the fine edges resampled from the
    detached coarse weights), and the point renders annealed by
    ``enc_alpha`` (the proposal scheme's main field only). Appearance
    codes: each ray's image's row of ``app`` (gathered after the pose
    deltas, JAX ``loss_fn``) conditions both hierarchical nets, or the
    proposal scheme's main field, or the single net. ``occ_sampler``: with
    ``ts`` None, the occupancy sampler, a function of the (refined) batch
    rays to their ts."""
    if cams is not None:
        rays_b = apply_cam_deltas(rays_b, cams.dr[im_b], cams.dt[im_b])
    if ts is None:
        ts = occ_sampler(rays_b)
    app_b = None if app is None else app.table[im_b]
    gt_d = None
    if cfg.depth_loss_weight > 0:
        pix_b, gt_d = pix_b[:, :3], pix_b[:, 3]

    def mse(rgb):
        return torch.mean((rgb - pix_b) ** 2)

    def mip_mse(rgb):  # multiscale: the footprint-area loss weight rides ray column 7 (JAX :557-560, :587-589)
        return torch.mean(rays_b[:, 7:8] * (rgb - pix_b) ** 2) if rays_b.shape[1] >= 8 else mse(rgb)

    if cfg.proposal:
        out, (ts_p, w_prop, ts_f) = render_rays_proposal(field, rays_b, generator, settings, det_fine=det_fine,
                                                         ts_prop=ts, return_aux=True, prop_anneal=prop_anneal,
                                                         app=app_b, enc_alpha=enc_alpha)
        if cfg.mip:  # the interval forms, at the fine edges ts_f
            il = interlevel_loss_intervals(out.weights.detach(), 0.5 * (ts_f[:, 1:] + ts_f[:, :-1]), w_prop, ts_p,
                                           cfg.opaque_background)
        else:
            il = interlevel_loss(out.weights.detach(), ts_f, w_prop, ts_p)
        loss = mse(out.rgb) + cfg.proposal_loss_weight * il
        if gt_d is not None:
            loss = loss + cfg.depth_loss_weight * _depth_term(out, gt_d)
        if cfg.distortion_loss_weight > 0:
            loss = loss + cfg.distortion_loss_weight * (
                distortion_loss_intervals(out.weights, _s_norm(cfg, ts_f), opaque_tail=cfg.opaque_background)
                if cfg.mip else distortion_loss(out.weights, _s_norm(cfg, ts_f)))
        return loss
    if cfg.mip:
        outs = render_rays_mip(field, rays_b, generator, settings, edges=ts, edges_fine=edges_fine,
                               return_coarse=True)
        if cfg.mip_levels == 2:
            out = outs[1]
            loss = cfg.mip_coarse_weight * mip_mse(outs[0].rgb) + mip_mse(out.rgb)
        else:
            out = outs
            loss = mip_mse(out.rgb)
        if gt_d is not None:
            loss = loss + cfg.depth_loss_weight * _depth_term(out, gt_d)
        if cfg.distortion_loss_weight > 0:
            loss = loss + cfg.distortion_loss_weight * distortion_loss_intervals(
                out.weights, _s_norm(cfg, ts), opaque_tail=cfg.opaque_background)
        return loss

    if cfg.hierarchical:
        coarse, fine, (_, ts_all) = render_rays_hierarchical(field.coarse, field.fine, rays_b, generator, settings,
                                                             det_fine=det_fine, ts_coarse=ts, return_ts=True,
                                                             enc_alpha=enc_alpha, app=app_b)
        loss = mse(coarse.rgb) + mse(fine.rgb)
        if gt_d is not None:
            loss = loss + cfg.depth_loss_weight * (_depth_term(coarse, gt_d) + _depth_term(fine, gt_d))
        if cfg.distortion_loss_weight > 0:
            loss = loss + cfg.distortion_loss_weight * distortion_loss(fine.weights, _s_norm(cfg, ts_all))
        return loss
    out = render_rays(field, rays_b, generator, settings, ts=ts, noise=noise, enc_alpha=enc_alpha, app=app_b)
    loss = mse(out.rgb)
    if gt_d is not None:
        loss = loss + cfg.depth_loss_weight * _depth_term(out, gt_d)
    if cfg.distortion_loss_weight > 0:
        loss = loss + cfg.distortion_loss_weight * distortion_loss(out.weights, _s_norm(cfg, ts))
    return loss


def render_settings(cfg: TrainConfig, base_radius: float = 0.0) -> RenderSettings:
    """The training render's settings (the sigma noise with them; under
    mip the cone radius ``base_radius`` and the mip keys; the occupancy
    sampler's, for renders given the grid)."""
    return RenderSettings(
        N=cfg.Nf, N_coarse=cfg.Nc if cfg.hierarchical else 0, N_prop=cfg.Np if cfg.proposal else 0,
        tn=cfg.tn, tf=cfg.tf,
        sampling_space=cfg.sampling_space, compute_dtype=cfg.render_dtype, backend=cfg.backend,
        sigma_noise=cfg.sigma_noise, mip=cfg.mip, base_radius=base_radius if cfg.mip else 0.0,
        mip_levels=cfg.mip_levels, resample_blur=cfg.resample_blur, opaque_background=cfg.opaque_background,
        occ_Nb=cfg.occ_Nb, occ_floor=cfg.occ_floor, occ_aabb=cfg.occ_aabb,
    )


def build_train_step(cfg: TrainConfig, model: NerfMLP, fused: bool | None = None, base_radius: float = 0.0,
                     rays_per_image: int | None = None):
    """``step_fn(state, rays, pixels) -> loss``: one iteration on the
    resident ray set, the loss left on the device (no sync). With
    ``depth_loss_weight > 0``, ``pixels`` carries the metric depth as a
    4th channel (train/loop.py packs it). Under mip, ``base_radius`` is
    the frame's cone radius a unit of t, ``2 / sqrt(12) / focal`` (the
    loop passes it). ``pose_opt`` and ``appearance_dim`` need
    ``rays_per_image`` (H * W: ray i belongs to image i // rays_per_image)
    and a state with ``cams`` / ``app``; so does ``train_im_idxs``, whose
    batch is a random image of the list and a random pixel of it for each
    ray (the reference's select_imgs mode). Multiscale training
    (``mip_multiscale``) draws 8-column rays from the pyramid pool, each
    with its cone radius and loss weight."""
    if cfg.mip and base_radius <= 0:
        raise ValueError(
            "cfg.mip=True needs base_radius > 0 (2/sqrt(12)/focal; the train driver passes it automatically)"
        )
    aux = cfg.pose_opt or cfg.appearance_dim > 0
    if cfg.train_im_idxs and rays_per_image is None:
        raise ValueError("cfg.train_im_idxs needs rays_per_image (= H*W) to map image indices to ray rows; train() "
                         "passes it")
    if aux and rays_per_image is None:
        raise ValueError("pose_opt / appearance_dim need rays_per_image (= H*W) to map sampled rays to their "
                         "images; train() passes it")
    refusal = kernel_refusal(cfg)
    if fused is None:
        fused = cfg.backend == "pallas" and refusal is None
    if fused and cfg.backend != "pallas":
        raise ValueError("the fused train step is the pallas backend's")
    if fused and refusal:
        raise ValueError(f"the fused train kernel does not take {refusal}; build the step with "
                         "fused=None or fused=False (autograd through fused_mlp)")
    if cfg.backend == "pallas" and not fused and not aux:  # pose's and appearance's path is this one: no warning
        warnings.warn(
            f"backend='pallas' requested but the fused train kernel is ineligible ({refusal}); "
            "falling back to the autodiff path (through fused_mlp) for this step" if refusal else
            "backend='pallas' requested but the fused train kernel is not used "
            "(fused=False); running autograd through fused_mlp instead",
            stacklevel=2,
        )
    settings = render_settings(cfg, base_radius)
    # the stratified draw a ray: coarse samples, proposal probes (their edges under mip), mip's interval edges or
    # the samples
    N_strat = (cfg.Nc if cfg.hierarchical else cfg.Np + cfg.mip if cfg.proposal else cfg.Nf + 1 if cfg.mip
               else cfg.Nf)
    lr0, decay = lr_schedule(cfg)
    dist = ((cfg.distortion_loss_weight, cfg.tn, cfg.tf, cfg.sampling_space == "disparity")
            if cfg.distortion_loss_weight > 0 else None)

    def core(field, rays_b, pix_b, ts, g, anneal, cams=None, im_b=None, enc_alpha=None, app=None, occ_sampler=None):
        """The loss of one batch at the stratified or occupancy ``ts`` (None:
        ``occ_sampler`` draws them from the refined rays), gradients left in
        the fields (and in the camera deltas ``cams`` and the codes
        ``app``); ``g`` draws the importance samples (and the sigma noise);
        ``anneal`` is the proposal's placement anneal, ``enc_alpha``
        BARF's."""
        if fused and cfg.mip and cfg.proposal:  # before the mip core, as JAX dispatches (:813)
            return mip_proposal_fused_loss(field, rays_b, pix_b, ts, g, cfg.Nf, cfg.render_dtype, model, base_radius,
                                           cfg.proposal_loss_weight, anneal, cfg.resample_blur, cfg.opaque_background,
                                           dist=dist)[0]
        if fused and cfg.mip:
            return mip_fused_loss(field, rays_b, pix_b, ts, g, cfg.render_dtype, model, base_radius,
                                  cfg.mip_levels, cfg.mip_coarse_weight, cfg.resample_blur,
                                  cfg.opaque_background, dist=dist)
        if fused and cfg.hierarchical:
            return hierarchical_fused_loss(field, rays_b, pix_b, ts, g, cfg.Nf, cfg.render_dtype, model,
                                           dist=dist)
        if fused and cfg.proposal:
            return proposal_fused_loss(field, rays_b, pix_b, ts, g, cfg.Nf, cfg.render_dtype, model,
                                       cfg.proposal_loss_weight, anneal, dist=dist)[0]
        if fused:
            return fused_loss(field, rays_b, pix_b, ts, cfg.render_dtype, model, dist=dist)[0]

        loss = autograd_loss(cfg, field, rays_b, pix_b, ts, g, settings, prop_anneal=anneal, cams=cams, im_b=im_b,
                             enc_alpha=enc_alpha, app=app, occ_sampler=occ_sampler)
        loss.backward()
        return loss.detach()

    def refresh_occ(state: TrainState) -> torch.Tensor:
        """The EMA refresh of the state's grid from its field's weights (the
        fine field of a pair, which eval renders), jitter from its generator."""
        dp = getattr(state.field, "fine", state.field)
        return update_occ_grid(state.occ, density_fn(dp, cfg.backend, cfg.render_dtype), state.generator,
                               cfg.occ_aabb, decay=cfg.occ_decay)

    def occ_sampler(state: TrainState):
        """The batch rays -> their (B, N_strat) occupancy ts, from the state's
        grid and generator (JAX ``_maybe_occ_ts``)."""
        return lambda r: occupancy_ts(state.generator, r, state.occ, N_strat, cfg.tn, cfg.tf, cfg.occ_aabb,
                                      Nb=cfg.occ_Nb, floor=cfg.occ_floor)

    def guarded(state: TrainState, fn, *args, **kw):
        """``fn`` under ``torch.autograd.detect_anomaly``, its NaN re-raised
        naming the step (``debug_nan``)."""
        try:
            with torch.autograd.detect_anomaly():
                return fn(*args, **kw)
        except RuntimeError as e:
            if "nan" not in str(e).lower():
                raise
            raise FloatingPointError(f"NaN in the backward of step {state.step}: {e}") from e

    def named_tensors(state: TrainState, grads: bool):
        mods = [("", state.field), ("cams.", state.cams), ("app.", state.app)]
        return [(f"{'grad of ' if grads else ''}{pre}{n}", p.grad if grads else p)
                for pre, m in mods if m is not None for n, p in m.named_parameters()]

    def sample_idx(g: torch.Generator, n_rows: int, device) -> torch.Tensor:
        """The batch's ray rows: uniform over the split, or under
        ``train_im_idxs`` a random listed image and a random pixel of it for
        each ray (JAX ``sample_idx``)."""
        B = cfg.batch_size
        if not cfg.train_im_idxs:
            return torch.randint(0, n_rows, (B,), generator=g, device=device)
        listed = torch.tensor(cfg.train_im_idxs, dtype=torch.int64, device=device)
        im = listed[torch.randint(0, len(listed), (B,), generator=g, device=device)]
        return im * rays_per_image + torch.randint(0, rays_per_image, (B,), generator=g, device=device)

    def step_fn(state: TrainState, rays: torch.Tensor, pixels: torch.Tensor) -> torch.Tensor:
        g = state.generator
        if cfg.occupancy and state.step % cfg.occ_update_every == 0:  # before the loss, the pre-step weights
            state.occ = refresh_occ(state)
        idx = sample_idx(g, rays.shape[0], rays.device)
        rays_b, sampler = rays[idx], None
        if not cfg.occupancy:
            ts = stratified_ts_spaced(g, cfg.batch_size, N_strat, cfg.tn, cfg.tf, rays.device,
                                      space=cfg.sampling_space)
        elif cfg.pose_opt:  # drawn from the refined rays, in autograd_loss
            ts, sampler = None, occ_sampler(state)
        else:
            ts = occ_sampler(state)(rays_b)
        state.optimizer.zero_grad(set_to_none=True)
        extras = {}
        if cfg.pose_opt:
            if state.cams is None:
                raise ValueError("pose_opt trains the camera deltas: the state has none (make_train_state with "
                                 "n_images; a frozen state takes the plain config's step)")
            extras = dict(cams=state.cams, enc_alpha=anneal_alpha(cfg, state.step))
        if cfg.appearance_dim > 0:
            if state.app is None:
                raise ValueError("appearance_dim trains the appearance codes: the state has none (make_train_state "
                                 "with n_images)")
            extras["app"] = state.app
        if aux:
            extras["im_b"] = idx // rays_per_image
        if sampler is not None:
            extras["occ_sampler"] = sampler
        args = (state.field, rays_b, pixels[idx], ts, g, _prop_anneal(cfg, state.step))
        if cfg.debug_nan:
            loss = guarded(state, core, *args, **extras)
            finite_guard(state.step, [("loss", loss), *named_tensors(state, grads=True)])
        else:
            loss = core(*args, **extras)
        for group in state.optimizer.param_groups:
            group["lr"] = pose_lr(cfg, state.step) if group.get("name") == "cams" else lr0 * decay**state.step
        state.optimizer.step()
        if cfg.debug_nan:
            finite_guard(state.step, named_tensors(state, grads=False), "after Adam")
        state.step += 1
        return loss

    return step_fn
