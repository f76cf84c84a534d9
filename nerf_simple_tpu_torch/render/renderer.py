"""Ray -> radiance rendering (port of nerf_simple_tpu/render/renderer.py,
the point-sampled path).

``render_rays`` draws stratified ``ts`` and renders through
``_render_at_ts``: under ``backend="pallas"`` the fused MLP (kernels/
mlp.py) on the feature-major ``(8, B*N)`` input, then ``composite_T``
(with gradients enabled, the differentiable ``fused_mlp``, whose backward
is the fused backward kernel); under ``backend="xla"`` the layer-by-layer
``nerf_apply`` oracle, then ``composite``. ``render_rays_chunked`` renders
any number of rays in fixed-size chunks, padding the last chunk with
copies of the last ray; with ``fused_eval`` under ``"pallas"`` each chunk
is one call of the fused render kernel (forward and compositing).
``render_rays_hierarchical`` is the coarse + fine scheme: the coarse
field's weights place importance samples, and the fine field renders the
sorted union; ``render_rays_chunked`` takes that path for a ``NerfPair``
under ``N_coarse > 0``. ``render_rays_proposal`` is mip-NeRF 360's
scheme: the proposal net's weights at ``N_prop`` probes place the main
field's N samples; ``render_rays_chunked`` takes that path for a
``ProposalPair`` under ``N_prop > 0``, and under ``mip`` too, mip-NeRF
360's composition: the proposal's interval histogram over N_prop + 1 probe
edges places the N + 1 edges of the main field's cones.
``render_rays_mip`` is mip-NeRF's cone casting (``mip``): N + 1
stratified edges, the conical frustums between them as Gaussians through
the integrated encoder (under
``"pallas"`` the forward kernel's), interval compositing in torch; with
``mip_levels: 2`` the same field renders a coarse level, whose detached
weights resample the fine level's edges. ``render_rays`` and
``render_rays_chunked`` take that path under ``mip``. Pose refinement:
``enc_alpha`` (the BARF anneal progress) windows the encoder of the point
renders (in the forward kernel under ``"pallas"``), and where the rays
carry a gradient ``fused_mlp`` gives its input rows theirs, which
autograd carries into the rays (and so into the per-image camera deltas).
Appearance codes (``app``, an appearance model's per-ray codes, or one
code for a whole chunked render) condition the colour head of the point
renders: under ``"pallas"`` they ride the kernels' input rows 8..15 (and
their gradients come back in the input gradient's rows 8..15), under
``"xla"`` the query's last columns; a chunked render with a code takes no
fused render kernel.

Eval on top of it: ``render_image`` (one still of a split),
``render_orbit_video`` (frames to ``utils/video.py``) and
``render_normals_chunked`` (density-gradient normals, plain torch with
autograd, as the JAX package forces its XLA path there).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any

import numpy as np
import torch

from nerf_simple_tpu_torch.kernels.mlp import (
    FusedWeights,
    _cast_weights,
    anneal_row_weights,
    fused_mlp,
    fused_mlp_forward,
    fused_render,
    pack_weights,
    supported,
)
from nerf_simple_tpu_torch.models import apply_model, zeros_app_for
from nerf_simple_tpu_torch.models.nerf import NerfField, NerfPair, check_app, nerf_apply_mip
from nerf_simple_tpu_torch.models.proposal import ProposalPair, proposal_weights, proposal_weights_intervals
from nerf_simple_tpu_torch.ops.occupancy import occupancy_ts
from nerf_simple_tpu_torch.ops.rays import rays_for_poses
from nerf_simple_tpu_torch.ops.sampling import (
    anneal_weights,
    conical_gaussian,
    frustum_gaussians_T,
    importance_ts,
    merge_sorted,
    resample_edges,
    sample_points,
    stratified_ts_spaced,
)
from nerf_simple_tpu_torch.ops.volume import CompositeOut, composite, composite_intervals, composite_T


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Render configuration. Defaults mirror the reference (N=128,
    utils/rendering.py:102; tn=2, tf=6, utils/rendering.py:13).

    ``backend``: ``"xla"`` = the plain layer-by-layer torch MLP,
    ``"pallas"`` = the hand-written fused kernel (the JAX package's CLI
    words). ``fused_eval`` routes ``render_rays_chunked`` under
    ``"pallas"`` through the fused render kernel (forward and compositing
    in one call); under ``"xla"`` it changes nothing, and it does not
    apply under ``N_coarse > 0`` or ``N_prop > 0`` (as in JAX).
    ``N_coarse > 0`` renders hierarchically: N_coarse stratified samples,
    then N importance samples. ``N_prop > 0`` renders with the proposal
    scheme: N_prop probes of the proposal net, then N samples of the main
    field from its weights. ``sigma_noise > 0`` (a training regulariser)
    adds ``sigma_noise * N(0, 1)`` to raw sigma before compositing in
    ``render_rays``; the hierarchical and proposal renders apply none, as
    in JAX. ``mip`` casts cones (``render_rays_mip``): ``base_radius`` is
    the cone's radius a unit of t, ``2 / sqrt(12) / focal`` for a pinhole
    frame (the entry points compute it); ``mip_levels: 2`` renders a
    coarse and a fine level with one field, the fine edges resampled with
    ``resample_blur``; ``opaque_background`` makes the last interval
    absorb what is left (mip only). ``mip_shape`` is ``"cone"``: the NDC
    cylinder is not ported. Mip excludes ``N_coarse`` (JAX's rule); mip
    with ``N_prop`` is mip-NeRF 360's composition (``render_rays_proposal``)."""

    N: int = 128
    tn: float = 2.0
    tf: float = 6.0
    sampling_space: str = "linear"  # or "disparity": bins uniform in 1/t
    compute_dtype: Any = torch.float32
    backend: str = "xla"
    N_coarse: int = 0
    N_prop: int = 0
    mip: bool = False
    base_radius: float = 0.0
    mip_levels: int = 1
    mip_shape: str = "cone"
    resample_blur: float = 0.01
    opaque_background: bool = False
    fused_eval: bool = False
    sigma_noise: float = 0.0
    # the occupancy sampler of a chunked render given a grid (``occ``): its
    # probe bins, floor mass and grid extent, and ``occ_group`` adjacent
    # rays a probe (ops/occupancy.py::occupancy_ts)
    occ_Nb: int = 64
    occ_floor: float = 0.01
    occ_aabb: float = 4.0
    occ_group: int = 1

    def __post_init__(self):
        if self.backend not in ("xla", "pallas"):
            raise ValueError(f"backend must be 'xla' or 'pallas', got {self.backend!r}")
        if self.compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be f32 or bf16, got {self.compute_dtype}")
        if self.sigma_noise < 0:
            raise ValueError(f"sigma_noise must be >= 0, got {self.sigma_noise}")
        if self.mip_levels not in (1, 2):
            raise ValueError(f"mip_levels must be 1 or 2, got {self.mip_levels}")
        if self.mip_levels == 2 and not self.mip:
            raise ValueError("mip_levels=2 (coarse+fine cone casting) requires mip=True")
        if self.opaque_background and not self.mip:
            raise ValueError("opaque_background modifies INTERVAL compositing and needs mip=True")
        if self.resample_blur < 0:
            raise ValueError(f"resample_blur must be >= 0, got {self.resample_blur}")
        if self.mip and self.N_coarse > 0:
            raise ValueError(
                "mip rendering excludes hierarchical sampling: cone casting draws its own interval "
                "edges (mip_levels=2 is the cone-cast hierarchical scheme)"
            )
        if self.mip_shape == "cylinder":
            raise NotImplementedError(
                "mip_shape='cylinder' (NDC-warped LLFF rays) is not ported yet: ROADMAP Queue A item 6, LLFF/NDC")
        if self.mip_shape != "cone":
            raise ValueError(f"mip_shape must be 'cone' or 'cylinder', got {self.mip_shape!r}")


def _packed(field: NerfField, dtype) -> FusedWeights:
    """The field's packed (and cast) weights, built once and reused until
    a parameter changes in place (tensor version counters)."""
    key = (dtype, tuple(p._version for p in field.parameters()))
    cache = field.__dict__.setdefault("_fused_weights", {})
    if key not in cache:
        cache.clear()
        cache[key] = _cast_weights(pack_weights(field), dtype)
    return cache[key]


def render_rays(
    field: NerfField,
    rays: torch.Tensor,
    generator: torch.Generator | None,
    settings: RenderSettings = RenderSettings(),
    ts: torch.Tensor | None = None,
    noise: torch.Tensor | None = None,
    enc_alpha: float | None = None,
    app: torch.Tensor | None = None,
) -> CompositeOut:
    """Render (B, 6) ``[origin | direction]`` rays (direction
    unnormalised; under mip also (B, 8) rays with their own cone radius in
    column 6 and a loss weight in column 7) at stratified ``ts`` drawn
    from ``generator``, or at the (B, N) ``ts`` given. ``.rgb`` is raw, like the reference. ``enc_alpha``:
    the BARF anneal progress in [0, 1] of the encoder, or None (the
    standard one). ``app``: (B, app_dim) appearance codes of an appearance
    model's rays (required iff ``app_dim > 0``).

    With ``settings.sigma_noise > 0`` the (B, N) standard normal ``noise``
    given, or else one drawn from ``generator`` after the ts, times
    ``sigma_noise`` is added to raw sigma. At 0 nothing is drawn, so the
    generator's stream and every result stay as without the setting.

    Under ``settings.mip`` it is ``render_rays_mip`` (no ``ts``: the
    cone-cast path draws its own edges; the fine level's output under
    ``mip_levels: 2``)."""
    if settings.mip:
        if ts is not None or noise is not None:
            raise ValueError("mip rendering draws its own interval edges: pass edges to render_rays_mip")
        if enc_alpha is not None:
            raise ValueError("the anneal windows are not plumbed through the integrated encoder (as in JAX)")
        if app is not None:
            raise ValueError("appearance codes are not plumbed through the integrated encoder (as in JAX)")
        return render_rays_mip(field, rays, generator, settings)
    if ts is None:
        ts = stratified_ts_spaced(
            generator, rays.shape[0], settings.N, settings.tn, settings.tf,
            rays.device, rays.dtype, settings.sampling_space,
        )
    if settings.sigma_noise > 0 and noise is None:
        if generator is None:
            raise ValueError("sigma_noise > 0 draws its noise from a generator: pass one, or the noise")
        noise = torch.randn(ts.shape, generator=generator, dtype=ts.dtype, device=ts.device)
    return _render_at_ts(field, rays, ts, settings, noise if settings.sigma_noise > 0 else None, enc_alpha, app)


def render_rays_mip(
    field: NerfField,
    rays: torch.Tensor,
    generator: torch.Generator | None,
    settings: RenderSettings,
    edges: torch.Tensor | None = None,
    edges_fine: torch.Tensor | None = None,
    return_coarse: bool = False,
):
    """Cone-cast rendering (mip-NeRF; JAX ``_render_mip``): N + 1
    stratified edges drawn from ``generator`` (or the (B, N + 1)
    ``edges`` given), the N frustums between them through
    ``_mip_level``. With ``mip_levels: 2`` the same field renders again at
    the fine edges that ``resample_edges`` draws from the coarse level's
    detached weights (or ``edges_fine``), and the fine output is
    returned, with ``return_coarse`` as (coarse, fine). With
    ``sigma_noise > 0`` each level's raw sigma gains ``sigma_noise``
    times a standard normal drawn from ``generator`` after that level's
    edges."""
    B, N = rays.shape[0], settings.N
    if edges is None:
        edges = stratified_ts_spaced(generator, B, N + 1, settings.tn, settings.tf, rays.device,
                                     rays.dtype, settings.sampling_space)

    def level(e):
        noise = None
        if settings.sigma_noise > 0:
            if generator is None:
                raise ValueError("sigma_noise > 0 draws its noise from a generator: pass one")
            noise = torch.randn((B, N), generator=generator, dtype=rays.dtype, device=rays.device)
        return _mip_level(field, rays, e, settings, noise)

    out_c = level(edges)
    if settings.mip_levels < 2:
        return out_c
    if edges_fine is None:
        edges_fine = resample_edges(generator, edges, out_c.weights.detach(), N, blur=settings.resample_blur)
    out_f = level(edges_fine)
    return (out_c, out_f) if return_coarse else out_f


def _mip_level(field: NerfField, rays: torch.Tensor, edges: torch.Tensor, settings: RenderSettings,
               noise: torch.Tensor | None = None) -> CompositeOut:
    """One cone-cast level at the (B, N + 1) ``edges`` (JAX ``_mip_level``):
    the frustum Gaussians through the integrated encoder (under
    ``"pallas"`` the forward kernel's, ``_fused_mlp_bn_mip``; else
    ``nerf_apply_mip``), ``sigma_noise * noise`` on raw sigma, then
    ``composite_intervals`` (with ``opaque_background``'s tail). Rays of
    more than 6 columns (multiscale training's 8) carry their own cone
    radius in column 6, in place of ``settings.base_radius``."""
    B, N = edges.shape[0], edges.shape[1] - 1
    dirs = rays[:, 3:6]
    unit_dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    if settings.backend == "pallas":
        outT, t_mids = _fused_mlp_bn_mip(field, rays, edges, settings)
        out = outT.permute(1, 2, 0)
    else:
        means, vars_, t_mids = conical_gaussian(rays, edges, _cone_radius(rays, settings), settings.mip_shape)
        q = unit_dirs[:, None, :].expand(B, N, 3).reshape(B * N, 3)
        out = nerf_apply_mip(field, means.reshape(B * N, 3), vars_.reshape(B * N, 3), q,
                             settings.compute_dtype).reshape(B, N, 4)
    if noise is not None:
        out = torch.cat([out[..., :3], (out[..., 3] + settings.sigma_noise * noise)[..., None]], dim=-1)
    return composite_intervals(out, edges, t_mids, unit_dirs, opaque_tail=settings.opaque_background)


def _cone_radius(rays: torch.Tensor, settings: RenderSettings):
    """The cone radius a unit of t: the rays' own (B, 1) column 6 where
    they have one (JAX :263), else the settings' scalar."""
    return rays[:, 6:7] if rays.shape[1] >= 7 else settings.base_radius


def _fused_mlp_bn_mip(field: NerfField, rays: torch.Tensor, edges: torch.Tensor,
                      settings: RenderSettings) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel with the integrated encoder over a (B, N)
    interval grid (JAX ``_fused_mlp_bn_mip``): its (16, B*N) input from
    ``frustum_gaussians_T`` (means rows 0..2, unit dirs 3..5, variances
    11..13) -> (channel-major (4, B, N) raw outputs, (B, N) frustum
    centres). With gradients enabled, the differentiable ``fused_mlp``
    (its backward recomputes the same forward: B2's mip variant); where the
    rays carry a gradient (pose refinement), B2's input gradient gives the
    means, directions and variances theirs (the input-gradient kernel's
    mip instantiation), which autograd carries through
    ``frustum_gaussians_T`` to the rays."""
    _require_kernel_arch(field)
    B, N = edges.shape[0], edges.shape[1] - 1
    meanT, unitT, varT, mu_t = frustum_gaussians_T(rays, edges, _cone_radius(rays, settings), settings.mip_shape)
    x = torch.zeros((16, B, N), dtype=torch.float32, device=rays.device)
    x[0:3] = meanT
    x[3:6] = unitT[:, :, None]
    x[11:14] = varT
    x = x.reshape(16, B * N)
    if torch.is_grad_enabled():
        outT = fused_mlp(pack_weights(field, differentiable=True), x, settings.compute_dtype, field.model, mip=True)
    else:
        outT = fused_mlp_forward(_packed(field, settings.compute_dtype), x, settings.compute_dtype, field.model,
                                 mip=True)
    return outT[:4].reshape(4, B, N), mu_t


def render_rays_hierarchical(
    coarse: NerfField,
    fine: NerfField,
    rays: torch.Tensor,
    generator: torch.Generator | None,
    settings: RenderSettings,
    det_fine: bool = False,
    ts_coarse: torch.Tensor | None = None,
    return_ts: bool = False,
    enc_alpha: float | None = None,
    app: torch.Tensor | None = None,
) -> tuple[CompositeOut, CompositeOut]:
    """Coarse + fine rendering (the NeRF paper, sec. 5.2): ``N_coarse``
    stratified samples (or the (B, N_coarse) ``ts_coarse`` given) through
    the coarse field; ``N`` importance samples from its detached weights
    (``det_fine``: the deterministic quantiles); the fine field at the
    sorted union of both, N_coarse + N a ray. Returns (coarse, fine), and
    with ``return_ts`` also ``(ts_coarse, ts_union)``, the ts each render
    composited (the distortion loss reads the union). No sigma noise is
    added, whatever ``settings.sigma_noise`` says, as in JAX. ``enc_alpha``
    anneals both fields' encoders; both take the codes ``app`` (JAX
    render/renderer.py:548, :561)."""
    if settings.N_coarse <= 0:
        raise ValueError("the hierarchical path needs N_coarse > 0")
    ts_c = ts_coarse
    if ts_c is None:
        ts_c = stratified_ts_spaced(
            generator, rays.shape[0], settings.N_coarse, settings.tn, settings.tf,
            rays.device, rays.dtype, settings.sampling_space,
        )
    coarse_out = _render_at_ts(coarse, rays, ts_c, settings, enc_alpha=enc_alpha, app=app)
    ts_f = importance_ts(generator, ts_c, coarse_out.weights.detach(), settings.N, det=det_fine)
    ts_all = merge_sorted(ts_c, ts_f)
    fine_out = _render_at_ts(fine, rays, ts_all, settings, enc_alpha=enc_alpha, app=app)
    if return_ts:
        return coarse_out, fine_out, (ts_c, ts_all)
    return coarse_out, fine_out


def render_rays_proposal(
    pair: ProposalPair,
    rays: torch.Tensor,
    generator: torch.Generator | None,
    settings: RenderSettings,
    det_fine: bool = False,
    ts_prop: torch.Tensor | None = None,
    return_aux: bool = False,
    prop_anneal: float | None = None,
    app: torch.Tensor | None = None,
    enc_alpha: float | None = None,
):
    """Proposal-guided rendering (mip-NeRF 360; JAX ``render_rays_proposal``,
    its point branch): ``N_prop`` stratified probes (or the (B, N_prop)
    ``ts_prop`` given; bin midpoints under ``det_fine``), the proposal
    net's weights there, and the main field ``pair.fine`` at ``N``
    importance samples of those weights, detached and raised to
    ``prop_anneal`` (``anneal_weights``; the deterministic quantiles under
    ``det_fine``). The main field sees only its N samples. With
    ``return_aux`` also ``(ts_prop, w_prop, ts_fine)``, ``w_prop``
    differentiable in the proposal net (the interlevel loss reads them).
    No sigma noise is added, whatever ``settings.sigma_noise`` says, as in
    JAX. The codes ``app`` condition the main field only (JAX
    render/renderer.py:669), and ``enc_alpha`` (BARF's anneal progress)
    anneals the main field's encoder only (JAX :665-670): the proposal
    MLP keeps its own.

    Under ``settings.mip`` it is mip-NeRF 360's composition (JAX
    render/renderer.py:614-645): ``N_prop + 1`` stratified probe edges (or
    the (B, N_prop + 1) ``ts_prop`` given; bin midpoints under
    ``det_fine``), the proposal's interval weights over them
    (``proposal_weights_intervals``, its last interval opaque under
    ``opaque_background``), ``resample_edges`` of those weights, detached
    and annealed, to ``N + 1`` fine edges (the quantiles under
    ``det_fine``), and the main field's cones there (``_mip_level``); with
    ``return_aux`` also ``(probe edges, w_prop, fine edges)``. No windows
    and no codes under mip (as in JAX)."""
    if settings.N_prop <= 0:
        raise ValueError("the proposal path needs N_prop > 0")
    if settings.mip:
        if enc_alpha is not None or app is not None:
            raise ValueError("the anneal windows and appearance codes are not plumbed through the integrated "
                             "encoder (as in JAX)")
        edges_p = ts_prop
        if edges_p is None:
            edges_p = stratified_ts_spaced(generator, rays.shape[0], settings.N_prop + 1, settings.tn, settings.tf,
                                           rays.device, rays.dtype, settings.sampling_space, det=det_fine)
        w_prop = proposal_weights_intervals(pair.prop, rays, edges_p, settings.compute_dtype,
                                            settings.opaque_background)
        edges_f = resample_edges(generator, edges_p, anneal_weights(w_prop.detach(), prop_anneal), settings.N,
                                 blur=settings.resample_blur, det=det_fine)
        out = _mip_level(pair.fine, rays, edges_f, settings)
        return (out, (edges_p, w_prop, edges_f)) if return_aux else out
    ts_p = ts_prop
    if ts_p is None:
        ts_p = stratified_ts_spaced(
            generator, rays.shape[0], settings.N_prop, settings.tn, settings.tf,
            rays.device, rays.dtype, settings.sampling_space, det=det_fine,
        )
    w_prop = proposal_weights(pair.prop, rays, ts_p, settings.compute_dtype)
    ts_f = importance_ts(generator, ts_p, anneal_weights(w_prop.detach(), prop_anneal), settings.N,
                         det=det_fine)
    out = _render_at_ts(pair.fine, rays, ts_f, settings, enc_alpha=enc_alpha, app=app)
    if return_aux:
        return out, (ts_p, w_prop, ts_f)
    return out


def _render_at_ts(
    field: NerfField, rays: torch.Tensor, ts: torch.Tensor, settings: RenderSettings,
    noise: torch.Tensor | None = None, enc_alpha: float | None = None, app: torch.Tensor | None = None,
) -> CompositeOut:
    """Render at the (B, N) ``ts``; with ``noise`` (B, N), raw sigma gains
    ``settings.sigma_noise * noise`` before compositing, on both backends;
    ``enc_alpha`` anneals the encoder; ``app`` (B, app_dim), each ray's
    appearance code, broadcast over its samples (JAX :356-375)."""
    B, N = ts.shape
    if settings.backend == "pallas":
        outT = _fused_mlp_bn(field, rays, ts, settings, enc_alpha, app)
        if noise is not None:
            outT = torch.cat([outT[:3], (outT[3] + settings.sigma_noise * noise)[None]])
        dirs = rays[:, 3:6]
        unit_dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
        return composite_T(outT, ts, unit_dirs)
    locs, unit_dirs = sample_points(rays, ts)
    query = torch.cat([locs, unit_dirs[:, None, :].expand(B, N, 3)], dim=-1).reshape(B * N, 6)
    app_q = None if app is None else app[:, None, :].expand(B, N, app.shape[-1]).reshape(B * N, -1)
    out = apply_model(field, query, settings.compute_dtype, enc_alpha, app_q).reshape(B, N, 4)
    if noise is not None:
        out = torch.cat([out[..., :3], (out[..., 3] + settings.sigma_noise * noise)[..., None]], dim=-1)
    return composite(out, ts, unit_dirs)


def _require_kernel_arch(field: NerfField) -> None:
    """An architecture the kernels do not take raises here; the JAX
    renderer fell back to its XLA path instead."""
    if not supported(field.model):
        raise ValueError(
            f"backend='pallas' needs H % 16 == 0, H >= 16 (got {field.model}); "
            "use backend='xla' for other architectures"
        )


def _kernel_input(rays: torch.Tensor, ts: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The kernels' feature-major input for a (B, N) ray/sample grid:
    rows 0..2 the sample xyz along the unnormalised direction (the
    reference quirk at utils/rendering.py:31-36), rows 3..5 the unit view
    direction; with ``n_rows`` = 16 also row 6 the ts. Other rows zero.
    Differentiable in ``rays``: the unit direction through its
    normalisation."""
    B, N = ts.shape
    oT = rays[:, :3].T
    dT = rays[:, 3:6].T
    unitT = dT / torch.linalg.vector_norm(dT, dim=0, keepdim=True)
    x = torch.zeros((n_rows, B * N), dtype=torch.float32, device=rays.device)
    x[0:3] = (oT[:, :, None] + dT[:, :, None] * ts[None]).reshape(3, B * N)
    x[3:6] = unitT[:, :, None].expand(3, B, N).reshape(3, B * N)
    if n_rows == 16:
        x[6] = ts.reshape(B * N)
    return x


def _fused_mlp_bn(
    field: NerfField, rays: torch.Tensor, ts: torch.Tensor, settings: RenderSettings,
    enc_alpha: float | None = None, app: torch.Tensor | None = None,
) -> torch.Tensor:
    """Fused MLP over a (B, N) ray/sample grid -> channel-major (4, B, N).
    ``enc_alpha`` windows the kernel's encoder (``anneal_row_weights``);
    an appearance model's codes ``app`` (B, app_dim) ride input rows 8..15
    (JAX ``_fused_mlp_bn``, :487-492: each ray's code on its samples, zero
    rows past app_dim). Where the rays or the codes carry a gradient (pose
    refinement, appearance training), the backward gives the input rows
    theirs too (B2's ``want_dx``)."""
    _require_kernel_arch(field)
    model = field.model
    check_app(model, app)
    B, N = ts.shape
    x = _kernel_input(rays, ts, 8)
    if app is not None:
        codes = app.to(torch.float32).T[:, :, None].expand(model.app_dim, B, N).reshape(model.app_dim, B * N)
        x = torch.cat([x, codes, x.new_zeros((8 - model.app_dim, B * N))])
    enc_w = None if enc_alpha is None else anneal_row_weights(field.model, enc_alpha, rays.device)
    if torch.is_grad_enabled():
        wts = pack_weights(field, differentiable=True)
        outT = fused_mlp(wts, x, settings.compute_dtype, field.model, enc_w=enc_w)
    else:
        outT = fused_mlp_forward(
            _packed(field, settings.compute_dtype), x, settings.compute_dtype, field.model, enc_w=enc_w
        )
    return outT[:4].reshape(4, B, N)


def _fused_render_rays(
    field: NerfField, rays: torch.Tensor, ts: torch.Tensor, settings: RenderSettings
) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused render kernel on a (B, N) grid -> (rgb clipped to [0, 1]
    (B, 3), disparity (B,)), as JAX ``_chunked_render_fn.fused_chunk``."""
    _require_kernel_arch(field)
    N = ts.shape[1]
    out = fused_render(_packed(field, settings.compute_dtype), _kernel_input(rays, ts, 16), N,
                       settings.compute_dtype, field.model)
    heads = out[:, ::N]  # (8, B): rgb rows 0..2, depth 3, acc 4
    rgb = torch.clamp(heads[:3].T, 0.0, 1.0)
    disp = 1.0 / torch.clamp(heads[3] / heads[4], min=1e-10)
    return rgb, disp


def derive_seed(seed: int, *idx: int) -> int:
    """A seed for item ``idx`` of a run seeded with ``seed`` (the role of
    ``jax.random.fold_in``): independent of how many items came before."""
    return int(np.random.SeedSequence([seed, *idx]).generate_state(1, np.uint64)[0])


def chunk_generator(seed: int, idx: int, device) -> torch.Generator:
    """The generator of chunk ``idx``: seeded from (seed, idx), so a
    chunk's samples do not depend on how many chunks came before."""
    g = torch.Generator(device=device)
    g.manual_seed(derive_seed(seed, idx))
    return g


def _padded_chunks(rays: torch.Tensor, chunk: int) -> tuple[torch.Tensor, int]:
    """(rays padded to whole chunks with copies of the last real ray (a
    zero direction would normalise to NaN), chunk): the chunk rounded up
    to a multiple of 1,024 rays when there are at least 1,024."""
    R = rays.shape[0]
    chunk = max(1024 * (-(-chunk // 1024)), 1024) if R >= 1024 else chunk
    pad = -(-R // chunk) * chunk - R
    if pad:
        rays = torch.cat([rays, rays[R - 1 :].expand(pad, rays.shape[1])])
    return rays, chunk


@torch.inference_mode()
def render_rays_chunked(
    field: NerfField | NerfPair | ProposalPair,
    rays: torch.Tensor,
    seed: int,
    settings: RenderSettings = RenderSettings(),
    chunk: int = 16384,
    occ: torch.Tensor | None = None,
    enc_alpha: float | None = None,
    app: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Render R rays in fixed-size chunks -> (rgb clipped to [0, 1] (R, 3),
    disparity (R,)), the remainder included (the reference drops it,
    utils/rendering.py:100). Rays are (R, 6), or under mip (R, 8) with
    each ray's cone radius in column 6 (JAX :919; the last chunk is padded
    with copies of the last ray, all columns). ``enc_alpha``: the BARF anneal progress of a
    mid-anneal training preview (the encoder the field is being trained
    with; the proposal scheme's main field only), or None; with it no
    chunk takes the fused render kernel.
    ``app``: an appearance model's (app_dim,) code for the whole render
    (broadcast to every ray, JAX :868-874); with it no chunk takes the
    fused render kernel, which has no slot for codes.

    Chunk ``i`` draws its samples from ``chunk_generator(seed, i)``. With
    ``fused_eval`` under ``backend="pallas"`` a chunk is one call of the
    fused render kernel; otherwise ``render_rays``. Both draw the same
    samples from the same seed. Under ``N_coarse > 0`` ``field`` is a
    ``NerfPair`` and a chunk renders hierarchically with the deterministic
    quantiles (``det_fine``), as JAX eval does; under ``N_prop > 0`` it is
    a ``ProposalPair`` and a chunk renders with the proposal scheme, its
    probes at bin midpoints and its samples at the quantiles (under
    ``mip`` its probe edges and fine edges), so a frame is deterministic
    end to end. Under ``mip`` a chunk casts cones
    (``render_rays_mip``, its draws from the chunk's generator, as JAX
    eval draws them).

    ``occ``: an (R, R, R) occupancy grid (JAX :764-830): a chunk's samples
    are the deterministic quantiles of the grid's PDF
    (``occupancy_ts(det=True)`` at the settings' ``occ_*``), in place of
    the stratified draw: the N samples (the fused render kernel's too),
    the hierarchical coarse pass's N_coarse or the proposal probes'
    N_prop. Not with ``mip`` (cone casting draws its own edges)."""
    hier, prop = settings.N_coarse > 0, settings.N_prop > 0
    if occ is not None and settings.mip:
        raise ValueError("mip rendering draws its own interval edges: occupancy sampling is for point samples "
                         "(as in JAX)")
    if enc_alpha is not None and settings.mip:
        raise ValueError("the anneal windows are for the point renders: not with mip (as in JAX)")
    want = NerfPair if hier else ProposalPair if prop else NerfField
    if not isinstance(field, want):
        raise ValueError(f"N_coarse={settings.N_coarse}, N_prop={settings.N_prop} renders a {want.__name__} "
                         "(N_coarse > 0: a NerfPair of coarse and fine fields; N_prop > 0: a ProposalPair; "
                         f"else one NerfField); got a {type(field).__name__}")
    R = rays.shape[0]
    rays, chunk = _padded_chunks(rays, chunk)
    fused = (settings.fused_eval and settings.backend == "pallas" and enc_alpha is None and app is None
             and not (hier or prop or settings.mip))
    app_c = None if app is None else torch.as_tensor(app, dtype=torch.float32, device=rays.device).expand(chunk, -1)
    rgbs, disps = [], []

    def occ_ts(rays_c, n):
        if occ is None:
            return None
        return occupancy_ts(None, rays_c, occ, n, settings.tn, settings.tf, settings.occ_aabb, Nb=settings.occ_Nb,
                            floor=settings.occ_floor, det=True, group=settings.occ_group)

    for i in range(rays.shape[0] // chunk):
        rays_c = rays[i * chunk : (i + 1) * chunk]
        g = chunk_generator(seed, i, rays.device)
        if fused:
            ts = occ_ts(rays_c, settings.N)
            if ts is None:
                ts = stratified_ts_spaced(g, chunk, settings.N, settings.tn, settings.tf,
                                          rays.device, rays.dtype, settings.sampling_space)
            rgb, disp = _fused_render_rays(field, rays_c, ts, settings)
        else:
            if hier:
                out = render_rays_hierarchical(field.coarse, field.fine, rays_c, g, settings, det_fine=True,
                                               ts_coarse=occ_ts(rays_c, settings.N_coarse), enc_alpha=enc_alpha,
                                               app=app_c)[1]
            elif prop:
                out = render_rays_proposal(field, rays_c, g, settings, det_fine=True,
                                           ts_prop=occ_ts(rays_c, settings.N_prop), app=app_c, enc_alpha=enc_alpha)
            else:
                out = render_rays(field, rays_c, g, settings, ts=occ_ts(rays_c, settings.N), enc_alpha=enc_alpha,
                                  app=app_c)
            rgb, disp = torch.clamp(out.rgb, 0.0, 1.0), out.disp  # eval clip: rendering.py:103
        rgbs.append(rgb)
        disps.append(disp)
    return torch.cat(rgbs)[:R], torch.cat(disps)[:R]


# Rows a density-gradient pass takes at once: sigma depends on its own row
# only, so slicing changes no gradient and bounds autograd's saved
# activations (~10 GB at the flagship width).
_GRAD_ROWS = 1 << 19


def _density_grad(field: NerfField, x: torch.Tensor, dtype) -> torch.Tensor:
    """d softplus(sigma) / dx at (rows, 3) positions."""
    x = x.detach().requires_grad_(True)
    dirs = torch.zeros_like(x)
    dirs[:, 2] = -1.0  # sigma does not read the direction (nor an appearance code)
    with torch.enable_grad():
        sigma = apply_model(field, torch.cat([x, dirs], dim=-1), dtype,
                            app=zeros_app_for(field.model, x.shape[0], x.device))[:, 3]
        return torch.autograd.grad(torch.nn.functional.softplus(sigma).sum(), x)[0]


def render_normals_chunked(
    field: NerfField | NerfPair | ProposalPair,
    rays: torch.Tensor,
    seed: int,
    settings: RenderSettings = RenderSettings(),
    chunk: int = 16384,
) -> torch.Tensor:
    """Per-pixel surface normals (R, 3) in [-1, 1]: the per-sample
    directions n(x) = -normalize(grad softplus sigma(x)) composited with
    the render weights (JAX ``render_normals_chunked``). Plain torch at
    ``settings.compute_dtype``, gradients by autograd; the kernels are not
    used, as the JAX package forces its XLA path here. The tail sample is
    left out (its 1e10 delta makes its weight absorb all remaining
    transmittance) and the sum is not renormalised (its length is the
    coherence of the gradients: ~0 over empty space). A ``NerfPair`` or
    ``ProposalPair`` gives its fine field, at the plain N setting (normals
    need one density field); a mip field renders point samples, as JAX
    does; an appearance model renders with zero codes (the weights and the
    density do not read them)."""
    if isinstance(field, (NerfPair, ProposalPair)):
        field = field.fine
    s = dataclasses.replace(settings, backend="xla", fused_eval=False, N_coarse=0, N_prop=0, mip=False,
                            mip_levels=1, opaque_background=False)
    R = rays.shape[0]
    rays, chunk = _padded_chunks(rays[:, :6], chunk)
    outs = []
    for i in range(rays.shape[0] // chunk):
        rays_c = rays[i * chunk : (i + 1) * chunk]
        ts = stratified_ts_spaced(chunk_generator(seed, i, rays.device), chunk, s.N, s.tn, s.tf,
                                  rays.device, rays.dtype, s.sampling_space)
        with torch.no_grad():
            weights = _render_at_ts(field, rays_c, ts, s, app=zeros_app_for(field.model, chunk, rays.device)).weights
            locs, _ = sample_points(rays_c, ts)
        g = torch.cat([_density_grad(field, x, s.compute_dtype)
                       for x in locs.reshape(-1, 3).split(_GRAD_ROWS)])
        n = -g / torch.clamp(torch.linalg.vector_norm(g, dim=-1, keepdim=True), min=1e-8)
        outs.append(torch.einsum("bn,bnc->bc", weights[:, :-1], n.reshape(*ts.shape, 3)[:, :-1]))
    return torch.cat(outs)[:R]


def render_image(
    field: NerfField | NerfPair | ProposalPair,
    rays_split: torch.Tensor,
    H: int,
    W: int,
    im_idx: int,
    seed: int,
    settings: RenderSettings = RenderSettings(),
    chunk: int = 16384,
    app: torch.Tensor | None = None,
    occ: torch.Tensor | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Image ``im_idx`` of a split's ray tensor -> host numpy (1, H, W, 3)
    rgb in [0, 1] and (1, H, W, 1) disparity (utils/rendering.py:88-113);
    ``app``: an appearance model's code, ``occ``: an occupancy grid
    (``render_rays_chunked``)."""
    n = H * W
    if not 0 <= im_idx < rays_split.shape[0] // n:
        raise IndexError(f"image {im_idx} of a split with {rays_split.shape[0] // n} images")
    rgb, disp = render_rays_chunked(field, rays_split[im_idx * n : (im_idx + 1) * n], seed,
                                    settings, chunk, app=app, occ=occ)
    return rgb.reshape(1, H, W, 3).cpu().numpy(), disp.reshape(1, H, W, 1).cpu().numpy()


def render_orbit_video(
    field: NerfField | NerfPair | ProposalPair,
    poses: np.ndarray,
    H: int,
    W: int,
    f: float,
    savepath: str,
    seed: int,
    settings: RenderSettings = RenderSettings(),
    chunk: int = 16384,
    fps: int = 15,
    app: torch.Tensor | None = None,
    occ: torch.Tensor | None = None,
) -> str:
    """Render the (P, 4, 4) poses and write them as a video of frame size
    (W, H) at ``fps`` (utils/rendering.py:116-160, which passed (H, W));
    frame ``i`` is rendered from ``derive_seed(seed, i)`` (with an
    appearance model's code ``app``, an occupancy grid ``occ``). Returns the written path
    (utils/video.py picks the format)."""
    from nerf_simple_tpu_torch.utils.video import open_video

    device = next(field.parameters()).device
    rays_all = rays_for_poses(torch.as_tensor(poses, dtype=torch.float32, device=device), H, W, f)
    n = H * W
    os.makedirs(savepath or ".", exist_ok=True)
    writer = open_video(os.path.join(savepath, f"nerf_rgb{str(time.time())[-10:]}"), W, H, fps)
    try:
        for i in range(len(poses)):
            rgb, _ = render_rays_chunked(field, rays_all[i * n : (i + 1) * n], derive_seed(seed, i),
                                         settings, chunk, app=app, occ=occ)
            writer.write((rgb.reshape(H, W, 3).cpu().numpy() * 255).astype(np.uint8))
    finally:
        writer.close()
    return writer.path
