"""Occupancy-grid sampling (port of nerf_simple_tpu/ops/occupancy.py).

The fixed sample budget of a ray is redistributed into occupied space
rather than cut: a dense ``(R, R, R)`` grid holds an EMA of cell opacities,
refreshed every few steps by one density probe of the field at one jittered
point a cell (``update_occ_grid``); a ray reads the grid at ``Nb`` equally
spaced probe points (``ray_bin_occupancy``) and draws its N sorted samples
from the piecewise-constant PDF ``occ + floor`` over those bins
(``binned_pdf_ts``). The samples are sorted and N a ray, as stratified
ones, so every render and train path takes them as it takes those. The
``floor`` keeps every bin reachable, so a cell the grid wrongly marks empty
is still probed and the EMA corrects itself.

The grid is derived state: eval and serving rebuild it from the loaded
field (``rebuild_occ``); a checkpoint carries it, and a run without one in
its checkpoint starts from the all-ones grid.

The JAX package draws the jitter and the sampler's exponentials from
keys; here they come from a ``torch.Generator``, or are passed in (``u``,
``jitter``), so tests can feed both packages the same draws. The TPU's
dense compare and one-hot ``einsum`` (JAX :128-139) and its
``optimization_barrier`` (:183) are layout tricks: ``torch.searchsorted``
and ``gather`` find the same bin and read the same CDF and PDF values.

``density_fn`` is the density probe: under ``backend="pallas"`` it runs
the forward kernel (``fused_mlp_forward``) on the points, under ``"xla"``
the layer-by-layer MLP, as the renders do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def init_occ_grid(R: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """All-ones grid: until the first refresh the sampling PDF is uniform,
    which is stratified sampling's."""
    return torch.ones((R, R, R), dtype=dtype, device=device)


def occ_lookup(grid: torch.Tensor, pts: torch.Tensor, aabb: float) -> torch.Tensor:
    """Nearest-cell occupancy of the (R, R, R) ``grid`` over
    [-aabb, aabb]^3 at (..., 3) world points; points outside clamp to the
    boundary cell, and a NaN coordinate reads cell 0 of its axis (an index
    past the grid would fault on the card)."""
    R = grid.shape[0]
    cell = torch.clamp(torch.nan_to_num(torch.floor((pts + aabb) / (2.0 * aabb) * R)), 0, R - 1).to(torch.int64)
    flat = (cell[..., 0] * R + cell[..., 1]) * R + cell[..., 2]
    return grid.reshape(-1)[flat]


def ray_bin_occupancy(grid: torch.Tensor, rays: torch.Tensor, tn: float, tf: float, Nb: int,
                      aabb: float) -> torch.Tensor:
    """(B, Nb) occupancy of Nb equal t-bins of each (B, 6) ray, read at the
    bin centres along the unnormalised direction (where the renderer puts
    its samples)."""
    w = (tf - tn) / Nb
    t_centers = tn + (torch.arange(Nb, dtype=rays.dtype, device=rays.device) + 0.5) * w
    pts = rays[:, None, :3] + rays[:, None, 3:6] * t_centers[None, :, None]
    return occ_lookup(grid, pts, aabb)


def binned_pdf_ts(generator: torch.Generator | None, weights: torch.Tensor, N: int, tn: float, tf: float,
                  det: bool = False, u: torch.Tensor | None = None) -> torch.Tensor:
    """(B, N) sorted samples from the piecewise-constant PDF of the (B, Nb)
    nonnegative ``weights`` over Nb equal bins of [tn, tf], uniform within
    a bin. A ray of zero mass takes the uniform PDF (no 0/0). ``det``: the
    evenly spaced quantiles ``linspace(0, 1, N) * (1 - 1e-6)``; else the
    sorted uniforms are the normalised partial sums of N + 1 Exp(1) draws
    from ``generator``, or the (B, N) ``u`` given."""
    B, Nb = weights.shape
    dtype, device = weights.dtype, weights.device
    total = weights.sum(-1, keepdim=True)
    pdf = torch.where(total > 0.0, weights / torch.clamp(total, min=torch.finfo(dtype).tiny),
                      torch.full_like(weights, 1.0 / Nb))
    cdf = torch.cat([torch.zeros((B, 1), dtype=dtype, device=device), torch.cumsum(pdf, -1)], -1)
    if u is None:
        if det:
            u = (torch.linspace(0.0, 1.0, N, dtype=dtype, device=device) * (1 - 1e-6)).expand(B, N)
        else:
            e = torch.empty((B, N + 1), dtype=dtype, device=device).exponential_(generator=generator)
            s = torch.cumsum(e, -1)
            u = s[:, :N] / s[:, N:]
    # the bin: how many interior edges are <= u, in [0, Nb - 1]
    idx = torch.searchsorted(cdf[:, 1:-1].contiguous(), u.contiguous(), right=True)
    cdf_lo, p = cdf[:, :-1].gather(-1, idx), pdf.gather(-1, idx)
    frac = torch.clamp((u - cdf_lo) / torch.clamp(p, min=1e-12), 0.0, 1.0)
    return tn + (idx.to(dtype) + frac) * ((tf - tn) / Nb)


def occupancy_ts(generator: torch.Generator | None, rays: torch.Tensor, grid: torch.Tensor, N: int, tn: float,
                 tf: float, aabb: float, Nb: int = 128, floor: float = 0.01, det: bool = False, group: int = 1,
                 u: torch.Tensor | None = None) -> torch.Tensor:
    """The occupancy sampler in place of stratified sampling: (B, N)
    sorted samples a ray, concentrated in the bins the grid marks occupied
    (``binned_pdf_ts`` of the probe's ``occ + floor``). ``group > 1`` shares
    one probe, at the mean ray, among each run of ``group`` consecutive rays
    (eval of adjacent pixels); it is ignored (1) when it does not divide B.
    The ts carry no gradient: the lookups are piecewise constant."""
    B = rays.shape[0]
    rays = rays[:, :6].detach()
    if group > 1 and B % group == 0:
        probe = rays.reshape(B // group, group, 6).mean(1)
        occ = torch.repeat_interleave(ray_bin_occupancy(grid, probe, tn, tf, Nb, aabb), group, dim=0)
    else:
        occ = ray_bin_occupancy(grid, rays, tn, tf, Nb, aabb)
    return binned_pdf_ts(generator, occ + floor, N, tn, tf, det=det, u=u)


def density_fn(field, backend: str = "xla", compute_dtype=torch.float32):
    """``fn((P, 3) world points) -> (P,) raw sigma`` of ``field`` (a
    ``NerfField``; a pair's caller passes its fine field): the points with
    the unit -z view direction (sigma reads no direction), zero codes for an
    appearance model, sigma's raw column. Under ``backend="pallas"`` it is
    the forward kernel on the renderer's ``_kernel_input`` at t = 0 (its
    plain version on the CPU); under ``"xla"`` the layer-by-layer MLP. A
    contracted model contracts the points in either. No gradient."""
    from nerf_simple_tpu_torch.models import apply_model, zeros_app_for
    from nerf_simple_tpu_torch.render.renderer import RenderSettings, _fused_mlp_bn

    settings = RenderSettings(backend=backend, compute_dtype=compute_dtype)

    @torch.no_grad()
    def fn(pts: torch.Tensor) -> torch.Tensor:
        P = pts.shape[0]
        dirs = torch.zeros_like(pts)
        dirs[:, 2] = -1.0
        app = zeros_app_for(field.model, P, pts.device)
        if backend == "pallas":
            rays = torch.cat([pts, dirs], dim=-1)
            ts = torch.zeros((P, 1), dtype=pts.dtype, device=pts.device)
            return _fused_mlp_bn(field, rays, ts, settings, app=app)[3].reshape(P)
        return apply_model(field, torch.cat([pts, dirs], dim=-1), compute_dtype, app=app)[:, 3]

    return fn


def update_occ_grid(grid: torch.Tensor, sigma_fn, generator: torch.Generator | None, aabb: float,
                    decay: float = 0.95, jitter: torch.Tensor | None = None) -> torch.Tensor:
    """One EMA refresh: ``sigma_fn`` at one jittered point a cell (the
    (R^3, 3) ``jitter`` in [0, 1) given, or drawn from ``generator``), each
    cell's opacity ``alpha = 1 - exp(-softplus(sigma) * cell_w)`` over the
    cell's width, folded in as ``max(occ * decay, alpha)`` (Instant-NGP's
    rule). One dense forward of R^3 points."""
    R = grid.shape[0]
    cell_w = 2.0 * aabb / R
    ii = torch.arange(R, dtype=grid.dtype, device=grid.device)
    corners = torch.stack(torch.meshgrid(ii, ii, ii, indexing="ij"), -1).reshape(-1, 3)
    if jitter is None:
        jitter = torch.rand(corners.shape, generator=generator, dtype=grid.dtype, device=grid.device)
    pts = -aabb + (corners + jitter) * cell_w
    sigma = sigma_fn(pts).reshape(R, R, R).to(grid.dtype)
    alpha = 1.0 - torch.exp(-F.softplus(sigma) * cell_w)
    return torch.maximum(grid * decay, alpha)


def build_occ_from_params(sigma_fn, R: int, aabb: float, generator: torch.Generator | None, n_draws: int = 4,
                          device=None, jitters=None) -> torch.Tensor:
    """A grid rebuilt from a trained field (eval's): ``n_draws`` jittered
    probes max-accumulated from zeros (``update_occ_grid`` at decay 1),
    which approximates the EMA training keeps. ``jitters``: the draws'
    (R^3, 3) jitters given, in order."""
    grid = torch.zeros((R, R, R), dtype=torch.float32, device=device)
    for i in range(n_draws):
        grid = update_occ_grid(grid, sigma_fn, generator, aabb, decay=1.0,
                                jitter=None if jitters is None else jitters[i])
    return grid


def rebuild_occ(field, backend: str, compute_dtype, R: int, aabb: float, seed: int) -> torch.Tensor:
    """Eval's and serving's grid rebuild from a loaded field: the fine field
    of a coarse + fine or proposal pair (the field eval renders), its
    density probe, ``build_occ_from_params`` with draws from a generator
    seeded with ``seed`` on the field's device."""
    dp = getattr(field, "fine", field)
    device = next(dp.parameters()).device
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return build_occ_from_params(density_fn(dp, backend, compute_dtype), R, aabb, g, device=device)
