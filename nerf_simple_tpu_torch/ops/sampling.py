"""Sample placement (port of nerf_simple_tpu/ops/sampling.py): stratified
samples, the hierarchical scheme's importance samples and merge, the
proposal scheme's placement anneal, and mip-NeRF's cone casting: the
conical-frustum Gaussians of interval samples and the fine level's
resampled interval edges.

The JAX package draws from explicit PRNG keys; here an explicit
``torch.Generator`` on the tensors' device plays that part. The two give
different numbers from one seed, so parity tests pass ``ts`` in (or use
``det=True``).
"""

from __future__ import annotations

import torch


def stratified_ts(
    generator: torch.Generator | None,
    n_rays: int,
    N: int,
    tn: float,
    tf: float,
    device,
    dtype=torch.float32,
    det: bool = False,
) -> torch.Tensor:
    """(n_rays, N) samples, one uniform draw in each of N equal bins of
    [tn, tf] (utils/rendering.py:25-29); ``det=True`` takes the bin
    midpoints and needs no generator."""
    edges = torch.linspace(tn, tf, N + 1, dtype=dtype, device=device)
    width = (tf - tn) / N
    if det:
        u = torch.full((n_rays, N), 0.5, dtype=dtype, device=device)
    else:
        u = torch.rand((n_rays, N), generator=generator, dtype=dtype, device=device)
    return width * u + edges[:-1]


def stratified_ts_spaced(
    generator: torch.Generator | None,
    n_rays: int,
    N: int,
    tn: float,
    tf: float,
    device,
    dtype=torch.float32,
    space: str = "linear",
    det: bool = False,
) -> torch.Tensor:
    """``stratified_ts`` with bins uniform in t (``"linear"``, the
    reference) or in 1/t (``"disparity"``, mip-NeRF 360)."""
    if space == "linear":
        return stratified_ts(generator, n_rays, N, tn, tf, device, dtype, det)
    if space != "disparity":
        raise ValueError(f"unknown sampling space {space!r}")
    k = torch.arange(N, dtype=dtype, device=device)
    if det:
        u = ((k + 0.5) / N).expand(n_rays, N)
    else:
        u = (k + torch.rand((n_rays, N), generator=generator, dtype=dtype, device=device)) / N
    inv = (1.0 / tn) + u * (1.0 / tf - 1.0 / tn)  # descending in t
    return 1.0 / inv


def sample_points(
    rays: torch.Tensor, ts: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, 6) rays, (B, N) ts -> locs (B, N, 3) along the UNNORMALISED
    direction, and the unit view dirs (B, 3) (utils/rendering.py:31-40)."""
    origins, dirs = rays[:, :3], rays[:, 3:6]
    locs = origins[:, None, :] + dirs[:, None, :] * ts[..., None]
    unit_dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    return locs, unit_dirs


def importance_ts(
    generator: torch.Generator | None,
    ts_coarse: torch.Tensor,
    weights: torch.Tensor,
    N_fine: int,
    det: bool = False,
) -> torch.Tensor:
    """(B, N_fine) ascending samples drawn by inverse transform from the
    piecewise-constant PDF of the (B, Nc) coarse ``weights`` over the
    midpoints of the ascending ``ts_coarse`` (the NeRF paper, sec. 5.2;
    the interior bins only, each with 1e-5 added). ``det=True`` takes the
    quantiles ``linspace(0, 1, N_fine)`` and needs no generator; otherwise
    u are the order statistics of N_fine uniforms, drawn already sorted as
    the normalised partial sums of N_fine + 1 Exp(1) draws, and the
    inverse CDF is monotone, so the samples come out sorted with no sort.
    The result lies within [ts_coarse min, max]."""
    B = ts_coarse.shape[0]
    mids = 0.5 * (ts_coarse[:, 1:] + ts_coarse[:, :-1])  # (B, Nc - 1)
    w = weights[:, 1:-1] + 1e-5
    pdf = w / w.sum(-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, -1)], -1)  # (B, Nc - 1)
    if det:
        u = torch.linspace(0.0, 1.0, N_fine, dtype=ts_coarse.dtype, device=ts_coarse.device)
        u = u.expand(B, N_fine).contiguous()
    else:
        e = torch.empty((B, N_fine + 1), dtype=ts_coarse.dtype, device=ts_coarse.device)
        s = torch.cumsum(e.exponential_(generator=generator), -1)
        u = s[:, :N_fine] / s[:, N_fine:]
    return _inv_cdf_interp(cdf, mids, u)


def _inv_cdf_interp(cdf: torch.Tensor, values: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear inverse CDF: ``u`` (B, K) in [0, 1] through the
    ascending (B, M) ``cdf`` onto its support ``values`` (B, M). The bin is
    ``#(cdf <= u)``, its ends clipped to [0, M - 1]; a bin of mass under
    1e-8 divides by 1. Monotone in u along each row."""
    M = cdf.shape[-1]
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = torch.clamp(idx - 1, 0, M - 1)
    above = torch.clamp(idx, 0, M - 1)
    cdf_b, cdf_a = cdf.gather(-1, below), cdf.gather(-1, above)
    v_b, v_a = values.gather(-1, below), values.gather(-1, above)
    denom = torch.where(cdf_a - cdf_b < 1e-8, torch.ones_like(cdf_a), cdf_a - cdf_b)
    return v_b + (u - cdf_b) / denom * (v_a - v_b)


def merge_sorted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, Na + Nb) ascending union of the rows of two ascending (B, Na)
    and (B, Nb) tensors: a stable sort of the concatenation, so equal
    values keep a's before b's, as the JAX rank merge orders them."""
    return torch.sort(torch.cat([a, b], -1), dim=-1, stable=True).values


def anneal_weights(w: torch.Tensor, a: float | None) -> torch.Tensor:
    """The placement anneal (JAX ``anneal_weights``): ``max(w, 1e-8) ** a``,
    so an exponent ramping 0 -> 1 moves sample placement from uniform to
    the weights' histogram; ``a = None`` is the identity."""
    if a is None:
        return w
    return torch.pow(torch.clamp(w, min=1e-8), a)


def resample_edges(
    generator: torch.Generator | None,
    edges: torch.Tensor,
    weights: torch.Tensor,
    N_new: int,
    blur: float = 0.01,
    det: bool = False,
) -> torch.Tensor:
    """Mip-NeRF's fine-level resampling (Barron et al. 2021, sec. 3.2):
    ``N_new + 1`` ascending edges drawn from the piecewise-constant
    histogram of the (B, N) interval ``weights`` over the (B, N + 1)
    ascending ``edges``, after the 2-tap max filter and the uniform
    padding ``w' = (max(w_{k-1}, w_k) + max(w_k, w_{k+1})) / 2 + blur``.
    ``det=True`` takes the quantiles ``linspace(0, 1, N_new + 1)``;
    otherwise the sorted uniforms come from N_new + 2 Exp(1) draws of
    ``generator``, as in ``importance_ts``. The inverse CDF runs against
    the edges themselves, so the result lies within [edges min, max]."""
    B = weights.shape[0]
    wpad = torch.cat([weights[:, :1], weights, weights[:, -1:]], -1)
    wmax = torch.maximum(wpad[:, :-1], wpad[:, 1:])  # (B, N + 1)
    w = 0.5 * (wmax[:, :-1] + wmax[:, 1:]) + blur
    pdf = w / w.sum(-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, -1)], -1)  # (B, N + 1)
    n_draw = N_new + 1
    if det:
        u = torch.linspace(0.0, 1.0, n_draw, dtype=edges.dtype, device=edges.device)
        u = u.expand(B, n_draw).contiguous()
    else:
        e = torch.empty((B, n_draw + 1), dtype=edges.dtype, device=edges.device)
        s = torch.cumsum(e.exponential_(generator=generator), -1)
        u = s[:, :n_draw] / s[:, n_draw:]
    return _inv_cdf_interp(cdf, edges, u)


def frustum_moments(t0: torch.Tensor, t1: torch.Tensor, base_radius):
    """The conical frustum between ``t0`` and ``t1`` as a Gaussian
    (mip-NeRF eqn. 7, the stable form): (mu_t, sig_t2, sig_r2), its mean
    and variance along the ray and its variance across it, for a cone of
    radius ``base_radius * t`` (a scalar or a tensor that broadcasts)."""
    t_mu = 0.5 * (t0 + t1)
    t_d = 0.5 * (t1 - t0)
    denom = 3.0 * t_mu**2 + t_d**2
    mu_t = t_mu + 2.0 * t_mu * t_d**2 / denom
    sig_t2 = t_d**2 / 3.0 - (4.0 * t_d**4 * (12.0 * t_mu**2 - t_d**2)) / (15.0 * denom**2)
    sig_r2 = base_radius**2 * (t_mu**2 / 4.0 + 5.0 * t_d**2 / 12.0 - 4.0 * t_d**4 / (15.0 * denom))
    return mu_t, sig_t2, sig_r2


def interval_moments(t0: torch.Tensor, t1: torch.Tensor, radius, shape: str = "cone"):
    """``frustum_moments`` for ``shape="cone"`` (pinhole frames). The NDC
    cylinder of LLFF scenes is not ported."""
    if shape == "cylinder":
        raise NotImplementedError(
            "mip_shape='cylinder' (NDC-warped LLFF rays) is not ported yet: ROADMAP Queue A item 6, LLFF/NDC")
    if shape != "cone":
        raise ValueError(f"mip_shape must be 'cone' or 'cylinder', got {shape!r}")
    return frustum_moments(t0, t1, radius)


def frustum_gaussians_T(rays: torch.Tensor, edges: torch.Tensor, radius, shape: str = "cone"):
    """The interval Gaussians of (B, >= 6) rays at (B, N + 1) edges in the
    kernels' feature-major layout, shared by the fused train step's input
    and the mip render: (meanT (3, B, N), unitT (3, B), varT (3, B, N),
    mu_t (B, N)). The diagonal covariance is ``sig_t2 d^2 + sig_r2 (1 -
    d^2 / |d|^2)`` along the unnormalised direction d. ``radius`` is a
    scalar, or a (B, 1) tensor of per-ray radii (multiscale training's
    column 6), broadcast over the intervals as JAX broadcasts it."""
    oT, dT = rays[:, :3].T, rays[:, 3:6].T
    n2 = torch.sum(dT * dT, dim=0, keepdim=True)  # (1, B)
    unitT = dT / torch.sqrt(n2)
    mu_t, sig_t2, sig_r2 = interval_moments(edges[:, :-1], edges[:, 1:], radius, shape)
    meanT = oT[:, :, None] + dT[:, :, None] * mu_t[None]
    d2T = dT * dT
    varT = sig_t2[None] * d2T[:, :, None] + sig_r2[None] * (1.0 - d2T / n2)[:, :, None]
    return meanT, unitT, varT, mu_t


def conical_gaussian(rays: torch.Tensor, t_edges: torch.Tensor, base_radius, shape: str = "cone"):
    """The interval Gaussians in the row-major layout: (means (B, N, 3),
    vars (B, N, 3), t_mids (B, N), the Gaussian centres' distances along
    the ray). ``base_radius`` is ``2 / sqrt(12) / focal`` for a pinhole
    frame, or a (B, 1) tensor of radii."""
    origins, d = rays[:, :3], rays[:, 3:6]
    mu_t, sig_t2, sig_r2 = interval_moments(t_edges[:, :-1], t_edges[:, 1:], base_radius, shape)
    means = origins[:, None, :] + d[:, None, :] * mu_t[..., None]
    d2 = d**2
    n2 = torch.sum(d2, dim=-1, keepdim=True)
    vars_ = sig_t2[..., None] * d2[:, None, :] + sig_r2[..., None] * (1.0 - d2[:, None, :] / n2[:, None, :])
    return means, vars_, mu_t
