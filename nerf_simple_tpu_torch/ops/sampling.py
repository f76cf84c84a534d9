"""Sample placement (port of nerf_simple_tpu/ops/sampling.py): stratified
samples, the hierarchical scheme's importance samples and merge, and the
proposal scheme's placement anneal.

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
