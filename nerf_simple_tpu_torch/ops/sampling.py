"""Stratified sample placement (port of nerf_simple_tpu/ops/sampling.py).

The JAX package draws from explicit PRNG keys; here an explicit
``torch.Generator`` on the tensors' device plays that part. The two give
different numbers from one seed, so parity tests pass ``ts`` in.
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
