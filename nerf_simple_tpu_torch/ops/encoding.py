"""Sinusoidal positional encoding and mip-NeRF's integrated positional
encoding (port of nerf_simple_tpu/ops/encoding.py).

Reference layout (reference utils/xyz.py:6-36): per scalar channel ``u``
the 2L features ``[sin(u), cos(u), sin(2u), cos(2u), ...]`` interleaved
per frequency; channel blocks in input order; raw values prepended by
``positional_encoder`` (and by ``ipe_encoder``, so a mip checkpoint is a
plain ``NerfMLP`` checkpoint). Inputs are not rescaled.
"""

from __future__ import annotations

import torch


def gamma(x: torch.Tensor, L: int = 4, alpha: float | None = None) -> torch.Tensor:
    """(..., C) -> (..., C * 2L), interleaved ``[sin(2^i x), cos(2^i x)]``
    per channel; with the BARF anneal progress ``alpha``, octave i's pair
    times ``anneal_weights(L, alpha)[i]``."""
    freqs = 2.0 ** torch.arange(L, dtype=x.dtype, device=x.device)
    ang = x[..., None] * freqs  # (..., C, L)
    enc = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1)
    if alpha is not None:
        enc = enc * anneal_weights(L, alpha, x.dtype, x.device)[:, None]
    return enc.reshape(*x.shape[:-1], x.shape[-1] * 2 * L)


def anneal_weights(L: int, alpha: float, dtype=torch.float32, device=None) -> torch.Tensor:
    """BARF's coarse-to-fine octave weights (Lin et al. 2021, eqn. 14):
    ``w_k = (1 - cos(pi * clip(alpha * L - k, 0, 1))) / 2`` for the anneal
    progress ``alpha`` in [0, 1], computed in ``dtype``. At alpha 0 every
    octave is off (the raw values alone drive the MLP); at alpha >= 1 this
    is the standard encoder (every weight exactly 1). Returns (L,)."""
    k = torch.arange(L, dtype=dtype, device=device)
    ramp = torch.clamp(torch.as_tensor(alpha, dtype=dtype, device=device) * L - k, 0.0, 1.0)
    return (1.0 - torch.cos(torch.pi * ramp)) / 2.0


def positional_encoder(
    vec: torch.Tensor, Lp: int = 10, Ld: int = 4, alpha: float | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., 6) ``[xyz | view dir]`` -> (posx (..., 3 + 6Lp),
    posd (..., 3 + 6Ld)), raw values first (utils/xyz.py:33-34); ``alpha``
    anneals both branches (``gamma``)."""
    xyz, d = vec[..., 0:3], vec[..., 3:6]
    posx = torch.cat([xyz, gamma(xyz, Lp, alpha)], dim=-1)
    posd = torch.cat([d, gamma(d, Ld, alpha)], dim=-1)
    return posx, posd


def gamma_ipe(mean: torch.Tensor, var: torch.Tensor, L: int = 10) -> torch.Tensor:
    """The integrated positional encoding (mip-NeRF eqn. 14): the expected
    ``gamma`` of x ~ N(mean, diag(var)), each sin and cos of frequency
    2^i damped by ``exp(-0.5 * 4^i * var)``; ``gamma``'s layout, and
    ``gamma(mean)`` exactly at var = 0."""
    freqs = 2.0 ** torch.arange(L, dtype=mean.dtype, device=mean.device)
    ang = mean[..., None] * freqs
    damp = torch.exp(-0.5 * var[..., None] * freqs * freqs)
    enc = torch.stack([torch.sin(ang) * damp, torch.cos(ang) * damp], dim=-1)
    return enc.reshape(*mean.shape[:-1], mean.shape[-1] * 2 * L)


def ipe_encoder(
    mean: torch.Tensor, var: torch.Tensor, dirs: torch.Tensor, Lp: int = 10, Ld: int = 4
) -> tuple[torch.Tensor, torch.Tensor]:
    """The mip encoder: posx ``[mean, gamma_ipe(mean, var)]`` (raw values
    first, as ``positional_encoder``) and the ordinary direction branch
    ``[dirs, gamma(dirs)]``."""
    posx = torch.cat([mean, gamma_ipe(mean, var, Lp)], dim=-1)
    posd = torch.cat([dirs, gamma(dirs, Ld)], dim=-1)
    return posx, posd
