"""Sinusoidal positional encoding, mip-NeRF's integrated positional
encoding and mip-NeRF 360's scene contraction (port of
nerf_simple_tpu/ops/encoding.py).

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


def scene_contraction(x: torch.Tensor) -> torch.Tensor:
    """mip-NeRF 360's scene contraction (Barron et al. 2022, eqn. 10) of
    (..., 3) points: ``x`` for ``|x| <= 1``, else ``(2 - 1/|x|) x / |x|``,
    so all of space lands in the radius-2 ball (the identity inside the
    unit ball, C1 at its boundary). The norm is floored at 1e-10. Applied
    at the model boundary (``nerf_apply``, ``proposal_sigma``), so every
    consumer, the normals' autograd included, sees the same field."""
    n = torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-10)
    return torch.where(n <= 1.0, x, (2.0 - 1.0 / n) * (x / n))


def contract_gaussian(mean: torch.Tensor, var: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The linearised contraction of diagonal Gaussians (mip-NeRF 360,
    eqn. 8-9): ``(contract(mean), diag(J diag(var) J^T))`` with J the
    contraction's Jacobian at the mean. For ``contract(x) = g(r) x``, ``g =
    (2 - 1/r) / r`` outside the unit ball, ``c = g'(r) / r``, ``m = mean^2``:
    ``var'_i = g^2 v_i + 2 g c m_i v_i + c^2 m_i sum_j m_j v_j``. Inside the
    ball g = 1 and c = 0: the identity, exactly."""
    r = torch.clamp(torch.linalg.vector_norm(mean, dim=-1, keepdim=True), min=1e-10)
    inside = r <= 1.0
    g = torch.where(inside, 1.0, (2.0 - 1.0 / r) / r)
    c = torch.where(inside, 0.0, (-2.0 / r**2 + 2.0 / r**3) / r)  # g'(r) / r
    m2 = mean**2
    m2v = torch.sum(m2 * var, dim=-1, keepdim=True)
    var_out = g**2 * var + 2.0 * g * c * m2 * var + c**2 * m2 * m2v
    return g * mean, var_out


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
