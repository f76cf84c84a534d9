"""Emission-absorption compositing and the distortion regulariser (port of
nerf_simple_tpu/ops/volume.py, point form).

Plain torch, as the JAX package leaves it to XLA outside any kernel. The
reference quirks (utils/rendering.py:47-85) stay: softplus density; raw,
unclipped colour; a 1e10 final delta; deltas scaled by ||unit dir||;
disparity ``1 / max(1e-10, depth/acc)``. The exclusive cumprod of
``1 - alpha`` runs as an exclusive log-cumsum over ``max(1 - alpha,
1e-10)``, which equals the reference's ``1 - alpha + 1e-10`` for every
f32 alpha and cannot be reassociated into log(0).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class CompositeOut(NamedTuple):
    """Per-ray results, in the reference's order (rgb, disparity, alpha,
    acc, weights) plus depth."""

    rgb: torch.Tensor  # (B, 3) raw (unclipped) colour
    disp: torch.Tensor  # (B,)
    alpha: torch.Tensor  # (B, N)
    acc: torch.Tensor  # (B,)
    weights: torch.Tensor  # (B, N)
    depth: torch.Tensor  # (B,)


def _weights(sigma: torch.Tensor, ts: torch.Tensor, unit_dirs: torch.Tensor):
    deltas = ts[:, 1:] - ts[:, :-1]
    deltas = torch.cat([deltas, torch.full_like(deltas[:, :1], 1e10)], dim=-1)
    deltas = deltas * torch.linalg.vector_norm(unit_dirs, dim=-1, keepdim=True)
    alpha = 1.0 - torch.exp(-F.softplus(sigma) * deltas)
    log_trans = torch.log(torch.clamp(1.0 - alpha, min=1e-10))
    excl = torch.cumsum(log_trans, dim=-1) - log_trans
    return alpha, alpha * torch.exp(excl)


def _finish(rgb, alpha, weights, ts) -> CompositeOut:
    depth = torch.sum(weights * ts, dim=-1)
    acc = torch.sum(weights, dim=-1)
    disp = 1.0 / torch.clamp(depth / acc, min=1e-10)
    return CompositeOut(rgb, disp, alpha, acc, weights, depth)


def composite_T(
    rgb_sigma_T: torch.Tensor, ts: torch.Tensor, unit_dirs: torch.Tensor
) -> CompositeOut:
    """``composite`` on the kernel's channel-major (4, B, N) output."""
    alpha, weights = _weights(rgb_sigma_T[3], ts, unit_dirs)
    rgb = torch.einsum("bn,cbn->bc", weights, rgb_sigma_T[:3])
    return _finish(rgb, alpha, weights, ts)


def composite(
    rgb_sigma: torch.Tensor, ts: torch.Tensor, unit_dirs: torch.Tensor
) -> CompositeOut:
    """(B, N, 4) raw ``[r, g, b, sigma]``, (B, N) ascending ts, (B, 3)
    unit dirs -> per-ray colour, disparity and weights."""
    alpha, weights = _weights(rgb_sigma[..., 3], ts, unit_dirs)
    rgb = torch.sum(weights[..., None] * rgb_sigma[..., :3], dim=1)
    return _finish(rgb, alpha, weights, ts)


def s_norm(ts: torch.Tensor, tn: float, tf: float, disparity: bool = False) -> torch.Tensor:
    """Sample distances in the sampling parametrisation s in [0, 1] (JAX
    ``train/step.py::_s_norm``): affine in t, or in 1/t with
    ``disparity``. The distortion loss is measured in s."""
    if disparity:
        return (1.0 / tn - 1.0 / torch.clamp(ts, min=1e-10)) / (1.0 / tn - 1.0 / tf)
    return (ts - tn) / (tf - tn)


def distortion_loss(weights: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    """The mip-NeRF 360 distortion loss (eqn. 15) in point form, O(N) by
    cumsums, averaged over rays (JAX ``ops/volume.py::distortion_loss``):
    sum_ij w_i w_j |t_i - t_j| + sum_i w_i^2 delta_i / 3 over (B, N)
    weights at sorted (B, N) ts. The tail sample is left out: its weight
    is the 1e10 absorber's leftover transmittance."""
    return _distortion_core(weights[:, :-1], ts[:, :-1], ts[:, 1:] - ts[:, :-1])


def _distortion_core(w: torch.Tensor, m: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Weights ``w`` at sorted positions ``m`` with widths ``delta``: the
    cross term 2 sum_j w_j (m_j A_j - B_j) with A, B the exclusive prefix
    sums of w and w m, plus the self term."""
    acc = torch.cumsum(w, dim=-1)
    acc_m = torch.cumsum(w * m, dim=-1)
    cross = 2.0 * torch.sum(w * (m * (acc - w) - (acc_m - w * m)), dim=-1)
    return torch.mean(cross + torch.sum(w * w * delta, dim=-1) / 3.0)
