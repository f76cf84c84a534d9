"""Emission-absorption compositing, the distortion regulariser and the
proposal scheme's interlevel loss (port of nerf_simple_tpu/ops/volume.py):
point form, and the interval form of the mip path (finite interval widths,
no 1e10 tail unless ``opaque_tail``).

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
    return _interval_weights(sigma, torch.cat([deltas, torch.full_like(deltas[:, :1], 1e10)], dim=-1), unit_dirs)


def _interval_weights(sigma: torch.Tensor, deltas: torch.Tensor, unit_dirs: torch.Tensor):
    """(alpha, weights) of (B, N) raw sigma over (B, N) ``deltas``."""
    deltas = deltas * torch.linalg.vector_norm(unit_dirs, dim=-1, keepdim=True)
    alpha = 1.0 - torch.exp(-F.softplus(sigma) * deltas)
    log_trans = torch.log(torch.clamp(1.0 - alpha, min=1e-10))
    excl = torch.cumsum(log_trans, dim=-1) - log_trans
    return alpha, alpha * torch.exp(excl)


def composite_intervals(
    rgb_sigma: torch.Tensor,
    t_edges: torch.Tensor,
    t_mids: torch.Tensor,
    unit_dirs: torch.Tensor,
    opaque_tail: bool = False,
) -> CompositeOut:
    """``composite`` for interval samples (the mip path): (B, N, 4) raw
    outputs of the frustums between the (B, N + 1) ascending ``t_edges``;
    the deltas are the interval widths, with no 1e10 tail, so light that
    passes every interval stays unabsorbed (acc < 1). ``opaque_tail``
    (mip-NeRF 360's opaque background) makes the last interval's delta
    1e10. Depth and disparity use the frustum centres ``t_mids`` (B, N)."""
    deltas = t_edges[:, 1:] - t_edges[:, :-1]
    if opaque_tail:
        deltas = torch.cat([deltas[:, :-1], torch.full_like(deltas[:, -1:], 1e10)], -1)
    alpha, weights = _interval_weights(rgb_sigma[..., 3], deltas, unit_dirs)
    rgb = torch.sum(weights[..., None] * rgb_sigma[..., :3], dim=1)
    depth = torch.sum(weights * t_mids, dim=-1)
    acc = torch.sum(weights, dim=-1)
    disp = 1.0 / torch.clamp(depth / torch.clamp(acc, min=1e-10), min=1e-10)
    return CompositeOut(rgb, disp, alpha, acc, weights, depth)


def weights_from_sigma(sigma: torch.Tensor, ts: torch.Tensor, unit_dirs: torch.Tensor) -> torch.Tensor:
    """(B, N) compositing weights alone from (B, N) raw sigma at ascending
    ts: the colour-free slice of ``composite`` (the proposal net's)."""
    return _weights(sigma, ts, unit_dirs)[1]


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


def distortion_loss_intervals(weights: torch.Tensor, edges: torch.Tensor, opaque_tail: bool = False) -> torch.Tensor:
    """The distortion loss in its interval form (mip-NeRF 360 eqn. 15 as
    published; JAX ``distortion_loss_intervals``): (B, N) interval weights
    at the midpoints of the (B, N + 1) ascending ``edges`` (in s-space),
    the self term on the interval widths, no tail dropped, except under
    ``opaque_tail``, whose last interval is the background absorber."""
    m = 0.5 * (edges[:, 1:] + edges[:, :-1])
    delta = edges[:, 1:] - edges[:, :-1]
    if opaque_tail:
        weights, m, delta = weights[:, :-1], m[:, :-1], delta[:, :-1]
    return _distortion_core(weights, m, delta)


def interlevel_loss(w: torch.Tensor, ts: torch.Tensor, w_prop: torch.Tensor, ts_prop: torch.Tensor) -> torch.Tensor:
    """Proposal supervision, mip-NeRF 360 eqn. 13 in point form (JAX
    ``ops/volume.py::interlevel_loss``). The (B, Np) proposal weights at
    ascending ``ts_prop`` own the Np cells between the midpoints of
    ``ts_prop``; the main field's (B, N) weights ``w`` at ascending ``ts``
    fall into them, and each cell's mass ``bound_j`` must be covered:
    ``mean_rays sum_j relu(bound_j - w_prop_j)^2 / (w_prop_j + 1e-4)``.
    The main field's tail sample is left out (its weight is the 1e10
    absorber's leftover transmittance). The caller detaches ``w``: the
    proposal distils from the main field, never the other way."""
    mids = 0.5 * (ts_prop[:, 1:] + ts_prop[:, :-1])  # (B, Np - 1) interior edges
    return _interlevel_core(w[:, :-1], ts[:, :-1], w_prop, mids)


def _interlevel_core(wi: torch.Tensor, ti: torch.Tensor, w_prop: torch.Tensor,
                     interior_edges: torch.Tensor) -> torch.Tensor:
    """Mass ``wi`` at positions ``ti`` binned against the proposal cells
    that ``interior_edges`` (B, Np - 1) separate: the bin of t is
    ``#(interior_edges <= t)`` (a t on an edge goes to the cell above it);
    only under-coverage is penalised."""
    idx = torch.searchsorted(interior_edges.contiguous(), ti.contiguous(), right=True)
    bound = torch.zeros_like(w_prop).scatter_add_(1, idx, wi.to(w_prop.dtype))
    excess = torch.relu(bound - w_prop)
    return torch.mean(torch.sum(excess**2 / (w_prop + 1e-4), dim=-1))
