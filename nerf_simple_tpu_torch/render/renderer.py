"""Ray -> radiance rendering (port of nerf_simple_tpu/render/renderer.py,
the point-sampled path).

``render_rays`` draws stratified ``ts`` and renders through
``_render_at_ts``: under ``backend="pallas"`` the fused MLP (kernels/
mlp.py) on the feature-major ``(8, B*N)`` input, then ``composite_T``
(with gradients enabled, the differentiable ``fused_mlp``, whose backward
is the fused backward kernel); under ``backend="xla"`` the layer-by-layer
``nerf_apply`` oracle, then ``composite``. ``render_rays_chunked`` renders
any number of rays in fixed-size chunks, padding the last chunk with
copies of the last ray.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from nerf_simple_tpu_torch.kernels.mlp import (
    FusedWeights,
    _cast_weights,
    fused_mlp,
    fused_mlp_forward,
    pack_weights,
    supported,
)
from nerf_simple_tpu_torch.models import apply_model
from nerf_simple_tpu_torch.models.nerf import NerfField
from nerf_simple_tpu_torch.ops.sampling import sample_points, stratified_ts_spaced
from nerf_simple_tpu_torch.ops.volume import CompositeOut, composite, composite_T


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Render configuration. Defaults mirror the reference (N=128,
    utils/rendering.py:102; tn=2, tf=6, utils/rendering.py:13).

    ``backend``: ``"xla"`` = the plain layer-by-layer torch MLP,
    ``"pallas"`` = the hand-written fused kernel (the JAX package's CLI
    words). The fields after ``backend`` exist in the JAX settings but are
    not ported yet: setting one raises."""

    N: int = 128
    tn: float = 2.0
    tf: float = 6.0
    sampling_space: str = "linear"  # or "disparity": bins uniform in 1/t
    compute_dtype: Any = torch.float32
    backend: str = "xla"
    N_coarse: int = 0
    N_prop: int = 0
    mip: bool = False
    fused_eval: bool = False
    sigma_noise: float = 0.0

    def __post_init__(self):
        if self.backend not in ("xla", "pallas"):
            raise ValueError(f"backend must be 'xla' or 'pallas', got {self.backend!r}")
        if self.compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be f32 or bf16, got {self.compute_dtype}")
        unported = {
            "N_coarse": (self.N_coarse > 0, "hierarchical sampling"),
            "N_prop": (self.N_prop > 0, "proposal sampling"),
            "mip": (self.mip, "the mip family"),
            "fused_eval": (self.fused_eval, "the fused_render kernel (Queue B)"),
            "sigma_noise": (self.sigma_noise > 0, "sigma noise (a training regulariser)"),
        }
        for name, (on, item) in unported.items():
            if on:
                raise NotImplementedError(
                    f"RenderSettings.{name} is not ported yet: ROADMAP, {item}"
                )


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
) -> CompositeOut:
    """Render (B, 6) ``[origin | direction]`` rays (direction
    unnormalised) at stratified ``ts`` drawn from ``generator``, or at the
    (B, N) ``ts`` given. ``.rgb`` is raw, like the reference."""
    if ts is None:
        ts = stratified_ts_spaced(
            generator, rays.shape[0], settings.N, settings.tn, settings.tf,
            rays.device, rays.dtype, settings.sampling_space,
        )
    return _render_at_ts(field, rays, ts, settings)


def _render_at_ts(
    field: NerfField, rays: torch.Tensor, ts: torch.Tensor, settings: RenderSettings
) -> CompositeOut:
    B, N = ts.shape
    if settings.backend == "pallas":
        outT = _fused_mlp_bn(field, rays, ts, settings)
        dirs = rays[:, 3:6]
        unit_dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
        return composite_T(outT, ts, unit_dirs)
    locs, unit_dirs = sample_points(rays, ts)
    query = torch.cat([locs, unit_dirs[:, None, :].expand(B, N, 3)], dim=-1)
    out = apply_model(field, query.reshape(B * N, 6), settings.compute_dtype)
    return composite(out.reshape(B, N, 4), ts, unit_dirs)


def _fused_mlp_bn(
    field: NerfField, rays: torch.Tensor, ts: torch.Tensor, settings: RenderSettings
) -> torch.Tensor:
    """Fused MLP over a (B, N) ray/sample grid -> channel-major (4, B, N).

    Builds the kernel's ``xT (8, B*N)`` straight from the rays: rows 0..2
    the sample xyz along the unnormalised direction (the reference quirk
    at utils/rendering.py:31-36), rows 3..5 the unit view direction. An
    architecture the kernel does not take raises here; the JAX renderer
    fell back to its XLA path instead."""
    model = field.model
    if not supported(model):
        raise ValueError(
            f"backend='pallas' needs H % 16 == 0, H >= 16 (got {model}); "
            "use backend='xla' for other architectures"
        )
    B, N = ts.shape
    oT = rays[:, :3].T
    dT = rays[:, 3:6].T
    unitT = dT / torch.linalg.vector_norm(dT, dim=0, keepdim=True)
    rows = B * N
    tile = 1024 if rows % 1024 == 0 else 128
    rows_p = -(-rows // tile) * tile
    x = torch.zeros((8, rows_p), dtype=torch.float32, device=rays.device)
    x[0:3, :rows] = (oT[:, :, None] + dT[:, :, None] * ts[None]).reshape(3, rows)
    x[3:6, :rows] = unitT[:, :, None].expand(3, B, N).reshape(3, rows)
    if torch.is_grad_enabled():
        wts = pack_weights(field, differentiable=True)
        outT = fused_mlp(wts, x, settings.compute_dtype, model)
    else:
        outT = fused_mlp_forward(
            _packed(field, settings.compute_dtype), x, settings.compute_dtype, model
        )
    return outT[:4, :rows].reshape(4, B, N)


def chunk_generator(seed: int, idx: int, device) -> torch.Generator:
    """The generator of chunk ``idx``: seeded from (seed, idx), so a
    chunk's samples do not depend on how many chunks came before."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, idx]).generate_state(1, np.uint64)[0]))
    return g


@torch.inference_mode()
def render_rays_chunked(
    field: NerfField,
    rays: torch.Tensor,
    seed: int,
    settings: RenderSettings = RenderSettings(),
    chunk: int = 16384,
    occ: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Render R rays in fixed-size chunks -> (rgb clipped to [0, 1] (R, 3),
    disparity (R,)), the remainder included (the reference drops it,
    utils/rendering.py:100).

    The chunk is rounded up to a multiple of 1,024 rays when R >= 1024;
    the last chunk is padded with copies of the last real ray (a zero
    direction would normalise to NaN). Chunk ``i`` draws its samples from
    ``chunk_generator(seed, i)``."""
    if occ is not None:
        raise NotImplementedError(
            "occupancy-informed sampling is not ported yet: ROADMAP Queue A, occupancy"
        )
    R = rays.shape[0]
    chunk = max(1024 * (-(-chunk // 1024)), 1024) if R >= 1024 else chunk
    n_chunks = -(-R // chunk)
    pad = n_chunks * chunk - R
    if pad:
        rays = torch.cat([rays, rays[R - 1 :].expand(pad, rays.shape[1])])
    rgbs, disps = [], []
    for i in range(n_chunks):
        out = render_rays(
            field, rays[i * chunk : (i + 1) * chunk],
            chunk_generator(seed, i, rays.device), settings,
        )
        rgbs.append(torch.clamp(out.rgb, 0.0, 1.0))  # eval clip: rendering.py:103
        disps.append(out.disp)
    return torch.cat(rgbs)[:R], torch.cat(disps)[:R]
