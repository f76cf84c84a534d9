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
    fused_mlp,
    fused_mlp_forward,
    fused_render,
    pack_weights,
    supported,
)
from nerf_simple_tpu_torch.models import apply_model
from nerf_simple_tpu_torch.models.nerf import NerfField
from nerf_simple_tpu_torch.ops.rays import rays_for_poses
from nerf_simple_tpu_torch.ops.sampling import sample_points, stratified_ts_spaced
from nerf_simple_tpu_torch.ops.volume import CompositeOut, composite, composite_T


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Render configuration. Defaults mirror the reference (N=128,
    utils/rendering.py:102; tn=2, tf=6, utils/rendering.py:13).

    ``backend``: ``"xla"`` = the plain layer-by-layer torch MLP,
    ``"pallas"`` = the hand-written fused kernel (the JAX package's CLI
    words). ``fused_eval`` routes ``render_rays_chunked`` under
    ``"pallas"`` through the fused render kernel (forward and compositing
    in one call); under ``"xla"`` it changes nothing. The other fields
    after ``backend`` exist in the JAX settings but are not ported yet:
    setting one raises."""

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
    direction; with ``n_rows`` = 16 also row 6 the ts. Other rows zero."""
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
    field: NerfField, rays: torch.Tensor, ts: torch.Tensor, settings: RenderSettings
) -> torch.Tensor:
    """Fused MLP over a (B, N) ray/sample grid -> channel-major (4, B, N)."""
    _require_kernel_arch(field)
    B, N = ts.shape
    x = _kernel_input(rays, ts, 8)
    if torch.is_grad_enabled():
        wts = pack_weights(field, differentiable=True)
        outT = fused_mlp(wts, x, settings.compute_dtype, field.model)
    else:
        outT = fused_mlp_forward(
            _packed(field, settings.compute_dtype), x, settings.compute_dtype, field.model
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

    Chunk ``i`` draws its samples from ``chunk_generator(seed, i)``. With
    ``fused_eval`` under ``backend="pallas"`` a chunk is one call of the
    fused render kernel; otherwise ``render_rays``. Both draw the same
    samples from the same seed."""
    if occ is not None:
        raise NotImplementedError(
            "occupancy-informed sampling is not ported yet: ROADMAP Queue A, occupancy"
        )
    R = rays.shape[0]
    rays, chunk = _padded_chunks(rays, chunk)
    fused = settings.fused_eval and settings.backend == "pallas"
    rgbs, disps = [], []
    for i in range(rays.shape[0] // chunk):
        rays_c = rays[i * chunk : (i + 1) * chunk]
        g = chunk_generator(seed, i, rays.device)
        if fused:
            ts = stratified_ts_spaced(g, chunk, settings.N, settings.tn, settings.tf,
                                      rays.device, rays.dtype, settings.sampling_space)
            rgb, disp = _fused_render_rays(field, rays_c, ts, settings)
        else:
            out = render_rays(field, rays_c, g, settings)
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
    dirs[:, 2] = -1.0  # sigma does not read the direction
    with torch.enable_grad():
        sigma = apply_model(field, torch.cat([x, dirs], dim=-1), dtype)[:, 3]
        return torch.autograd.grad(torch.nn.functional.softplus(sigma).sum(), x)[0]


def render_normals_chunked(
    field: NerfField,
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
    coherence of the gradients: ~0 over empty space)."""
    s = dataclasses.replace(settings, backend="xla", fused_eval=False)
    R = rays.shape[0]
    rays, chunk = _padded_chunks(rays[:, :6], chunk)
    outs = []
    for i in range(rays.shape[0] // chunk):
        rays_c = rays[i * chunk : (i + 1) * chunk]
        ts = stratified_ts_spaced(chunk_generator(seed, i, rays.device), chunk, s.N, s.tn, s.tf,
                                  rays.device, rays.dtype, s.sampling_space)
        with torch.no_grad():
            weights = _render_at_ts(field, rays_c, ts, s).weights
            locs, _ = sample_points(rays_c, ts)
        g = torch.cat([_density_grad(field, x, s.compute_dtype)
                       for x in locs.reshape(-1, 3).split(_GRAD_ROWS)])
        n = -g / torch.clamp(torch.linalg.vector_norm(g, dim=-1, keepdim=True), min=1e-8)
        outs.append(torch.einsum("bn,bnc->bc", weights[:, :-1], n.reshape(*ts.shape, 3)[:, :-1]))
    return torch.cat(outs)[:R]


def render_image(
    field: NerfField,
    rays_split: torch.Tensor,
    H: int,
    W: int,
    im_idx: int,
    seed: int,
    settings: RenderSettings = RenderSettings(),
    chunk: int = 16384,
) -> tuple[np.ndarray, np.ndarray]:
    """Image ``im_idx`` of a split's ray tensor -> host numpy (1, H, W, 3)
    rgb in [0, 1] and (1, H, W, 1) disparity (utils/rendering.py:88-113)."""
    n = H * W
    if not 0 <= im_idx < rays_split.shape[0] // n:
        raise IndexError(f"image {im_idx} of a split with {rays_split.shape[0] // n} images")
    rgb, disp = render_rays_chunked(field, rays_split[im_idx * n : (im_idx + 1) * n], seed,
                                    settings, chunk)
    return rgb.reshape(1, H, W, 3).cpu().numpy(), disp.reshape(1, H, W, 1).cpu().numpy()


def render_orbit_video(
    field: NerfField,
    poses: np.ndarray,
    H: int,
    W: int,
    f: float,
    savepath: str,
    seed: int,
    settings: RenderSettings = RenderSettings(),
    chunk: int = 16384,
    fps: int = 15,
) -> str:
    """Render the (P, 4, 4) poses and write them as a video of frame size
    (W, H) at ``fps`` (utils/rendering.py:116-160, which passed (H, W));
    frame ``i`` is rendered from ``derive_seed(seed, i)``. Returns the
    written path (utils/video.py picks the format)."""
    from nerf_simple_tpu_torch.utils.video import open_video

    device = next(field.parameters()).device
    rays_all = rays_for_poses(torch.as_tensor(poses, dtype=torch.float32, device=device), H, W, f)
    n = H * W
    os.makedirs(savepath or ".", exist_ok=True)
    writer = open_video(os.path.join(savepath, f"nerf_rgb{str(time.time())[-10:]}"), W, H, fps)
    try:
        for i in range(len(poses)):
            rgb, _ = render_rays_chunked(field, rays_all[i * n : (i + 1) * n], derive_seed(seed, i),
                                         settings, chunk)
            writer.write((rgb.reshape(H, W, 3).cpu().numpy() * 255).astype(np.uint8))
    finally:
        writer.close()
    return writer.path
