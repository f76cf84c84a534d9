"""The training step: sample -> render -> loss -> gradients -> Adam (port of
nerf_simple_tpu/train/step.py, the point-sampled single-network path).

Learning rate as the reference: Adam starts at the hard-coded 5e-4
(train.py:43 ignores lr_init; ``honor_lr_init`` fixes that) and
``lr(i) = lr0 * decay^i`` with ``decay = exp(ln(lr_final/lr_init) /
num_iters)`` for update ``i`` (0-based), as optax's
``exponential_decay`` counts. Adam has optax's defaults (betas 0.9 and
0.999, eps 1e-8); torch's update is the same formula.

The batch and the sample ``ts`` are drawn on the device from the state's
generator, so a step moves nothing between host and card.

Cores:

- ``backend="pallas"``: the fused train-step kernel
  (kernels/mlp.py::fused_train_step), one launch a step; its packed
  gradients go back to the field through the differentiable pack;
- ``backend="xla"``, or ``fused=False``: autograd over ``render_rays``
  and the MSE. Under ``backend="pallas"`` that renders through
  ``fused_mlp``, whose backward is the fused backward kernel. This is
  the JAX package's path for configs its single kernel does not take;
  the port's configs all fit the single kernel, so only a caller that
  asks for it (``fused=False``) gets it, with the JAX warning.
"""

from __future__ import annotations

import dataclasses
import math
import warnings

import torch

from nerf_simple_tpu_torch.config import TrainConfig
from nerf_simple_tpu_torch.kernels.mlp import fused_train_step, pack_weights
from nerf_simple_tpu_torch.models.nerf import NerfField, NerfMLP, init_nerf_params
from nerf_simple_tpu_torch.ops.sampling import stratified_ts_spaced
from nerf_simple_tpu_torch.render.renderer import RenderSettings, render_rays


def lr_schedule(cfg: TrainConfig):
    """(lr0, decay): the learning rate of update i is lr0 * decay**i."""
    lr0 = cfg.lr_init if cfg.honor_lr_init else 5e-4  # train.py:43 quirk
    return lr0, math.exp(math.log(cfg.lr_final / cfg.lr_init) / cfg.num_iters)


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.Adam:
    lr0, _ = lr_schedule(cfg)
    return torch.optim.Adam(params, lr=lr0, betas=(0.9, 0.999), eps=1e-8)


@dataclasses.dataclass
class TrainState:
    """The field, its optimizer, the step count and the generator that
    draws batches and samples, on the training device."""

    field: NerfField
    optimizer: torch.optim.Adam
    generator: torch.Generator
    step: int = 0


def make_train_state(cfg: TrainConfig, model: NerfMLP, device) -> TrainState:
    """Weights from the numpy seed ``cfg.seed`` (the JAX package draws
    them from a JAX key: the two inits differ), generator seeded alike."""
    field = NerfField.from_jax_params(init_nerf_params(cfg.seed, model), device, model)
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed)
    return TrainState(field, make_optimizer(cfg, field.parameters()), gen)


def build_x16(rays_b: torch.Tensor, ts: torch.Tensor, pix_b: torch.Tensor) -> torch.Tensor:
    """The fused step's (16, B*N) input: sample xyz along the unnormalised
    direction, unit dirs, ts, and the gt colour on every sample."""
    B, N = ts.shape
    oT, dT = rays_b[:, :3].T, rays_b[:, 3:6].T
    x = torch.zeros((16, B, N), dtype=torch.float32, device=rays_b.device)
    x[0:3] = oT[:, :, None] + dT[:, :, None] * ts[None]
    x[3:6] = (dT / torch.linalg.vector_norm(dT, dim=0, keepdim=True))[:, :, None]
    x[6] = ts
    x[8:11] = pix_b.T[:, :, None]
    return x.reshape(16, B * N)


def build_train_step(cfg: TrainConfig, model: NerfMLP, fused: bool | None = None):
    """``step_fn(state, rays, pixels) -> loss``: one iteration on the
    resident ray set, the loss left on the device (no sync)."""
    if fused is None:
        fused = cfg.backend == "pallas"
    if fused and cfg.backend != "pallas":
        raise ValueError("the fused train step is the pallas backend's")
    if cfg.backend == "pallas" and not fused:
        warnings.warn(
            "backend='pallas' requested but the fused train kernel is not used "
            "(fused=False); running autograd through fused_mlp instead",
            stacklevel=2,
        )
    settings = RenderSettings(
        N=cfg.Nf, tn=cfg.tn, tf=cfg.tf, sampling_space=cfg.sampling_space,
        compute_dtype=cfg.render_dtype, backend=cfg.backend,
    )
    lr0, decay = lr_schedule(cfg)

    def core(field, rays_b, pix_b, ts):
        if fused:
            wts = pack_weights(field, differentiable=True)
            loss, dwts = fused_train_step(wts, build_x16(rays_b, ts, pix_b), cfg.Nf,
                                          cfg.render_dtype, model)
            torch.autograd.backward(list(wts), list(dwts))
            return loss
        out = render_rays(field, rays_b, None, settings, ts=ts)
        loss = torch.mean((out.rgb - pix_b) ** 2)  # raw-colour MSE, train.py:52
        loss.backward()
        return loss.detach()

    def step_fn(state: TrainState, rays: torch.Tensor, pixels: torch.Tensor) -> torch.Tensor:
        g = state.generator
        idx = torch.randint(0, rays.shape[0], (cfg.batch_size,), generator=g, device=rays.device)
        ts = stratified_ts_spaced(g, cfg.batch_size, cfg.Nf, cfg.tn, cfg.tf, rays.device,
                                  space=cfg.sampling_space)
        state.optimizer.zero_grad(set_to_none=True)
        loss = core(state.field, rays[idx], pixels[idx], ts)
        for group in state.optimizer.param_groups:
            group["lr"] = lr0 * decay**state.step
        state.optimizer.step()
        state.step += 1
        return loss

    return step_fn
