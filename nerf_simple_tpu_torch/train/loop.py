"""The training loop (port of nerf_simple_tpu/train/loop.py: one network,
the hierarchical coarse + fine pair, the proposal scheme, or one network
casting cones, mip-NeRF's path).

Same observable behaviour as the reference ``train()`` (train.py:28-91)
and the JAX loop: loss and lr every ``ckpt_loss`` iterations, train and
val renders with MSE/PSNR/SSIM every ``ckpt_images`` (hierarchical runs
render with both nets, ``N_coarse = Nc``; proposal runs with the proposal
net placing the main field's samples, ``N_prop = Np``; mip runs cast
cones with the train frames' radius, ``2 / sqrt(12) / focal``), a checkpoint
every ``ckpt_model`` and at the end, then ``params_<step>.npz`` (both
nets of a hierarchical or proposal run) and ``.pth`` (the reference's
single-network format: the fine net of a two-net run) exports that this
package's server and the JAX package both load.

The loss of every step stays on the device. The host waits for the card
only at the end of a chunk of ``steps_per_call`` iterations that holds a
log, image or checkpoint iteration (``chunk_schedule``), so the host
queues steps ahead of the card. it/s and rays/s are timed between those
syncs by CUDA events on the card (by the host clock on a CPU run), from
the second sync on: the first window holds the kernel builds.

Pose refinement (``pose_opt``): the state holds one camera delta a train
image; train-split renders use the refined poses (val poses are never
refined), and before ``pe_anneal_until`` they render with the annealed
encoder the field is being trained with. ``pose_freeze_at`` is aligned up
to a ``steps_per_call`` boundary (JAX's rule): there the deltas go to
``<exp_dir>/cam_deltas.npz`` (``dr``, ``dt``, ``freeze_step``), are baked
into the training rays, the state drops them (``freeze_pose_state``) and
the run finishes on the plain config's step (the fused kernel under
``"pallas"``). A checkpoint at the boundary is pre-freeze; a resume past
it re-bakes from the sidecar.

Multiscale training (``mip_multiscale``): the sampler draws from the
train images' 1, 1/2, 1/4 and 1/8 pyramid (8-column rays with their cone
radii and loss weights); the renders, checkpoints and exports are those of
a mip run. ``train_im_idxs`` restricts the sampler to the listed train
images. ``dataset: tiny_nerf`` reads the scene from a tiny_nerf npz.

Appearance codes (``appearance_dim``): the state holds one code a train
image; train-split renders use the image's own code, val renders the
mean code (NeRF-W's canonical look). The checkpoints and
``params_<N>.npz`` carry the JAX ``{"field", "app"[, "cams"]}`` params;
the reference-format ``.pth`` export is skipped (the widened colour head
does not fit the reference ``Nerf``), as JAX skips it.

Occupancy (``occupancy``): the state holds the grid (train/step.py) and
the previews render with the live grid, as eval would (JAX loop.py:294-297).

``profile_dir``: the first two chunks run before the walk, and the second
is traced with ``torch.profiler`` into a Chrome trace under ``profile_dir``
(utils/profiling.py; JAX loop.py:419-450); the rate is measured from the
walk on. The trace is skipped, with JAX's message, when fewer than two
chunks are left or when the two would cross ``pose_freeze_at``.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Any

import numpy as np
import torch

from nerf_simple_tpu_torch.config import TrainConfig, train_config_from_dict
from nerf_simple_tpu_torch.data.blender import load_scene
from nerf_simple_tpu_torch.data.dataset import RayDataset, multiscale_train_arrays
from nerf_simple_tpu_torch.models import model_from_train_config
from nerf_simple_tpu_torch.ops.rays import apply_cam_deltas, bake_cam_deltas
from nerf_simple_tpu_torch.render.renderer import render_rays_chunked
from nerf_simple_tpu_torch.train import checkpoint as ckpt
from nerf_simple_tpu_torch.train.metrics import img_mse, img_psnr, img_ssim
from nerf_simple_tpu_torch.train.step import (
    TrainState,
    build_train_step,
    freeze_pose_state,
    lr_schedule,
    make_train_state,
    render_settings,
)
from nerf_simple_tpu_torch.utils.device import require_device
from nerf_simple_tpu_torch.utils.profiling import trace_context
from nerf_simple_tpu_torch.utils.tb import Logger, run_log_dir


def chunk_schedule(start: int, num_iters: int, steps_per_call: int, boundary_everys: tuple[int, ...]):
    """Chunks covering [start, num_iters): full ``steps_per_call`` chunks
    and one remainder; a chunk is a ``boundary`` (the host syncs after
    it) if an iteration in it hits a cadence of ``boundary_everys`` or it
    is the last. Yields ``(chunk_start, chunk_len, boundary)``."""
    n_total = num_iters - start
    if n_total <= 0:
        return
    remainder = n_total % steps_per_call
    n_chunks = -(-n_total // steps_per_call)
    for c in range(n_chunks):
        chunk_start = start + c * steps_per_call
        last = c == n_chunks - 1
        spc = remainder if (last and remainder) else steps_per_call
        boundary = last or any(
            (chunk_start + j) % every == 0 for every in boundary_everys for j in range(spc)
        )
        yield chunk_start, spc, boundary


class SteadyStateMeter:
    """Iterations and seconds between syncs, from the second sync on."""

    def __init__(self, rays_per_iter: int, device: torch.device):
        self.rays_per_iter = rays_per_iter
        self.cuda = device.type == "cuda"
        self._first: tuple[int, Any] | None = None
        self.iters, self.seconds = 0, 0.0

    def _mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            ev.synchronize()
            return ev
        return time.perf_counter()

    def sync(self, iters_done: int) -> None:
        mark = self._mark()
        if self._first is None:
            self._first = (iters_done, mark)
            return
        it0, m0 = self._first
        self.iters = iters_done - it0
        self.seconds = m0.elapsed_time(mark) / 1e3 if self.cuda else mark - m0

    @property
    def iters_per_sec(self) -> float:
        return self.iters / max(self.seconds, 1e-9)

    @property
    def rays_per_sec(self) -> float:
        return self.iters_per_sec * self.rays_per_iter


def train(params_or_cfg: dict[str, Any] | TrainConfig, device="cuda") -> TrainState:
    """Run training from a reference-schema config dict or a TrainConfig,
    on ``device`` (default: the card; the CPU only when asked for).
    Returns the final TrainState."""
    cfg = (params_or_cfg if isinstance(params_or_cfg, TrainConfig)
           else train_config_from_dict(params_or_cfg))
    device = require_device(device)
    model = model_from_train_config(cfg)
    exp_dir = os.path.join(cfg.savepath, cfg.exp_name)
    ckpt.save_model_meta(exp_dir, model)
    logger = Logger(run_log_dir(cfg.log_dir))

    data = load_scene(cfg.dataset, cfg.datapath, cfg.half_res, cfg.num_train_imgs, white_bkgd=cfg.white_bkgd)
    rd = RayDataset.from_blender(data, device)
    rays, pixels = rd.rays["train"], rd.pixels["train"]
    # mip's cone radius: a pixel's world-space half-width at unit distance
    # (2 / sqrt(12) times the direction grid's spacing 1 / f; mip-NeRF sec. 3.1)
    base_radius = 2.0 / math.sqrt(12.0) / rd.f if cfg.mip else 0.0
    if cfg.mip_multiscale:  # the pyramid's 8-column rays: only the sampler's pool; renders and checkpoints as before
        rays, pixels = multiscale_train_arrays(data, base_radius, device)
    if cfg.depth_loss_weight > 0:  # the metric depth rides as a 4th pixel channel (step.py splits it)
        md = data.splits["train"].metric_depth
        if md is None:
            raise ValueError(
                "depth_loss_weight > 0 but the train split has no metric depth sidecars "
                f"({cfg.datapath}/depth/train/r_<i>.npy — data/synthetic.py "
                "write_blender_scene(write_depth=True) emits them)"
            )
        pixels = torch.cat([pixels, torch.as_tensor(md.reshape(-1, 1), device=device)], dim=1)

    n_pix = rd.H * rd.W
    # two-phase pose refinement: the freeze at the first steps_per_call
    # boundary >= pose_freeze_at, then the plain config
    freeze_at, cfg_frozen = 0, cfg
    if cfg.pose_opt and cfg.pose_freeze_at:
        freeze_at = min(-(-cfg.pose_freeze_at // cfg.steps_per_call) * cfg.steps_per_call, cfg.num_iters)
        cfg_frozen = dataclasses.replace(cfg, pose_opt=False, pose_freeze_at=0, pe_anneal_until=0)
    frozen, cam_tbl = False, None  # after the freeze: the baked deltas, numpy (dr, dt)
    sidecar = os.path.join(exp_dir, "cam_deltas.npz")
    aux = cfg.pose_opt or cfg.appearance_dim > 0  # per-image tables: one row a train image
    state = make_train_state(cfg, model, device, n_images=rd.split_size("train") // n_pix if aux else None)
    if cfg.resume:
        latest = ckpt.latest_checkpoint(exp_dir)
        if latest is not None:
            # a checkpoint at the boundary is pre-freeze (the freeze saves none)
            if freeze_at and ckpt.checkpoint_step(latest) > freeze_at:
                if not os.path.exists(sidecar):
                    raise FileNotFoundError(
                        f"resuming past pose_freeze_at ({ckpt.checkpoint_step(latest)} > {freeze_at}) but {sidecar} "
                        "is missing: cannot re-apply the baked pose refinement")
                with np.load(sidecar) as d:
                    cam_tbl = (d["dr"], d["dt"])
                rays = bake_cam_deltas(rays, *(torch.as_tensor(t, device=device) for t in cam_tbl), n_pix)
                state, frozen = make_train_state(cfg_frozen, model, device), True
            ckpt.restore_checkpoint(latest, state)
            print(f"resumed from {latest} at step {state.step}")
    step_fns = {}

    def step_fn_for(pose: bool):
        """The step of the pose phase, or of the plain config (after a
        freeze, or without pose refinement), built at first use."""
        if pose not in step_fns:
            c = cfg if pose else cfg_frozen
            step_fns[pose] = build_train_step(c, model, base_radius=base_radius,
                                              **({"rays_per_image": n_pix} if aux or cfg.train_im_idxs else {}))
        return step_fns[pose]

    eval_settings = dataclasses.replace(render_settings(cfg, base_radius), sigma_noise=0.0)  # no training noise
    lr0, decay = lr_schedule(cfg)

    def render_and_log(split: str, ii: int, i: int) -> None:
        n = rd.H * rd.W
        if ii >= rd.split_size(split) // n:
            print(f"skipping {split} render {ii}: split has {rd.split_size(split) // n} images")
            return
        rays_img = rd.rays[split][ii * n : (ii + 1) * n]
        if cfg.pose_opt and split == "train":  # the refined pose, what the field is fit to
            if frozen:
                dr_i, dt_i = (torch.as_tensor(t[ii], device=device) for t in cam_tbl)
            else:
                dr_i, dt_i = state.cams.dr.detach()[ii], state.cams.dt.detach()[ii]
            rays_img = apply_cam_deltas(rays_img, dr_i.expand(n, 3), dt_i.expand(n, 3))
        # mid-anneal previews render with the encoder the field is being trained with
        enc_alpha = None
        if cfg.pe_anneal_until > 0 and not frozen and i + 1 < cfg.pe_anneal_until:
            enc_alpha = (i + 1) / cfg.pe_anneal_until
        app = None
        if state.app is not None:  # the image's own code; val views have none: the mean code
            table = state.app.table.detach()
            app = table[ii] if split == "train" else table.mean(0)
        rgb, disp = render_rays_chunked(state.field, rays_img, cfg.seed + i, eval_settings, chunk=16384,
                                        enc_alpha=enc_alpha, app=app, occ=state.occ if cfg.occupancy else None)
        rgb = rgb.reshape(1, rd.H, rd.W, 3).cpu().numpy()
        disp = disp.reshape(1, rd.H, rd.W, 1).cpu().numpy()
        gt = rd.pixels[split][ii * n : (ii + 1) * n].reshape(1, rd.H, rd.W, 3).cpu().numpy()
        tag = "train" if split == "train" else "Val"
        logger.images(f"{tag}/RGB_{ii}", rgb, i + 1)
        logger.images(f"{tag}/Depth_{ii}", disp / max(disp.max(), 1e-9), i + 1)
        logger.images(f"{tag}/GT_{ii}", gt, i + 1)
        psnr = img_psnr(gt, rgb)
        logger.scalar(f"Loss/{tag}_Img_MSE_{ii}", img_mse(gt, rgb), i + 1)
        logger.scalar(f"Loss/{tag}_Img_PSNR_{ii}", psnr, i + 1)
        line = f"{tag} image {ii} | iter: {i + 1} | PSNR {psnr:.3f}"
        if min(rd.H, rd.W) >= 11:  # SSIM needs one full 11x11 window
            ssim = img_ssim(gt, rgb)
            logger.scalar(f"Loss/{tag}_Img_SSIM_{ii}", ssim, i + 1)
            line += f" | SSIM {ssim:.4f}"
        print(line)

    meter = SteadyStateMeter(cfg.batch_size, device)
    start = state.step

    def walk(w_start: int, w_end: int) -> None:
        step_fn = step_fn_for(cfg.pose_opt and not frozen)
        for chunk_start, spc, boundary in chunk_schedule(
            w_start, w_end, cfg.steps_per_call, (cfg.ckpt_loss, cfg.ckpt_images, cfg.ckpt_model)
        ):
            losses = torch.stack([step_fn(state, rays, pixels) for _ in range(spc)])
            if not boundary:
                continue
            losses = losses.cpu().numpy()  # the host waits for the card here
            meter.sync(chunk_start + spc - start)
            for j, loss in enumerate(losses):
                i = chunk_start + j
                if i % cfg.ckpt_loss == 0:
                    logger.scalar("Loss/train", float(loss), i + 1)
                    logger.scalar("Train/lr", lr0 * decay ** (i + 1), i + 1)
                    rate = (f"{meter.iters_per_sec:.1f} it/s | {meter.rays_per_sec:,.0f} rays/s"
                            if meter.iters else "warmup (kernel builds)")
                    print(f"loss: {float(loss):.6f} | iter: {i + 1} | {rate}")
            i_last = chunk_start + spc - 1
            if any((chunk_start + j) % cfg.ckpt_images == 0 for j in range(spc)):
                for ii in cfg.val_idxs:
                    render_and_log("train", ii, i_last)
                    render_and_log("val", ii, i_last)
            if any((chunk_start + j) % cfg.ckpt_model == 0 for j in range(spc)):
                print(f"saved checkpoint {ckpt.save_checkpoint(exp_dir, state)}")

    def do_freeze() -> None:
        """Persist and bake the deltas, drop them from the state (Adam's
        moments carry over), and take the plain step from here on."""
        nonlocal state, rays, frozen, cam_tbl, meter, start
        tables = state.cams.tables()
        np.savez(sidecar, dr=tables["dr"], dt=tables["dt"], freeze_step=state.step)
        rays = bake_cam_deltas(rays, state.cams.dr.detach(), state.cams.dt.detach(), n_pix)
        state = freeze_pose_state(state)
        cam_tbl, frozen = (tables["dr"], tables["dt"]), True
        meter, start = SteadyStateMeter(cfg.batch_size, device), state.step  # the plain step's rate from here
        print(f"pose freeze at step {state.step}: deltas baked into the ray set (|dr| max "
              f"{np.abs(tables['dr']).max():.4f} rad, |dt| max {np.abs(tables['dt']).max():.4f}); continuing on "
              f"the plain {cfg.backend} step")

    if cfg.profile_dir and freeze_at and not frozen and start + 2 * cfg.steps_per_call > freeze_at:
        # the two chunks run outside the walk, on the pose step: past the boundary they would train poses
        # beyond the configured freeze
        print(f"profile_dir set but the trace chunks would cross pose_freeze_at ({freeze_at}); skipping trace "
              "(profile a resumed post-freeze run instead)")
    elif cfg.profile_dir and cfg.num_iters - start >= 2 * cfg.steps_per_call:
        step_fn = step_fn_for(cfg.pose_opt and not frozen)
        for traced in (False, True):  # the first chunk builds the kernels; the second is traced
            with trace_context(cfg.profile_dir if traced else None) as prof:
                torch.stack([step_fn(state, rays, pixels) for _ in range(cfg.steps_per_call)]).cpu()
        print(f"wrote trace {prof.trace_path}")
        meter, start = SteadyStateMeter(cfg.batch_size, device), state.step  # the rate from the walk on
    elif cfg.profile_dir:
        print(f"profile_dir set but only {cfg.num_iters - start} iters remain (< 2*steps_per_call="
              f"{2 * cfg.steps_per_call}); skipping trace")

    if freeze_at and not frozen:
        walk(start, freeze_at)
        do_freeze()
        walk(state.step, cfg.num_iters)
    else:
        walk(start, cfg.num_iters)

    path = ckpt.save_checkpoint(exp_dir, state)
    params = state.field.to_jax_params()
    # per-image tables still training ride beside the field (the JAX {"field", "cams"/"app"} params)
    ckpt.export_params_npz(os.path.join(exp_dir, f"params_{state.step}.npz"), ckpt.state_params(state))
    if cfg.appearance_dim == 0:  # the widened colour head does not fit the reference Nerf (JAX loop.py:521)
        ckpt.export_params_pth(os.path.join(exp_dir, f"params_{state.step}.pth"), params.get("fine", params))
    rate = (f"{meter.iters_per_sec:.1f} it/s | {meter.rays_per_sec:,.0f} rays/s (steady-state)"
            if meter.iters else "steady-state throughput n/a (one synced chunk)")
    print(f"final checkpoint {path} | {rate}")
    logger.close()
    return state


def main(argv=None) -> None:
    import argparse

    from nerf_simple_tpu_torch.config import load_yaml

    ap = argparse.ArgumentParser(description="Train a NeRF (PyTorch port)")
    ap.add_argument("--config_path", required=True, help="reference-schema YAML config")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda; cpu only when asked for)")
    args = ap.parse_args(argv)
    train(load_yaml(args.config_path), device=args.device)
