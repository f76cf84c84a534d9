"""Eval entry point: stills with metrics, and the orbit video (port of
nerf_simple_tpu/evaluate.py, the point-sampled Blender path).

    python -m nerf_simple_tpu_torch.evaluate --config_path configs/lego.yaml [--device cuda|cpu]

Reads the config's ``test_params`` (``TestConfig``), loads the weights,
then either renders the orbit video (``animation``: radius
``orbit_radius``, elevation ``-theta``, ``num_poses`` frames) or renders
``im_idxs`` of ``im_set``: ``rgb_<i>.png`` (gt beside prediction),
``depth_<i>.png`` (disparity over its max) and, with ``normals``,
``normal_<i>.png``, printing mse/psnr/ssim a still and the metric-depth
RMSE where the scene has depth sidecars. The reference's equivalent is
``test()`` (test.py:18-45). With ``Nc > 0`` eval is hierarchical: the
checkpoint's coarse and fine nets, Nc stratified samples and N_samples
deterministic importance samples a ray. With ``Np > 0`` it renders with
the proposal scheme: the checkpoint's proposal net at Np probes (bin
midpoints) places N_samples deterministic samples of its main field.
With ``mip`` it casts cones (at ``mip_levels`` 1 or 2), their radius
``2 / sqrt(12) / focal`` of the eval frames; normals render point samples.
A pose-refined run's train-split stills render from the refined poses:
the camera deltas of the checkpoint's ``{"field", "cams"}`` params, or
after a pose freeze those of the ``cam_deltas.npz`` sidecar beside it,
baked into the train rays; val and test poses are never refined. An
appearance checkpoint (``{"field", "app"}``) renders its stills, normals
and orbit under one code: the table's mean for ``appearance_idx`` -1
(NeRF-W's canonical look), else train image ``appearance_idx``'s.

Mip with Np (mip-NeRF 360), occupancy eval, LLFF (spiral path, NDC),
the tiny_nerf loader, sharded eval and Orbax checkpoint directories are
not ported: each raises NotImplementedError.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import re
import warnings
from typing import Any

import numpy as np
import torch

from nerf_simple_tpu_torch.config import TestConfig, load_yaml, test_config_from_dict


def load_params(loadpath: str, return_aux: bool = False, keep_hierarchy: bool = False):
    """Numpy params pytree from an npz export, a reference .pth, a
    ``ckpt_<step>.pth`` checkpoint, or an experiment directory (its latest
    ``ckpt_<step>.pth``). ``{"field", ...}`` wrappers (pose/appearance
    training) unwrap to the field, and ``return_aux`` also returns the
    rest as a dict; ``{coarse, fine}`` and ``{prop, fine}`` checkpoints
    give the fine net unless ``keep_hierarchy`` (hierarchical or proposal
    eval)."""
    from nerf_simple_tpu_torch.train import checkpoint as ckpt

    name = os.path.basename(os.path.normpath(loadpath))
    if os.path.isdir(loadpath) and not name.startswith("ckpt_"):
        found = ckpt.latest_checkpoint(loadpath)
        if found is None:
            if any(n.startswith("ckpt_") for n in os.listdir(loadpath)):
                raise NotImplementedError(
                    f"{loadpath!r} holds Orbax ckpt_* directories, which are not readable "
                    "without orbax; export the params to .npz or .pth first (ROADMAP Queue A, "
                    "checkpoint full state)"
                )
            raise FileNotFoundError(f"no ckpt_*.pth under {loadpath}")
        loadpath, name = found, os.path.basename(found)
    if loadpath.endswith(".npz"):
        params = ckpt.import_params_npz(loadpath)
    elif re.fullmatch(r"ckpt_\d+\.pth", name):
        params = ckpt.checkpoint_params(loadpath)
    elif loadpath.endswith((".pth", ".pt")):
        params = ckpt.import_params_pth(loadpath)
    else:
        raise NotImplementedError(
            f"{loadpath!r}: Orbax checkpoint directories are not readable "
            "without orbax; export the params to .npz or .pth first "
            "(ROADMAP Queue A, checkpoint full state)"
        )
    aux = {}
    if isinstance(params, dict) and "field" in params:
        aux = {k: v for k, v in params.items() if k != "field"}
        params = params["field"]
    if "fine" in params and not keep_hierarchy:
        params = params["fine"]
    return (params, aux) if return_aux else params


def _model_for(cfg: TestConfig, params):
    """The model of the ``model.json`` sidecar, else inferred from the
    weight shapes, with the JAX package's warning (given, as there, only
    when the inferred model is not contracted: the shapes never say so)."""
    from nerf_simple_tpu_torch.models import infer_model
    from nerf_simple_tpu_torch.train.checkpoint import load_model_meta

    model = load_model_meta(cfg.loadpath)
    if model is None:
        model = infer_model(params)
        if not model.contract:
            warnings.warn(
                "no model.json sidecar next to the checkpoint; the "
                "architecture was inferred from weight shapes, which "
                "cannot recover shape-invariant fields (contract=False "
                "assumed — a contracted checkpoint would render wrong). "
                "Keep the sidecar with the weights.",
                stacklevel=3,
            )
    return model


def cam_deltas(cfg: TestConfig, aux: dict) -> tuple[np.ndarray, np.ndarray] | None:
    """The (dr, dt) camera-delta tables a train-split still renders from
    (JAX evaluate.py:222-265): the checkpoint's live ``cams``, or the
    ``cam_deltas.npz`` sidecar of a pose freeze in the experiment dir (the
    loadpath's directory, or the directory holding a params file or a
    ``ckpt_<step>``); None for other splits, the orbit video, or a run
    without refinement."""
    if cfg.im_set != "train" or cfg.animation:
        return None
    if "cams" in aux:
        return np.asarray(aux["cams"]["dr"], np.float32), np.asarray(aux["cams"]["dt"], np.float32)
    exp = cfg.loadpath
    if not os.path.isdir(exp) or os.path.basename(os.path.normpath(exp)).startswith("ckpt_"):
        exp = os.path.dirname(os.path.normpath(exp))
    sidecar = os.path.join(exp, "cam_deltas.npz")
    if not os.path.exists(sidecar):
        return None
    with np.load(sidecar) as d:
        return d["dr"].astype(np.float32), d["dt"].astype(np.float32)


def appearance_code(cfg: TestConfig, aux: dict, model) -> np.ndarray | None:
    """The (app_dim,) code an appearance checkpoint renders with (JAX
    evaluate.py:97-106): the mean of its ``app`` table for
    ``appearance_idx`` -1, else that train image's row; None for a model
    that reads no code. An index past the table raises (JAX's gather
    clamps it)."""
    if model.app_dim == 0:
        return None
    if "app" not in aux:
        raise ValueError(f"the model reads appearance codes (app_dim={model.app_dim}) but the checkpoint holds "
                         "no 'app' table")
    table = np.asarray(aux["app"], np.float32)
    if cfg.appearance_idx < 0:
        return table.mean(axis=0)
    if cfg.appearance_idx >= len(table):
        raise IndexError(f"appearance_idx {cfg.appearance_idx} of a code table of {len(table)} train images")
    return table[cfg.appearance_idx]


def _write_png(path: str, img: np.ndarray) -> None:
    from nerf_simple_tpu_torch.utils.png import encode_png

    with open(path, "wb") as fh:
        fh.write(encode_png(img))


def test(params_or_cfg: dict[str, Any] | TestConfig, device="cuda") -> None:
    """Run evaluation per the reference test_params interface, on
    ``device`` (default: the card; the CPU only when asked for)."""
    from nerf_simple_tpu_torch.data.blender import load_blender
    from nerf_simple_tpu_torch.data.dataset import RayDataset
    from nerf_simple_tpu_torch.models.nerf import NerfField, NerfPair
    from nerf_simple_tpu_torch.models.proposal import ProposalPair, infer_proposal_arch
    from nerf_simple_tpu_torch.ops.rays import bake_cam_deltas, orbit_poses
    from nerf_simple_tpu_torch.render.renderer import (
        RenderSettings,
        derive_seed,
        render_image,
        render_normals_chunked,
        render_orbit_video,
    )
    from nerf_simple_tpu_torch.train.metrics import img_mse, img_psnr, img_ssim
    from nerf_simple_tpu_torch.utils.device import require_device

    cfg = (params_or_cfg if isinstance(params_or_cfg, TestConfig)
           else test_config_from_dict(params_or_cfg))
    device = require_device(device)
    if not os.path.exists(cfg.loadpath):
        raise FileNotFoundError(f"model path doesn't exist: {cfg.loadpath}")  # test.py:19
    out_dir = os.path.join(cfg.savepath, cfg.exp_name)
    os.makedirs(out_dir, exist_ok=True)

    params, aux = load_params(cfg.loadpath, return_aux=True, keep_hierarchy=cfg.Nc > 0 or cfg.Np > 0)
    if cfg.Nc > 0 and not (isinstance(params, dict) and "coarse" in params):
        raise ValueError(
            "Nc > 0 requests hierarchical eval but the checkpoint has no coarse/fine nets"
        )
    if cfg.Np > 0 and not (isinstance(params, dict) and "prop" in params):
        raise ValueError(
            "Np > 0 requests proposal-guided eval but the checkpoint has no proposal net "
            "(train with proposal: true)"
        )
    model = _model_for(cfg, params)
    code = appearance_code(cfg, aux, model)
    app = None if code is None else torch.as_tensor(code, device=device)
    if cfg.Np > 0:  # the proposal arch from its weight shapes; contract, which they cannot tell, from the model's
        prop_model = dataclasses.replace(infer_proposal_arch(params["prop"]), contract=model.contract)
        field = ProposalPair.from_jax_params(params, device, model, prop_model)
    else:
        field = (NerfPair if cfg.Nc > 0 else NerfField).from_jax_params(params, device, model)
    data = load_blender(cfg.datapath, cfg.half_res)
    rd = RayDataset.from_blender(data, device)
    deltas = cam_deltas(cfg, aux)
    if deltas is not None:  # the train split's refined rig: only train images have deltas
        n_train = rd.split_size("train") // (rd.H * rd.W)
        if n_train == len(deltas[0]):
            rd.rays["train"] = bake_cam_deltas(rd.rays["train"], *(torch.as_tensor(t, device=device) for t in deltas),
                                               rd.H * rd.W)
        else:
            print(f"pose deltas cover {len(deltas[0])} train images but the split has {n_train}; "
                  "skipping eval-time refinement")
    settings = RenderSettings(
        N=cfg.N_samples, N_coarse=cfg.Nc, N_prop=cfg.Np, tn=cfg.tn, tf=cfg.tf, sampling_space=cfg.sampling_space,
        compute_dtype=cfg.render_dtype, backend=cfg.backend, mip=cfg.mip, mip_levels=cfg.mip_levels,
        resample_blur=cfg.resample_blur, opaque_background=cfg.opaque_background,
        # the cone radius from the eval frames' focal (JAX evaluate.py:208-211)
        base_radius=2.0 / 12.0**0.5 / rd.f if cfg.mip else 0.0,
    )

    if cfg.animation:
        poses = orbit_poses(cfg.orbit_radius, -cfg.theta, cfg.num_poses)
        out = render_orbit_video(field, poses, rd.H, rd.W, rd.f, out_dir, cfg.seed, settings,
                                 chunk=cfg.batch_size, app=app)
        print(f"wrote {out}")
        return

    print(f"saving images to {out_dir}")
    n = rd.H * rd.W
    for idx in cfg.im_idxs:
        rgb, disp = render_image(field, rd.rays[cfg.im_set], rd.H, rd.W, idx,
                                 derive_seed(cfg.seed, idx), settings, chunk=cfg.batch_size, app=app)
        gt = rd.pixels[cfg.im_set][idx * n : (idx + 1) * n].reshape(1, rd.H, rd.W, 3).cpu().numpy()
        ssim_txt = ""
        if min(rd.H, rd.W) >= 11:  # SSIM needs one full 11x11 window
            ssim_txt = f" ssim={img_ssim(gt, rgb):.4f}"
        print(f"im {idx}: mse={img_mse(gt, rgb):.5f} psnr={img_psnr(gt, rgb):.2f}" + ssim_txt)
        # gt beside prediction, like the reference's make_grid (test.py:43-44)
        _write_png(os.path.join(out_dir, f"rgb_{idx}.png"),
                   (np.concatenate([gt[0], rgb[0]], axis=1) * 255).astype(np.uint8))
        d = disp[0, ..., 0]
        md = data.splits[cfg.im_set].metric_depth
        if md is not None:
            # the predicted depth is 1 / disparity = depth / acc
            depth_pred = 1.0 / np.maximum(d, 1e-10)
            valid = np.isfinite(md[idx]) & (md[idx] > 0)
            rmse = float(np.sqrt(np.mean((depth_pred - md[idx])[valid] ** 2)))
            print(f"im {idx}: depth_rmse={rmse:.4f} (metric GT)")
        d = d / max(d.max(), 1e-9)
        _write_png(os.path.join(out_dir, f"depth_{idx}.png"), (d * 255).astype(np.uint8))
        if cfg.normals:
            nrm = render_normals_chunked(field, rd.rays[cfg.im_set][idx * n : (idx + 1) * n],
                                         derive_seed(cfg.seed, 1000 + idx), settings,
                                         chunk=cfg.batch_size)
            nrm = nrm.reshape(rd.H, rd.W, 3).cpu().numpy()
            _write_png(os.path.join(out_dir, f"normal_{idx}.png"),
                       ((nrm * 0.5 + 0.5) * 255).astype(np.uint8))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Render NeRF stills or the orbit video (PyTorch)")
    ap.add_argument("--config_path", required=True, help="reference-schema YAML config")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda; cpu only when asked for)")
    args = ap.parse_args(argv)
    test(load_yaml(args.config_path), device=args.device)


if __name__ == "__main__":
    main()
