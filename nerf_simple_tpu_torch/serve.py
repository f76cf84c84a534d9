"""Novel-view render server (port of nerf_simple_tpu/serve.py).

    python -m nerf_simple_tpu_torch.serve --loadpath models/exp/params_10000.npz \\
        --height 400 --width 400 --focal 555.0 --backend pallas [--port 8000] \\
        [--proposal-samples 64] [--mip [--mip-levels 2] [--resample-blur B] [--opaque-background]] \\
        [--occupancy [--occ-R 64]]

Endpoints:
  GET /health                  -> {"status": "ok", ...}
  GET /render?r=4&theta=-30&phi=120  -> image/png

With ``--proposal-samples Np`` (a proposal-trained checkpoint, its
``{prop, fine}`` params) the proposal net at Np probes places the
``--samples`` of the main field in each frame. With ``--mip`` (a
mip-trained checkpoint) each frame casts cones of radius ``2 / sqrt(12) /
focal``, at ``--mip-levels`` 1 or 2; with both (a mip x proposal
checkpoint, mip-NeRF 360's composition) the proposal net places the
cones' edges. With ``--occupancy`` the server rebuilds an ``--occ-R``
occupancy grid once from the field (a fixed seed) and each frame draws its
samples from it (deterministic quantiles); not with ``--mip``. The params
live on one device. Renders are serialised through a lock
(one card, one render at a time). PNGs are encoded with the standard
library (utils/png.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from nerf_simple_tpu_torch.kernels.mlp import fused_mlp_forward
from nerf_simple_tpu_torch.models import infer_model
from nerf_simple_tpu_torch.models.nerf import NerfField
from nerf_simple_tpu_torch.models.proposal import ProposalPair, infer_proposal_arch
from nerf_simple_tpu_torch.ops.occupancy import rebuild_occ
from nerf_simple_tpu_torch.ops.rays import rays_for_poses, spherical_to_pose
from nerf_simple_tpu_torch.render.renderer import RenderSettings, render_rays_chunked
from nerf_simple_tpu_torch.utils.png import decode_png, encode_png  # noqa: F401 (re-exported)


class RenderServer:
    """Holds the field on its device; thread-safe ``render()``."""

    def __init__(
        self,
        params,
        H: int,
        W: int,
        f: float,
        settings: RenderSettings | None = None,
        model=None,
        warmup: bool = True,
        device="cuda",
        occupancy: bool = False,
        occ_R: int = 64,
    ):
        self.device = torch.device(device)
        self.model = model or infer_model(params)
        self.settings = settings or RenderSettings()
        if self.settings.mip and occupancy:  # JAX serve.py:59-68
            raise ValueError(
                "mip serving excludes hierarchical/occupancy sampling: cone casting draws its own interval edges "
                "(mip_levels=2 is the cone-cast hierarchical scheme); proposal-guided mip serving IS supported "
                "(--proposal-samples)")
        self.prop_model = None
        if self.settings.N_prop > 0:
            if not (isinstance(params, dict) and "prop" in params):
                raise ValueError(
                    "settings.N_prop > 0 needs a proposal-trained checkpoint ({'prop', 'fine'} params)"
                )
            # the arch from the weight shapes; contract, which they cannot tell, from the main model (JAX serve.py:96-99)
            self.prop_model = dataclasses.replace(infer_proposal_arch(params["prop"]), contract=self.model.contract)
            self.field = ProposalPair.from_jax_params(params, self.device, self.model, self.prop_model)
        else:
            self.field = NerfField.from_jax_params(params, self.device, self.model)
        self.H, self.W, self.f = H, W, float(f)
        self.occ = None
        if occupancy:  # derived state: one rebuild from the field, a fixed seed (JAX serve.py:102-115)
            self.occ = rebuild_occ(self.field, self.settings.backend, self.settings.compute_dtype, occ_R,
                                   self.settings.occ_aabb, 42)
        self._lock = threading.Lock()
        self.seed = 0
        if warmup:
            self.render(4.0, -30.0, 0.0)  # builds the kernel on first use

    def render(self, r: float, theta: float, phi: float) -> np.ndarray:
        """One (H, W, 3) uint8 frame from spherical camera coords (the
        reference's dome parametrisation, utils/xyz.py:70-81)."""
        pose = torch.as_tensor(
            spherical_to_pose(r, theta, phi)[None], dtype=torch.float32, device=self.device
        )
        with self._lock:
            rays = rays_for_poses(pose, self.H, self.W, self.f)
            rgb, _ = render_rays_chunked(self.field, rays, self.seed, self.settings, occ=self.occ)
            frame = rgb.reshape(self.H, self.W, 3).cpu().numpy()
        return (np.clip(frame, 0.0, 1.0) * 255).astype(np.uint8)


def _make_handler(server: RenderServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, ctype: str, body: bytes) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj) -> None:
            self._send(code, "application/json", json.dumps(obj).encode())

        def do_GET(self):  # noqa: N802 (http.server API)
            u = urlparse(self.path)
            if u.path == "/health":
                self._json(200, {
                    "status": "ok",
                    "frame": [server.H, server.W],
                    "model": type(server.model).__name__,
                    "arch": dataclasses.asdict(server.model),
                    "backend": server.settings.backend,
                    "occupancy": server.occ is not None,
                    "proposal": server.prop_model is not None,
                    "mip": server.settings.mip,
                    "device": str(server.device),
                    "kernel_launches": fused_mlp_forward.launches,
                })
                return
            if u.path != "/render":
                self._json(404, {"error": f"unknown path {u.path}"})
                return
            q = parse_qs(u.query)

            def num(name, default):
                return float(q[name][0]) if name in q else default

            try:
                frame = server.render(num("r", 4.0), num("theta", -30.0), num("phi", 0.0))
            except Exception as e:  # the server keeps running: report as 500
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._send(200, "image/png", encode_png(frame))

    return Handler


def serve(server: RenderServer, port: int = 8000) -> ThreadingHTTPServer:
    """Start the HTTP server (returns it; call .serve_forever())."""
    return ThreadingHTTPServer(("0.0.0.0", port), _make_handler(server))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="NeRF novel-view render server (PyTorch)")
    ap.add_argument("--loadpath", required=True, help="params .npz or .pth")
    ap.add_argument("--height", type=int, required=True)
    ap.add_argument("--width", type=int, required=True)
    ap.add_argument("--focal", type=float, required=True)
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--backend", default="xla", choices=["xla", "pallas"])
    ap.add_argument("--dtype", default="f32", choices=["f32", "bf16"])
    ap.add_argument("--samples", type=int, default=128)
    ap.add_argument("--device", default="cuda", help="torch device to serve from")
    ap.add_argument("--occupancy", action="store_true")
    ap.add_argument("--occ-R", type=int, default=64)
    ap.add_argument("--proposal-samples", type=int, default=0)
    ap.add_argument("--mip", action="store_true")
    ap.add_argument("--mip-levels", type=int, default=1, choices=[1, 2])
    ap.add_argument("--resample-blur", type=float, default=0.01)
    ap.add_argument("--opaque-background", action="store_true")
    ap.add_argument("--tn", type=float, default=2.0)
    ap.add_argument("--tf", type=float, default=6.0)
    ap.add_argument("--sampling-space", default="linear", choices=["linear", "disparity"])
    args = ap.parse_args(argv)

    from nerf_simple_tpu_torch.evaluate import load_params
    from nerf_simple_tpu_torch.train.checkpoint import load_model_meta

    settings = RenderSettings(
        N=args.samples,
        N_prop=args.proposal_samples,
        tn=args.tn,
        tf=args.tf,
        sampling_space=args.sampling_space,
        backend=args.backend,
        compute_dtype=torch.bfloat16 if args.dtype == "bf16" else torch.float32,
        mip=args.mip,
        mip_levels=args.mip_levels,
        resample_blur=args.resample_blur,
        opaque_background=args.opaque_background,
        # a pixel's world-space half-width at unit distance (mip-NeRF sec. 3.1)
        base_radius=2.0 / 12.0**0.5 / args.focal if args.mip else 0.0,
    )
    params = load_params(args.loadpath, keep_hierarchy=args.proposal_samples > 0)
    model = load_model_meta(args.loadpath)  # None -> inferred from shapes
    srv = RenderServer(
        params, args.height, args.width, args.focal, settings, model=model,
        device=args.device, occupancy=args.occupancy, occ_R=args.occ_R,
    )
    httpd = serve(srv, args.port)
    print(f"serving on :{args.port} (frame {args.height}x{args.width}, "
          f"{args.backend}/{args.dtype}, N={args.samples}"
          + (f", Np={args.proposal_samples}" if args.proposal_samples > 0 else "")
          + (f", mip levels {args.mip_levels}" if args.mip else "")
          + (f", occupancy grid {args.occ_R}^3" if args.occupancy else "") + f", {srv.device})")
    httpd.serve_forever()


if __name__ == "__main__":
    main()
