"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's novel-view server (nerf_simple_tpu_torch) at the
flagship width, NerfMLP(Lp=10, Ld=4, H=256), with random weights from a
numpy seed:

1. device: refuses to run without CUDA; prints the card's name and power
   limit as nvidia-smi reports them;
2. build: compiles the CUDA kernel from csrc/ and prints the build time;
3. kernel vs plain: the fused MLP forward against its plain PyTorch
   version on one render chunk (16,384 rays of a 400x400, f=555 frame x
   128 stratified samples = 2,097,152 rows), f32 and bf16, max abs error
   against the stated tolerance and CUDA-event times;
4. serve: exports the params to .npz, builds the server the way
   ``python -m nerf_simple_tpu_torch.serve --backend pallas`` does,
   serves it over HTTP on localhost, requests /health and three 400x400
   frames, checks the PNGs and that the kernel's launch counter rose
   during the requests, then renders one pose with both backends and
   compares the frames.

Every failed check raises, so the script exits non-zero without its last
line. The last line is one JSON object naming the device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

H = W = 400
FOCAL = 555.0
N = 128
CHUNK = 16384
SEED = 0
# Kernel vs plain, max abs error on raw rgb and sigma. f32: both sum the
# same f32 products in another order over nine chained layers (K <= 256):
# ~1e-6 relative each, so 2e-4 (the JAX kernel test's bound) is wide.
# bf16: a different summation order flips the bf16 rounding of an
# occasional activation by one ulp (2^-8 relative), which the later
# layers carry; 2e-3 bounds that at unit-scale outputs.
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-3}
# Served frame, pallas vs xla backend at f32: clipped rgb in [0, 1].
FRAME_TOL = 1e-3


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event time of ``fn`` in ms, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def chunk_input(dev):
    """xT (8, 2,097,152) for the middle chunk of a 400x400 frame, as the
    renderer builds it."""
    from nerf_simple_tpu_torch.ops.rays import rays_for_poses, spherical_to_pose
    from nerf_simple_tpu_torch.ops.sampling import stratified_ts

    pose = torch.as_tensor(spherical_to_pose(4.0, -30.0, 0.0)[None], dtype=torch.float32, device=dev)
    rays = rays_for_poses(pose, H, W, FOCAL)[72000 : 72000 + CHUNK]
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    ts = stratified_ts(g, CHUNK, N, 2.0, 6.0, dev)
    dT = rays[:, 3:6].T
    xT = torch.zeros((8, CHUNK * N), dtype=torch.float32, device=dev)
    xT[0:3] = (rays[:, :3].T[:, :, None] + dT[:, :, None] * ts[None]).reshape(3, -1)
    xT[3:6] = (dT / torch.linalg.vector_norm(dT, dim=0, keepdim=True))[:, :, None].expand(3, CHUNK, N).reshape(3, -1)
    return xT


def get(url: str) -> tuple[bytes, str]:
    with urllib.request.urlopen(url, timeout=600) as r:
        return r.read(), r.headers["Content-Type"]


def main() -> None:
    # 1. device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke test runs on the card only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    # full f32 matmuls in the plain versions (PyTorch's default; stated)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    from nerf_simple_tpu_torch.evaluate import load_params
    from nerf_simple_tpu_torch.kernels import _build
    from nerf_simple_tpu_torch.kernels.mlp import (
        _cast_weights,
        fused_mlp_forward,
        fused_mlp_forward_plain,
        pack_weights,
    )
    from nerf_simple_tpu_torch.models.nerf import NerfField, NerfMLP, init_nerf_params
    from nerf_simple_tpu_torch.ops.rays import rays_for_poses, spherical_to_pose
    from nerf_simple_tpu_torch.render.renderer import RenderSettings, render_rays_chunked
    from nerf_simple_tpu_torch.serve import RenderServer, decode_png, serve
    from nerf_simple_tpu_torch.train.checkpoint import export_params_npz, load_model_meta

    # 2. build
    fresh = not _build.library_path("fused_mlp_fwd").exists()
    t0 = time.perf_counter()
    _build.load("fused_mlp_fwd")
    print(f"build: fused_mlp_fwd {'compiled' if fresh else 'cached'} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for line in _build.build_log.get("fused_mlp_fwd", "").splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas:", line.strip())

    # 3. kernel vs plain at one full chunk
    model = NerfMLP()
    params = init_nerf_params(SEED, model)
    field = NerfField.from_jax_params(params, dev)
    xT = chunk_input(dev)
    wts = pack_weights(field)
    stats = {}
    with torch.inference_mode():
        for dt in (torch.float32, torch.bfloat16):
            w = _cast_weights(wts, dt)
            got = fused_mlp_forward(w, xT, dt, model)
            ref = fused_mlp_forward_plain(w, xT, dt, model)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), f"{dt} kernel output finite")
            check(bool((got[4:] == 0).all()), f"{dt} kernel rows 4..7 zero")
            err_rgb = (got[:3] - ref[:3]).abs().max().item()
            err_sig = (got[3] - ref[3]).abs().max().item()
            ms = cuda_ms(lambda: fused_mlp_forward(w, xT, dt, model))
            plain_ms = cuda_ms(lambda: fused_mlp_forward_plain(w, xT, dt, model))
            name = "f32" if dt == torch.float32 else "bf16"
            print(f"kernel vs plain {name} at {xT.shape[1]} rows: max abs err rgb "
                  f"{err_rgb:.3e} sigma {err_sig:.3e} (tol {TOL[dt]:.0e}); "
                  f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (median of 5)", flush=True)
            check(err_rgb <= TOL[dt] and err_sig <= TOL[dt], f"{name} kernel within tolerance")
            stats[name] = dict(err=max(err_rgb, err_sig), ms=ms, plain_ms=plain_ms)
    del xT

    # 4. serve, as `python -m nerf_simple_tpu_torch.serve --backend pallas` builds it
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "params.npz")
        export_params_npz(path, params)
        with open(os.path.join(tmp, "model.json"), "w") as fh:
            json.dump({"family": "nerf", **dataclasses.asdict(model)}, fh)
        loaded = load_params(path)
        meta_model = load_model_meta(path)
    check(meta_model == model, "model.json round trip")
    settings = RenderSettings(backend="pallas")
    srv = RenderServer(loaded, H, W, FOCAL, settings, model=meta_model, device=dev)
    httpd = serve(srv, 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    phis = (0.0, 120.0, 240.0)
    served = {}
    try:
        fused_mlp_forward.launches = 0
        health = json.loads(get(url + "/health")[0])
        check(health["status"] == "ok" and health["frame"] == [H, W], "/health")
        for phi in phis:
            t0 = time.perf_counter()
            data, ctype = get(f"{url}/render?r=4&theta=-30&phi={phi:g}")
            http_ms = (time.perf_counter() - t0) * 1e3
            check(ctype == "image/png", "PNG content type")
            served[phi] = decode_png(data)
            check(served[phi].shape == (H, W, 3), "400x400x3 frame")
            print(f"served /render phi={phi:g}: {len(data)} B PNG, {http_ms:.1f} ms "
                  f"(HTTP round trip)", flush=True)
        launches = fused_mlp_forward.launches
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    n_chunks = -(-H * W // CHUNK)
    print(f"kernel launches during the {len(phis)} requests: {launches} "
          f"({n_chunks} chunks a frame)", flush=True)
    check(launches == len(phis) * n_chunks, "every served chunk went through the kernel")

    # the served frame against the plain backend, same pose and seed
    pose = torch.as_tensor(spherical_to_pose(4.0, -30.0, phis[0])[None], dtype=torch.float32, device=dev)
    rays = rays_for_poses(pose, H, W, FOCAL)
    frame_ms, rgb = {}, {}
    for backend in ("pallas", "xla"):
        s = dataclasses.replace(settings, backend=backend)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rgb[backend], disp = render_rays_chunked(srv.field, rays, srv.seed, s)
        torch.cuda.synchronize()
        frame_ms[backend] = (time.perf_counter() - t0) * 1e3
        check(bool(torch.isfinite(rgb[backend]).all() and torch.isfinite(disp).all()),
              f"{backend} frame finite")
    frame_err = (rgb["pallas"] - rgb["xla"]).abs().max().item()
    xla_u8 = (rgb["xla"].reshape(H, W, 3).cpu().numpy() * 255).astype(np.uint8)
    u8_err = int(np.abs(served[phis[0]].astype(int) - xla_u8.astype(int)).max())
    print(f"frame {H}x{W}x{N} f32: pallas {frame_ms['pallas']:.1f} ms, xla "
          f"{frame_ms['xla']:.1f} ms; max abs rgb diff {frame_err:.3e} (tol {FRAME_TOL:.0e}), "
          f"served PNG vs xla max diff {u8_err} levels", flush=True)
    check(frame_err <= FRAME_TOL and u8_err <= 1, "served frame matches the plain backend")

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "fused_mlp_forward",
        "route": "cuda",
        "source": "nerf_simple_tpu_torch/csrc/fused_mlp_fwd.cu",
        "replaces": "nerf_simple_tpu/kernels/mlp.py:669",
        "launches": launches,
        "max_abs_err": stats["f32"]["err"],
        "ms": stats["f32"]["ms"],
        "plain_ms": stats["f32"]["plain_ms"],
        "max_abs_err_bf16": stats["bf16"]["err"],
        "ms_bf16": stats["bf16"]["ms"],
        "plain_ms_bf16": stats["bf16"]["plain_ms"],
        "frame_ms": frame_ms["pallas"],
        "plain_frame_ms": frame_ms["xla"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
