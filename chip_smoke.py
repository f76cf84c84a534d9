"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (nerf_simple_tpu_torch) at the flagship width,
NerfMLP(Lp=10, Ld=4, H=256):

1. device: refuses to run without CUDA; prints the card's name and power
   limit as nvidia-smi reports them;
2. build: compiles the three CUDA sources from csrc/, one nvcc each, all
   at once; prints the build time and ptxas registers and spills;
3. forward kernel vs plain: the fused MLP forward against its plain
   PyTorch version on one render chunk (16,384 rays of a 400x400, f=555
   frame x 128 stratified samples = 2,097,152 rows), f32 and bf16, with
   random weights from a numpy seed;
4. serve: the novel-view server over HTTP on localhost, three 400x400
   frames through the forward kernel, then the frame against the plain
   backend;
5. backward (B2) and train step (B1) vs plain: at 524,288 rows (a
   4096-ray x 128-sample batch drawn from the synthetic scene), f32 and
   bf16: per-tensor gradient errors, loss error, CUDA-event times, and
   the train step's bitwise determinism;
6. train: writes the synthetic scene (25 train, 2 val, 2 test images at
   800x800, loaded at half resolution), trains through ``train()`` (what
   ``python -m nerf_simple_tpu_torch.train`` runs) with lego.yaml's keys,
   ``backend: pallas``, ``compute_dtype: bf16``; checks the launch count,
   the loss, the val PSNR, a resume and that the server serves the
   exported params; then a few f32 steps from one state through the
   fused step, the two-kernel autograd path (fused_mlp: forward kernel
   and B2) and the plain path, whose losses must agree.

Every failed check raises, so the script exits non-zero without its last
line. The line before the last is one JSON object with the kernels; the
last names the device. The build and train logs go
to smoke_logs/.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import glob
import io
import json
import os
import subprocess
import tempfile
import threading
import time
import urllib.request
import warnings

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
# B1/B2 gradients, per tensor: max abs error over the plain version's max
# abs value. B2 gets seeded random cotangents on every sample: its weight
# gradients are sums of random-sign terms over 524,288 rows, and both the
# kernel and the plain f32 version land ~1e-3 (of the largest entry) from
# a float64 reference there (measured on the card), so they differ from
# each other by as much. B1's cotangents come from the compositing; there
# f32 kernel and plain agree to ~5e-6. bf16 rounding moves every gradient
# 0.5-10% from f32, and kernel and plain differ by a fraction of that
# (tests/test_torch_cuda.py). Beside the bound, the kernel must be no
# farther than twice the plain version's distance from the float64 result.
GRAD_TOL = {("B2", torch.float32): 1e-2, ("B2", torch.bfloat16): 5e-2,
            ("B1", torch.float32): 1e-4, ("B1", torch.bfloat16): 2e-3}
LOSS_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-3}  # relative
# f32 training steps from one state, fused vs two-kernel vs plain:
# relative loss difference. The paths sum in other orders (~1e-6), and
# Adam's early updates are lr * sign(g) where g is near zero, so a
# weight whose gradient sign differs between paths moves 2 lr apart.
STEP_TOL = 1e-3
BATCH, N_SAMPLES = 4096, 128
OUT = "smoke_logs"


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


def grad_errors(got, want) -> tuple[float, float]:
    """(max over tensors of max abs error / max abs plain, max abs error)."""
    rel = max(((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item() for g, w in zip(got, want))
    return rel, max((g - w).abs().max().item() for g, w in zip(got, want))


def phase_build(mlp, _build) -> None:
    fresh = [n for n in mlp.SOURCES if not _build.library_path(n).exists()]
    t0 = time.perf_counter()
    seconds = _build.build(*mlp.SOURCES)
    print(f"build: {', '.join(mlp.SOURCES)} ({len(fresh)} compiled, one nvcc each, "
          f"in parallel) in {time.perf_counter() - t0:.2f} s; per source "
          + ", ".join(f"{n} {t:.2f} s" for n, t in seconds.items()), flush=True)
    with open(os.path.join(OUT, "build_log.txt"), "w") as fh:
        for name in mlp.SOURCES:
            log = _build.build_log.get(name, "")
            fh.write(f"===== {name}\n{log}\n")
            kernel = None
            for line in log.splitlines():
                if "Compiling entry function" in line:
                    kernel = line.split("'")[1] if "'" in line else line
                elif "registers" in line or "spill" in line:
                    print(f"ptxas {name} {(kernel or '')[:48]}: {line.strip()}")


def phase_forward(dev, params, model, mlp):
    from nerf_simple_tpu_torch.models.nerf import NerfField

    field = NerfField.from_jax_params(params, dev)
    xT = chunk_input(dev)
    wts = mlp.pack_weights(field)
    stats = {}
    with torch.inference_mode():
        for dt in (torch.float32, torch.bfloat16):
            w = mlp._cast_weights(wts, dt)
            got = mlp.fused_mlp_forward(w, xT, dt, model)
            ref = mlp.fused_mlp_forward_plain(w, xT, dt, model)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), f"{dt} kernel output finite")
            check(bool((got[4:] == 0).all()), f"{dt} kernel rows 4..7 zero")
            err_rgb = (got[:3] - ref[:3]).abs().max().item()
            err_sig = (got[3] - ref[3]).abs().max().item()
            ms = cuda_ms(lambda: mlp.fused_mlp_forward(w, xT, dt, model))
            plain_ms = cuda_ms(lambda: mlp.fused_mlp_forward_plain(w, xT, dt, model))
            name = "f32" if dt == torch.float32 else "bf16"
            print(f"forward kernel vs plain {name} at {xT.shape[1]} rows: max abs err rgb "
                  f"{err_rgb:.3e} sigma {err_sig:.3e} (tol {TOL[dt]:.0e}); "
                  f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (median of 5)", flush=True)
            check(err_rgb <= TOL[dt] and err_sig <= TOL[dt], f"{name} kernel within tolerance")
            stats[name] = dict(err=max(err_rgb, err_sig), ms=ms, plain_ms=plain_ms)
    return stats


def phase_serve(dev, params, model, mlp) -> tuple[int, dict]:
    """Serves three frames over HTTP; returns the forward kernel's launches
    during the requests and the frame times of both backends."""
    from nerf_simple_tpu_torch.evaluate import load_params
    from nerf_simple_tpu_torch.ops.rays import rays_for_poses, spherical_to_pose
    from nerf_simple_tpu_torch.render.renderer import RenderSettings, render_rays_chunked
    from nerf_simple_tpu_torch.serve import RenderServer
    from nerf_simple_tpu_torch.train.checkpoint import export_params_npz, load_model_meta

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
    phis = (0.0, 120.0, 240.0)
    mlp.fused_mlp_forward.launches = 0
    served = serve_frames(srv, phis)
    launches = mlp.fused_mlp_forward.launches
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
    u8_err = int(np.abs(served[0].astype(int) - xla_u8.astype(int)).max())
    print(f"frame {H}x{W}x{N} f32: pallas {frame_ms['pallas']:.1f} ms, xla "
          f"{frame_ms['xla']:.1f} ms; max abs rgb diff {frame_err:.3e} (tol {FRAME_TOL:.0e}), "
          f"served PNG vs xla max diff {u8_err} levels", flush=True)
    check(frame_err <= FRAME_TOL and u8_err <= 1, "served frame matches the plain backend")
    return launches, frame_ms


def serve_frames(srv, phis) -> list:
    """GET /health and one /render per phi from the server over HTTP."""
    from nerf_simple_tpu_torch.serve import decode_png, serve

    httpd = serve(srv, 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    frames = []
    try:
        health = json.loads(get(url + "/health")[0])
        check(health["status"] == "ok" and health["frame"] == [srv.H, srv.W], "/health")
        for phi in phis:
            t0 = time.perf_counter()
            data, ctype = get(f"{url}/render?r=4&theta=-30&phi={phi:g}")
            http_ms = (time.perf_counter() - t0) * 1e3
            check(ctype == "image/png", "PNG content type")
            frames.append(decode_png(data))
            check(frames[-1].shape == (srv.H, srv.W, 3), f"{srv.H}x{srv.W}x3 frame")
            print(f"served /render phi={phi:g}: {len(data)} B PNG, {http_ms:.1f} ms "
                  f"(HTTP round trip)", flush=True)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    return frames


def train_batch(dev, scene):
    """x16 (16, 524,288) for a 4096-ray batch of the synthetic scene, with
    stratified samples, as the train step builds it."""
    from nerf_simple_tpu_torch.data.blender import load_blender
    from nerf_simple_tpu_torch.data.dataset import RayDataset, sample_ray_batch
    from nerf_simple_tpu_torch.ops.sampling import stratified_ts
    from nerf_simple_tpu_torch.train.step import build_x16

    rd = RayDataset.from_blender(load_blender(scene, True, 25), dev)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    rays_b, pix_b = sample_ray_batch(g, rd.rays["train"], rd.pixels["train"], BATCH)
    ts = stratified_ts(g, BATCH, N_SAMPLES, 2.0, 6.0, dev)
    return build_x16(rays_b, ts, pix_b)


def phase_backward_and_step(dev, params, model, mlp, x16):
    """B2 and B1 against their plain versions at the training batch, and
    all three against the plain float64 result."""
    from nerf_simple_tpu_torch.models.nerf import NerfField

    wts = mlp.pack_weights(NerfField.from_jax_params(params, dev))
    w64 = mlp.FusedWeights(*[t.double() for t in wts])
    xT = x16[:8].contiguous()
    gT = torch.from_numpy(np.random.default_rng(SEED).normal(size=tuple(xT.shape)).astype(np.float32)).to(dev)
    stats = {}
    with torch.no_grad():
        ref = {"B2": mlp.fused_mlp_backward_plain(w64, xT.double(), gT.double(), torch.float64, model),
               "B1": mlp.fused_train_step_plain(w64, x16.double(), N_SAMPLES, torch.float64, model)[1]}
        torch.cuda.empty_cache()
        for dt in (torch.float32, torch.bfloat16):
            name = "f32" if dt == torch.float32 else "bf16"
            w = mlp._cast_weights(wts, dt)
            runs = {
                "B2": (lambda: (None, mlp.fused_mlp_backward(w, xT, gT, dt, model)),
                       lambda: (None, mlp.fused_mlp_backward_plain(w, xT, gT, dt, model))),
                "B1": (lambda: mlp.fused_train_step(w, x16, N_SAMPLES, dt, model),
                       lambda: mlp.fused_train_step_plain(w, x16, N_SAMPLES, dt, model)),
            }
            for kname, (kernel, plain) in runs.items():
                loss, got = kernel()
                loss_p, want = plain()
                check(all(bool(torch.isfinite(t).all()) for t in got), f"{kname} {name} finite")
                rel, abs_err = grad_errors(got, want)
                k64, p64 = grad_errors(got, ref[kname])[0], grad_errors(want, ref[kname])[0]
                line = (f"{kname} {'fused_mlp_backward' if kname == 'B2' else 'fused_train_step'} vs "
                        f"plain {name} at {xT.shape[1]} rows: grad err {rel:.3e} of max (tol "
                        f"{GRAD_TOL[kname, dt]:.0e}), max abs {abs_err:.3e}; from f64: kernel "
                        f"{k64:.3e}, plain {p64:.3e}")
                st = dict(err=abs_err, rel=rel, kernel_vs_f64=k64, plain_vs_f64=p64)
                check(rel <= GRAD_TOL[kname, dt], f"{kname} {name} within tolerance")
                check(k64 <= 2 * p64 + 1e-7, f"{kname} {name} as accurate as plain")
                if kname == "B1":
                    st["loss_err"] = abs(loss.item() / loss_p.item() - 1)
                    loss2, again = kernel()
                    bitwise = loss2.item() == loss.item() and all(torch.equal(a, b) for a, b in zip(got, again))
                    line += (f"; loss {loss.item():.6f} vs {loss_p.item():.6f} (rel err "
                             f"{st['loss_err']:.2e}, tol {LOSS_TOL[dt]:.0e}); two runs bitwise equal: {bitwise}")
                    check(st["loss_err"] <= LOSS_TOL[dt], f"B1 {name} loss within tolerance")
                    check(bitwise, f"B1 {name} deterministic")
                    del again
                del got, want
                st["ms"], st["plain_ms"] = cuda_ms(kernel), cuda_ms(plain)
                print(f"{line}; kernel {st['ms']:.3f} ms, plain {st['plain_ms']:.3f} ms (median of 5)",
                      flush=True)
                stats[f"{kname}_{name}"] = st
                torch.cuda.empty_cache()
    return stats


def scalars(log_dir: str, tag: str) -> list[float]:
    rows = []
    for path in glob.glob(os.path.join(log_dir, "run_*", "scalars.csv")):
        with open(path) as fh:
            rows += [(int(r[1]), float(r[3])) for r in csv.reader(fh) if r[2] == tag]
    return [v for _, v in sorted(rows)]


def phase_train(dev, scene, work, mlp):
    """Train through train(), resume, serve the export, then the f32
    fused/two-kernel/plain step comparison. Returns its numbers."""
    from nerf_simple_tpu_torch.config import load_yaml
    from nerf_simple_tpu_torch.evaluate import load_params
    from nerf_simple_tpu_torch.models.nerf import NerfMLP
    from nerf_simple_tpu_torch.render.renderer import RenderSettings
    from nerf_simple_tpu_torch.serve import RenderServer
    from nerf_simple_tpu_torch.train.checkpoint import load_model_meta
    from nerf_simple_tpu_torch.train.loop import train
    from nerf_simple_tpu_torch.train.step import build_train_step, make_train_state

    iters, more = 300, 100
    cfg = load_yaml("configs/lego.yaml")
    cfg.update(datapath=scene, savepath=os.path.join(work, "models"), log_dir=os.path.join(work, "logs"),
               backend="pallas", compute_dtype="bf16", num_iters=iters, ckpt_loss=1,
               ckpt_images=150, ckpt_model=150, steps_per_call=50)
    log = io.StringIO()
    mlp.fused_train_step.launches = mlp.fused_mlp_forward.launches = mlp.fused_mlp_backward.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        state = train(cfg)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(fused_train_step=mlp.fused_train_step.launches,
                    fused_mlp_forward=mlp.fused_mlp_forward.launches,
                    fused_mlp_backward=mlp.fused_mlp_backward.launches)
    cfg.update(resume=True, num_iters=iters + more)
    with contextlib.redirect_stdout(log):
        state = train(cfg)
    resumed_launches = mlp.fused_train_step.launches - launches["fused_train_step"]
    text = log.getvalue()
    with open(os.path.join(OUT, "train_log.txt"), "w") as fh:
        fh.write(text)
    for line in text.splitlines():
        if "resumed from" in line or "final checkpoint" in line or "Val image" in line:
            print("train:", line, flush=True)
    losses = scalars(cfg["log_dir"], "Loss/train")
    psnr = scalars(cfg["log_dir"], "Loss/Val_Img_PSNR_0")
    first, last = float(np.mean(losses[:50])), float(np.mean(losses[iters - 50 : iters]))
    print(f"train: {iters} steps in {train_s:.1f} s with builds and renders; launches {launches}; "
          f"mean loss of the first 50 steps {first:.5f}, of steps {iters - 50}-{iters} {last:.5f}; "
          f"val PSNR(0) {', '.join(f'{p:.2f}' for p in psnr)} dB", flush=True)
    check(launches["fused_train_step"] == iters, "one fused train-step launch a step")
    check(launches["fused_mlp_forward"] > 0, "val renders went through the forward kernel")
    check(all(np.isfinite(losses)) and len(losses) == iters + more, "every loss logged and finite")
    check(last <= 0.5 * first, "the loss at least halved")
    check(psnr[-1] > psnr[0], "val PSNR rose")
    check("resumed from" in text and f"at step {iters}" in text, "resume printed")
    check(resumed_launches == more and state.step == iters + more, "resume added the steps")

    # the exported params, served
    path = os.path.join(work, "models", "lego", f"params_{iters + more}.npz")
    model = load_model_meta(path)
    check(model == NerfMLP(), "model.json of the run")
    srv = RenderServer(load_params(path), 400, 400, scene_focal(scene), RenderSettings(
        backend="pallas", compute_dtype=torch.bfloat16), model=model, device=dev)
    frame = serve_frames(srv, (30.0,))[0]
    check(frame.max() > 0, "the trained field renders something")

    # steady-state ms a step on the trained state
    step_fn = build_train_step(train_config(cfg), NerfMLP())
    from nerf_simple_tpu_torch.data.blender import load_blender
    from nerf_simple_tpu_torch.data.dataset import RayDataset

    rd = RayDataset.from_blender(load_blender(scene, True, 25), dev)
    rays, pixels = rd.rays["train"], rd.pixels["train"]
    step_ms = cuda_ms(lambda: [step_fn(state, rays, pixels) for _ in range(20)]) / 20
    print(f"train step bf16 steady state: {step_ms:.3f} ms a step, "
          f"{BATCH / step_ms * 1e3:,.0f} rays/s (CUDA events over 20 steps, median of 5)", flush=True)

    # f32: fused step, two-kernel path (forward kernel + B2), plain path
    cfg32 = train_config({**cfg, "compute_dtype": "f32"})
    paths = {}
    mlp.fused_mlp_backward.launches = 0
    for name, backend, fused in (("fused", "pallas", True), ("two-kernel", "pallas", False),
                                 ("plain", "xla", False)):
        c = dataclasses.replace(cfg32, backend=backend)
        st = make_train_state(c, NerfMLP(), dev)
        with warnings.catch_warnings():  # the two-kernel path warns, as JAX does
            warnings.simplefilter("ignore")
            fn = build_train_step(c, NerfMLP(), fused=fused)
        paths[name] = torch.stack([fn(st, rays, pixels) for _ in range(5)]).cpu().numpy()
    b2_launches = mlp.fused_mlp_backward.launches
    diff = max(float(np.max(np.abs(paths[n] / paths["plain"] - 1))) for n in ("fused", "two-kernel"))
    print(f"f32 steps from one state: fused {paths['fused']}, two-kernel {paths['two-kernel']}, "
          f"plain {paths['plain']}; max rel diff {diff:.2e} (tol {STEP_TOL:.0e}); B2 launches "
          f"{b2_launches}", flush=True)
    check(diff <= STEP_TOL, "fused, two-kernel and plain steps agree")
    check(b2_launches == 5, "the two-kernel path went through B2 once a step")
    return dict(launches=launches, b2_launches=b2_launches, step_ms=step_ms)


def train_config(d):
    from nerf_simple_tpu_torch.config import train_config_from_dict

    return train_config_from_dict(d)


def scene_focal(scene: str) -> float:
    with open(os.path.join(scene, "transforms_train.json")) as fh:
        fov = json.load(fh)["camera_angle_x"]
    return 400 / (2.0 * np.tan(fov / 2.0))


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
    os.makedirs(OUT, exist_ok=True)

    from nerf_simple_tpu_torch.data.synthetic import write_blender_scene
    from nerf_simple_tpu_torch.kernels import _build, mlp
    from nerf_simple_tpu_torch.models.nerf import NerfMLP, init_nerf_params

    # 2. build
    phase_build(mlp, _build)

    # 3-4. forward kernel vs plain; serving
    model = NerfMLP()
    params = init_nerf_params(SEED, model)
    fwd = phase_forward(dev, params, model, mlp)
    serve_launches, frame_ms = phase_serve(dev, params, model, mlp)

    with tempfile.TemporaryDirectory() as work:
        scene = os.path.join(work, "scene")
        t0 = time.perf_counter()
        write_blender_scene(scene, n_train=25, n_val=2, n_test=2, H=800, W=800, device=dev)
        print(f"scene: 25/2/2 images at 800x800 written in {time.perf_counter() - t0:.1f} s", flush=True)
        # 5. B2 and B1 vs plain at the training batch
        bwd = phase_backward_and_step(dev, params, model, mlp, train_batch(dev, scene))
        torch.cuda.empty_cache()
        # 6. train
        tr = phase_train(dev, scene, work, mlp)

    def entry(name, source, replaces, launches, st, **extra):
        return {"name": name, "route": "cuda", "source": f"nerf_simple_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, "max_abs_err": st["f32"]["err"],
                "ms": st["f32"]["ms"], "plain_ms": st["f32"]["plain_ms"],
                "max_abs_err_bf16": st["bf16"]["err"], "ms_bf16": st["bf16"]["ms"],
                "plain_ms_bf16": st["bf16"]["plain_ms"], **extra}

    b2 = {k: bwd[f"B2_{k}"] for k in ("f32", "bf16")}
    b1 = {k: bwd[f"B1_{k}"] for k in ("f32", "bf16")}
    print(smi)
    print(json.dumps({"kernels": [
        entry("fused_mlp_forward", "fused_mlp_fwd.cu", "nerf_simple_tpu/kernels/mlp.py:669",
              serve_launches, fwd, frame_ms=frame_ms["pallas"], plain_frame_ms=frame_ms["xla"],
              train_launches=tr["launches"]["fused_mlp_forward"]),
        entry("fused_mlp_backward", "fused_mlp_bwd.cu", "nerf_simple_tpu/kernels/mlp.py:1147",
              tr["b2_launches"], b2, grad_rel_err=b2["f32"]["rel"], grad_rel_err_bf16=b2["bf16"]["rel"]),
        entry("fused_train_step", "fused_train_step.cu", "nerf_simple_tpu/kernels/mlp.py:1623",
              tr["launches"]["fused_train_step"], b1, grad_rel_err=b1["f32"]["rel"],
              grad_rel_err_bf16=b1["bf16"]["rel"], loss_rel_err=b1["f32"]["loss_err"],
              loss_rel_err_bf16=b1["bf16"]["loss_err"], step_ms_bf16=tr["step_ms"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
