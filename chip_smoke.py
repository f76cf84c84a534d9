"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--before CSRC]

Drives the port (nerf_simple_tpu_torch) at the flagship width,
NerfMLP(Lp=10, Ld=4, H=256):

1. device: refuses to run without CUDA; prints the card's name and power
   limit as nvidia-smi reports them;
2. build: compiles the five CUDA sources from csrc/, one nvcc each, all
   at once; prints the build time and ptxas registers and spills (the
   forward tile kernels, csrc/fwd_f32.cuh and csrc/fwd_bf16.cuh, and the
   bf16 backward tile kernel, csrc/bwd_bf16.cuh, are built into four of
   them);
3. forward kernel and render kernel (B3) vs plain: the fused MLP forward
   and the fused render (forward + compositing) against their plain
   PyTorch versions on one render chunk (16,384 rays of a 400x400, f=555
   frame x 128 stratified samples = 2,097,152 rows), f32 and bf16, with
   random weights from a numpy seed; the f32 forward's TFLOP/s and share
   of its bound beside one f32 torch.mm of the chunk's rows (TF32 off);
   with ``--before CSRC``, the earlier f32 forward beside the current one
   in turns;
4. serve: the novel-view server over HTTP on localhost, three 400x400
   frames through the forward kernel, then the frame against the plain
   backend; then one frame through ``render_rays_chunked`` with
   ``fused_eval`` (the render kernel, ten chunks) against the forward
   kernel plus torch compositing, f32 and bf16;
5. backward (B2) and train step (B1) vs plain: at 524,288 rows (a
   4096-ray x 128-sample batch drawn from the synthetic scene), f32 and
   bf16: per-tensor gradient errors, loss error, CUDA-event times, and
   the train step's bitwise determinism; with ``--before CSRC`` (a copy
   of an earlier commit's csrc/, e.g. ``git archive <commit>
   nerf_simple_tpu_torch/csrc`` unpacked under a gitignored build/), the
   earlier train-step and forward sources are built from it and B1 bf16
   and f32 are timed beside the current ones, in turns (step ms and the
   profiled kernel groups; the f32 forward's times join the f32 line),
   and so is the whole bf16 train step of phase 7;
6. wgrad: the backward's twelve weight-gradient sums alone at 524,288
   rows (probes/wgrad.py), f32 and bf16: the kernel in one launch (as B1
   and B2 run it) and as twelve calls, against float64 sums, the plain
   version and the library call torch.mm + sum (timed, never used);
   then the backward tile kernel alone at 524,288 rows
   (probes/bwd_tile.py), f32 and bf16, against its plain version;
7. train: writes the synthetic scene (25 train, 2 val, 2 test images at
   800x800, loaded at half resolution), trains through ``train()`` (what
   ``python -m nerf_simple_tpu_torch.train`` runs) with lego.yaml's keys,
   ``backend: pallas``, ``compute_dtype: bf16``; checks the launch count,
   the loss, the val PSNR, a resume and that the server serves the
   exported params; then a few f32 steps from one state through the
   fused step, the two-kernel autograd path (fused_mlp: forward kernel
   and B2) and the plain path, whose losses must agree; the bf16 step's
   wall and the host's time to issue it, its kernel time by kernel and
   the host's time by torch op (torch.profiler), and the device's idle
   share;
8. eval: ``evaluate.test`` (what ``python -m nerf_simple_tpu_torch.
   evaluate`` runs) on the trained scene's test split with lego.yaml's
   test_params, ``backend: pallas``, ``compute_dtype: bf16``: stills 0
   and 1 with their PSNR, normals of still 0, and the orbit video cut to
   ORBIT_POSES frames (lego.yaml asks for 30);
9. the padding probe (B4) at full reps: kernel vs plain for K = 40, 72,
   80, 128, ms a launch, TFLOP/s and the ratios.

Every failed check raises, so the script exits non-zero without its last
line. The line before the last is one JSON object with the kernels, each
with its bound (utils/roofline.py: the larger of its operations over the
card's peak rate and its bytes over the memory rate) and the time of one
PyTorch library call computing the same function where there is one; the
last names the device. The build and train logs go
to smoke_logs/.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import ctypes
import dataclasses
import glob
import io
import json
import os
import re
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
# Served frame, pallas vs xla backend at f32, and fused_eval vs the
# forward kernel plus torch compositing: clipped rgb in [0, 1].
FRAME_TOL = 1e-3
# Disparity of the fused_eval frame against the unfused one, relative:
# both composite the same raw outputs, summed in another order (the JAX
# test's bound, tests/test_kernels.py:433).
DISP_RTOL = 2e-3
ORBIT_POSES = 10  # eval's orbit video, cut from lego.yaml's 30 frames
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
    """x16 (16, 2,097,152) for the middle chunk of a 400x400 frame, as the
    renderer builds it: rows 0..5 are the forward kernel's xT, row 6 the
    ts."""
    from nerf_simple_tpu_torch.ops.rays import rays_for_poses, spherical_to_pose
    from nerf_simple_tpu_torch.ops.sampling import stratified_ts

    pose = torch.as_tensor(spherical_to_pose(4.0, -30.0, 0.0)[None], dtype=torch.float32, device=dev)
    rays = rays_for_poses(pose, H, W, FOCAL)[72000 : 72000 + CHUNK]
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    ts = stratified_ts(g, CHUNK, N, 2.0, 6.0, dev)
    dT = rays[:, 3:6].T
    x16 = torch.zeros((16, CHUNK * N), dtype=torch.float32, device=dev)
    x16[0:3] = (rays[:, :3].T[:, :, None] + dT[:, :, None] * ts[None]).reshape(3, -1)
    x16[3:6] = (dT / torch.linalg.vector_norm(dT, dim=0, keepdim=True))[:, :, None].expand(3, CHUNK, N).reshape(3, -1)
    x16[6] = ts.reshape(-1)
    return x16


def get(url: str) -> tuple[bytes, str]:
    with urllib.request.urlopen(url, timeout=600) as r:
        return r.read(), r.headers["Content-Type"]


def grad_errors(got, want) -> tuple[float, float]:
    """(max over tensors of max abs error / max abs plain, max abs error)."""
    rel = max(((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item() for g, w in zip(got, want))
    return rel, max((g - w).abs().max().item() for g, w in zip(got, want))


# the entries of an earlier library that the before/after phases call
BEFORE_ENTRIES = {"fused_train_step": ("fused_train_step", "fused_train_step_workspace_bytes"),
                  "fused_mlp_fwd": ("fused_mlp_fwd", "fused_mlp_fwd_image_bytes")}


def build_before(csrc: str, _build, mlp) -> dict:
    """The train-step and forward sources of another copy of csrc/ (the
    kernels a change replaces), built with the package's nvcc flags into
    <csrc>/../build/, one nvcc each, both at once; returns their ctypes
    libraries by source, the entries of BEFORE_ENTRIES bound as the
    current library's."""
    outdir = os.path.join(os.path.dirname(os.path.abspath(csrc)), "build")
    os.makedirs(outdir, exist_ok=True)
    procs = {n: (os.path.join(outdir, f"{n}.so"), subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", os.path.join(outdir, f"{n}.so"),
         os.path.join(csrc, f"{n}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for n in BEFORE_ENTRIES}
    libs = {}
    for name, (out, proc) in procs.items():
        log = proc.communicate()[0]
        check(proc.returncode == 0, f"build of the earlier {name}.cu:\n{log}")
        libs[name] = ctypes.CDLL(out)
        for entry in BEFORE_ENTRIES[name]:
            fn = getattr(libs[name], entry)
            fn.argtypes, fn.restype = mlp._SIGNATURES[name][entry]
    return libs


def in_turns(old, new) -> dict:
    """CUDA-event ms of ``old`` and ``new`` in turns (earlier, current,
    current, earlier; each the median of 5 calls): the median of each."""
    t = {"earlier": [], "current": []}
    for which in ("earlier", "current", "current", "earlier"):
        t[which].append(cuda_ms(old if which == "earlier" else new))
    return {k: float(np.median(v)) for k, v in t.items()}


def phase_forward_before_after(dev, params, model, mlp, x16, earlier) -> dict:
    """The f32 forward of an earlier forward library beside the current one
    on the render chunk, in turns, both called straight through ctypes with
    their outputs and weight images made once. The two must agree."""
    from nerf_simple_tpu_torch.models.nerf import NerfField

    w = mlp._cast_weights(mlp.pack_weights(NerfField.from_jax_params(params, dev)), torch.float32)
    cw, xT = mlp._CPtrs(*mlp._ptrs(w)), x16[:8].contiguous()
    R = xT.shape[1]

    def bind(lib, what):
        out = torch.empty((8, R), dtype=torch.float32, device=dev)
        image = torch.empty(lib.fused_mlp_fwd_image_bytes(model.Lp, model.Ld, model.H, 0), dtype=torch.uint8,
                            device=dev)

        def fwd():
            mlp._raise_on(lib.fused_mlp_fwd(xT.data_ptr(), out.data_ptr(), R, model.Lp, model.Ld, model.H, 0, cw,
                                            image.data_ptr(), mlp._stream(xT)), what)
        return fwd, out

    old, o_old = bind(earlier, "earlier fused_mlp_fwd")
    new, o_new = bind(mlp._lib("fused_mlp_fwd"), "fused_mlp_fwd")
    with torch.inference_mode():
        old()
        new()
        torch.cuda.synchronize()
        err = (o_new[:4] - o_old[:4]).abs().max().item()
        check(err <= TOL[torch.float32], "current f32 forward matches the earlier kernel")
        res = {"fwd_ms": in_turns(old, new), "fwd_err": err, "rows": R}
    del o_old, o_new
    torch.cuda.empty_cache()
    return res


@contextlib.contextmanager
def earlier_train_step(mlp, lib):
    """Inside, ``mlp.fused_train_step`` (and so the train step) launches the
    earlier library ``lib`` and hands it the transposed weights
    (``mlp._transposed``), as the earlier wrapper did: the step as it was."""
    lib_of, weights_t = mlp._lib, mlp._weights_t
    mlp._lib = lambda name: lib if name == "fused_train_step" else lib_of(name)
    mlp._weights_t = lambda wts, bf16: mlp._transposed(wts)
    try:
        yield
    finally:
        mlp._lib, mlp._weights_t = lib_of, weights_t


def phase_before_after(dev, params, model, mlp, x16_batch, earlier, dt=torch.bfloat16) -> dict:
    """B1 of an earlier train-step library beside the current one at the
    training batch, in compute type ``dt``, in turns (earlier, current,
    current, earlier, median of each): step ms and the profiled kernel
    groups (the tile kernels' among them). Both libraries are called the
    same way, straight through ctypes with a workspace made once, so the
    walls hold no wrapper time. The two must agree."""
    from nerf_simple_tpu_torch.models.nerf import NerfField

    w = mlp._cast_weights(mlp.pack_weights(NerfField.from_jax_params(params, dev)), dt)
    cw, wt = mlp._CPtrs(*mlp._ptrs(w)), mlp._transposed(w)  # an earlier bf16 library may read wt
    res = {}
    R, Nb = x16_batch.shape[1], N_SAMPLES
    bf16 = int(dt == torch.bfloat16)
    name = "bf16" if bf16 else "f32"

    def bind(lib, what):
        ws = torch.empty(lib.fused_train_step_workspace_bytes(R, Nb, model.Lp, model.Ld, model.H, bf16),
                         dtype=torch.uint8, device=dev)
        loss = torch.empty((), dtype=torch.float32, device=dev)
        grads = mlp._empty_grads(model, dev)
        cg = mlp._CPtrs(*mlp._ptrs(grads))

        def step():
            mlp._raise_on(lib.fused_train_step(x16_batch.data_ptr(), R, Nb, model.Lp, model.Ld, model.H, bf16,
                                               cw, wt, ws.data_ptr(), loss.data_ptr(), cg,
                                               mlp._stream(x16_batch)), what)
        return step, loss, grads

    old_step, loss, grads = bind(earlier, "earlier fused_train_step")
    new_step, l_new, g_new = bind(mlp._lib("fused_train_step"), "fused_train_step")

    with torch.no_grad():
        old_step()
        new_step()
        rel = grad_errors(g_new, grads)[0]
        check(abs(l_new.item() / loss.item() - 1) <= LOSS_TOL[dt] and rel <= GRAD_TOL["B1", dt],
              f"current B1 {name} matches the earlier kernels")
        res["b1_ms"] = in_turns(old_step, new_step)
        res["b1_profile"] = {"earlier": profile_step(old_step), "current": profile_step(new_step)}
        res["b1_grad_rel"] = rel
    del old_step, new_step
    torch.cuda.empty_cache()
    b = res["b1_ms"]
    if not bf16:
        return res
    print(f"before/after B1 bf16 at {R} rows: earlier {b['earlier']:.3f} ms, current {b['current']:.3f} ms; "
          "profiled ms a call: " + "; ".join(
              f"{k}: " + ", ".join(f"{g} {v:.3f}" for g, v in sorted(p.items(), key=lambda kv: -kv[1]))
              for k, p in res["b1_profile"].items())
          + f"; current vs earlier grads {rel:.2e} of max", flush=True)
    return res


def step_walls(step, steps: int = 20, reps: int = 5) -> dict:
    """ms a call of ``step`` over runs of ``steps`` calls back to back, after
    one warm-up run: each run's device wall (CUDA events) and the host's
    time to issue it (perf_counter up to the last call's return, before
    the synchronize). Where the host issues slower than the card runs, the
    two agree and the card waits on the host."""
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    walls, hosts = [], []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        hosts.append((time.perf_counter() - t0) * 1e3 / steps)
        b.record()
        b.synchronize()
        walls.append(a.elapsed_time(b) / steps)
    return {"ms": float(np.median(walls)), "host_ms": float(np.median(hosts)), "walls": walls, "hosts": hosts}


def short_name(mangled: str) -> str:
    """A kernel's mangled name without its anonymous namespace's prefix
    (``_ZN<n><n characters>``), so that the kernel's own name shows."""
    m = re.match(r"_ZN(\d+)", mangled)
    return mangled[m.end() + int(m.group(1)):] if m else mangled


def phase_build(sources, _build) -> None:
    fresh = [n for n in sources if not _build.library_path(n).exists()]
    t0 = time.perf_counter()
    seconds = _build.build(*sources)
    print(f"build: {', '.join(sources)} ({len(fresh)} compiled, one nvcc each, "
          f"in parallel) in {time.perf_counter() - t0:.2f} s; per source "
          + ", ".join(f"{n} {t:.2f} s" for n, t in seconds.items()), flush=True)
    with open(os.path.join(OUT, "build_log.txt"), "w") as fh:
        for name in sources:
            log = _build.build_log.get(name, "")
            fh.write(f"===== {name}\n{log}\n")
            kernel = None
            for line in log.splitlines():
                if "Compiling entry function" in line:
                    kernel = line.split("'")[1] if "'" in line else line
                elif "registers" in line or "spill" in line:
                    print(f"ptxas {name} {short_name(kernel or '')[:48]}: {line.strip()}")


def phase_forward(dev, params, model, mlp, x16):
    """The forward kernel against its plain version on the chunk, f32 and
    bf16; then the f32 kernel's rate and share of its bound beside the
    rate of one f32 torch.mm of the chunk's rows by a 256 x 256 matrix
    (TF32 off): the SIMT FMA rate a library reaches, timed here only."""
    from nerf_simple_tpu_torch.models.nerf import NerfField
    from nerf_simple_tpu_torch.utils.roofline import bound_ms

    field = NerfField.from_jax_params(params, dev)
    xT = x16[:8].contiguous()
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
        R = xT.shape[1]
        flops = 2 * sum(o * k for o, k in mlp._weight_shapes(model).values() if k != 1) * R
        A = torch.from_numpy(np.random.default_rng(SEED).standard_normal((R, 256), dtype=np.float32)).to(dev)
        B = torch.from_numpy(np.random.default_rng(SEED + 1).standard_normal((256, 256), dtype=np.float32)).to(dev)
        mm_ms = cuda_ms(lambda: torch.mm(A, B))
        del A, B
    f32 = stats["f32"]
    f32["tflops"] = flops / (f32["ms"] * 1e9)
    f32["share_of_bound"] = bound_ms(flops, 64 * R, torch.float32) / f32["ms"]
    f32["mm_tflops"] = 2 * R * 256 * 256 / (mm_ms * 1e9)
    print(f"forward kernel f32 at {R} rows: {f32['tflops']:.2f} TFLOP/s, {100 * f32['share_of_bound']:.1f}% of its "
          f"bound ({bound_ms(flops, 64 * R, torch.float32):.2f} ms, operations at 67 TFLOP/s); one f32 torch.mm "
          f"({R} x 256) @ (256 x 256), TF32 off: {mm_ms:.3f} ms, {f32['mm_tflops']:.2f} TFLOP/s", flush=True)
    torch.cuda.empty_cache()
    return stats


def phase_render(dev, params, model, mlp, x16):
    """B3 against its plain version on the chunk: each ray's rgb, depth and
    acc at its head column, zeros elsewhere; CUDA-event ms of both."""
    from nerf_simple_tpu_torch.models.nerf import NerfField

    wts = mlp.pack_weights(NerfField.from_jax_params(params, dev))
    heads = torch.zeros(x16.shape[1], dtype=torch.bool, device=dev)
    heads[::N] = True
    stats = {}
    with torch.inference_mode():
        for dt in (torch.float32, torch.bfloat16):
            name = "f32" if dt == torch.float32 else "bf16"
            w = mlp._cast_weights(wts, dt)
            got = mlp.fused_render(w, x16, N, dt, model)
            ref = mlp.fused_render_plain(w, x16, N, dt, model)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), f"{name} render kernel output finite")
            check(bool((got[:, ~heads] == 0).all()) and bool((got[5:] == 0).all()),
                  f"{name} render kernel: zeros off the head columns")
            err = (got[:5, heads] - ref[:5, heads]).abs().amax(1).tolist()
            err_rgb_acc, err_depth = max(err[:3] + err[4:]), err[3]
            del got, ref
            ms = cuda_ms(lambda: mlp.fused_render(w, x16, N, dt, model))
            plain_ms = cuda_ms(lambda: mlp.fused_render_plain(w, x16, N, dt, model))
            # depth sums w * t with t up to 6: six times the rgb bound
            print(f"B3 render kernel vs plain {name} at {x16.shape[1]} rows ({CHUNK} rays): max abs err "
                  f"rgb/acc {err_rgb_acc:.3e} (tol {TOL[dt]:.0e}), depth {err_depth:.3e} (tol "
                  f"{6 * TOL[dt]:.0e}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (median of 5)",
                  flush=True)
            check(err_rgb_acc <= TOL[dt] and err_depth <= 6 * TOL[dt], f"{name} render kernel within tolerance")
            stats[name] = dict(err=max(err), ms=ms, plain_ms=plain_ms)
            torch.cuda.empty_cache()
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


def phase_fused_frame(dev, params, model, mlp) -> tuple[int, dict]:
    """One 400x400 frame through render_rays_chunked with fused_eval (the
    render kernel) against the forward kernel plus torch compositing, same
    seed, so the same ts. Returns the render kernel's launches in the f32
    frame and the frame times."""
    from nerf_simple_tpu_torch.models.nerf import NerfField
    from nerf_simple_tpu_torch.ops.rays import rays_for_poses, spherical_to_pose
    from nerf_simple_tpu_torch.render.renderer import RenderSettings, render_rays_chunked

    field = NerfField.from_jax_params(params, dev, model)
    pose = torch.as_tensor(spherical_to_pose(4.0, -30.0, 0.0)[None], dtype=torch.float32, device=dev)
    rays = rays_for_poses(pose, H, W, FOCAL)

    def frame(dt, fused):
        s = RenderSettings(backend="pallas", compute_dtype=dt, fused_eval=fused)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rgb, disp = render_rays_chunked(field, rays, SEED, s)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, rgb, disp

    mlp.fused_render.launches = 0
    first_ms, rgb_f, disp_f = frame(torch.float32, True)  # the eval render path
    launches = mlp.fused_render.launches
    n_chunks = -(-H * W // CHUNK)
    check(launches == n_chunks, "every chunk of the fused_eval frame went through the render kernel")
    frame_ms = {}
    for dt in (torch.float32, torch.bfloat16):
        name = "f32" if dt == torch.float32 else "bf16"
        _, rgb_f, disp_f = frame(dt, True)
        _, rgb_u, disp_u = frame(dt, False)
        check(bool(torch.isfinite(rgb_f).all() and torch.isfinite(disp_f).all()), f"{name} fused frame finite")
        rgb_err = (rgb_f - rgb_u).abs().max().item()
        disp_err = ((disp_f - disp_u).abs() / disp_u.abs()).max().item()
        # in turns: unfused, fused, fused, unfused, unfused, fused
        t = {True: [], False: []}
        for fused in (False, True, True, False, False, True):
            t[fused].append(frame(dt, fused)[0])
        frame_ms[name] = {"fused": float(np.median(t[True])), "unfused": float(np.median(t[False]))}
        print(f"fused_eval frame {H}x{W}x{N} {name}: render kernel {frame_ms[name]['fused']:.1f} ms, "
              f"forward kernel + torch compositing {frame_ms[name]['unfused']:.1f} ms (median of 3, "
              f"in turns); max abs rgb diff {rgb_err:.3e} (tol {FRAME_TOL:.0e}), max rel disparity "
              f"diff {disp_err:.3e} (tol {DISP_RTOL:.0e})", flush=True)
        check(rgb_err <= FRAME_TOL and disp_err <= DISP_RTOL, f"{name} fused_eval frame matches")
    print(f"render kernel launches during the f32 fused_eval frame: {launches} ({n_chunks} chunks; "
          f"first frame {first_ms:.1f} ms)", flush=True)
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


def phase_wgrad(dev):
    """The twelve weight-gradient sums alone (probes/wgrad.py): kernel vs
    float64 sums of the operands as stored (REL_TOL there: f32 1e-4, bf16
    1e-3 of the largest entry, for the reasons stated beside it) and no
    less accurate than the plain version; kernel, library and plain ms."""
    from nerf_simple_tpu_torch.probes import wgrad

    res = wgrad.run(dev)  # raises on a failed check
    for name in ("f32", "bf16"):
        v = res[name]
        print(f"wgrad {name}, twelve sums at {res['rows']} rows: kernel {v['ms']:.3f} ms in one launch "
              f"({v['ms_single']:.3f} ms as twelve calls), library torch.mm + sum {v['library_ms']:.3f} ms, "
              f"plain {v['plain_ms']:.3f} ms (runs of {wgrad.CALLS} calls, median of 5, in turns); bound {v['bound_ms']:.3f} ms "
              f"({v['bound_by']}), {100 * v['share_of_bound']:.1f}% of it; {v['tflops']:.1f} TFLOP/s, "
              f"{v['gb_s']:.0f} GB/s; from float64 of the operands as stored: kernel {v['rel_err']:.2e} "
              f"(twelve calls {v['single_rel_err']:.2e}), plain {v['plain_rel_err']:.2e} of max (tol "
              f"{wgrad.REL_TOL[torch.float32 if name == 'f32' else torch.bfloat16]:.0e}); kernel vs plain "
              f"max abs {v['max_abs_err']:.3e}; launches {v['launches']}", flush=True)
    return res


def phase_bwd_tile(dev):
    """The backward tile kernel alone (probes/bwd_tile.py): kernel vs plain
    planes (REL_TOL there: f32 1e-4, bf16 2e-2 of each group's largest
    entry, for the reasons stated beside it), pad rows zero; kernel and
    plain ms, the bound and its share."""
    from nerf_simple_tpu_torch.probes import bwd_tile

    res = bwd_tile.run(dev)  # raises on a failed check
    for name in ("f32", "bf16"):
        v = res[name]
        print(f"bwd_tile {name} at {res['rows']} rows: kernel {v['ms']:.3f} ms, plain {v['plain_ms']:.3f} ms "
              f"(a call of {bwd_tile.CALLS} back to back, median of 5, in turns); bound {v['bound_ms']:.3f} ms ({v['bound_by']}), "
              f"{100 * v['share_of_bound']:.1f}% of it; {v['gb_s']:.0f} GB/s, {v['tflops']:.1f} TFLOP/s; "
              f"vs plain {v['rel_err']:.2e} of max (tol {bwd_tile.REL_TOL[torch.float32 if name == 'f32' else torch.bfloat16]:.0e}), "
              f"max abs {v['max_abs_err']:.3e}, {100 * v['share_differ']:.3f}% of entries differ; "
              f"launches {v['launches']}", flush=True)
    return res


def profile_step(step, others: dict | None = None, host: dict | None = None) -> dict:
    """Device time of each kernel group in one call of ``step`` (ms, mean of
    10 calls after 3 warm-up) under torch.profiler; {} when the profiler
    sees no device activity. ``others``, where given, gets the ms of each
    kernel of the group "other" by name; ``host``, the host's self time
    of each torch op a call (ms; the profiler's own cost included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            step()
        torch.cuda.synchronize()
    groups = (("sums", "sums_"), ("sums_reduce", "reduce_kernel"), ("bwd_tile", "bwd_kernel"),
              ("fwd_tile", "fwd_kernel"), ("bwd_image", "bwd_image_kernel"), ("weight_image", "image_kernel"),
              ("compositing", "composite_grad"), ("compositing", "sum_kernel"))
    out: dict = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue  # not a kernel (a user annotation spans kernels counted on their own)
        group = next((g for g, key in groups if key in e.name), "other")
        ms = e.time_range.elapsed_us() / 1e4  # ms a step over 10 steps
        out[group] = out.get(group, 0.0) + ms
        if group == "other" and others is not None:
            others[e.name[:60]] = others.get(e.name[:60], 0.0) + ms
    if host is not None:
        for a in prof.key_averages():
            if a.self_cpu_time_total > 0:
                host[a.key[:60]] = a.self_cpu_time_total / 1e4  # us over 10 calls -> ms a call
    return out


def scalars(log_dir: str, tag: str) -> list[float]:
    rows = []
    for path in glob.glob(os.path.join(log_dir, "run_*", "scalars.csv")):
        with open(path) as fh:
            rows += [(int(r[1]), float(r[3])) for r in csv.reader(fh) if r[2] == tag]
    return [v for _, v in sorted(rows)]


def phase_train(dev, scene, work, mlp, earlier=None):
    """Train through train(), resume, serve the export, time and profile
    the bf16 step (with ``earlier``, an earlier train-step library, beside
    the step as it was, in turns), then the f32 fused/two-kernel/plain
    step comparison. Returns its numbers."""
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
    mlp.wgrad_sums_launches(reset=True)
    mlp.bwd_tile_launches(reset=True)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        state = train(cfg)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(fused_train_step=mlp.fused_train_step.launches,
                    fused_mlp_forward=mlp.fused_mlp_forward.launches,
                    fused_mlp_backward=mlp.fused_mlp_backward.launches,
                    wgrad_sums=mlp.wgrad_sums_launches(), bwd_tile=mlp.bwd_tile_launches())
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
    check(launches["wgrad_sums"] == iters, "one launch of the weight-gradient sums a step")
    check(launches["bwd_tile"] == iters, "one launch of the backward tile kernel a step")
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
    def step():
        return step_fn(state, rays, pixels)

    walls = step_walls(step)
    step_ms = walls["ms"]
    print(f"train step bf16 steady state: {step_ms:.3f} ms a step, {BATCH / step_ms * 1e3:,.0f} rays/s "
          f"(CUDA events over 20 steps, median of 5; runs {', '.join(f'{w:.3f}' for w in walls['walls'])}); "
          f"host issues a step in {walls['host_ms']:.3f} ms (runs "
          f"{', '.join(f'{h:.3f}' for h in walls['hosts'])})", flush=True)
    others, host = {}, {}
    prof = profile_step(step, others, host)
    busy = sum(prof.values())
    print("train step bf16 profile, device ms a step: " + (", ".join(
        f"{k} {v:.3f}" for k, v in sorted(prof.items(), key=lambda kv: -kv[1]))
        + f"; kernels {busy:.3f} of {step_ms:.3f} ms, idle share {1 - busy / step_ms:.3f}"
        if prof else "not measured (the profiler saw no device activity)"), flush=True)
    print("train step bf16 profile, the group other by kernel, ms a step: " + "; ".join(
        f"{n} {v:.3f}" for n, v in sorted(others.items(), key=lambda kv: -kv[1])[:8]), flush=True)
    print(f"train step bf16 profile, host self time a step: torch ops {sum(host.values()):.3f} ms (profiled); "
          + "; ".join(f"{n} {v:.3f}" for n, v in sorted(host.items(), key=lambda kv: -kv[1])[:10]), flush=True)
    turns = None
    if earlier is not None:  # the step as it was (the earlier library) beside this one, in turns
        t = {"earlier": [], "current": []}
        for which in ("earlier", "current", "current", "earlier", "earlier", "current"):
            with earlier_train_step(mlp, earlier) if which == "earlier" else contextlib.nullcontext():
                t[which].append(step_walls(step))
        turns = {k: {"ms": float(np.median([r["ms"] for r in v])),
                     "host_ms": float(np.median([r["host_ms"] for r in v]))} for k, v in t.items()}
        print("before/after train step bf16 (in turns, each the median of 5 runs of 20 steps; median of 3): "
              + "; ".join(f"{k} {v['ms']:.3f} ms a step ({BATCH / v['ms'] * 1e3:,.0f} rays/s), host issues "
                          f"it in {v['host_ms']:.3f} ms" for k, v in turns.items()), flush=True)

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
    return dict(launches=launches, b2_launches=b2_launches, step_ms=step_ms, host_ms=walls["host_ms"],
                profile=prof, others=others, turns=turns)


def phase_eval(dev, scene, work, mlp):
    """evaluate.test on the trained run's test split: stills 0 and 1, the
    normals of still 0, the orbit video (ORBIT_POSES frames)."""
    from nerf_simple_tpu_torch.config import load_yaml
    from nerf_simple_tpu_torch.evaluate import test
    from nerf_simple_tpu_torch.utils.video import read_avi

    tp = load_yaml("configs/lego.yaml")["test_params"]
    tp.update(loadpath=os.path.join(work, "models", "lego"), datapath=scene,
              savepath=os.path.join(work, "results"), backend="pallas", compute_dtype="bf16",
              im_idxs=[0, 1])
    runs = {"stills": dict(animation=False),
            "normals": dict(animation=False, im_idxs=[0], normals=True),
            "orbit": dict(animation=True, num_poses=ORBIT_POSES)}
    log, secs = io.StringIO(), {}
    mlp.fused_mlp_forward.launches = 0
    for name, extra in runs.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            test({**tp, **extra})
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    launches = mlp.fused_mlp_forward.launches
    text = log.getvalue()
    with open(os.path.join(OUT, "eval_log.txt"), "w") as fh:
        fh.write(text)
    for line in text.splitlines():
        print("eval:", line, flush=True)
    psnr = {int(i): float(p) for i, p in re.findall(r"im (\d+): mse=\S+ psnr=(\S+)", text)}
    out_dir = os.path.join(work, "results", "lego")
    files = set(os.listdir(out_dir))
    videos = [f for f in files if f.startswith("nerf_rgb")]
    check({"rgb_0.png", "rgb_1.png", "depth_0.png", "depth_1.png", "normal_0.png"} <= files,
          "stills, depth and normal PNGs written")
    check(len(videos) == 1, "one orbit video written")
    if videos[0].endswith(".avi"):
        frames, fps = read_avi(os.path.join(out_dir, videos[0]))
        check(frames.shape == (ORBIT_POSES, 400, 400, 3) and fps == 15, "the AVI holds the orbit")
    check(sorted(psnr) == [0, 1] and min(psnr.values()) >= 20.0, "test PSNR >= 20 dB")
    check(launches > 0, "eval rendered through the forward kernel")
    res = dict(psnr=psnr, s_per_still=secs["stills"] / 2, s_normals=secs["normals"],
               s_per_frame=secs["orbit"] / ORBIT_POSES, launches=launches, video=videos[0])
    print(f"eval: test PSNR {psnr[0]:.2f} / {psnr[1]:.2f} dB; {res['s_per_still']:.2f} s a still, "
          f"stills + normals of one {secs['normals']:.2f} s, orbit {res['s_per_frame']:.2f} s a frame "
          f"({ORBIT_POSES} frames, cut from 30; each wall includes loading the scene); "
          f"forward kernel launches {launches}; video {videos[0]}", flush=True)
    return res


def phase_probe(dev):
    """The padding probe at full reps: kernel vs plain for each K, ms a
    launch by differencing launch counts, the ratios."""
    from nerf_simple_tpu_torch.probes import pad_passes

    pad_passes.pad_passes.launches = 0
    res = pad_passes.run_probe(dev)
    launches = pad_passes.pad_passes.launches
    for K, v in res["K"].items():
        print(f"B4 probe K={K:3d}: {v['ms']:.4f} ms a launch ({res['reps']} x (256,{K})@({K},{res['TR']})), "
              f"{v['tflops']:.1f} TFLOP/s at K={K}; plain {v['plain_ms']:.2f} ms; kernel vs plain "
              f"{v['rel_err']:.2e} of max (tol {pad_passes.REL_TOL:.0e})", flush=True)
    print(f"B4 probe ratios: K72/K128 {res['K72_over_K128']:.3f}, K72/K80 {res['K72_over_K80']:.3f}, "
          f"K40/K128 {res['K40_over_K128']:.3f}; TR={res['TR']} columns (64 an SM); launches {launches}",
          flush=True)
    return res, launches


def train_config(d):
    from nerf_simple_tpu_torch.config import train_config_from_dict

    return train_config_from_dict(d)


def scene_focal(scene: str) -> float:
    with open(os.path.join(scene, "transforms_train.json")) as fh:
        fov = json.load(fh)["camera_angle_x"]
    return 400 / (2.0 * np.tan(fov / 2.0))


def main() -> None:
    ap = argparse.ArgumentParser(description="Smoke test of the PyTorch / CUDA port on one GPU.")
    ap.add_argument("--before", metavar="CSRC", help="a csrc/ directory of an earlier commit (kept out "
                    "of the committed tree): its train-step source is built and B1 bf16 timed beside the current one")
    args = ap.parse_args()
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
    from nerf_simple_tpu_torch.probes import bwd_tile, pad_passes, wgrad
    from nerf_simple_tpu_torch.utils.roofline import bound_by, bound_ms

    # 2. build (with --before, the earlier train-step and forward sources too)
    phase_build((*mlp.SOURCES, pad_passes.SOURCE), _build)
    earlier = build_before(args.before, _build, mlp) if args.before else {}

    # 3-4. forward and render kernels vs plain; serving; the fused_eval frame
    model = NerfMLP()
    params = init_nerf_params(SEED, model)
    x16 = chunk_input(dev)
    fwd = phase_forward(dev, params, model, mlp, x16)
    fwd_turns = earlier and phase_forward_before_after(dev, params, model, mlp, x16, earlier["fused_mlp_fwd"])
    rnd = phase_render(dev, params, model, mlp, x16)
    del x16
    torch.cuda.empty_cache()
    serve_launches, frame_ms = phase_serve(dev, params, model, mlp)
    render_launches, fused_frame_ms = phase_fused_frame(dev, params, model, mlp)

    with tempfile.TemporaryDirectory() as work:
        scene = os.path.join(work, "scene")
        t0 = time.perf_counter()
        write_blender_scene(scene, n_train=25, n_val=2, n_test=2, H=800, W=800, device=dev)
        print(f"scene: 25/2/2 images at 800x800 written in {time.perf_counter() - t0:.1f} s", flush=True)
        # 5. B2 and B1 vs plain at the training batch
        bwd = phase_backward_and_step(dev, params, model, mlp, train_batch(dev, scene))
        torch.cuda.empty_cache()
        before = None
        if earlier:  # 5b. B1 (and the f32 forward) of the earlier sources beside the current ones
            batch = train_batch(dev, scene)
            before = phase_before_after(dev, params, model, mlp, batch, earlier["fused_train_step"])
            b32 = phase_before_after(dev, params, model, mlp, batch, earlier["fused_train_step"], torch.float32)
            del batch
            before["f32"] = {**fwd_turns, **b32}
            f, b = fwd_turns["fwd_ms"], b32["b1_ms"]
            print(f"before/after f32: forward at {fwd_turns['rows']} rows earlier {f['earlier']:.3f} ms, current "
                  f"{f['current']:.3f} ms (max abs diff {fwd_turns['fwd_err']:.2e}); B1 at {BATCH * N_SAMPLES} rows "
                  f"earlier {b['earlier']:.3f} ms, current {b['current']:.3f} ms (grads {b32['b1_grad_rel']:.2e} of "
                  "max); profiled ms a B1 call: " + "; ".join(
                      f"{k}: " + ", ".join(f"{g} {v:.3f}" for g, v in sorted(p.items(), key=lambda kv: -kv[1]))
                      for k, p in b32["b1_profile"].items()), flush=True)
        # 6. the weight-gradient sums alone, then the backward tile kernel alone
        wg = phase_wgrad(dev)
        torch.cuda.empty_cache()
        bt = phase_bwd_tile(dev)
        torch.cuda.empty_cache()
        # 7. train
        tr = phase_train(dev, scene, work, mlp, earlier.get("fused_train_step"))
        torch.cuda.empty_cache()
        # 8. eval of the trained run
        ev = phase_eval(dev, scene, work, mlp)
    # 9. the padding probe
    probe, probe_launches = phase_probe(dev)

    # bounds from the shapes (utils/roofline.py): MACs a row of the forward
    # (every packed matrix once) and of B1/B2 (forward recompute, W^T g of
    # the nine transposed matrices, the weight-gradient sums); the bytes
    # each kernel must move, its f32 inputs and outputs
    shapes = mlp._weight_shapes(model)
    fwd_macs = sum(o * k for o, k in shapes.values() if k != 1)
    train_macs = 2 * fwd_macs + sum(shapes[n][0] * shapes[n][1] for n in mlp._TRANSPOSED)
    grad_bytes = 4 * sum(o * k for o, k in shapes.values())
    chunk_rows, batch_rows = CHUNK * N, BATCH * N_SAMPLES

    def bounds(flops, nbytes, nbytes_bf16=None):
        nb = nbytes if nbytes_bf16 is None else nbytes_bf16
        return {"bound_ms": bound_ms(flops, nbytes, torch.float32),
                "bound_by": bound_by(flops, nbytes, torch.float32),
                "bound_ms_bf16": bound_ms(flops, nb, torch.bfloat16),
                "bound_by_bf16": bound_by(flops, nb, torch.bfloat16)}

    def entry(name, source, replaces, launches, st, work, library=(None, None), **extra):
        return {"name": name, "route": "cuda", "source": f"nerf_simple_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, "max_abs_err": st["f32"]["err"],
                "ms": st["f32"]["ms"], "plain_ms": st["f32"]["plain_ms"], **bounds(*work),
                "library_ms": library[0], "max_abs_err_bf16": st["bf16"]["err"],
                "ms_bf16": st["bf16"]["ms"], "plain_ms_bf16": st["bf16"]["plain_ms"],
                "library_ms_bf16": library[1], **extra}

    b2 = {k: bwd[f"B2_{k}"] for k in ("f32", "bf16")}
    b1 = {k: bwd[f"B1_{k}"] for k in ("f32", "bf16")}
    sums = {k: dict(err=wg[k]["max_abs_err"], ms=wg[k]["ms"], plain_ms=wg[k]["plain_ms"])
            for k in ("f32", "bf16")}
    (wg_flops, wg_bytes), (_, wg_bytes_bf16) = (wgrad.work(model, wg["rows"], dt)
                                                for dt in (torch.float32, torch.bfloat16))
    tile = {k: dict(err=bt[k]["max_abs_err"], ms=bt[k]["ms"], plain_ms=bt[k]["plain_ms"]) for k in ("f32", "bf16")}
    (tile_flops, tile_bytes), (_, tile_bytes_bf16) = (bwd_tile.work(model, bt["rows"], dt)
                                                      for dt in (torch.float32, torch.bfloat16))
    probe_bound = {K: bound_ms(2 * pad_passes.M * K * probe["TR"] * probe["reps"], 0, torch.bfloat16)
                   for K in probe["K"]}
    fwd_bound_bf16 = bound_ms(2 * fwd_macs * chunk_rows, 64 * chunk_rows, torch.bfloat16)
    print(smi)
    print(json.dumps({"kernels": [
        entry("fused_mlp_forward", "fused_mlp_fwd.cu", "nerf_simple_tpu/kernels/mlp.py:669",
              serve_launches, fwd, (2 * fwd_macs * chunk_rows, 64 * chunk_rows),
              tflops_bf16=2 * fwd_macs * chunk_rows / (fwd["bf16"]["ms"] * 1e9),
              share_of_bound_bf16=fwd_bound_bf16 / fwd["bf16"]["ms"],
              tflops=fwd["f32"]["tflops"], share_of_bound=fwd["f32"]["share_of_bound"],
              mm_tflops_f32=fwd["f32"]["mm_tflops"],
              source_f32="nerf_simple_tpu_torch/csrc/fwd_f32.cuh", before_after_f32=fwd_turns or None,
              source_bf16="nerf_simple_tpu_torch/csrc/fwd_bf16.cuh",
              frame_ms=frame_ms["pallas"], plain_frame_ms=frame_ms["xla"],
              train_launches=tr["launches"]["fused_mlp_forward"], eval_launches=ev["launches"],
              eval_psnr=ev["psnr"], eval_s_per_still=ev["s_per_still"], eval_s_per_frame=ev["s_per_frame"]),
        entry("fused_mlp_backward", "fused_mlp_bwd.cu", "nerf_simple_tpu/kernels/mlp.py:1147",
              tr["b2_launches"], b2, (2 * train_macs * batch_rows, 64 * batch_rows + grad_bytes),
              grad_rel_err=b2["f32"]["rel"], grad_rel_err_bf16=b2["bf16"]["rel"]),
        entry("fused_train_step", "fused_train_step.cu", "nerf_simple_tpu/kernels/mlp.py:1623",
              tr["launches"]["fused_train_step"], b1, (2 * train_macs * batch_rows, 64 * batch_rows + grad_bytes),
              grad_rel_err=b1["f32"]["rel"], grad_rel_err_bf16=b1["bf16"]["rel"],
              loss_rel_err=b1["f32"]["loss_err"], loss_rel_err_bf16=b1["bf16"]["loss_err"],
              step_ms_bf16=tr["step_ms"], step_host_ms_bf16=tr["host_ms"], step_profile_ms_bf16=tr["profile"],
              before_after=before and {**before, "step": tr["turns"]}),
        entry("wgrad_sums", "wgrad.cuh", "nerf_simple_tpu/kernels/mlp.py:774",
              tr["launches"]["wgrad_sums"], sums, (wg_flops, wg_bytes, wg_bytes_bf16),
              (wg["f32"]["library_ms"], wg["bf16"]["library_ms"]),
              replaces_also="nerf_simple_tpu/kernels/mlp.py:1081",
              ms_twelve_calls=wg["f32"]["ms_single"], ms_twelve_calls_bf16=wg["bf16"]["ms_single"],
              rel_err_f64=wg["f32"]["rel_err"], rel_err_f64_bf16=wg["bf16"]["rel_err"],
              plain_rel_err_f64=wg["f32"]["plain_rel_err"], plain_rel_err_f64_bf16=wg["bf16"]["plain_rel_err"]),
        entry("bwd_tile", "bwd_bf16.cuh", "nerf_simple_tpu/kernels/mlp.py:808",
              tr["launches"]["bwd_tile"], tile, (tile_flops, tile_bytes, tile_bytes_bf16),
              replaces_also="nerf_simple_tpu/kernels/mlp.py:757", source_f32="nerf_simple_tpu_torch/csrc/mlp_tile.cuh",
              share_of_bound=bt["f32"]["share_of_bound"], share_of_bound_bf16=bt["bf16"]["share_of_bound"],
              rel_err=bt["f32"]["rel_err"], rel_err_bf16=bt["bf16"]["rel_err"],
              gb_s_bf16=bt["bf16"]["gb_s"], probe_launches=bt["bf16"]["launches"],
              step_profile_ms_bf16=tr["profile"].get("bwd_tile")),
        entry("fused_render", "fused_render.cu", "nerf_simple_tpu/kernels/mlp.py:1734",
              render_launches, rnd, (2 * fwd_macs * chunk_rows, 96 * chunk_rows),
              frame_ms=fused_frame_ms["f32"]["fused"], unfused_frame_ms=fused_frame_ms["f32"]["unfused"],
              frame_ms_bf16=fused_frame_ms["bf16"]["fused"],
              unfused_frame_ms_bf16=fused_frame_ms["bf16"]["unfused"]),
        {"name": "pad_passes_probe", "route": "cuda",
         "source": "nerf_simple_tpu_torch/csrc/pad_passes_probe.cu",
         "replaces": "scripts/pad_passes_probe.py:82", "launches": probe_launches,
         "max_abs_err": max(v["max_abs_err"] for v in probe["K"].values()),
         "ms": probe["K"][72]["ms"], "plain_ms": probe["K"][72]["plain_ms"],
         "bound_ms": probe_bound[72], "bound_by": "operations", "library_ms": None,
         "K": {str(K): {"ms": v["ms"], "plain_ms": v["plain_ms"], "bound_ms": probe_bound[K],
                        "tflops": v["tflops"], "rel_err": v["rel_err"]} for K, v in probe["K"].items()},
         "TR": probe["TR"], "reps": probe["reps"], "K72_over_K128": probe["K72_over_K128"],
         "K72_over_K80": probe["K72_over_K80"], "K40_over_K128": probe["K40_over_K128"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
