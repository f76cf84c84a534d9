"""Padding probe: does a bf16 matmul of contraction depth K = 72 cost
what K = 80 costs, or what K = 128 costs? (port of
scripts/pad_passes_probe.py, the TPU's probe of the same question).

    python -m nerf_simple_tpu_torch.probes.pad_passes
    python -m nerf_simple_tpu_torch.probes.pad_passes --device cpu   # smoke test

The packed layout pads posx to K = 72 and posd to K = 40; mma.sync takes
K in steps of 16, so K = 72 does the work of K = 80. The probe times a
recurrence of ``reps`` bf16 ``(256, K) x (K, TR)`` matmuls inside one
launch (csrc/pad_passes_probe.cu) for K = 40, 72, 80 and 128, each as the
difference of two launch counts (CUDA events), and prints the ms, the
TFLOP/s counted at the nominal K, and the ratios K72/K128, K72/K80 and
K40/K128. TR is 64 columns for each of the card's SMs, one block an SM
(8,448 on an H100); the TPU probe's TR = 1024 would leave most SMs idle.
The kernel is held to ``pad_passes_plain`` at the same shapes.

On the CPU the probe runs the plain version at ``reps=2`` as a smoke
test: it prints no times.
"""

from __future__ import annotations

import argparse
import ctypes
import json

import numpy as np
import torch

from nerf_simple_tpu_torch.kernels import _build

M = 256  # output rows, the flagship's layer width
KS = (40, 72, 80, 128)
REPS = 2048  # matmuls in one launch, as in the TPU probe
TC = 64  # columns a block of the kernel owns
# Kernel vs plain, max abs error over the plain result's max abs value.
# Both round the same operands to bf16 and sum exact products in f32, but
# the tensor cores add each k-step of 16 products into the accumulator
# without rounding to nearest: each of the reps * ceil(K/16) mma steps can
# lose ~1 ulp of acc (6e-8 relative), up to ~1e-3 at 2048 x 8 steps. The
# card measured 3.2e-4 (K = 40) to 7.2e-4 (K = 128), growing with the
# k-steps, where the plain version rounds each of its reps adds once.
REL_TOL = 1e-3
SOURCE = "pad_passes_probe"


def pad_passes_plain(x: torch.Tensor, W: torch.Tensor, reps: int) -> torch.Tensor:
    """``acc += W . bf16(x + acc[:K] * 1e-20)``, ``reps`` times from 0:
    both operands rounded to bf16, products summed in f32."""
    K = x.shape[0]
    w = W.to(torch.bfloat16).float()
    acc = torch.zeros((W.shape[0], x.shape[1]), dtype=torch.float32, device=x.device)
    for _ in range(reps):
        xi = (x + acc[:K] * 1e-20).to(torch.bfloat16).float()
        acc = acc + w @ xi
    return acc


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    P = ctypes.c_void_p
    lib.pad_passes_probe.argtypes = [P, P, P, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, P]
    lib.pad_passes_probe.restype = ctypes.c_int
    return lib


def pad_passes(x: torch.Tensor, W: torch.Tensor, reps: int) -> torch.Tensor:
    """The probe's recurrence: ``x (K, TR)``, ``W (256, K)`` f32 -> ``(256,
    TR)`` f32. A CPU tensor takes the plain version, a CUDA tensor the
    kernel; any other device raises."""
    K = x.shape[0] if x.dim() == 2 else -1
    if not 1 <= K <= 128 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (K, TR) f32 tensor, 1 <= K <= 128; got "
                         f"{tuple(x.shape)} {x.dtype}")
    if (tuple(W.shape) != (M, K) or W.dtype != torch.float32 or not W.is_contiguous()
            or W.device != x.device):
        raise ValueError(f"W must be a contiguous ({M}, {K}) f32 tensor on {x.device}; got "
                         f"{tuple(W.shape)} {W.dtype} on {W.device}")
    if reps < 0:
        raise ValueError(f"reps must be >= 0, got {reps}")
    if x.device.type == "cpu":
        return pad_passes_plain(x, W, reps)
    if x.device.type != "cuda":
        raise ValueError(f"no padding-probe kernel for device {x.device}")
    out = torch.empty((M, x.shape[1]), dtype=torch.float32, device=x.device)
    err = _lib().pad_passes_probe(x.data_ptr(), W.data_ptr(), out.data_ptr(), K, x.shape[1],
                                  reps, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pad_passes_probe launch failed: cudaError {err}")
    pad_passes.launches += 1
    return out


pad_passes.launches = 0


def inputs(K: int, TR: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """x (K, TR) ~ N(0, 0.1^2) and W (256, K) ~ N(0, 0.01^2), from numpy
    seed K (the TPU probe's scales)."""
    rng = np.random.default_rng(K)
    x = (rng.standard_normal((K, TR)) * 0.1).astype(np.float32)
    w = (rng.standard_normal((M, K)) * 0.01).astype(np.float32)
    return torch.from_numpy(x).to(device), torch.from_numpy(w).to(device)


def default_tr(device) -> int:
    """64 columns for each SM of the card: one block an SM."""
    return TC * torch.cuda.get_device_properties(device).multi_processor_count


def _events_ms(fn, n: int) -> float:
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def launch_ms(fn) -> float:
    """ms a launch: the median of 3 of (time of 10 launches - time of 2) /
    8, which cancels any constant cost of a timed run; after one warm-up
    launch."""
    fn()
    torch.cuda.synchronize()
    return float(np.median([(_events_ms(fn, 10) - _events_ms(fn, 2)) / 8 for _ in range(3)]))


def run_probe(device) -> dict:
    """On the card: per K, the kernel's ms a launch, its TFLOP/s at the
    nominal K, the plain version's ms and the kernel's error against it;
    then the ratios K72/K128, K72/K80 and K40/K128. Raises if an error is
    above REL_TOL."""
    tr, reps = default_tr(device), REPS
    res: dict = {"TR": tr, "reps": reps, "K": {}}
    for K in KS:
        x, W = inputs(K, tr, device)
        got = pad_passes(x, W, reps)
        want = pad_passes_plain(x, W, reps)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"K={K}: kernel output not finite")
        err = (got - want).abs().max().item()
        rel = err / max(want.abs().max().item(), 1e-30)
        if rel > REL_TOL:
            raise RuntimeError(f"K={K}: kernel vs plain {rel:.3e} of max > {REL_TOL:.0e}")
        del got, want
        ms = launch_ms(lambda: pad_passes(x, W, reps))
        plain_ms = float(np.median([_events_ms(lambda: pad_passes_plain(x, W, reps), 1)
                                    for _ in range(3)]))
        res["K"][K] = dict(ms=ms, tflops=2 * M * K * tr * reps / (ms * 1e-3) / 1e12,
                           plain_ms=plain_ms, max_abs_err=err, rel_err=rel)
    ms = {K: v["ms"] for K, v in res["K"].items()}
    res.update(K72_over_K128=ms[72] / ms[128], K72_over_K80=ms[72] / ms[80],
               K40_over_K128=ms[40] / ms[128])
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="bf16 matmul cost against contraction depth K")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu for a smoke test")
    args = ap.parse_args(argv)
    from nerf_simple_tpu_torch.utils.device import require_device

    device = require_device(args.device)
    if device.type == "cpu":
        for K in KS:
            x, W = inputs(K, 128, device)
            out = pad_passes(x, W, 2)
            if out.shape != (M, 128) or not bool(torch.isfinite(out).all()):
                raise RuntimeError(f"K={K}: plain probe output bad")
        print(f"CPU smoke test only: the plain probe ran for K={list(KS)} at reps=2, TR=128 "
              "and returned finite values; it times nothing on the CPU")
        return
    res = run_probe(device)
    print(f"{torch.cuda.get_device_name(device)}: TR={res['TR']} columns, reps={res['reps']}")
    for K, v in res["K"].items():
        print(f"K={K:3d}: {v['ms']:.4f} ms a launch ({res['reps']}x (256,{K})@({K},{res['TR']}); "
              f"{v['tflops']:.1f} TFLOP/s at K={K}); plain {v['plain_ms']:.2f} ms; "
              f"kernel vs plain {v['rel_err']:.2e} of max")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
