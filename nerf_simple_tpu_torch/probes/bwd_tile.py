"""The backward tile kernel alone, at the training batch: the kernel
(``kernels/mlp.py::backward_tile``; bf16 csrc/bwd_bf16.cuh, f32
csrc/bwd_f32.cuh) against its plain version ``backward_tile_plain``.

    python -m nerf_simple_tpu_torch.probes.bwd_tile
    python -m nerf_simple_tpu_torch.probes.bwd_tile --device cpu   # smoke test

For the flagship ``NerfMLP(Lp=10, Ld=4, H=256)`` at 524,288 rows (a
4096-ray x 128-sample batch), from numpy seed 0: the residual planes of
the workspace (2,288 features), each entry zero where u < 0.5 and 2 (u -
0.5) elsewhere (u uniform: half of each plane as after a relu); the
output cotangents g (8, rows), d_rgb and d_sigma normal(0, 1); random
weights ``init_nerf_params(0)``, packed. For f32 and bf16 it runs the
kernel and the plain version on them, compares the cotangent planes
(per plane group: g_rgb8, g_cs, g_h7 .. g_h0) and times both: CUDA
events around CALLS calls back to back (so the wrapper's host time
between launches is hidden, as in a step), the median of 5 in turns
kernel / plain / plain / kernel ...

What the kernel must move, counted once (the bound): the residual planes
it reads (h0..h7, hc: 8 H + H/2 features), the rows 0..3 of g, the
weights, and the cotangent planes it writes (16 + H/2 + 8 H features);
its operations are the products W^T g of the chain, 2 x (8 H/2 + (H/2 +
8) H + 7 H^2) a row.

``before_after`` times the f32 tile kernel of other builds of
csrc/fused_mlp_bwd.cu (an earlier commit's, or a variant's) beside the
current one on the same inputs, in turns, with the max abs difference
of their planes from the current ones: ``chip_smoke.py --before`` runs
it.

On the CPU it runs the wrapper (its plain version) at 256 rows: it times
nothing.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from nerf_simple_tpu_torch.kernels import mlp
from nerf_simple_tpu_torch.models.nerf import NerfField, NerfMLP, init_nerf_params
from nerf_simple_tpu_torch.probes.wgrad import turns_ms
from nerf_simple_tpu_torch.utils.roofline import bound_by, bound_ms

ROWS = 524_288  # BATCH x N_SAMPLES of configs/lego.yaml
CALLS = 10  # calls a timing
# Kernel against plain, per plane group: max abs error over the group's
# largest entry. f32: both sum the same f32 products in another order, a
# few ulps a layer, carried through nine layers: 1e-4. bf16: the order
# also flips the bf16 rounding of an occasional cotangent by one ulp
# (2^-8 = 3.9e-3 of it), and every layer below carries that into its
# products; 2e-2 bounds a few such ulps of the largest entry.
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def groups(model: NerfMLP) -> dict[str, tuple[int, int]]:
    """The cotangent planes by group: name -> (first feature, features)."""
    L = mlp.Layout.of(model)
    out = {"g_rgb8": (L.gr8, 8), "g_cs": (L.gcs, model.H // 2 + 8)}
    out.update({f"g_h{l}": (L.gh(l), model.H) for l in range(7, -1, -1)})
    return out


def inputs(model: NerfMLP, rows: int, device, seed: int = 0):
    """(packed f32 weights, residual planes (FA, Rp) f32, g (8, rows) f32)
    from numpy seed ``seed``, the planes made 64 features at a time."""
    rng = np.random.default_rng(seed)
    L = mlp.Layout.of(model)
    Rp = -(-rows // 64) * 64
    res = torch.empty((L.FA, Rp), dtype=torch.float32, device=device)
    for f0 in range(0, L.FA, 64):
        u = rng.random((min(64, L.FA - f0), Rp), dtype=np.float32)
        res[f0 : f0 + u.shape[0]] = torch.from_numpy(np.where(u < 0.5, 0.0, 2 * (u - 0.5)).astype(np.float32))
    g = np.zeros((8, rows), np.float32)
    g[:4] = rng.normal(size=(4, rows))
    wts = mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(seed, model), device))
    return wts, res, torch.from_numpy(g).to(device)


def work(model: NerfMLP, rows: int, dtype) -> tuple[float, float]:
    """FLOPs of the chain and the bytes the kernel must move (see the
    module's docstring)."""
    H, H2 = model.H, model.H // 2
    L = mlp.Layout.of(model)
    es = torch.finfo(dtype).bits // 8
    flops = 2.0 * (8 * H2 + (H2 + 8) * H + 7 * H * H) * rows
    weights = es * (8 * H2 + (H2 + 8) * H + 7 * H * H)
    return flops, es * (8 * H + H2 + L.FG) * rows + 16 * rows + weights


def errors(got: torch.Tensor, want: torch.Tensor, model: NerfMLP) -> dict[str, float]:
    """Per plane group, max abs error over the group's largest entry."""
    out = {}
    for name, (f0, F) in groups(model).items():
        g, w = got[f0 : f0 + F].float(), want[f0 : f0 + F].float()
        out[name] = ((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
    return out


def run(device, model: NerfMLP = mlp.FLAGSHIP, rows: int = ROWS) -> dict:
    """On the card, per compute type: the kernel and the plain version on
    the probe's inputs: ms of both, the bound and its share, GB/s, the
    kernel's launches, its errors from the plain planes (per group) and
    the share of entries that differ. Raises if an error exceeds REL_TOL
    or a pad row is not zero."""
    torch.backends.cuda.matmul.allow_tf32 = False
    wts, res32, g = inputs(model, rows, device)
    out = {"rows": rows}
    for dt in (torch.float32, torch.bfloat16):
        name = "f32" if dt == torch.float32 else "bf16"
        w = mlp._cast_weights(wts, dt)
        res = res32 if dt == torch.float32 else res32.to(dt)
        before = mlp.backward_tile.launches
        got = mlp.backward_tile(w, res, g, dt, model)
        launches = mlp.backward_tile.launches - before
        want = mlp.backward_tile_plain(w, res, g, dt, model)
        errs = errors(got, want, model)
        differ = (got.float() != want).float().mean().item()
        max_abs = (got.float() - want).abs().max().item()
        pad_zero = bool((got[:, rows:] == 0).all())
        del got, want
        torch.cuda.empty_cache()
        ms = turns_ms({"kernel": lambda: mlp.backward_tile(w, res, g, dt, model),
                       "plain": lambda: mlp.backward_tile_plain(w, res, g, dt, model)}, calls=CALLS)
        flops, nbytes = work(model, rows, dt)
        b = bound_ms(flops, nbytes, dt)
        out[name] = dict(ms=ms["kernel"], plain_ms=ms["plain"], bound_ms=b, bound_by=bound_by(flops, nbytes, dt),
                         share_of_bound=b / ms["kernel"], gb_s=nbytes / (ms["kernel"] * 1e-3) / 1e9,
                         tflops=flops / (ms["kernel"] * 1e-3) / 1e12, launches=launches,
                         rel_err=max(errs.values()), rel_err_by_group=errs, share_differ=differ,
                         max_abs_err=max_abs)
        if max(errs.values()) > REL_TOL[dt]:
            raise RuntimeError(f"{name} backward tile: kernel {max(errs.values()):.3e} of max from the plain "
                               f"planes > {REL_TOL[dt]:.0e} ({errs})")
        if not pad_zero:
            raise RuntimeError(f"{name} backward tile: a pad row's cotangent is not zero")
        del res
        torch.cuda.empty_cache()
    return out


def before_after(device, libs: dict, model: NerfMLP = mlp.FLAGSHIP, rows: int = ROWS) -> dict:
    """The f32 tile kernel of other fused_mlp_bwd libraries (``libs``: label
    -> library, its ``backward_tile`` and ``bwd_tile_image_bytes`` bound)
    beside the current one on the probe's inputs: ms of each (label
    "current" among them), runs of CALLS calls back to back, median of 5
    in turns; all called straight through ctypes with their outputs and
    weight images made once, the others given the transposes (an earlier
    f32 kernel reads them). Also each one's max abs difference from the
    current planes, and that over the planes' largest entry."""
    wts, res, g = inputs(model, rows, device)
    cw = mlp._CPtrs(*mlp._ptrs(wts))
    L = mlp.Layout.of(model)

    def bind(lib, wt, what):
        out = torch.empty((L.FG, res.shape[1]), dtype=torch.float32, device=device)
        image = torch.empty(max(lib.bwd_tile_image_bytes(model.H, 0), 16), dtype=torch.uint8, device=device)

        def call():
            mlp._raise_on(lib.backward_tile(g.data_ptr(), rows, model.Lp, model.Ld, model.H, 0, cw, wt,
                                            res.data_ptr(), out.data_ptr(), image.data_ptr(), 0, mlp._stream(g)), what)
        return call, out

    calls, outs = {}, {}
    calls["current"], outs["current"] = bind(mlp._lib("fused_mlp_bwd"), mlp._weights_t(wts), "backward_tile")
    for label, lib in libs.items():
        calls[label], outs[label] = bind(lib, mlp._transposed(wts), f"{label} backward_tile")
    with torch.no_grad():
        for call in calls.values():
            call()
        torch.cuda.synchronize()
        diff = {k: (o - outs["current"]).abs().max().item() for k, o in outs.items() if k != "current"}
        scale = outs["current"].abs().max().clamp_min(1e-30).item()
        ms = turns_ms(calls, calls=CALLS)
    del outs
    torch.cuda.empty_cache()
    return {"rows": rows, "ms": ms, "max_abs_diff": diff, "rel_diff": {k: d / scale for k, d in diff.items()}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="the backward tile kernel alone")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu for a smoke test")
    args = ap.parse_args(argv)
    from nerf_simple_tpu_torch.utils.device import require_device

    device = require_device(args.device)
    if device.type == "cpu":
        model = mlp.FLAGSHIP
        wts, res, g = inputs(model, 256, device)
        for dt in (torch.float32, torch.bfloat16):
            got = mlp.backward_tile(wts, res.to(dt), g, dt, model)
            if got.shape != (mlp.Layout.of(model).FG, 256) or not bool(torch.isfinite(got.float()).all()):
                raise RuntimeError(f"{dt}: plain backward tile bad")
        print("CPU smoke test only: the plain backward tile ran at 256 rows; it times nothing on the CPU")
        return
    res = run(device)
    print(f"{torch.cuda.get_device_name(device)}: backward tile at {res['rows']} rows")
    for name in ("f32", "bf16"):
        v = res[name]
        print(f"{name}: kernel {v['ms']:.3f} ms, plain {v['plain_ms']:.3f} ms; bound {v['bound_ms']:.3f} ms "
              f"({v['bound_by']}), {100 * v['share_of_bound']:.1f}% of it; {v['gb_s']:.0f} GB/s; "
              f"from plain {v['rel_err']:.2e} of max")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
