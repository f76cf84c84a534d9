"""The input-gradient kernel alone, at the training batch: the kernel
(``kernels/mlp.py::input_grad``, csrc/input_grad.cuh) against its plain
version ``input_grad_plain`` and beside a library yardstick.

    python -m nerf_simple_tpu_torch.probes.input_grad
    python -m nerf_simple_tpu_torch.probes.input_grad --device cpu   # smoke test

For the flagship ``NerfMLP(Lp=10, Ld=4, H=256)`` at 524,288 rows (a
4096-ray x 128-sample batch), from numpy seed 0: the workspace's
cotangent planes g_h0, g_h5 and g_cs (the three the kernel reads; the
others zero), each entry zero where u < 0.5 and normal(0, 1) elsewhere
(half of each plane masked, as after a relu); x (8, rows) with xyz
uniform in [-4, 4] and a unit direction; random weights
``init_nerf_params(0)``, packed. For f32 and bf16 and for the anneal
windows off and at alpha 0.3 it runs the kernel and the plain version,
compares ``dx`` (max abs error over max |dx|) and times them: CUDA events
around CALLS calls back to back, the median of 5 in turns kernel / plain /
library / library / plain / kernel ...

What the kernel must move and compute (the bound) is
``utils/roofline.py::input_grad_work``: 640 plane rows a row in the
compute type, x and dx, and 71,424 flop a row at the flagship; bf16 is
then bound by its bytes (0.21 ms), f32 by its operations at 67 TFLOP/s
(0.56 ms).

The library yardstick (``library``, timed here and used nowhere in the
package): ``torch.mm`` in the compute type for the three products, added
in f32, then the transpose's elementwise tail in torch
(``mlp._encode_transpose``).

On the CPU it runs the wrapper (its plain version) at 256 rows: it times
nothing.

``explain_dx`` holds B2's ``dx`` (``fused_mlp_backward(want_dx=True)``)
against the plain chain row by row (the position and direction rows each
against their own largest entry) and names the cause of each row that
lies farther than the tolerance from it. B2's cotangent chain reads the
relu masks of its own forward; where a pre-activation lies within that
forward's rounding of 0, the kernel's mask and the plain chain's differ
and the row's dx moves by a whole term. So a row past the tolerance must
be a row with a flipped mask, and on the kernel's own masks the plain
chain must give B2's dx within the tolerance at every row. Two planted
faults show what the rule catches: the plain chain's dx with one octave
window halved in the input gradient only.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from nerf_simple_tpu_torch.kernels import mlp
from nerf_simple_tpu_torch.models.nerf import NerfField, NerfMLP, init_nerf_params
from nerf_simple_tpu_torch.probes.wgrad import turns_ms
from nerf_simple_tpu_torch.utils.roofline import bound_by, bound_ms, input_grad_work

ROWS = 524_288  # BATCH x N_SAMPLES of configs/lego.yaml
CALLS = 10  # calls a timing
ALPHA = 0.3  # the anneal progress of the windowed case
# Kernel against plain: max abs error over max |dx|. Both take the same
# operands (bf16 values are exact in f32) and sum in f32 in another
# order; the transpose scales octave i by 2^i (512 at the top octave),
# so the sums' few ulps reach dx unevenly: 1e-4 (f32) and 5e-3 (bf16)
# are wide.
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-3}


def inputs(model: NerfMLP, rows: int, device, seed: int = 0):
    """(packed f32 weights, cotangent planes (FG, Rp) f32, x (8, rows) f32)
    from numpy seed ``seed``."""
    rng = np.random.default_rng(seed)
    L = mlp.Layout.of(model)
    Rp = -(-rows // 64) * 64
    gws = torch.zeros((L.FG, Rp), dtype=torch.float32, device=device)
    for f0, F in ((L.gh(0), model.H), (L.gh(5), model.H), (L.gcs, model.H // 2)):
        for a in range(f0, f0 + F, 64):
            n = min(64, f0 + F - a)
            u = rng.random((n, rows), dtype=np.float32)
            g = np.where(u < 0.5, 0.0, rng.standard_normal((n, rows), dtype=np.float32)).astype(np.float32)
            gws[a : a + n, :rows] = torch.from_numpy(g)
    x = np.zeros((8, rows), np.float32)
    x[:3] = rng.uniform(-4, 4, (3, rows))
    d = rng.normal(size=(3, rows))
    x[3:6] = d / np.linalg.norm(d, axis=0, keepdims=True)
    wts = mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(seed, model), device))
    return wts, gws, torch.from_numpy(x).to(device)


def library(wts, x, gws, dt, model: NerfMLP) -> torch.Tensor:
    """The yardstick: torch.mm in ``dt`` for the three products, the
    transpose's tail in torch."""
    L, rows = mlp.Layout.of(model), x.shape[1]
    g = gws[:, :rows]
    gx = (torch.mm(wts.W1.T, g[L.gh(0) : L.gh(0) + L.H]).float()
          + torch.mm(wts.Wsx.T, g[L.gh(5) : L.gh(5) + L.H]).float())
    gd = torch.mm(wts.Wcd.T, g[L.gcs : L.gcs + L.H // 2]).float()
    return mlp._encode_transpose(x, gx, gd, model)


def mask_flips(res: torch.Tensor, res_plain: torch.Tensor, model: NerfMLP, rows: int) -> torch.Tensor:
    """(rows,) bool: the rows where a relu mask (h0..h7, hc > 0) of the
    residual planes ``res`` differs from that of ``res_plain``."""
    L = mlp.Layout.of(model)
    return ((res[L.h(0) : L.FA, :rows] > 0) != (res_plain[L.h(0) : L.FA, :rows] > 0)).any(0)


def _fault_windows(model: NerfMLP, enc_w: tuple | None, branch: int, device) -> tuple:
    """The windows ``enc_w`` (all ones without them) with one octave's
    window halved: posx's highest octave with a window of at least 0.5
    (``branch`` 0), or posd's lowest (``branch`` 1)."""
    w = [t.clone() for t in (enc_w or mlp.anneal_row_weights(model, 1.0, device))]
    L = (model.Lp, model.Ld)[branch]
    sb = mlp._sin_block(L)
    octave = int((w[0][8 : 8 + L] >= 0.5).nonzero().max()) if branch == 0 else 0
    for c in range(3):
        w[branch][8 + L * c + octave] *= 0.5
        w[branch][8 + sb + L * c + octave] *= 0.5
    return tuple(w)


def row_err(dx: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """(rows,) the error of each row of ``dx`` (8, rows) against ``want``:
    the larger of max |diff| over the position rows 0..2 by max
    |want[0:3]| and over the direction rows 3..5 by max |want[3:6]|. The
    direction's gradient runs ~2^(Lp - Ld) below the position's, so one
    scale for both would hide an error in it."""
    d = (dx - want).abs()
    return torch.maximum(d[0:3].amax(0) / want[0:3].abs().max().clamp_min(1e-30),
                         d[3:6].amax(0) / want[3:6].abs().max().clamp_min(1e-30))


def explain_dx(wts, x, g, dx, dx_plain, dt, model: NerfMLP, enc_w: tuple | None = None,
               tol: float | None = None) -> dict:
    """B2's ``dx`` (8, rows) against the plain chain's ``dx_plain`` for the
    same weights ``wts`` (cast to ``dt``), inputs ``x`` (8, rows), output
    cotangents ``g`` (8, rows) and windows ``enc_w``: ``n_past`` rows
    whose ``row_err`` exceeds ``tol`` (default REL_TOL; ``share`` of the
    rows); ``n_flipped`` rows where a relu mask of the forward kernel's
    residual planes (what B2 recomputes) differs from the plain chain's;
    ``n_unexplained`` rows past with no flipped mask; ``own_masks_err``,
    the largest ``row_err`` of dx against the plain chain on the kernel's
    planes. ``faults``: for each planted fault (``_fault_windows``) its
    ``share`` and ``n_unexplained`` against ``dx_plain``."""
    tol = REL_TOL[dt] if tol is None else tol
    rows = x.shape[1]
    past = row_err(dx, dx_plain) > tol
    _, res = mlp.forward_residuals(wts, x, dt, model, enc_w=enc_w)
    _, res_plain = mlp.forward_residuals_plain(wts, x, dt, model, enc_w=enc_w)
    flipped = mask_flips(res, res_plain, model, rows)
    own = mlp.input_grad_plain(wts, x, mlp.backward_tile_plain(wts, res.float(), g, dt, model), dt, model, enc_w)
    del res
    out = dict(n_past=int(past.sum()), share=past.float().mean().item(), n_flipped=int(flipped.sum()),
               n_unexplained=int((past & ~flipped).sum()),
               own_masks_err=row_err(dx, own).max().item(), rows=rows, tol=tol, faults={})
    del own
    gws = mlp.backward_tile_plain(wts, res_plain, g, dt, model)
    del res_plain
    for name, branch in (("posx_top_octave_half", 0), ("posd_low_octave_half", 1)):
        bad = mlp.input_grad_plain(wts, x, gws, dt, model, _fault_windows(model, enc_w, branch, x.device))
        fpast = row_err(bad, dx_plain) > tol
        out["faults"][name] = dict(share=fpast.float().mean().item(), n_unexplained=int((fpast & ~flipped).sum()))
        del bad
    return out


def run(device, model: NerfMLP = mlp.FLAGSHIP, rows: int = ROWS) -> dict:
    """On the card, per compute type and windows off / at ALPHA: the kernel,
    the plain version and the library yardstick on the probe's inputs: ms
    of each, the bound and its share, the kernel's launches and its error
    from plain. Raises if an error exceeds REL_TOL."""
    torch.backends.cuda.matmul.allow_tf32 = False
    wts, gws32, x = inputs(model, rows, device)
    out = {"rows": rows, "alpha": ALPHA}
    for dt in (torch.float32, torch.bfloat16):
        name = "f32" if dt == torch.float32 else "bf16"
        w = mlp._cast_weights(wts, dt)
        gws = gws32 if dt == torch.float32 else gws32.to(dt)
        for case, enc_w in (("", None), ("_anneal", mlp.anneal_row_weights(model, ALPHA, device))):
            before = mlp.input_grad.launches
            got = mlp.input_grad(w, x, gws, dt, model, enc_w)
            launches = mlp.input_grad.launches - before
            want = mlp.input_grad_plain(w, x, gws, dt, model, enc_w)
            err = ((got - want).abs().max() / want.abs().max()).item()
            out[name + case] = dict(rel_err=err, max_abs_err=(got - want).abs().max().item(),
                                    max_abs_dx=want.abs().max().item(), launches=launches,
                                    rows_6_7_zero=bool((got[6:] == 0).all()))
            if err > REL_TOL[dt] or not out[name + case]["rows_6_7_zero"]:
                raise RuntimeError(f"{name}{case} input gradient: kernel {err:.3e} of max |dx| from plain > "
                                   f"{REL_TOL[dt]:.0e}, or rows 6..7 not zero")
            del got, want
        ms = turns_ms({"kernel": lambda: mlp.input_grad(w, x, gws, dt, model),
                       "plain": lambda: mlp.input_grad_plain(w, x, gws, dt, model),
                       "library": lambda: library(w, x, gws, dt, model)}, calls=CALLS)
        ms_anneal = turns_ms({"kernel": lambda: mlp.input_grad(w, x, gws, dt, model, enc_w)}, calls=CALLS)["kernel"]
        flops, nbytes = input_grad_work(model, rows, dt)
        b = bound_ms(flops, nbytes, dt)
        out[name].update(ms=ms["kernel"], plain_ms=ms["plain"], library_ms=ms["library"], ms_anneal=ms_anneal,
                         bound_ms=b, bound_by=bound_by(flops, nbytes, dt), share_of_bound=b / ms["kernel"],
                         gb_s=nbytes / (ms["kernel"] * 1e-3) / 1e9, tflops=flops / (ms["kernel"] * 1e-3) / 1e12)
        del gws
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="the input-gradient kernel alone")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu for a smoke test")
    args = ap.parse_args(argv)
    from nerf_simple_tpu_torch.utils.device import require_device

    device = require_device(args.device)
    if device.type == "cpu":
        model = mlp.FLAGSHIP
        wts, gws, x = inputs(model, 256, device)
        for dt in (torch.float32, torch.bfloat16):
            got = mlp.input_grad(wts, x, gws.to(dt), dt, model, mlp.anneal_row_weights(model, ALPHA))
            if got.shape != (8, 256) or not bool(torch.isfinite(got).all()):
                raise RuntimeError(f"{dt}: plain input gradient bad")
        print("CPU smoke test only: the plain input gradient ran at 256 rows; it times nothing on the CPU")
        return
    res = run(device)
    print(f"{torch.cuda.get_device_name(device)}: input gradient at {res['rows']} rows")
    for name in ("f32", "bf16"):
        v = res[name]
        print(f"{name}: kernel {v['ms']:.3f} ms (windows {v['ms_anneal']:.3f}), plain {v['plain_ms']:.3f} ms, "
              f"library {v['library_ms']:.3f} ms; bound {v['bound_ms']:.3f} ms ({v['bound_by']}), "
              f"{100 * v['share_of_bound']:.1f}% of it; from plain {v['rel_err']:.2e} of max |dx| "
              f"(windows {res[name + '_anneal']['rel_err']:.2e})")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
