"""The backward's twelve weight-gradient sums alone, at the training
batch: the kernel (``kernels/mlp.py::weight_grad``, csrc/wgrad.cuh)
against its plain version, a float64 reference and one PyTorch library
call per sum.

    python -m nerf_simple_tpu_torch.probes.wgrad
    python -m nerf_simple_tpu_torch.probes.wgrad --device cpu   # smoke test

For the flagship ``NerfMLP(Lp=10, Ld=4, H=256)`` at Rp = 524,288 rows (a
4096-ray x 128-sample batch), the cotangent planes (2,192 features) and
the residual planes (2,288) are laid out as the backward's workspace
lays them out, from numpy seed 0: G has about half its entries zero (a
relu mask), the rest uniform in [-1, 1); A has half its entries zero,
the rest uniform in [0, 1). For f32 and bf16 it runs the twelve sums
through the kernel (in one launch, ``weight_grads``, as the backward runs
them, and as twelve ``weight_grad`` calls), the plain version
(``weight_grad_plain``) and the library yardstick ``torch.mm(G, A.t())``
+ ``G.sum(1)`` (timed here and never called by the port), and compares
kernel and plain with float64 sums of the operands as stored. Times are
CUDA events around CALLS calls back to back (so the wrapper's host time
between launches is hidden, as in a step), the median of 5 in turns
kernel / library / twelve calls / plain / plain / twelve calls / library
/ kernel ...; TF32 is off.

On the CPU it runs the plain version at 256 rows: it times nothing.
"""

from __future__ import annotations

import argparse
import json
import numpy as np
import torch

from nerf_simple_tpu_torch.kernels import mlp
from nerf_simple_tpu_torch.models.nerf import NerfMLP
from nerf_simple_tpu_torch.utils.roofline import bound_by, bound_ms

ROWS = 524_288  # BATCH x N_SAMPLES of configs/lego.yaml
CALLS = 10  # calls a timing
# Kernel against float64 sums of the operands as stored, max abs error
# over the largest entry of the reference, per sum (dW and db together).
# Only the f32 accumulation of 524,288 products differs. f32: the sums
# round each add to nearest in f32 over row chunks; their error grows like
# sqrt(rows) ulps, ~1e-6 of the largest entry; 1e-4 leaves room for a
# chunked order. bf16: the tensor cores add each k-step of 16 products to
# the accumulator without rounding to nearest (B4 measured up to 7.2e-4
# over 16,384 steps on the card); 1e-3.
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}


def sums(model: NerfMLP) -> tuple[list[mlp.WgradTask], int, int]:
    """The twelve sums in the backward's order (``mlp.wgrad_tasks``), and
    the feature counts of the cotangent and residual workspaces (FG,
    FA)."""
    L = mlp.Layout.of(model)
    return mlp.wgrad_tasks(model), L.FG, L.FA


def planes(FG: int, FA: int, rows: int, device, seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """G (FG, rows) and A (FA, rows) f32 from numpy seed ``seed``, made 64
    features at a time: G zero where u < 0.5 and 4 (u - 0.75) elsewhere, A
    zero where u < 0.5 and 2 (u - 0.5) elsewhere, each u uniform. numpy
    draws the u; the map runs on ``device`` in f32, which gives numpy's
    f32 values bit for bit and takes the host's passes over ~9 GB out of
    the set-up."""
    rng = np.random.default_rng(seed)
    out = []
    for F, lo, scale in ((FG, 0.75, 4.0), (FA, 0.5, 2.0)):
        t = torch.empty((F, rows), dtype=torch.float32, device=device)
        for f0 in range(0, F, 64):
            u = torch.from_numpy(rng.random((min(64, F - f0), rows), dtype=np.float32)).to(device)
            t[f0 : f0 + u.shape[0]] = torch.where(u < 0.5, 0.0, (u - lo) * scale)
        out.append(t)
    return out[0], out[1]


def turns_ms(fns: dict, reps: int = 5, calls: int = 1) -> dict:
    """Median CUDA-event ms of each callable, after a warm-up of each, timed
    in turns (a b c c b a a b c ...) until each ran ``reps`` times. With
    ``calls`` > 1 each timing spans that many calls back to back and is
    divided by it: the card then waits on no host work between them."""
    names = list(fns)
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {n: [] for n in names}
    order = names + names[::-1]
    for i in range(reps * len(names)):
        name = order[i % len(order)]
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(calls):
            fns[name]()
        e1.record()
        e1.synchronize()
        times[name].append(e0.elapsed_time(e1) / calls)
    return {k: float(np.median(v)) for k, v in times.items()}


def _rel(got, ref) -> float:
    """Max abs error over dW and db, over the reference's largest entry."""
    err = max((g - r).abs().max().item() for g, r in zip(got, ref) if r is not None)
    return err / max(max(r.abs().max().item() for r in ref if r is not None), 1e-30)


def work(model: NerfMLP, rows: int, dtype) -> tuple[float, float]:
    """FLOPs of the twelve sums and the bytes they must move: each plane
    read once (every workspace plane feeds a sum), the f32 results
    written once."""
    ss, FG, FA = sums(model)
    flops = sum(2.0 * s.O * s.K * rows + (s.O * rows if s.bias else 0) for s in ss)
    out_bytes = 4 * sum(s.O * s.K + (s.O if s.bias else 0) for s in ss)
    return flops, (FG + FA) * rows * torch.finfo(dtype).bits // 8 + out_bytes


def run(device, model: NerfMLP = mlp.FLAGSHIP, rows: int = ROWS) -> dict:
    """On the card, per compute type: the twelve sums in one launch
    (``weight_grads``, as the backward runs them) and as twelve
    ``weight_grad`` calls, the plain version and the library calls: ms,
    TFLOP/s, GB/s, share of the bound, the kernel's launches, its max abs
    error from the plain version, and each sum's error from float64
    (kernel and plain). Raises if the kernel is outside REL_TOL or less
    accurate than the plain version (over twice its error, plus 1e-7 of
    the largest entry)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    ss, FG, FA = sums(model)
    G32, A32 = planes(FG, FA, rows, device)
    res = {"rows": rows, "sums": [s.name for s in ss]}
    for dt in (torch.float32, torch.bfloat16):
        name = "f32" if dt == torch.float32 else "bf16"
        G, A = (G32, A32) if dt == torch.float32 else (G32.to(dt), A32.to(dt))
        pairs = [(G[s.gf : s.gf + s.O], A[s.af : s.af + s.K], s.bias) for s in ss]
        grouped = mlp.weight_grads(pairs)
        errs, single_errs, plain_errs, abs_err = {}, {}, {}, 0.0
        for s, (g, a, bias), got in zip(ss, pairs, grouped):
            one = mlp.weight_grad(g, a, bias)
            want = mlp.weight_grad_plain(g, a, dt)
            abs_err = max(abs_err, *((x - y).abs().max().item() for x, y in zip(got, want) if x is not None))
            g64, a64 = g.double(), a.double()
            ref = (g64 @ a64.T, g64.sum(1) if bias else None)
            del g64, a64
            errs[s.name], single_errs[s.name] = _rel(got, ref), _rel(one, ref)
            plain_errs[s.name] = _rel((want[0], want[1] if bias else None), ref)
            del one, want, ref
        del grouped
        torch.cuda.empty_cache()
        fns = {
            "kernel": lambda: mlp.weight_grads(pairs),
            "library": lambda: [(torch.mm(g, a.t()), g.sum(1) if bias else None) for g, a, bias in pairs],
            "single": lambda: [mlp.weight_grad(g, a, bias) for g, a, bias in pairs],
            "plain": lambda: [mlp.weight_grad_plain(g, a, dt) for g, a, _ in pairs],
        }
        before = mlp.weight_grad.launches
        fns["kernel"]()
        launches = mlp.weight_grad.launches - before
        ms = turns_ms(fns, calls=CALLS)
        flops, nbytes = work(model, rows, dt)
        b = bound_ms(flops, nbytes, dt)
        res[name] = dict(
            ms=ms["kernel"], ms_single=ms["single"], library_ms=ms["library"],
            plain_ms=ms["plain"], bound_ms=b, bound_by=bound_by(flops, nbytes, dt),
            tflops=flops / (ms["kernel"] * 1e-3) / 1e12, gb_s=nbytes / (ms["kernel"] * 1e-3) / 1e9,
            share_of_bound=b / ms["kernel"], launches=launches, max_abs_err=abs_err,
            rel_err=max(errs.values()), single_rel_err=max(single_errs.values()),
            plain_rel_err=max(plain_errs.values()), rel_err_by_sum=errs,
            plain_rel_err_by_sum=plain_errs)
        for what, e in (("one launch", errs), ("twelve launches", single_errs)):
            if max(e.values()) > REL_TOL[dt]:
                raise RuntimeError(f"{name} sums ({what}): kernel {max(e.values()):.3e} of max "
                                   f"from float64 > {REL_TOL[dt]:.0e}")
            if max(e.values()) > 2 * max(plain_errs.values()) + 1e-7:
                raise RuntimeError(f"{name} sums ({what}): kernel {max(e.values()):.3e} from "
                                   f"float64, plain {max(plain_errs.values()):.3e}: less accurate")
        del G, A, pairs
        torch.cuda.empty_cache()
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="the backward's weight-gradient sums alone")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu for a smoke test")
    args = ap.parse_args(argv)
    from nerf_simple_tpu_torch.utils.device import require_device

    device = require_device(args.device)
    if device.type == "cpu":
        ss, FG, FA = sums(mlp.FLAGSHIP)
        G, A = planes(FG, FA, 256, device)
        for s in ss:
            dW, db = mlp.weight_grad(G[s.gf : s.gf + s.O], A[s.af : s.af + s.K], s.bias)
            if dW.shape != (s.O, s.K) or not bool(torch.isfinite(dW).all()) or (db is None) == s.bias:
                raise RuntimeError(f"{s.name}: plain sums bad")
        print(f"CPU smoke test only: the plain sums ran for {len(ss)} planes at 256 rows; "
              "they time nothing on the CPU")
        return
    res = run(device)
    print(f"{torch.cuda.get_device_name(device)}: twelve sums at {res['rows']} rows")
    for name in ("f32", "bf16"):
        v = res[name]
        print(f"{name}: kernel {v['ms']:.3f} ms in one launch ({v['ms_single']:.3f} ms as twelve), "
              f"library {v['library_ms']:.3f} ms, plain {v['plain_ms']:.3f} ms; bound {v['bound_ms']:.3f} ms "
              f"({v['bound_by']}), {100 * v['share_of_bound']:.1f}% of it; {v['tflops']:.1f} TFLOP/s, "
              f"{v['gb_s']:.0f} GB/s; from float64: kernel {v['rel_err']:.2e}, plain "
              f"{v['plain_rel_err']:.2e} of max")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
