"""The input-gradient kernel alone, at the training batch: the kernel
(``kernels/mlp.py::input_grad``, csrc/input_grad.cuh) against its plain
version ``input_grad_plain`` and beside a library yardstick.

    python -m nerf_simple_tpu_torch.probes.input_grad
    python -m nerf_simple_tpu_torch.probes.input_grad --device cpu   # smoke test
    python -m nerf_simple_tpu_torch.probes.input_grad --before CSRC [CSRC ...]

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
library / library / plain / kernel ...; the kernel straight through ctypes
(``kernel_call``), so that the wrapper's host work, of the bf16 kernel's
order, is not timed with it.

What the kernel must move and compute (the bound) is
``utils/roofline.py::input_grad_work``: 640 plane rows a row in the
compute type, x and dx, and 71,424 flop a row at the flagship; bf16 is
then bound by its bytes (0.21 ms), f32 by its operations at 67 TFLOP/s
(0.56 ms). The f32 kernel runs its products on the FMA pipes (a
register-blocked product fed by cp.async, ``input_grad_fma``); the bf16
one on the tensor cores (mma.sync, ``input_grad_mma``), so that only its
bytes bound it.

``before_after`` holds the kernel of an earlier commit's csrc/ against the
current one for every instantiation (``INSTANCES``): dx bit-equal in both
types (each kernel of csrc/input_grad.cuh sums every slot in the order of
the kernel it replaced), two launches of the current one bit-equal, and
the launches of both in turns in each type. With
``--before`` the probe builds the ``fused_mlp_bwd`` and ``fused_contract``
sources of each csrc/ directory given (an earlier commit's, or a copy with
a constant changed, under a gitignored ``build/``) and runs
``before_after`` on each, in place of the runs above, and prints how many
of each earlier library's kernels build to the same SASS in the current one
(``kernels/_build.py::sass_against``; the SIMT input-gradient kernels,
SASS_REPLACED, are replaced by design). It does not fail on a SASS
difference: a variant copy differs on purpose.

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
window halved in the input gradient only. For an appearance model (dx of
16 rows, the codes' cotangents in rows 8..15) the code rows are held
against their own largest entry too, and a third planted fault halves
them.

For an appearance model (``run(device, model)`` with ``model.app_dim >
0``) x has 16 rows, a code from N(0, 0.5) in rows 8..8 + app_dim a row,
and the kernel also gives the codes' rows of dx.

Under mip (``run(device, model, mip=True)``: the kernel's mip
instantiation, the integrated encoder's transpose) x has 16 rows, the
means uniform in [-4, 4], the diagonal variances in rows 11..13
log-uniform in [1e-6, 1e-2] (so the damp exp(-0.5 4^i v) of the top
octaves runs from ~1 to ~0), and dx has 16 rows: the variance rows 11..13
are held against their own largest entry too. The window faults do not
apply (mip takes no windows); ``explain_dx`` plants two others there: the
damp dropped from the transpose (the plain chain at zero variance), and
the variance rows halved.

For a contracted model (``run_contract``: the kernel's contract
instantiation, csrc/fused_contract.cu) the positions' radii are
log-uniform in [0.1, 32] (about a third inside the unit ball), and
``explain_dx`` plants the contraction's two faults besides
(``CONTRACT_FAULTS``, ``planted``): the transpose's ``c (x . dy) x`` term
dropped, and the encoder's transpose taken at the uncontracted rows.

For a contracted model under mip (``run_mip_contract``: the kernel's
``MIP && CONTRACT`` instantiation) x has 16 rows as under mip, the means'
radii as for a contracted model (or the rows given, such as a batch of the
unbounded scene), and ``MIP_CONTRACT_FAULTS`` are planted in the warp's
coupled transpose (``transpose_mip_with``): its ``term_n`` (the variance
transform's dependence on the mean through n) dropped, its rank-one
coupling ``c^2 m2 (m2 . dv)`` of the variance rows dropped, and the angles
and damps taken at the uncontracted means and variances.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
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
# The MIP && CONTRACT kernel against plain, in either type (run_mip_contract):
# the same operands summed in f32 in another order, 7e-7 (f32) and 4e-7
# (bf16) measured at 524,288 rows on the H100; tighter than REL_TOL's bf16
# bound, so that each fault of the coupled transpose shows in bf16 too.
MIP_CONTRACT_TOL = 1e-4
MIP_ZERO_ROWS = (6, 7, 8, 9, 10, 14, 15)  # dx's rows that the mip transpose leaves zero (JAX :1068-1077)
CONTRACT_FAULTS = ("jacobian_c_dropped", "angles_uncontracted")  # the faults ``planted`` plants
MIP_CONTRACT_FAULTS = ("term_n_dropped", "coupling_dropped", "angles_uncontracted")  # and under mip


def inputs(model: NerfMLP, rows: int, device, seed: int = 0, mip: bool = False):
    """(packed f32 weights, cotangent planes (FG, Rp) f32, x (8, rows) f32;
    16 rows with an appearance model's codes or under ``mip``, its
    variances in rows 11..13) from numpy seed ``seed``."""
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
    x = np.zeros((mlp._x_rows(mip, model), rows), np.float32)
    x[:3] = rng.uniform(-4, 4, (3, rows))
    if model.contract:  # radii log-uniform in [0.1, 32]: both sides of the unit sphere
        x[:3] *= 10.0 ** rng.uniform(-1, 1.5, rows) / np.linalg.norm(x[:3], axis=0)
    d = rng.normal(size=(3, rows))
    x[3:6] = d / np.linalg.norm(d, axis=0, keepdims=True)
    x[8 : 8 + model.app_dim] = rng.normal(0, 0.5, (model.app_dim, rows))
    if mip:
        x[11:14] = 10.0 ** rng.uniform(-6, -2, (3, rows))
    wts = mlp.pack_weights(NerfField.from_jax_params(init_nerf_params(seed, model), device, model))
    return wts, gws, torch.from_numpy(x).to(device)


def kernel_call(w, x, gws, dt, model: NerfMLP, enc_w: tuple | None = None, mip: bool = False, lib=None):
    """A callable that launches the kernel as ``mlp.input_grad(w, x, gws,
    dt, model, enc_w, mip)`` does, straight through ctypes with its
    arguments made once and one dx for every call, and returns that dx: a
    timing of calls back to back then holds the kernel and none of the
    wrapper's host work (its checks and allocation), which is of the bf16
    kernel's order. ``lib``: an
    earlier commit's libraries (``{"fused_mlp_bwd": ..., "fused_contract":
    ...}``, their input-gradient entries bound) instead of the current
    ones; without it the wrapper runs once first (its checks, the contract
    library's link). The wrapper counts none of these launches; the
    library does."""
    if lib is None:
        mlp.input_grad(w, x, gws, dt, model, enc_w, mip)
        entry = mlp._lib("fused_mlp_bwd").input_grad
    else:
        entry = lib["fused_contract"].fused_contract_input_grad if model.contract else lib["fused_mlp_bwd"].input_grad
    wx, wd = mlp._enc_w_ptrs(enc_w, model, x.device, mip)
    dx = torch.empty((mlp._x_rows(mip, model), x.shape[1]), dtype=torch.float32, device=x.device)
    args = (gws.data_ptr(), x.data_ptr(), x.shape[1], model.Lp, model.Ld, model.H, int(dt == torch.bfloat16),
            mlp._CPtrs(*mlp._ptrs(w)), wx, wd, dx.data_ptr(), mlp._app(model), int(mip))
    args += (mlp._stream(x),) if lib is not None and model.contract else (int(model.contract), mlp._stream(x))

    def call() -> torch.Tensor:
        mlp._raise_on(entry(*args), "input_grad")
        return dx

    call.keep = (w, x, gws, enc_w)  # alive while the callable is
    return call


def library(wts, x, gws, dt, model: NerfMLP, mip: bool = False) -> torch.Tensor:
    """The yardstick: torch.mm in ``dt`` for the three products, the
    transpose's tail in torch (the integrated encoder's under ``mip``)."""
    L, rows = mlp.Layout.of(model), x.shape[1]
    g = gws[:, :rows]
    gx = (torch.mm(wts.W1.T, g[L.gh(0) : L.gh(0) + L.H]).float()
          + torch.mm(wts.Wsx.T, g[L.gh(5) : L.gh(5) + L.H]).float())
    gd = torch.mm(wts.Wcd.T, g[L.gcs : L.gcs + L.H // 2]).float()
    return mlp._encode_transpose(x, gx, gd, model, mip)


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


def transpose_mip_with(xyz, var, dy, dvo, fault: str | None = None):
    """``mlp._contract_transpose_mip`` written out again, with one of its
    terms dropped: ``term_n_dropped`` leaves out ``term_n x`` from
    d/d(mean), ``coupling_dropped`` the rank-one ``c^2 m2 (m2 . dvo)`` from
    d/d(variance); with ``fault`` None it is the plain version's (a test
    holds the two equal)."""
    g, c = mlp._contract_scales(xyz)
    n = torch.sqrt(torch.clamp(xyz[0:1] ** 2 + xyz[1:2] ** 2 + xyz[2:3] ** 2, min=1e-20))
    cp = torch.where(n <= 1.0, 0.0, 6.0 / n**4 - 8.0 / n**5)
    gp = c * n
    m2 = xyz**2
    m2v, Cv = (m2 * var).sum(0, keepdim=True), (m2 * dvo).sum(0, keepdim=True)
    A, Bv = (dvo * var).sum(0, keepdim=True), (dvo * m2 * var).sum(0, keepdim=True)
    dv = (g**2 + 2.0 * g * c * m2) * dvo + (fault != "coupling_dropped") * c**2 * m2 * Cv
    term_n = (2.0 * g * gp * A + 2.0 * (gp * c + g * cp) * Bv + 2.0 * c * cp * m2v * Cv) / n
    dmean = (g * dy + c * (xyz * dy).sum(0, keepdim=True) * xyz + (fault != "term_n_dropped") * term_n * xyz
             + (4.0 * g * c * var + 2.0 * c**2 * m2v) * xyz * dvo + 2.0 * c**2 * var * xyz * Cv)
    return dmean, dv


@contextlib.contextmanager
def planted(fault: str):
    """One of CONTRACT_FAULTS or MIP_CONTRACT_FAULTS planted in the plain
    input gradient of a contracted model: ``jacobian_c_dropped`` leaves the
    contraction's transpose at ``g dy`` (its ``c (x . dy) x`` term dropped);
    ``angles_uncontracted`` takes the encoder's transpose at the
    uncontracted rows (under mip the damps at the unwarped variances too;
    the forward's plain version is patched as well, so plant it only around
    ``input_grad_plain`` on planes made before); ``term_n_dropped`` and
    ``coupling_dropped`` drop a term of the warp's coupled transpose under
    mip (``transpose_mip_with``)."""
    contract, transpose, transpose_mip = mlp._contract, mlp._contract_transpose, mlp._contract_transpose_mip
    if fault == "jacobian_c_dropped":
        mlp._contract_transpose = lambda xyz, dy: mlp._contract_scales(xyz)[0] * dy
    elif fault == "angles_uncontracted":
        mlp._contract = lambda xyz, var: (xyz, var)
    elif fault in ("term_n_dropped", "coupling_dropped"):
        mlp._contract_transpose_mip = functools.partial(transpose_mip_with, fault=fault)
    else:
        raise ValueError(f"no planted fault {fault!r}; the faults are {CONTRACT_FAULTS + MIP_CONTRACT_FAULTS}")
    try:
        yield
    finally:
        mlp._contract, mlp._contract_transpose, mlp._contract_transpose_mip = contract, transpose, transpose_mip


def row_err(dx: torch.Tensor, want: torch.Tensor, mip: bool = False) -> torch.Tensor:
    """(rows,) the error of each row of ``dx`` (8 or 16, rows) against
    ``want``: the largest of max |diff| over the position rows 0..2 by max
    |want[0:3]|, over the direction rows 3..5 by max |want[3:6]| and, for
    an appearance model, over the code rows 8..15 by max |want[8:16]| (under
    ``mip``, over the variance rows 11..13 by max |want[11:14]|). The
    direction's gradient runs ~2^(Lp - Ld) below the position's, so one
    scale for all would hide an error in it."""
    d = (dx - want).abs()
    parts = [(0, 3), (3, 6)] + ([(11, 14)] if mip else [(8, 16)] if dx.shape[0] == 16 else [])
    return torch.stack([d[a:b].amax(0) / want[a:b].abs().max().clamp_min(1e-30) for a, b in parts]).amax(0)


def explain_dx(wts, x, g, dx, dx_plain, dt, model: NerfMLP, enc_w: tuple | None = None,
               tol: float | None = None, mip: bool = False) -> dict:
    """B2's ``dx`` (8, rows; 16 for an appearance model) against the plain
    chain's ``dx_plain`` for the same weights ``wts`` (cast to ``dt``),
    inputs ``x`` (8 or 16, rows), output
    cotangents ``g`` (8, rows) and windows ``enc_w``: ``n_past`` rows
    whose ``row_err`` exceeds ``tol`` (default REL_TOL; ``share`` of the
    rows); ``n_flipped`` rows where a relu mask of the forward kernel's
    residual planes (what B2 recomputes) differs from the plain chain's;
    ``n_unexplained`` rows past with no flipped mask; ``own_masks_err``,
    the largest ``row_err`` of dx against the plain chain on the kernel's
    planes. ``faults``: for each planted fault (``_fault_windows``; for an
    appearance model also the code rows halved; under ``mip`` (x and dx of
    16 rows, no windows) instead the damp dropped from the transpose and
    the variance rows halved; for a contracted model also CONTRACT_FAULTS,
    under mip MIP_CONTRACT_FAULTS)
    its ``share`` and ``n_unexplained`` against ``dx_plain``."""
    tol = REL_TOL[dt] if tol is None else tol
    rows = x.shape[1]
    past = row_err(dx, dx_plain, mip) > tol
    _, res = mlp.forward_residuals(wts, x, dt, model, mip, enc_w)
    _, res_plain = mlp.forward_residuals_plain(wts, x, dt, model, mip, enc_w)
    flipped = mask_flips(res, res_plain, model, rows)
    own = mlp.input_grad_plain(wts, x, mlp.backward_tile_plain(wts, res.float(), g, dt, model), dt, model, enc_w,
                               mip)
    del res
    out = dict(n_past=int(past.sum()), share=past.float().mean().item(), n_flipped=int(flipped.sum()),
               n_unexplained=int((past & ~flipped).sum()),
               own_masks_err=row_err(dx, own, mip).max().item(), rows=rows, tol=tol, faults={})
    del own
    gws = mlp.backward_tile_plain(wts, res_plain, g, dt, model)
    del res_plain
    if mip:
        faults = [("damp_dropped", None), ("variance_rows_half", None)]
    else:
        faults = [("posx_top_octave_half", 0), ("posd_low_octave_half", 1)]
        faults += [("code_rows_half", None)] if model.app_dim > 0 else []
    if model.contract:
        faults += [(name, "contract") for name in (MIP_CONTRACT_FAULTS if mip else CONTRACT_FAULTS)]
    for name, branch in faults:
        if branch == "contract":
            with planted(name):
                bad = mlp.input_grad_plain(wts, x, gws, dt, model, enc_w, mip)
        elif name == "damp_dropped":  # the transpose at zero variance: no damp on either chain
            x0 = x.clone()
            x0[11:14] = 0.0
            bad = mlp.input_grad_plain(wts, x0, gws, dt, model, mip=True)
            del x0
        elif branch is None:  # the variance rows (mip) or the code rows halved
            bad = mlp.input_grad_plain(wts, x, gws, dt, model, enc_w, mip)
            lo, hi = (11, 14) if mip else (8, 16)
            bad[lo:hi] *= 0.5
        else:
            bad = mlp.input_grad_plain(wts, x, gws, dt, model, _fault_windows(model, enc_w, branch, x.device))
        fpast = row_err(bad, dx_plain, mip) > tol
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
                                    rows_6_7_zero=bool((got[6:8] == 0).all()))
            if model.app_dim > 0:  # the codes' rows against their own largest entry
                out[name + case]["code_rel_err"] = ((got[8:] - want[8:]).abs().max() / want[8:].abs().max()).item()
            if (max(err, out[name + case].get("code_rel_err", 0.0)) > REL_TOL[dt]
                    or not out[name + case]["rows_6_7_zero"]):
                raise RuntimeError(f"{name}{case} input gradient: kernel {err:.3e} of max |dx| from plain (code rows "
                                   f"{out[name + case].get('code_rel_err')}) > {REL_TOL[dt]:.0e}, or rows 6..7 not "
                                   "zero")
            del got, want
        ms = turns_ms({"kernel": kernel_call(w, x, gws, dt, model),
                       "plain": lambda: mlp.input_grad_plain(w, x, gws, dt, model),
                       "library": lambda: library(w, x, gws, dt, model)}, calls=CALLS)
        ms_anneal = turns_ms({"kernel": kernel_call(w, x, gws, dt, model, enc_w)}, calls=CALLS)["kernel"]
        flops, nbytes = input_grad_work(model, rows, dt)
        b = bound_ms(flops, nbytes, dt)
        out[name].update(ms=ms["kernel"], plain_ms=ms["plain"], library_ms=ms["library"], ms_anneal=ms_anneal,
                         bound_ms=b, bound_by=bound_by(flops, nbytes, dt), share_of_bound=b / ms["kernel"],
                         gb_s=nbytes / (ms["kernel"] * 1e-3) / 1e9, tflops=flops / (ms["kernel"] * 1e-3) / 1e12)
        del gws
        torch.cuda.empty_cache()
    return out


def run_mip(device, model: NerfMLP = mlp.FLAGSHIP, rows: int = ROWS) -> dict:
    """On the card, per compute type: the kernel's mip instantiation on the
    probe's mip inputs against the plain version (``row_err`` by row group,
    the rows that must be zero exactly zero), the two planted faults
    (``damp_dropped``, ``variance_rows_half``) against plain by the same
    measure, which must exceed REL_TOL; then, in turns, the kernel with mip,
    the point kernel on the same planes and x's first eight rows, the plain
    version and the library yardstick: ms of each, the bound and its share.
    Raises if a check fails."""
    torch.backends.cuda.matmul.allow_tf32 = False
    wts, gws32, x = inputs(model, rows, device, mip=True)
    x8 = x[:8].contiguous()
    out = {"rows": rows}
    for dt in (torch.float32, torch.bfloat16):
        name = "f32" if dt == torch.float32 else "bf16"
        w = mlp._cast_weights(wts, dt)
        gws = gws32 if dt == torch.float32 else gws32.to(dt)
        before = (mlp.input_grad.mip_launches, mlp.input_grad_mip_launches())
        got = mlp.input_grad(w, x, gws, dt, model, mip=True)
        launches = (mlp.input_grad.mip_launches - before[0], mlp.input_grad_mip_launches() - before[1])
        want = mlp.input_grad_plain(w, x, gws, dt, model, mip=True)
        err = row_err(got, want, mip=True).max().item()
        x0 = x.clone()
        x0[11:14] = 0.0
        faults = {"damp_dropped": mlp.input_grad_plain(w, x0, gws, dt, model, mip=True)}
        del x0
        faults["variance_rows_half"] = want.clone()
        faults["variance_rows_half"][11:14] *= 0.5
        fault_err = {k: row_err(v, want, mip=True).max().item() for k, v in faults.items()}
        del faults
        st = dict(rel_err=err, max_abs_err=(got - want).abs().max().item(), max_abs_dx=want.abs().max().item(),
                  var_rel_err=((got[11:14] - want[11:14]).abs().max() / want[11:14].abs().max()).item(),
                  launches=launches[0], launches_in_c=launches[1], fault_err=fault_err,
                  zero_rows_zero=bool((got[list(MIP_ZERO_ROWS)] == 0).all()))
        del got, want
        if (err > REL_TOL[dt] or not st["zero_rows_zero"] or launches != (1, 1)
                or min(fault_err.values()) <= REL_TOL[dt]):
            raise RuntimeError(f"{name} mip input gradient: {st}")
        ms = turns_ms({"kernel": kernel_call(w, x, gws, dt, model, mip=True),
                       "point": kernel_call(w, x8, gws, dt, model),
                       "plain": lambda: mlp.input_grad_plain(w, x, gws, dt, model, mip=True),
                       "library": lambda: library(w, x, gws, dt, model, mip=True)}, calls=CALLS)
        flops, nbytes = input_grad_work(model, rows, dt, mip=True)
        b = bound_ms(flops, nbytes, dt)
        st.update(ms=ms["kernel"], point_ms=ms["point"], plain_ms=ms["plain"], library_ms=ms["library"],
                  bound_ms=b, bound_by=bound_by(flops, nbytes, dt), share_of_bound=b / ms["kernel"],
                  gb_s=nbytes / (ms["kernel"] * 1e-3) / 1e9, flops=flops, bytes=nbytes)
        out[name] = st
        del gws
        torch.cuda.empty_cache()
    return out


def run_contract(device, model: NerfMLP = mlp.FLAGSHIP, rows: int = ROWS) -> dict:
    """On the card, per compute type: the kernel's contract instantiation
    (csrc/fused_contract.cu) on a contracted ``model``'s probe inputs (radii
    on both sides of the unit sphere) against the plain version
    (``row_err``), bit-equal to the kernel without contract on the rows
    inside the ball; CONTRACT_FAULTS planted in the plain version, which
    must be past REL_TOL; then, in turns, the contract kernel, the kernel
    without contract on the same planes and x, the plain version and the
    library yardstick: ms of each, the bound and its share. Raises if a
    check fails."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cm, pm = dataclasses.replace(model, contract=True), dataclasses.replace(model, contract=False)
    wts, gws32, x = inputs(cm, rows, device)
    inside = x[:3].norm(dim=0) <= 1.0
    out = {"rows": rows, "inside_rows": int(inside.sum())}
    for dt in (torch.float32, torch.bfloat16):
        name = "f32" if dt == torch.float32 else "bf16"
        w = mlp._cast_weights(wts, dt)
        gws = gws32 if dt == torch.float32 else gws32.to(dt)
        before = (mlp.input_grad.contract_launches, mlp.input_grad_contract_launches())
        got = mlp.input_grad(w, x, gws, dt, cm)
        launches = (mlp.input_grad.contract_launches - before[0], mlp.input_grad_contract_launches() - before[1])
        want = mlp.input_grad_plain(w, x, gws, dt, cm)
        err = row_err(got, want).max().item()
        fault_err = {}
        for fault in CONTRACT_FAULTS:
            with planted(fault):
                fault_err[fault] = row_err(mlp.input_grad_plain(w, x, gws, dt, cm), want).max().item()
        unc = mlp.input_grad(w, x, gws, dt, pm)
        st = dict(rel_err=err, max_abs_err=(got - want).abs().max().item(), max_abs_dx=want.abs().max().item(),
                  launches=launches[0], launches_in_c=launches[1], fault_err=fault_err,
                  inside_bit_equal=torch.equal(got[:, inside], unc[:, inside]),
                  rows_6_7_zero=bool((got[6:8] == 0).all()))
        del got, want, unc
        if (err > REL_TOL[dt] or not st["rows_6_7_zero"] or not st["inside_bit_equal"] or launches != (1, 1)
                or min(fault_err.values()) <= REL_TOL[dt]):
            raise RuntimeError(f"{name} contract input gradient: {st}")
        ms = turns_ms({"kernel": kernel_call(w, x, gws, dt, cm),
                       "point": kernel_call(w, x, gws, dt, pm),
                       "plain": lambda: mlp.input_grad_plain(w, x, gws, dt, cm),
                       "library": lambda: library(w, x, gws, dt, cm)}, calls=CALLS)
        flops, nbytes = input_grad_work(cm, rows, dt)
        b = bound_ms(flops, nbytes, dt)
        st.update(ms=ms["kernel"], point_ms=ms["point"], plain_ms=ms["plain"], library_ms=ms["library"],
                  bound_ms=b, bound_by=bound_by(flops, nbytes, dt), share_of_bound=b / ms["kernel"],
                  gb_s=nbytes / (ms["kernel"] * 1e-3) / 1e9, flops=flops, bytes=nbytes)
        out[name] = st
        del gws
        torch.cuda.empty_cache()
    return out


def run_mip_contract(device, model: NerfMLP = mlp.FLAGSHIP, rows: int = ROWS, x: torch.Tensor | None = None) -> dict:
    """On the card, per compute type: the kernel's ``MIP && CONTRACT``
    instantiation (csrc/fused_contract.cu) on a contracted ``model``'s
    probe mip inputs (or on the (16, rows) ``x`` given) against the plain
    version (``row_err`` by row group, the rows that must be zero exactly
    zero), counted by the wrapper and in C; bit-equal to the ``MIP`` kernel
    on the rows inside the unit ball; MIP_CONTRACT_FAULTS planted in the
    plain version, which must be past MIP_CONTRACT_TOL, as the kernel must
    be within it; then, in turns, the kernel,
    the ``MIP`` kernel on the same planes and x, the plain version and the
    library yardstick: ms of each, the bound and its share. Raises if a
    check fails."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cm, pm = dataclasses.replace(model, contract=True), dataclasses.replace(model, contract=False)
    wts, gws32, xp = inputs(cm, rows, device, mip=True)
    x = xp if x is None else x
    del xp
    inside = x[:3].norm(dim=0) <= 1.0
    out = {"rows": rows, "inside_rows": int(inside.sum())}
    for dt in (torch.float32, torch.bfloat16):
        name = "f32" if dt == torch.float32 else "bf16"
        w = mlp._cast_weights(wts, dt)
        gws = gws32 if dt == torch.float32 else gws32.to(dt)
        counts = (lambda: (mlp.input_grad.mip_launches, mlp.input_grad.contract_launches,
                           mlp.input_grad_mip_contract_launches(), mlp.input_grad_contract_launches()))
        before = counts()
        got = mlp.input_grad(w, x, gws, dt, cm, mip=True)
        launches = tuple(a - b for a, b in zip(counts(), before))
        want = mlp.input_grad_plain(w, x, gws, dt, cm, mip=True)
        err = row_err(got, want, mip=True).max().item()
        fault_err = {}
        for fault in MIP_CONTRACT_FAULTS:
            with planted(fault):
                fault_err[fault] = row_err(mlp.input_grad_plain(w, x, gws, dt, cm, mip=True), want, mip=True).max().item()
        unc = mlp.input_grad(w, x, gws, dt, pm, mip=True)
        st = dict(rel_err=err, max_abs_err=(got - want).abs().max().item(), max_abs_dx=want.abs().max().item(),
                  var_rel_err=((got[11:14] - want[11:14]).abs().max() / want[11:14].abs().max()).item(),
                  launches=launches[0], launches_in_c=launches[2], fault_err=fault_err,
                  inside_bit_equal=torch.equal(got[:, inside], unc[:, inside]),
                  zero_rows_zero=bool((got[list(MIP_ZERO_ROWS)] == 0).all()))
        del got, want, unc
        if (err > MIP_CONTRACT_TOL or not st["zero_rows_zero"] or not st["inside_bit_equal"]
                or launches != (1, 1, 1, 1) or min(fault_err.values()) <= MIP_CONTRACT_TOL):
            raise RuntimeError(f"{name} mip + contract input gradient: {st}")
        ms = turns_ms({"kernel": kernel_call(w, x, gws, dt, cm, mip=True),
                       "mip": kernel_call(w, x, gws, dt, pm, mip=True),
                       "plain": lambda: mlp.input_grad_plain(w, x, gws, dt, cm, mip=True),
                       "library": lambda: library(w, x, gws, dt, cm, mip=True)}, calls=CALLS)
        flops, nbytes = input_grad_work(cm, rows, dt, mip=True)
        b = bound_ms(flops, nbytes, dt)
        st.update(ms=ms["kernel"], mip_ms=ms["mip"], plain_ms=ms["plain"], library_ms=ms["library"],
                  bound_ms=b, bound_by=bound_by(flops, nbytes, dt), share_of_bound=b / ms["kernel"],
                  gb_s=nbytes / (ms["kernel"] * 1e-3) / 1e9, flops=flops, bytes=nbytes)
        out[name] = st
        del gws
        torch.cuda.empty_cache()
    return out


# The earlier kernels that the current libraries replace by design: the
# instantiations of the input-gradient kernel's SIMT version, whose work the
# tensor-core kernel input_grad_mma (bf16) and the register-blocked
# input_grad_fma (f32) of csrc/input_grad.cuh do.
SASS_REPLACED = ("input_grad_kernel",)


def sass_line(sass: dict) -> str:
    """``kernels/_build.py::sass_against``'s result as one line."""
    return "SASS against the earlier libraries, kernel by kernel: " + "; ".join(
        f"{src} {v['identical']} of the earlier {v['earlier']} identical"
        + (f" ({v['replaced']} SIMT input-gradient kernels replaced)" if v["replaced"] else "")
        + f", {len(v['new'])} new" + (f", differ: {v['differ']}" if v["differ"] else "")
        for src, v in sass.items())


# The kernel's instantiations by case: (app_dim, mip, contract). The
# contract ones are built into csrc/fused_contract.cu's library.
INSTANCES = {"point": (0, False, False), "codes": (8, False, False), "mip": (0, True, False),
             "contract": (0, False, True), "contract_codes": (8, False, True), "mip_contract": (0, True, True)}


def before_after(device, libs: dict, rows: int = ROWS, model: NerfMLP = mlp.FLAGSHIP) -> dict:
    """On the card, for each instantiation (INSTANCES) on the probe's inputs
    at ``rows``, in f32 and in bf16: an earlier commit's kernel (``libs``:
    its ``fused_mlp_bwd`` and ``fused_contract`` libraries, built from its
    csrc/) against the current one. dx must be the earlier's to the bit
    (``err``: how far a copy that sums in another order lies from it, by
    row group, ``row_err``), and two launches of the current kernel must
    give the same bits. Then the launches of both in turns (earlier,
    current, current, earlier, ...; CALLS calls back to back a timing) and
    the torch.mm yardstick, with the bound and each kernel's share of it.
    Raises if a check fails."""
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = {"fused_mlp_bwd": mlp._bind(libs["fused_mlp_bwd"], "fused_mlp_bwd", ("input_grad",)),
            "fused_contract": mlp._bind(libs["fused_contract"], "fused_contract", ("fused_contract_input_grad",))}
    out = {"rows": rows}
    for case, (app_dim, mip, contract) in INSTANCES.items():
        m = dataclasses.replace(model, app_dim=app_dim, contract=contract)
        wts, gws32, x = inputs(m, rows, device, mip=mip)
        out[case] = {}
        for dt in (torch.float32, torch.bfloat16):
            w = mlp._cast_weights(wts, dt)
            gws = gws32 if dt == torch.float32 else gws32.to(dt)
            cur = mlp.input_grad(w, x, gws, dt, m, mip=mip)
            old = kernel_call(w, x, gws, dt, m, mip=mip, lib=libs)()
            st = dict(err=row_err(cur, old, mip).max().item(), bit_equal=torch.equal(cur, old),
                      twice_bit_equal=torch.equal(cur, mlp.input_grad(w, x, gws, dt, m, mip=mip)))
            del cur, old
            ms = turns_ms({"earlier": kernel_call(w, x, gws, dt, m, mip=mip, lib=libs),
                           "current": kernel_call(w, x, gws, dt, m, mip=mip),
                           "library": lambda: library(w, x, gws, dt, m, mip)}, calls=CALLS)
            flops, nbytes = input_grad_work(m, rows, dt, mip=mip)
            b = bound_ms(flops, nbytes, dt)
            st.update(ms=ms["current"], earlier_ms=ms["earlier"], library_ms=ms["library"], bound_ms=b,
                      bound_by=bound_by(flops, nbytes, dt), share_of_bound=b / ms["current"],
                      earlier_share_of_bound=b / ms["earlier"], gb_s=nbytes / (ms["current"] * 1e-3) / 1e9)
            out[case]["f32" if dt == torch.float32 else "bf16"] = st
            del gws
            if not (st["twice_bit_equal"] and st["bit_equal"]):
                raise RuntimeError(f"{case} {dt} input gradient against the earlier kernel: {st}")
        del wts, gws32, x
        torch.cuda.empty_cache()
    return out


def before_after_line(ba: dict) -> str:
    """``before_after``'s result as one line a type: each instantiation's
    earlier and current ms, their shares of the bound, the yardstick and
    the distance of dx from the earlier's."""
    cases = [c for c in ba if c in INSTANCES]
    return "\n".join(
        f"before/after {name} input gradient at {ba['rows']} rows, earlier and current in turns: " + "; ".join(
            f"{case} {v['earlier_ms']:.3f} -> {v['ms']:.3f} ms ({100 * v['earlier_share_of_bound']:.1f}% -> "
            f"{100 * v['share_of_bound']:.1f}% of its {v['bound_ms']:.3f} ms bound; torch.mm yardstick "
            f"{v['library_ms']:.3f} ms; dx {v['err']:.1e} from the earlier's by row group, bit-equal "
            f"{v['bit_equal']})" for case in cases for v in [ba[case][name]])
        for name in ("f32", "bf16"))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="the input-gradient kernel alone")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu for a smoke test")
    ap.add_argument("--before", nargs="+", metavar="CSRC", help="csrc/ directories of an earlier commit or of "
                    "variants: each one's kernel beside the current one, every instantiation in turns")
    args = ap.parse_args(argv)
    from nerf_simple_tpu_torch.utils.device import require_device

    device = require_device(args.device)
    if args.before:
        if device.type != "cuda":
            raise RuntimeError("--before builds and times kernels: it runs on the card only")
        from nerf_simple_tpu_torch.kernels import _build

        sources = ["fused_mlp_bwd", "fused_contract"]
        _build.build(*sources)
        copies = _build.build_copies(args.before, sources)
        out = {d: before_after(device, copies[d]) for d in args.before}
        print(f"{torch.cuda.get_device_name(device)}: the input gradient at {ROWS} rows, each copy and the "
              "current kernel in turns")
        for d, ba in out.items():
            ba["sass"] = _build.sass_against(d, sources, SASS_REPLACED)
            print(f"{d}:\n{before_after_line(ba)}\n{sass_line(ba['sass'])}")
        print(json.dumps(out))
        return
    if device.type == "cpu":
        model = mlp.FLAGSHIP
        wts, gws, x = inputs(model, 256, device)
        _, _, xm = inputs(model, 256, device, mip=True)
        cm = NerfMLP(contract=True)
        _, _, xc = inputs(cm, 256, device)
        _, _, xcm = inputs(cm, 256, device, mip=True)
        for dt in (torch.float32, torch.bfloat16):
            got = mlp.input_grad(wts, x, gws.to(dt), dt, model, mlp.anneal_row_weights(model, ALPHA))
            mip = mlp.input_grad(wts, xm, gws.to(dt), dt, model, mip=True)
            con = mlp.input_grad(wts, xc, gws.to(dt), dt, cm)
            cmip = mlp.input_grad(wts, xcm, gws.to(dt), dt, cm, mip=True)
            if (got.shape != (8, 256) or mip.shape != (16, 256) or con.shape != (8, 256) or cmip.shape != (16, 256)
                    or not all(bool(torch.isfinite(t).all()) for t in (got, mip, con, cmip))):
                raise RuntimeError(f"{dt}: plain input gradient bad")
        print("CPU smoke test only: the plain input gradient (point, mip, contract, mip + contract) ran at 256 "
              "rows; it times nothing on the CPU")
        return
    res = run(device)
    res["mip"] = run_mip(device)
    res["contract"] = run_contract(device)
    res["mip_contract"] = run_mip_contract(device)
    print(f"{torch.cuda.get_device_name(device)}: input gradient at {res['rows']} rows")
    for name in ("f32", "bf16"):
        v = res[name]
        print(f"{name}: kernel {v['ms']:.3f} ms (windows {v['ms_anneal']:.3f}), plain {v['plain_ms']:.3f} ms, "
              f"library {v['library_ms']:.3f} ms; bound {v['bound_ms']:.3f} ms ({v['bound_by']}), "
              f"{100 * v['share_of_bound']:.1f}% of it; from plain {v['rel_err']:.2e} of max |dx| "
              f"(windows {res[name + '_anneal']['rel_err']:.2e})")
        v = res["mip"][name]
        print(f"{name} mip: kernel {v['ms']:.3f} ms (point {v['point_ms']:.3f}), plain {v['plain_ms']:.3f} ms, library "
              f"{v['library_ms']:.3f} ms; bound {v['bound_ms']:.3f} ms ({v['bound_by']}), "
              f"{100 * v['share_of_bound']:.1f}% of it; from plain {v['rel_err']:.2e} by row group")
        v = res["contract"][name]
        print(f"{name} contract: kernel {v['ms']:.3f} ms (without contract {v['point_ms']:.3f}), plain "
              f"{v['plain_ms']:.3f} ms, library {v['library_ms']:.3f} ms; bound {v['bound_ms']:.3f} ms "
              f"({v['bound_by']}), {100 * v['share_of_bound']:.1f}% of it; from plain {v['rel_err']:.2e} by row group")
        v = res["mip_contract"][name]
        print(f"{name} mip + contract: kernel {v['ms']:.3f} ms (mip without contract {v['mip_ms']:.3f}), plain "
              f"{v['plain_ms']:.3f} ms, library {v['library_ms']:.3f} ms; bound {v['bound_ms']:.3f} ms "
              f"({v['bound_by']}), {100 * v['share_of_bound']:.1f}% of it; from plain {v['rel_err']:.2e} by row group")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
