"""The fused NeRF MLP kernels: hand-written CUDA kernels and their plain
PyTorch versions.

Port of nerf_simple_tpu/kernels/mlp.py, point variant:

- ``fused_mlp_forward`` (csrc/fused_mlp_fwd.cu): the MLP forward;
- ``fused_mlp_backward`` (csrc/fused_mlp_bwd.cu): the weight gradients
  for per-sample output cotangents (the TPU ``_fused_mlp_bwd``);
- ``fused_mlp``: a ``torch.autograd.Function`` whose forward is the first
  and whose backward is the second;
- ``fused_train_step`` (csrc/fused_train_step.cu): forward, compositing,
  the MSE loss and the full backward of one batch of whole rays.

Each source's header says what bounds it on the card and how it is laid
out; the tile kernels they share are in ``csrc/mlp_tile.cuh``.

Layout, kept from the JAX package so the two can be compared field by
field: activations are feature-major ``(features, rows)``; the caller
passes ``xT (8, rows)`` (rows 0..2 sample xyz, 3..5 unit view dir) and
gets ``(8, rows)`` back (raw rgb rows 0..2, raw sigma row 3, zeros 4..7).
``pack_weights`` permutes the first-layer columns into 8-aligned raw /
sin / cos blocks, splits the skip and colour concats into two matrices
each, and folds the reference's no-activation feature layer into the
colour head: ``Wcf (Wf h + bf) == (Wcf Wf) h + Wcf bf`` exactly, so
``Wcs = [Wcf·Wf ; Wsigma ; 0]`` replaces two matmuls by one.

Dispatch: each wrapper runs the plain version for a CPU tensor and
launches its kernel for a CUDA tensor, or raises. It never falls back
from one to the other. Each counts its launches in ``<wrapper>.launches``.

Gradients come out in the packed layout; ``pack_weights(field,
differentiable=True)`` records the pack, so ``torch.autograd.backward(packed, packed_grads)``
takes them to the field's parameters (the transposes of the column
permutation and of the feature-layer fold), as ``jax.vjp(pack_weights)``
does in the JAX package.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from nerf_simple_tpu_torch.kernels import _build
from nerf_simple_tpu_torch.models.nerf import NerfField, NerfMLP, require_ported

FLAGSHIP = NerfMLP()
_MAX_H = 256  # widest layer the kernel's shared-memory plan holds


def supported(model) -> bool:
    """Can the fused kernel run this architecture? NerfMLP only, with
    8-aligned widths (H % 16 == 0, H >= 16) and L >= 1 (the JAX rule)."""
    if not isinstance(model, NerfMLP):
        return False
    if not 0 <= model.app_dim <= 8:
        return False
    return model.H % 16 == 0 and model.H >= 16 and model.Lp >= 1 and model.Ld >= 1


def _ceil8(n: int) -> int:
    return -(-n // 8) * 8


def _sin_block(L: int) -> int:
    """Rows in the 8-aligned sin block: 3 channels x L frequencies."""
    return _ceil8(3 * L)


def _enc_rows(L: int) -> int:
    """Encoded rows: 8 raw + sin block + cos block."""
    return 8 + 2 * _sin_block(L)


def _perm(L: int) -> np.ndarray:
    """Kernel row -> reference encoded-feature index. Reference layout
    (utils/xyz.py:33): 0..2 raw; 3 + 2Lc + 2i = sin(2^i ch_c), +1 = cos.
    Kernel layout: 0..2 raw; 8 + Lc + i = sin; 8 + sb + Lc + i = cos."""
    sb = _sin_block(L)
    perm = np.zeros(_enc_rows(L), np.int64)
    perm[0:3] = [0, 1, 2]
    for c in range(3):
        for i in range(L):
            perm[8 + L * c + i] = 3 + 2 * L * c + 2 * i
            perm[8 + sb + L * c + i] = 3 + 2 * L * c + 2 * i + 1
    return perm


def _valid(L: int) -> np.ndarray:
    """1 on kernel rows that carry a real feature, 0 on pad rows."""
    sb = _sin_block(L)
    v = np.zeros(_enc_rows(L), np.float32)
    v[0:3] = 1
    v[8 : 8 + 3 * L] = 1
    v[8 + sb : 8 + sb + 3 * L] = 1
    return v


class FusedWeights(NamedTuple):
    """Kernel-layout weights, (out_features, in_features); biases
    (out_features, 1) f32. Field order is the CUDA struct's."""

    W1: torch.Tensor  # (H, FX) trunk0, columns permuted and padded
    b1: torch.Tensor
    Wt1: torch.Tensor  # (H, H) x4 trunk1..4
    bt1: torch.Tensor
    Wt2: torch.Tensor
    bt2: torch.Tensor
    Wt3: torch.Tensor
    bt3: torch.Tensor
    Wt4: torch.Tensor
    bt4: torch.Tensor
    Wsh: torch.Tensor  # (H, H) skip, h half
    Wsx: torch.Tensor  # (H, FX) skip, posx half
    bs: torch.Tensor
    Wp0: torch.Tensor  # (H, H)
    bp0: torch.Tensor
    Wp1: torch.Tensor  # (H, H)
    bp1: torch.Tensor
    Wcs: torch.Tensor  # (H//2 + 8, H): Wcf·Wfeature rows, then sigma, then 7 zero rows
    bcs: torch.Tensor  # (H//2 + 8, 1): Wcf·b_feature + b_color0 ; b_sigma ; 0
    Wcd: torch.Tensor  # (H//2, FD) color0, posd half
    Wc1: torch.Tensor  # (8, H//2) color1: rgb rows 0..2, zero rows 3..7
    bc1: torch.Tensor


def pack_weights(field: NerfField, differentiable: bool = False) -> FusedWeights:
    """Repack the field's layers into the kernel layout, f32, on the
    field's device. The feature-layer fold is computed in float64 and
    rounded once. With ``differentiable`` (and gradients enabled) the
    result carries autograd history back to the field's parameters."""
    if not differentiable:
        with torch.no_grad():
            return pack_weights(field, differentiable=True)
    model = field.model
    if not supported(model):
        raise ValueError(f"fused kernel needs H % 16 == 0, H >= 16; got {model}")
    H, Cd = model.H, model.in_Cd
    dev = field.trunk0.weight.device
    w = {n: getattr(field, n).weight.double() for n in (
        "trunk0", "trunk1", "trunk2", "trunk3", "trunk4", "skip", "post0",
        "post1", "sigma", "feature", "color0", "color1")}
    b = {n: getattr(field, n).bias.double() for n in w}

    def perm_pad(m, L):  # (out, C) reference columns -> (out, F) kernel columns
        valid = torch.from_numpy(_valid(L)).to(dev, torch.float64)
        return m[:, torch.from_numpy(_perm(L)).to(dev)] * valid

    def col(v):
        return v[:, None]

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float64, device=dev)

    Wcf = w["color0"][:, :H]
    fields = dict(
        W1=perm_pad(w["trunk0"], model.Lp), b1=col(b["trunk0"]),
        Wt1=w["trunk1"], bt1=col(b["trunk1"]),
        Wt2=w["trunk2"], bt2=col(b["trunk2"]),
        Wt3=w["trunk3"], bt3=col(b["trunk3"]),
        Wt4=w["trunk4"], bt4=col(b["trunk4"]),
        Wsh=w["skip"][:, :H], Wsx=perm_pad(w["skip"][:, H:], model.Lp),
        bs=col(b["skip"]),
        Wp0=w["post0"], bp0=col(b["post0"]),
        Wp1=w["post1"], bp1=col(b["post1"]),
        Wcs=torch.cat([Wcf @ w["feature"], w["sigma"], zeros(7, H)]),
        bcs=col(torch.cat([Wcf @ b["feature"] + b["color0"], b["sigma"], zeros(7)])),
        Wcd=perm_pad(w["color0"][:, H : H + Cd], model.Ld),
        Wc1=torch.cat([w["color1"], zeros(5, H // 2)]),
        bc1=col(torch.cat([b["color1"], zeros(5)])),
    )
    return FusedWeights(**{k: v.to(torch.float32).contiguous() for k, v in fields.items()})


def _cast_weights(wts: FusedWeights, dtype) -> FusedWeights:
    """Weight matrices in the compute dtype; biases stay f32 (they add
    into the f32 accumulator). A no-op when already cast."""
    return FusedWeights(*[
        w if w.shape[-1] == 1 or w.dtype == dtype else w.to(dtype).contiguous()
        for w in wts
    ])


def _encode(xT: torch.Tensor, model: NerfMLP) -> tuple[torch.Tensor, torch.Tensor]:
    """(8, rows) f32 -> posx (FX, rows), posd (FD, rows) in the kernel's
    row order, f32. Pad rows are zero."""

    def branch(x3, L):
        sb = _sin_block(L)
        freqs = 2.0 ** torch.arange(L, dtype=x3.dtype, device=x3.device)
        ang = (x3[:, None, :] * freqs[None, :, None]).reshape(3 * L, -1)
        out = torch.zeros((_enc_rows(L), x3.shape[1]), dtype=x3.dtype, device=x3.device)
        out[0:3] = x3
        out[8 : 8 + 3 * L] = torch.sin(ang)
        out[8 + sb : 8 + sb + 3 * L] = torch.cos(ang)
        return out

    return branch(xT[0:3], model.Lp), branch(xT[3:6], model.Ld)


def _rnd(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to bf16 when that is the compute type, computed on in
    f32 (bf16 products are exact in f32). f32 and f64 pass through: the
    plain versions also run in f64, as a reference for both."""
    return x.to(dtype).float() if dtype == torch.bfloat16 else x


def _mm(a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """Both operands rounded to ``dtype``, products summed in f32 (f64 for
    f64 operands)."""
    return _rnd(a, dtype) @ _rnd(b, dtype)


class Residuals(NamedTuple):
    """What the backward needs of the forward, f32 ``(features, rows)``:
    the encoded inputs and every relu output."""

    posx: torch.Tensor
    posd: torch.Tensor
    h: tuple  # h0..h7, each (H, rows)
    hc: torch.Tensor


def _forward(wts: FusedWeights, xT: torch.Tensor, dt, model: NerfMLP):
    """The JAX ``_forward_tile``: (8, rows) -> (out (8, rows), Residuals)."""
    H2 = model.H // 2
    posx, posd = _encode(xT, model)

    def dense(W, b, h):
        return torch.relu(_mm(W, h, dt) + b)

    h = [dense(wts.W1, wts.b1, posx)]
    for W, b in ((wts.Wt1, wts.bt1), (wts.Wt2, wts.bt2), (wts.Wt3, wts.bt3),
                 (wts.Wt4, wts.bt4)):
        h.append(dense(W, b, h[-1]))
    h.append(torch.relu(_mm(wts.Wsh, h[-1], dt) + _mm(wts.Wsx, posx, dt) + wts.bs))
    h.append(dense(wts.Wp0, wts.bp0, h[-1]))
    h.append(dense(wts.Wp1, wts.bp1, h[-1]))
    cs = _mm(wts.Wcs, h[-1], dt) + wts.bcs
    hc = torch.relu(cs[:H2] + _mm(wts.Wcd, posd, dt))
    rgb8 = _mm(wts.Wc1, hc, dt) + wts.bc1
    out = torch.zeros((8, xT.shape[1]), dtype=rgb8.dtype, device=xT.device)
    out[:3] = rgb8[:3]
    out[3] = cs[H2]
    return out, Residuals(posx, posd, tuple(h), hc)


def fused_mlp_forward_plain(
    wts: FusedWeights,
    xT: torch.Tensor,
    compute_dtype=torch.bfloat16,
    model: NerfMLP = FLAGSHIP,
) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: same weights, same
    numerics (the JAX ``_forward_tile``), any device."""
    return _forward(wts, xT, compute_dtype, model)[0]


def _backprop(wts: FusedWeights, res: Residuals, g_rgb: torch.Tensor,
              g_sig: torch.Tensor, dt, model: NerfMLP) -> FusedWeights:
    """The JAX ``_backprop_tile`` from per-sample cotangents ``g_rgb (3,
    rows)`` and ``g_sig (rows,)`` to packed-layout f32 gradients, summed
    over rows. Rounding as the kernels round: both operands of every
    product to ``dt``, f32 sums; the relu mask from the residual; a bias
    gradient is the row sum of the cotangent as stored (rounded to
    ``dt``). The TPU kernel took three bias sums (b1, bs, the colour half
    of bcs) from a rail column of rounded cotangents and the others from
    f32 ones; at f32 the two agree."""
    rows = g_rgb.shape[1]
    h = res.h

    def back(W, g, act):  # mask(act) * W^T g
        return _mm(W.T, g, dt) * (act > 0)

    def dW(g, act):
        return _mm(g, act.T, dt)

    def db(g):
        return _rnd(g, dt).sum(1, keepdim=True)

    g8 = torch.zeros((8, rows), dtype=g_rgb.dtype, device=g_rgb.device)
    g8[:3] = g_rgb
    g_hc = back(wts.Wc1, g8, res.hc)
    g_cs = torch.cat([g_hc, g_sig[None], torch.zeros_like(g8[:7])])
    g_h = [None] * 8
    g_h[7] = back(wts.Wcs, g_cs, h[7])
    for l, W in ((6, wts.Wp1), (5, wts.Wp0), (4, wts.Wsh), (3, wts.Wt4),
                 (2, wts.Wt3), (1, wts.Wt2), (0, wts.Wt1)):
        g_h[l] = back(W, g_h[l + 1], h[l])
    return FusedWeights(
        W1=dW(g_h[0], res.posx), b1=db(g_h[0]),
        Wt1=dW(g_h[1], h[0]), bt1=db(g_h[1]),
        Wt2=dW(g_h[2], h[1]), bt2=db(g_h[2]),
        Wt3=dW(g_h[3], h[2]), bt3=db(g_h[3]),
        Wt4=dW(g_h[4], h[3]), bt4=db(g_h[4]),
        Wsh=dW(g_h[5], h[4]), Wsx=dW(g_h[5], res.posx), bs=db(g_h[5]),
        Wp0=dW(g_h[6], h[5]), bp0=db(g_h[6]),
        Wp1=dW(g_h[7], h[6]), bp1=db(g_h[7]),
        Wcs=dW(g_cs, h[7]), bcs=db(g_cs), Wcd=dW(g_hc, res.posd),
        Wc1=dW(g8, res.hc), bc1=db(g8),
    )


def fused_mlp_backward_plain(
    wts: FusedWeights,
    xT: torch.Tensor,
    gT: torch.Tensor,
    compute_dtype=torch.bfloat16,
    model: NerfMLP = FLAGSHIP,
) -> FusedWeights:
    """Plain PyTorch version of the backward kernel: ``gT (8, rows)`` with
    d_rgb in rows 0..2 and d_sigma in row 3 -> packed f32 gradients."""
    _, res = _forward(wts, xT, compute_dtype, model)
    return _backprop(wts, res, gT[:3], gT[3], compute_dtype, model)


def _composite_grad(out8: torch.Tensor, x16: torch.Tensor, N: int):
    """The JAX ``_composite_grad_block``, point form: per-sample raw rgb
    and sigma ``out8`` (8, B*N) and ``x16`` -> (per-ray loss (B,), d_rgb
    per sample (3, B*N), d_sigma per sample (B*N,)). The loss is
    sum_c (rgb_ray - gt)^2 / (3B) summed over rays."""
    B = out8.shape[1] // N
    scale = 1.0 / (3.0 * B)
    rgb = out8[:3].reshape(3, B, N)
    sig = out8[3].reshape(B, N)
    ts = x16[6].reshape(B, N)
    gt = x16[8:11].reshape(3, B, N)[:, :, 0]
    delta = torch.cat([ts[:, 1:] - ts[:, :-1], torch.full_like(ts[:, :1], 1e10)], dim=1)
    e = torch.exp(-torch.nn.functional.softplus(sig) * delta)
    alpha = 1.0 - e
    m = torch.clamp(1.0 - alpha, min=1e-10)
    logm = torch.log(m)
    T = torch.exp(torch.cumsum(logm, dim=1) - logm)
    w = alpha * T
    err = (w[None] * rgb).sum(-1) - gt  # (3, B)
    loss_ray = (err * err).sum(0) * scale
    d_rgb = 2.0 * scale * err
    d_w = (rgb * d_rgb[:, :, None]).sum(0)
    y = d_w * w
    suffix = y.sum(1, keepdim=True) - torch.cumsum(y, dim=1)
    d_alpha = d_w * T - torch.where(1.0 - alpha > 1e-10, suffix / m, 0.0)
    d_sig = d_alpha * e * delta * torch.sigmoid(sig)
    return loss_ray, (w[None] * d_rgb[:, :, None]).reshape(3, -1), d_sig.reshape(-1)


def fused_train_step_plain(
    wts: FusedWeights,
    x16: torch.Tensor,
    N: int,
    compute_dtype=torch.bfloat16,
    model: NerfMLP = FLAGSHIP,
) -> tuple[torch.Tensor, FusedWeights]:
    """Plain PyTorch version of the train-step kernel: (loss, packed f32
    gradients) for ``x16 (16, B*N)`` (see ``fused_train_step``)."""
    out8, res = _forward(wts, x16[:8], compute_dtype, model)
    loss_ray, g_rgb, g_sig = _composite_grad(out8, x16, N)
    return loss_ray.sum(), _backprop(wts, res, g_rgb, g_sig, compute_dtype, model)


# --- the CUDA wrappers --------------------------------------------------------

class _CPtrs(ctypes.Structure):
    """The C ``Weights`` and ``Grads`` structs: one pointer a field."""

    _fields_ = [(name, ctypes.c_void_p) for name in FusedWeights._fields]


_TRANSPOSED = ("Wc1", "Wcs", "Wp1", "Wp0", "Wsh", "Wt4", "Wt3", "Wt2", "Wt1")


class _CWeightsT(ctypes.Structure):
    _fields_ = [(f"{name}T", ctypes.c_void_p) for name in _TRANSPOSED]


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {  # source -> {entry: (argtypes, restype)}
    "fused_mlp_fwd": {
        "fused_mlp_fwd": ([_P, _P, _LL, _I, _I, _I, _I, _CPtrs, _P], _I),
        "fused_mlp_fwd_smem_bytes": ([_I] * 4, _LL),
    },
    "fused_mlp_bwd": {
        "fused_mlp_bwd": ([_P, _P, _LL, _I, _I, _I, _I, _CPtrs, _CWeightsT, _P, _CPtrs, _P], _I),
        "fused_mlp_bwd_smem_bytes": ([_I] * 4, _LL),
        "fused_mlp_bwd_workspace_bytes": ([_LL, _I, _I, _I, _I], _LL),
    },
    "fused_train_step": {
        "fused_train_step": ([_P, _LL, _I, _I, _I, _I, _I, _CPtrs, _CWeightsT, _P, _P, _CPtrs, _P], _I),
        "fused_train_step_smem_bytes": ([_I] * 4, _LL),
        "fused_train_step_workspace_bytes": ([_LL, _I, _I, _I, _I, _I], _LL),
    },
}
SOURCES = tuple(_SIGNATURES)


def _lib(name: str) -> ctypes.CDLL:
    lib = _build.load(name)
    for entry, (argtypes, restype) in _SIGNATURES[name].items():
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def _weight_shapes(model: NerfMLP) -> dict[str, tuple[int, int]]:
    H, H2 = model.H, model.H // 2
    FX, FD = _enc_rows(model.Lp), _enc_rows(model.Ld)
    shapes = dict(W1=(H, FX), Wsh=(H, H), Wsx=(H, FX), Wcs=(H2 + 8, H),
                  bcs=(H2 + 8, 1), Wcd=(H2, FD), Wc1=(8, H2), bc1=(8, 1))
    for n in ("t1", "t2", "t3", "t4", "p0", "p1"):
        shapes[f"W{n}"], shapes[f"b{n}"] = (H, H), (H, 1)
    shapes["b1"] = shapes["bs"] = (H, 1)
    return shapes


def _check_launch(name: str, wts: FusedWeights, x: torch.Tensor, x_name: str, x_rows: int,
                  compute_dtype, model: NerfMLP) -> tuple[ctypes.CDLL, int]:
    """Raise on what the kernels do not take; returns the library and the
    bf16 flag."""
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the kernels compute in f32 or bf16, not {compute_dtype}")
    if model.H > _MAX_H:
        raise ValueError(f"the CUDA kernels hold H <= {_MAX_H}; got {model}")
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[0] != x_rows or not x.is_contiguous():
        raise ValueError(
            f"{x_name} must be a contiguous ({x_rows}, rows) f32 tensor; got "
            f"{tuple(x.shape)} {x.dtype}"
        )
    for field, shape in _weight_shapes(model).items():
        t = getattr(wts, field)
        want = torch.float32 if shape[1] == 1 else compute_dtype
        if tuple(t.shape) != shape or t.dtype != want or t.device != x.device or not t.is_contiguous():
            raise ValueError(
                f"{field}: need contiguous {shape} {want} on {x.device}, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}"
            )
    lib = _lib(name)
    bf16 = int(compute_dtype == torch.bfloat16)
    smem = getattr(lib, f"{name}_smem_bytes")(model.Lp, model.Ld, model.H, bf16)
    limit = torch.cuda.get_device_properties(x.device).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"{model} needs {smem} B of shared memory a block; the card has {limit}")
    return lib, bf16


def _ptrs(tensors) -> list[int]:
    return [t.data_ptr() for t in tensors]


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def _dispatch(x: torch.Tensor) -> bool:
    """True for a CPU tensor (plain version), False for a CUDA tensor
    (kernel); raises for any other device."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"no fused MLP kernel for device {x.device}")
    return False


def _prepare(wts: FusedWeights, compute_dtype, model: NerfMLP) -> FusedWeights:
    if not supported(model):
        raise ValueError(f"fused kernel needs H % 16 == 0, H >= 16; got {model}")
    require_ported(model)  # the point variant only: no contraction, no appearance rail
    return _cast_weights(wts, compute_dtype)


def fused_mlp_forward(
    wts: FusedWeights,
    xT: torch.Tensor,
    compute_dtype=torch.bfloat16,
    model: NerfMLP = FLAGSHIP,
) -> torch.Tensor:
    """Fused MLP forward: ``xT (8, rows)`` f32 -> ``(8, rows)`` f32, raw
    rgb in rows 0..2, raw sigma in row 3, zeros in rows 4..7. ``rows``
    may be any count (the kernel masks the ragged tile)."""
    wts = _prepare(wts, compute_dtype, model)
    if _dispatch(xT):
        return fused_mlp_forward_plain(wts, xT, compute_dtype, model)
    lib, bf16 = _check_launch("fused_mlp_fwd", wts, xT, "xT", 8, compute_dtype, model)
    out = torch.empty((8, xT.shape[1]), dtype=torch.float32, device=xT.device)
    _raise_on(lib.fused_mlp_fwd(
        xT.data_ptr(), out.data_ptr(), xT.shape[1], model.Lp, model.Ld, model.H, bf16,
        _CPtrs(*_ptrs(wts)), _stream(xT),
    ), "fused_mlp_fwd")
    fused_mlp_forward.launches += 1
    return out


fused_mlp_forward.launches = 0


def _transposed(wts: FusedWeights) -> _CWeightsT:
    """The backward's transposed matrices; the tensors ride on the struct
    so they live as long as the launch arguments."""
    ts = [getattr(wts, n).t().contiguous() for n in _TRANSPOSED]
    st = _CWeightsT(*_ptrs(ts))
    st.keep = ts
    return st


def _empty_grads(model: NerfMLP, device) -> FusedWeights:
    return FusedWeights(**{
        n: torch.empty(s, dtype=torch.float32, device=device)
        for n, s in _weight_shapes(model).items()
    })


def fused_mlp_backward(
    wts: FusedWeights,
    xT: torch.Tensor,
    gT: torch.Tensor,
    compute_dtype=torch.bfloat16,
    model: NerfMLP = FLAGSHIP,
) -> FusedWeights:
    """Fused MLP backward: the packed f32 weight gradients of
    sum(out * gT) for ``out = fused_mlp_forward(wts, xT)``, with
    ``gT (8, rows)`` f32 (rows 0..2 d_rgb, row 3 d_sigma, rows 4..7 not
    read). No gradient for ``xT``."""
    wts = _prepare(wts, compute_dtype, model)
    if _dispatch(xT):
        with torch.no_grad():
            return fused_mlp_backward_plain(wts, xT, gT, compute_dtype, model)
    lib, bf16 = _check_launch("fused_mlp_bwd", wts, xT, "xT", 8, compute_dtype, model)
    if gT.shape != xT.shape or gT.dtype != torch.float32 or gT.device != xT.device or not gT.is_contiguous():
        raise ValueError(f"gT must be a contiguous {tuple(xT.shape)} f32 tensor on {xT.device}")
    rows = xT.shape[1]
    if rows == 0:
        raise ValueError("fused_mlp_backward needs at least one row")
    ws = torch.empty(lib.fused_mlp_bwd_workspace_bytes(rows, model.Lp, model.Ld, model.H, bf16),
                     dtype=torch.uint8, device=xT.device)
    grads = _empty_grads(model, xT.device)
    _raise_on(lib.fused_mlp_bwd(
        xT.data_ptr(), gT.data_ptr(), rows, model.Lp, model.Ld, model.H, bf16,
        _CPtrs(*_ptrs(wts)), _transposed(wts), ws.data_ptr(), _CPtrs(*_ptrs(grads)),
        _stream(xT),
    ), "fused_mlp_bwd")
    fused_mlp_backward.launches += 1
    return grads


fused_mlp_backward.launches = 0


class _FusedMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xT, compute_dtype, model, *wts):
        ctx.save_for_backward(xT, *wts)
        ctx.compute_dtype, ctx.model = compute_dtype, model
        return fused_mlp_forward(FusedWeights(*wts), xT, compute_dtype, model)

    @staticmethod
    def backward(ctx, g):
        xT, *wts = ctx.saved_tensors
        grads = fused_mlp_backward(FusedWeights(*wts), xT, g.contiguous(),
                                   ctx.compute_dtype, ctx.model)
        return (None, None, None, *grads)


def fused_mlp(
    wts: FusedWeights,
    xT: torch.Tensor,
    compute_dtype=torch.bfloat16,
    model: NerfMLP = FLAGSHIP,
) -> torch.Tensor:
    """Differentiable fused MLP (the JAX ``fused_mlp`` with
    ``want_dx=False``): forward ``fused_mlp_forward``, backward
    ``fused_mlp_backward``. Gradients reach the packed weights only;
    ``xT`` gets none."""
    return _FusedMLP.apply(xT, compute_dtype, model, *wts)


def fused_train_step(
    wts: FusedWeights,
    x16: torch.Tensor,
    N: int,
    compute_dtype=torch.bfloat16,
    model: NerfMLP = FLAGSHIP,
) -> tuple[torch.Tensor, FusedWeights]:
    """One fused forward + compositing + MSE + backward pass.

    ``x16 (16, B*N)`` f32: rows 0..2 sample xyz, 3..5 unit view dirs, 6 ts
    (ascending along each ray), 8..10 the ray's gt colour on each of its
    samples, other rows unread; ray b owns columns b*N .. b*N + N - 1.
    Returns (loss, a 0-d f32 tensor; packed f32 weight gradients)."""
    wts = _prepare(wts, compute_dtype, model)
    if N <= 0 or x16.dim() != 2 or x16.shape[1] % N or x16.shape[1] == 0:
        raise ValueError(f"x16 must hold whole rays of N={N} samples; got {tuple(x16.shape)}")
    if _dispatch(x16):
        with torch.no_grad():
            return fused_train_step_plain(wts, x16, N, compute_dtype, model)
    lib, bf16 = _check_launch("fused_train_step", wts, x16, "x16", 16, compute_dtype, model)
    rows = x16.shape[1]
    ws = torch.empty(
        lib.fused_train_step_workspace_bytes(rows, N, model.Lp, model.Ld, model.H, bf16),
        dtype=torch.uint8, device=x16.device,
    )
    loss = torch.empty((), dtype=torch.float32, device=x16.device)
    grads = _empty_grads(model, x16.device)
    _raise_on(lib.fused_train_step(
        x16.data_ptr(), rows, N, model.Lp, model.Ld, model.H, bf16,
        _CPtrs(*_ptrs(wts)), _transposed(wts), ws.data_ptr(), loss.data_ptr(),
        _CPtrs(*_ptrs(grads)), _stream(x16),
    ), "fused_train_step")
    fused_train_step.launches += 1
    return loss, grads


fused_train_step.launches = 0
