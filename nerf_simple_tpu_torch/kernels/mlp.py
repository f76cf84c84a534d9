"""The fused NeRF MLP forward: a hand-written CUDA kernel and its plain
PyTorch version.

Port of nerf_simple_tpu/kernels/mlp.py's forward (``fused_mlp_forward``,
point variant). The kernel source is ``csrc/fused_mlp_fwd.cu``; its
header says what bounds it on the card and how it is laid out.

Layout, kept from the JAX package so the two can be compared field by
field: activations are feature-major ``(features, rows)``; the caller
passes ``xT (8, rows)`` (rows 0..2 sample xyz, 3..5 unit view dir) and
gets ``(8, rows)`` back (raw rgb rows 0..2, raw sigma row 3, zeros 4..7).
``pack_weights`` permutes the first-layer columns into 8-aligned raw /
sin / cos blocks, splits the skip and colour concats into two matrices
each, and folds the reference's no-activation feature layer into the
colour head: ``Wcf (Wf h + bf) == (Wcf Wf) h + Wcf bf`` exactly, so
``Wcs = [Wcf·Wf ; Wsigma ; 0]`` replaces two matmuls by one.

Dispatch: ``fused_mlp_forward`` runs the plain version for a CPU tensor
and launches the kernel for a CUDA tensor, or raises. It never falls
back from one to the other.
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


@torch.no_grad()
def pack_weights(field: NerfField) -> FusedWeights:
    """Repack the field's layers into the kernel layout, f32, on the
    field's device. The feature-layer fold is computed in float64 and
    rounded once."""
    model = field.model
    if not supported(model):
        raise ValueError(f"fused kernel needs H % 16 == 0, H >= 16; got {model}")
    H, Cd = model.H, model.in_Cd
    dev = field.trunk0.weight.device
    w = {n: getattr(field, n).weight.detach().cpu().double() for n in (
        "trunk0", "trunk1", "trunk2", "trunk3", "trunk4", "skip", "post0",
        "post1", "sigma", "feature", "color0", "color1")}
    b = {n: getattr(field, n).bias.detach().cpu().double() for n in w}

    def perm_pad(m, L):  # (out, C) reference columns -> (out, F) kernel columns
        return m[:, torch.from_numpy(_perm(L))] * torch.from_numpy(_valid(L)).double()

    def col(v):
        return v[:, None]

    Wcf = w["color0"][:, :H]
    zH = torch.zeros((7, H), dtype=torch.float64)
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
        Wcs=torch.cat([Wcf @ w["feature"], w["sigma"], zH]),
        bcs=col(torch.cat([Wcf @ b["feature"] + b["color0"], b["sigma"],
                           torch.zeros(7, dtype=torch.float64)])),
        Wcd=perm_pad(w["color0"][:, H : H + Cd], model.Ld),
        Wc1=torch.cat([w["color1"], torch.zeros((5, H // 2), dtype=torch.float64)]),
        bc1=col(torch.cat([b["color1"], torch.zeros(5, dtype=torch.float64)])),
    )
    return FusedWeights(**{
        k: v.to(torch.float32).contiguous().to(dev) for k, v in fields.items()
    })


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


def _mm(a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """Both operands rounded to ``dtype``, products summed in f32."""
    if dtype != torch.float32:
        a, b = a.to(dtype).float(), b.to(dtype).float()
    return a @ b


def fused_mlp_forward_plain(
    wts: FusedWeights,
    xT: torch.Tensor,
    compute_dtype=torch.bfloat16,
    model: NerfMLP = FLAGSHIP,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: same weights, same numerics
    (the JAX ``_forward_tile``), any device."""
    dt, H2 = compute_dtype, model.H // 2
    posx, posd = _encode(xT, model)

    def dense(W, b, h):
        return torch.relu(_mm(W, h, dt) + b)

    h = dense(wts.W1, wts.b1, posx)
    for W, b in ((wts.Wt1, wts.bt1), (wts.Wt2, wts.bt2), (wts.Wt3, wts.bt3),
                 (wts.Wt4, wts.bt4)):
        h = dense(W, b, h)
    h = torch.relu(_mm(wts.Wsh, h, dt) + _mm(wts.Wsx, posx, dt) + wts.bs)
    h = dense(wts.Wp0, wts.bp0, h)
    h = dense(wts.Wp1, wts.bp1, h)
    cs = _mm(wts.Wcs, h, dt) + wts.bcs
    hc = torch.relu(cs[:H2] + _mm(wts.Wcd, posd, dt))
    rgb8 = _mm(wts.Wc1, hc, dt) + wts.bc1
    out = torch.zeros((8, xT.shape[1]), dtype=torch.float32, device=xT.device)
    out[:3] = rgb8[:3]
    out[3] = cs[H2]
    return out


class _CWeights(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in FusedWeights._fields]


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_mlp_fwd")
    lib.fused_mlp_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _CWeights, ctypes.c_void_p,
    ]
    lib.fused_mlp_fwd.restype = ctypes.c_int
    lib.fused_mlp_fwd_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.fused_mlp_fwd_smem_bytes.restype = ctypes.c_longlong
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


def _launch(wts: FusedWeights, xT: torch.Tensor, compute_dtype, model: NerfMLP) -> torch.Tensor:
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the kernel computes in f32 or bf16, not {compute_dtype}")
    if model.H > _MAX_H:
        raise ValueError(f"the CUDA kernel holds H <= {_MAX_H}; got {model}")
    if xT.dtype != torch.float32 or xT.dim() != 2 or xT.shape[0] != 8 or not xT.is_contiguous():
        raise ValueError(
            f"xT must be a contiguous (8, rows) f32 tensor; got {tuple(xT.shape)} {xT.dtype}"
        )
    for name, shape in _weight_shapes(model).items():
        t = getattr(wts, name)
        want = torch.float32 if shape[1] == 1 else compute_dtype
        if tuple(t.shape) != shape or t.dtype != want or t.device != xT.device or not t.is_contiguous():
            raise ValueError(
                f"{name}: need contiguous {shape} {want} on {xT.device}, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}"
            )
    lib = _lib()
    bf16 = int(compute_dtype == torch.bfloat16)
    smem = lib.fused_mlp_fwd_smem_bytes(model.Lp, model.Ld, model.H, bf16)
    limit = torch.cuda.get_device_properties(xT.device).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"{model} needs {smem} B of shared memory a block; the card has {limit}")
    rows = xT.shape[1]
    out = torch.empty((8, rows), dtype=torch.float32, device=xT.device)
    err = lib.fused_mlp_fwd(
        xT.data_ptr(), out.data_ptr(), rows, model.Lp, model.Ld, model.H, bf16,
        _CWeights(*[t.data_ptr() for t in wts]),
        torch.cuda.current_stream(xT.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_mlp_fwd launch failed: cudaError {err}")
    return out


def fused_mlp_forward(
    wts: FusedWeights,
    xT: torch.Tensor,
    compute_dtype=torch.bfloat16,
    model: NerfMLP = FLAGSHIP,
) -> torch.Tensor:
    """Fused MLP forward: ``xT (8, rows)`` f32 -> ``(8, rows)`` f32, raw
    rgb in rows 0..2, raw sigma in row 3, zeros in rows 4..7. ``rows``
    may be any count (the kernel masks the ragged tile).

    A CPU tensor takes ``fused_mlp_forward_plain``; a CUDA tensor
    launches the kernel (counted in ``fused_mlp_forward.launches``) or
    raises."""
    if not supported(model):
        raise ValueError(f"fused kernel needs H % 16 == 0, H >= 16; got {model}")
    require_ported(model)  # the point variant only: no contraction, no appearance rail
    wts = _cast_weights(wts, compute_dtype)
    if xT.device.type == "cpu":
        return fused_mlp_forward_plain(wts, xT, compute_dtype, model)
    if xT.device.type != "cuda":
        raise ValueError(f"no fused MLP forward for device {xT.device}")
    out = _launch(wts, xT, compute_dtype, model)
    fused_mlp_forward.launches += 1
    return out


fused_mlp_forward.launches = 0
