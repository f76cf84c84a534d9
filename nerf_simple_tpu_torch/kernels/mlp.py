"""The fused NeRF MLP kernels: hand-written CUDA kernels and their plain
PyTorch versions.

Port of nerf_simple_tpu/kernels/mlp.py, point and mip (cone-cast)
variants, each with or without the scene contraction:

- ``fused_mlp_forward`` (csrc/fused_mlp_fwd.cu): the MLP forward;
- ``fused_mlp_backward`` (csrc/fused_mlp_bwd.cu): the weight gradients
  for per-sample output cotangents (the TPU ``_fused_mlp_bwd``), and with
  ``want_dx`` the gradient of the input rows too (csrc/input_grad.cuh,
  the TPU ``_input_grad_tile``, and under mip ``_input_grad_tile_mip``;
  a contracted model's through csrc/fused_contract.cu);
- ``fused_mlp``: a ``torch.autograd.Function`` whose forward is the first
  and whose backward is the second;
- ``input_grad`` (csrc/input_grad.cuh, through csrc/fused_mlp_bwd.cu):
  the input-gradient kernel alone, from the backward's cotangent planes
  to ``dL/dx``;
- ``fused_train_step`` (csrc/fused_train_step.cu): forward, compositing,
  the MSE loss and the full backward of one batch of whole rays, and
  optionally each sample's compositing weight (``out_weights``) and the
  point-form distortion loss in the loss and its gradient (``dist``);
- ``fused_render`` (csrc/fused_render.cu): forward and point compositing
  of whole rays, each ray's rgb, depth and acc (the eval render);
- ``weight_grad`` and ``weight_grads`` (csrc/wgrad.cuh, through
  csrc/fused_mlp_bwd.cu): the backward's weight-gradient sums alone,
  ``G A^T`` and the row sums of ``G``, one or up to twelve a launch, as
  B1 and B2 run them;
- ``backward_tile`` (csrc/bwd_f32.cuh or csrc/bwd_bf16.cuh, through
  csrc/fused_mlp_bwd.cu): the backward's tile kernel alone, from residual
  planes and output cotangents to every layer's cotangent plane.
- ``forward_residuals`` (csrc/fwd_f32.cuh or csrc/fwd_bf16.cuh, through
  csrc/fused_mlp_fwd.cu): the forward tile kernel as B1 and B2 run it,
  its output and every residual plane.

A contracted model's forward tile kernels and input-gradient kernel are
built into a library of their own (csrc/fused_contract.cu), which each of
the others calls for them (``_link_contract``).

Each source's header says what bounds it on the card and how it is laid
out; the tile kernels they share are headers of ``csrc/mlp_tile.cuh``.

Layout, kept from the JAX package so the two can be compared field by
field: activations are feature-major ``(features, rows)``; the caller
passes ``xT (8, rows)`` (rows 0..2 sample xyz, 3..5 unit view dir) and
gets ``(8, rows)`` back (raw rgb rows 0..2, raw sigma row 3, zeros 4..7).
With ``mip`` (mip-NeRF's cone casting) the input has 16 rows: rows 0..2
the frustum Gaussians' means, 11..13 their diagonal variances, and the
encoder is the integrated one: each sin and cos row of coordinate c at
frequency 2^i is damped by ``exp(-0.5 * 4^i * var_c)`` (the raw rows and
the direction branch are not). The damped posx is what the residual
planes hold, so the backward's weight gradients need no change. BARF's
anneal windows (``enc_w``, ``anneal_row_weights``: pose refinement's
coarse-to-fine encoder) multiply each encoded row of posx and posd by its
octave's weight the same way, in the forward and in the backward's
recompute. An appearance model (``model.app_dim`` > 0, NeRF-W's per-image
codes) takes 16 input rows, its code in rows 8..15 (``app_dim`` of them,
zeros after), which only the colour head reads: ``hc_pre = Wcs h7 + Wcd
posd + Wca app8``. The port packs ``Wca`` as eight more columns of ``Wcd``
and the encoder copies the code rows after posd's encoded rows, so the
kernels run that sum as one product, ``[Wcd | Wca] [posd ; app8]``, and
the backward's ``Wcd`` sum and input gradient give ``dWca`` and the codes'
gradients with no new pass (``_posd_rows``). A contracted model
(``model.contract``, mip-NeRF 360's unbounded scenes) has the encoder of
posx contract rows 0..2 first, ``x g(n)`` with ``g = (2 - 1/n) / n``
outside the unit ball and 1 inside, and under mip warp the variance rows
through the contraction's Jacobian; the residual planes hold the
contracted posx, so the backward's weight gradients need no change; its
input gradient takes the encoder's transpose at the contracted rows and
then the contraction's, ``g dy + c (x . dy) x`` (``_encode_transpose``);
under mip the angles and damps are those of the contracted means and
variances, and the warp's coupled transpose takes both cotangents to the
raw means and variances (``_contract_transpose_mip``). The windows and
the code rows compose with the contraction as without it.
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
from nerf_simple_tpu_torch.models.nerf import NerfField, NerfMLP
from nerf_simple_tpu_torch.ops.volume import s_norm

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


def _posd_rows(model) -> int:
    """Rows of posd as the kernels hold it: the encoded direction, and for
    an appearance model the eight code rows after it (the input's rows
    8..15), which ``Wcd``'s last eight columns (``Wca``) multiply."""
    return _enc_rows(model.Ld) + (8 if model.app_dim > 0 else 0)


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
    Wcd: torch.Tensor  # (H//2, FD) color0, posd half; with app_dim, Wca as 8 more columns
    Wc1: torch.Tensor  # (8, H//2) color1: rgb rows 0..2, zero rows 3..7
    bc1: torch.Tensor


def pack_weights(field: NerfField, differentiable: bool = False) -> FusedWeights:
    """Repack the field's layers into the kernel layout, f32, on the
    field's device. The feature-layer fold is computed in float64 and
    rounded once. With ``differentiable`` (and gradients enabled) the
    result carries autograd history back to the field's parameters. An
    appearance model's ``Wcd`` is ``[Wcd | Wca]``: ``color0``'s code
    columns, then zero columns to eight (the JAX ``FusedWeightsApp.Wca``,
    kernels/mlp.py:350-360)."""
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
    Wcd = perm_pad(w["color0"][:, H : H + Cd], model.Ld)
    if model.app_dim > 0:
        Wcd = torch.cat([Wcd, w["color0"][:, H + Cd :], zeros(H // 2, 8 - model.app_dim)], 1)
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
        Wcd=Wcd,
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


IMAGE_ORDER = ("W1", "Wt1", "Wt2", "Wt3", "Wt4", "Wsh", "Wsx", "Wp0", "Wp1", "Wcs", "Wcd", "Wc1")


def image_slices(model: NerfMLP) -> list[tuple[str, int, int]]:
    """The bf16 forward's weight image, in order: (matrix, K-slice index,
    slice rows). Each slice holds 64 columns of every output row of one
    matrix, rows padded to the product's N (a multiple of 64, or 8 for
    ``Wc1``): the order in which csrc/fwd_bf16.cuh multiplies by them."""
    H = model.H
    npad = {n: -(-H // 64) * 64 for n in IMAGE_ORDER[:9]}
    npad.update(Wcs=-(-(H // 2 + 8) // 64) * 64, Wcd=-(-(H // 2 + 8) // 64) * 64, Wc1=8)
    K = _weight_shapes(model)
    return [(n, c, npad[n]) for n in IMAGE_ORDER for c in range(-(-K[n][1] // 64))]


def _swizzled_image(mats: dict, slices) -> torch.Tensor:
    """int16 bit patterns of the bf16 matrices ``mats`` (name -> (rows, K)),
    slice after slice as ``slices`` lists them ((name, K-slice, slice
    rows)), each (rows, 64) with zeros past the matrix, in the 128-byte
    swizzle: the 16-byte chunk c of row n is stored at chunk c ^ (n % 8)."""
    parts = []
    for name, c, rows in slices:
        W = mats[name].to(torch.bfloat16).view(torch.int16)
        sl = torch.zeros((rows, 64), dtype=torch.int16, device=W.device)
        blk = W[:, 64 * c : 64 * c + 64]
        sl[: blk.shape[0], : blk.shape[1]] = blk
        n = torch.arange(rows, device=W.device)[:, None]
        pos = torch.arange(8, device=W.device)[None, :]
        parts.append(sl.reshape(rows, 8, 8)[n, pos ^ (n % 8)].reshape(-1))
    return torch.cat(parts)


def weight_image_plain(wts: FusedWeights, model: NerfMLP) -> torch.Tensor:
    """Plain version of the bf16 forward's weight image (csrc/
    fwd_bf16.cuh ``image_kernel``): the packed matrices as
    ``image_slices`` lists them, swizzled (``_swizzled_image``)."""
    return _swizzled_image({n: getattr(wts, n) for n in IMAGE_ORDER}, image_slices(model))


BWD_IMAGE_ORDER = ("Wc1", "Wcs", "Wp1", "Wp0", "Wsh", "Wt4", "Wt3", "Wt2", "Wt1")


def bwd_image_slices(model: NerfMLP) -> list[tuple[str, int, int]]:
    """The bf16 backward's weight image, in order: (matrix, K-slice index,
    slice rows) of each transposed matrix ``W^T`` (in, out), 64 of its
    columns a slice, rows padded to a multiple of 64: the order in which
    csrc/bwd_bf16.cuh multiplies a cotangent by them (``Wc1^T`` with K = 8,
    ``Wcs^T`` with K = H/2 + 8, then the chain ``Wp1^T`` .. ``Wt1^T``)."""
    shapes = _weight_shapes(model)
    return [(n, c, -(-shapes[n][1] // 64) * 64) for n in BWD_IMAGE_ORDER
            for c in range(-(-shapes[n][0] // 64))]


def bwd_weight_image_plain(wts: FusedWeights, model: NerfMLP) -> torch.Tensor:
    """Plain version of the bf16 backward's weight image (csrc/
    bwd_bf16.cuh ``bwd_image_kernel``): each matrix's transpose as
    ``bwd_image_slices`` lists them, swizzled (``_swizzled_image``)."""
    return _swizzled_image({n: getattr(wts, n).T for n in BWD_IMAGE_ORDER}, bwd_image_slices(model))


F32_IMAGE_ORDER = IMAGE_ORDER[:-1]  # Wc1 is read in the epilogue, not streamed
F32_KS = 16  # weight columns of a slice of the f32 forward's ring
F32_ROWS = 128  # sample rows of the f32 forward's tile
SMEM_LIMIT = 232448  # shared memory a block of the H100


def f32_image_slices(model: NerfMLP) -> list[tuple[str, int, int]]:
    """The f32 forward's weight image, in order: (matrix, K-slice index,
    slice width OP). Each slice is ``(F32_KS, OP)`` f32, ``[k][o]``: 16
    columns of a matrix transposed, output features zero-padded to OP =
    128 per feature group of a thread (256 for H > 128, else 128; 128 for
    ``Wcs``, of which only the H/2 colour rows are in the image, and
    ``Wcd``): the order in which csrc/fwd_f32.cuh multiplies by them."""
    ni = 2 if model.H > 128 else 1
    K = _weight_shapes(model)
    return [(n, c, 128 * ni if i < 9 else 128) for i, n in enumerate(F32_IMAGE_ORDER)
            for c in range(-(-K[n][1] // F32_KS))]


def f32_weight_image_plain(wts: FusedWeights, model: NerfMLP) -> torch.Tensor:
    """Plain version of the f32 forward's weight image (csrc/fwd_f32.cuh
    ``image_kernel``): the slices ``f32_image_slices`` lists, flat."""
    parts = []
    for name, c, op in f32_image_slices(model):
        W = getattr(wts, name)
        if name == "Wcs":
            W = W[: model.H // 2]
        sl = torch.zeros((F32_KS, op), dtype=torch.float32, device=W.device)
        blk = W[:, F32_KS * c : F32_KS * (c + 1)].T
        sl[: blk.shape[0], : blk.shape[1]] = blk
        parts.append(sl.reshape(-1))
    return torch.cat(parts)


def f32_forward_smem_bytes(model: NerfMLP) -> int:
    """Shared memory a block of the f32 forward tile kernel takes
    (csrc/fwd_f32.cuh ``Plan::smem_bytes``): the activation tile and posx
    of 128 rows, posd's own tile where it does not fit in posx past eight
    rows (FX < FD + 8), the ring's stages (2-4, as many as fit in
    ``SMEM_LIMIT``) and the barrier words."""
    ni = 2 if model.H > 128 else 1
    FX, FD = _enc_rows(model.Lp), _posd_rows(model)
    fixed = 4 * F32_ROWS * (model.H + FX + (0 if FX >= FD + 8 else FD)) + 2 * 4 * 8
    stage = 4 * F32_KS * 128 * ni
    return fixed + min(max((SMEM_LIMIT - fixed) // stage, 2), 4) * stage


F32_BWD_MAX_STAGES = 6  # ring stages of the f32 backward, at most


def f32_bwd_image_slices(model: NerfMLP) -> list[tuple[str, int, int]]:
    """The f32 backward's weight image, in order: (matrix, K-slice index,
    slice width OP) of each transposed matrix ``W^T`` as
    ``BWD_IMAGE_ORDER`` lists them. Slice c is ``(F32_KS, OP)`` f32,
    ``[k][o]``: rows 16c .. 16c + 15 of the packed (out, in) matrix, each
    zero-padded to OP = 128 output features per feature group of a thread
    (256 for H > 128, else 128; 128 for ``Wc1^T``, whose H/2 outputs one
    group holds), and zero past the matrix's rows (``Wc1``'s 8 rows fill
    half a slice): the order in which csrc/bwd_f32.cuh multiplies a
    cotangent by them."""
    ni = 2 if model.H > 128 else 1
    shapes = _weight_shapes(model)
    return [(n, c, 128 if n == "Wc1" else 128 * ni) for n in BWD_IMAGE_ORDER
            for c in range(-(-shapes[n][0] // F32_KS))]


def f32_bwd_weight_image_plain(wts: FusedWeights, model: NerfMLP) -> torch.Tensor:
    """Plain version of the f32 backward's weight image (csrc/bwd_f32.cuh
    ``bwd_image_kernel``): the slices ``f32_bwd_image_slices`` lists, flat."""
    parts = []
    for name, c, op in f32_bwd_image_slices(model):
        blk = getattr(wts, name)[F32_KS * c : F32_KS * (c + 1)]  # W^T's columns k: W's rows
        sl = torch.zeros((F32_KS, op), dtype=torch.float32, device=blk.device)
        sl[: blk.shape[0], : blk.shape[1]] = blk
        parts.append(sl.reshape(-1))
    return torch.cat(parts)


def f32_backward_smem_bytes(model: NerfMLP) -> int:
    """Shared memory a block of the f32 backward tile kernel takes
    (csrc/bwd_f32.cuh ``Plan::smem_bytes``): the cotangent tile of 128
    rows, the ring's stages (2 to ``F32_BWD_MAX_STAGES``, as many as fit
    in ``SMEM_LIMIT``) and the barrier words."""
    ni = 2 if model.H > 128 else 1
    fixed = 4 * F32_ROWS * model.H + 2 * F32_BWD_MAX_STAGES * 8
    stage = 4 * F32_KS * 128 * ni
    return fixed + min(max((SMEM_LIMIT - fixed) // stage, 2), F32_BWD_MAX_STAGES) * stage


def anneal_row_weights(model: NerfMLP, alpha: float, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """BARF's anneal windows in the kernels' encoded-row layout: (wx (FX,),
    wd (enc_rows(Ld),)) f32. The raw rows carry 1; octave i's sin and cos
    rows of every coordinate carry ``ops/encoding.py::anneal_weights(L,
    alpha)[i]``; pad rows carry 1 (their weight columns are zero). The JAX
    ``anneal_row_weights`` (its row 3, the bias rail, is a pad row here).
    An appearance model's code rows, after posd's encoded rows, take no
    window: JAX anneals only encoded rows (``_encode`` :491-493)."""
    from nerf_simple_tpu_torch.ops.encoding import anneal_weights

    def rows(L):
        w = anneal_weights(L, alpha, torch.float32, device)
        pad = torch.ones(_sin_block(L) - 3 * L, dtype=torch.float32, device=device)
        blk = torch.cat([w.repeat(3), pad])
        return torch.cat([torch.ones(8, dtype=torch.float32, device=device), blk, blk]).contiguous()

    return rows(model.Lp), rows(model.Ld)


def _encode(xT: torch.Tensor, model: NerfMLP, var: torch.Tensor | None = None,
            enc_w: tuple | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(>= 6, rows) f32 -> posx (FX, rows), posd (FD, rows) in the kernel's
    row order, f32. Pad rows are zero. With ``var`` (3, rows), the
    integrated encoder: posx's sin and cos rows of coordinate c at
    frequency 2^i times ``exp(-0.5 * 4^i * var_c)``. With the anneal
    windows ``enc_w = (wx, wd)`` each encoded row times its weight. For an
    appearance model posd ends with the input's code rows 8..15 as they
    are (``_posd_rows``). A contracted model's posx encodes the contracted
    rows 0..2 (``_contract``)."""
    if model.contract:
        xyz, var = _contract(xT[0:3], var)
        xT = torch.cat([xyz, xT[3:]])

    def branch(x3, L, v3=None):
        sb = _sin_block(L)
        freqs = 2.0 ** torch.arange(L, dtype=x3.dtype, device=x3.device)
        ang = (x3[:, None, :] * freqs[None, :, None]).reshape(3 * L, -1)
        out = torch.zeros((_enc_rows(L), x3.shape[1]), dtype=x3.dtype, device=x3.device)
        out[0:3] = x3
        s, c = torch.sin(ang), torch.cos(ang)
        if v3 is not None:
            damp = torch.exp(-0.5 * (v3[:, None, :] * (freqs * freqs)[None, :, None]).reshape(3 * L, -1))
            s, c = s * damp, c * damp
        out[8 : 8 + 3 * L] = s
        out[8 + sb : 8 + sb + 3 * L] = c
        return out

    posx, posd = branch(xT[0:3], model.Lp, var), branch(xT[3:6], model.Ld)
    if enc_w is not None:
        posx, posd = posx * enc_w[0].to(posx.dtype)[:, None], posd * enc_w[1].to(posd.dtype)[:, None]
    if model.app_dim > 0:
        posd = torch.cat([posd, xT[8:16]])
    return posx, posd


def _contract(xyz: torch.Tensor, var: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The JAX kernel's contraction (``_encode``, kernels/mlp.py:437-456)
    of rows ``xyz (3, rows)``: ``n = sqrt(max(x0^2 + x1^2 + x2^2, 1e-20))``
    (summed in this order, as the CUDA encoder sums it), ``g = 1`` inside
    the unit ball and ``(2 - 1/n) / n`` outside; with ``var (3, rows)`` the
    linearised Gaussian warp of the variances at the uncontracted means:
    ``g^2 v + 2 g c m2 v + c^2 m2 (m2 . v)``, ``c = (-2/n^2 + 2/n^3) / n``
    outside (0 inside), ``m2 = xyz^2``. Inside the ball both are unchanged."""
    g, c = _contract_scales(xyz)
    if var is not None:
        m2 = xyz**2
        m2v = m2[0:1] * var[0:1] + m2[1:2] * var[1:2] + m2[2:3] * var[2:3]
        var = g**2 * var + 2.0 * g * c * m2 * var + c**2 * m2 * m2v
    return xyz * g, var


def _contract_scales(xyz: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``g`` and ``c`` of the contraction at ``xyz (3, rows)``, each (1,
    rows), from ``n = sqrt(max(x0^2 + x1^2 + x2^2, 1e-20))`` (summed in this
    order, as the CUDA kernels sum it): ``g = (2 - 1/n) / n`` and ``c =
    (-2/n^2 + 2/n^3) / n`` outside the unit ball, 1 and 0 inside."""
    n = torch.sqrt(torch.clamp(xyz[0:1] ** 2 + xyz[1:2] ** 2 + xyz[2:3] ** 2, min=1e-20))
    inside = n <= 1.0
    g = torch.where(inside, 1.0, (2.0 - 1.0 / n) / n)
    return g, torch.where(inside, 0.0, (-2.0 / (n * n) + 2.0 / (n * n * n)) / n)


def _contract_transpose(xyz: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The transpose of the contraction (without mip) at the uncontracted
    ``xyz (3, rows)``: the cotangent ``dy`` of the contracted rows -> that
    of ``xyz``, ``g dy + c (x . dy) x`` (its Jacobian ``g I + c x x^T`` is
    symmetric; ``_contract_scales``); ``dy`` inside the unit ball."""
    g, c = _contract_scales(xyz)
    return g * dy + c * (xyz * dy).sum(0, keepdim=True) * xyz


def _contract_transpose_mip(xyz: torch.Tensor, var: torch.Tensor, dy: torch.Tensor,
                            dvo: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The transpose of the contraction under mip (``_contract`` with the
    variances) at the uncontracted means ``xyz (3, rows)`` and variances
    ``var (3, rows)`` (the JAX ``_input_grad_tile_mip``'s contract branch,
    :1034-1064): the cotangents ``dy`` of the contracted means and ``dvo``
    of the contracted variances -> (d/d(mean), d/d(variance)). The warped
    variance ``g^2 v + 2 g c m2 v + c^2 m2 (m2 . v)``, ``m2 = xyz^2``,
    depends on the mean through n and m2, so d/d(mean) gains the variance
    transform's terms (``g' = c n``, ``c' = 6/n^4 - 8/n^5`` outside the
    unit ball, 0 inside; ``_contract_scales``); d/d(variance) is diagonal
    in ``dvo`` plus the rank-one ``c^2 m2 (m2 . dvo)``. Inside the ball
    ``(dy, dvo)``."""
    g, c = _contract_scales(xyz)
    n = torch.sqrt(torch.clamp(xyz[0:1] ** 2 + xyz[1:2] ** 2 + xyz[2:3] ** 2, min=1e-20))
    cp = torch.where(n <= 1.0, 0.0, 6.0 / n**4 - 8.0 / n**5)
    gp = c * n

    def dot(a, b):
        return (a * b).sum(0, keepdim=True)

    m2 = xyz**2
    m2v, Cv, A, Bv = dot(m2, var), dot(m2, dvo), dot(dvo, var), dot(dvo, m2 * var)
    dv = (g**2 + 2.0 * g * c * m2) * dvo + c**2 * m2 * Cv
    term_n = (2.0 * g * gp * A + 2.0 * (gp * c + g * cp) * Bv + 2.0 * c * cp * m2v * Cv) / n
    dmean = (g * dy + c * dot(xyz, dy) * xyz + term_n * xyz + (4.0 * g * c * var + 2.0 * c**2 * m2v) * xyz * dvo
             + 2.0 * c**2 * var * xyz * Cv)
    return dmean, dv


def _encode_transpose(xT: torch.Tensor, g_posx: torch.Tensor, g_posd: torch.Tensor,
                      model: NerfMLP, mip: bool = False) -> torch.Tensor:
    """The transpose of ``_encode`` (without windows) at the inputs ``xT``:
    the encoded rows' cotangents ``g_posx (FX, rows)`` and ``g_posd (FD,
    rows)`` -> ``dx (8, rows)``. A raw row passes through; a sin row of
    coordinate c at frequency 2^i adds ``2^i cos(2^i x_c)`` times its
    cotangent to x_c, a cos row ``-2^i sin(2^i x_c)``; posx feeds rows
    0..2, posd rows 3..5; rows 6..7 are zero (the JAX ``_input_grad_tile``
    without contraction). For an appearance model dx is (16, rows): posd's
    code rows pass their cotangents through to rows 8..15 (the JAX
    ``g_app``, appended at kernels/mlp.py:747-748). A contracted model's
    posx was encoded at the contracted rows (``_contract``): its transpose
    is taken there, and the contraction's at the uncontracted ``x``
    (``_contract_transpose``) takes it to rows 0..2 (the JAX
    ``_input_grad_tile``'s contract branch, :898-906, :933-938); posd and
    the code rows are not contracted.

    With ``mip`` (``xT`` (16, rows), the variances in rows 11..13), the
    integrated encoder's transpose (the JAX ``_input_grad_tile_mip``
    without contraction): posx's sin and cos rows were damped by ``damp =
    exp(-0.5 * 4^i * v_c)``, so their cotangents take the angle chain
    ``g * f'(ang) * damp`` into the mean, and the damp chain ``-0.5 * g *
    f(ang) * damp``, ``4^i`` times which goes to ``v_c``; posd is not
    damped. dx is (16, rows): rows 0..2 d/d(mean), 3..5 d/d(unit dir),
    11..13 d/d(variance), the rest zero. A contracted model under mip (the
    JAX ``_input_grad_tile_mip``'s contract branch, :972-983, :1034-1064)
    takes both chains at the contracted means and variances (``_contract``
    with the variances), then the warp's coupled transpose at the raw ones
    (``_contract_transpose_mip``)."""

    def branch(x3, g, L, v3=None):
        sb = _sin_block(L)
        freqs = 2.0 ** torch.arange(L, dtype=x3.dtype, device=x3.device)
        ang = (x3[:, None, :] * freqs[None, :, None]).reshape(3 * L, -1)
        gs, gc = g[8 : 8 + 3 * L], g[8 + sb : 8 + sb + 3 * L]
        s, c = torch.sin(ang), torch.cos(ang)
        dv = None
        if v3 is not None:  # both chains see the damped rows; the damp chain goes to v by 4^i
            f2 = (freqs * freqs)[None, :, None]
            damp = torch.exp(-0.5 * (v3[:, None, :] * f2).reshape(3 * L, -1))
            s, c = s * damp, c * damp
            dv = (-0.5 * (gs * s + gc * c)).reshape(3, L, -1).mul(f2).sum(1)
        dang = gs * c - gc * s
        return g[0:3] + (dang.reshape(3, L, -1) * freqs[None, :, None]).sum(1), dv

    FD0 = _enc_rows(model.Ld)
    dt = g_posx.dtype
    dx = torch.zeros((_x_rows(mip, model), xT.shape[1]), dtype=dt, device=xT.device)
    xyz = xT[0:3].to(dt)
    var = xT[11:14].to(dt) if mip else None
    if model.contract and mip:
        xc, vc = _contract(xyz, var)
        dx[0:3], dv = _contract_transpose_mip(xyz, var, *branch(xc, g_posx, model.Lp, vc))
    elif model.contract:
        dx[0:3] = _contract_transpose(xyz, branch(_contract(xyz, None)[0], g_posx, model.Lp)[0])
        dv = None
    else:
        dx[0:3], dv = branch(xyz, g_posx, model.Lp, var)
    dx[3:6] = branch(xT[3:6].to(g_posd.dtype), g_posd[:FD0], model.Ld)[0]
    if mip:
        dx[11:14] = dv
    if model.app_dim > 0:
        dx[8:16] = g_posd[FD0 : FD0 + 8]
    return dx


def _rnd(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to bf16 when that is the compute type, computed on in
    f32 (bf16 products are exact in f32). f32 and f64 pass through: the
    plain versions also run in f64, as a reference for both."""
    return x.to(dtype).float() if dtype == torch.bfloat16 else x


def _mm(a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """Both operands rounded to ``dtype``, products summed in f32 (f64 for
    f64 operands)."""
    return _rnd(a, dtype) @ _rnd(b, dtype)


class Layout(NamedTuple):
    """The backward's workspace (csrc/mlp_tile.cuh's ``Layout``): feature
    offsets of the residual planes (FA features: posx, posd, h0..h7, hc)
    and of the cotangent planes (FG: g_rgb8, g_cs = [g_hc ; g_sigma ; 0 x
    7], g_h7..g_h0), each plane ``(features, rows)``."""

    FX: int
    FD: int
    H: int

    @classmethod
    def of(cls, model: NerfMLP) -> "Layout":
        """An appearance model's posd plane has its eight code rows too."""
        return cls(_enc_rows(model.Lp), _posd_rows(model), model.H)

    posx = property(lambda s: 0)
    posd = property(lambda s: s.FX)
    hc = property(lambda s: s.FX + s.FD + 8 * s.H)
    FA = property(lambda s: s.FX + s.FD + 8 * s.H + s.H // 2)
    gr8 = property(lambda s: 0)
    gcs = property(lambda s: 8)
    FG = property(lambda s: 16 + s.H // 2 + 8 * s.H)

    def h(self, l: int) -> int:
        return self.FX + self.FD + l * self.H

    def gh(self, l: int) -> int:
        return 16 + self.H // 2 + (7 - l) * self.H


class WgradTask(NamedTuple):
    """One weight-gradient sum of the backward (csrc/mlp_tile.cuh::
    wgrad_tasks): the cotangent planes at gf (O features) against the
    residual planes at af (K features) give ``name``'s gradient, and with
    ``bias`` its bias's."""

    name: str
    gf: int
    O: int
    af: int
    K: int
    bias: bool


def wgrad_tasks(model: NerfMLP) -> list[WgradTask]:
    """The backward's twelve sums, in its order."""
    L, H, H2 = Layout.of(model), model.H, model.H // 2
    return [WgradTask("Wc1", L.gr8, 8, L.hc, H2, True), WgradTask("Wcd", L.gcs, H2, L.posd, L.FD, False),
            WgradTask("Wcs", L.gcs, H2 + 8, L.h(7), H, True), WgradTask("Wp1", L.gh(7), H, L.h(6), H, True),
            WgradTask("Wp0", L.gh(6), H, L.h(5), H, True), WgradTask("Wsh", L.gh(5), H, L.h(4), H, True),
            WgradTask("Wsx", L.gh(5), H, L.posx, L.FX, False), WgradTask("Wt4", L.gh(4), H, L.h(3), H, True),
            WgradTask("Wt3", L.gh(3), H, L.h(2), H, True), WgradTask("Wt2", L.gh(2), H, L.h(1), H, True),
            WgradTask("Wt1", L.gh(1), H, L.h(0), H, True), WgradTask("W1", L.gh(0), H, L.posx, L.FX, True)]


class Residuals(NamedTuple):
    """What the backward needs of the forward, ``(features, rows)``: the
    encoded inputs and every relu output."""

    posx: torch.Tensor
    posd: torch.Tensor
    h: tuple  # h0..h7, each (H, rows)
    hc: torch.Tensor

    @classmethod
    def of_planes(cls, res: torch.Tensor, model: NerfMLP) -> "Residuals":
        """Views of the workspace's residual planes ``res (FA, rows)``."""
        L = Layout.of(model)
        return cls(res[L.posx : L.posd], res[L.posd : L.h(0)],
                   tuple(res[L.h(l) : L.h(l) + L.H] for l in range(8)), res[L.hc : L.FA])


def _x_rows(mip: bool, model: NerfMLP = FLAGSHIP) -> int:
    """Rows of the kernels' sample input: 8, or 16 with ``mip``'s variances
    or an appearance model's codes (rows 8..15)."""
    return 16 if mip or model.app_dim > 0 else 8


def _forward(wts: FusedWeights, xT: torch.Tensor, dt, model: NerfMLP, mip: bool = False,
             enc_w: tuple | None = None):
    """The JAX ``_forward_tile``: (8, rows), or (16, rows) with ``mip``
    (variances in rows 11..13) or an appearance model (codes in rows
    8..15, read through posd and ``Wcd``'s code columns), -> (out (8,
    rows), Residuals); ``enc_w`` the anneal windows."""
    H2 = model.H // 2
    posx, posd = _encode(xT, model, xT[11:14] if mip else None, enc_w)

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
    mip: bool = False,
    enc_w: tuple | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: same weights, same
    numerics (the JAX ``_forward_tile``, with the anneal windows
    ``enc_w``), any device."""
    return _forward(wts, xT, compute_dtype, model, mip, enc_w)[0]


def weight_grad_plain(G: torch.Tensor, A: torch.Tensor, dt) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the weight-gradient sums: ``(G A^T, row sums of
    G)`` for planes ``G (O, rows)`` and ``A (K, rows)``, both operands
    rounded to ``dt`` and summed in f32 (the JAX ``mmT_acc`` and
    ``dbias``); the bias sums G as stored, rounded to ``dt``."""
    return _mm(G, A.T, dt), _rnd(G, dt).sum(1)


def _cotangents(wts: FusedWeights, res: Residuals, g_rgb: torch.Tensor, g_sig: torch.Tensor, dt):
    """The g_hc / g_cs / g_h chain of the JAX ``_backprop_tile``, from
    per-sample cotangents ``g_rgb (3, rows)`` and ``g_sig (rows,)``: (g8
    = [g_rgb ; 0 x 5], g_cs = [g_hc ; g_sig ; 0 x 7], [g_h0 .. g_h7]).
    Each is ``mask(h > 0) * W^T g`` of the layer above, both operands
    rounded to ``dt`` and summed in f32; it is left unrounded, since every
    use of it (a product, a sum, a plane) rounds it to ``dt``."""

    def back(W, g, act):  # mask(act) * W^T g
        return _mm(W.T, g, dt) * (act > 0)

    g8 = torch.zeros((8, g_rgb.shape[1]), dtype=g_rgb.dtype, device=g_rgb.device)
    g8[:3] = g_rgb
    g_hc = back(wts.Wc1, g8, res.hc)
    g_cs = torch.cat([g_hc, g_sig[None], torch.zeros_like(g8[:7])])
    g_h = [None] * 8
    g_h[7] = back(wts.Wcs, g_cs, res.h[7])
    for l, W in ((6, wts.Wp1), (5, wts.Wp0), (4, wts.Wsh), (3, wts.Wt4),
                 (2, wts.Wt3), (1, wts.Wt2), (0, wts.Wt1)):
        g_h[l] = back(W, g_h[l + 1], res.h[l])
    return g8, g_cs, g_h


def backward_tile_plain(
    wts: FusedWeights,
    res: torch.Tensor,
    g: torch.Tensor,
    compute_dtype=torch.bfloat16,
    model: NerfMLP = FLAGSHIP,
) -> torch.Tensor:
    """Plain version of the backward tile kernel: from the residual planes
    ``res (FA, Rp)`` of the workspace and the output cotangents ``g (>= 4,
    rows)`` (rows 0..2 d_rgb, row 3 d_sigma; rows <= Rp) to the cotangent
    planes ``(FG, Rp)`` (``Layout``) of the chain ``_cotangents``, each
    rounded once to ``compute_dtype`` and held in f32 (f64 for f64
    inputs, a reference). The chain runs over all Rp rows, so a row's
    planes do not depend on ``rows``; rows past ``rows`` get zero
    cotangents and are zero."""
    L, dt = Layout.of(model), compute_dtype
    ft = torch.float64 if torch.float64 in (res.dtype, g.dtype) else torch.float32
    g4 = torch.zeros((4, res.shape[1]), dtype=ft, device=res.device)
    g4[:, : g.shape[1]] = g[:4]
    g8, g_cs, g_h = _cotangents(wts, Residuals.of_planes(res, model), g4[:3], g4[3], dt)
    return _rnd(torch.cat([g8, g_cs, *g_h[::-1]]), dt)


def _backprop(wts: FusedWeights, res: Residuals, g_rgb: torch.Tensor,
              g_sig: torch.Tensor, dt, model: NerfMLP, want_pos: bool = False):
    """The JAX ``_backprop_tile`` from per-sample cotangents ``g_rgb (3,
    rows)`` and ``g_sig (rows,)`` to packed-layout f32 gradients, summed
    over rows: the chain ``_cotangents`` (what ``backward_tile_plain``
    lays out as planes), then the twelve weight-gradient sums. Rounding
    as the kernels round: both operands of every product to ``dt``, f32
    sums; the relu mask from the residual; a bias gradient is the row sum
    of the cotangent as stored (rounded to ``dt``). The TPU kernel took
    three bias sums (b1, bs, the colour half of bcs) from a rail column of
    rounded cotangents and the others from f32 ones; at f32 the two
    agree. With ``want_pos`` also the cotangent planes the input gradient
    reads, ``(g_h0, g_h5, g_hc)``."""
    h = res.h
    g8, g_cs, g_h = _cotangents(wts, res, g_rgb, g_sig, dt)
    g_hc = g_cs[: model.H // 2]

    def sums(g, act):  # the kernels' twelve weight-gradient sums: (dW, db (O, 1))
        dW, db = weight_grad_plain(g, act, dt)
        return dW, db[:, None]

    (W1, b1), (Wt1, bt1), (Wt2, bt2), (Wt3, bt3), (Wt4, bt4) = (
        sums(g_h[0], res.posx), sums(g_h[1], h[0]), sums(g_h[2], h[1]),
        sums(g_h[3], h[2]), sums(g_h[4], h[3]))
    (Wsh, bs), (Wp0, bp0), (Wp1, bp1) = sums(g_h[5], h[4]), sums(g_h[6], h[5]), sums(g_h[7], h[6])
    (Wcs, bcs), (Wc1, bc1) = sums(g_cs, h[7]), sums(g8, res.hc)
    grads = FusedWeights(
        W1=W1, b1=b1, Wt1=Wt1, bt1=bt1, Wt2=Wt2, bt2=bt2, Wt3=Wt3, bt3=bt3,
        Wt4=Wt4, bt4=bt4, Wsh=Wsh, Wsx=sums(g_h[5], res.posx)[0], bs=bs,
        Wp0=Wp0, bp0=bp0, Wp1=Wp1, bp1=bp1, Wcs=Wcs, bcs=bcs,
        Wcd=sums(g_hc, res.posd)[0], Wc1=Wc1, bc1=bc1,
    )
    return (grads, (g_h[0], g_h[5], g_hc)) if want_pos else grads


def _input_grad(wts: FusedWeights, xT: torch.Tensor, g_h0: torch.Tensor, g_h5: torch.Tensor,
                g_hc: torch.Tensor, dt, model: NerfMLP, enc_w: tuple | None = None,
                mip: bool = False) -> torch.Tensor:
    """The JAX ``_bwd_kernel``'s ``want_dx`` branch from the cotangent
    planes (rows, as stored) of the first layer ``g_h0``, the skip layer
    ``g_h5`` and the colour head ``g_hc``: the encoded inputs' cotangents
    ``g_posx = W1^T g_h0 + Wsx^T g_h5`` and ``g_posd = Wcd^T g_hc`` (both
    operands rounded to ``dt``, f32 sums: the JAX ``mTg``; for an
    appearance model its last eight rows are ``g_app = Wca^T g_hc``), the
    encoded rows times the anneal windows, then the encoder's transpose in
    f32 (f64 for f64 planes) -> ``dx (8, rows)``, or (16, rows) with the
    codes' cotangents in rows 8..15; with ``mip`` the integrated encoder's
    transpose, dx (16, rows) (``_encode_transpose``)."""
    g_posx = _mm(wts.W1.T, g_h0, dt) + _mm(wts.Wsx.T, g_h5, dt)
    g_posd = _mm(wts.Wcd.T, g_hc, dt)
    if enc_w is not None:
        wd = torch.ones(g_posd.shape[0], dtype=g_posd.dtype, device=g_posd.device)
        wd[: enc_w[1].shape[0]] = enc_w[1]
        g_posx, g_posd = g_posx * enc_w[0].to(g_posx.dtype)[:, None], g_posd * wd[:, None]
    return _encode_transpose(xT, g_posx, g_posd, model, mip)


def input_grad_plain(
    wts: FusedWeights,
    xT: torch.Tensor,
    gws: torch.Tensor,
    compute_dtype=torch.bfloat16,
    model: NerfMLP = FLAGSHIP,
    enc_w: tuple | None = None,
    mip: bool = False,
) -> torch.Tensor:
    """Plain version of the input-gradient kernel (see ``input_grad``):
    from the backward's cotangent planes ``gws (FG, Rp)`` (``Layout``; as
    ``backward_tile`` gives them) and the inputs ``xT (8, rows)`` to ``dx
    (8, rows)`` (for an appearance model both 16 rows, dx's rows 8..15 the
    codes'; with ``mip`` both 16 rows, the integrated encoder's
    transpose), f32 (f64 for f64 planes, a reference)."""
    L, rows = Layout.of(model), xT.shape[1]
    g = gws[:, :rows]
    dx = _input_grad(wts, xT, g[L.gh(0) : L.gh(0) + L.H], g[L.gh(5) : L.gh(5) + L.H],
                     g[L.gcs : L.gcs + L.H // 2], compute_dtype, model, enc_w, mip)
    return dx if gws.dtype == torch.float64 else dx.float()


def fused_mlp_backward_plain(
    wts: FusedWeights,
    xT: torch.Tensor,
    gT: torch.Tensor,
    compute_dtype=torch.bfloat16,
    model: NerfMLP = FLAGSHIP,
    mip: bool = False,
    want_dx: bool = False,
    enc_w: tuple | None = None,
):
    """Plain PyTorch version of the backward kernel: ``gT (8, rows)`` with
    d_rgb in rows 0..2 and d_sigma in row 3 -> packed f32 gradients, and
    with ``want_dx`` ``(grads, dx (8, rows))`` (16 rows for an appearance
    model and under ``mip``); the forward it recomputes with the anneal
    windows ``enc_w``."""
    _, res = _forward(wts, xT, compute_dtype, model, mip, enc_w)
    out = _backprop(wts, res, gT[:3], gT[3], compute_dtype, model, want_pos=want_dx)
    if not want_dx:
        return out
    grads, (g_h0, g_h5, g_hc) = out
    return grads, _input_grad(wts, xT, g_h0, g_h5, g_hc, compute_dtype, model, enc_w, mip)


def _point_deltas(ts: torch.Tensor) -> torch.Tensor:
    """The deltas of point compositing at (B, N) ts: t[k+1] - t[k], 1e10
    for the last sample."""
    return torch.cat([ts[:, 1:] - ts[:, :-1], torch.full_like(ts[:, :1], 1e10)], dim=1)


def _transmittance(sig: torch.Tensor, delta: torch.Tensor):
    """Compositing of (B, N) raw sigma over (B, N) ``delta``, as the TPU
    kernels composite: (delta, e = exp(-softplus(sigma) delta), alpha = 1
    - e, m = max(1 - alpha, 1e-10), T = exp of the exclusive cumsum of
    log m)."""
    e = torch.exp(-torch.nn.functional.softplus(sig) * delta)
    alpha = 1.0 - e
    m = torch.clamp(1.0 - alpha, min=1e-10)
    logm = torch.log(m)
    return delta, e, alpha, m, torch.exp(torch.cumsum(logm, dim=1) - logm)


def _distortion_rail(w: torch.Tensor, s: torch.Tensor, d_s: torch.Tensor | None = None,
                     drop_tail: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """The distortion of each ray, ``(B,)``, and its gradient in the (B, N)
    weights ``w`` at sorted positions ``s`` with widths ``d_s``. Point
    form (``d_s`` None): ``d_s`` is the gap to the next sample, 0 at the
    tail. Interval form: ``s`` the interval midpoints and ``d_s`` their
    widths. With ``drop_tail`` the tail's weight is dropped (``wm``) and
    its width is 0; the prefix sums A, Bm of wm and wm * s and their
    suffix sums give the cross term and its gradient in O(N). With
    ``drop_tail`` the gradient is exactly 0 at the tail, whose weight the
    loss does not read."""
    if d_s is None:
        d_s = torch.cat([s[:, 1:] - s[:, :-1], torch.zeros_like(s[:, :1])], 1)
    wm = w
    if drop_tail:
        wm = torch.cat([w[:, :-1], torch.zeros_like(w[:, :1])], 1)
        d_s = torch.cat([d_s[:, :-1], torch.zeros_like(d_s[:, :1])], 1)
    wms = wm * s
    A_in, Bm_in = torch.cumsum(wm, 1), torch.cumsum(wms, 1)
    cross = s * (A_in - wm) - (Bm_in - wms)  # exclusive prefixes
    SA = wm.sum(1, keepdim=True) - A_in  # suffix sums (j > k)
    SBm = wms.sum(1, keepdim=True) - Bm_in
    dist_ray = (wm * (2.0 * cross) + wm * wm * d_s / 3.0).sum(1)
    d_w = 2.0 * (cross + SBm - s * SA) + (2.0 / 3.0) * wm * d_s
    if drop_tail:
        d_w = torch.cat([d_w[:, :-1], torch.zeros_like(d_w[:, :1])], 1)
    return dist_ray, d_w


def _composite_grad(out8: torch.Tensor, x16: torch.Tensor, N: int, dist: tuple | None = None,
                    mip: bool = False, opaque_tail: bool = False):
    """The JAX ``_composite_grad_block``: per-sample raw rgb and sigma
    ``out8`` (8, B*N) and ``x16`` -> (per-ray loss (B,), d_rgb per sample
    (3, B*N), d_sigma per sample (B*N,), the compositing weights (B, N)).
    The loss is sum_c (rgb_ray - gt)^2 / (3B) summed over rays.

    Point form: the deltas are the gaps of the ts in row 6, 1e10 for the
    last sample. Interval form (``mip``): row 6 holds the interval widths,
    composited as they are (with ``opaque_tail``, the last one is 1e10),
    and each ray's loss is weighted by its row 14.

    ``dist = (d_scale, tn, tf, disparity)`` adds the distortion rail:
    ``d_scale`` times the distortion of each ray in s-space, and its
    gradient to d_w. Point form (``ops/volume.py::distortion_loss`` before
    its mean): at the ts, the tail sample dropped, the gap to the next
    sample 0 there, the gradient exactly 0 at the tail. Interval form
    (``distortion_loss_intervals``): at the midpoints of s(t0) and s(t0 +
    width), t0 from row 7, on the s-widths; the tail is dropped only under
    ``opaque_tail``."""
    B = out8.shape[1] // N
    scale = 1.0 / (3.0 * B)
    rgb = out8[:3].reshape(3, B, N)
    sig = out8[3].reshape(B, N)
    gt = x16[8:11].reshape(3, B, N)[:, :, 0]
    row6 = x16[6].reshape(B, N)
    if mip:
        delta = row6
        if opaque_tail:
            delta = torch.cat([row6[:, :-1], torch.full_like(row6[:, :1], 1e10)], dim=1)
    else:
        delta = _point_deltas(row6)
    delta, e, alpha, m, T = _transmittance(sig, delta)
    w = alpha * T
    err = (w[None] * rgb).sum(-1) - gt  # (3, B)
    if mip:
        lw = x16[14].reshape(B, N)[:, 0]
        loss_ray = (lw * err * err).sum(0) * scale
        d_rgb = 2.0 * scale * lw * err
    else:
        loss_ray = (err * err).sum(0) * scale
        d_rgb = 2.0 * scale * err
    d_w = (rgb * d_rgb[:, :, None]).sum(0)
    if dist is not None:
        d_scale, tn, tf, disparity = dist
        if mip:
            t0 = x16[7].reshape(B, N)
            s0, s1 = s_norm(t0, tn, tf, disparity), s_norm(t0 + row6, tn, tf, disparity)
            dist_ray, d_w_dist = _distortion_rail(w, 0.5 * (s0 + s1), s1 - s0, drop_tail=opaque_tail)
        else:
            dist_ray, d_w_dist = _distortion_rail(w, s_norm(row6, tn, tf, disparity))
        loss_ray = loss_ray + d_scale * dist_ray
        d_w = d_w + d_scale * d_w_dist
    y = d_w * w
    suffix = y.sum(1, keepdim=True) - torch.cumsum(y, dim=1)
    d_alpha = d_w * T - torch.where(1.0 - alpha > 1e-10, suffix / m, 0.0)
    d_sig = d_alpha * e * delta * torch.sigmoid(sig)
    return loss_ray, (w[None] * d_rgb[:, :, None]).reshape(3, -1), d_sig.reshape(-1), w


def _dist_rail(dist: tuple | None, B: int) -> tuple | None:
    """``dist = (weight, tn, tf, disparity)`` of ``fused_train_step`` ->
    the rail's ``(weight / B, tn, tf, disparity)``: the loss is a mean
    over rays, the rail sums them (JAX kernels/mlp.py:1619-1622)."""
    if dist is None:
        return None
    weight, tn, tf, disparity = dist
    if not weight >= 0 or not tf > tn or (disparity and not tn > 0):
        raise ValueError(f"dist needs weight >= 0, tf > tn, and tn > 0 in disparity space; got {dist}")
    return (float(weight) / B, float(tn), float(tf), bool(disparity))


def fused_train_step_plain(
    wts: FusedWeights,
    x16: torch.Tensor,
    N: int,
    compute_dtype=torch.bfloat16,
    model: NerfMLP = FLAGSHIP,
    out_weights: bool = False,
    dist: tuple | None = None,
    mip: bool = False,
    opaque_tail: bool = False,
):
    """Plain PyTorch version of the train-step kernel: (loss, packed f32
    gradients[, the compositing weights (B, N) with ``out_weights``]) for
    ``x16 (16, B*N)`` (see ``fused_train_step``; ``dist``, ``mip`` and
    ``opaque_tail`` as it takes them)."""
    out8, res = _forward(wts, x16 if mip else x16[:8], compute_dtype, model, mip)
    loss_ray, g_rgb, g_sig, w = _composite_grad(out8, x16, N, _dist_rail(dist, x16.shape[1] // N), mip,
                                                opaque_tail)
    grads = _backprop(wts, res, g_rgb, g_sig, compute_dtype, model)
    return (loss_ray.sum(), grads, w) if out_weights else (loss_ray.sum(), grads)


def fused_render_plain(
    wts: FusedWeights,
    x16: torch.Tensor,
    N: int,
    compute_dtype=torch.bfloat16,
    model: NerfMLP = FLAGSHIP,
) -> torch.Tensor:
    """Plain PyTorch version of the render kernel (see ``fused_render``):
    the forward, then f32 compositing of whole rays."""
    out8 = _forward(wts, x16[:8], compute_dtype, model)[0]
    B = out8.shape[1] // N
    ts = x16[6].reshape(B, N)
    _, _, alpha, _, T = _transmittance(out8[3].reshape(B, N), _point_deltas(ts))
    w = alpha * T
    out = torch.zeros((8, B, N), dtype=out8.dtype, device=out8.device)
    out[:3, :, 0] = (w[None] * out8[:3].reshape(3, B, N)).sum(-1)
    out[3, :, 0] = (w * ts).sum(-1)
    out[4, :, 0] = w.sum(-1)
    return out.reshape(8, B * N)


# --- the CUDA wrappers --------------------------------------------------------

class _CPtrs(ctypes.Structure):
    """The C ``Weights`` and ``Grads`` structs: one pointer a field."""

    _fields_ = [(name, ctypes.c_void_p) for name in FusedWeights._fields]


_TRANSPOSED = ("Wc1", "Wcs", "Wp1", "Wp0", "Wsh", "Wt4", "Wt3", "Wt2", "Wt1")


class _CWeightsT(ctypes.Structure):
    _fields_ = [(f"{name}T", ctypes.c_void_p) for name in _TRANSPOSED]


_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {  # source -> {entry: (argtypes, restype)}
    "fused_mlp_fwd": {
        "fused_mlp_fwd": ([_P, _P, _LL, _I, _I, _I, _I, _CPtrs, _P, _I, _P, _P, _I, _I, _P], _I),
        "fused_mlp_fwd_smem_bytes": ([_I] * 5, _LL),
        "fused_mlp_fwd_image_bytes": ([_I] * 5, _LL),
        "fwd_weight_image": ([_CPtrs, _I, _I, _I, _I, _P, _I, _P], _I),
        "fused_mlp_fwd_residuals": ([_P, _P, _LL, _I, _I, _I, _I, _CPtrs, _P, _P, _I, _P, _P, _I, _I, _P], _I),
        "set_contract_forward": ([_P], None),
    },
    "fused_mlp_bwd": {
        "fused_mlp_bwd": ([_P, _P, _LL, _I, _I, _I, _I, _CPtrs, _CWeightsT, _P, _CPtrs, _I, _P, _P, _P, _I, _I,
                           _P], _I),
        "set_contract_forward": ([_P], None),
        "set_contract_input_grad": ([_P], None),
        "input_grad": ([_P, _P, _LL, _I, _I, _I, _I, _CPtrs, _P, _P, _P, _I, _I, _I, _P], _I),
        "input_grad_launch_count": ([_I], _LL),
        "input_grad_mip_launch_count": ([_I], _LL),
        "input_grad_f32_launch_count": ([_I], _LL),
        "fused_mlp_bwd_smem_bytes": ([_I] * 5, _LL),
        "fused_mlp_bwd_workspace_bytes": ([_LL, _I, _I, _I, _I, _I], _LL),
        "wgrad_sums": ([_P, _I, _P, _I, _LL, _I, _P, _P, _P, _P], _I),
        "wgrad_part_bytes": ([_I, _I, _LL, _I], _LL),
        "wgrad_group": ([_P, _I, _LL, _I, _P, _P], _I),
        "wgrad_group_part_bytes": ([_P, _I, _LL, _I], _LL),
        "wgrad_launch_count": ([_I], _LL),
        "bwd_tile_launch_count": ([_I], _LL),
        "bwd_tile_image_bytes": ([_I, _I], _LL),
        "backward_tile": ([_P, _LL, _I, _I, _I, _I, _CPtrs, _CWeightsT, _P, _P, _P, _I, _P], _I),
        "bwd_weight_image": ([_CPtrs, _I, _I, _P, _P], _I),
    },
    "fused_render": {
        "fused_render": ([_P, _P, _LL, _I, _I, _I, _I, _I, _CPtrs, _P, _I, _P], _I),
        "set_contract_forward": ([_P], None),
        "fused_render_smem_bytes": ([_I] * 4, _LL),
        "fused_render_image_bytes": ([_I] * 4, _LL),
    },
    "fused_train_step": {
        "fused_train_step": ([_P, _LL, _I, _I, _I, _I, _I, _CPtrs, _CWeightsT, _P, _P, _CPtrs, _P,
                              _I, _F, _F, _F, _I, _I, _I, _I, _P], _I),
        "set_contract_forward": ([_P], None),
        "fused_train_step_smem_bytes": ([_I] * 4, _LL),
        "fused_train_step_workspace_bytes": ([_LL, _I, _I, _I, _I, _I], _LL),
        "wgrad_launch_count": ([_I], _LL),
        "bwd_tile_launch_count": ([_I], _LL),
    },
    "fused_contract": {
        "fused_contract_fwd": ([_P, _P, _LL, _I, _I, _I, _I, _CPtrs, _P, _P, _I, _P, _P, _I, _P], _I),
        "fwd_contract_launch_count": ([_I], _LL),
        "fused_contract_input_grad": ([_P, _P, _LL, _I, _I, _I, _I, _CPtrs, _P, _P, _P, _I, _I, _P], _I),
        "input_grad_contract_launch_count": ([_I], _LL),
        "input_grad_mip_contract_launch_count": ([_I], _LL),
        "input_grad_contract_f32_launch_count": ([_I], _LL),
    },
}
SOURCES = tuple(_SIGNATURES)


def _bind(lib: ctypes.CDLL, name: str, entries=None) -> ctypes.CDLL:
    """Give the entries (all of source ``name``'s by default) of a library
    of that source their C signatures."""
    for entry in entries or _SIGNATURES[name]:
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = _SIGNATURES[name][entry]
    return lib


def _lib(name: str) -> ctypes.CDLL:
    return _bind(_build.load(name), name)


def _link_contract(lib: ctypes.CDLL, name: str) -> None:
    """Hand library ``name`` the contracted forward (csrc/fused_contract.cu,
    a library of its own: mlp_tile.cuh's forward_contract) and, B2's, the
    input gradient's contract instantiation (input_grad.cuh's
    contract_input_grad), building it first if it is not built."""
    contracted = _lib("fused_contract")
    lib.set_contract_forward(ctypes.cast(contracted.fused_contract_fwd, ctypes.c_void_p).value)
    if "set_contract_input_grad" in _SIGNATURES[name]:
        lib.set_contract_input_grad(ctypes.cast(contracted.fused_contract_input_grad, ctypes.c_void_p).value)


def _weight_shapes(model: NerfMLP) -> dict[str, tuple[int, int]]:
    H, H2 = model.H, model.H // 2
    FX, FD = _enc_rows(model.Lp), _posd_rows(model)
    shapes = dict(W1=(H, FX), Wsh=(H, H), Wsx=(H, FX), Wcs=(H2 + 8, H),
                  bcs=(H2 + 8, 1), Wcd=(H2, FD), Wc1=(8, H2), bc1=(8, 1))
    for n in ("t1", "t2", "t3", "t4", "p0", "p1"):
        shapes[f"W{n}"], shapes[f"b{n}"] = (H, H), (H, 1)
    shapes["b1"] = shapes["bs"] = (H, 1)
    return shapes


def _check_launch(name: str, wts: FusedWeights, x: torch.Tensor, x_name: str, x_rows: int,
                  compute_dtype, model: NerfMLP) -> tuple[ctypes.CDLL, int]:
    """Raise on what the kernels do not take (``x`` must have ``x_rows``
    rows: 16 for the train step, under mip and for an appearance model,
    else 8); returns the library and the bf16 flag."""
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
    if model.contract:
        _link_contract(lib, name)
    bf16 = int(compute_dtype == torch.bfloat16)
    app = (int(model.app_dim > 0),) if name in ("fused_mlp_fwd", "fused_mlp_bwd") else ()
    smem = getattr(lib, f"{name}_smem_bytes")(model.Lp, model.Ld, model.H, bf16, *app)
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


def _image_scratch(nbytes, model: NerfMLP, bf16: int, device, *app) -> torch.Tensor:
    """Scratch for the forward's weight image of the compute type (``app``:
    the appearance flag, for the entries that take it)."""
    return torch.empty(nbytes(model.Lp, model.Ld, model.H, bf16, *app), dtype=torch.uint8, device=device)


def _prepare(wts: FusedWeights, compute_dtype, model: NerfMLP, mip: bool = False) -> FusedWeights:
    if not supported(model):
        raise ValueError(f"fused kernel needs H % 16 == 0, H >= 16, app_dim <= 8; got {model}")
    if mip and model.app_dim > 0:
        raise ValueError("appearance codes and the integrated encoder both need the input's rows 8..15 "
                         "(the JAX fused_mlp_forward's rule); mip with appearance_dim is refused")
    return _cast_weights(wts, compute_dtype)


def _app(model: NerfMLP) -> int:
    """The C entries' appearance flag."""
    return int(model.app_dim > 0)


def _enc_w_ptrs(enc_w: tuple | None, model: NerfMLP, device, mip: bool = False):
    """Check the anneal windows ``enc_w = (wx (FX,), wd (enc_rows(Ld),))``
    (contiguous f32 on ``device``, as ``anneal_row_weights`` makes them;
    an appearance model's code rows take none); returns their
    pointers, or (None, None) without windows. The cone-cast encoder takes
    no windows (the JAX config's rule, config.py:627-631)."""
    if mip and enc_w is not None:
        raise ValueError("the anneal windows are not plumbed through the integrated encoder (mip), as in JAX "
                         "(config.py:627-631: pe_anneal_until with mip raises)")
    if enc_w is None:
        return None, None
    for name, t, n in zip(("wx", "wd"), enc_w, (_enc_rows(model.Lp), _enc_rows(model.Ld))):
        if t.dtype != torch.float32 or tuple(t.shape) != (n,) or t.device != device or not t.is_contiguous():
            raise ValueError(f"enc_w's {name} must be a contiguous ({n},) f32 tensor on {device}; got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    return tuple(t.data_ptr() for t in enc_w)


INPUT_GRAD_MAX_L = (10, 4)  # octaves of posx and posd the input-gradient kernel holds (the flagship's)


def _check_input_grad_arch(model: NerfMLP) -> None:
    if model.Lp > INPUT_GRAD_MAX_L[0] or model.Ld > INPUT_GRAD_MAX_L[1]:
        raise ValueError(f"the input-gradient kernel holds Lp <= {INPUT_GRAD_MAX_L[0]} and Ld <= "
                         f"{INPUT_GRAD_MAX_L[1]}; got {model}")


def fused_mlp_forward(
    wts: FusedWeights,
    xT: torch.Tensor,
    compute_dtype=torch.bfloat16,
    model: NerfMLP = FLAGSHIP,
    mip: bool = False,
    enc_w: tuple | None = None,
) -> torch.Tensor:
    """Fused MLP forward: ``xT (8, rows)`` f32 -> ``(8, rows)`` f32, raw
    rgb in rows 0..2, raw sigma in row 3, zeros in rows 4..7. ``rows``
    may be any count (the kernel masks the ragged tile). With ``mip``,
    ``xT`` is (16, rows): the frustum Gaussians' means in rows 0..2, unit
    dirs 3..5, diagonal variances 11..13, read by the integrated encoder;
    ``fused_mlp_forward.mip_launches`` counts those launches. For an
    appearance model (``model.app_dim > 0``; not with ``mip``) ``xT`` is
    (16, rows) with each sample's code in rows 8..15 (``app_dim`` rows,
    zeros after); ``fused_mlp_forward.app_launches`` counts those
    launches. ``enc_w = (wx, wd)`` (``anneal_row_weights``, on the input's
    device) multiplies each encoded row by its anneal window;
    ``fused_mlp_forward.anneal_launches`` counts those launches. A
    contracted model's launches (``contract_launches``) run the encoder's
    contraction (point and mip)."""
    wts = _prepare(wts, compute_dtype, model, mip)
    wx, wd = _enc_w_ptrs(enc_w, model, xT.device, mip)
    if _dispatch(xT):
        return fused_mlp_forward_plain(wts, xT, compute_dtype, model, mip, enc_w)
    lib, bf16 = _check_launch("fused_mlp_fwd", wts, xT, "xT", _x_rows(mip, model), compute_dtype, model)
    out = torch.empty((8, xT.shape[1]), dtype=torch.float32, device=xT.device)
    image = _image_scratch(lib.fused_mlp_fwd_image_bytes, model, bf16, xT.device, _app(model))
    _raise_on(lib.fused_mlp_fwd(
        xT.data_ptr(), out.data_ptr(), xT.shape[1], model.Lp, model.Ld, model.H, bf16,
        _CPtrs(*_ptrs(wts)), image.data_ptr(), int(mip), wx, wd, _app(model), int(model.contract), _stream(xT),
    ), "fused_mlp_fwd")
    fused_mlp_forward.launches += 1
    fused_mlp_forward.contract_launches += model.contract
    fused_mlp_forward.mip_launches += mip
    fused_mlp_forward.anneal_launches += enc_w is not None
    fused_mlp_forward.app_launches += _app(model)
    return out


fused_mlp_forward.launches = 0
fused_mlp_forward.mip_launches = 0  # of them, with the integrated encoder
fused_mlp_forward.anneal_launches = 0  # of them, with the anneal windows
fused_mlp_forward.app_launches = 0  # of them, an appearance model's (the code rows)
fused_mlp_forward.contract_launches = 0  # of them, a contracted model's


def forward_residuals_plain(
    wts: FusedWeights,
    xT: torch.Tensor,
    compute_dtype=torch.bfloat16,
    model: NerfMLP = FLAGSHIP,
    mip: bool = False,
    enc_w: tuple | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``forward_residuals``: ``_forward``'s output and
    its residuals laid out as the workspace's planes ``(FA, Rp)``
    (``Layout``), rounded to ``compute_dtype`` and held in f32. Pad rows
    (past ``rows``) are zero here; the kernel writes the residuals of a
    zero input there."""
    out, r = _forward(wts, xT, compute_dtype, model, mip, enc_w)
    L, rows = Layout.of(model), xT.shape[1]
    res = torch.zeros((L.FA, -(-rows // 64) * 64), dtype=out.dtype, device=xT.device)
    res[:, :rows] = _rnd(torch.cat([r.posx, r.posd, *r.h, r.hc]), compute_dtype)
    return out, res


def forward_residuals(
    wts: FusedWeights,
    xT: torch.Tensor,
    compute_dtype=torch.bfloat16,
    model: NerfMLP = FLAGSHIP,
    mip: bool = False,
    enc_w: tuple | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward tile kernel as B1 and B2 run it, keeping every residual:
    ``(out (8, rows) f32, res (FA, Rp))``, the planes of ``Layout`` (posx,
    posd, h0..h7, hc) in the compute dtype, Rp = rows rounded up to 64;
    ``xT`` and ``enc_w`` as ``fused_mlp_forward`` takes them (with ``mip``,
    posx is the damped encoding; with ``enc_w``, the windowed one; for an
    appearance model posd's plane ends with the code rows).
    ``forward_residuals.launches`` counts its launches."""
    wts = _prepare(wts, compute_dtype, model, mip)
    wx, wd = _enc_w_ptrs(enc_w, model, xT.device, mip)
    if _dispatch(xT):
        return forward_residuals_plain(wts, xT, compute_dtype, model, mip, enc_w)
    lib, bf16 = _check_launch("fused_mlp_fwd", wts, xT, "xT", _x_rows(mip, model), compute_dtype, model)
    rows = xT.shape[1]
    out = torch.empty((8, rows), dtype=torch.float32, device=xT.device)
    res = torch.empty((Layout.of(model).FA, -(-rows // 64) * 64), dtype=compute_dtype, device=xT.device)
    image = _image_scratch(lib.fused_mlp_fwd_image_bytes, model, bf16, xT.device, _app(model))
    _raise_on(lib.fused_mlp_fwd_residuals(
        xT.data_ptr(), out.data_ptr(), rows, model.Lp, model.Ld, model.H, bf16,
        _CPtrs(*_ptrs(wts)), res.data_ptr(), image.data_ptr(), int(mip), wx, wd, _app(model), int(model.contract),
        _stream(xT),
    ), "fused_mlp_fwd_residuals")
    forward_residuals.launches += 1
    return out, res


forward_residuals.launches = 0


def _transposed(wts: FusedWeights) -> _CWeightsT:
    """The backward's transposed matrices, for earlier libraries whose f32
    backward read them (chip_smoke.py's ``--before``); the tensors ride on
    the struct so they live as long as the launch arguments."""
    ts = [getattr(wts, n).t().contiguous() for n in _TRANSPOSED]
    st = _CWeightsT(*_ptrs(ts))
    st.keep = ts
    return st


def _weights_t(wts: FusedWeights) -> _CWeightsT:
    """What the training entries get for their transposes (the C
    ``WeightsT``): null pointers. Both backward tile kernels transpose into
    their weight images from the packed matrices, so no copies are made;
    an earlier library gets ``_transposed`` here instead."""
    return _CWeightsT()


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
    mip: bool = False,
    want_dx: bool = False,
    enc_w: tuple | None = None,
):
    """Fused MLP backward: the packed f32 weight gradients of
    sum(out * gT) for ``out = fused_mlp_forward(wts, xT, mip=mip,
    enc_w=enc_w)``, with ``gT (8, rows)`` f32 (rows 0..2 d_rgb, row 3
    d_sigma, rows 4..7 not read). With ``mip`` the forward it recomputes
    is the integrated encoder's (``fused_mlp_backward.mip_launches``),
    with ``enc_w`` the windowed one (``anneal_launches``), for an
    appearance model the one with the codes of ``xT``'s rows 8..15
    (``app_launches``; ``Wcd``'s last eight columns are then ``dWca``).
    With ``want_dx`` it returns ``(grads, dx)``: ``dx (8, rows)`` f32 is
    the gradient of that sum in ``xT`` (rows 0..5; rows 6..7 zero; for an
    appearance model (16, rows), rows 8..15 the codes'; under ``mip`` (16,
    rows): rows 0..2 d/d(mean), 3..5 d/d(unit dir), 11..13 d/d(variance),
    the rest zero), which the input-gradient kernel (csrc/input_grad.cuh,
    its mip instantiation under ``mip``) computes after the weight
    gradients from the backward's cotangent planes
    (``fused_mlp_backward.dx_launches``, of them ``mip_dx_launches``); the
    windows get no gradient. A contracted model recomputes the contracted
    forward (``contract_launches``), and its dx is the input-gradient
    kernel's contract instantiation (csrc/fused_contract.cu,
    ``input_grad_contract_launches``), under mip its ``MIP && CONTRACT``
    one (``input_grad_mip_contract_launches``)."""
    wts = _prepare(wts, compute_dtype, model, mip)
    wx, wd = _enc_w_ptrs(enc_w, model, xT.device, mip)
    if _dispatch(xT):
        with torch.no_grad():
            return fused_mlp_backward_plain(wts, xT, gT, compute_dtype, model, mip, want_dx, enc_w)
    lib, bf16 = _check_launch("fused_mlp_bwd", wts, xT, "xT", _x_rows(mip, model), compute_dtype, model)
    if want_dx:
        _check_input_grad_arch(model)
    if (gT.shape != (8, xT.shape[1]) or gT.dtype != torch.float32 or gT.device != xT.device
            or not gT.is_contiguous()):
        raise ValueError(f"gT must be a contiguous (8, {xT.shape[1]}) f32 tensor on {xT.device}")
    rows = xT.shape[1]
    if rows == 0:
        raise ValueError("fused_mlp_backward needs at least one row")
    ws = torch.empty(lib.fused_mlp_bwd_workspace_bytes(rows, model.Lp, model.Ld, model.H, bf16, _app(model)),
                     dtype=torch.uint8, device=xT.device)
    grads = _empty_grads(model, xT.device)
    dx = torch.empty((_x_rows(mip, model), rows), dtype=torch.float32, device=xT.device) if want_dx else None
    _raise_on(lib.fused_mlp_bwd(
        xT.data_ptr(), gT.data_ptr(), rows, model.Lp, model.Ld, model.H, bf16,
        _CPtrs(*_ptrs(wts)), _weights_t(wts), ws.data_ptr(), _CPtrs(*_ptrs(grads)),
        int(mip), wx, wd, None if dx is None else dx.data_ptr(), _app(model), int(model.contract), _stream(xT),
    ), "fused_mlp_bwd")
    fused_mlp_backward.launches += 1
    fused_mlp_backward.mip_launches += mip
    fused_mlp_backward.dx_launches += want_dx
    fused_mlp_backward.mip_dx_launches += mip and want_dx
    fused_mlp_backward.anneal_launches += enc_w is not None
    fused_mlp_backward.app_launches += _app(model)
    fused_mlp_backward.contract_launches += model.contract
    return (grads, dx) if want_dx else grads


fused_mlp_backward.launches = 0
fused_mlp_backward.mip_launches = 0  # of them, recomputing the integrated encoder
fused_mlp_backward.dx_launches = 0  # of them, with the input gradient (want_dx)
fused_mlp_backward.mip_dx_launches = 0  # of those, under mip (the integrated encoder's transpose)
fused_mlp_backward.anneal_launches = 0  # of them, recomputing with the anneal windows
fused_mlp_backward.app_launches = 0  # of them, an appearance model's (the code rows, dWca)
fused_mlp_backward.contract_launches = 0  # of them, recomputing a contracted model's forward


class _FusedMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xT, compute_dtype, model, mip, enc_w, *wts):
        ctx.save_for_backward(xT, *wts)
        ctx.compute_dtype, ctx.model, ctx.mip, ctx.enc_w = compute_dtype, model, mip, enc_w
        return fused_mlp_forward(FusedWeights(*wts), xT, compute_dtype, model, mip, enc_w)

    @staticmethod
    def backward(ctx, g):
        xT, *wts = ctx.saved_tensors
        want_dx = ctx.needs_input_grad[0]
        out = fused_mlp_backward(FusedWeights(*wts), xT, g.contiguous(), ctx.compute_dtype, ctx.model,
                                 ctx.mip, want_dx, ctx.enc_w)
        grads, dx = out if want_dx else (out, None)
        return (dx, None, None, None, None, *grads)


def fused_mlp(
    wts: FusedWeights,
    xT: torch.Tensor,
    compute_dtype=torch.bfloat16,
    model: NerfMLP = FLAGSHIP,
    mip: bool = False,
    enc_w: tuple | None = None,
) -> torch.Tensor:
    """Differentiable fused MLP (the JAX ``fused_mlp``): forward
    ``fused_mlp_forward``, backward ``fused_mlp_backward``, both with
    ``mip`` and the anneal windows ``enc_w`` as given. Gradients reach the
    packed weights, and ``xT`` when autograd asks for it (B2's
    ``want_dx``, the input-gradient kernel: pose refinement trains through
    ray generation, under mip through the frustum Gaussians' means,
    directions and variances, of a contracted model too; appearance codes
    through rows 8..15). The windows are a schedule and get no gradient."""
    return _FusedMLP.apply(xT, compute_dtype, model, mip, enc_w, *wts)


def fused_train_step(
    wts: FusedWeights,
    x16: torch.Tensor,
    N: int,
    compute_dtype=torch.bfloat16,
    model: NerfMLP = FLAGSHIP,
    out_weights: bool = False,
    dist: tuple | None = None,
    mip: bool = False,
    opaque_tail: bool = False,
):
    """One fused forward + compositing + MSE + backward pass.

    ``x16 (16, B*N)`` f32: rows 0..2 sample xyz, 3..5 unit view dirs, 6 ts
    (ascending along each ray), 8..10 the ray's gt colour on each of its
    samples, other rows unread; ray b owns columns b*N .. b*N + N - 1.
    Returns (loss, a 0-d f32 tensor; packed f32 weight gradients), and
    with ``out_weights`` also each sample's compositing weight, f32 (B, N)
    (the hierarchical scheme's importance sampler reads them).

    ``dist = (weight, tn, tf, disparity)`` (JAX's) adds ``weight`` times
    the point-form distortion loss of the rays' weights at their ts
    normalised to s in [0, 1] (linearly, or in 1/t with ``disparity``),
    averaged over rays, to the loss, and its gradient to the backward
    (the kernel's distortion rail). ``fused_train_step.dist_launches``
    counts the launches with it, ``weights_dist_launches`` those with the
    weights output and the rail at once (the proposal scheme's).

    ``mip`` (mip-NeRF's cone casting, train/step.py::build_x16_mip's
    layout): rows 0..2 hold the frustum Gaussians' means, 11..13 their
    diagonal variances (the integrated encoder), 6 the interval widths,
    composited as they are (no 1e10 tail), 7 the intervals' near edges t0
    (read by the rail alone), 14 each ray's loss weight on its samples;
    the rail takes its interval form. ``opaque_tail`` (with ``mip`` only;
    mip-NeRF 360's opaque background) makes the last interval's delta 1e10
    and drops it from the rail. ``mip_launches`` and ``opaque_launches``
    count those launches.

    No appearance model (JAX's rule, kernels/mlp.py:1559-1562): rows
    8..10 carry the gt colour, so there is no slot for codes; appearance
    trains on the forward kernel and B2 (``fused_mlp``). A contracted
    model's launches (``contract_launches``) contract rows 0..2 (and under
    mip warp the variances) in the forward's encoder; compositing and the
    rail read the ts and are unchanged."""
    if model.app_dim > 0:
        raise ValueError(
            "the single fused train kernel has no appearance slot (its x16 rows 8..10 carry gt colors); "
            "appearance training runs the forward kernel and B2 (fused_mlp, train/step.py's autograd path)"
        )
    wts = _prepare(wts, compute_dtype, model)
    if N <= 0 or x16.dim() != 2 or x16.shape[1] % N or x16.shape[1] == 0:
        raise ValueError(f"x16 must hold whole rays of N={N} samples; got {tuple(x16.shape)}")
    if opaque_tail and not mip:
        raise ValueError("opaque_tail changes interval compositing and needs mip=True")
    rail = _dist_rail(dist, x16.shape[1] // N)
    if _dispatch(x16):
        with torch.no_grad():
            return fused_train_step_plain(wts, x16, N, compute_dtype, model, out_weights, dist, mip,
                                          opaque_tail)
    lib, bf16 = _check_launch("fused_train_step", wts, x16, "x16", 16, compute_dtype, model)
    rows = x16.shape[1]
    ws = torch.empty(
        lib.fused_train_step_workspace_bytes(rows, N, model.Lp, model.Ld, model.H, bf16),
        dtype=torch.uint8, device=x16.device,
    )
    loss = torch.empty((), dtype=torch.float32, device=x16.device)
    grads = _empty_grads(model, x16.device)
    w = torch.empty((rows // N, N), dtype=torch.float32, device=x16.device) if out_weights else None
    d_scale, tn, tf, disparity = rail or (0.0, 0.0, 0.0, False)
    _raise_on(lib.fused_train_step(
        x16.data_ptr(), rows, N, model.Lp, model.Ld, model.H, bf16,
        _CPtrs(*_ptrs(wts)), _weights_t(wts), ws.data_ptr(), loss.data_ptr(),
        _CPtrs(*_ptrs(grads)), None if w is None else w.data_ptr(),
        int(rail is not None), d_scale, tn, tf, int(disparity), int(mip), int(opaque_tail), int(model.contract),
        _stream(x16),
    ), "fused_train_step")
    fused_train_step.launches += 1
    fused_train_step.weights_launches += out_weights
    fused_train_step.dist_launches += rail is not None
    fused_train_step.weights_dist_launches += out_weights and rail is not None
    fused_train_step.mip_launches += mip
    fused_train_step.opaque_launches += opaque_tail
    fused_train_step.contract_launches += model.contract
    return (loss, grads, w) if out_weights else (loss, grads)


fused_train_step.launches = 0
fused_train_step.weights_launches = 0  # of them, with the weights output
fused_train_step.dist_launches = 0  # of them, with the distortion rail
fused_train_step.weights_dist_launches = 0  # of them, with both at once
fused_train_step.mip_launches = 0  # of them, cone-cast: the integrated encoder and interval compositing
fused_train_step.opaque_launches = 0  # of them, with the opaque last interval
fused_train_step.contract_launches = 0  # of them, a contracted model's


def fused_render(
    wts: FusedWeights,
    x16: torch.Tensor,
    N: int,
    compute_dtype=torch.bfloat16,
    model: NerfMLP = FLAGSHIP,
) -> torch.Tensor:
    """Fused forward + point compositing of whole rays (the eval render).

    ``x16 (16, B*N)`` f32: rows 0..2 sample xyz, 3..5 unit view dirs, 6 ts
    (ascending along each ray; ray b owns columns b*N .. b*N + N - 1), rows
    7..15 not read. Returns ``(8, B*N)`` f32: at each ray's head column
    b*N, rows 0..2 the raw rgb, row 3 the depth sum(w t), row 4 the acc
    sum(w); zeros elsewhere. Compositing is f32 at either compute type. A
    contracted model's forward contracts rows 0..2 (``contract_launches``)."""
    if model.app_dim > 0:
        raise ValueError(
            "the fused eval render kernel has no appearance slot; appearance "
            "eval renders through fused_mlp_forward and torch compositing"
        )
    wts = _prepare(wts, compute_dtype, model)
    if N <= 0 or x16.dim() != 2 or x16.shape[1] % N or x16.shape[1] == 0:
        raise ValueError(f"x16 must hold whole rays of N={N} samples; got {tuple(x16.shape)}")
    if _dispatch(x16):
        return fused_render_plain(wts, x16, N, compute_dtype, model)
    lib, bf16 = _check_launch("fused_render", wts, x16, "x16", 16, compute_dtype, model)
    out = torch.empty((8, x16.shape[1]), dtype=torch.float32, device=x16.device)
    image = _image_scratch(lib.fused_render_image_bytes, model, bf16, x16.device)
    _raise_on(lib.fused_render(
        x16.data_ptr(), out.data_ptr(), x16.shape[1], N, model.Lp, model.Ld, model.H, bf16,
        _CPtrs(*_ptrs(wts)), image.data_ptr(), int(model.contract), _stream(x16),
    ), "fused_render")
    fused_render.launches += 1
    fused_render.contract_launches += model.contract
    return out


fused_render.launches = 0
fused_render.contract_launches = 0  # of them, a contracted model's


WGRAD_ROW_MULTIPLE = 64  # rows of a plane come in whole 64-row tiles, as in the workspace
WGRAD_MAX_SUMS = 12  # sums of one launch: the backward's twelve


class _CWTask(ctypes.Structure):
    """The C ``WTask``: one sum's planes, widths and outputs."""

    _fields_ = [("G", ctypes.c_void_p), ("A", ctypes.c_void_p), ("O", ctypes.c_int),
                ("K", ctypes.c_int), ("dW", ctypes.c_void_p), ("db", ctypes.c_void_p)]


def _check_planes(G: torch.Tensor, A: torch.Tensor) -> None:
    ok_dtype = G.dtype in (torch.float32, torch.bfloat16) and A.dtype == G.dtype
    if not ok_dtype or G.dim() != 2 or A.dim() != 2:
        raise ValueError(f"G and A must be 2-d planes, both f32 or both bf16; got "
                         f"{tuple(G.shape)} {G.dtype} and {tuple(A.shape)} {A.dtype}")
    (O, R), K = G.shape, A.shape[0]
    if A.shape[1] != R or R == 0 or R % WGRAD_ROW_MULTIPLE:
        raise ValueError(f"G and A need the same rows, a positive multiple of "
                         f"{WGRAD_ROW_MULTIPLE}; got {tuple(G.shape)} and {tuple(A.shape)}")
    if not (1 <= O <= _MAX_H and 1 <= K <= _MAX_H):
        raise ValueError(f"the kernel takes 1 <= O, K <= {_MAX_H}; got O={O}, K={K}")
    if not (G.is_contiguous() and A.is_contiguous()) or A.device != G.device:
        raise ValueError("G and A must be contiguous planes on one device")
    if G.device.type == "cuda" and (G.data_ptr() | A.data_ptr()) % 16:
        raise ValueError("the kernel's 16-byte copies need 16-byte aligned planes")


def weight_grads(sums) -> list[tuple[torch.Tensor, torch.Tensor | None]]:
    """Up to 12 weight-gradient sums at once, as the backward runs its
    twelve: ``sums`` is a list of ``(G, A, bias)``, every plane pair as
    ``weight_grad`` takes it, all of one type and row count on one device.
    On the card they run in one launch of the sums kernel (and one of its
    reduce); returns ``[(dW, db or None), ...]``."""
    sums = list(sums)
    if not 1 <= len(sums) <= WGRAD_MAX_SUMS:
        raise ValueError(f"1 to {WGRAD_MAX_SUMS} sums a launch; got {len(sums)}")
    for G, A, _ in sums:
        _check_planes(G, A)
    G0 = sums[0][0]
    if any(G.dtype != G0.dtype or G.shape[1] != G0.shape[1] or G.device != G0.device
           for G, _, _ in sums):
        raise ValueError("the sums of one launch share a type, a row count and a device")
    if _dispatch(G0):
        return [(dW, db if bias else None)
                for (dW, db), (_, _, bias) in zip((weight_grad_plain(G, A, G.dtype) for G, A, _ in sums), sums)]
    lib, bf16, R = _lib("fused_mlp_bwd"), int(G0.dtype == torch.bfloat16), G0.shape[1]
    out = [(torch.empty((G.shape[0], A.shape[0]), dtype=torch.float32, device=G.device),
            torch.empty((G.shape[0],), dtype=torch.float32, device=G.device) if bias else None)
           for G, A, bias in sums]
    tasks = (_CWTask * len(sums))(*[
        _CWTask(G.data_ptr(), A.data_ptr(), G.shape[0], A.shape[0], dW.data_ptr(),
                db.data_ptr() if db is not None else None)
        for (G, A, _), (dW, db) in zip(sums, out)])
    ptr = ctypes.cast(tasks, ctypes.c_void_p)
    part = torch.empty(lib.wgrad_group_part_bytes(ptr, len(sums), R, bf16), dtype=torch.uint8,
                       device=G0.device)
    _raise_on(lib.wgrad_group(ptr, len(sums), R, bf16, part.data_ptr(), _stream(G0)), "wgrad_group")
    weight_grad.launches += 1
    return out


def weight_grad(
    G: torch.Tensor, A: torch.Tensor, bias: bool = True
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One weight-gradient sum of the backward, alone: for planes ``G (O,
    R)`` and ``A (K, R)``, both f32 or both bf16, returns ``dW = G A^T``
    ``(O, K)`` f32 and, with ``bias``, ``db`` ``(O,)`` f32, the row sums
    of ``G`` (else None). ``1 <= O, K <= 256`` and R a multiple of 64, as
    the backward's workspace holds them; pad rows of zeros add nothing.
    ``weight_grad.launches`` counts the kernel's launches by this wrapper
    and by ``weight_grads``."""
    _check_planes(G, A)
    if _dispatch(G):
        dW, db = weight_grad_plain(G, A, G.dtype)
        return dW, db if bias else None
    (O, R), K = G.shape, A.shape[0]
    lib, bf16 = _lib("fused_mlp_bwd"), int(G.dtype == torch.bfloat16)
    dW = torch.empty((O, K), dtype=torch.float32, device=G.device)
    db = torch.empty((O,), dtype=torch.float32, device=G.device) if bias else None
    part = torch.empty(lib.wgrad_part_bytes(O, K, R, bf16), dtype=torch.uint8, device=G.device)
    _raise_on(lib.wgrad_sums(G.data_ptr(), O, A.data_ptr(), K, R, bf16, dW.data_ptr(),
                             db.data_ptr() if bias else None, part.data_ptr(), _stream(G)),
              "wgrad_sums")
    weight_grad.launches += 1
    return dW, db


weight_grad.launches = 0


def _c_counts(entry: str, reset: bool) -> int:
    """A launch count kept in C (``<entry>(reset)``), summed over the
    training libraries that are loaded; libraries not yet loaded count 0
    and are not built."""
    return sum(getattr(_lib(name), entry)(int(reset))
               for name in ("fused_mlp_bwd", "fused_train_step") if name in _build._loaded)


def wgrad_sums_launches(reset: bool = False) -> int:
    """Launches of the weight-gradient sums kernel (csrc/wgrad.cuh) so far,
    counted inside the libraries that launch it: B1 and B2 run it from C,
    ``weight_grad`` through B2's library. With ``reset``, the counts
    restart from 0."""
    return _c_counts("wgrad_launch_count", reset)


def bwd_tile_launches(reset: bool = False) -> int:
    """Launches of the backward tile kernels (bf16: csrc/bwd_bf16.cuh; f32:
    csrc/bwd_f32.cuh) so far, counted inside the libraries that launch them:
    B1 and B2 once a call, ``backward_tile`` through B2's library. With
    ``reset``, the counts restart from 0."""
    return _c_counts("bwd_tile_launch_count", reset)


def input_grad_launches(reset: bool = False) -> int:
    """Launches of the input-gradient kernel (csrc/input_grad.cuh) so far,
    counted inside the libraries that launch it: from
    ``fused_mlp_backward(want_dx=True)`` and ``input_grad``, B2's library,
    and for a contracted model csrc/fused_contract.cu's
    (``input_grad_contract_launches``). With ``reset``, the counts restart
    from 0; 0 for a library that is not loaded (it is not built)."""
    n = input_grad_contract_launches(reset)
    if "fused_mlp_bwd" not in _build._loaded:
        return n
    return n + _lib("fused_mlp_bwd").input_grad_launch_count(int(reset))


def input_grad_mip_launches(reset: bool = False) -> int:
    """Of ``input_grad_launches``, those of the kernel's mip instantiations
    (the integrated encoder's transpose; a contracted model's,
    ``input_grad_mip_contract_launches``, among them), counted in C where
    they launch."""
    n = input_grad_mip_contract_launches(reset)
    if "fused_mlp_bwd" not in _build._loaded:
        return n
    return n + _lib("fused_mlp_bwd").input_grad_mip_launch_count(int(reset))


def input_grad_f32_launches(reset: bool = False) -> int:
    """Of ``input_grad_launches``, those in f32 (csrc/input_grad.cuh's
    ``input_grad_fma``; a contracted model's among them), counted in C where
    they launch."""
    n = 0 if "fused_contract" not in _build._loaded else _lib("fused_contract").input_grad_contract_f32_launch_count(
        int(reset))
    if "fused_mlp_bwd" not in _build._loaded:
        return n
    return n + _lib("fused_mlp_bwd").input_grad_f32_launch_count(int(reset))


def input_grad_contract_launches(reset: bool = False) -> int:
    """Of ``input_grad_launches``, those of the kernel's contract
    instantiation (csrc/fused_contract.cu), counted in C where they launch."""
    if "fused_contract" not in _build._loaded:
        return 0
    return _lib("fused_contract").input_grad_contract_launch_count(int(reset))


def input_grad_mip_contract_launches(reset: bool = False) -> int:
    """Of ``input_grad_contract_launches``, those of the kernel's ``MIP &&
    CONTRACT`` instantiation (a contracted model under mip), counted in C
    where they launch."""
    if "fused_contract" not in _build._loaded:
        return 0
    return _lib("fused_contract").input_grad_mip_contract_launch_count(int(reset))


def contract_launches(reset: bool = False) -> int:
    """Launches of the forward tile kernels' contracted instantiations so
    far (csrc/fused_contract.cu: for the forward, B2's recompute, B1 and
    B3), counted in C where they launch. With ``reset``, the count restarts
    from 0; 0 when the library is not loaded (it is not built)."""
    if "fused_contract" not in _build._loaded:
        return 0
    return _lib("fused_contract").fwd_contract_launch_count(int(reset))


def input_grad(
    wts: FusedWeights,
    xT: torch.Tensor,
    gws: torch.Tensor,
    compute_dtype=torch.bfloat16,
    model: NerfMLP = FLAGSHIP,
    enc_w: tuple | None = None,
    mip: bool = False,
) -> torch.Tensor:
    """The input-gradient kernel alone, as ``fused_mlp_backward(want_dx=
    True)`` runs it after its weight gradients: from the backward's
    cotangent planes ``gws (FG, Rp)`` in the compute type (``Layout``; Rp
    = rows rounded up to 64; it reads g_h0, g_h5 and g_hc) and the inputs
    ``xT (8, rows)`` f32 to ``dx (8, rows)`` f32 (``input_grad_plain``),
    with the anneal windows ``enc_w``; for an appearance model ``xT`` and
    ``dx`` have 16 rows, dx's rows 8..15 the codes' cotangents
    (``input_grad.app_launches``); with ``mip`` (no windows, no codes)
    ``xT`` and ``dx`` have 16 rows, the integrated encoder's transpose
    (``input_grad.mip_launches``). ``input_grad.launches`` counts the
    kernel's launches by this wrapper. A contracted model's is the kernel's
    contract instantiation (``input_grad.contract_launches``), under mip its
    ``MIP && CONTRACT`` one (counted in ``mip_launches`` too)."""
    wts = _prepare(wts, compute_dtype, model, mip)
    L = Layout.of(model)
    rows = xT.shape[1] if xT.dim() == 2 else 0
    Rp = -(-rows // WGRAD_ROW_MULTIPLE) * WGRAD_ROW_MULTIPLE
    if rows == 0 or gws.dtype != compute_dtype or tuple(gws.shape) != (L.FG, Rp) or not gws.is_contiguous():
        raise ValueError(f"gws must be contiguous ({L.FG}, {Rp}) {compute_dtype} planes for xT of "
                         f"{rows} rows; got {tuple(gws.shape)} {gws.dtype}")
    if gws.device != xT.device:
        raise ValueError(f"gws on {gws.device} and xT on {xT.device}")
    wx, wd = _enc_w_ptrs(enc_w, model, xT.device, mip)
    if _dispatch(xT):
        return input_grad_plain(wts, xT, gws, compute_dtype, model, enc_w, mip)
    lib, bf16 = _check_launch("fused_mlp_bwd", wts, xT, "xT", _x_rows(mip, model), compute_dtype, model)
    _check_input_grad_arch(model)
    dx = torch.empty((_x_rows(mip, model), rows), dtype=torch.float32, device=xT.device)
    _raise_on(lib.input_grad(
        gws.data_ptr(), xT.data_ptr(), rows, model.Lp, model.Ld, model.H, bf16, _CPtrs(*_ptrs(wts)),
        wx, wd, dx.data_ptr(), _app(model), int(mip), int(model.contract), _stream(xT),
    ), "input_grad")
    input_grad.launches += 1
    input_grad.app_launches += _app(model)
    input_grad.mip_launches += mip
    input_grad.contract_launches += model.contract
    return dx


input_grad.launches = 0
input_grad.app_launches = 0  # of them, an appearance model's (dx's code rows)
input_grad.mip_launches = 0  # of them, the integrated encoder's transpose (mip)
input_grad.contract_launches = 0  # of them, a contracted model's (csrc/fused_contract.cu)


def backward_tile(
    wts: FusedWeights,
    res: torch.Tensor,
    g: torch.Tensor,
    compute_dtype=torch.bfloat16,
    model: NerfMLP = FLAGSHIP,
) -> torch.Tensor:
    """The backward tile kernel alone: from the residual planes ``res (FA,
    Rp)`` of the workspace (``Layout``; Rp = rows rounded up to 64) in the
    compute type and the output cotangents ``g (8, rows)`` f32 (rows 0..2
    d_rgb, row 3 d_sigma, rows 4..7 not read) to the cotangent planes
    ``(FG, Rp)`` in the compute type, zero past ``rows``: what B1 and B2
    run between their forward and their weight-gradient sums.
    ``backward_tile.launches`` counts the kernel's launches by this
    wrapper."""
    wts = _prepare(wts, compute_dtype, model)
    L = Layout.of(model)
    rows = g.shape[1] if g.dim() == 2 else 0
    Rp = -(-rows // WGRAD_ROW_MULTIPLE) * WGRAD_ROW_MULTIPLE
    if rows == 0 or res.dtype != compute_dtype or tuple(res.shape) != (L.FA, Rp) or not res.is_contiguous():
        raise ValueError(f"res must be contiguous ({L.FA}, {Rp}) {compute_dtype} planes for g of "
                         f"{rows} rows; got {tuple(res.shape)} {res.dtype}")
    if res.device != g.device:
        raise ValueError(f"res on {res.device} and g on {g.device}")
    if _dispatch(g):
        if g.dtype != torch.float32 or g.shape[0] != 8:
            raise ValueError(f"g must be an (8, rows) f32 tensor; got {tuple(g.shape)} {g.dtype}")
        return backward_tile_plain(wts, res, g, compute_dtype, model).to(compute_dtype)
    lib, bf16 = _check_launch("fused_mlp_bwd", wts, g, "g", 8, compute_dtype, model)
    if res.data_ptr() % 16:
        raise ValueError("the kernel's 16-byte copies need 16-byte aligned planes")
    out = torch.empty((L.FG, Rp), dtype=compute_dtype, device=g.device)
    image = torch.empty(lib.bwd_tile_image_bytes(model.H, bf16), dtype=torch.uint8, device=g.device)
    _raise_on(lib.backward_tile(
        g.data_ptr(), rows, model.Lp, model.Ld, model.H, bf16, _CPtrs(*_ptrs(wts)),
        _weights_t(wts), res.data_ptr(), out.data_ptr(), image.data_ptr(), _app(model), _stream(g),
    ), "backward_tile")
    backward_tile.launches += 1
    return out


backward_tile.launches = 0
