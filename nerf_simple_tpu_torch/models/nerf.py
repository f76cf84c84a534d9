"""The NeRF MLP as a ``torch.nn.Module``.

Port of nerf_simple_tpu/models/nerf.py, behaviour-equivalent to the
reference ``Nerf`` module (reference utils/nets.py:8-43) with its quirks:
positional encoding inside the forward; 5 trunk layers; a skip layer on
``[h | posx]``; 2 post layers; a sigma head and a feature layer with NO
activation; a colour head ``[feat | posd] -> H//2 -> 3`` with no sigmoid;
output ``[rgb | sigma]``. With ``app_dim > 0`` (NeRF-W-style per-image
appearance codes) the colour head also reads a code of that width,
appended to the direction encoding, so the density does not see it.
With ``contract`` (mip-NeRF 360's scene contraction, for unbounded
scenes) the sample positions are contracted into the radius-2 ball before
the encoder, and under mip the frustum Gaussians through the contraction's
linearisation.

The JAX package keeps params as a pytree of ``(in, out)`` arrays; that
pytree, as numpy, stays the interchange format (checkpoints, tests).
``NerfField.from_jax_params`` / ``to_jax_params`` convert between it and
the module's ``nn.Linear`` children, whose weights are ``(out, in)``.
``NerfPair`` holds the hierarchical scheme's coarse and fine fields, the
JAX ``{"coarse", "fine"}`` pytree.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nerf_simple_tpu_torch.ops.encoding import contract_gaussian, ipe_encoder, positional_encoder, scene_contraction

Params = dict[str, dict[str, np.ndarray]]

@dataclasses.dataclass(frozen=True)
class NerfMLP:
    """Static architecture config. ``app_dim``: the width of the per-image
    appearance code the colour head reads (0: none; the codes themselves
    are the train step's ``AppCodes``). ``contract``: the positions go
    through ``scene_contraction`` before the encoder."""

    Lp: int = 10
    Ld: int = 4
    H: int = 256
    contract: bool = False
    app_dim: int = 0

    @property
    def in_Cx(self) -> int:
        return 6 * self.Lp + 3

    @property
    def in_Cd(self) -> int:
        return 6 * self.Ld + 3

    def layer_dims(self) -> dict[str, tuple[int, int]]:
        H, Cx, Cd = self.H, self.in_Cx, self.in_Cd
        return {
            "trunk0": (Cx, H),
            "trunk1": (H, H),
            "trunk2": (H, H),
            "trunk3": (H, H),
            "trunk4": (H, H),
            "skip": (H + Cx, H),
            "post0": (H, H),
            "post1": (H, H),
            "sigma": (H, 1),
            "feature": (H, H),
            "color0": (H + Cd + self.app_dim, H // 2),
            "color1": (H // 2, 3),
        }


def check_app(model: NerfMLP, app: torch.Tensor | None) -> None:
    """Raise unless ``app`` suits ``model``: (..., app_dim) codes for an
    appearance model, None for any other (the JAX ``nerf_apply``'s rule)."""
    if (app is None) != (model.app_dim == 0) or (app is not None and app.shape[-1] != model.app_dim):
        raise ValueError(
            f"model.app_dim={model.app_dim} but app is {None if app is None else tuple(app.shape)}: appearance "
            "models need matching (B, app_dim) codes (and only they accept them)"
        )


def infer_arch(params: Params) -> NerfMLP:
    """Recover (Lp, Ld, H) from a params pytree's layer shapes ({coarse,
    fine} pytrees infer from the fine net)."""
    if "fine" in params and "trunk0" not in params:
        params = params["fine"]
    Cx, H = np.shape(params["trunk0"]["w"])
    Cd = np.shape(params["color0"]["w"])[0] - H
    if (Cd - 3) % 6:
        raise ValueError(
            f"color head fan-in {np.shape(params['color0']['w'])[0]} does "
            f"not match any pure direction-encoding width (H={H} + 6*Ld + "
            "3): this looks like an appearance-embedding checkpoint "
            "(app_dim > 0) — rebuild the model from its model.json sidecar"
        )
    return NerfMLP(Lp=(Cx - 3) // 6, Ld=(Cd - 3) // 6, H=H)


def init_nerf_params(seed: int, model: NerfMLP = NerfMLP()) -> Params:
    """Numpy params pytree, W and b ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    (torch.nn.Linear's default distribution), drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    params: Params = {}
    for name, (fan_in, fan_out) in model.layer_dims().items():
        bound = 1.0 / np.sqrt(fan_in)
        params[name] = {
            "w": rng.uniform(-bound, bound, (fan_in, fan_out)).astype(np.float32),
            "b": rng.uniform(-bound, bound, (fan_out,)).astype(np.float32),
        }
    return params


class LinearField(nn.Module):
    """An MLP of ``nn.Linear`` children named after the JAX layers of
    ``model.layer_dims()``, in its order; converts to and from the JAX
    pytree of ``(in, out)`` weights. ``infer_arch`` recovers a subclass's
    model from such a pytree."""

    infer_arch = None

    def __init__(self, model, device=None):
        super().__init__()
        self.model = model
        for name, (fan_in, fan_out) in model.layer_dims().items():
            self.add_module(name, nn.Linear(fan_in, fan_out, device=device))

    @classmethod
    def from_jax_params(cls, params: Params, device, model=None):
        """Module from a JAX-layout pytree of ``(in, out)`` weights."""
        model = model or cls.infer_arch(params)
        return cls(model, device="meta").to_empty(device=device).copy_jax_params_(params)

    def copy_jax_params_(self, params: Params):
        """Copy a JAX-layout pytree into the weights, in place."""
        with torch.no_grad():
            for name in self.model.layer_dims():
                lin = getattr(self, name)
                w = np.asarray(params[name]["w"], np.float32)
                lin.weight.copy_(torch.from_numpy(np.ascontiguousarray(w.T)))
                lin.bias.copy_(torch.from_numpy(np.asarray(params[name]["b"], np.float32)))
        return self

    def to_jax_params(self) -> Params:
        """Inverse of ``from_jax_params``: numpy ``(in, out)`` pytree."""
        return {
            name: {
                "w": getattr(self, name).weight.detach().cpu().numpy().T.copy(),
                "b": getattr(self, name).bias.detach().cpu().numpy().copy(),
            }
            for name in self.model.layer_dims()
        }


class NerfField(LinearField):
    """The NerfMLP field; ``forward`` is ``nerf_apply``."""

    infer_arch = staticmethod(infer_arch)

    def __init__(self, model: NerfMLP = NerfMLP(), device=None):
        super().__init__(model, device)

    def forward(self, v: torch.Tensor, compute_dtype=torch.float32, enc_alpha: float | None = None,
                app: torch.Tensor | None = None) -> torch.Tensor:
        return nerf_apply(self, v, compute_dtype, enc_alpha, app)


class NerfPair(nn.Module):
    """The hierarchical scheme's two fields of one model: ``coarse`` places
    the samples of ``fine`` (the JAX ``{"coarse", "fine"}`` params)."""

    def __init__(self, coarse: NerfField, fine: NerfField):
        super().__init__()
        if coarse.model != fine.model:
            raise ValueError(f"coarse and fine fields differ: {coarse.model} vs {fine.model}")
        self.coarse, self.fine = coarse, fine
        self.model = fine.model

    @classmethod
    def from_jax_params(cls, params: dict[str, Params], device, model: NerfMLP | None = None):
        return cls(*(NerfField.from_jax_params(params[k], device, model) for k in ("coarse", "fine")))

    def copy_jax_params_(self, params: dict[str, Params]) -> "NerfPair":
        self.coarse.copy_jax_params_(params["coarse"])
        self.fine.copy_jax_params_(params["fine"])
        return self

    def to_jax_params(self) -> dict[str, Params]:
        return {"coarse": self.coarse.to_jax_params(), "fine": self.fine.to_jax_params()}



def _rnd(x: torch.Tensor, dtype) -> torch.Tensor:
    """Round to ``dtype`` and compute on in f32 (bf16 products are exact
    in f32, so an f32 matmul of rounded operands is a bf16 matmul with
    f32 accumulation)."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def _dense(lin: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    return F.linear(_rnd(x, dtype), _rnd(lin.weight, dtype), lin.bias)


def nerf_apply(
    field: NerfField, v: torch.Tensor, compute_dtype=torch.float32, enc_alpha: float | None = None,
    app: torch.Tensor | None = None,
) -> torch.Tensor:
    """Raw (B, 6) ``[xyz | unit dir]`` rows -> (B, 4) f32 ``[rgb | sigma]``,
    layer by layer: the plain (``backend="xla"``) oracle.

    ``compute_dtype=torch.bfloat16`` rounds weights and activations to
    bf16 and accumulates in f32, like the JAX path's
    ``preferred_element_type=f32``. ``enc_alpha``: the BARF anneal
    progress in [0, 1] (``ops/encoding.py::anneal_weights``), the
    pose-refinement companion ``pe_anneal_until``; None is the standard
    encoder. ``app``: (B, app_dim) per-row appearance codes, required iff
    ``model.app_dim > 0``, appended to the direction encoding, so they
    condition the colour head only. A contracted model contracts the
    positions first (JAX models/nerf.py:192-196)."""
    model = field.model
    check_app(model, app)
    if model.contract:
        v = torch.cat([scene_contraction(v[..., :3]), v[..., 3:]], dim=-1)
    posx, posd = positional_encoder(v, Lp=model.Lp, Ld=model.Ld, alpha=enc_alpha)
    if app is not None:
        posd = torch.cat([posd, app.to(posd.dtype)], dim=-1)
    return _apply_encoded(field, posx, posd, compute_dtype)


def nerf_apply_mip(
    field: NerfField, mean: torch.Tensor, var: torch.Tensor, dirs: torch.Tensor, compute_dtype=torch.float32
) -> torch.Tensor:
    """The mip forward (JAX ``nerf_apply_mip``): the frustum Gaussians'
    (B, 3) means and diagonal variances (through ``contract_gaussian`` for
    a contracted model) and the (B, 3) unit dirs through ``ipe_encoder``,
    then the same layers as ``nerf_apply``, so a mip checkpoint is a plain
    one."""
    if field.model.contract:
        mean, var = contract_gaussian(mean, var)
    posx, posd = ipe_encoder(mean, var, dirs, Lp=field.model.Lp, Ld=field.model.Ld)
    return _apply_encoded(field, posx, posd, compute_dtype)


def _apply_encoded(field: NerfField, posx: torch.Tensor, posd: torch.Tensor, dt) -> torch.Tensor:
    posx, posd = _rnd(posx, dt), _rnd(posd, dt)
    h = posx
    for name in ("trunk0", "trunk1", "trunk2", "trunk3", "trunk4"):
        h = _rnd(torch.relu(_dense(getattr(field, name), h, dt)), dt)
    h = _rnd(torch.relu(_dense(field.skip, torch.cat([h, posx], -1), dt)), dt)
    for name in ("post0", "post1"):
        h = _rnd(torch.relu(_dense(getattr(field, name), h, dt)), dt)
    sigma = _dense(field.sigma, h, dt)
    feat = _rnd(_dense(field.feature, h, dt), dt)  # no activation (quirk)
    hc = _rnd(torch.relu(_dense(field.color0, torch.cat([feat, posd], -1), dt)), dt)
    color = _dense(field.color1, hc, dt)
    return torch.cat([color, sigma], dim=-1)
