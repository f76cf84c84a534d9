"""The density-only proposal MLP of mip-NeRF 360's sampling scheme (port of
nerf_simple_tpu/models/proposal.py, the point-sampled form).

A small MLP, ``[x | gamma(x)] -> D x (H, relu) -> sigma`` (``x`` contracted
first when ``contract``, as the main field's), probed at
``Np`` stratified samples a ray; its compositing weights place the main
field's samples, and the interlevel loss (ops/volume.py) distils it from
the main field's weights. It stays plain PyTorch (``F.linear``), as the
JAX package keeps it in XLA outside any kernel.

Params travel as the JAX package's pytree of numpy ``(in, out)`` arrays,
``{"trunk0", ..., "trunk<D-1>", "sigma"}``; ``ProposalField`` (a
``LinearField``) converts between it and ``nn.Linear`` children, and
``ProposalPair`` holds the scheme's two nets, the JAX ``{"prop", "fine"}``
pytree.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nerf_simple_tpu_torch.models.nerf import LinearField, NerfField, NerfMLP, Params, _rnd
from nerf_simple_tpu_torch.ops.encoding import gamma, scene_contraction
from nerf_simple_tpu_torch.ops.volume import weights_from_sigma


@dataclasses.dataclass(frozen=True)
class ProposalMLP:
    """Static architecture: ``Lp`` position-encoding octaves, ``D`` hidden
    layers of width ``H``. ``contract``: the positions go through
    ``scene_contraction`` first; it must match the main field's (the
    weights cannot tell, so eval copies it from the main model)."""

    Lp: int = 6
    D: int = 4
    H: int = 64
    contract: bool = False

    @property
    def in_Cx(self) -> int:
        return 6 * self.Lp + 3

    def layer_dims(self) -> dict[str, tuple[int, int]]:
        dims = {"trunk0": (self.in_Cx, self.H)}
        dims.update({f"trunk{i}": (self.H, self.H) for i in range(1, self.D)})
        dims["sigma"] = (self.H, 1)
        return dims


def proposal_from_train_config(cfg) -> ProposalMLP:
    return ProposalMLP(Lp=cfg.prop_Lp, D=cfg.prop_D, H=cfg.prop_H, contract=cfg.contract)


def infer_proposal_arch(params: Params) -> ProposalMLP:
    """The architecture from the weight shapes: Lp from trunk0's fan-in, H
    from its fan-out, D from the count of trunk layers."""
    Cx, H = np.shape(params["trunk0"]["w"])
    D = sum(1 for name in params if name.startswith("trunk"))
    return ProposalMLP(Lp=(Cx - 3) // 6, D=D, H=H)


def init_proposal_params(seed: int, model: ProposalMLP = ProposalMLP()) -> Params:
    """Numpy params pytree, W and b ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    drawn from ``seed`` (the family init of ``init_nerf_params``)."""
    rng = np.random.default_rng(seed)
    params: Params = {}
    for name, (fan_in, fan_out) in model.layer_dims().items():
        bound = 1.0 / np.sqrt(fan_in)
        params[name] = {
            "w": rng.uniform(-bound, bound, (fan_in, fan_out)).astype(np.float32),
            "b": rng.uniform(-bound, bound, (fan_out,)).astype(np.float32),
        }
    return params


class ProposalField(LinearField):
    """The proposal net (``proposal_sigma`` runs it)."""

    infer_arch = staticmethod(infer_proposal_arch)

    def __init__(self, model: ProposalMLP = ProposalMLP(), device=None):
        super().__init__(model, device)


class ProposalPair(nn.Module):
    """The proposal scheme's two nets: ``prop`` places the samples of the
    main field ``fine`` (the JAX ``{"prop", "fine"}`` params); one
    ``parameters()`` for one Adam."""

    def __init__(self, prop: ProposalField, fine: NerfField):
        super().__init__()
        self.prop, self.fine = prop, fine
        self.model = fine.model

    @classmethod
    def from_jax_params(cls, params: dict, device, model: NerfMLP | None = None,
                        prop_model: ProposalMLP | None = None):
        return cls(ProposalField.from_jax_params(params["prop"], device, prop_model),
                   NerfField.from_jax_params(params["fine"], device, model))

    def copy_jax_params_(self, params: dict) -> "ProposalPair":
        self.prop.copy_jax_params_(params["prop"])
        self.fine.copy_jax_params_(params["fine"])
        return self

    def to_jax_params(self) -> dict:
        return {"prop": self.prop.to_jax_params(), "fine": self.fine.to_jax_params()}


def proposal_sigma(field: ProposalField, locs: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
    """Raw (pre-softplus) density at (..., 3) positions -> (...,) f32. In
    bf16 it rounds where JAX rounds: the input ``[x | gamma(x)]``, each
    weight, and each activation after its relu; products accumulate and
    biases add in f32, and the sigma head stays f32. A contracted net
    contracts the positions first (JAX models/proposal.py:114-117)."""
    dt = compute_dtype
    if field.model.contract:
        locs = scene_contraction(locs)

    def dense(lin, h):  # h is rounded already: round the weight alone
        return F.linear(h, _rnd(lin.weight, dt), lin.bias)

    h = _rnd(torch.cat([locs, gamma(locs, field.model.Lp)], dim=-1), dt)
    for i in range(field.model.D):
        h = _rnd(torch.relu(dense(getattr(field, f"trunk{i}"), h)), dt)
    return dense(field.sigma, h)[..., 0]


def proposal_weights(field: ProposalField, rays: torch.Tensor, ts: torch.Tensor,
                     compute_dtype=torch.float32) -> torch.Tensor:
    """(B, N) compositing weights of the proposal density at the (B, N)
    ascending ``ts`` of the (B, 6) ``[origin | direction]`` rays (samples
    along the unnormalised direction, as the main render places them);
    differentiable in the field's parameters."""
    origins, dirs = rays[:, :3], rays[:, 3:6]
    locs = origins[:, None, :] + dirs[:, None, :] * ts[..., None]
    sigma = proposal_sigma(field, locs, compute_dtype)
    unit_dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    return weights_from_sigma(sigma, ts, unit_dirs)
