"""Model families (port of nerf_simple_tpu/models/__init__.py).

The port runs the NerfMLP family. The hash-grid and CP-grid families are
ROADMAP Queue A item 8: asking for them raises.
"""

from __future__ import annotations

import torch

from nerf_simple_tpu_torch.models.nerf import (
    NerfField,
    NerfMLP,
    NerfPair,
    infer_arch,
    init_nerf_params,
    nerf_apply,
)

__all__ = [
    "NerfMLP",
    "NerfField",
    "NerfPair",
    "init_nerf_params",
    "nerf_apply",
    "apply_model",
    "zeros_app_for",
    "infer_model",
    "model_from_meta",
    "model_from_train_config",
]

_UNPORTED_FAMILIES = ("hashgrid", "cpgrid")


def _unported_family(family: str) -> NotImplementedError:
    return NotImplementedError(
        f"the {family} model family is not ported yet: ROADMAP Queue A item 8, "
        "'the hashgrid/cpgrid families'"
    )


def apply_model(field: NerfField, v: torch.Tensor, compute_dtype=torch.float32,
                enc_alpha: float | None = None, app: torch.Tensor | None = None) -> torch.Tensor:
    """(B, 6) ``[xyz | unit dir]`` rows -> (B, 4) raw ``[rgb | sigma]``;
    ``enc_alpha`` anneals the encoder; ``app`` (B, app_dim) are the
    appearance codes, required iff ``model.app_dim > 0`` (``nerf_apply``).
    Density-only consumers (normals) pass ``zeros_app_for``: sigma never
    sees the code."""
    return nerf_apply(field, v, compute_dtype, enc_alpha, app)


def zeros_app_for(model: NerfMLP, n: int, device=None) -> torch.Tensor | None:
    """(n, app_dim) zero appearance codes for density-only forwards of an
    appearance model (sigma does not read the code), or None when the model
    takes none."""
    if model.app_dim > 0:
        return torch.zeros((n, model.app_dim), dtype=torch.float32, device=device)
    return None


def model_from_train_config(cfg) -> NerfMLP:
    """The main field's model of a TrainConfig (JAX models/__init__.py:
    139-142): ``contract`` is wired from ``cfg.contract``, as it is into the
    proposal net (``proposal_from_train_config``)."""
    return NerfMLP(Lp=cfg.net_Lp, Ld=cfg.net_Ld, H=cfg.net_H, contract=cfg.contract, app_dim=cfg.appearance_dim)


def model_from_meta(meta: dict) -> NerfMLP:
    """The model a ``model.json`` sidecar describes."""
    meta = dict(meta)
    family = meta.pop("family", "nerf")
    if family in _UNPORTED_FAMILIES:
        raise _unported_family(family)
    if family != "nerf":
        raise ValueError(f"unknown model family {family!r} in model meta")
    return NerfMLP(**meta)


def infer_model(params) -> NerfMLP:
    """The model, from a params pytree's layer shapes alone."""
    p = params
    if isinstance(p, dict) and "fine" in p and "tables" not in p:
        p = p["fine"]
    if isinstance(p, dict) and "tables" in p:
        raise _unported_family("hashgrid")
    if isinstance(p, dict) and "basis" in p:
        raise _unported_family("cpgrid")
    return infer_arch(params)
